"""Quadratic importance penalties for the EWC / MAS / L2 baselines (port of
gslora_tpu/losses/regularization.py; reference engine_cl.py:435-460
get_reg_loss): lambda * sum_tasks sum_n imp_n * (p - p*_n)^2."""
from __future__ import annotations

import torch

from gslora_tpu_torch.models.convert import flatten_tree


def quadratic_penalty(params, anchors, importances, lam) -> torch.Tensor:
    """``params`` and each ``anchors[i]`` / ``importances[i]`` are trees of
    one structure (one anchor and importance per past task). Each task's
    term runs as a few ``torch._foreach_*`` calls over the leaves, in
    fp32."""
    p = flatten_tree(params)
    names = list(p)
    ps = [p[k].float() for k in names]
    total = ps[0].new_zeros(())
    for anchor, imp in zip(anchors, importances):
        a, w = flatten_tree(anchor), flatten_tree(imp)
        d = torch._foreach_sub(ps, [a[k].float() for k in names])
        terms = torch._foreach_mul(torch._foreach_mul(d, d),
                                   [w[k].float() for k in names])
        total = total + torch.stack([t.sum() for t in terms]).sum()
    return lam * total
