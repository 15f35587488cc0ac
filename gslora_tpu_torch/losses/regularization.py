"""Quadratic importance penalties for the EWC / MAS / L2 baselines (port of
gslora_tpu/losses/regularization.py; reference engine_cl.py:435-460
get_reg_loss): lambda * sum_tasks sum_n imp_n * (p - p*_n)^2."""
from __future__ import annotations

import torch

from gslora_tpu_torch.models.convert import flatten_tree
from gslora_tpu_torch.parallel import sharding


def quadratic_penalty(params, anchors, importances, lam,
                      mesh=None) -> torch.Tensor:
    """``params`` and each ``anchors[i]`` / ``importances[i]`` are trees of
    one structure (one anchor and importance per past task). Each task's
    term runs as a few ``torch._foreach_*`` calls over the leaves, in
    fp32. Under a sharding ``mesh`` the trees hold this rank's shards:
    each leaf's part is summed over the axes it is sharded on
    (parallel/sharding.whole_sums; a replicated leaf's is whole already),
    so every rank holds the whole penalty and the gradient of its own
    shards."""
    p = flatten_tree(params)
    names = list(p)
    ps = [p[k].float() for k in names]
    per_leaf = [t.new_zeros(()) for t in ps]
    for anchor, imp in zip(anchors, importances):
        a, w = flatten_tree(anchor), flatten_tree(imp)
        d = torch._foreach_sub(ps, [a[k].float() for k in names])
        terms = torch._foreach_mul(torch._foreach_mul(d, d),
                                   [w[k].float() for k in names])
        per_leaf = [s + t.sum() for s, t in zip(per_leaf, terms)]
    total = torch.stack(sharding.whole_sums(mesh, names, ps,
                                            per_leaf)).sum()
    return lam * total
