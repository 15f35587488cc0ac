"""What the baseline runners share: batches onto the device, the last
evals of a task, and the per-stream gradient accumulation of the
teacher-student families."""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gslora_tpu_torch.engine.evaluate import eval_accuracy


def to_device(device: torch.device, *arrays) -> List[torch.Tensor]:
    """numpy batches (images, labels, ...) as tensors on ``device``."""
    return [torch.from_numpy(np.asarray(a)).to(device) for a in arrays]


def valid_count(labels: torch.Tensor) -> torch.Tensor:
    """Rows not labelled -1 (the pad sentinel), as an fp32 scalar."""
    return torch.sum((labels >= 0).float())


def final_accuracies(eval_step, params, test_batches_f: Callable,
                     test_batches_r: Callable,
                     test_batches_open: Optional[Callable] = None
                     ) -> Tuple[float, float, Optional[float]]:
    """Forget, remain and (when given) open-set accuracy after a task."""
    facc = eval_accuracy(eval_step, params, test_batches_f())
    racc = eval_accuracy(eval_step, params, test_batches_r())
    oacc = eval_accuracy(eval_step, params, test_batches_open()) \
        if test_batches_open else None
    return facc, racc, oacc


def stream_grads(sums_fn: Callable, combine: Callable,
                 leaves: Sequence[torch.Tensor],
                 streams: Sequence[torch.Tensor], grad_accum: int
                 ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """Gradient of ``leaves`` and the metrics of a loss that mixes masked
    means over several streams (and raw sums), optionally over
    micro-batches (the JAX package's ``_accum_grads`` of
    baselines/distill.py and baselines/lirf.py).

    ``streams``: the step's tensors, images and labels of each stream;
    each is split into ``grad_accum`` equal micro-batches, or run whole
    when ``grad_accum`` does not divide one of them. ``sums_fn(*micro)``
    returns the masked per-sample SUMS of each term over one micro-batch
    (a masked mean times its valid count). ``combine(sums) -> (total,
    metrics)`` divides them by the global valid counts of the step, so
    the micro-gradients add up to the full-batch gradient exactly: every
    term is linear in per-sample statistics. Gradients add up in fp32 and
    are cast back to each leaf's dtype."""
    n = grad_accum
    if any(t.shape[0] % n for t in streams):
        n = 1
    parts = [t.split(t.shape[0] // n) for t in streams]
    gsum, ssum = None, {}
    for i in range(n):
        sums = sums_fn(*(p[i] for p in parts))
        total, _ = combine(sums)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(p, dtype=torch.float32) if g is None
                 else g.float() for g, p in zip(grads, leaves)]
        gsum = grads if gsum is None else [a.add_(g) for a, g in
                                           zip(gsum, grads)]
        for k, v in sums.items():
            ssum[k] = ssum[k] + v.detach() if k in ssum else v.detach()
    total, metrics = combine(ssum)
    metrics["loss_total"] = total
    return ([g.to(p.dtype) for g, p in zip(gsum, leaves)],
            {k: v.detach() for k, v in metrics.items()})
