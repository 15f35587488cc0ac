"""What the baseline runners share: batches onto the device, the trees
onto the mesh and back, the last evals of a task, the valid counts of a
global batch, and the per-stream gradient accumulation every baseline
step goes through."""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gslora_tpu_torch.engine.continual import detached
from gslora_tpu_torch.engine.evaluate import eval_accuracy
from gslora_tpu_torch.models.convert import flatten_tree
from gslora_tpu_torch.parallel import sharding
from gslora_tpu_torch.parallel.multihost import check_local_feed
from gslora_tpu_torch.utils.trees import PairwiseSum


def to_device(device: torch.device, *arrays) -> List[torch.Tensor]:
    """numpy batches (images, labels, ...) as tensors on ``device``."""
    return [torch.from_numpy(np.asarray(a)).to(device) for a in arrays]


def valid_count(labels: torch.Tensor) -> torch.Tensor:
    """Rows not labelled -1 (the pad sentinel), as an fp32 scalar."""
    return torch.sum((labels >= 0).float())


def global_counts(mesh, *labels: torch.Tensor) -> List[torch.Tensor]:
    """The valid rows of each stream's global batch, clamped to at least 1
    (the masked means' denominators): this rank's counts, summed over the
    batch axis under a mesh (one all_reduce of a small fp32 vector).
    Every rank passes its rows (``check_local_feed``)."""
    for y in labels:
        check_local_feed(mesh, y.shape[0])
    counts = torch.stack([valid_count(y) for y in labels])
    if mesh is not None:
        mesh.all_reduce_([counts])
    return list(torch.clamp(counts, min=1.0).unbind())


def put_trees(mesh, device: torch.device, *trees) -> List:
    """Each whole parameter tree on ``device`` as plain tensors, rank 0's
    on every rank, and this rank's shards of it under ``mesh``
    (parallel/sharding.shard_tree: JAX's ``put_params``); the trees
    themselves without a mesh."""
    out = [detached(t, device) for t in trees]
    if mesh is not None:
        mesh.broadcast_([t for tree in out
                         for t in flatten_tree(tree).values()])
    return [sharding.shard_tree(mesh, t) for t in out]


def whole_tree(mesh, tree) -> Dict:
    """The whole tree of plain tensors from this rank's shards, on every
    rank (a collective under a sharding mesh: every rank calls it)."""
    return detached(sharding.gather_tree(mesh, tree))


def rank_generator(cfg, device: torch.device, mesh) -> torch.Generator:
    """The dropout stream of a runner: under a mesh each batch block draws
    its rows' masks from a stream of its own (seed + 7919·block; block
    0's is the one-process stream), as engine/loop does."""
    block = 0 if mesh is None else mesh.block
    return torch.Generator(device=device).manual_seed(cfg.data.seed +
                                                      7919 * block)


def final_accuracies(eval_step, params, test_batches_f: Callable,
                     test_batches_r: Callable,
                     test_batches_open: Optional[Callable] = None,
                     mesh=None) -> Tuple[float, float, Optional[float]]:
    """Forget, remain and (when given) open-set accuracy after a task; the
    counts are summed over the ranks under a mesh."""
    facc = eval_accuracy(eval_step, params, test_batches_f(), mesh=mesh)
    racc = eval_accuracy(eval_step, params, test_batches_r(), mesh=mesh)
    oacc = eval_accuracy(eval_step, params, test_batches_open(),
                         mesh=mesh) if test_batches_open else None
    return facc, racc, oacc


def stream_grads(sums_fn: Callable, combine: Callable,
                 leaves: Sequence[torch.Tensor], names: Sequence[str],
                 streams: Sequence[torch.Tensor], grad_accum: int,
                 mesh=None, fixed: Optional[torch.Tensor] = None
                 ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """Gradient of ``leaves`` and the metrics of a loss that mixes masked
    means over several streams (and raw sums), optionally over
    micro-batches (the JAX package's ``_accum_grads`` of
    baselines/distill.py and baselines/lirf.py) and over the ranks of a
    data mesh.

    ``streams``: the step's tensors, images and labels of each stream (a
    rank's rows under a mesh); each is split into ``grad_accum`` equal
    micro-batches, or run whole when ``grad_accum`` does not divide one of
    them. ``sums_fn(*micro)`` returns the masked per-sample SUMS of each
    term over one micro-batch (a masked mean times its valid count).
    ``combine(sums) -> (total, metrics)`` divides them by the GLOBAL valid
    counts of the step (:func:`global_counts`), so the micro-gradients and
    the ranks' gradients add up to the global batch's gradient exactly:
    every term is linear in per-sample statistics. Gradients add up in
    fp32 as a tree (utils/trees.PairwiseSum), then the gradients are
    summed over the ranks by parallel/sharding.sync_grads (``names``: the
    leaves' dotted names, which say how each is sharded: an fsdp shard's
    gradient comes out of the backward summed over ``data`` and crosses
    ``dcn`` alone, one that sp or pp leaves a rank's part of is summed
    over ``model`` first, a tp shard's is the rank's own; the others go
    over the batch axis) and one all_reduce takes the sums before
    ``combine`` gives the metrics; so two ranks equal one process with
    twice the micro-batches to the bit.

    ``fixed``: a term of the loss that does not depend on the data (a
    quadratic penalty, an SWA distance), as a 0-dim tensor with its
    graph, the same value on every rank (summed over the shards inside).
    Its gradient joins after the sums, on every rank alike and local to
    each shard, so it counts once, not once per micro-batch or rank; its
    value joins ``loss_total``. Gradients are cast back to each leaf's
    dtype at the end."""
    n = grad_accum
    if any(t.shape[0] % n for t in streams):
        n = 1
    parts = [t.split(t.shape[0] // n) for t in streams]
    gsum, ssum = PairwiseSum(), PairwiseSum()
    for i in range(n):
        sums = sums_fn(*(p[i] for p in parts))
        keys = sorted(sums)
        total, _ = combine(sums)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        gsum.add([torch.zeros_like(p, dtype=torch.float32) if g is None
                  else g.float() for g, p in zip(grads, leaves)])
        ssum.add([sums[k].detach().float() for k in keys])
    grads = gsum.total()
    flat = torch.stack(ssum.total())
    if mesh is not None:
        sharding.sync_grads(mesh, names, grads)
        mesh.all_reduce_([flat])
    total, metrics = combine(dict(zip(keys, flat.unbind())))
    if fixed is not None:
        if fixed.requires_grad:
            extra = torch.autograd.grad(fixed, leaves, allow_unused=True)
            grads = [g if e is None else g + e.float()
                     for g, e in zip(grads, extra)]
        total = total + fixed.detach()
    metrics["loss_total"] = total
    return ([g.to(p.dtype) for g, p in zip(grads, leaves)],
            {k: v.detach() for k, v in metrics.items()})
