"""Supervised pretraining step (port of gslora_tpu/engine/pretrain.py;
reference train/train_own.py).

One call: forward + CE (or SFace's own loss) + gradient + optimizer update
over the parameters that ``PretrainState.create`` scoped to train: ALL of
them, the LoRA subtree only (``is_lora``, the reference's
mark_only_lora_as_trainable when a rank is set and a base checkpoint is
resumed, train_own.py:385-386), or the baselines' scope
(baselines/freeze.trains). Parameters update in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

from gslora_tpu_torch.config import LoraConfig, ViTConfig
from gslora_tpu_torch.losses.classification import cross_entropy, \
    top1_accuracy
from gslora_tpu_torch.models.heads import sface_head
from gslora_tpu_torch.models.vit import ViT, vit_apply, vit_embed
from gslora_tpu_torch.parallel.multihost import check_local_feed
from gslora_tpu_torch.parallel.sharding import fsdp_on, sync_grads, \
    sync_model_grads
from gslora_tpu_torch.utils.trees import PairwiseSum


@dataclass
class PretrainState:
    """The model, the optimizer's state for the trainable parameters and
    the step count."""

    model: ViT
    opt_state: Dict
    step: int = 0

    @classmethod
    def create(cls, model: ViT, optimizer,
               trains: Optional[Callable[[str], bool]] = None
               ) -> "PretrainState":
        """``trains``: the parameters that train, by name (all when None).
        Only they require grad and have optimizer state: torch optimizers
        skip parameters whose grad stays None, so a LoRA-only run
        (``is_lora``) holds no base moments and applies no base weight
        decay (train_own.py:386), and a frozen baseline head none either
        (baselines/freeze.trains)."""
        for name, p in model.named_parameters():
            p.requires_grad_(trains is None or trains(name))
        state = cls(model=model, opt_state={})
        state.opt_state = optimizer.init(state.trainable_params())
        return state

    def trainable_params(self) -> List[torch.nn.Parameter]:
        return [p for p in self.model.parameters() if p.requires_grad]

    def trainable_names(self) -> List[str]:
        """The dotted names of :meth:`trainable_params`, in its order."""
        return [n for n, p in self.model.named_parameters()
                if p.requires_grad]

    @property
    def params(self) -> Dict:
        return self.model.tree()


def is_lora(name: str) -> bool:
    """The ``trains`` scope of LoRA-only pretraining."""
    return name.startswith("lora.")


def _accumulated(grad_fn: Callable, n: int, accum_dtype=torch.float32,
                 mesh=None, names=()):
    """Wrap ``grad_fn(x, y) -> (grads, metrics)`` to run over ``n`` equal
    micro-batches, weighted to the exact full-batch masked mean (JAX
    ``_accumulated``, pretrain.py:41-108).

    Each micro-batch's grads and metrics are masked means over its valid
    samples (label >= 0); scaled by that count they are masked sums, and
    their sum over the micro-batches divided by the global valid count is
    the full-batch mean, padded tails included (an all-padding micro-batch
    adds zero). The sums are added as a tree (utils/trees.PairwiseSum)
    and kept in ``accum_dtype`` (fp32 by default, also
    for bf16 parameters: autograd's own ``.grad`` accumulation would sum in
    the parameter's dtype) and cast back to each leaf's dtype at the end.
    A batch that ``n`` does not divide runs as one full-batch call.

    ``mesh`` (parallel/mesh.DataMesh): each rank passes its rows of the
    global batch, and the sums and the count are summed over the ranks (one
    all_reduce over flat buckets: the full-model gradient, 19 M parameters
    at the flagship, goes in 16 MiB buckets) before the division, so the
    mean is the global batch's, as in the JAX step under a mesh. Under sp
    and pp the gradients that are a rank's part over ``model`` (``names``
    say which, parallel/sharding.sync_model_grads) are summed over that
    axis first."""
    def accum(x, y):
        b = x.shape[0]
        parts = n if b % n == 0 else 1
        if parts == 1 and mesh is None:
            return grad_fn(x, y)
        sums = PairwiseSum()
        for xm, ym in zip(x.split(b // parts), y.split(b // parts)):
            valid = torch.sum((ym >= 0).to(accum_dtype))
            grads, metrics = grad_fn(xm, ym)
            leaves = list(grads) + [m.detach() for m in metrics.values()]
            dtypes = [t.dtype for t in leaves]
            sums.add([t.to(accum_dtype) * valid for t in leaves] +
                     [valid.reshape(1)])
        *total, count = sums.total()
        if mesh is not None:
            sync_model_grads(mesh, names, total[:len(grads)])
            mesh.all_reduce_(total + [count])
        denom = torch.clamp(count[0], min=1.0)
        out = [(t / denom).to(dt) for t, dt in zip(total, dtypes)]
        return out[:len(grads)], dict(zip(metrics, out[len(grads):]))

    return accum


def _accumulated_fsdp(grad_fn: Callable, n: int, names, mesh,
                      accum_dtype=torch.float32):
    """:func:`_accumulated` for a mesh with fsdp shards, whose gradients
    come out of the backward already summed over the data axis
    (parallel/sharding.gather_from_data): so the global valid count is
    summed first (over the batch axis, dcn x data), and each micro-batch
    differentiates its masked mean times ``valid / count``
    (``grad_fn(x, y, weight)``), its part of the global mean; the
    micro-gradients add up in ``accum_dtype``, then the shards' cross
    ``dcn`` and the other leaves' are summed over the batch axis
    (``sync_grads``). The metrics are masked sums over the global count,
    as there."""
    def accum(x, y):
        b = x.shape[0]
        parts = n if b % n == 0 else 1
        count = torch.sum((y >= 0).to(accum_dtype)).reshape(1)
        mesh.all_reduce_([count])
        denom = torch.clamp(count[0], min=1.0)
        grad_sums, metric_sums = PairwiseSum(), PairwiseSum()
        for xm, ym in zip(x.split(b // parts), y.split(b // parts)):
            valid = torch.sum((ym >= 0).to(accum_dtype))
            grads, metrics = grad_fn(xm, ym, valid / denom)
            dtypes = [g.dtype for g in grads]
            grad_sums.add([g.to(accum_dtype) for g in grads])
            metric_sums.add([m.detach().to(accum_dtype) * valid
                             for m in metrics.values()])
        grads, msums = grad_sums.total(), metric_sums.total()
        sync_grads(mesh, names, grads)
        mesh.all_reduce_(msums)
        return [g.to(dt) for g, dt in zip(grads, dtypes)], \
            {k: v / denom for k, v in zip(metrics, msums)}

    return accum


def make_pretrain_step(model: ViTConfig, lora: LoraConfig, optimizer,
                       compute_dtype=torch.bfloat16, grad_accum: int = 1,
                       accum_dtype=torch.float32, mesh=None):
    """step(state, x, y, lr, generator=None) -> (state, metrics).

    The loss is CE over the margin head's logits (CosFace, ArcFace,
    Softmax) or SFace's own loss on the embedding; metrics ``loss`` and
    ``acc``; labels -1 (padding) are masked. ``grad_accum > 1`` splits each
    batch into that many micro-batches with one optimizer update
    (``_accumulated``); ``state`` is updated in place and returned.

    ``mesh`` (parallel/mesh.DataMesh): each rank passes its rows of the
    global batch, and the loss is the masked mean over the global batch
    (``_accumulated``; ``_accumulated_fsdp`` under fsdp), with or without
    ``grad_accum``. On a ``(dcn, data, model)`` mesh the sums run over
    the batch axis (dcn x data): the model's collectives give each rank
    of a model group the whole gradient of its own shards; fsdp's come
    summed over ``data`` (within the slice) out of the backward and cross
    ``dcn`` in ``sync_grads``; under sp and pp the gradients that are a
    rank's part over ``model`` are summed over that axis
    (parallel/sharding.sync_model_grads)."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def loss_fn(params, x, y, generator):
        kw = dict(train=True, generator=generator,
                  compute_dtype=compute_dtype)
        if model.head_type == "SFace":
            emb = vit_embed(params, x, model, lora, **kw)
            logits, loss, *_ = sface_head(params["base"]["head"], emb, y)
        else:
            logits, _ = vit_apply(params, x, y, model, lora, **kw)
            loss = cross_entropy(logits, y)
        return loss, {"loss": loss, "acc": top1_accuracy(logits, y)}

    def step(state: PretrainState, x, y, lr: float,
             generator: Optional[torch.Generator] = None):
        if mesh is not None:  # each rank feeds its rows, not the batch
            check_local_feed(mesh, x.shape[0])
        leaves = state.trainable_params()
        params = state.params

        def grad_fn(xm, ym, weight=None):
            loss, metrics = loss_fn(params, xm, ym, generator)
            if weight is not None:
                loss = loss * weight
            return torch.autograd.grad(loss, leaves), metrics

        if fsdp_on(mesh):
            grads, metrics = _accumulated_fsdp(
                grad_fn, grad_accum, state.trainable_names(), mesh,
                accum_dtype)(x, y)
        elif grad_accum > 1 or mesh is not None:
            grads, metrics = _accumulated(grad_fn, grad_accum, accum_dtype,
                                          mesh, state.trainable_names())(
                                              x, y)
        else:
            grads, metrics = grad_fn(x, y)
        optimizer.update(leaves, grads, state.opt_state, lr)
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def pretrain(cfg, params, train_batches_fn, epochs: int,
             compute_dtype=torch.bfloat16, lr: Optional[float] = None,
             seed: int = 0, lora_only: bool = False):
    """Minimal pretraining loop over a callable returning an epoch iterator
    of (x, y) batches (numpy or tensors), on ``cfg.device``; the per-epoch
    lr is ``timm_cosine_lr`` unless ``lr`` is given."""
    from gslora_tpu_torch.engine.loop import resolve_device
    from gslora_tpu_torch.engine.schedule import timm_cosine_lr
    from gslora_tpu_torch.engine.state import make_optimizer

    device = resolve_device(cfg.device)
    opt = make_optimizer(cfg.optim)
    state = PretrainState.create(
        ViT(params, cfg.model, cfg.lora).to(device), opt,
        trains=is_lora if lora_only else None)
    step = make_pretrain_step(cfg.model, cfg.lora, opt,
                              compute_dtype=compute_dtype,
                              grad_accum=cfg.optim.grad_accum)
    generator = torch.Generator(device=device).manual_seed(seed)
    metrics = {}
    for epoch in range(epochs):
        ep_lr = lr if lr is not None else timm_cosine_lr(cfg.optim, epoch)
        for x, y in train_batches_fn():
            state, metrics = step(state, torch.as_tensor(x).to(device),
                                  torch.as_tensor(y).to(device), ep_lr,
                                  generator)
    return state, metrics
