"""Regularization baseline family: Retrain / Replay / L2 / EWC / MAS (port
of gslora_tpu/baselines/regularization.py).

Reference mechanics (engine_cl.py:463-568 train_one_epoch_regularzation +
closures train_own_forget_cl.py:1414-1692):
* train on the randomly relabeled forget subset ("forget by wrong label");
  Replay concatenates relabeled forget + remain; Retrain trains a fresh
  model on remain only with lambda = 0;
* loss = CE + lambda * sum_tasks sum_n importance_n * (p - p*_n)^2;
* importance: L2 -> ones; EWC -> accumulated squared CE gradients weighted
  len(batch) / len(loader); MAS -> accumulated |grad| of the mean squared
  logits / len(loader);
* after each task the current params and the next importance are
  appended.

Every parameter trains except the margin head, which every reference
baseline branch freezes unless --ffn_open (baselines/freeze.py);
--only_ffn narrows it to the FFN Linears and the head.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict, List, Optional

import torch

from gslora_tpu_torch.baselines.common import (final_accuracies,
                                               global_counts, put_trees,
                                               rank_generator, stream_grads,
                                               to_device, valid_count,
                                               whole_tree)
from gslora_tpu_torch.baselines.freeze import freeze_flags, trains
from gslora_tpu_torch.config import LoraConfig, RunConfig, ViTConfig
from gslora_tpu_torch.engine.evaluate import eval_accuracy, h_mean, \
    make_eval_step
from gslora_tpu_torch.engine.loop import _dtype, resolve_device
from gslora_tpu_torch.engine.pretrain import PretrainState
from gslora_tpu_torch.engine.schedule import timm_cosine_lr
from gslora_tpu_torch.engine.state import make_optimizer
from gslora_tpu_torch.losses.classification import cross_entropy, \
    top1_accuracy
from gslora_tpu_torch.losses.regularization import quadratic_penalty
from gslora_tpu_torch.metrics.logging import MetricLogger
from gslora_tpu_torch.models.convert import flatten_tree, unflatten_tree
from gslora_tpu_torch.models.vit import ViT, vit_apply
from gslora_tpu_torch.parallel import sharding
from gslora_tpu_torch.parallel.mesh import (check_baseline_placement,
                                            set_active)
from gslora_tpu_torch.utils.trees import tree_map


def make_reg_step(model: ViTConfig, lora: LoraConfig, optimizer,
                  compute_dtype=torch.bfloat16, grad_accum: int = 1,
                  mesh=None):
    """step(state, x, y, anchors, importances, lam, lr, generator=None)
    -> (state, metrics); one term of the penalty per anchor.

    The CE is the masked sum over this rank's rows (micro-batches under
    ``grad_accum``) divided by the global batch's valid count
    (baselines/common.stream_grads), so micro-batches and the ranks of
    ``mesh`` add up to the global batch's gradient. The quadratic penalty
    does not depend on the data: its gradient is added once, after the
    all_reduce, on every rank alike (``stream_grads(fixed=...)``), not
    once per rank. A batch ``grad_accum`` does not divide runs whole.
    Under a sharding ``mesh`` the state, the anchors and the importances
    hold this rank's shards: the penalty sums each leaf's part over its
    shards, and the gradients are summed as each leaf's layout asks
    (parallel/sharding.sync_grads)."""

    def step(state: PretrainState, x, y, anchors, importances, lam: float,
             lr: float, generator: Optional[torch.Generator] = None):
        leaves = state.trainable_params()
        params = state.params
        (n,) = global_counts(mesh, y)

        def sums_fn(xm, ym):
            v = valid_count(ym)
            logits, _ = vit_apply(params, xm, ym, model, lora, train=True,
                                  generator=generator,
                                  compute_dtype=compute_dtype)
            return {"ce": cross_entropy(logits, ym) * v,
                    "acc": top1_accuracy(logits, ym) * v}

        def combine(s):
            m = {"loss_CE": s["ce"] / n, "acc": s["acc"] / n}
            return m["loss_CE"], m

        reg = quadratic_penalty(params, anchors, importances, lam, mesh) \
            if anchors else torch.zeros((), device=y.device)
        grads, metrics = stream_grads(sums_fn, combine, leaves,
                                      state.trainable_names(), (x, y),
                                      grad_accum, mesh, fixed=reg)
        metrics["loss_regularization"] = reg.detach()
        optimizer.update(leaves, grads, state.opt_state, lr)
        state.step += 1
        return state, metrics

    return step


def estimate_importance(method: str, params, batches, model: ViTConfig,
                        lora: LoraConfig, compute_dtype=torch.bfloat16,
                        grad_accum: int = 1, mesh=None):
    """Importance tree of one task over every parameter
    (train_own_forget_cl.py:1425-1569), fp32, on the parameters' device.
    ``batches``: (images, labels) numpy batches, streamed (a BatchLoader:
    materializing a decoded split would cost tens of GB at ImageNet
    scale); under ``mesh`` each rank's rows of the global batches.

    Each batch's loss is the masked sum over this rank's rows (in
    ``grad_accum`` micro-batches, as the training step splits them)
    divided by the global batch's valid count; the gradient is summed
    over the micro-batches and the ranks (baselines/common.stream_grads)
    BEFORE it is squared (EWC) or its absolute value taken (MAS): a sum of
    per-rank squares would be another Fisher: under sp that sum takes in
    the ``model`` sum of the leaves each rank holds a part of the
    gradient of (parallel/sharding.sync_grads). ``len(batches)`` counts
    global batches, the same number on every rank. ``params`` is the
    whole tree (on every rank alike); under a sharding mesh each rank
    differentiates its shards of it and the whole importance tree is
    gathered at the end."""
    if method == "l2":
        return tree_map(torch.ones_like, params)
    if method not in ("ewc", "mas"):
        raise ValueError(f"unknown importance method {method}")
    n = len(batches)
    set_active(mesh)
    # detached leaves that require grad, made once for every batch
    flat = {k: v.detach().requires_grad_(True)
            for k, v in flatten_tree(sharding.shard_tree(mesh,
                                                         params)).items()}
    names = list(flat)
    leaves = [flat[k] for k in names]
    tree = unflatten_tree(flat)
    device = leaves[0].device
    imp = {k: torch.zeros_like(v, dtype=torch.float32)
           for k, v in flat.items()}

    def sums_fn(x, y):
        logits, _ = vit_apply(tree, x, y, model, lora, train=False,
                              compute_dtype=compute_dtype)
        if method == "ewc":
            # the CE of valid rows (the -1 pad sentinel masked)
            return {"loss": cross_entropy(logits, y) * valid_count(y)}
        # logits^2 over valid rows only, so a padded tail batch gives the
        # reference's unpadded batch
        sq = torch.mean(logits.float() ** 2, dim=1)
        return {"loss": torch.sum(sq * (y >= 0).float())}

    for x, y in batches:
        x, y = to_device(device, x, y)
        (count,) = global_counts(mesh, y)
        grads, _ = stream_grads(sums_fn, lambda s: (s["loss"] / count, {}),
                                leaves, names, (x, y), grad_accum, mesh)
        for k, g in zip(names, grads):
            g = g.float()
            if method == "ewc":
                # each batch weighs len(batch) / len(loader) as in the
                # reference (:1505-1510), counting the global batch's
                # valid rows only
                imp[k] += (g * g) * (int(count) / n)
            else:
                imp[k] += g.abs() / n
    out = whole_tree(mesh, unflatten_tree(imp))
    if "base" in params:
        out.setdefault("lora", {})
    return out


def run_regularization_task(cfg: RunConfig, params, train_loader_factory,
                            test_batches_f: Callable,
                            test_batches_r: Callable, *, lam: float,
                            anchors: List, importances: List,
                            num_epoch: Optional[int] = None, logger=None,
                            eval_every: Optional[int] = None,
                            test_batches_open: Optional[Callable] = None,
                            mesh=None) -> Dict[str, Any]:
    """One task of reg-baseline training on ``cfg.device``.
    ``train_loader_factory()`` gives the epoch's batches (relabeled forget,
    remain for Retrain, or the Replay concat). Returns the trained tree
    (``params``) and the accuracies.

    ``mesh``: an optional parallel/mesh.DataMesh, as JAX's ``mesh``: the
    starting parameters, anchors and importances (whole trees) are
    broadcast from rank 0 and each rank keeps its shards of them under
    the mesh's layout (JAX's ``put_params``; baselines/common.put_trees),
    every loader gives this rank's rows of the global batches
    (parallel/multihost.process_sharded_loader), the loss is the global
    batch's, and the evals sum their counts over the ranks; the returned
    ``params`` are whole on every rank."""
    check_baseline_placement(cfg.mesh, mesh)
    set_active(mesh)
    device = resolve_device(cfg.device)
    cdt = _dtype(cfg)
    logger = logger or MetricLogger()
    opt = make_optimizer(cfg.optim)
    step = make_reg_step(cfg.model, cfg.lora, opt, compute_dtype=cdt,
                         grad_accum=cfg.optim.grad_accum, mesh=mesh)
    params, *trees = put_trees(mesh, device, params, *anchors,
                               *importances)
    anchors, importances = trees[:len(anchors)], trees[len(anchors):]
    state = PretrainState.create(ViT(params, cfg.model, cfg.lora), opt,
                                 trains=partial(trains, **freeze_flags(cfg)))
    eval_step = make_eval_step(cfg.model, cfg.lora, compute_dtype=cdt)

    def accuracy(batches):
        return eval_accuracy(eval_step, state.params, batches, mesh=mesh)

    facc_before = accuracy(test_batches_f())
    best_h = float("-inf")
    generator = rank_generator(cfg, device, mesh)
    batch = 0
    n_ep = num_epoch if num_epoch is not None else cfg.num_epoch
    eval_every = eval_every or cfg.ver_freq
    for epoch in range(n_ep):
        lr = timm_cosine_lr(cfg.optim, epoch)
        for x, y in train_loader_factory():
            x, y = to_device(device, x, y)
            state, metrics = step(state, x, y, anchors, importances, lam, lr,
                                  generator)
            if (batch + 1) % cfg.disp_freq == 0:
                logger.log({k: float(v) for k, v in metrics.items()},
                           step=batch)
            if (batch + 1) % eval_every == 0:
                facc = accuracy(test_batches_f())
                racc = accuracy(test_batches_r())
                best_h = max(best_h, h_mean(facc_before, facc, racc,
                                            eps=1e-8))
            batch += 1

    facc, racc, oacc = final_accuracies(eval_step, state.params,
                                        test_batches_f, test_batches_r,
                                        test_batches_open, mesh=mesh)
    best_h = max(best_h, h_mean(facc_before, facc, racc, eps=1e-8))
    return {"params": whole_tree(mesh, state.params), "forget_acc_before":
            facc_before, "forget_acc": facc, "remain_acc": racc,
            "open_acc": oacc, "best_h": best_h}
