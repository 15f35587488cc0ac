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

import numpy as np
import torch

from gslora_tpu_torch.baselines.common import (final_accuracies, to_device)
from gslora_tpu_torch.baselines.freeze import freeze_flags, trains
from gslora_tpu_torch.config import LoraConfig, RunConfig, ViTConfig
from gslora_tpu_torch.engine.continual import detached
from gslora_tpu_torch.engine.evaluate import eval_accuracy, h_mean, \
    make_eval_step
from gslora_tpu_torch.engine.loop import _dtype, resolve_device
from gslora_tpu_torch.engine.pretrain import PretrainState, _accumulated
from gslora_tpu_torch.engine.schedule import timm_cosine_lr
from gslora_tpu_torch.engine.state import make_optimizer
from gslora_tpu_torch.losses.classification import cross_entropy, \
    top1_accuracy
from gslora_tpu_torch.losses.regularization import quadratic_penalty
from gslora_tpu_torch.metrics.logging import MetricLogger
from gslora_tpu_torch.models.convert import flatten_tree, unflatten_tree
from gslora_tpu_torch.models.vit import ViT, vit_apply
from gslora_tpu_torch.parallel.mesh import check_baseline_placement
from gslora_tpu_torch.utils.trees import tree_map


def make_reg_step(model: ViTConfig, lora: LoraConfig, optimizer,
                  compute_dtype=torch.bfloat16, grad_accum: int = 1):
    """step(state, x, y, anchors, importances, lam, lr, generator=None)
    -> (state, metrics); one term of the penalty per anchor.

    ``grad_accum > 1`` splits the batch through engine/pretrain's
    ``_accumulated``, which is exact here: the loss is a masked-mean CE
    plus a penalty that does not depend on the data (its valid-count
    weighted sum over the micro-batches is the penalty itself). A batch
    it does not divide runs whole."""

    def loss_fn(params, x, y, anchors, importances, lam, generator):
        logits, _ = vit_apply(params, x, y, model, lora, train=True,
                              generator=generator,
                              compute_dtype=compute_dtype)
        ce = cross_entropy(logits, y)
        reg = quadratic_penalty(params, anchors, importances, lam) \
            if anchors else torch.zeros((), device=ce.device)
        total = ce + reg
        return total, {"loss_CE": ce, "loss_regularization": reg,
                       "loss_total": total, "acc": top1_accuracy(logits, y)}

    def step(state: PretrainState, x, y, anchors, importances, lam: float,
             lr: float, generator: Optional[torch.Generator] = None):
        leaves = state.trainable_params()
        params = state.params

        def grad_fn(xm, ym):
            loss, metrics = loss_fn(params, xm, ym, anchors, importances,
                                    lam, generator)
            return torch.autograd.grad(loss, leaves), metrics

        if grad_accum > 1:
            grads, metrics = _accumulated(grad_fn, grad_accum)(x, y)
        else:
            grads, metrics = grad_fn(x, y)
        optimizer.update(leaves, grads, state.opt_state, lr)
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def estimate_importance(method: str, params, batches, model: ViTConfig,
                        lora: LoraConfig, compute_dtype=torch.bfloat16):
    """Importance tree of one task over every parameter
    (train_own_forget_cl.py:1425-1569), fp32, on the parameters' device.
    ``batches``: (images, labels) numpy batches, streamed (a BatchLoader:
    materializing a decoded split would cost tens of GB at ImageNet
    scale)."""
    if method == "l2":
        return tree_map(torch.ones_like, params)
    if method not in ("ewc", "mas"):
        raise ValueError(f"unknown importance method {method}")
    n = len(batches)
    # detached leaves that require grad, made once for every batch
    flat = {k: v.detach().requires_grad_(True)
            for k, v in flatten_tree(params).items()}
    names = list(flat)
    leaves = [flat[k] for k in names]
    tree = unflatten_tree(flat)
    device = leaves[0].device
    imp = {k: torch.zeros_like(v, dtype=torch.float32)
           for k, v in flat.items()}
    for x, y in batches:
        valid = int((np.asarray(y) >= 0).sum())
        x, y = to_device(device, x, y)
        logits, _ = vit_apply(tree, x, y, model, lora, train=False,
                              compute_dtype=compute_dtype)
        w = (y >= 0).float()
        if method == "ewc":
            loss = cross_entropy(logits, y)  # masks the -1 pad sentinel
        else:
            # mean of logits^2 over valid rows only, so a padded tail batch
            # gives the reference's unpadded batch
            sq = torch.mean(logits.float() ** 2, dim=1)
            loss = torch.sum(sq * w) / torch.clamp(torch.sum(w), min=1.0)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        for k, g in zip(names, grads):
            if g is None:
                continue
            g = g.float()
            if method == "ewc":
                # each batch weighs len(batch) / len(loader) as in the
                # reference (:1505-1510), counting valid rows only
                imp[k] += (g * g) * (valid / n)
            else:
                imp[k] += g.abs() / n
    out = unflatten_tree(imp)
    if "base" in params:
        out.setdefault("lora", {})
    return out


def run_regularization_task(cfg: RunConfig, params, train_loader_factory,
                            test_batches_f: Callable,
                            test_batches_r: Callable, *, lam: float,
                            anchors: List, importances: List,
                            num_epoch: Optional[int] = None, logger=None,
                            eval_every: Optional[int] = None,
                            test_batches_open: Optional[Callable] = None
                            ) -> Dict[str, Any]:
    """One task of reg-baseline training on ``cfg.device``.
    ``train_loader_factory()`` gives the epoch's batches (relabeled forget,
    remain for Retrain, or the Replay concat). Returns the trained tree
    (``params``) and the accuracies."""
    check_baseline_placement(cfg.mesh)
    device = resolve_device(cfg.device)
    cdt = _dtype(cfg)
    logger = logger or MetricLogger()
    opt = make_optimizer(cfg.optim)
    step = make_reg_step(cfg.model, cfg.lora, opt, compute_dtype=cdt,
                         grad_accum=cfg.optim.grad_accum)
    state = PretrainState.create(
        ViT(params, cfg.model, cfg.lora).to(device), opt,
        trains=partial(trains, **freeze_flags(cfg)))
    anchors = [detached(a, device) for a in anchors]
    importances = [detached(i, device) for i in importances]
    eval_step = make_eval_step(cfg.model, cfg.lora, compute_dtype=cdt)

    facc_before = eval_accuracy(eval_step, state.params, test_batches_f())
    best_h = float("-inf")
    generator = torch.Generator(device=device).manual_seed(cfg.data.seed)
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
                facc = eval_accuracy(eval_step, state.params,
                                     test_batches_f())
                racc = eval_accuracy(eval_step, state.params,
                                     test_batches_r())
                best_h = max(best_h, h_mean(facc_before, facc, racc,
                                            eps=1e-8))
            batch += 1

    facc, racc, oacc = final_accuracies(eval_step, state.params,
                                        test_batches_f, test_batches_r,
                                        test_batches_open)
    best_h = max(best_h, h_mean(facc_before, facc, racc, eps=1e-8))
    return {"params": detached(state.params), "forget_acc_before":
            facc_before, "forget_acc": facc, "remain_acc": racc,
            "open_acc": oacc, "best_h": best_h}
