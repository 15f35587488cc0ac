"""Teacher-student baseline family: LwF, DER, DER++, FDR (port of
gslora_tpu/baselines/distill.py).

One step per method (reference loops baselines/Lwftrain.py, DERtrain.py,
FDRtrain.py): student CE on the relabeled forget batch plus a
teacher-anchored term on a cycled remain batch. The teacher is the
ORIGINAL pretrained model: the reference deep-copies it once before the
CL task loop (train_own_forget_cl.py:453-476, loop at :515), so every
task gets the same pretrained ``teacher_params`` (cli/train_forget_cl passes
them). Its forward runs without a graph.

Loss terms:
* DER   (DERtrain.py:12-16):  ||emb_r - emb_teacher_r||_2^2 (a SUM of
  squares); DER++ (:80-92) adds lambda_plus * CE(student, a second remain
  batch);
* FDR   (FDRtrain.py:17-19):  mean over rows of ||logits_r - logits_t||_2;
* LwF   (Lwftrain.py:12-27):  the temperature-power soft-target loss
  (losses/distillation.lwf_kd_loss); ``lwf_faithful_zero_kd`` gives the
  reference's own term, which is identically zero.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict, Optional

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
from gslora_tpu_torch.losses.classification import cross_entropy
from gslora_tpu_torch.losses.distillation import lwf_kd_loss
from gslora_tpu_torch.metrics.logging import MetricLogger
from gslora_tpu_torch.models.vit import ViT, vit_apply
from gslora_tpu_torch.parallel.mesh import (check_baseline_placement,
                                            set_active)


def der_loss(emb_s, emb_t, labels=None) -> torch.Tensor:
    """Squared Frobenius norm, summed (DERtrain.py:12-16), over valid rows
    (label -1, the pad sentinel, is left out)."""
    d = emb_s.float() - emb_t.float()
    per_row = torch.sum(d * d, dim=1)
    if labels is not None:
        per_row = per_row * (labels >= 0).float()
    return torch.sum(per_row)


def fdr_loss(logits_s, logits_t, labels=None) -> torch.Tensor:
    """Mean row-wise L2 (FDRtrain.py:17-19) over valid rows.

    The sqrt is clamped away from 0: the student starts as an exact copy
    of the teacher, so with dropout 0 the first step has rows with d == 0,
    where the plain norm's gradient is NaN (0/0); the clamp gives the zero
    subgradient instead."""
    d = logits_s.float() - logits_t.float()
    per_row = torch.sqrt(torch.clamp(torch.sum(d * d, dim=1), min=1e-24))
    if labels is None:
        return torch.mean(per_row)
    w = (labels >= 0).float()
    return torch.sum(per_row * w) / torch.clamp(torch.sum(w), min=1.0)


def make_distill_step(method: str, model: ViTConfig, lora: LoraConfig,
                      optimizer, hp: Dict[str, float],
                      compute_dtype=torch.bfloat16,
                      faithful_zero_kd: bool = False, grad_accum: int = 1,
                      mesh=None):
    """step(state, teacher, xf, yf, xr, yr, xr2, yr2, lr, generator=None)
    -> (state, metrics); ``teacher`` is a parameter tree.

    The loss mixes masked MEANS over two streams (three for DER++) with
    DER's raw SUM, so it is written as masked per-sample sums over each
    stream divided by the step's global valid count of that stream
    (baselines/common.stream_grads): one pass when ``grad_accum`` is 1,
    ``grad_accum`` micro-batches with fp32 gradient sums otherwise (the
    same gradient), one pass again when it does not divide a stream.
    Under ``mesh`` each rank passes its rows of every stream: the counts
    are the global batches', and DER's global SUM is the sum of the
    ranks' sums (the all_reduce of the gradients), with no count. Under
    a sharding mesh the student and the teacher hold this rank's shards:
    KD, FDR and DER read the class scores and embeddings, which the
    model gathers whole on every rank (models/heads._class_scores)."""
    method = method.lower()
    if method not in ("lwf", "der", "der_plus", "fdr"):
        raise ValueError(f"unknown distill method {method}")
    cdt = compute_dtype

    def step(state: PretrainState, teacher, xf, yf, xr, yr, xr2, yr2,
             lr: float, generator: Optional[torch.Generator] = None):
        leaves = state.trainable_params()
        params = state.params
        nf, nr, nr2 = global_counts(mesh, yf, yr, yr2)

        def sums_fn(xf, yf, xr, yr, xr2=None, yr2=None):
            vf, vr = valid_count(yf), valid_count(yr)
            logits_f, _ = vit_apply(params, xf, yf, model, lora, train=True,
                                    generator=generator, compute_dtype=cdt)
            logits_r, emb_r = vit_apply(params, xr, yr, model, lora,
                                        train=True, generator=generator,
                                        compute_dtype=cdt)
            with torch.no_grad():
                t_logits_r, t_emb_r = vit_apply(teacher, xr, yr, model, lora,
                                                train=False,
                                                compute_dtype=cdt)
            s = {"ce_f": cross_entropy(logits_f, yf) * vf}
            if method == "lwf":
                kd = torch.zeros((), device=vr.device) if faithful_zero_kd \
                    else lwf_kd_loss(logits_r, t_logits_r, hp["T"],
                                     labels=yr)
                s["kd"] = kd * vr
                s["ce_r"] = cross_entropy(logits_r, yr) * vr
            elif method == "fdr":
                s["fdr"] = fdr_loss(logits_r, t_logits_r, labels=yr) * vr
            else:
                s["der"] = der_loss(emb_r, t_emb_r, labels=yr)  # a SUM
                if method == "der_plus":
                    logits_r2, _ = vit_apply(params, xr2, yr2, model, lora,
                                             train=True, generator=generator,
                                             compute_dtype=cdt)
                    s["ce_r2"] = cross_entropy(logits_r2, yr2) * \
                        valid_count(yr2)
            return s

        def combine(s):
            m = {"loss_CE": s["ce_f"] / nf}
            total = m["loss_CE"]
            if method == "lwf":
                m["loss_KD"] = s["kd"] / nr
                m["loss_remain"] = s["ce_r"] / nr
                total = total + hp["lambda_kd"] * m["loss_KD"] + \
                    hp["lambda_remain"] * m["loss_remain"]
            elif method == "fdr":
                m["loss_FDR"] = s["fdr"] / nr
                total = total + hp["lambda_fdr"] * m["loss_FDR"]
            else:
                m["loss_DER"] = s["der"]
                total = total + hp["lambda_der"] * m["loss_DER"]
                if method == "der_plus":
                    m["loss_CE_next"] = s["ce_r2"] / nr2
                    total = total + hp["lambda_der_plus"] * \
                        m["loss_CE_next"]
            return total, m

        streams = (xf, yf, xr, yr, xr2, yr2) if method == "der_plus" \
            else (xf, yf, xr, yr)
        grads, metrics = stream_grads(sums_fn, combine, leaves,
                                      state.trainable_names(), streams,
                                      grad_accum, mesh)
        optimizer.update(leaves, grads, state.opt_state, lr)
        state.step += 1
        return state, metrics

    return step


def run_distill_task(cfg: RunConfig, params, teacher_params,
                     forget_loader_factory: Callable, remain_cycler,
                     test_batches_f: Callable, test_batches_r: Callable,
                     *, method: Optional[str] = None,
                     num_epoch: Optional[int] = None, logger=None,
                     test_batches_open: Optional[Callable] = None,
                     mesh=None) -> Dict[str, Any]:
    """One task of LwF / DER / DER++ / FDR on ``cfg.device``: iterate the
    relabeled forget loader, and take remain batches from
    ``remain_cycler.next()`` (two per step for DER++: DER++'s second remain
    batch is the cycler's next global batch).

    ``mesh``: as for baselines/regularization.run_regularization_task;
    the student and the teacher are broadcast from rank 0 and sharded
    alike; the returned ``params`` are whole."""
    method = (method or cfg.baseline.method).lower()
    b = cfg.baseline
    hp = {"T": b.lwf_T, "lambda_kd": b.lwf_lambda_kd,
          "lambda_remain": b.lwf_lambda_remain, "lambda_der": b.der_lambda,
          "lambda_der_plus": b.der_plus_lambda, "lambda_fdr": b.fdr_lambda}
    check_baseline_placement(cfg.mesh, mesh)
    set_active(mesh)
    device = resolve_device(cfg.device)
    cdt = _dtype(cfg)
    logger = logger or MetricLogger()
    opt = make_optimizer(cfg.optim)
    step = make_distill_step(method, cfg.model, cfg.lora, opt, hp,
                             compute_dtype=cdt,
                             faithful_zero_kd=b.lwf_faithful_zero_kd,
                             grad_accum=cfg.optim.grad_accum, mesh=mesh)
    params, teacher = put_trees(mesh, device, params, teacher_params)
    state = PretrainState.create(ViT(params, cfg.model, cfg.lora), opt,
                                 trains=partial(trains, **freeze_flags(cfg)))
    eval_step = make_eval_step(cfg.model, cfg.lora, compute_dtype=cdt)

    def accuracy(batches):
        return eval_accuracy(eval_step, state.params, batches, mesh=mesh)

    facc_before = accuracy(test_batches_f())
    best_h = float("-inf")
    generator = rank_generator(cfg, device, mesh)
    batch = 0
    for epoch in range(num_epoch if num_epoch is not None else cfg.num_epoch):
        lr = timm_cosine_lr(cfg.optim, epoch)
        for xf, yf in forget_loader_factory():
            xr, yr = remain_cycler.next()
            xr2, yr2 = remain_cycler.next() if method == "der_plus" \
                else (xr, yr)
            xf, yf, xr, yr, xr2, yr2 = to_device(device, xf, yf, xr, yr,
                                                 xr2, yr2)
            state, metrics = step(state, teacher, xf, yf, xr, yr, xr2, yr2,
                                  lr, generator)
            if (batch + 1) % cfg.disp_freq == 0:
                logger.log({k: float(v) for k, v in metrics.items()},
                           step=batch)
            if (batch + 1) % cfg.ver_freq == 0:
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
