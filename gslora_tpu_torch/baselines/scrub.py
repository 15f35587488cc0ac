"""SCRUB: teacher-student max/min distillation with SWA smoothing (port of
gslora_tpu/baselines/scrub.py; reference baselines/SCRUBtrain.py:11-291,
setup train_own_forget_cl.py:440-451, optimizer swap :860-879).

A superepoch is 10 inner epochs: the first 5 run a MAX pass over the
forget loader (loss = -KD(s, t) + smoothing * sum_p ||theta_p -
theta_swa_p||_F) followed by a MIN pass over remain (gamma * CE + alpha *
KD + the same distance); the last 5 run the MIN pass only. After each
superepoch the SWA model takes in the student: swa <- 0.9 swa + 0.1
student (the first update copies, torch AveragedModel). The sgda
optimizer (SGD by default) runs a step-decay LR (util/sgda_utils.py:7-19).
Teacher and SWA live across tasks (created once before the reference's
CL task loop): see run_scrub_task.
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
from gslora_tpu_torch.config import LoraConfig, OptimConfig, RunConfig, \
    ViTConfig
from gslora_tpu_torch.engine.evaluate import eval_accuracy, h_mean, \
    make_eval_step
from gslora_tpu_torch.engine.loop import _dtype, resolve_device
from gslora_tpu_torch.engine.pretrain import PretrainState
from gslora_tpu_torch.engine.schedule import step_decay_lr
from gslora_tpu_torch.engine.state import make_optimizer
from gslora_tpu_torch.losses.classification import cross_entropy
from gslora_tpu_torch.losses.distillation import kd_kl_loss
from gslora_tpu_torch.metrics.logging import MetricLogger
from gslora_tpu_torch.models.convert import flatten_tree
from gslora_tpu_torch.models.vit import ViT, vit_apply
from gslora_tpu_torch.parallel import sharding
from gslora_tpu_torch.parallel.mesh import (check_baseline_placement,
                                            set_active)
from gslora_tpu_torch.utils.trees import tree_map


def param_dist(params, swa_params, p: float, mesh=None) -> torch.Tensor:
    """p * the sum over tensors of the Frobenius norm of (theta -
    theta_swa) (util/sgda_utils.py:36-41). The sqrt is clamped: params ==
    swa at the start of a superepoch, where the plain norm's gradient is
    NaN (0/0); the clamp gives the zero subgradient. Under a sharding
    ``mesh`` the trees hold this rank's shards: each leaf's squares are
    summed over the axes it is sharded on BEFORE the square root
    (parallel/sharding.whole_sums), so the norm, and the gradient
    (theta - theta_swa) / norm of each shard, are the whole tensor's."""
    a, b = flatten_tree(params), flatten_tree(swa_params)
    if p == 0.0:
        return next(iter(a.values())).new_zeros((), dtype=torch.float32)
    names = list(a)
    sq = [torch.sum((a[k].float() - b[k].float()) ** 2) for k in names]
    sq = sharding.whole_sums(mesh, names, [a[k] for k in names], sq)
    norms = [torch.sqrt(torch.clamp(s, min=1e-24)) for s in sq]
    return p * torch.stack(norms).sum()


@torch.no_grad()
def swa_update(swa_params, student_params, n_averaged: int,
               beta: float = 0.1):
    """torch AveragedModel with avg_fn = (1 - beta) * avg + beta * new; the
    first update copies (train_own_forget_cl.py:446-450). Returns a new
    tree of detached tensors."""
    if n_averaged == 0:
        return tree_map(lambda s: s.detach().clone(), student_params)
    return tree_map(lambda a, s: ((1 - beta) * a.float() +
                                  beta * s.detach().float()).to(a.dtype),
                    swa_params, student_params)


def make_scrub_steps(model: ViTConfig, lora: LoraConfig, optimizer,
                     kd_T: float, smoothing: float, gamma: float,
                     alpha: float, compute_dtype=torch.bfloat16,
                     grad_accum: int = 1, mesh=None):
    """(max_step, min_step), each step(state, teacher, swa, x, y, lr,
    generator=None) -> (state, metrics).

    KD and CE are masked sums over this rank's rows (micro-batches under
    ``grad_accum``) divided by the global batch's valid count
    (baselines/common.stream_grads), exact over micro-batches and the
    ranks of ``mesh``. The SWA distance does not depend on the data: its
    gradient is added once, after the all_reduce, on every rank alike
    (``stream_grads(fixed=...)``). Every rank runs every step, a rank
    whose rows are all padding too: its collectives are the others'."""
    cdt = compute_dtype

    def make(maximize: bool):
        def step(state: PretrainState, teacher, swa, x, y, lr: float,
                 generator: Optional[torch.Generator] = None):
            leaves = state.trainable_params()
            params = state.params
            (n,) = global_counts(mesh, y)

            def sums_fn(xm, ym):
                v = valid_count(ym)
                logits, _ = vit_apply(params, xm, ym, model, lora,
                                      train=True, generator=generator,
                                      compute_dtype=cdt)
                with torch.no_grad():
                    t_logits, _ = vit_apply(teacher, xm, ym, model, lora,
                                            train=False, compute_dtype=cdt)
                s = {"kd": kd_kl_loss(logits, t_logits, kd_T, labels=ym) * v}
                if not maximize:
                    s["ce"] = cross_entropy(logits, ym) * v
                return s

            def combine(s):
                kd = s["kd"] / n
                if maximize:
                    return -kd, {"loss_kd_forget": kd}
                ce = s["ce"] / n
                return gamma * ce + alpha * kd, {"loss_kd_remain": kd,
                                                 "loss_CE": ce}

            grads, metrics = stream_grads(
                sums_fn, combine, leaves, state.trainable_names(), (x, y),
                grad_accum, mesh, fixed=param_dist(params, swa, smoothing,
                                                   mesh))
            metrics["loss_total_forget" if maximize else
                    "loss_total_remain"] = metrics.pop("loss_total")
            optimizer.update(leaves, grads, state.opt_state, lr)
            state.step += 1
            return state, metrics
        return step

    return make(True), make(False)


def run_scrub_task(cfg: RunConfig, params, forget_loader_factory: Callable,
                   remain_loader_factory: Callable,
                   test_batches_f: Callable, test_batches_r: Callable,
                   logger=None, test_batches_open: Optional[Callable] = None,
                   teacher=None, swa=None, n_averaged: int = 0,
                   mesh=None) -> Dict[str, Any]:
    """A SCRUB task of cfg.baseline.scrub_superepoch superepochs on
    ``cfg.device``.

    ``teacher`` / ``swa`` / ``n_averaged``: state across tasks. The
    reference creates the teacher and the SWA AveragedModel once before
    the CL task loop (train_own_forget_cl.py:441-451, loop at :515), so a
    multi-task caller threads the returned ``teacher`` / ``swa`` /
    ``n_averaged`` into the next task (cli/train_forget_cl does). The defaults
    give the single-task set-up: teacher = the entry params, the first
    SWA update copies.

    ``mesh``: as for baselines/regularization.run_regularization_task;
    the student, the teacher and the SWA model are broadcast from rank 0
    and sharded alike, every rank runs the same number of max and min
    steps (its loaders give the same number of global batches) and the
    same SWA updates (on its shards); the returned trees are whole."""
    b = cfg.baseline
    check_baseline_placement(cfg.mesh, mesh)
    set_active(mesh)
    device = resolve_device(cfg.device)
    cdt = _dtype(cfg)
    logger = logger or MetricLogger()
    # the sgda optimizer takes the main one's place (cl.py:860-879); its
    # state starts anew each task, as the reference re-creates it (:811)
    opt = make_optimizer(OptimConfig(opt=b.sgda_optim,
                                     lr=b.sgda_learning_rate,
                                     momentum=b.sgda_momentum,
                                     weight_decay=b.sgda_weight_decay))
    max_step, min_step = make_scrub_steps(
        cfg.model, cfg.lora, opt, b.kd_T, b.sgda_smoothing, b.sgda_gamma,
        b.sgda_alpha, compute_dtype=cdt, grad_accum=cfg.optim.grad_accum,
        mesh=mesh)
    params, teacher, swa = put_trees(
        mesh, device, params, teacher if teacher is not None else params,
        swa if swa is not None else params)
    state = PretrainState.create(ViT(params, cfg.model, cfg.lora), opt,
                                 trains=partial(trains, **freeze_flags(cfg)))
    eval_step = make_eval_step(cfg.model, cfg.lora, compute_dtype=cdt)

    def accuracy(batches):
        return eval_accuracy(eval_step, state.params, batches, mesh=mesh)

    facc_before = accuracy(test_batches_f())
    best_h = float("-inf")
    generator = rank_generator(cfg, device, mesh)
    decay_epochs = [b.scrub_decay_epoch]
    for superepoch in range(b.scrub_superepoch):
        for i in range(10):
            epoch = superepoch * 15 + i  # the reference's numbering
            lr = step_decay_lr(b.sgda_learning_rate, epoch, decay_epochs)
            if i < 5:  # max pass over forget
                for x, y in forget_loader_factory():
                    x, y = to_device(device, x, y)
                    state, _ = max_step(state, teacher, swa, x, y, lr,
                                        generator)
            for x, y in remain_loader_factory():  # min pass, always
                x, y = to_device(device, x, y)
                state, _ = min_step(state, teacher, swa, x, y, lr,
                                    generator)
        swa = swa_update(swa, state.params, n_averaged)
        n_averaged += 1
        facc = accuracy(test_batches_f())
        racc = accuracy(test_batches_r())
        best_h = max(best_h, h_mean(facc_before, facc, racc, eps=1e-8))
        logger.log({"Test forget Accuracy": facc,
                    "Test remain Accuracy": racc}, step=superepoch)

    facc, racc, oacc = final_accuracies(eval_step, state.params,
                                        test_batches_f, test_batches_r,
                                        test_batches_open, mesh=mesh)
    return {"params": whole_tree(mesh, state.params),
            "swa": whole_tree(mesh, swa), "teacher": whole_tree(mesh, teacher),
            "n_averaged": n_averaged,
            "forget_acc_before": facc_before, "forget_acc": facc,
            "remain_acc": racc, "open_acc": oacc, "best_h": best_h}
