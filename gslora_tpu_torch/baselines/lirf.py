"""LIRF: Learning-to-Impersonate-and-Recover baseline (port of
gslora_tpu/baselines/lirf.py; reference baselines/LIRFtrain.py:58-341,
4-model set-up train_own_forget_cl.py:330-422).

The reference splits ViT_face into a low half (the first depth // 2
blocks, returning the token sequence, vit_face.py:638-665) and an up half
(the other blocks and the head, vit_face.py:755-781); here the split is a
``layer_range`` over the stacked block parameters:

  student_low : the trainable low-half subtree (patch, cls, pos and the
                low blocks); the reference's optimizer holds ONLY
                student_model_low (train_own_forget_cl.py:811, :418)
  deposit_low : a FROZEN low-half subtree, never in any optimizer: its
                KD/CE term (loss_pt_re) is logged and has no gradient, so
                it runs without a graph
  teacher     : the frozen full tree; its upper half and head score
                everything, and the student's gradient flows back
                through that upper half

All three live across CL tasks (built once from the pretrained model
before the reference's task loop, cl.py:330-422, loop at :515):
cli/train_forget_cl threads the returned carry into the next task.

Per step over the relabeled forget loader (remain cycling):
  L = CE(student) (1 - alpha) - 300 AT(student_mid, teacher_mid)
      + 10 KD_T(student[:, split:] vs teacher) alpha T^2
      + 0.05 (KD_T(deposit[:, :split] vs teacher) alpha T^2
              + CE(deposit) (1 - alpha))
      + 5 CE(student on remain)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from gslora_tpu_torch.baselines.common import (global_counts, put_trees,
                                               rank_generator, stream_grads,
                                               to_device, valid_count,
                                               whole_tree)
from gslora_tpu_torch.config import LoraConfig, RunConfig, ViTConfig
from gslora_tpu_torch.engine.continual import detached
from gslora_tpu_torch.engine.ema import merged_params
from gslora_tpu_torch.engine.evaluate import h_mean
from gslora_tpu_torch.engine.loop import _dtype, resolve_device
from gslora_tpu_torch.engine.schedule import timm_cosine_lr
from gslora_tpu_torch.engine.state import make_optimizer
from gslora_tpu_torch.losses.classification import cross_entropy
from gslora_tpu_torch.losses.distillation import attention_transfer_loss, \
    kd_kl_loss
from gslora_tpu_torch.metrics.logging import MetricLogger
from gslora_tpu_torch.models.heads import apply_head
from gslora_tpu_torch.models.vit import _Node, vit_embed
from gslora_tpu_torch.parallel.mesh import (check_baseline_placement,
                                            set_active)


@dataclass
class LIRFState:
    """The student's low half (a module holding the trainable subtree),
    the frozen deposit subtree, the optimizer state of the student only
    and the step count."""

    student: _Node
    deposit_low: Dict
    opt_state: Dict
    step: int = 0

    @property
    def student_low(self) -> Dict:
        return self.student.tree()


def low_slice(tree: Dict, half: int) -> Dict:
    """The ViT_face_low parameters (vit_face.py:638-665): patch embedding,
    CLS, pos-embed and the first ``half`` blocks of a base tree, so the
    optimizer's state (and weight decay) covers exactly what the reference
    trains. The layer dim is never sharded (the baselines refuse pp), so
    the low half of a rank's shards is its shards of the low half."""
    return {"patch": tree["patch"], "cls_token": tree["cls_token"],
            "pos_embed": tree["pos_embed"],
            "blocks": _slice_blocks(tree["blocks"], half)}


def _slice_blocks(blocks: Dict, half: int) -> Dict:
    return {k: _slice_blocks(v, half) if isinstance(v, dict) else v[:half]
            for k, v in blocks.items()}


def _low_tokens(tree, x, model, lora, *, train, generator, cdt):
    """Patchify and the first depth // 2 blocks -> tokens (ViT_face_low)."""
    return vit_embed({"base": tree, "lora": {}}, x, model, lora, train=train,
                     generator=generator, compute_dtype=cdt,
                     layer_range=(0, model.depth // 2), return_tokens=True)


def _up_logits(teacher, tokens, labels, model, lora, cdt):
    """The frozen teacher's upper half and head (ViT_face_up)."""
    emb = vit_embed({"base": teacher, "lora": {}}, None, model, lora,
                    train=False, compute_dtype=cdt, tokens_in=tokens,
                    layer_range=(model.depth // 2, model.depth))
    return apply_head(model.head_type, teacher["head"], emb, labels)


def make_lirf_step(model: ViTConfig, lora: LoraConfig, optimizer,
                   split: int, T: float, alpha: float,
                   compute_dtype=torch.bfloat16, grad_accum: int = 1,
                   mesh=None):
    """step(state, teacher, xf, yf, xr, yr, lr, generator=None)
    -> (state, metrics); the gradient is taken w.r.t. the student's low
    half only.

    Every term is a masked row mean over the forget stream (CE, AT, kdKP,
    pt_re) or the remain stream (replay CE), so the step differentiates
    masked sums over the two streams divided by their global valid
    counts (baselines/common.stream_grads): ``grad_accum`` micro-batches
    and the ranks of ``mesh`` give the global batch's gradient; one pass
    when it does not divide a stream. Under a sharding mesh the gradients
    are summed as each leaf's layout asks (parallel/sharding.sync_grads,
    by the student's leaf names)."""
    cdt = compute_dtype

    def step(state: LIRFState, teacher, xf, yf, xr, yr, lr: float,
             generator: Optional[torch.Generator] = None):
        names, leaves = zip(*state.student.named_parameters())
        student = state.student_low
        nf, nr = global_counts(mesh, yf, yr)

        def sums_fn(xf, yf, xr, yr):
            vf, vr = valid_count(yf), valid_count(yr)
            s_mid = _low_tokens(student, xf, model, lora, train=True,
                                generator=generator, cdt=cdt)
            s_final = _up_logits(teacher, s_mid, yf, model, lora, cdt)
            with torch.no_grad():
                d_mid = _low_tokens(state.deposit_low, xf, model, lora,
                                    train=True, generator=generator, cdt=cdt)
                d_final = _up_logits(teacher, d_mid, yf, model, lora, cdt)
                t_mid = _low_tokens(teacher, xf, model, lora, train=False,
                                    generator=None, cdt=cdt)
                t_final = _up_logits(teacher, t_mid, yf, model, lora, cdt)
            sr_mid = _low_tokens(student, xr, model, lora, train=True,
                                 generator=generator, cdt=cdt)
            sr_final = _up_logits(teacher, sr_mid, yr, model, lora, cdt)
            return {
                "ce": cross_entropy(s_final, yf) * (1 - alpha) * vf,
                "at": attention_transfer_loss(s_mid, t_mid, labels=yf) * vf,
                "kd_kp": kd_kl_loss(s_final[:, split:], t_final[:, split:],
                                    T, labels=yf) * alpha * vf,
                "pt_re": (kd_kl_loss(d_final[:, :split], t_final[:, :split],
                                     T, labels=yf) * alpha +
                          cross_entropy(d_final, yf) * (1 - alpha)) * vf,
                "replay": cross_entropy(sr_final, yr) * vr,
            }

        def combine(s):
            m = {"loss_CE": s["ce"] / nf, "loss_AT": s["at"] / nf,
                 "loss_kdKP": s["kd_kp"] / nf, "loss_pt_re": s["pt_re"] / nf,
                 "loss_remain": s["replay"] / nr}
            total = m["loss_CE"] - 300.0 * m["loss_AT"] + \
                10.0 * m["loss_kdKP"] + 0.05 * m["loss_pt_re"] + \
                5.0 * m["loss_remain"]
            return total, m

        grads, metrics = stream_grads(sums_fn, combine, list(leaves), names,
                                      (xf, yf, xr, yr), grad_accum, mesh)
        optimizer.update(list(leaves), grads, state.opt_state, lr)
        state.step += 1
        return state, metrics

    return step


@torch.no_grad()
def lirf_eval_accuracy(teacher, student_low, batches, model: ViTConfig,
                       lora: LoraConfig, compute_dtype=torch.bfloat16,
                       mesh=None) -> float:
    """eval_data_LIRF: accuracy of teacher_up(student_low(x)) in percent
    over valid rows (label -1, the pad sentinel, never equals an argmax);
    counts stay on the device until the end. Under ``mesh`` each rank
    passes its rows and the correct and total counts are summed over the
    ranks, as in engine/evaluate.eval_accuracy."""
    device = student_low["patch"]["kernel"].device
    correct, total = None, 0
    for x, y in batches:
        total += int((np.asarray(y) >= 0).sum())
        x, y = to_device(device, x, y)
        mid = _low_tokens(student_low, x, model, lora, train=False,
                          generator=None, cdt=compute_dtype)
        logits = _up_logits(teacher, mid, y, model, lora, compute_dtype)
        c = torch.sum(torch.argmax(logits, dim=-1) == y)
        correct = c if correct is None else correct + c
    correct = 0 if correct is None else int(correct)
    if mesh is not None:
        correct, total = (int(v) for v in mesh.sum([correct, total]))
    return 100.0 * correct / max(total, 1)


def run_lirf_task(cfg: RunConfig, params, forget_loader_factory: Callable,
                  remain_cycler, test_batches_f: Callable,
                  test_batches_r: Callable, logger=None,
                  num_epoch: Optional[int] = None,
                  test_batches_open: Optional[Callable] = None,
                  carry: Optional[Dict[str, Any]] = None,
                  mesh=None) -> Dict[str, Any]:
    """One LIRF task on ``cfg.device``. ``carry``: the state across tasks,
    a dict of ``teacher`` / ``student_low`` / ``deposit_low``; the
    reference builds the four models once from the pretrained checkpoint
    before the CL task loop (cl.py:330-422) and the student keeps training
    across tasks, so a multi-task caller threads the returned values back
    in (cli/train_forget_cl does). ``carry=None`` builds them from ``params``.
    The optimizer state starts anew each task either way ("create again to
    reinitialize optimizer", cl.py:811-815).

    ``mesh``: as for baselines/regularization.run_regularization_task;
    the carry (whole trees) is broadcast from rank 0 and each rank keeps
    its shards of it, one set on every rank of a model group (the
    student's updates are the global batch's); the returned carry is
    whole. The split (``layer_range``) runs under tp, fsdp and sp
    (models/vit.transformer_stack)."""
    check_baseline_placement(cfg.mesh, mesh)
    set_active(mesh)
    device = resolve_device(cfg.device)
    cdt = _dtype(cfg)
    logger = logger or MetricLogger()
    b = cfg.baseline
    half = cfg.model.depth // 2
    if carry is not None:
        teacher, student_low, deposit_low = (
            carry[k] for k in ("teacher", "student_low", "deposit_low"))
    else:
        params = detached(params, device)
        teacher = params["base"]
        if params.get("lora"):
            # LIRF runs on a plain backbone (the reference's baselines run
            # lora_rank 0); a LoRA-carrying model's deployable teacher is
            # the merged one
            with torch.no_grad():
                teacher = merged_params(teacher, params["lora"],
                                        cfg.lora.scaling)
        student_low = low_slice(teacher, half)
        deposit_low = low_slice(teacher, half)
    opt = make_optimizer(cfg.optim)
    step = make_lirf_step(cfg.model, cfg.lora, opt,
                          split=cfg.forget.per_forget_cls, T=b.lirf_T,
                          alpha=b.lirf_alpha, compute_dtype=cdt,
                          grad_accum=cfg.optim.grad_accum, mesh=mesh)
    teacher, student_low, deposit_low = put_trees(
        mesh, device, teacher, student_low, deposit_low)
    student = _Node(student_low)  # a trainable copy
    state = LIRFState(student=student, deposit_low=deposit_low,
                      opt_state=opt.init(list(student.parameters())))

    def accuracy(batches):
        return lirf_eval_accuracy(teacher, state.student_low, batches,
                                  cfg.model, cfg.lora, cdt, mesh=mesh)

    facc_before = accuracy(test_batches_f())
    generator = rank_generator(cfg, device, mesh)
    batch = 0
    best_h = float("-inf")
    n_ep = num_epoch if num_epoch is not None else cfg.num_epoch
    for epoch in range(n_ep):
        lr = timm_cosine_lr(cfg.optim, epoch)
        for xf, yf in forget_loader_factory():
            xr, yr = remain_cycler.next()
            xf, yf, xr, yr = to_device(device, xf, yf, xr, yr)
            state, metrics = step(state, teacher, xf, yf, xr, yr, lr,
                                  generator)
            if (batch + 1) % cfg.disp_freq == 0:
                logger.log({k: float(v) for k, v in metrics.items()},
                           step=batch)
            batch += 1
        facc = accuracy(test_batches_f())
        racc = accuracy(test_batches_r())
        best_h = max(best_h, h_mean(facc_before, facc, racc, eps=1e-8))

    if n_ep == 0:
        # a zero-epoch call still defines the accuracies, as the other
        # runners' evals after the loop do
        facc = accuracy(test_batches_f())
        racc = accuracy(test_batches_r())
        best_h = max(best_h, h_mean(facc_before, facc, racc, eps=1e-8))
    oacc = accuracy(test_batches_open()) if test_batches_open else None
    return {"student_low": whole_tree(mesh, state.student_low),
            "deposit_low": whole_tree(mesh, deposit_low),
            "teacher": whole_tree(mesh, teacher),
            "forget_acc_before": facc_before, "forget_acc": facc,
            "remain_acc": racc, "open_acc": oacc, "best_h": best_h}
