"""Distillation losses of the teacher-student baselines (port of
gslora_tpu/losses/distillation.py).

* kd_kl_loss    — temperature KD: KL(softmax(t/T) || softmax(s/T)) * T^2,
                  the DistillKL of SCRUB (baselines/SCRUBtrain.py) and the
                  class-slice KD of LIRF (baselines/LIRFtrain.py).
* lwf_kd_loss   — LwF's soft-target loss with temperature *power*
                  (baselines/Lwftrain.py:12-27 L_old_kd_loss).
* attention_transfer_loss — LIRF's AT loss over token maps
                  (baselines/LIRFtrain.py:17-40).

Every loss takes an optional ``labels`` tensor: rows labelled -1 (the pad
sentinel of BatchLoader(mask_padding=True), which every loader on the
card uses) are left out of the reduction, so a padded tail batch gives
the loss of the unpadded one.
"""
from __future__ import annotations

from typing import Optional

import torch


def _row_mask(labels: Optional[torch.Tensor], like: torch.Tensor):
    if labels is None:
        return torch.ones_like(like)
    return (labels >= 0).float()


def _masked_row_mean(per_row: torch.Tensor,
                     labels: Optional[torch.Tensor]) -> torch.Tensor:
    w = _row_mask(labels, per_row)
    return torch.sum(per_row * w) / torch.clamp(torch.sum(w), min=1.0)


def kd_kl_loss(student_logits, teacher_logits, T: float,
               labels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KL(teacher || student) with temperature, scaled by T^2, mean over
    valid rows."""
    s = torch.log_softmax(student_logits.float() / T, dim=1)
    t = torch.softmax(teacher_logits.float() / T, dim=1)
    kl = torch.sum(t * (torch.log(torch.clamp(t, min=1e-12)) - s), dim=1)
    return _masked_row_mean(kl, labels) * (T ** 2)


def lwf_kd_loss(student_logits, teacher_logits, T: float,
                labels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The intended LwF soft-target loss (Lwftrain.py:12-27): softmaxes
    raised to 1/T and renormalized, then -mean(sum(t' * log s')) over
    valid rows. The reference's own code takes the log of a log_softmax
    and scrubs the NaNs, so its term is identically zero; that lives
    behind ``lwf_faithful_zero_kd`` in baselines/distill.py."""
    s = torch.softmax(student_logits.float(), dim=1) ** (1.0 / T)
    t = torch.softmax(teacher_logits.float(), dim=1) ** (1.0 / T)
    s = s / torch.sum(s, dim=1, keepdim=True)
    t = t / torch.sum(t, dim=1, keepdim=True)
    per_row = -torch.sum(t * torch.log(torch.clamp(s, min=1e-12)), dim=1)
    return _masked_row_mean(per_row, labels)


def attention_transfer_loss(student_tokens, teacher_tokens,
                            labels: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """LIRF attention transfer (LIRFtrain.py:42-55 ``at`` / ``at_loss``):
    per-token energy x.pow(2).mean(dim=1) -> L2-normalized per sample ->
    entries below 0.005 zeroed -> MSE between the student's and the
    teacher's maps, mean over valid samples."""
    def at_map(x):
        x = x.float()
        a = torch.mean(x ** 2, dim=1).reshape(x.shape[0], -1)
        a = a / torch.clamp(torch.linalg.vector_norm(a, dim=-1, keepdim=True),
                            min=1e-12)
        return torch.where(a < 0.005, torch.zeros_like(a), a)

    per_row = torch.mean((at_map(student_tokens) -
                          at_map(teacher_tokens)) ** 2, dim=1)
    return _masked_row_mean(per_row, labels)
