"""Epoch-level LR schedule (timm create_scheduler semantics, stepped per
epoch like the reference's ``lr_scheduler.step(epoch)``)."""
from __future__ import annotations

import math

from gslora_tpu_torch.config import OptimConfig


def timm_cosine_lr(cfg: OptimConfig, epoch: int) -> float:
    """timm CosineLRScheduler with .step(epoch): linear warmup from
    warmup_lr over warmup_epochs, then cosine from base lr to min_lr over
    t_initial (= epochs)."""
    if cfg.sched == "constant":
        return cfg.lr
    if epoch < cfg.warmup_epochs:
        frac = epoch / max(cfg.warmup_epochs, 1)
        return cfg.warmup_lr + frac * (cfg.lr - cfg.warmup_lr)
    if cfg.sched == "step":
        n = (epoch // max(cfg.decay_epochs, 1))
        return max(cfg.lr * (cfg.decay_rate ** n), cfg.min_lr)
    # cosine (timm default warmup_prefix=False: raw t over t_initial)
    t = min(epoch, cfg.epochs)
    cos = 0.5 * (1.0 + math.cos(math.pi * t / max(cfg.epochs, 1)))
    return cfg.min_lr + (cfg.lr - cfg.min_lr) * cos


def step_decay_lr(base_lr: float, epoch: int, decay_epochs: list[int],
                  decay_rate: float = 0.1) -> float:
    """SCRUB's sgda step decay (util/sgda_utils.py:7-19): multiply by
    decay_rate after each listed epoch, strictly after: the reference
    counts ``np.sum(epoch > decay_epochs)`` (sgda_utils.py:13), so the
    decay epoch itself still runs at the undecayed rate."""
    steps = sum(1 for e in decay_epochs if epoch > e)
    return base_lr * (decay_rate ** steps)
