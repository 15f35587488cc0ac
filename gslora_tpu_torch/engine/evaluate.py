"""Evaluation: batch accuracy + H-mean selection metric (port of
gslora_tpu/engine/evaluate.py).

The reference deep-copies the model and flips to eval mode, which merges
LoRA statefully (engine.py:436-529). Here eval is the forward with dropout
off and no graph; the LoRA contribution is the same merged or factored.
"""
from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import torch

from gslora_tpu_torch.config import LoraConfig, ViTConfig
from gslora_tpu_torch.models.vit import params_device, vit_apply


def make_eval_step(model: ViTConfig, lora: LoraConfig,
                   compute_dtype=torch.bfloat16):
    """eval_step(params, x, y) -> (n_correct, n_total) for one batch;
    n_correct stays a device tensor."""
    if model.head_type == "None":
        raise ValueError(
            "make_eval_step needs a classification head; head_type='None' "
            "has no logits to score (use vit_apply(labels=None) for "
            "embedding evals)")

    @torch.no_grad()
    def eval_step(params, x, y):
        logits, _ = vit_apply(params, x, y, model, lora, train=False,
                              compute_dtype=compute_dtype)
        pred = torch.argmax(logits, dim=-1)
        return torch.sum(pred == y), y.shape[0]

    return eval_step


def eval_accuracy(eval_step, params, batches: Iterable[Tuple],
                  mesh=None) -> float:
    """Top-1 accuracy in percent over an iterable of (x, y) numpy batches
    (reference engine.eval_data semantics), run on the parameters' device.
    Counts stay on the device until the end; label -1 (pad sentinel) never
    equals an argmax, so the correct count needs no mask and the total
    counts valid labels only.

    Under a data mesh each rank passes its rows of every batch
    (parallel/multihost.process_sharded_loader) and the integer counts are
    summed over the ranks, so the accuracy is the one-device one exactly.
    Under pp every model rank passes the same rows and runs the
    pipeline's schedule with the others, in lockstep."""
    device = params_device(params)
    correct = None
    total = 0
    for x, y in batches:
        c, _ = eval_step(params, torch.from_numpy(np.asarray(x)).to(device),
                         torch.from_numpy(np.asarray(y)).to(device))
        correct = c if correct is None else correct + c
        total += int((np.asarray(y) >= 0).sum())
    correct = 0 if correct is None else int(correct)
    if mesh is not None:
        correct, total = (int(v) for v in mesh.sum([correct, total]))
    if total == 0:
        return 0.0
    return 100.0 * correct / total


def h_mean(forget_acc_before: float, forget_acc: float,
           remain_acc: float, eps: float = 0.0) -> float:
    """Checkpoint-selection metric (engine.py:461-462):
    H = 2 * forget_drop * remain_acc / (forget_drop + remain_acc).
    engine_cl.py:279 adds a +1e-8 guard — pass eps for that variant."""
    drop = forget_acc_before - forget_acc
    denom = drop + remain_acc + eps
    if denom == 0:
        return 0.0
    return 2.0 * drop * remain_acc / denom
