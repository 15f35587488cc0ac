"""Data losses: remain CE + bounded forget CE (engine.py:248,261)
(port of gslora_tpu/losses/classification.py).

All reductions mask label -1, the pad sentinel BatchLoader(mask_padding=
True) emits for static batch shapes. Unpadded batches (all labels >= 0)
reduce to the exact torch-default batch mean.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _masked_mean(per_sample: torch.Tensor, labels: torch.Tensor):
    w = (labels >= 0).float()
    return torch.sum(per_sample * w) / torch.clamp(torch.sum(w), min=1.0)


def cross_entropy(logits, labels):
    """Mean CE over valid samples (torch nn.CrossEntropyLoss default on
    unpadded batches)."""
    ce = F.cross_entropy(logits.float(), labels.clamp(min=0).long(),
                         reduction="none")
    return _masked_mean(ce, labels)


def bounded_forget_loss(logits, labels, bnd):
    """Bounded gradient-ascent loss ``relu(BND - CE)`` (engine.py:77,261):
    pushes forget-class CE up until it clears BND, then yields zero grad."""
    return torch.relu(bnd - cross_entropy(logits, labels))


def top1_accuracy(logits, labels):
    """Top-1 accuracy in percent (util/utils.py train_accuracy topk=(1,));
    the k=1 case of :func:`topk_accuracy`."""
    return topk_accuracy(logits, labels, (1,))[0]


def topk_accuracy(logits, labels, topk=(1,)) -> tuple:
    """Precision@k for each k (util/utils.py:354-368 train_accuracy): a
    tuple of 0-dim percentages, pad sentinel (-1) masked. Ties go to the
    lower class index, as ``jax.lax.top_k`` breaks them (``torch.topk``
    promises no order): argmax for k = 1, else a stable descending
    sort."""
    maxk = max(topk)
    if maxk == 1:
        pred = torch.argmax(logits, dim=-1, keepdim=True)
    else:
        pred = torch.sort(logits, dim=-1, descending=True,
                          stable=True).indices[..., :maxk]
    hit = (pred == labels[..., None]).float()  # (..., maxk)
    return tuple(100.0 * _masked_mean(hit[..., :k].sum(dim=-1), labels)
                 for k in topk)
