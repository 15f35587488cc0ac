"""Margin-based classification heads as plain tensor functions, all in fp32
(port of gslora_tpu/models/heads.py; reference vit_face.py:14-304).

The margin branches (ArcFace th/mm fallback) and the one-hot are
numerically sensitive in bf16, so every head casts its inputs to fp32.
Label -1 (the pad sentinel) one-hots to an all-zero row.

On a mesh with a model axis (parallel/sharding) the weight holds this
rank's rows of the classes: the scores against them are gathered over
``model`` before any margin, so every head sees the whole (B, C); the
embedding enters through f, so its gradient sums every rank's classes.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from gslora_tpu_torch.parallel import sharding
from gslora_tpu_torch.parallel.mesh import active_mesh


def _l2norm(x, dim=-1, eps=1e-12):
    # torch F.normalize: x / max(||x||, eps)
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(n, min=eps)


def _one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """fp32 one-hot; out-of-range labels (the -1 sentinel) give zeros, as
    jax.nn.one_hot does."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[:, None] == classes).float()


def _class_scores(emb: torch.Tensor, weight: torch.Tensor,
                  fn) -> torch.Tensor:
    """``fn(emb, weight)`` (B, C) in fp32; under a class-sharded head, the
    rank's columns gathered over ``model``."""
    mesh = active_mesh()
    if not sharding.head_split(mesh):
        return fn(emb.float(), weight.float())
    emb = sharding.copy_to_model(emb.float(), mesh)
    return sharding.gather_from_model(fn(emb, weight.float()), mesh)


def _cosine(emb: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """cos(theta) between embeddings (B, d) and class weights (C, d)."""
    return _class_scores(emb, weight,
                         lambda e, w: _l2norm(e) @ _l2norm(w).t())


def softmax_head(params: Dict, emb, labels):
    """Plain FC head (vit_face.py:14-69; F.linear(x, W, b))."""
    del labels
    return _class_scores(emb, params["weight"], lambda e, w: e @ w.t()) + \
        params["bias"].float()


def cosface_head(params: Dict, emb, labels, s: float = 64.0,
                 m: float = 0.35):
    """CosFace additive-cosine margin s*(cos(theta) - m on target)
    (vit_face.py:146-208) — the head of all GS-LoRA experiments."""
    cos = _cosine(emb, params["weight"])
    return s * (cos - _one_hot(labels, cos.shape[-1]) * m)


def arcface_head(params: Dict, emb, labels, s: float = 64.0,
                 m: float = 0.50, easy_margin: bool = False):
    """ArcFace additive-angular margin s*cos(theta+m) (vit_face.py:72-143)."""
    cos = _cosine(emb, params["weight"])
    sin = torch.sqrt(torch.clamp(1.0 - cos ** 2, min=0.0))
    phi = cos * math.cos(m) - sin * math.sin(m)
    if easy_margin:
        phi = torch.where(cos > 0, phi, cos)
    else:
        th = math.cos(math.pi - m)
        mm = math.sin(math.pi - m) * m
        phi = torch.where(cos > th, phi, cos - mm)
    one_hot = _one_hot(labels, cos.shape[-1])
    return s * (one_hot * phi + (1.0 - one_hot) * cos)


def sface_head(params: Dict, emb, labels, s: float = 64.0, k: float = 80.0,
               a: float = 0.80, b: float = 1.22) -> Tuple[torch.Tensor, ...]:
    """SFace sigmoid-weighted intra/inter loss (vit_face.py:226-304).
    Returns (output, loss, intra_mean, inter_mean, Wyi_s_mean, Wj_s_mean)."""
    cos = _cosine(emb, params["weight"])
    output = cos * s
    one_hot = _one_hot(labels, cos.shape[-1])
    zero_hot = 1.0 - one_hot

    WyiX = torch.sum(one_hot * output, dim=1)
    theta_yi = torch.arccos(torch.clamp(WyiX.detach() / s, -1, 1))
    weight_yi = 1.0 / (1.0 + torch.exp(-k * (theta_yi - a)))
    intra = -weight_yi * WyiX

    Wj = zero_hot * output
    theta_j = torch.arccos(torch.clamp(Wj.detach() / s, -1, 1))
    weight_j = 1.0 / (1.0 + torch.exp(k * (theta_j - b)))
    inter = torch.sum(weight_j * Wj, dim=1)

    # mask pad-sentinel rows: their zero_hot row is all-ones
    w = (labels >= 0).float()
    denom = torch.clamp(torch.sum(w), min=1.0)

    def _mean(v):
        return torch.sum(v * w) / denom

    loss = _mean(intra) + _mean(inter)
    return output, loss, _mean(intra), _mean(inter), _mean(WyiX / s), \
        torch.sum((Wj / s) * w[:, None]) / (denom * Wj.shape[-1])


HEAD_FNS = {
    "Softmax": softmax_head,
    "CosFace": cosface_head,
    "ArcFace": arcface_head,
}


def apply_head(head_type: str, params: Dict, emb, labels):
    """Dispatch to a head; for SFace returns only the logits."""
    if head_type == "SFace":
        return sface_head(params, emb, labels)[0]
    return HEAD_FNS[head_type](params, emb, labels)
