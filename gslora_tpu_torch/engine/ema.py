"""EMA of the *merged* model (port of gslora_tpu/engine/ema.py; reference
train_own_forget.py:783-826).

The reference deep-copies the net and calls .eval() so loralib folds B@A
into the frozen weights, then EMAs the folded copy:
  epoch == ema_epoch:  ema <- merged(model)
  epoch  > ema_epoch:  ema <- ema * decay + merged(model) * (1 - decay)
Here ``merged_params`` is the fold (lora.core.merge_lora) as a new tree,
and the EMA a lerp over its tensors, in fp32.
"""
from __future__ import annotations

from typing import Dict

import torch

from gslora_tpu_torch.lora.core import merge_lora
from gslora_tpu_torch.utils.trees import tree_map


def merged_params(base: Dict, lora_tree: Dict, scaling: float) -> Dict:
    """Base params with the LoRA folded into the qkv/fc kernels, as a new
    tree (no tensor of ``base`` is changed); usable as
    ``{"base": merged, "lora": {}}``."""
    merged = dict(base)
    merged["blocks"] = merge_lora(base["blocks"], lora_tree, scaling)
    return merged


@torch.no_grad()
def ema_init(base: Dict, lora_tree: Dict, scaling: float) -> Dict:
    """EMA accumulator in fp32 whatever the parameter dtype: with bf16
    params the (1-decay)*delta contribution is usually below the
    accumulator's ulp and a bf16 EMA would freeze at its init value.
    vit_apply casts to the compute dtype at use."""
    return tree_map(lambda a: a.detach().to(torch.float32, copy=True),
                merged_params(base, lora_tree, scaling))


@torch.no_grad()
def ema_update(ema: Dict, base: Dict, lora_tree: Dict, scaling: float,
               decay: float) -> Dict:
    """ema * decay + merged * (1 - decay), in fp32; returns a new tree
    (the JAX function's ``e * decay + t * (1 - decay)`` with fp32
    decay)."""
    d = torch.tensor(decay, dtype=torch.float32)
    one_minus = 1.0 - d
    return tree_map(lambda e, t: e * d.to(e.device) +
                t.detach().float() * one_minus.to(e.device),
                ema, merged_params(base, lora_tree, scaling))
