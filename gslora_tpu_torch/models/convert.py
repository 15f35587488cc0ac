"""Carry parameters between the JAX package and the port.

Both packages keep the same tree ({"base": ..., "lora": ...}, stacked
[L, ...] blocks, kernels (fan_in, fan_out)), so converting is a
name-for-name copy: the JAX pytree path ``base/blocks/fc1/kernel`` is the
port's parameter name ``base.blocks.fc1.kernel``. The JAX side is handled
as nested dicts of numpy arrays only.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def flatten_tree(tree: Dict, prefix: str = "") -> Dict:
    """Nested dict -> {"a.b.c": leaf}."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_tree(v, name + "."))
        else:
            out[name] = v
    return out


def unflatten_tree(flat: Dict) -> Dict:
    """{"a.b.c": leaf} -> nested dict."""
    tree: Dict = {}
    for name, v in flat.items():
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def params_from_jax(tree_of_numpy: Dict, device="cpu", dtype=None) -> Dict:
    """JAX parameter tree (numpy leaves) -> the port's parameter tree of
    tensors (``ViT(tree, ...)`` holds it; ``flatten_tree`` gives its state
    dict). ``dtype`` casts every tensor (default: keep each leaf's). A
    subtree without ``base`` (LIRF's half-depth ``student_low`` and
    ``deposit_low``, an importance or anchor of the base alone) converts
    as it is; a full tree gets an empty ``lora`` when it has none."""
    def conv(leaf):
        a = np.array(leaf, copy=True)
        if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: numpy has none
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        return t.to(device=device, dtype=dtype or t.dtype)

    flat = {k: conv(v) for k, v in flatten_tree(tree_of_numpy).items()}
    tree = unflatten_tree(flat)
    if "base" in tree:
        tree.setdefault("lora", {})
    return tree


def params_to_jax(params) -> Dict:
    """The port's parameters (a models.vit.ViT or a parameter tree) -> the
    JAX package's tree with numpy leaves (bf16 widened to fp32)."""
    if isinstance(params, torch.nn.Module):
        params = params.tree()

    def conv(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    tree = unflatten_tree({k: conv(v)
                           for k, v in flatten_tree(params).items()})
    if "base" in tree:
        tree.setdefault("lora", {})
    return tree
