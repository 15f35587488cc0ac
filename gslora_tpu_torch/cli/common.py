"""Shared CLI plumbing: dataset construction, model init and resume (port
of gslora_tpu/cli/common.py)."""
from __future__ import annotations

import os
import warnings
from typing import Dict, Optional, Tuple

import torch

from gslora_tpu_torch.config import RunConfig
from gslora_tpu_torch.data.folders import Dataset, ImageFolderDataset
from gslora_tpu_torch.data.synthetic import synthetic_face_dataset
from gslora_tpu_torch.models.convert import flatten_tree, unflatten_tree
from gslora_tpu_torch.models.import_torch import (from_state_dict,
                                                  load_torch_state_dict)
from gslora_tpu_torch.models.vit import init_vit_params

# the JAX package, named in messages only (the port never imports it)
JAX_PACKAGE = "gslora_tpu"


def build_datasets(cfg: RunConfig) -> Tuple[Dataset, Dataset]:
    """(train, test) datasets per cfg.data (reference config.py DATA_ROOT
    layout: <root>/train, <root>/test class folders)."""
    d = cfg.data
    if d.data_mode == "synthetic" or d.data_root == "synthetic":
        train = synthetic_face_dataset(
            num_classes=cfg.model.num_class, per_class=20,
            image_size=cfg.model.image_size, seed=d.seed, noise=1.0)
        test = synthetic_face_dataset(
            num_classes=cfg.model.num_class, per_class=5,
            image_size=cfg.model.image_size, seed=d.seed + 1, noise=1.0)
        return train, test
    imagenet = d.data_mode == "imagenet100"
    raw_u8 = imagenet and d.uint8_transfer
    train = ImageFolderDataset(os.path.join(d.data_root, "train"),
                               image_size=cfg.model.image_size,
                               imagenet_eval=imagenet, raw_uint8=raw_u8)
    test = ImageFolderDataset(os.path.join(d.data_root, "test"),
                              image_size=cfg.model.image_size,
                              imagenet_eval=imagenet,
                              class_order=train.classes, raw_uint8=raw_u8)
    return train, test


def param_summary(params) -> dict:
    """{'base': N, 'lora': M, 'total': N + M, 'trainable_fraction': M/total}
    parameter counts of a {base, lora} tree."""
    def count(tree):
        return sum(count(v) if isinstance(v, dict) else v.numel()
                   for v in tree.values())

    base, lora = count(params.get("base", {})), count(params.get("lora", {}))
    total = base + lora
    return {"base": base, "lora": lora, "total": total,
            "trainable_fraction": lora / total if total else 0.0}


def build_params(cfg: RunConfig, seed: Optional[int] = None):
    """Fresh parameter tree (on the CPU) from a seeded CPU generator, then
    resumed from ``cfg.resume`` (``-r``) when it is set.

    Two formats load, told apart by their keys: the port's own checkpoints
    (checkpoints/io.save_params: a flat dict under the JAX pytree names,
    ``base.*`` / ``lora.*``) and reference-named ``.pth`` state dicts
    (``transformer.layers.{i}...``, models/import_torch). The resume rules
    are the JAX function's (the reference's strict=False resume that lets
    only lora_* keys be absent, train_own_forget.py:629-638):

    * a checkpoint without LoRA loads into a run with a rank; the LoRA
      keeps its fresh init (kaiming A, zero B);
    * a checkpoint's LoRA is dropped, with a warning, when the run has
      rank 0;
    * a LoRA that does not match the run's (rank, placement) raises;
    * a missing or extra non-LoRA key, or a wrong shape, raises.

    Loaded tensors take the fresh tree's dtypes (``--param_dtype`` for the
    base, fp32 for the LoRA)."""
    pdt = torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32
    gen = torch.Generator().manual_seed(seed if seed is not None
                                        else cfg.data.seed)
    params = init_vit_params(gen, cfg.model, cfg.lora, param_dtype=pdt)
    if not cfg.resume:
        return params
    path = cfg.resume
    if path.endswith(".msgpack"):
        raise NotImplementedError(
            f"{path}: the JAX package's .msgpack checkpoints are not read "
            f"by the port yet; convert one with `python -m "
            f"{JAX_PACKAGE}.cli.export_torch -r {path} --export_out "
            f"<file>.pth` and resume from the .pth")
    if cfg.net == "VIT_B16":
        raise NotImplementedError("resuming VIT_B16 (torchvision naming) is "
                                  "not ported yet")
    sd = load_torch_state_dict(path)
    if any(k.startswith("base.") for k in sd):
        loaded = unflatten_tree(sd)
        has_lora = bool(loaded.get("lora"))
    else:
        loaded = from_state_dict(sd, cfg.model, cfg.lora, param_dtype=pdt)
        # as in the JAX function, an all-zero LoRA (the importer's fill for
        # absent keys) keeps the fresh init
        has_lora = any("lora_" in k for k in sd) and not (
            params["lora"] and all(not bool(t.any()) for t in
                                   flatten_tree(loaded["lora"]).values()))
    return _resumed(path, params, loaded, has_lora)


def _resumed(path: str, fresh: Dict, loaded: Dict, has_lora: bool) -> Dict:
    """``loaded`` checked against the fresh tree by the resume rules of
    :func:`build_params`; ``has_lora``: the checkpoint carries a LoRA."""
    want, got = flatten_tree(fresh["base"]), flatten_tree(loaded["base"])
    if set(want) != set(got):
        raise KeyError(f"resume {path}: non-LoRA keys missing "
                       f"{sorted(set(want) - set(got))[:5]}, unexpected "
                       f"{sorted(set(got) - set(want))[:5]}")
    bad = [k for k in want if want[k].shape != got[k].shape]
    if bad:
        raise ValueError(f"resume {path}: shapes differ from this run's "
                         f"model at {bad[:5]}")
    base = unflatten_tree({k: got[k].to(want[k].dtype) for k in want})
    lora = fresh["lora"]
    if has_lora and not fresh["lora"]:
        warnings.warn(f"resume {path}: dropping its LoRA (this run has "
                      f"lora_rank=0)", stacklevel=3)
    elif has_lora:
        lw, lg = flatten_tree(fresh["lora"]), flatten_tree(loaded["lora"])
        if set(lw) != set(lg) or any(lw[k].shape != lg[k].shape
                                     for k in lw):
            raise ValueError(
                f"Wrong resume: {path} carries a LoRA that does not match "
                f"this run's lora_rank / lora_pos (train_own_forget.py:"
                f"629-638 aborts likewise)")
        lora = unflatten_tree({k: lg[k].to(lw[k].dtype) for k in lw})
    return {"base": base, "lora": lora}
