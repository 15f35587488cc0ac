"""Shared CLI plumbing: dataset construction and model init (port of
gslora_tpu/cli/common.py). Resuming from a checkpoint (``-r``) is still to
port and raises."""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from gslora_tpu_torch.config import RunConfig
from gslora_tpu_torch.data.folders import Dataset, ImageFolderDataset
from gslora_tpu_torch.data.synthetic import synthetic_face_dataset
from gslora_tpu_torch.models.vit import init_vit_params


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
    """Fresh parameter tree (on the CPU) from a seeded CPU generator."""
    if cfg.resume:
        raise NotImplementedError("resuming from a checkpoint (-r) is not "
                                  "ported yet")
    pdt = torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32
    gen = torch.Generator().manual_seed(seed if seed is not None
                                        else cfg.data.seed)
    return init_vit_params(gen, cfg.model, cfg.lora, param_dtype=pdt)
