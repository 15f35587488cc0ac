"""Class prototypes = mean embedding per class under the pretrained model
(util/utils.py:502-549 calculate_prototypes; port of
gslora_tpu/engine/prototypes.py).

A dense (num_class, dim) fp32 table: unseen classes stay zero and are
never gathered. Few-shot replication (``aug_repeat > 0``) uses the
reference's policy: torchvision RandAugment(num_ops=2, magnitude=aug_num)
on every one of the x20 copies, with no clean copy (util/utils.py:508-523
replaces the dataset transform before replicating), through the port's
own copy in data/randaugment.py.
"""
from __future__ import annotations

import numpy as np
import torch

from gslora_tpu_torch.config import (IMAGENET_MEAN, IMAGENET_STD, LoraConfig,
                                     ViTConfig)
from gslora_tpu_torch.models.vit import params_device, vit_apply


@torch.no_grad()
def calculate_prototypes(params, batches, model: ViTConfig, lora: LoraConfig,
                         num_classes: int, compute_dtype=torch.bfloat16,
                         aug_repeat: int = 0, seed: int = 0,
                         aug_magnitude: int = 9, mesh=None) -> torch.Tensor:
    """Stream (x, y) numpy batches through the (pretrained) model; return
    the dense class-mean embedding table (num_classes, dim) fp32 on the
    parameters' device. Pad slots (label -1) are dropped.

    aug_repeat=0: clean images once (the non-few-shot reference path).
    aug_repeat=k: k RandAugment(magnitude=aug_magnitude) views per image,
    seeded with ``seed``, no clean view (the reference's x20 replication).

    ``mesh``: each rank passed its rows of every batch; the per-class sums
    and counts are summed over the ranks. Not with ``aug_repeat``, whose
    RandAugment draws run in one sequence over the whole set: there every
    rank passes every row and the table needs no collective. Under pp
    every model rank passes the same batches, so the pipeline's schedule
    runs in lockstep."""
    if mesh is not None and aug_repeat > 0:
        raise ValueError("augmented prototypes take every row on every "
                         "rank: pass mesh=None with unsharded batches")
    device = params_device(params)

    def embed(x):
        return vit_apply(params, torch.from_numpy(x).to(device), None, model,
                         lora, train=False, compute_dtype=compute_dtype)

    aug = None
    if aug_repeat > 0:
        from gslora_tpu_torch.data.randaugment import RandAugment
        aug = RandAugment(num_ops=2, magnitude=aug_magnitude, seed=seed)
    mean = np.asarray(IMAGENET_MEAN, np.float32).reshape(1, 3, 1, 1)
    std = np.asarray(IMAGENET_STD, np.float32).reshape(1, 3, 1, 1)
    renorm = model.input_norm == "imagenet"
    sums = np.zeros((num_classes, model.dim), np.float64)
    counts = np.zeros((num_classes,), np.int64)
    for x, y in batches:
        x = np.asarray(x)
        if aug is None:
            # uint8-transfer batches pass straight through (vit_embed
            # dequantizes and normalizes on the device)
            embs = [embed(x)]
        else:
            # RandAugment works on [0, 1] pixels (the reference augments
            # PIL images BEFORE ToTensor + Normalize), and vit_embed takes
            # fp32 input as fully host-normalized: so back to pixel space,
            # augment, then the model's norm again
            if x.dtype == np.uint8:
                x = x.astype(np.float32) / np.float32(255.0)
            elif renorm:
                x = x * std + mean  # host-normalized ImageNet fp32
            embs = []
            for _ in range(aug_repeat):
                v = aug.apply_batch(x)
                if renorm:
                    v = (v - mean) / std
                embs.append(embed(v))
        y = np.asarray(y)
        keep = y >= 0
        for e in embs:
            np.add.at(sums, y[keep], e.float().cpu().numpy()[keep]
                      .astype(np.float64))
            np.add.at(counts, y[keep], 1)
    if mesh is not None:
        both = torch.from_numpy(np.concatenate(
            [sums, counts[:, None].astype(np.float64)], axis=1)).to(
                mesh.device)
        mesh.all_reduce_([both])
        both = both.cpu().numpy()
        sums, counts = both[:, :-1], np.rint(both[:, -1]).astype(np.int64)
    safe = np.maximum(counts, 1)[:, None]
    return torch.from_numpy((sums / safe).astype(np.float32)).to(device)
