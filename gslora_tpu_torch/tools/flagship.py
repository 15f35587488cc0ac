"""The set-up the flagship integration tools share (the JAX package's
scripts/integration_*.py each repeat it): the flagship ViT-P8S8 (19.2 M
parameters), its rank-8 LoRA, the synthetic CASIA-100 stand-in and the
pretrained base, cached at ``$PRETRAIN_CKPT``.

The base is read from a port checkpoint (``.pth``, checkpoints/io) or
from a ``.msgpack`` the JAX package's scripts wrote, so both packages can
start from one set of weights. When neither exists it is pretrained with
the scripts' recipe and saved as a ``.pth``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time

import torch

from gslora_tpu_torch.checkpoints import msgpack
from gslora_tpu_torch.checkpoints.io import load_params, save_params
from gslora_tpu_torch.config import (DataConfig, LoraConfig, OptimConfig,
                                     RunConfig, ViTConfig)
from gslora_tpu_torch.data.pipeline import BatchLoader
from gslora_tpu_torch.data.synthetic import synthetic_face_dataset
from gslora_tpu_torch.engine.continual import detached
from gslora_tpu_torch.engine.evaluate import eval_accuracy, make_eval_step
from gslora_tpu_torch.engine.pretrain import pretrain
from gslora_tpu_torch.models.vit import init_vit_params

MODEL = ViTConfig(image_size=112, patch_size=8, dim=512, depth=6, heads=8,
                  dim_head=64, mlp_dim=2048, num_class=100, dropout=0.1,
                  emb_dropout=0.1, head_type="CosFace")
# the CL script's --tiny model (a CPU wiring run)
TINY = dict(image_size=16, dim=64, depth=2, heads=2, dim_head=32,
            mlp_dim=128, dropout=0.0, emb_dropout=0.0)
LORA = LoraConfig(rank=8)
BS = 48
PRETRAIN_BS = 240


def model_config(unsaturated: bool, tiny: bool = False) -> ViTConfig:
    """The flagship with a Softmax head when ``unsaturated`` (CosFace at
    s = 64 saturates CE to 0 on the separable blobs), cut to the tiny
    model when ``tiny``."""
    model = dataclasses.replace(
        MODEL, head_type="Softmax" if unsaturated else "CosFace")
    return dataclasses.replace(model, **TINY) if tiny else model


def noise(unsaturated: bool) -> float:
    return 2.4 if unsaturated else 1.0


def pretrain_epochs(unsaturated: bool) -> int:
    return 12 if unsaturated else 25


def stand_in(model: ViTConfig, noise_std: float):
    """(train, test): 100 classes x 24 images at seed 0, x 5 at seed 77."""
    train = synthetic_face_dataset(num_classes=100, per_class=24,
                                   image_size=model.image_size, seed=0,
                                   noise=noise_std)
    test = synthetic_face_dataset(num_classes=100, per_class=5,
                                  image_size=model.image_size, seed=77,
                                  noise=noise_std)
    return train, test


def checkpoint_path(unsaturated: bool, tiny: bool = False) -> str:
    """``$PRETRAIN_CKPT`` (default ``flagship_pretrained.pth`` in the
    temporary directory), with ``_unsat`` and then ``_tiny`` before the
    suffix, as the scripts name their bases."""
    path = os.environ.get("PRETRAIN_CKPT", os.path.join(
        tempfile.gettempdir(), "flagship_pretrained.pth"))
    for tag, on in (("_unsat", unsaturated), ("_tiny", tiny)):
        if on:
            root, ext = os.path.splitext(path)
            path = f"{root}{tag}{ext}"
    return path


def pretrain_recipe(model: ViTConfig, train, epochs: int, device: str,
                    init, compute_dtype=torch.bfloat16, remat: bool = True,
                    attn_impl: str | None = None):
    """The scripts' pretrain from the parameter tree ``init`` on
    ``device``: every parameter trains, AdamW at lr 3e-4 with the timm
    schedule over ``epochs`` (2 warm-up epochs), bs 240 in the order of
    ``BatchLoader(train, 240, seed=3)``, dropout as ``model`` has it, the
    dropout generator at seed 0. The recipe runs remat in bf16 with
    ``model``'s attention; ``compute_dtype``, ``remat`` and ``attn_impl``
    (when given) change them. Returns (the trained tree on the CPU, the
    last step's metrics as floats)."""
    cfg = RunConfig(
        model=dataclasses.replace(model, remat=remat,
                                  attn_impl=attn_impl or model.attn_impl),
        lora=LORA, optim=OptimConfig(lr=3e-4, warmup_epochs=2, epochs=epochs),
        data=DataConfig(batch_size=PRETRAIN_BS), device=device)
    state, metrics = pretrain(cfg, init,
                              lambda: BatchLoader(train, PRETRAIN_BS, seed=3),
                              epochs=epochs, compute_dtype=compute_dtype)
    return detached(state.params, torch.device("cpu")), \
        {k: float(v) for k, v in metrics.items()}


def pretrained_base(model: ViTConfig, train, epochs: int, device: str,
                    path: str):
    """The base at ``path`` (CPU tensors), or one pretrained with the
    scripts' recipe (remat, AdamW lr 3e-4, 2 warm-up epochs, bs 240, bf16
    compute) on ``device`` from the seed-0 init and saved there. A
    ``.msgpack`` path is the JAX package's format: the port reads it, and
    saves what it pretrains beside it as a ``.pth`` (where it looks too)."""
    root, ext = os.path.splitext(path)
    save_to = root + ".pth"
    for candidate in dict.fromkeys((path, save_to)):
        if os.path.exists(candidate):
            if candidate.endswith(".msgpack"):
                params = msgpack.load(candidate)  # CPU tensors by name
                params.setdefault("lora", {})
            else:
                params = load_params(candidate)
            print("loaded pretrained", candidate, flush=True)
            return params
    t0 = time.time()
    params, _ = pretrain_recipe(
        model, train, epochs, device,
        init_vit_params(torch.Generator().manual_seed(0), model, LORA))
    save_params(save_to, params)
    print("pretrained + saved", save_to, round(time.time() - t0, 1), "s",
          flush=True)
    return params


def accuracy(params, test, model: ViTConfig, device, batch_size: int,
                  mask_padding: bool,
                  compute_dtype=torch.bfloat16) -> float:
    """Top-1 accuracy in percent of ``params`` over ``test`` on
    ``device``, in unshuffled batches of ``batch_size``."""
    ev = make_eval_step(model, LORA, compute_dtype=compute_dtype)
    return eval_accuracy(ev, detached(params, device),
                         BatchLoader(test, batch_size, shuffle=False,
                                     prefetch=0, mask_padding=mask_padding))


def merge_report(path: str, report: dict, indent=None) -> None:
    """``report`` merged into the JSON object at ``path`` (a new one where
    the file is missing or holds no JSON), as the scripts keep their
    reports across runs of different methods."""
    merged = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                merged = json.load(f)
        except ValueError:
            merged = {}
    merged.update(report)
    with open(path, "w") as f:
        json.dump(merged, f, indent=indent)


def dtype(name: str):
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
