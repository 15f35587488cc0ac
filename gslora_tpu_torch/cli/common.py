"""Shared CLI plumbing: dataset construction, model init and resume (port
of gslora_tpu/cli/common.py)."""
from __future__ import annotations

import os
import warnings
from typing import Dict, Optional, Tuple

import torch

from gslora_tpu_torch.checkpoints import msgpack
from gslora_tpu_torch.config import RunConfig
from gslora_tpu_torch.data.folders import (Dataset, ImageFolderDataset,
                                           PathListDataset)
from gslora_tpu_torch.data.synthetic import synthetic_face_dataset
from gslora_tpu_torch.models.convert import flatten_tree, unflatten_tree
from gslora_tpu_torch.models.import_torch import (from_state_dict,
                                                  load_torch_state_dict)
from gslora_tpu_torch.models.vit import init_vit_params
from gslora_tpu_torch.models.vit_imagenet import (from_torchvision_state_dict,
                                                  modify_head)


def idle_rank(mesh) -> bool:
    """Whether this rank sits past the mesh (JAX's devices past
    ``S·D·M``): it made the process groups with the others in
    ``make_mesh`` and now leaves, after one line; it builds no model,
    loads no data and writes nothing."""
    if mesh is None or not mesh.idle:
        return False
    print(f"rank {mesh.rank} idle: the mesh uses {mesh.size()} of "
          f"{mesh.world} ranks", flush=True)
    return True


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


def build_params(cfg: RunConfig, seed: Optional[int] = None):
    """Fresh parameter tree (on the CPU) from a seeded CPU generator, then
    resumed from ``cfg.resume`` (``-r``) when it is set.

    Four formats load: the JAX package's ``.msgpack`` trees
    (checkpoints/msgpack), the port's own checkpoints
    (checkpoints/io.save_params: a flat dict under the JAX pytree names,
    ``base.*`` / ``lora.*``), and ``.pth`` state dicts in the reference's
    face-ViT naming (``transformer.layers.{i}...``, models/import_torch)
    or, for ``-n VIT_B16``, torchvision's (``encoder.layers...``,
    models/vit_imagenet); the last three are told apart by their keys.
    The resume rules are the JAX function's (the reference's strict=False
    resume that lets only lora_* keys be absent,
    train_own_forget.py:629-638):

    * a checkpoint without LoRA (or with an all-zero one) loads into a run
      with a rank; the LoRA keeps its fresh init (kaiming A, zero B);
    * a checkpoint's LoRA is dropped, with a warning, when the run has
      rank 0;
    * a LoRA that does not match the run's (rank, placement) raises;
    * a missing or extra non-LoRA key, or a wrong shape, raises; for
      VIT_B16 the head comes as the checkpoint has it (a torchvision
      1000-way head is cut down afterwards by
      :func:`prepare_imagenet_head`, as in the JAX package).

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
        loaded = msgpack.load(path)
        if not isinstance(loaded, dict) or "base" not in loaded:
            raise ValueError(f"resume {path}: not a parameter tree (no "
                             f"'base' subtree)")
        # a task snapshot holds the merged base alone
        loaded.setdefault("lora", {})
        has_lora = bool(loaded["lora"])
    else:
        sd = load_torch_state_dict(path)
        if any(k.startswith("base.") for k in sd):
            loaded = unflatten_tree(sd)
            loaded.setdefault("lora", {})
            has_lora = bool(loaded["lora"])
        else:
            if cfg.net == "VIT_B16":
                loaded = from_torchvision_state_dict(sd, cfg.model, cfg.lora,
                                                     param_dtype=pdt)
            else:
                loaded = from_state_dict(sd, cfg.model, cfg.lora,
                                         param_dtype=pdt)
            # as in the JAX function, an all-zero LoRA (the importer's
            # fill for absent keys) keeps the fresh init
            has_lora = any("lora_" in k for k in sd) and not (
                params["lora"] and all(not bool(t.any()) for t in
                                       flatten_tree(loaded["lora"]).values()))
    return _resumed(path, params, loaded, has_lora,
                    head_as_is=cfg.net == "VIT_B16")


def _resumed(path: str, fresh: Dict, loaded: Dict, has_lora: bool,
             head_as_is: bool = False) -> Dict:
    """``loaded`` checked against the fresh tree by the resume rules of
    :func:`build_params`; ``has_lora``: the checkpoint carries a LoRA;
    ``head_as_is``: the head keeps the checkpoint's shape."""
    want, got = flatten_tree(fresh["base"]), flatten_tree(loaded["base"])
    if set(want) != set(got):
        raise KeyError(f"resume {path}: non-LoRA keys missing "
                       f"{sorted(set(want) - set(got))[:5]}, unexpected "
                       f"{sorted(set(got) - set(want))[:5]}")
    bad = [k for k in want if want[k].shape != got[k].shape and not (
        head_as_is and k.startswith("head."))]
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


def _imagenet_global_index(data_root: str) -> Optional[Dict[str, int]]:
    """wnid -> ImageNet-1k index from <data_root>/imagenet_folder_names.txt
    (the file the reference requires, train_own_forget_cl.py:148-155)."""
    path = os.path.join(data_root, "imagenet_folder_names.txt")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        classes = [ln.strip() for ln in f if ln.strip()]
    return {c: i for i, c in enumerate(classes)}


def prepare_imagenet_head(cfg: RunConfig, params: Dict, train_ds: Dataset):
    """ImageNet-100 head surgery (reference modify_head flow,
    train_own_forget_cl.py:180-296): a resumed head wider than the run's
    classes (torchvision's 1000-way) is cut down to them by the
    wnid -> index map. Returns (params, original head or None); the
    original head serves the missing-class eval (resume_head)."""
    head = params["base"].get("head", {})
    w = head.get("weight")
    C = cfg.model.num_class
    if w is None or w.shape[0] == C:
        return params, None
    idx_of = _imagenet_global_index(cfg.data.data_root)
    if idx_of is not None:
        missing = [c for c in train_ds.classes if c not in idx_of]
        if missing:
            raise ValueError(
                f"dataset classes not in the ImageNet-1k list: "
                f"{missing[:5]} (train_own_forget_cl.py:183-186 assert)")
        class_id_map = {i: idx_of[c] for i, c in enumerate(train_ds.classes)}
    else:
        warnings.warn(
            "imagenet_folder_names.txt not found under data_root — slicing "
            f"the first {C} head rows (class identity NOT aligned with "
            "ImageNet-1k indices)")
        class_id_map = {i: i for i in range(C)}
    out = modify_head(params, class_id_map)
    original = out.pop("original_head")
    print(f"sliced ImageNet head {w.shape[0]} -> {C} classes")
    return out, original


def build_missing_dataset(cfg: RunConfig, miss_root: str) -> PathListDataset:
    """Held-out-class val set with GLOBAL ImageNet-1k labels (reference
    ImageNet900 construction, train_own_forget_cl.py:160-178)."""
    idx_of = _imagenet_global_index(cfg.data.data_root)
    if idx_of is None:
        raise FileNotFoundError(
            "imagenet_folder_names.txt required under data_root for the "
            "missing-class eval")
    entries = []
    for cls in sorted(os.listdir(miss_root)):
        cdir = os.path.join(miss_root, cls)
        if not os.path.isdir(cdir):
            continue
        if cls not in idx_of:
            raise ValueError(f"held-out class {cls!r} not in the global "
                             "1000-class list (cl.py:170-171)")
        for fn in sorted(os.listdir(cdir)):
            if fn.lower().endswith((".jpg", ".jpeg", ".png")):
                entries.append((os.path.join(cdir, fn), idx_of[cls]))
    return PathListDataset(entries, image_size=cfg.model.image_size)
