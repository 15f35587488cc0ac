"""Host-side dataset ingestion (replaces torchvision ImageFolder +
mxnet recordio paths, image_iter.py).

The port's copy of ``gslora_tpu/data/folders.py``: images decode with
PIL, and :meth:`ImageFolderDataset.decode_batch` decodes a batch of
already-sized JPEG/PNG files on the C++ thread pool of
gslora_tpu_torch/native (``csrc/imagedec.cpp``) first.

Datasets here are lightweight index structures: ``samples`` (path or array,
label) pairs with ``targets``/``classes`` metadata — decode happens at batch
assembly (pipeline.py), keeping the object cheap to split/subset the way
the reference slices ImageFolders (util/utils.py:371-420).
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from gslora_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".ppm", ".webp")


class Dataset:
    """Minimal dataset protocol: samples [(source, label)], targets, classes,
    class_to_idx, decode(idx) -> (C,H,W) float32."""

    samples: List[Tuple]
    targets: List[int]
    classes: List[str]

    def __len__(self):
        return len(self.samples)

    def decode_batch(self, idxs: Sequence[int]) -> np.ndarray:
        """Batched decode; subclasses with a native fast path override."""
        return np.stack([self.decode(i) for i in idxs])


class ImageFolderDataset(Dataset):
    """Directory-of-class-dirs layout (torchvision ImageFolder semantics:
    classes sorted lexicographically, labels = sorted index)."""

    def __init__(self, root: str, image_size: int = 112,
                 imagenet_eval: bool = False,
                 class_order: Optional[Sequence[str]] = None,
                 raw_uint8: bool = False):
        """``raw_uint8``: decode stops at uint8 CHW pixels (after any
        resize/crop) — the uint8_transfer form; normalization (/255 and,
        for ImageNet, mean/std) then happens ON DEVICE inside the model
        (vit_embed + ViTConfig.input_norm)."""
        self.root = root
        self.image_size = image_size
        self.imagenet_eval = imagenet_eval
        self.raw_uint8 = raw_uint8
        classes = class_order if class_order is not None else sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        self.classes = list(classes)
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples = []
        for c in self.classes:
            cdir = os.path.join(root, c)
            if not os.path.isdir(cdir):
                continue
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith(IMG_EXTS):
                    self.samples.append((os.path.join(cdir, fn),
                                         self.class_to_idx[c]))
        self.targets = [label for _, label in self.samples]

    def decode_batch(self, idxs: Sequence[int]) -> np.ndarray:
        """Batched decode on the native C++ thread pool (libjpeg/libpng,
        the codecs PIL wraps: pixels equal PIL's to the bit for images
        already at ``image_size``). Images the native decoder declines
        (a resize is needed, another codec) are decoded one by one with
        PIL, as is the whole batch on the ImageNet and raw-uint8 paths and
        where the decoder is unavailable (native.decode_image_batch says
        why, once)."""
        idxs = list(idxs)
        if not self.imagenet_eval and not self.raw_uint8:
            from gslora_tpu_torch.native import (decode_image_batch,
                                                 default_threads)
            res = decode_image_batch([self.samples[i][0] for i in idxs],
                                     self.image_size, self.image_size,
                                     threads=default_threads())
            if res is not None:
                out, ok = res
                for j in np.nonzero(~ok)[0]:
                    out[j] = self.decode(idxs[int(j)])
                return out
        return np.stack([self.decode(i) for i in idxs])

    def decode(self, idx: int) -> np.ndarray:
        from PIL import Image
        path, _ = self.samples[idx]
        img = Image.open(path).convert("RGB")
        if self.imagenet_eval:
            img = _resize_short(img, 256)
            img = _center_crop(img, 224)
        elif self.image_size and img.size != (self.image_size,
                                              self.image_size):
            # face path: the reference assumes pre-sized 112x112 folders
            # (no Resize transform); off-size images would otherwise crash
            # np.stack mid-epoch. Pre-sized images pass through untouched.
            img = img.resize((self.image_size, self.image_size))
        if self.raw_uint8:  # normalization happens on device (vit_embed)
            return np.asarray(img, dtype=np.uint8).transpose(2, 0, 1)
        arr = np.asarray(img, dtype=np.float32) / 255.0  # ToTensor
        arr = arr.transpose(2, 0, 1)  # HWC -> CHW
        if self.imagenet_eval:
            mean = np.array(IMAGENET_MEAN, np.float32)[:, None, None]
            std = np.array(IMAGENET_STD, np.float32)[:, None, None]
            arr = (arr - mean) / std
        return arr


def _resize_short(img, size: int):
    """torchvision transforms.Resize(int) semantics (image_iter.py:144):
    short side -> size with BILINEAR (torchvision's PIL default), long side
    scaled by int() truncation (torchvision F.resize)."""
    from PIL import Image
    w, h = img.size
    if w <= h:
        nw, nh = size, max(1, int(h * size / w))
    else:
        nw, nh = max(1, int(w * size / h)), size
    return img.resize((nw, nh), Image.BILINEAR)


def _center_crop(img, size: int):
    """torchvision transforms.CenterCrop semantics (image_iter.py:145):
    offsets int(round(diff / 2)) (Python banker's rounding, as torchvision)."""
    w, h = img.size
    left = int(round((w - size) / 2.0))
    top = int(round((h - size) / 2.0))
    return img.crop((left, top, left + size, top + size))


class ArrayDataset(Dataset):
    """In-memory dataset over (N, C, H, W) float32 images — synthetic data,
    tests, and pre-decoded caches."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 classes: Optional[List[str]] = None):
        self.images = images
        self.labels = np.asarray(labels, dtype=np.int64)
        self.samples = [(i, int(l)) for i, l in enumerate(self.labels)]
        self.targets = [int(l) for l in self.labels]
        n_cls = int(self.labels.max()) + 1 if len(self.labels) else 0
        self.classes = classes or [str(i) for i in range(n_cls)]
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}

    def decode(self, idx: int) -> np.ndarray:
        src, _ = self.samples[idx]
        return self.images[src]


class SubsetDataset(Dataset):
    """Subset preserving targets/classes (image_iter.py:124-137
    CustomSubset)."""

    def __init__(self, parent: Dataset, indices: Sequence[int]):
        self.parent = parent
        self.indices = list(indices)
        self.samples = [parent.samples[i] for i in self.indices]
        self.targets = [parent.targets[i] for i in self.indices]
        self.classes = parent.classes
        self.class_to_idx = getattr(parent, "class_to_idx", {})

    def decode(self, idx: int) -> np.ndarray:
        return self.parent.decode(self.indices[idx])

    def decode_batch(self, idxs: Sequence[int]) -> np.ndarray:
        return self.parent.decode_batch([self.indices[i] for i in idxs])


class ConcatDataset(Dataset):
    """Concatenation preserving the decode protocol (torch ConcatDataset
    analogue used by Replay, train_own_forget_cl.py:691-695)."""

    def __init__(self, a: Dataset, b: Dataset):
        self.a, self.b = a, b
        self.samples = list(a.samples) + list(b.samples)
        self.targets = list(a.targets) + list(b.targets)
        self.classes = a.classes
        self.class_to_idx = getattr(a, "class_to_idx", {})

    def decode(self, idx: int) -> np.ndarray:
        if idx < len(self.a):
            return self.a.decode(idx)
        return self.b.decode(idx - len(self.a))

    def decode_batch(self, idxs: Sequence[int]) -> np.ndarray:
        """Route index sub-ranges to each parent's decode_batch so their
        batched fast paths (C++ thread-pool decode) survive concatenation
        — the inherited per-image fallback would drop them on the Replay
        hot path."""
        idxs = list(idxs)
        na = len(self.a)
        pos_a = [(j, i) for j, i in enumerate(idxs) if i < na]
        pos_b = [(j, i - na) for j, i in enumerate(idxs) if i >= na]
        out: List = [None] * len(idxs)
        for pairs, ds in ((pos_a, self.a), (pos_b, self.b)):
            if pairs:
                batch = ds.decode_batch([i for _, i in pairs])
                for (j, _), arr in zip(pairs, batch):
                    out[j] = arr
        return np.stack(out)


class PathListDataset(Dataset):
    """Path-list dataset (reference ImageNet900Dataset, image_iter.py:140-159):
    entries are (image_path, label) pairs with the ImageNet eval transform —
    used for the missing-class eval over held-out classes with the restored
    1000-way head."""

    def __init__(self, entries, image_size: int = 224,
                 raw_uint8: bool = False):
        self.samples = [(p, int(l)) for p, l in entries]
        self.targets = [l for _, l in self.samples]
        # protocol contract: classes is indexed BY LABEL (labels here are
        # global ImageNet-1k indices, so fill 0..max); a sorted string set
        # would misalign classes[l] for every consumer (splits.unique_classes)
        n_cls = (max(self.targets) + 1) if self.targets else 0
        self.classes = [str(i) for i in range(n_cls)]
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.image_size = image_size
        self.raw_uint8 = raw_uint8

    def decode(self, idx: int) -> np.ndarray:
        from PIL import Image
        path, _ = self.samples[idx]
        img = Image.open(path).convert("RGB")
        img = _resize_short(img, 256)
        img = _center_crop(img, self.image_size)
        if self.raw_uint8:  # normalization happens on device (vit_embed)
            return np.asarray(img, np.uint8).transpose(2, 0, 1)
        arr = (np.asarray(img, np.float32) / 255.0).transpose(2, 0, 1)
        mean = np.array(IMAGENET_MEAN, np.float32)[:, None, None]
        std = np.array(IMAGENET_STD, np.float32)[:, None, None]
        return (arr - mean) / std


class AugmentedDataset(Dataset):
    """x-k duplication with augmentation (reference AugmentedDataset /
    TransformWrapper, image_iter.py:162-203): each sample appears k times;
    copies beyond the first get a seeded random augmentation (flip + jitter
    — a PIL-free stand-in for RandAugment used in few-shot prototype
    replication, util/utils.py:502-549)."""

    def __init__(self, parent: Dataset, k: int, magnitude: int = 5,
                 seed: int = 0):
        self.parent = parent
        self.k = k
        self.magnitude = magnitude
        self.seed = seed
        self.samples = [parent.samples[i % len(parent)]
                        for i in range(len(parent) * k)]
        self.targets = [parent.targets[i % len(parent)]
                        for i in range(len(parent) * k)]
        self.classes = parent.classes
        self.class_to_idx = getattr(parent, "class_to_idx", {})

    def decode(self, idx: int) -> np.ndarray:
        base = self.parent.decode(idx % len(self.parent))
        if base.dtype == np.uint8:
            raise ValueError(
                "AugmentedDataset over a raw_uint8 parent would mix uint8 "
                "clean copies with float augmented ones and skip device "
                "normalization — use a float-decoding parent (augmented "
                "streams are not uint8-representable)")
        copy_id = idx // len(self.parent)
        if copy_id == 0:
            return base
        rng = np.random.RandomState(self.seed + idx)
        img = base
        if rng.randint(2):
            img = img[:, :, ::-1]
        shift = rng.randint(-2, 3, size=2)
        img = np.roll(img, shift, axis=(1, 2))
        img = img * (1.0 + 0.02 * self.magnitude * rng.randn())
        img = img + 0.01 * self.magnitude * rng.randn(*img.shape) \
            .astype(np.float32)
        return img.astype(np.float32)


class RelabelDataset(Dataset):
    """Random-relabel wrapper for the "forget by wrong label" baselines
    (image_iter.py:89-121 CLDatasetWrapper): label -> (label + rand) % C,
    never the original, fixed per sample by seed."""

    def __init__(self, parent: Dataset, num_classes: int, seed: int = 0):
        import random as pyrandom
        rng = pyrandom.Random(seed)
        self.parent = parent
        self.targets = [
            (t + rng.randint(1, num_classes - 1)) % num_classes
            for t in parent.targets]
        self.classes = parent.classes
        self.class_to_idx = getattr(parent, "class_to_idx", {})
        self.samples = [(s, nt) for (s, _), nt in
                        zip(parent.samples, self.targets)]

    def decode(self, idx: int) -> np.ndarray:
        return self.parent.decode(idx)

    def decode_batch(self, idxs: Sequence[int]) -> np.ndarray:
        # pixels are untouched by relabeling: keep the parent's batched
        # fast path (the relabeled forget stream is a training hot path)
        return self.parent.decode_batch(list(idxs))
