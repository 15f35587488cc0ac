"""Host-side RandAugment — the exact torchvision v0.15 op set (the port's
own copy of gslora_tpu/data/randaugment.py: numpy and PIL, seeded, the
same draws and the same pixels for the same seed).

The reference's few-shot prototype path applies
``transforms.RandAugment(num_ops=2, magnitude=aug_num)`` to the prototype
dataset and replicates it x20 (util/utils.py:508-523). torchvision is not a
dependency of the port, so the policy is re-implemented here on PIL —
the same backend torchvision's PIL code path dispatches to (ImageOps /
ImageEnhance / Image.transform), with torchvision's magnitude tables:

  ShearX/Y       linspace(0, 0.3, 31)                 signed
  TranslateX/Y   linspace(0, 150/331 * size, 31) px   signed
  Rotate         linspace(0, 30, 31) deg              signed
  Brightness/Color/Contrast/Sharpness
                 factor 1 +/- linspace(0, 0.9, 31)    signed
  Posterize      8 - round(bin / 7.5) bits
  Solarize       linspace(255, 0, 31) threshold
  Identity / AutoContrast / Equalize                  no magnitude

Signed magnitudes flip with p=0.5 per application, ops drawn uniformly with
replacement — torchvision RandAugment.forward semantics. Geometric ops use
NEAREST resampling (torchvision default); shears act about the TOP-LEFT
corner (torchvision passes center=[0, 0]), translations truncate to whole
pixels (int(magnitude)), rotation is about the image center.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def _affine(img, coeffs):
    from PIL import Image
    return img.transform(img.size, Image.AFFINE, coeffs,
                         resample=Image.NEAREST)


def _apply_op(img, name: str, mag: float):
    from PIL import Image, ImageEnhance, ImageOps
    if name == "Identity":
        return img
    if name == "ShearX":
        # torchvision v0.15 shears about the TOP-LEFT corner (center=[0,0]
        # in autoaugment._apply_op): _get_inverse_affine_matrix(rot=0,
        # sx=atan(mag), cx=cy=0) yields PIL inverse-map coefficients
        # (1, mag, 0, 0, 1, 0) — no center offset (row y=0 stays fixed)
        return _affine(img, (1.0, mag, 0.0, 0.0, 1.0, 0.0))
    if name == "ShearY":
        return _affine(img, (1.0, 0.0, 0.0, mag, 1.0, 0.0))
    if name == "TranslateX":
        # torchvision truncates the pixel shift toward zero:
        # translate=[int(magnitude), 0] (autoaugment._apply_op)
        return _affine(img, (1.0, 0.0, -int(mag), 0.0, 1.0, 0.0))
    if name == "TranslateY":
        return _affine(img, (1.0, 0.0, 0.0, 0.0, 1.0, -int(mag)))
    if name == "Rotate":
        return img.rotate(mag, resample=Image.NEAREST)
    if name == "Brightness":
        return ImageEnhance.Brightness(img).enhance(1.0 + mag)
    if name == "Color":
        return ImageEnhance.Color(img).enhance(1.0 + mag)
    if name == "Contrast":
        return ImageEnhance.Contrast(img).enhance(1.0 + mag)
    if name == "Sharpness":
        return ImageEnhance.Sharpness(img).enhance(1.0 + mag)
    if name == "Posterize":
        return ImageOps.posterize(img, int(mag))
    if name == "Solarize":
        # float threshold, like torchvision's F.solarize pass-through
        # (pixels >= threshold invert; int() would also invert the pixel
        # equal to floor(threshold))
        return ImageOps.solarize(img, mag)
    if name == "AutoContrast":
        return ImageOps.autocontrast(img)
    if name == "Equalize":
        return ImageOps.equalize(img)
    raise ValueError(f"unknown op {name}")


class RandAugment:
    """transforms.RandAugment(num_ops, magnitude) on PIL images / float
    CHW numpy batches."""

    NUM_BINS = 31

    def __init__(self, num_ops: int = 2, magnitude: int = 9,
                 seed: Optional[int] = None):
        if not 0 <= magnitude < self.NUM_BINS:
            raise ValueError(f"magnitude {magnitude} not in [0, 31)")
        self.num_ops = num_ops
        self.magnitude = magnitude
        self.rng = np.random.RandomState(seed)

    def _space(self, w: int, h: int):
        bins = self.NUM_BINS
        m = self.magnitude

        def lin(hi):
            return np.linspace(0.0, hi, bins)[m]

        return [
            ("Identity", 0.0, False),
            ("ShearX", lin(0.3), True),
            ("ShearY", lin(0.3), True),
            ("TranslateX", lin(150.0 / 331.0 * w), True),
            ("TranslateY", lin(150.0 / 331.0 * h), True),
            ("Rotate", lin(30.0), True),
            ("Brightness", lin(0.9), True),
            ("Color", lin(0.9), True),
            ("Contrast", lin(0.9), True),
            ("Sharpness", lin(0.9), True),
            ("Posterize", 8 - round(m / ((bins - 1) / 4)), False),
            ("Solarize", float(np.linspace(255.0, 0.0, bins)[m]), False),
            ("AutoContrast", 0.0, False),
            ("Equalize", 0.0, False),
        ]

    def __call__(self, img):
        """Augment one PIL image."""
        space = self._space(*img.size)
        for _ in range(self.num_ops):
            name, mag, signed = space[self.rng.randint(len(space))]
            if signed and self.rng.randint(2):
                mag = -mag
            img = _apply_op(img, name, mag)
        return img

    def apply_batch(self, batch: np.ndarray) -> np.ndarray:
        """Augment a float [0,1] CHW batch (the framework's in-memory image
        format); round-trips through uint8 PIL exactly like the reference's
        PIL dataset -> RandAugment -> ToTensor chain."""
        from PIL import Image
        out = np.empty_like(batch, dtype=np.float32)
        for i, chw in enumerate(batch):
            u8 = np.clip(np.round(chw.transpose(1, 2, 0) * 255.0), 0,
                         255).astype(np.uint8)
            aug = self(Image.fromarray(u8))
            out[i] = np.asarray(aug, np.float32).transpose(2, 0, 1) / 255.0
        return out
