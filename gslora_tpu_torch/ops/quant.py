"""Dynamic int8 GEMM for serving, W8A8 (port of gslora_tpu/ops/quant.py).

The transformer's projection GEMMs quantized on the fly:

* activations: per-tensor dynamic absmax -> int8 (one fp32 reduction per
  GEMM; post-LayerNorm activations are well bounded, so one scale holds
  the tensor's range);
* weights: per-output-channel absmax -> int8 (per-channel keeps a column
  with a small norm from losing its mantissa to one large column);
* the int8 x int8 -> int32 product, then the rescale to fp32 and the cast
  to the compute dtype.

Eval and serving only: the rounding has zero gradient, so
models/vit.vit_embed refuses int8 under ``train=True``. The weights are
quantized per call, as in the JAX package (no cached int8 weights).

The JAX package leaves the int8 product to XLA (``lax.dot_general``); it
is no Pallas kernel, so the port leaves it to ``torch._int_mm`` (cuBLAS on
the card), a plain matrix product outside any kernel of the port. On the
card ``_int_mm`` takes more than 16 rows and K and N that are multiples of
8 (every projection of ViT-P8S8 and ViT-B/16 does: K, N in {192, 512,
768, 1536, 2048, 2304, 3072}, rows B*196 or B*197); :func:`int8_matmul`
raises for a CUDA shape it refuses and never falls back to a float
product. Quantization divides by the scale (``round(x / s)``), as the JAX
package does, so both round alike.

:func:`int8_linear_reference` is the plain twin: the same quantized
operands, their product in float64 (exact: every partial sum is an
integer below 2**53, where fp32 would round above 2**24, which fc2's
K = 2048 can reach) and the same rescale. :func:`quant_mismatch` holds
:func:`int8_linear` to it.
"""
from __future__ import annotations

import torch

# relative agreement of int8_linear with its float64 twin: both round the
# exact integer product to fp32 once and rescale alike, so they agree to
# the last bit; the limit leaves room for nothing else
REL_TOL = 1e-6
# _int_mm's shape rules on the card (ATen's _int_mm_out_cuda)
CUDA_MIN_ROWS = 17
CUDA_MULTIPLE = 8


def quantize_per_tensor(x: torch.Tensor):
    """fp -> (int8, fp32 scale) with symmetric per-tensor absmax."""
    xf = x.float()
    s = torch.clamp_min(xf.abs().amax() / 127.0, 1e-12)  # zeros -> zeros
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


def quantize_per_channel(w: torch.Tensor):
    """(K, N) fp -> (int8, (1, N) fp32 scales), symmetric absmax per output
    channel."""
    wf = w.float()
    s = torch.clamp_min(wf.abs().amax(dim=0, keepdim=True) / 127.0, 1e-12)
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return q, s


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact. On a CUDA tensor
    the shape must be one ``_int_mm`` takes there (else ValueError), and
    ``b`` goes in column-major: on an H100 (PyTorch 2.11, CUDA 12.8) that
    layout ran 3.5-5.6x faster than a row-major ``b`` at the flagship's
    projection shapes (PERF.md)."""
    if a.is_cuda:
        m, k = a.shape
        n = b.shape[1]
        if m < CUDA_MIN_ROWS or k % CUDA_MULTIPLE or n % CUDA_MULTIPLE:
            raise ValueError(
                f"int8 product of ({m}, {k}) x ({k}, {n}) on the card: "
                f"_int_mm there takes at least {CUDA_MIN_ROWS} rows and K, "
                f"N that are multiples of {CUDA_MULTIPLE}")
        b = b.t().contiguous().t()
    return torch._int_mm(a, b)


def int8_linear(x: torch.Tensor, w: torch.Tensor,
                out_dtype=None) -> torch.Tensor:
    """``x @ w`` with W8A8 dynamic quantization.

    x: (..., K) activations; w: (K, N) weights. Returns (..., N) in
    ``out_dtype`` (default: x.dtype). The int32 sum cannot overflow:
    |q| <= 127, so each product is <= 16129 and K <= 2**17 keeps the sum
    under 2**31."""
    return _w8a8(x, w, out_dtype, int8_matmul)


def int8_linear_reference(x: torch.Tensor, w: torch.Tensor,
                          out_dtype=None) -> torch.Tensor:
    """The plain twin of :func:`int8_linear`: the same quantized operands,
    their product in float64 (exact), the same rescale and cast."""
    return _w8a8(x, w, out_dtype, lambda a, b: a.double() @ b.double())


def _w8a8(x, w, out_dtype, product):
    """Quantize x per tensor and w per channel, take ``product`` of the
    int8 operands, rescale it in fp32 and cast to ``out_dtype``."""
    out_dtype = out_dtype or x.dtype
    lead, k = x.shape[:-1], x.shape[-1]
    qx, sx = quantize_per_tensor(x.reshape(-1, k))
    qw, sw = quantize_per_channel(w)
    y = product(qx, qw).float() * (sx * sw)
    return y.reshape(*lead, w.shape[-1]).to(out_dtype)


def quant_mismatch(got: torch.Tensor, want: torch.Tensor) -> dict:
    """How far ``got`` (int8_linear) is from ``want`` (its float64 twin):
    the largest abs error, the largest error relative to each element
    (elements where the twin is 0 must be 0) and ``ok`` when that is
    within REL_TOL."""
    g, w = got.double(), want.double()
    err = (g - w).abs()
    rel = torch.where(w == 0, torch.where(err == 0, 0.0, float("inf")),
                      err / w.abs())
    max_rel = float(rel.max()) if rel.numel() else 0.0
    return {"max_abs": float(err.max()) if err.numel() else 0.0,
            "max_rel": max_rel, "ok": max_rel <= REL_TOL}
