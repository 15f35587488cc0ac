"""Fused multi-head attention: the hand-written Hopper kernel K1 and its
plain PyTorch version.

Port of ``gslora_tpu/ops/attention.py``. The TPU kernel computes one
(b, h) slice entirely in VMEM with a recompute backward (no attention
residuals in device memory):

  fwd:  dots = q kᵀ · scale (fp32); p = softmax_fp32(dots);
        o = cast(p) v (fp32 accumulation)
  bwd:  recompute p, then dv = cast(p)ᵀ g, dp = g vᵀ,
        ddots = p * (dp - rowsum(dp ⊙ p)),
        dq = cast(ddots) k · scale, dk = cast(ddots)ᵀ q · scale

where cast rounds to the input dtype: bf16 under the bf16 compute dtype,
nothing under fp32. On the card both directions run in hand-written CUDA
C++ for sm_90a, bound with ctypes, one library per dtype with the same C
interface: ``csrc/attention.cu`` for bfloat16 (wgmma and TMA) and
``csrc/attention_fp32.cu`` for float32 (three-pass TF32 on the tensor
cores: wgmma and TMA); each source notes its design and bound. The backward is two launches: a rows
kernel (dq and the row statistics m, l, 1/l, D = rowsum(dp ⊙ p) of each
query row) and a keys kernel (dk, dv from those statistics);
``BWD_LAUNCHES`` counts the pair once. The plain version below computes the
same function with the same rounding points in eager PyTorch; it runs for
tensors on the CPU and is what the kernel is held against on the card.
There is no fallback: a CUDA tensor goes to the kernel of its dtype, or the
wrapper raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

# Launch counts of the two kernels, over both dtypes (plain versions are
# not counted), and the same counts by the inputs' dtype.
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
FWD_BY_DTYPE = dict.fromkeys(KERNEL_DTYPES, 0)
BWD_BY_DTYPE = dict.fromkeys(KERNEL_DTYPES, 0)

KERNEL_HEAD_DIMS = (16, 32, 64, 128)
# Longest sequence the kernels take: a 64-row query tile keeps its whole
# score row on chip, in registers (bf16: padded to 16 keys; fp32: padded to
# 8 keys).
KERNEL_MAX_N = 256
# fp32 row statistics the backward's first launch leaves for its second, one
# plane each: m, l, 1 / l and D = rowsum(dp ⊙ p)
STATS = ("m", "l", "inv_l", "D")
# The source of each dtype's kernels (csrc/<name>.cu); both export the same
# C interface.
SOURCES = {torch.bfloat16: "attention", torch.float32: "attention_fp32"}
_LIBS = {}

# How far a kernel output may sit from the plain version's, by dtype. Each
# output is held to its own size: max|a - b| <= max_rel * max|b| and
# ||a - b|| <= l2 * ||b||.
# bf16: both round at the same points and differ only in the order of fp32
# sums, so an element moves by one bf16 ulp, and rarely: four ulps of the
# largest element (2^-6) and 2e-3.
# fp32: nothing is rounded below fp32, so the two differ by the order of
# fp32 sums and a few ulps of exp. At the flagship's n and d the plain
# version itself sits about 1e-6 (max) and 4e-7 (L2) from a float64 one,
# also at n = 256, d = 128, so two correct fp32 computations differ by
# about twice that; 2^-16 (1.5e-5) and 1e-5 leave some 10x room. Any
# rounding below fp32 lands an order of magnitude above: TF32 operands
# move the outputs by ~3e-4 to 2e-3, and so does TF32 on the tensor cores
# in one pass (hi·hi, ~4e-4 to 8e-4) or two (lo·hi dropped, ~3e-4 to
# 4e-4); p rounded to bf16 by ~2e-3, the whole bf16 path by ~4e-3, all of
# which the bf16 limits would pass (tests/test_torch_attention.py plants
# each). Three passes (lo·hi + hi·lo + hi·hi, the fp32 kernel's design)
# land near 1e-6, as a correct fp32 computation does.
TOLERANCES = {torch.bfloat16: (2.0 ** -6, 2e-3),
              torch.float32: (2.0 ** -16, 1e-5)}


def reset_launch_counts() -> None:
    global FWD_LAUNCHES, BWD_LAUNCHES
    FWD_LAUNCHES = 0
    BWD_LAUNCHES = 0
    for counts in (FWD_BY_DTYPE, BWD_BY_DTYPE):
        counts.update(dict.fromkeys(counts, 0))


def plain_mismatch(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Error of a kernel output against the plain version's: max abs,
    that over max |want|, relative L2, and whether both are within the
    limits of ``want``'s dtype (``TOLERANCES``)."""
    max_tol, l2_tol = TOLERANCES[want.dtype]
    a, b = got.detach().float(), want.detach().float()
    diff = (a - b).abs()
    max_abs, max_ref = float(diff.max()), float(b.abs().max())
    rel_l2 = float(torch.linalg.vector_norm(diff) /
                   torch.linalg.vector_norm(b).clamp_min(1e-30))
    max_rel = max_abs / max(max_ref, 1e-30)
    return {"max_abs": max_abs, "max_rel": max_rel, "rel_l2": rel_l2,
            "ok": max_rel <= max_tol and rel_l2 <= l2_tol}


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def attention_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """What ``_fwd_kernel`` (gslora_tpu/ops/attention.py:71-96) computes,
    over (BH, n, d) slices: fp32 scores, fp32 softmax, p rounded to the
    input dtype before ``p v``, fp32 accumulation, output in the input
    dtype. These are the casts of ``jax.nn.dot_product_attention`` (the
    JAX model's ``attn_impl="dpa"``); its einsum path (models/vit.py:
    295-297) differs only in rounding the scores to the compute dtype."""
    dots = torch.einsum("xid,xjd->xij", q.float(), k.float()) * scale
    p = torch.softmax(dots, dim=-1)
    o = torch.einsum("xij,xjd->xid", p.to(q.dtype).float(), v.float())
    return o.to(q.dtype)


def attention_bwd_stats_plain(q, k, v, g, scale: float
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The row statistics of the kernel's backward, fp32 (BH, n) each:
    m = max of the scaled scores, l = sum of exp(scores - m) and
    D = rowsum(dp ⊙ p) with fp32 p and dp."""
    qf, kf, vf = q.float(), k.float(), v.float()
    g = g.to(q.dtype).float()
    dots = torch.einsum("xid,xjd->xij", qf, kf) * scale
    m = dots.amax(dim=-1)
    e = torch.exp(dots - m[..., None])
    l_ = e.sum(dim=-1)
    p = e / l_[..., None]
    dp = torch.einsum("xid,xjd->xij", g, vf)
    return m, l_, torch.sum(dp * p, dim=-1)


def attention_bwd_from_stats_plain(q, k, v, g, scale: float, m, l_, dsum
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """The backward as the kernel splits it: p = exp(scores - m) / l and
    ddots = p ⊙ (dp - D) from the row statistics, then dq, dk, dv as in
    :func:`attention_bwd_plain`."""
    qf, kf, vf = q.float(), k.float(), v.float()
    g = g.to(q.dtype).float()
    dots = torch.einsum("xid,xjd->xij", qf, kf) * scale
    p = torch.exp(dots - m[..., None]) / l_[..., None]
    dv = torch.einsum("xij,xid->xjd", p.to(q.dtype).float(), g)
    dp = torch.einsum("xid,xjd->xij", g, vf)
    dd = (p * (dp - dsum[..., None])).to(q.dtype).float()
    dq = torch.einsum("xij,xjd->xid", dd, kf) * scale
    dk = torch.einsum("xij,xid->xjd", dd, qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def attention_bwd_plain(q, k, v, g, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What ``_bwd_kernel`` (gslora_tpu/ops/attention.py:99-125) computes:
    the recompute backward of :func:`attention_fwd_plain`."""
    qf, kf, vf = q.float(), k.float(), v.float()
    g = g.to(q.dtype).float()
    p = torch.softmax(torch.einsum("xid,xjd->xij", qf, kf) * scale, dim=-1)
    dv = torch.einsum("xij,xid->xjd", p.to(q.dtype).float(), g)
    dp = torch.einsum("xid,xjd->xij", g, vf)
    ddots = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    dd = ddots.to(q.dtype).float()
    dq = torch.einsum("xij,xjd->xid", dd, kf) * scale
    dk = torch.einsum("xij,xid->xjd", dd, qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


def _lib(dtype: torch.dtype):
    """The kernel library of ``dtype``, built from its source at first
    use."""
    if dtype not in _LIBS:
        from gslora_tpu_torch.ops.cuda_build import load
        lib = load(SOURCES[dtype])
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gslora_attn_fwd.argtypes = [vp, vp, vp, vp, ci, ci, ci, cf, vp]
        lib.gslora_attn_bwd_rows.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci,
                                             ci, cf, vp]
        lib.gslora_attn_bwd_keys.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci,
                                             ci, ci, cf, vp]
        lib.gslora_attn_kernel_info.argtypes = [ci, ci, ci,
                                                ctypes.POINTER(ci)]
        for fn in (lib.gslora_attn_fwd, lib.gslora_attn_bwd_rows,
                   lib.gslora_attn_bwd_keys, lib.gslora_attn_kernel_info,
                   lib.gslora_attn_max_n, lib.gslora_attn_stats):
            fn.restype = ci
        if (lib.gslora_attn_max_n(), lib.gslora_attn_stats()) != \
                (KERNEL_MAX_N, len(STATS)):
            raise RuntimeError(f"csrc/{SOURCES[dtype]}.cu and "
                               f"ops/attention.py disagree on the longest "
                               f"sequence or the row statistics")
        _LIBS[dtype] = lib
    return _LIBS[dtype]


def _check_kernel_args(*ts: torch.Tensor) -> None:
    q = ts[0]
    if q.dim() != 3:
        raise ValueError(f"attention kernel takes (BH, n, d) slices, got "
                         f"shape {tuple(q.shape)}")
    for t in ts:
        if not t.is_cuda or t.device != q.device:
            raise ValueError("attention kernel: every tensor must be on the "
                             "same CUDA device")
        if t.dtype not in KERNEL_DTYPES or t.dtype != q.dtype:
            raise ValueError(f"attention kernel takes bfloat16 or float32, "
                             f"every tensor in one dtype; got {t.dtype} "
                             f"beside {q.dtype}")
        if t.shape != q.shape:
            raise ValueError(f"attention kernel: shape mismatch "
                             f"{tuple(t.shape)} vs {tuple(q.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("attention kernel needs contiguous tensors "
                             "aligned to 16 bytes")
    bh, n, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"attention kernel is built for head dims "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    if not 1 <= n <= KERNEL_MAX_N or bh < 1:
        raise ValueError(f"attention kernel takes 1 <= n <= {KERNEL_MAX_N} "
                         f"tokens (a query tile's score row stays on chip) "
                         f"and at least one slice, got bh={bh}, n={n}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"attention {what} kernel launch failed: CUDA "
                           f"error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def attention_fwd_kernel(q, k, v, scale: float) -> torch.Tensor:
    """Launch the forward kernel of the inputs' dtype on the current
    stream."""
    global FWD_LAUNCHES
    _check_kernel_args(q, k, v)
    bh, n, d = q.shape
    o = torch.empty_like(q)
    _raise_on(_lib(q.dtype).gslora_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, n, d,
        float(scale), _stream(q)), "forward")
    FWD_LAUNCHES += 1
    FWD_BY_DTYPE[q.dtype] += 1
    return o


def attention_bwd_rows_kernel(q, k, v, g, scale: float):
    """The backward's first launch alone: dq and the row statistics, a
    (4, BH, n) fp32 tensor with the planes of ``STATS``. Not counted in
    ``BWD_LAUNCHES`` (a backward counts once, in
    :func:`attention_bwd_kernel`); the card tests and ``chip_smoke.py``
    call it to check and time the two launches apart."""
    _check_kernel_args(q, k, v, g)
    bh, n, d = q.shape
    dq = torch.empty_like(q)
    stats = torch.empty(len(STATS), bh, n, dtype=torch.float32,
                        device=q.device)
    _raise_on(_lib(q.dtype).gslora_attn_bwd_rows(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        dq.data_ptr(), stats.data_ptr(), bh, n, d, float(scale),
        _stream(q)), "backward rows")
    return dq, stats


def attention_bwd_keys_kernel(q, k, v, g, stats, scale: float):
    """The backward's second launch alone: dk and dv from the statistics
    of :func:`attention_bwd_rows_kernel`. Not counted, as that one."""
    _check_kernel_args(q, k, v, g)
    bh, n, d = q.shape
    if (stats.shape != (len(STATS), bh, n) or stats.dtype != torch.float32
            or stats.device != q.device or not stats.is_contiguous()):
        raise ValueError(f"attention backward: statistics must be a "
                         f"contiguous ({len(STATS)}, {bh}, {n}) float32 "
                         f"tensor on {q.device}")
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    _raise_on(_lib(q.dtype).gslora_attn_bwd_keys(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        stats.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, n, d,
        float(scale), _stream(q)), "backward keys")
    return dk, dv


def attention_bwd_kernel(q, k, v, g, scale: float):
    """Launch the recompute backward (rows, then keys) of the inputs' dtype
    on the current stream; one count in ``BWD_LAUNCHES``."""
    global BWD_LAUNCHES
    dq, stats = attention_bwd_rows_kernel(q, k, v, g, scale)
    dk, dv = attention_bwd_keys_kernel(q, k, v, g, stats, scale)
    BWD_LAUNCHES += 1
    BWD_BY_DTYPE[q.dtype] += 1
    return dq, dk, dv


KERNEL_NAMES = ("forward", "backward rows", "backward keys")


def kernel_info(n: int, d: int, dtype: torch.dtype = torch.bfloat16) -> dict:
    """For each of the three kernels of ``dtype`` at (n, d): blocks
    resident per SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    registers and spill (local) bytes per thread, shared memory per
    block."""
    lib, out = _lib(dtype), (ctypes.c_int * 4)()
    info = {}
    for which, name in enumerate(KERNEL_NAMES):
        _raise_on(lib.gslora_attn_kernel_info(which, n, d, out), name)
        info[name] = dict(zip(("blocks_per_sm", "registers", "spill_bytes",
                               "smem_bytes"), list(out)))
    return info


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class FusedAttention(torch.autograd.Function):
    """softmax(q kᵀ · scale) v over (BH, n, d) slices with the recompute
    backward; saves only q, k, v. ``plain=True`` runs the plain version
    on any device (the model's ``attn_impl="dpa"``); otherwise a CUDA
    input goes to the kernels and a CPU input to the plain version."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, plain: bool):
        ctx.save_for_backward(q, k, v)
        ctx.scale, ctx.plain = scale, plain
        if plain or not q.is_cuda:
            return attention_fwd_plain(q, k, v, scale)
        return attention_fwd_kernel(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        g = g.to(q.dtype).contiguous()
        if ctx.plain or not q.is_cuda:
            grads = attention_bwd_plain(q, k, v, g, ctx.scale)
        else:
            grads = attention_bwd_kernel(q, k, v, g, ctx.scale)
        return (*grads, None, None)


def fused_attention(q, k, v, scale: float) -> torch.Tensor:
    """(BH, n, d) attention: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    return FusedAttention.apply(q, k, v, float(scale), False)


def fused_attention_bhnd(q, k, v, scale: float,
                         plain: bool = False) -> torch.Tensor:
    """(b, h, n, d) front end of :func:`fused_attention`: flattens (b, h)
    into contiguous slices."""
    b, h, n, d = q.shape

    def flat(t):
        return t.reshape(b * h, n, d).contiguous()

    o = FusedAttention.apply(flat(q), flat(k), flat(v), float(scale), plain)
    return o.reshape(b, h, n, d)
