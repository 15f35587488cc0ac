"""Per-layer group-Lasso over the stacked FFN LoRA factors: the hand-written
Hopper kernels K2 (group prox) and K3 (group norms and rescale), their plain
PyTorch versions, and the autograd function of the fused group-Lasso.

Port of ``gslora_tpu/ops/group_lasso.py``. The tensors are the layer-major
FFN LoRA factors A1 (L, r, d), B1 (L, m, r), A2 (L, r, m), B2 (L, d, r);
group l is layer l of all four. With n_l the fp32 norm of group l:

  K2  group_prox:  theta_l <- theta_l * T(max(0, 1 - thr / max(n_l, 1e-12)))
                   (T the parameters' dtype)
  K3  group_norms: n_l (no eps);
      group_scale: theta_l * scales[l], scales in the parameter dtype

``group_lasso_fused`` is sum_l n_l with the gradient theta_l * g /
max(n_l, 1e-12): K3's clamp rule, which differs from ``lora.core.
group_lasso`` (eps inside the sqrt). As in the JAX package it is on no
training path; the forget step's ``structure_mode="prox"`` runs K2.

On the card all three run in ``csrc/group_lasso.cu`` (CUDA C++ for sm_90a,
bound with ctypes; the source notes its design and bound): each layer is
spread over C blocks, one thread-block cluster per layer for the prox and
the norms, by the launch plan that ``group_plan`` computes. The plain
versions compute the same functions with the same rounding points; they
run for tensors on the CPU and are what the kernels are held against on
the card. A CUDA tensor goes to the kernel, or the wrapper raises.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# Launch counts of the three kernels (plain versions are not counted).
PROX_LAUNCHES = 0
NORMS_LAUNCHES = 0
SCALE_LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ESIZE = {torch.float32: 4, torch.bfloat16: 2}
_LIB = None

# Launch plan defaults: blocks per layer of the prox and the norms (one
# cluster per layer; 8 is the portable cluster size, 16 needs the card's
# leave), blocks per layer of the rescale (no cluster), and the shared
# memory a prox block may hold its share in. The kernels refuse more than
# SMEM_LIMIT bytes and more than MAX_CLUSTER / MAX_BLOCKS blocks.
CLUSTER = 8
SCALE_BLOCKS = 16
MAX_SHARE_BYTES = 200 * 1024
SMEM_LIMIT = 220 * 1024
MAX_CLUSTER = 16
MAX_BLOCKS = 1024

# How far a kernel output may sit from the plain version's. The two differ
# only in the order of the fp32 sum of squares: norms within 1e-5 of their
# own value, fp32 outputs within 1e-5 of the output's largest element, bf16
# outputs within one bf16 ulp of each element (the bf16 scale almost never
# moves; the product is rounded once).
NORM_RTOL = 1e-5
FP32_TOL = 1e-5

Four = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def reset_launch_counts() -> None:
    global PROX_LAUNCHES, NORMS_LAUNCHES, SCALE_LAUNCHES
    PROX_LAUNCHES = NORMS_LAUNCHES = SCALE_LAUNCHES = 0


def fp32_threshold(lr: float, alpha: float) -> float:
    """The prox threshold lr·alpha as the product of two fp32 scalars, as
    the JAX step multiplies its traced fp32 ``lr`` and ``alpha``: a double
    product can land one fp32 ulp away, right at a group's kill boundary."""
    return float(np.float32(lr) * np.float32(alpha))


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x| (fp32 tensor): 2**(e - 8) for x = m·2**e with
    m in [0.5, 1); the smallest normal bf16's ulp at 0."""
    _, e = torch.frexp(x.abs())
    ulp = torch.ldexp(torch.ones_like(x), e - 8)
    return torch.where(x == 0, torch.full_like(x, 2.0 ** -133), ulp)


def group_mismatch(got: torch.Tensor, want: torch.Tensor,
                   norms: bool = False) -> Dict:
    """Error of a kernel output against the plain version's: max abs, and
    whether it is within the tolerance for its kind (``norms=True``: the
    (L,) norms; else a parameter-shaped output in its dtype)."""
    a, b = got.detach().float(), want.detach().float()
    diff = (a - b).abs()
    max_abs = float(diff.max()) if diff.numel() else 0.0
    if norms:
        ok = bool((diff <= NORM_RTOL * b.abs()).all())
    elif want.dtype == torch.bfloat16:
        ok = bool((diff <= _bf16_ulp(torch.maximum(a.abs(), b.abs()))).all())
    else:
        max_ref = float(b.abs().max()) if b.numel() else 0.0
        ok = max_abs <= FP32_TOL * max_ref
    return {"max_abs": max_abs, "ok": ok}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _layer_sqsum(t: torch.Tensor) -> torch.Tensor:
    """(L,) fp32 sum of squares of each layer of a stacked tensor."""
    return torch.sum(t.float().reshape(t.shape[0], -1) ** 2, dim=-1)


def _layer_mul(t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """theta_l * s[l] in t's dtype (s already in that dtype)."""
    return t * s.reshape(-1, *([1] * (t.dim() - 1)))


def group_norms_plain(A1, B1, A2, B2) -> torch.Tensor:
    """What ``_sqsum_kernel`` (gslora_tpu/ops/group_lasso.py:47-52)
    computes: the four fp32 sums of squares taken separately, added in
    order, then the square root (no eps)."""
    s = _layer_sqsum(A1) + _layer_sqsum(B1) + _layer_sqsum(A2) + \
        _layer_sqsum(B2)
    return torch.sqrt(s)


def group_scale_plain(A1, B1, A2, B2, scales: torch.Tensor) -> Four:
    """What ``_scale_kernel`` (group_lasso.py:69-74) computes: each layer
    times its scale, the scale given in the parameters' dtype (the JAX
    wrapper casts before the call, :90)."""
    return tuple(_layer_mul(t, scales) for t in (A1, B1, A2, B2))


def group_prox_plain(A1, B1, A2, B2, threshold: float) -> Four:
    """What ``_prox_kernel`` (group_lasso.py:125-136) computes: fp32 norm,
    scale max(0, 1 - thr / max(n, 1e-12)) in fp32, rounded to the
    parameters' dtype before the multiply (:132)."""
    norm = group_norms_plain(A1, B1, A2, B2)
    # a tensor, not a Python scalar: ``scalar / tensor`` is a reciprocal
    # and a multiply in torch, not the correctly rounded fp32 division
    thr = torch.full_like(norm, float(np.float32(threshold)))
    scale = torch.clamp_min(1.0 - thr / torch.clamp_min(norm, 1e-12), 0.0)
    return group_scale_plain(A1, B1, A2, B2, scale.to(A1.dtype))


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GroupPlan:
    """How the kernels spread one layer over ``blocks`` blocks. Each span
    (A1_l, B1_l, A2_l, B2_l) is a scalar head up to its first 16-byte
    address, a body of 16-byte vectors and a scalar tail; rank k owns body
    vectors [k·vecs[t], (k+1)·vecs[t]) of span t, rank ``edge_owner`` every
    head and tail. ``onchip``: the prox and the norms bring the share
    (``smem_bytes``) into shared memory with one bulk copy, and the prox
    reads device memory once; else they stream it (the prox twice)."""
    blocks: int
    vecs: Tuple[int, int, int, int]
    edge_owner: int
    smem_bytes: int
    onchip: bool


@functools.lru_cache(maxsize=256)
def group_plan(L: int, n1: int, n2: int, n3: int, n4: int,
               dtype: torch.dtype, cluster: Optional[int] = None,
               max_share_bytes: Optional[int] = None) -> GroupPlan:
    """The launch plan for L layers whose spans hold n1..n4 elements of
    ``dtype``: ``cluster`` blocks per layer (default ``CLUSTER``), each
    rank's share of a span's body rounded up to whole vectors so that it
    covers the body at any base alignment, on chip where the share's bytes
    fit ``max_share_bytes`` (default ``MAX_SHARE_BYTES``)."""
    esize = _ESIZE[dtype]
    blocks = CLUSTER if cluster is None else int(cluster)
    budget = MAX_SHARE_BYTES if max_share_bytes is None \
        else int(max_share_bytes)
    if L < 1 or min(n1, n2, n3, n4) < 1:
        raise ValueError(f"group plan: L {L} and spans {(n1, n2, n3, n4)} "
                         f"must be at least 1")
    if not 1 <= blocks <= MAX_BLOCKS:
        raise ValueError(f"group plan: {blocks} blocks per layer, not in "
                         f"[1, {MAX_BLOCKS}]")
    if not 0 <= budget <= SMEM_LIMIT:
        raise ValueError(f"group plan: max_share_bytes {budget} not in "
                         f"[0, {SMEM_LIMIT}]")
    V = 16 // esize
    vecs = tuple(-(-(n // V) // blocks) for n in (n1, n2, n3, n4))
    share = 16 * sum(vecs)
    onchip = share <= budget
    return GroupPlan(blocks, vecs, blocks - 1, share if onchip else 0, onchip)


def share_edges(plan: GroupPlan, t: int, n: int, esize: int, mis: int,
                rank: int) -> Tuple[int, int, int, int]:
    """Element edges of span t (n elements, its first at byte offset
    ``mis`` mod 16) as block ``rank`` sees them: (head, lo, hi, tail0) —
    the head is [0, head), this rank's body share [lo, hi), the tail
    [tail0, n). The kernels compute the same (csrc/group_lasso.cu,
    ``share_of``)."""
    V = 16 // esize
    m = mis % 16
    head = min(0 if m == 0 else (16 - m) // esize, n)
    nv = (n - head) // V
    v0 = min(rank * plan.vecs[t], nv)
    v1 = min(v0 + plan.vecs[t], nv)
    return head, head + v0 * V, head + v1 * V, head + nv * V


class _Plan(ctypes.Structure):
    """csrc/group_lasso.cu's ``struct Plan``."""
    _fields_ = [("blocks", ctypes.c_int), ("edge_owner", ctypes.c_int),
                ("onchip", ctypes.c_int), ("smem_bytes", ctypes.c_int),
                ("vecs", ctypes.c_longlong * 4)]


@functools.lru_cache(maxsize=256)
def _plan_struct(plan: GroupPlan) -> _Plan:
    return _Plan(plan.blocks, plan.edge_owner, int(plan.onchip),
                 plan.smem_bytes, (ctypes.c_longlong * 4)(*plan.vecs))


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


def _lib():
    """The kernel library, built from csrc/group_lasso.cu at first use."""
    global _LIB
    if _LIB is None:
        from gslora_tpu_torch.ops.cuda_build import load
        lib = load("group_lasso")
        vp, ci, cll, cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_float)
        pp = ctypes.POINTER(_Plan)
        lib.gslora_group_prox.argtypes = [ci] + [vp] * 8 + [ci] + [cll] * 4 \
            + [cf, pp, vp]
        lib.gslora_group_norms.argtypes = [ci] + [vp] * 5 + [ci] + [cll] * 4 \
            + [pp, vp]
        lib.gslora_group_scale.argtypes = [ci] + [vp] * 9 + [ci] + [cll] * 4 \
            + [pp, vp]
        lib.gslora_group_cluster_info.argtypes = [ci, ci, pp, ci,
                                                  ctypes.POINTER(ci)]
        lib.gslora_group_empty.argtypes = [ci, ci, ci, vp]
        for fn in (lib.gslora_group_prox, lib.gslora_group_norms,
                   lib.gslora_group_scale, lib.gslora_group_cluster_info,
                   lib.gslora_group_empty):
            fn.restype = ci
        _LIB = lib
    return _LIB


def _check_kernel_args(A1, B1, A2, B2) -> Tuple[int, int, Tuple[int, ...]]:
    """(dtype code, L, per-layer sizes) of four tensors the kernels take;
    raises on anything else."""
    ts = (A1, B1, A2, B2)
    dev = A1.device
    for t in ts:
        if not t.is_cuda or t.device != dev:
            raise ValueError("group-Lasso kernel: every tensor must be on the "
                             "same CUDA device")
        if t.dtype != A1.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"group-Lasso kernel takes float32 or bfloat16, "
                             f"all four alike; got "
                             f"{[str(x.dtype) for x in ts]}")
        if not t.is_contiguous():
            raise ValueError("group-Lasso kernel needs contiguous tensors")
        if t.dim() != 3 or t.shape[0] != A1.shape[0]:
            raise ValueError(f"group-Lasso kernel takes four (L, ., .) "
                             f"tensors, got {[tuple(x.shape) for x in ts]}")
    r, d = A1.shape[1:]
    m = B1.shape[1]
    want = ((r, d), (m, r), (r, m), (d, r))
    if tuple(tuple(t.shape[1:]) for t in ts) != want:
        raise ValueError(f"group-Lasso kernel: shapes "
                         f"{[tuple(x.shape) for x in ts]} are not A1 (L,r,d), "
                         f"B1 (L,m,r), A2 (L,r,m), B2 (L,d,r)")
    if A1.shape[0] < 1:
        raise ValueError("group-Lasso kernel needs at least one layer")
    return _DTYPES[A1.dtype], A1.shape[0], tuple(t[0].numel() for t in ts)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"group {what} kernel launch failed: CUDA error "
                           f"{err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def group_prox_kernel(A1, B1, A2, B2, threshold: float,
                      inplace: bool = False,
                      plan: Optional[GroupPlan] = None) -> Four:
    """Launch K2 on the current stream; ``inplace`` writes the result into
    the four inputs and returns them. ``plan`` defaults to
    ``group_plan``'s."""
    global PROX_LAUNCHES
    code, L, n = _check_kernel_args(A1, B1, A2, B2)
    plan = plan or group_plan(L, *n, A1.dtype)
    ins = (A1, B1, A2, B2)
    outs = ins if inplace else tuple(torch.empty_like(t) for t in ins)
    _raise_on(_lib().gslora_group_prox(
        code, *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
        L, *n, float(np.float32(threshold)), _plan_struct(plan),
        _stream(A1)), "prox")
    PROX_LAUNCHES += 1
    return outs


def group_norms_kernel(A1, B1, A2, B2,
                       plan: Optional[GroupPlan] = None) -> torch.Tensor:
    """Launch K3's norms on the current stream: (L,) fp32."""
    global NORMS_LAUNCHES
    code, L, n = _check_kernel_args(A1, B1, A2, B2)
    plan = plan or group_plan(L, *n, A1.dtype)
    norms = torch.empty(L, dtype=torch.float32, device=A1.device)
    _raise_on(_lib().gslora_group_norms(
        code, *(t.data_ptr() for t in (A1, B1, A2, B2)), norms.data_ptr(),
        L, *n, _plan_struct(plan), _stream(A1)), "norms")
    NORMS_LAUNCHES += 1
    return norms


def group_scale_kernel(A1, B1, A2, B2, scales: torch.Tensor,
                       plan: Optional[GroupPlan] = None) -> Four:
    """Launch K3's rescale on the current stream; ``scales`` is (L,) in
    the parameters' dtype. The default plan spreads a layer over
    ``SCALE_BLOCKS`` blocks (no cluster, no shared memory)."""
    global SCALE_LAUNCHES
    code, L, n = _check_kernel_args(A1, B1, A2, B2)
    plan = plan or group_plan(L, *n, A1.dtype, cluster=SCALE_BLOCKS,
                              max_share_bytes=0)
    if (not scales.is_cuda or scales.device != A1.device or
            scales.dtype != A1.dtype or scales.shape != (L,) or
            not scales.is_contiguous()):
        raise ValueError(f"group scale kernel takes contiguous (L,) scales "
                         f"in {A1.dtype} on {A1.device}, got "
                         f"{tuple(scales.shape)} {scales.dtype} on "
                         f"{scales.device}")
    ins = (A1, B1, A2, B2)
    outs = tuple(torch.empty_like(t) for t in ins)
    _raise_on(_lib().gslora_group_scale(
        code, *(t.data_ptr() for t in ins), scales.data_ptr(),
        *(t.data_ptr() for t in outs), L, *n, _plan_struct(plan),
        _stream(A1)), "scale")
    SCALE_LAUNCHES += 1
    return outs


def cluster_info(plan: GroupPlan, dtype: torch.dtype, L: int,
                 which: str = "prox") -> int:
    """Clusters of the prox or norms kernel under ``plan`` that the card
    can hold at once (``cudaOccupancyMaxActiveClusters``; 0: such a
    cluster does not fit)."""
    active = ctypes.c_int(0)
    _raise_on(_lib().gslora_group_cluster_info(
        _DTYPES[dtype], ("prox", "norms").index(which), _plan_struct(plan),
        L, ctypes.byref(active)), "cluster query")
    return active.value


def launch_floor_kernel(blocks: int, layers: int, cluster: int) -> None:
    """Launch an empty kernel of csrc/group_lasso.cu on grid (blocks,
    layers), as clusters of ``cluster`` blocks when cluster > 0, through
    the same ctypes path as the kernels (the launch floor; not counted)."""
    _raise_on(_lib().gslora_group_empty(
        blocks, layers, cluster,
        torch.cuda.current_stream().cuda_stream), "empty")


# ---------------------------------------------------------------------------
# device dispatch, autograd, tree front end
# ---------------------------------------------------------------------------


def group_norms(A1, B1, A2, B2) -> torch.Tensor:
    """(L,) group norms: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if A1.is_cuda:
        return group_norms_kernel(A1, B1, A2, B2)
    return group_norms_plain(A1, B1, A2, B2)


def group_scale(A1, B1, A2, B2, scales) -> Four:
    if A1.is_cuda:
        return group_scale_kernel(A1, B1, A2, B2, scales)
    return group_scale_plain(A1, B1, A2, B2, scales)


class GroupLassoFn(torch.autograd.Function):
    """sum_l ||theta_l|| over the four stacked tensors, with the gradient
    theta_l · g / max(||theta_l||, 1e-12) (the JAX custom_vjp,
    group_lasso.py:99-117): norms kernel forward, rescale kernel backward;
    the (L,) vector ``g / max(norms, 1e-12)`` is computed in torch, as
    the JAX code computes it outside the kernel."""

    @staticmethod
    def forward(ctx, A1, B1, A2, B2):
        norms = group_norms(A1, B1, A2, B2)
        ctx.save_for_backward(A1, B1, A2, B2, norms)
        return torch.sum(norms)

    @staticmethod
    def backward(ctx, g):
        A1, B1, A2, B2, norms = ctx.saved_tensors
        inv = g.float() / torch.clamp_min(norms, 1e-12)
        return group_scale(A1, B1, A2, B2, inv.to(A1.dtype).contiguous())


def group_lasso_fused(A1, B1, A2, B2) -> torch.Tensor:
    """The fused group-Lasso value (K3), differentiable in all four."""
    return GroupLassoFn.apply(A1, B1, A2, B2)


@torch.no_grad()
def lora_group_prox(lora_tree: Dict, threshold: float) -> Dict:
    """Apply K2 to the FFN factors of a LoRA tree in place (the port's
    optimizer updates its parameters in place) and return the tree; a
    no-op for an empty tree or one without ``ffn`` (group_lasso.py:159-166).
    CUDA tensors go to the kernel, CPU tensors to the plain version."""
    if not lora_tree or "ffn" not in lora_tree:
        return lora_tree
    f = lora_tree["ffn"]
    ts = tuple(f[k] for k in ("A1", "B1", "A2", "B2"))
    if ts[0].is_cuda:
        group_prox_kernel(*ts, threshold, inplace=True)
    else:
        for t, new in zip(ts, group_prox_plain(*ts, threshold)):
            t.copy_(new)
    return lora_tree
