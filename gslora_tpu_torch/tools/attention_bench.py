"""Times kernel K1 (forward, and the backward's two launches) on the card
beside an earlier build of its source, at the flagship shape (384, 197,
64) and at the fp32 paths' shapes (192, 960 and 4000 slices of 197
tokens), L2-warm, with each direction's bounds and SDPA as the library
yardstick.

    python3 -m gslora_tpu_torch.tools.attention_bench [--baseline OLD.cu]
        [--dtype float32|bfloat16]

``--baseline`` binds an earlier ``csrc/attention_fp32.cu`` (or, with
``--dtype bfloat16``, ``csrc/attention.cu``) with the same C interface,
e.g. ``git show <commit>:gslora_tpu_torch/csrc/attention_fp32.cu >
.parent/attention_fp32.cu``, builds it beside the package's own, holds its
outputs against the plain version at every shape, then times old, new,
new, old in one process. Prints one JSON line; needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from typing import Dict, Optional

import torch

from gslora_tpu_torch.ops import attention as A
from gslora_tpu_torch.ops import cuda_build
from gslora_tpu_torch.utils.timing import cuda_ms

SCALE = 512 ** -0.5  # the flagship's attention scale
N_TOKENS, HEAD_DIM = 197, 64
# slices (batch x heads) of the flagship and of the fp32 paths' batches
SLICES = (384, 192, 960, 4000)
# Published dense rates (NVIDIA data sheets), keyed by a substring of the
# card's name: device-memory bytes/s, bf16 and TF32 tensor-core FLOP/s,
# fp32 FLOP/s outside the tensor cores.
RATES = [("H200", 4.8e12, 989e12, 495e12, 67e12),
         ("H100 PCIe", 2.0e12, 756e12, 378e12, 51e12),
         ("H100 NVL", 3.9e12, 835e12, 418e12, 60e12),
         ("H100", 3.35e12, 989e12, 495e12, 67e12)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Products of fp32 K1 as the tensor cores run them: three TF32 passes.
TF32_PASSES = 3


def card_rates(name: str):
    """(bytes/s, bf16 FLOP/s, TF32 FLOP/s, fp32 FLOP/s) of the card named
    ``name``."""
    for key, *rates in RATES:
        if key in name:
            return tuple(rates)
    raise RuntimeError(f"no published rates for card {name!r}")


def k1_work(bh: int, n: int, d: int, elem: int) -> Dict:
    """Bytes and FLOPs of K1 forward and backward at (bh, n, d): 4 and 7
    (bh, n, d) tensors of ``elem`` bytes, each read or written once, and
    2 and 5 products of 2 bh n^2 d FLOPs."""
    tensor_bytes, matmul = bh * n * d * elem, 2 * bh * n * n * d
    return {"fwd": (4 * tensor_bytes, 2 * matmul),
            "bwd": (7 * tensor_bytes, 5 * matmul)}


def bound(nbytes: float, flops: float, bw: float, peak: float):
    """Least time in ms, the larger of bytes / bw and flops / peak, and
    which of the two it is."""
    t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def fp32_bounds(bh: int, n: int, d: int, bw: float, tf32_peak: float,
                ffma_peak: float) -> Dict:
    """fp32 K1's bounds per direction: ``bound_ms`` / ``bound_by`` at three
    TF32 passes on the tensor cores (3 x FLOPs at ``tf32_peak``), the
    design's, and ``bound_ffma_ms`` at the fp32 rate outside them."""
    out = {}
    for key, (nbytes, flops) in k1_work(bh, n, d, 4).items():
        ms, by = bound(nbytes, TF32_PASSES * flops, bw, tf32_peak)
        out[key] = {"bound_ms": ms, "bound_by": by,
                    "bound_ffma_ms": bound(nbytes, flops, bw, ffma_peak)[0]}
    return out


def bf16_bounds(bh: int, n: int, d: int, bw: float, peak: float) -> Dict:
    """bf16 K1's bounds per direction, at the bf16 tensor-core rate."""
    out = {}
    for key, (nbytes, flops) in k1_work(bh, n, d, 2).items():
        ms, by = bound(nbytes, flops, bw, peak)
        out[key] = {"bound_ms": ms, "bound_by": by}
    return out


class Baseline:
    """An earlier K1 source with the package's C interface."""

    def __init__(self, path: str):
        lib = cuda_build.load("attention_baseline", path)
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gslora_attn_fwd.argtypes = [vp] * 4 + [ci] * 3 + [cf, vp]
        lib.gslora_attn_bwd_rows.argtypes = [vp] * 6 + [ci] * 3 + [cf, vp]
        lib.gslora_attn_bwd_keys.argtypes = [vp] * 7 + [ci] * 3 + [cf, vp]
        for fn in (lib.gslora_attn_fwd, lib.gslora_attn_bwd_rows,
                   lib.gslora_attn_bwd_keys):
            fn.restype = ci
        self.lib = lib

    def calls(self, q, k, v, g, scale: float) -> Dict:
        bh, n, d = q.shape
        o, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
        stats = torch.empty(len(A.STATS), bh, n, dtype=torch.float32,
                            device=q.device)
        p = [t.data_ptr() for t in (q, k, v, g)]
        s = torch.cuda.current_stream().cuda_stream
        lib = self.lib

        def check(err):
            if err:
                raise RuntimeError(f"baseline kernel: CUDA error {err}")

        def rows():
            check(lib.gslora_attn_bwd_rows(*p, dq.data_ptr(),
                                           stats.data_ptr(), bh, n, d,
                                           scale, s))

        def keys():
            check(lib.gslora_attn_bwd_keys(*p, stats.data_ptr(),
                                           dk.data_ptr(), dv.data_ptr(), bh,
                                           n, d, scale, s))

        def fwd():
            check(lib.gslora_attn_fwd(*p[:3], o.data_ptr(), bh, n, d, scale,
                                      s))
            return o

        def bwd():
            rows()
            keys()
            return dq, dk, dv

        return {"fwd": fwd, "bwd": bwd, "rows": rows, "keys": keys}


def new_calls(q, k, v, g, scale: float) -> Dict:
    """The package's K1 wrappers on these inputs as callables."""
    _, stats = A.attention_bwd_rows_kernel(q, k, v, g, scale)
    return {"fwd": lambda: A.attention_fwd_kernel(q, k, v, scale),
            "bwd": lambda: A.attention_bwd_kernel(q, k, v, g, scale),
            "rows": lambda: A.attention_bwd_rows_kernel(q, k, v, g, scale),
            "keys": lambda: A.attention_bwd_keys_kernel(q, k, v, g, stats,
                                                        scale)}


def check_against_plain(calls: Dict, q, k, v, g, scale: float,
                        what: str) -> Dict:
    """Raises unless the forward and backward of ``calls`` are within
    ``plain_mismatch``'s limits; the errors."""
    got = [calls["fwd"]().clone(), *(t.clone() for t in calls["bwd"]())]
    torch.cuda.synchronize()
    want = [A.attention_fwd_plain(q, k, v, scale),
            *A.attention_bwd_plain(q, k, v, g, scale)]
    errs = {}
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        m = A.plain_mismatch(a, b)
        if not m["ok"]:
            raise AssertionError(f"{what} {name}: {m}")
        errs[name] = {"max_rel": m["max_rel"], "rel_l2": m["rel_l2"]}
    return errs


def inputs(bh: int, n: int, d: int, dtype, seed: int):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(bh, n, d, generator=g).to("cuda", dtype)
            for _ in range(4)]


def run(baseline: Optional[str], dtype: torch.dtype) -> Dict:
    bw, bf16_peak, tf32_peak, ffma_peak = card_rates(
        torch.cuda.get_device_name(0))
    old = Baseline(baseline) if baseline else None
    sdpa = torch.nn.functional.scaled_dot_product_attention
    report: Dict = {"dtype": str(dtype).replace("torch.", ""),
                    "baseline": baseline, "shapes": {}}
    for seed, bh in enumerate(SLICES):
        n, d = N_TOKENS, HEAD_DIM
        q, k, v, g = inputs(bh, n, d, dtype, seed)
        bounds = (fp32_bounds(bh, n, d, bw, tf32_peak, ffma_peak)
                  if dtype == torch.float32
                  else bf16_bounds(bh, n, d, bw, bf16_peak))
        new = new_calls(q, k, v, g, SCALE)
        row: Dict = {"errors": check_against_plain(new, q, k, v, g, SCALE,
                                                   "new")}
        if old is not None:
            prev = old.calls(q, k, v, g, SCALE)
            row["old_errors"] = check_against_plain(prev, q, k, v, g, SCALE,
                                                    "baseline")
        # SDPA over (b, h, n, d) = (bh / 8, 8, n, d); its backward alone,
        # over one recorded forward
        q4, k4, v4, g4 = (t.reshape(bh // 8, 8, n, d) for t in (q, k, v, g))
        ql, kl, vl = (t.clone().requires_grad_(True) for t in (q4, k4, v4))
        out_l = sdpa(ql, kl, vl, scale=SCALE)
        library = {"fwd": lambda: sdpa(q4, k4, v4, scale=SCALE),
                   "bwd": lambda: torch.autograd.grad(
                       out_l, (ql, kl, vl), g4, retain_graph=True)}
        for key in ("fwd", "bwd", "rows", "keys"):
            times = {"old": [], "new": []}
            for which in ("old", "new", "new", "old") if old else ("new",):
                times[which].append(
                    cuda_ms((prev if which == "old" else new)[key]))
            entry = {"ms": sum(times["new"]) / len(times["new"]),
                     "ms_each": times["new"]}
            if old:
                entry["old_ms"] = sum(times["old"]) / 2
                entry["old_ms_each"] = times["old"]
            if key in library:
                entry.update(bounds[key])
                entry["share_of_bound"] = entry["bound_ms"] / entry["ms"]
                entry["library_ms"] = cuda_ms(library[key])
            row[key] = entry
        del out_l, ql, kl, vl
        report["shapes"][f"{bh}x{n}x{d}"] = row
    return report


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="an earlier K1 source (.cu) to time "
                    "beside the package's kernel of --dtype")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32",
                    help="the inputs' dtype, and so which kernel is timed")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("attention_bench: no CUDA GPU visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    report = run(args.baseline, DTYPES[args.dtype])
    report["card"] = smi.splitlines()[0]
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
