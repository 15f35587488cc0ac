"""Times the group-Lasso kernels K2 (prox) and K3 (norms, rescale) on the
card, fp32 and L2-warm, at the flagship FFN LoRA (6, 8, 512, 2048) and at
ViT-B/16's rank-8 FFN LoRA (12, 8, 768, 3072), beside their byte bounds
and the launch floor (an empty kernel of csrc/group_lasso.cu through the
same ctypes path, alone and as a cluster launch).

    python3 -m gslora_tpu_torch.tools.group_bench [--baseline OLD.cu]

``--baseline`` binds an earlier ``group_lasso.cu`` with the same C
interface minus the launch plan (``gslora_group_prox(dtype, a1, b1, a2,
b2, o1, o2, o3, o4, L, n1, n2, n3, n4, thr, stream)`` and its two
siblings), builds it beside the package's own and times both in one
process, in the order old, new, new, old, after holding the old one's
outputs against the plain versions. Prints one JSON line; needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from typing import Dict, List, Optional

import torch

from gslora_tpu_torch.ops import cuda_build
from gslora_tpu_torch.ops import group_lasso as G
from gslora_tpu_torch.utils.timing import cuda_ms

SHAPES = {"flagship": (6, 8, 512, 2048), "vit_b16_r8": (12, 8, 768, 3072)}
# Published device-memory rate and fp32 rate outside the tensor cores
# (NVIDIA data sheets), keyed by a substring of the card's name.
RATES = [("H200", 4.8e12, 67e12), ("H100 PCIe", 2.0e12, 51e12),
         ("H100 NVL", 3.9e12, 60e12), ("H100", 3.35e12, 67e12)]


def card_rates(name: str):
    """(bytes/s, fp32 FLOP/s) of the card named ``name``."""
    for key, bw, fp32 in RATES:
        if key in name:
            return bw, fp32
    raise RuntimeError(f"no published rates for card {name!r}")


def lora_factors(shape, dtype, seed, device="cuda"):
    """The four FFN LoRA factors (L, r, d, m) on ``device``, layer l scaled
    by (l + 1) and layer 0 all zero (for L > 1), and a threshold between
    the two smallest live layer norms: that layer dies, the larger ones
    shrink."""
    L, r, d, m = shape
    g = torch.Generator().manual_seed(seed)
    ts = []
    for shp in ((L, r, d), (L, m, r), (L, r, m), (L, d, r)):
        t = 0.3 * torch.randn(shp, generator=g) * \
            torch.arange(1, L + 1).reshape(-1, 1, 1)
        if L > 1:
            t[0] = 0.0
        ts.append(t.to(device, dtype))
    live = sorted(x for x in G.group_norms_plain(*ts).tolist() if x > 0)
    thr = 0.5 * live[0] if len(live) == 1 else 0.5 * (live[0] + live[1])
    return ts, thr


def group_bounds(shape, esize: int, bw: float, fp32_peak: float) -> Dict:
    """Least time (ms) and what bounds it, per kernel: bytes (each input
    read once, each output written once) against fp32 operations
    (square-and-add per element, plus the multiply that scales)."""
    L, r, d, m = shape
    numel = 2 * L * r * (d + m)
    nbytes = numel * esize
    work = {"group_prox": (2 * nbytes, 3 * numel),
            "group_norms": (nbytes + 4 * L, 2 * numel),
            "group_scale": (2 * nbytes + esize * L, numel)}
    out = {}
    for name, (nb, ops) in work.items():
        t_bytes, t_ops = nb / bw * 1e3, ops / fp32_peak * 1e3
        out[name] = (max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def kernel_calls(ts, thr, plans: Optional[Dict] = None) -> Dict:
    """The package's three kernel wrappers on ``ts`` as callables, with
    the plans given (default plans where ``plans`` is None)."""
    inv = (1.0 / torch.clamp_min(G.group_norms_plain(*ts), 1e-12)
           ).to(ts[0].dtype)
    kw = plans or {}
    return {
        "group_prox": lambda: G.group_prox_kernel(
            *ts, thr, **({"plan": kw["prox"]} if "prox" in kw else {})),
        "group_norms": lambda: G.group_norms_kernel(
            *ts, **({"plan": kw["norms"]} if "norms" in kw else {})),
        "group_scale": lambda: G.group_scale_kernel(
            *ts, inv, **({"plan": kw["scale"]} if "scale" in kw else {})),
    }


def launch_floor(layers: int = SHAPES["flagship"][0]) -> Dict:
    """Device ms of one back-to-back launch of an empty kernel: one block;
    the prox's and norms' grid of one ``CLUSTER``-block cluster per layer;
    the rescale's grid of ``SCALE_BLOCKS`` blocks per layer."""
    return {"one_block_ms": cuda_ms(lambda: G.launch_floor_kernel(1, 1, 0)),
            "cluster_grid_ms": cuda_ms(lambda: G.launch_floor_kernel(
                G.CLUSTER, layers, G.CLUSTER)),
            "scale_grid_ms": cuda_ms(lambda: G.launch_floor_kernel(
                G.SCALE_BLOCKS, layers, 0))}


def cluster_report(shape, dtype=torch.float32) -> Dict:
    """The default plan of K2 at ``shape`` and the clusters of each size
    that can be resident at once (``cudaOccupancyMaxActiveClusters``)."""
    L, r, d, m = shape
    n = (r * d, m * r, r * m, d * r)
    plan = G.group_plan(L, *n, dtype)
    active = {}
    for c in (8, 16):
        p = G.group_plan(L, *n, dtype, cluster=c)
        active[str(c)] = G.cluster_info(p, dtype, L)
    return {"cluster": plan.blocks, "onchip": plan.onchip,
            "share_bytes": 16 * sum(plan.vecs),
            "max_active_clusters": active}


class Baseline:
    """An earlier group_lasso.cu (no launch plan in its C interface)."""

    def __init__(self, path: str):
        lib = cuda_build.load("group_lasso_baseline", path)
        vp, ci, cll, cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_float)
        lib.gslora_group_prox.argtypes = [ci] + [vp] * 8 + [ci] + \
            [cll] * 4 + [cf, vp]
        lib.gslora_group_norms.argtypes = [ci] + [vp] * 5 + [ci] + \
            [cll] * 4 + [vp]
        lib.gslora_group_scale.argtypes = [ci] + [vp] * 9 + [ci] + \
            [cll] * 4 + [vp]
        self.lib = lib

    def calls(self, ts, thr) -> Dict:
        code, L, n = G._check_kernel_args(*ts)
        outs = [torch.empty_like(t) for t in ts]
        norms = torch.empty(L, dtype=torch.float32, device=ts[0].device)
        inv = (1.0 / torch.clamp_min(G.group_norms_plain(*ts), 1e-12)
               ).to(ts[0].dtype)
        p = [t.data_ptr() for t in ts]
        o = [t.data_ptr() for t in outs]
        s = torch.cuda.current_stream().cuda_stream
        lib = self.lib

        def check(err):
            if err:
                raise RuntimeError(f"baseline kernel: CUDA error {err}")

        return {
            "group_prox": lambda: (check(lib.gslora_group_prox(
                code, *p, *o, L, *n, float(thr), s)), outs)[1],
            "group_norms": lambda: (check(lib.gslora_group_norms(
                code, *p, norms.data_ptr(), L, *n, s)), norms)[1],
            "group_scale": lambda: (check(lib.gslora_group_scale(
                code, *p, inv.data_ptr(), *o, L, *n, s)), outs)[1],
        }

    def check_outputs(self, ts, thr) -> None:
        calls = self.calls(ts, thr)
        inv = (1.0 / torch.clamp_min(G.group_norms_plain(*ts), 1e-12)
               ).to(ts[0].dtype)
        want = {"group_prox": G.group_prox_plain(*ts, thr),
                "group_norms": [G.group_norms_plain(*ts)],
                "group_scale": G.group_scale_plain(*ts, inv)}
        for name, fn in calls.items():
            got = fn()
            got = [got] if torch.is_tensor(got) else [t.clone() for t in got]
            torch.cuda.synchronize()
            for a, b in zip(got, want[name]):
                m = G.group_mismatch(a, b, norms=name == "group_norms")
                if not m["ok"]:
                    raise AssertionError(f"baseline {name}: {m}")


def run(baseline: Optional[str]) -> Dict:
    bw, fp32 = card_rates(torch.cuda.get_device_name(0))
    old = Baseline(baseline) if baseline else None
    planned = hasattr(G, "group_plan")
    report: Dict = {"shapes": {}}
    for label, shape in SHAPES.items():
        ts, thr = lora_factors(shape, torch.float32, seed=9)
        bounds = group_bounds(shape, 4, bw, fp32)
        new = kernel_calls(ts, thr)
        row: Dict = {"shape": list(shape), "dtype": "float32"}
        if old is not None:
            old.check_outputs(ts, thr)
            prev = old.calls(ts, thr)
        with torch.no_grad():
            for name in new:
                times: Dict[str, List[float]] = {"old": [], "new": []}
                order = ("old", "new", "new", "old") if old else ("new",)
                for which in order:
                    fn = prev[name] if which == "old" else new[name]
                    times[which].append(cuda_ms(fn))
                entry = {"ms": sum(times["new"]) / len(times["new"]),
                         "ms_each": times["new"],
                         "bound_ms": bounds[name][0],
                         "bound_by": bounds[name][1]}
                if old:
                    entry["old_ms"] = sum(times["old"]) / 2
                    entry["old_ms_each"] = times["old"]
                row[name] = entry
            if planned:
                L, r, d, m = shape
                n = (r * d, m * r, r * m, d * r)
                variants = {}
                for c in (8, 16):
                    p = G.group_plan(L, *n, torch.float32, cluster=c)
                    if G.cluster_info(p, torch.float32, L) > 0:
                        calls = kernel_calls(ts, thr, {"prox": p, "norms": p})
                        variants[f"prox_c{c}"] = cuda_ms(calls["group_prox"])
                        variants[f"norms_c{c}"] = cuda_ms(calls["group_norms"])
                for c in (8, 16, 32):
                    p = G.group_plan(L, *n, torch.float32, cluster=c,
                                     max_share_bytes=0)
                    variants[f"scale_b{c}"] = cuda_ms(
                        kernel_calls(ts, thr, {"scale": p})["group_scale"])
                streamed = G.group_plan(L, *n, torch.float32,
                                        max_share_bytes=0)
                variants["prox_streamed"] = cuda_ms(kernel_calls(
                    ts, thr, {"prox": streamed})["group_prox"])
                row["variants_ms"] = variants
                row["plan"] = cluster_report(shape)
        report["shapes"][label] = row
    if hasattr(G, "launch_floor_kernel"):
        report["launch_floor"] = launch_floor()
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="an earlier group_lasso.cu to time "
                    "beside the package's kernels")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("group_bench: no CUDA GPU visible")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    report = run(args.baseline)
    report["card"] = smi.splitlines()[0]
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
