"""Serving throughput: eval-mode forward images/s on the card (port of
scripts/bench_inference.py).

The reference's only inference probe is test_forward (util/utils.py:144-
164, single-image forwards); deployment serves batches. This times the
eval forward (train=False, dropout off, merged LoRA, logits and
embedding) of random bf16 parameters across batch sizes for either
headline model, one JSON line per point, with the forward FLOP accounting
of BASELINE.md (ViT-P8S8 7.95, ViT-B/16 35.1 GFLOP per image):
``images_per_sec``, ``ms_per_batch``, ``achieved_tflops``, ``mfu`` against
this card's published dense peak (bf16, or int8 with ``--int8``) and the
peak device memory of the forwards.

    python3 -m gslora_tpu_torch.tools.bench_inference [--b16] [--k 50]
        [--batches 64,128] [--int8] [--device cpu]

Timing: ``utils/profiling.forward_throughput`` (one warm forward, then K
chained forwards between CUDA events). On the CPU (``--device cpu``) the
host clock times them, and ``mfu`` and the peak memory are null: a CPU
rate is no device metric.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from gslora_tpu_torch.config import LoraConfig, ViTConfig
from gslora_tpu_torch.engine.continual import detached
from gslora_tpu_torch.engine.loop import resolve_device
from gslora_tpu_torch.models.vit import init_vit_params, vit_apply
from gslora_tpu_torch.utils.profiling import forward_throughput

FWD_GFLOP = {"p8s8": 7.95, "b16": 35.1}  # BASELINE.md forward accounting
BATCHES = {"p8s8": [64, 128, 240, 512], "b16": [32, 64, 128, 256]}
# Published dense bf16 tensor-core FLOP/s (NVIDIA data sheets), keyed by
# a substring of the card's name; int8 runs at twice each row's rate.
BF16_PEAKS = [("H200", 989e12), ("H100 PCIe", 756e12), ("H100 NVL", 835e12),
              ("H100", 989e12)]


def dense_peak(card: str, gemm_impl: str) -> float:
    """The card's published dense rate for the GEMMs' type (FLOP/s or
    OP/s); an unknown card raises."""
    for key, bf16 in BF16_PEAKS:
        if key in card:
            return 2 * bf16 if gemm_impl == "int8" else bf16
    raise RuntimeError(f"no published rates for card {card!r}")


def serving_model(name: str, int8: bool = False) -> ViTConfig:
    """The served model: the flagship ViT-P8S8 with dropout off, or
    ViT-B/16 over 100 classes; W8A8 projections with ``int8``."""
    model = ViTConfig.vit_b16(num_class=100) if name == "b16" else \
        ViTConfig(dropout=0.0, emb_dropout=0.0)
    return dataclasses.replace(model, gemm_impl="int8" if int8 else
                               "default")


def serving_params(model: ViTConfig, lora: LoraConfig,
                   device: torch.device):
    """Random bf16 parameters of ``model`` (seed 0) on ``device``."""
    return detached(init_vit_params(torch.Generator().manual_seed(0), model,
                                    lora, param_dtype=torch.bfloat16),
                    device)


def measure(model: ViTConfig, lora: LoraConfig, bs: int, k: int,
            gflop: float, device: torch.device, params=None) -> dict:
    """One point: ``k`` chained eval forwards of batch ``bs`` (of
    ``params``, default :func:`serving_params`)."""
    if params is None:
        params = serving_params(model, lora, device)
    labels = torch.zeros((bs,), dtype=torch.long, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    hw = model.image_size
    x = torch.randn(bs, 3, hw, hw, generator=gen, device=device)

    def apply_fn(images):
        logits, _ = vit_apply(params, images, labels, model, lora,
                              train=False, compute_dtype=torch.bfloat16,
                              lora_apply="merged")
        return logits

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    ips = forward_throughput(apply_fn, x, iters=k)
    tflops = ips * gflop / 1e3
    out = {"batch": bs, "images_per_sec": ips, "ms_per_batch": bs / ips * 1e3,
           "achieved_tflops": tflops, "mfu": None, "peak_mem_gb": None}
    if cuda:
        card = torch.cuda.get_device_name(device)
        out["mfu"] = tflops * 1e12 / dense_peak(card, model.gemm_impl)
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--b16", action="store_true",
                    help="ViT-B/16 (224px) instead of ViT-P8S8")
    ap.add_argument("--k", type=int, default=50)
    ap.add_argument("--batches", default="")
    ap.add_argument("--int8", action="store_true",
                    help="W8A8 dynamic quantization of the projection "
                         "GEMMs (gemm_impl='int8')")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    name = "b16" if args.b16 else "p8s8"
    model = serving_model(name, args.int8)
    batches = [int(b) for b in args.batches.split(",")] if args.batches \
        else BATCHES[name]
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    points = []
    for bs in batches:
        r = measure(model, LoraConfig(rank=8), bs, args.k, FWD_GFLOP[name],
                    device)
        points.append({"model": name, "gemm_impl": model.gemm_impl,
                       "device": where, **r})
        print(json.dumps(points[-1]), flush=True)
    return points


if __name__ == "__main__":
    main()
