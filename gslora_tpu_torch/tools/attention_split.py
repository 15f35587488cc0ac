"""The single-step GS-LoRA recipe with K1 and with the plain attention, in
bf16 and in fp32 compute, from one base: which of the attention kernel,
the compute dtype and the weights moves the forget and remain accuracy.

    python3 -m gslora_tpu_torch.tools.attention_split \
        [--seeds 3] [--epochs 25] [--out split.json] [--device cuda] [--tiny]

The base is tools/flagship.pretrained_base's unsaturated one
(``$PRETRAIN_CKPT``, pretrained and saved there when missing). Each run is
tools/integration_synthetic's recipe (``--unsaturated``: BND 10, alpha
warm-up, prototypes, EMA, merged LoRA) from that same base, with
``attn_impl`` "auto" (K1 on the card) or "dpa" (the plain attention of
ops/attention.py on any device), ``compute_dtype`` bfloat16 or float32,
at data seeds 0 .. seeds - 1 added to the recipe's (batch order and
dropout). The report lists every run (forget accuracy before and after,
remain accuracy, best H-mean, wall seconds, K1's launches by dtype) and,
for each of the four, the mean and the range over the seeds. On the card
a "dpa" run must launch no K1 and an "auto" run only the kernel of its
dtype.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import tempfile
import time

import torch

from gslora_tpu_torch.engine.loop import resolve_device, run_forget_training
from gslora_tpu_torch.ops import attention as A
from gslora_tpu_torch.tools import flagship
from gslora_tpu_torch.tools import integration_synthetic as IS

DTYPES = ("bfloat16", "float32")
IMPLS = ("auto", "dpa")
METRICS = ("forget_acc_after", "remain_acc_after", "best_H_mean")


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def k1_launches(since=None):
    """K1's forward and backward launches by dtype name, counted from
    ``since`` (an earlier reading) when given; the counters are never
    reset here, so a caller can count around a whole run too."""
    now = {str(dt).replace("torch.", ""): [A.FWD_BY_DTYPE[dt],
                                           A.BWD_BY_DTYPE[dt]]
           for dt in A.KERNEL_DTYPES}
    if since is None:
        return now
    return {k: [a - b for a, b in zip(v, since[k])] for k, v in now.items()}


def one_run(params, data, model, *, dtype, impl, seed, epochs, device,
            bs=flagship.BS) -> dict:
    """One forget run of the recipe from ``params``; raises on the card
    unless K1 ran as ``impl`` says."""
    dev = resolve_device(device)
    cfg = IS.run_config(dataclasses.replace(model, attn_impl=impl), True,
                        str(dev), epochs, bs, dtype)
    sync(dev)
    start = k1_launches()
    t0 = time.perf_counter()
    res = run_forget_training(cfg, params, data, seed_offset=seed)
    sync(dev)
    launches = k1_launches(since=start)
    if dev.type == "cuda":
        used = {k for k, v in launches.items() if any(v)}
        want = {dtype} if impl == "auto" else set()
        if used != want:
            raise RuntimeError(f"{impl} {dtype}: K1 launches {launches}")
    return {"seed": seed, "compute_dtype": dtype, "attn_impl": impl,
            "forget_acc_before": res.forget_acc_before,
            "forget_acc_after": res.forget_acc,
            "remain_acc_after": res.remain_acc,
            "best_H_mean": res.best_h,
            "wallclock_s": round(time.perf_counter() - t0, 1),
            "k1_launches": launches}


def summarize(runs) -> dict:
    """Mean and range of each metric for each (dtype, impl) over seeds."""
    out = {}
    for dtype in DTYPES:
        for impl in IMPLS:
            sel = [r for r in runs if (r["compute_dtype"], r["attn_impl"])
                   == (dtype, impl)]
            if sel:
                out[f"{dtype}/{impl}"] = {
                    m: {"mean": statistics.fmean(r[m] for r in sel),
                        "min": min(r[m] for r in sel),
                        "max": max(r[m] for r in sel)} for m in METRICS}
    return out


def run_split(params, train, test, model, *, seeds: int, epochs: int,
              device: str = "cuda", out: str | None = None) -> dict:
    """The base's test accuracy in each dtype, then every run; writes and
    returns the report."""
    dev = resolve_device(device)
    report = {"base_test_acc": {
        dtype: flagship.accuracy(params, test, model, dev, IS.EVAL_BS,
                                 mask_padding=False,
                                 compute_dtype=flagship.dtype(dtype))
        for dtype in DTYPES}, "epochs": epochs, "runs": []}
    data = IS.forget_data(train, test)
    for seed in range(seeds):
        for dtype in DTYPES:
            for impl in IMPLS:
                run = one_run(params, data, model, dtype=dtype, impl=impl,
                              seed=seed, epochs=epochs, device=device)
                print(json.dumps(run), flush=True)
                report["runs"].append(run)
    report["summary"] = summarize(report["runs"])
    report["device"] = flagship.device_name(dev)
    print(json.dumps(report["summary"], indent=1), flush=True)
    with open(out or os.path.join(tempfile.gettempdir(),
                                  "attention_split.json"), "w") as f:
        json.dump(report, f, indent=1)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=IS.EPOCHS)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="the integration tools' tiny model (a CPU run)")
    a = ap.parse_args(argv)
    resolve_device(a.device)
    model = flagship.model_config(True, tiny=a.tiny)
    train, test = flagship.stand_in(model, flagship.noise(True))
    params = flagship.pretrained_base(
        model, train, flagship.pretrain_epochs(True), a.device,
        flagship.checkpoint_path(True, tiny=a.tiny))
    return run_split(params, train, test, model, seeds=a.seeds,
                     epochs=a.epochs, device=a.device, out=a.out)


if __name__ == "__main__":
    main()
