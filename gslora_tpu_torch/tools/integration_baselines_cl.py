"""The baselines over several forget tasks on the flagship (port of
scripts/integration_baselines_cl.py): each method keeps its state across
the tasks (SCRUB's teacher and SWA model, LwF's teacher, LIRF's four
models, EWC's growing anchor and importance lists) through the continual
task loop, cli/train_forget_cl.run_baseline_continual, from one
unsaturated pretrained ViT-P8S8 base (Softmax head, noise 2.4), bf16
compute, batch 48.

    python3 -m gslora_tpu_torch.tools.integration_baselines_cl \
        [--methods scrub,lwf,lirf,ewc] [--num_tasks 2] [--tiny] \
        [--out report.json] [--device cpu]

The 80 first classes stay and 10 more are forgotten per task, from 40 %
subsets. ``--tiny`` runs the 16-px, depth-2 model of dim 64 at batch 8
(its own cached base, ``_tiny``), a wiring run for the CPU; ``--device``
alone picks the device. The base comes from
tools/flagship.pretrained_base (``$PRETRAIN_CKPT`` with ``_unsat``). After
each method the report (pretrain test accuracy, the per-task results and
wall time of each method, the total wall time) is merged into ``--out``,
else into ``integration_baselines_cl.json`` in the temporary directory.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

from gslora_tpu_torch.cli.train_forget_cl import run_baseline_continual
from gslora_tpu_torch.config import (BaselineConfig, DataConfig,
                                     ForgetConfig, OptimConfig, RunConfig)
from gslora_tpu_torch.data.splits import make_order_list
from gslora_tpu_torch.engine.continual import detached
from gslora_tpu_torch.engine.loop import resolve_device
from gslora_tpu_torch.metrics.logging import MetricLogger
from gslora_tpu_torch.tools import flagship
from gslora_tpu_torch.tools.integration_baselines import EVAL_BS

TINY_BS = 8
# Per method: epochs, learning rate (default 1e-4) and BaselineConfig
# fields, as the single-task matrix's (reference recipe lambdas; SCRUB's
# 2 superepochs suffice on the stand-in; Retrain starts from scratch each
# task, so it gets the pretrain budget).
RECIPES = {
    "lwf": dict(n_ep=6, baseline=dict(lwf_lambda_kd=0.5,
                                      lwf_lambda_remain=1.0)),
    "lirf": dict(n_ep=6, baseline={}),
    "ewc": dict(n_ep=6, baseline=dict(ewc_lambda=10.0)),
    "scrub": dict(n_ep=10, baseline=dict(
        scrub_superepoch=2, sgda_learning_rate=5e-4, sgda_gamma=0.99,
        sgda_alpha=0.001)),
    "der": dict(n_ep=6, baseline=dict(der_lambda=0.1)),
    "der_plus": dict(n_ep=6, baseline=dict(der_lambda=0.1,
                                           der_plus_lambda=0.1)),
    "fdr": dict(n_ep=6, baseline=dict(fdr_lambda=0.1)),
    "mas": dict(n_ep=6, baseline=dict(mas_lambda=5.0)),
    "l2": dict(n_ep=6, baseline=dict(l2_lambda=0.1)),
    "replay": dict(n_ep=6, baseline={}),
    "retrain": dict(n_ep=12, lr=3e-4, baseline={}),
}


def default_out() -> str:
    return os.path.join(tempfile.gettempdir(),
                        "integration_baselines_cl.json")


def flush(report: dict, t0: float, out: str | None) -> None:
    """The report with its total wall time, merged into ``out``."""
    report["total_wallclock_s"] = round(time.time() - t0, 1)
    flagship.merge_report(out or default_out(), report, indent=2)
    print(json.dumps(report, indent=2), flush=True)


def run_config(method: str, recipe: dict, model, bs: int, num_tasks: int,
               device: str, compute_dtype: str = "bfloat16") -> RunConfig:
    """``method`` at ``recipe`` over ``num_tasks`` tasks of 80 first and
    10 forgotten classes, 40 % subsets."""
    return RunConfig(
        model=model, lora=flagship.LORA,
        optim=OptimConfig(opt="adamw", lr=recipe.get("lr", 1e-4),
                          warmup_epochs=0, epochs=recipe["n_ep"]),
        forget=ForgetConfig(num_of_first_cls=80, per_forget_cls=10,
                            num_tasks=num_tasks, data_ratio=0.4),
        baseline=BaselineConfig(method=method, **recipe["baseline"]),
        data=DataConfig(batch_size=bs), num_epoch=recipe["n_ep"],
        ver_freq=10_000, compute_dtype=compute_dtype, device=device)


def run(methods, params, train, test, model, bs, device, num_tasks=2,
        recipes=RECIPES, *, compute_dtype: str = "bfloat16",
        out: str | None = None, t0: float | None = None) -> dict:
    """``num_tasks`` tasks of each of ``methods`` (in order) from the
    base ``params`` at ``recipes``; the report, merged into ``out`` after
    each method."""
    t0 = time.time() if t0 is None else t0
    dev = resolve_device(str(device))
    params = detached(params, dev)
    pre_acc = flagship.accuracy(params, test, model, dev, EVAL_BS,
                                mask_padding=True,
                                compute_dtype=flagship.dtype(compute_dtype))
    print("pretrain test acc", pre_acc, flush=True)
    order = make_order_list(100, seed=1337)
    report = {"pretrain_test_acc": pre_acc, "num_tasks": num_tasks}
    for m in methods:
        t1 = time.time()
        cfg = run_config(m, recipes[m], model, bs, num_tasks, str(dev),
                         compute_dtype)
        results, _ = run_baseline_continual(cfg, params, train, test, order,
                                            MetricLogger(), workdir=None)
        report[m] = {"tasks": results,
                     "wallclock_s": round(time.time() - t1, 1)}
        print(m, json.dumps(report[m]), flush=True)
        flush(dict(report), t0, out)
    flush(report, t0, out)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--methods", default="scrub,lwf,lirf,ewc",
                    help="comma list of the methods with state across "
                         "tasks")
    ap.add_argument("--num_tasks", default=2, type=int)
    ap.add_argument("--tiny", action="store_true",
                    help="CPU wiring run: 16-px depth-2 model, batch 8")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    methods = [m.strip() for m in a.methods.split(",") if m.strip()]
    resolve_device(a.device)
    model = flagship.model_config(unsaturated=True, tiny=a.tiny)
    t0 = time.time()
    train, test = flagship.stand_in(model, flagship.noise(True))
    params = flagship.pretrained_base(
        model, train, flagship.pretrain_epochs(True), a.device,
        flagship.checkpoint_path(unsaturated=True, tiny=a.tiny))
    return run(methods, params, train, test, model,
               TINY_BS if a.tiny else flagship.BS, a.device, a.num_tasks,
               out=a.out, t0=t0)


if __name__ == "__main__":
    main()
