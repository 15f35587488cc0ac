"""One forget task of each unlearning method on the flagship (port of
scripts/integration_baselines.py): GS-LoRA and the eleven baselines of
the zoo (LwF, DER, DER++, FDR, LIRF, EWC, MAS, L2, Retrain, Replay,
SCRUB) from one pretrained ViT-P8S8 base on the synthetic CASIA-100
stand-in, bf16 compute, batch 48.

    python3 -m gslora_tpu_torch.tools.integration_baselines \
        [--methods ewc,scrub] [--unsaturated] [--out report.json] \
        [--device cpu]

The 80 first classes stay and the next 20 are forgotten (the seed-1337
order), from 40 % subsets of each training split; the baselines train on
the forget subset relabeled at random (seed 1337), GS-LoRA and SCRUB on
its true labels. Each method's recipe is a row of ``RECIPES``. The base
comes from tools/flagship.pretrained_base (``$PRETRAIN_CKPT``; with
``--unsaturated`` the Softmax head and noise 2.4, where the
gradient-based baselines have signal). After each method the report
(forget accuracy before and after, remain accuracy, best H-mean and wall
time per method, the pretrain test accuracy, the total wall time; keys
end in ``_unsat`` when unsaturated) is merged into ``--out``, else into
``integration_baselines.json`` in the temporary directory.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from gslora_tpu_torch.baselines.distill import run_distill_task
from gslora_tpu_torch.baselines.lirf import run_lirf_task
from gslora_tpu_torch.baselines.regularization import (
    estimate_importance, run_regularization_task)
from gslora_tpu_torch.baselines.scrub import run_scrub_task
from gslora_tpu_torch.config import (BaselineConfig, DataConfig,
                                     ForgetConfig, OptimConfig, RunConfig)
from gslora_tpu_torch.data.folders import ConcatDataset
from gslora_tpu_torch.data.pipeline import BatchLoader, CyclingLoader
from gslora_tpu_torch.data.splits import (make_order_list, random_relabel,
                                          ratio_subset, split_by_class_window)
from gslora_tpu_torch.engine.continual import detached
from gslora_tpu_torch.engine.loop import (ForgetData, resolve_device,
                                          run_forget_training)
from gslora_tpu_torch.models.vit import init_vit_params
from gslora_tpu_torch.tools import flagship

EVAL_BS = 240
_DISTILL = dict(lwf_lambda_kd=0.5, lwf_lambda_remain=1.0, der_lambda=0.1,
                der_plus_lambda=0.1, fdr_lambda=0.1)
# Each method's recipe, in the order the script runs them: its family,
# epochs, learning rate (default 1e-4), BaselineConfig fields and the
# seeds of its training loaders. The lambdas of the regularization family
# are the reference recipe templates' (ewc 10, MAS 5, l2 0.1); Retrain
# starts from scratch, so it gets the pretrain budget.
RECIPES = {
    "gs_lora": dict(family="gs_lora", n_ep=12, lr=1e-2,
                    forget=dict(beta=0.15, alpha=1e-4, alpha_epoch=0)),
    **{m: dict(family="distill", n_ep=6, baseline=_DISTILL, seeds=(4, 5))
       for m in ("lwf", "der", "der_plus", "fdr")},
    "lirf": dict(family="lirf", n_ep=6, seeds=(6, 7)),
    "ewc": dict(family="reg", n_ep=6, baseline=dict(ewc_lambda=10.0),
                seeds=(1,)),
    "mas": dict(family="reg", n_ep=6, baseline=dict(mas_lambda=5.0),
                seeds=(1,)),
    "l2": dict(family="reg", n_ep=6, baseline=dict(l2_lambda=0.1),
               seeds=(1,)),
    "retrain": dict(family="retrain", n_ep=12, lr=3e-4, seeds=(8,)),
    "replay": dict(family="replay", n_ep=6, seeds=(9,)),
    "scrub": dict(family="scrub", n_ep=10, baseline=dict(
        scrub_superepoch=2, sgda_learning_rate=5e-4, sgda_gamma=0.99,
        sgda_alpha=0.001), seeds=(2, 3)),
}
RESULT_KEYS = ("forget_acc_before", "forget_acc", "remain_acc", "best_h")


def with_epochs(recipes: dict, n: int) -> dict:
    """``recipes`` with every epoch count (SCRUB's superepochs too) set to
    ``n``."""
    out = {}
    for m, r in recipes.items():
        r = {**r, "n_ep": n}
        if "scrub_superepoch" in r.get("baseline", {}):
            r["baseline"] = {**r["baseline"], "scrub_superepoch": n}
        out[m] = r
    return out


def check_methods(methods) -> set:
    """The set of ``methods``; SystemExit names any the script lacks."""
    methods = set(methods)
    unknown = methods - set(RECIPES)
    if unknown or not methods:
        raise SystemExit(f"unknown --methods {sorted(unknown)}; "
                         f"choose from {sorted(RECIPES)}")
    return methods


def default_out() -> str:
    return os.path.join(tempfile.gettempdir(), "integration_baselines.json")


def finish(report: dict, t0: float, out: str | None) -> None:
    """The report with its total wall time, merged into ``out``."""
    report["total_wallclock_s"] = round(time.time() - t0, 1)
    print(json.dumps(report, indent=2), flush=True)
    flagship.merge_report(out or default_out(), report)


def run_methods(methods, params, train, test, model, bs, device,
                fresh_params=None, recipes=RECIPES, *, suffix: str = "",
                compute_dtype: str = "bfloat16", out: str | None = None,
                t0: float | None = None) -> dict:
    """One task of each of ``methods`` from the base ``params`` (a tree
    on any device) at ``recipes``; the report, merged into ``out`` after
    each method. ``fresh_params``: Retrain's start (default: the init
    drawn from seed 11); ``suffix``: the report keys' (``_unsat``)."""
    methods = check_methods(methods)
    t0 = time.time() if t0 is None else t0
    dev = resolve_device(str(device))
    cdt = flagship.dtype(compute_dtype)
    params = detached(params, dev)
    pre_acc = flagship.accuracy(params, test, model, dev, EVAL_BS,
                                mask_padding=True, compute_dtype=cdt)
    print("pretrain test acc", pre_acc, flush=True)

    order = make_order_list(100, seed=1337)
    remain_tr, forget_tr = split_by_class_window(train, order, 0, 80, 80, 100)
    remain_te, forget_te = split_by_class_window(test, order, 0, 80, 80, 100)
    forget_sub = ratio_subset(forget_tr, 0.4, 1337)
    remain_sub = ratio_subset(remain_tr, 0.4, 1337)
    relabeled = random_relabel(forget_sub, 100, seed=1337)

    def padded(ds, batch_size, **kw):
        return BatchLoader(ds, batch_size, mask_padding=True, **kw)

    def tbf():
        return padded(forget_te, EVAL_BS, shuffle=False, prefetch=0)

    def tbr():
        return padded(remain_te, EVAL_BS, shuffle=False, prefetch=0)

    report = {"pretrain_test_acc" + suffix: pre_acc}
    for m, r in recipes.items():
        if m not in methods:
            continue
        t1 = time.time()
        family, n_ep, seeds = r["family"], r["n_ep"], r.get("seeds", ())
        gs_lora = family == "gs_lora"
        # GS-LoRA's BND: 110 suits CosFace's s = 64 logits; a Softmax
        # head's CE lives near ln(100) ~ 4.6
        bnd = {"bnd": 110.0 if model.head_type == "CosFace" else 10.0} \
            if gs_lora else {}
        cfg = RunConfig(
            model=model, lora=flagship.LORA,
            optim=OptimConfig(opt="adamw", lr=r.get("lr", 1e-4),
                              warmup_epochs=0, epochs=n_ep),
            forget=ForgetConfig(num_of_first_cls=80, per_forget_cls=20,
                                **r.get("forget", {}), **bnd),
            baseline=BaselineConfig(method=m, **r.get("baseline", {})),
            data=DataConfig(batch_size=bs), num_epoch=n_ep, ver_freq=10_000,
            compute_dtype=compute_dtype, device=str(dev),
            lora_apply="merged" if gs_lora else "factored",
            fused_batch=gs_lora)
        if gs_lora:
            # bounded ascent + remain CE + group-Lasso over the rank-8 FFN
            # LoRA, true forget labels, one fused batch
            res = run_forget_training(cfg, params, ForgetData(
                train_forget=forget_sub, train_remain=remain_sub,
                test_forget=forget_te, test_remain=remain_te))
            out_m = {"forget_acc_before": res.forget_acc_before,
                     "forget_acc": res.forget_acc,
                     "remain_acc": res.remain_acc, "best_h": res.best_h}
        elif family == "distill":
            # the teacher is the base, frozen
            fl = padded(relabeled, bs, seed=seeds[0])
            rl = padded(remain_sub, bs, seed=seeds[1])
            out_m = run_distill_task(cfg, params, params, lambda: iter(fl),
                                     CyclingLoader(rl), tbf, tbr)
        elif family == "lirf":
            fl = padded(relabeled, bs, seed=seeds[0])
            rl = padded(remain_sub, bs, seed=seeds[1])
            out_m = run_lirf_task(cfg, params, lambda: iter(fl),
                                  CyclingLoader(rl), tbf, tbr)
        elif family == "reg":
            # quadratic penalty to the base, weighted by the importance
            # over the remain subset
            lam = r["baseline"][m + "_lambda"]
            imp = estimate_importance(
                m, params, padded(remain_sub, bs, shuffle=False, prefetch=0),
                model, flagship.LORA, cdt)
            fl = padded(relabeled, bs, seed=seeds[0])
            out_m = run_regularization_task(
                cfg, params, lambda: iter(fl), tbf, tbr, lam=lam,
                anchors=[params], importances=[imp])
        elif family in ("retrain", "replay"):
            # Retrain: a fresh model on the remain subset; Replay: the
            # base on the relabeled forget subset and the remain subset
            if family == "retrain":
                start = fresh_params if fresh_params is not None else \
                    init_vit_params(torch.Generator().manual_seed(11), model,
                                    flagship.LORA)
                tl = padded(remain_sub, bs, seed=seeds[0])
            else:
                start = params
                tl = padded(ConcatDataset(relabeled, remain_sub), bs,
                            seed=seeds[0])
            out_m = run_regularization_task(
                cfg, start, lambda: iter(tl), tbf, tbr, lam=0.0, anchors=[],
                importances=[])
        else:
            # SCRUB: max/min KD against the base, SWA, sgda, true labels
            fl = padded(forget_sub, bs, seed=seeds[0])
            rl = padded(remain_sub, bs, seed=seeds[1])
            out_m = run_scrub_task(cfg, params, lambda: iter(fl),
                                   lambda: iter(rl), tbf, tbr)
        report[m + suffix] = {k: out_m[k] for k in RESULT_KEYS}
        report[m + suffix]["wallclock_s"] = round(time.time() - t1, 1)
        print(f"{m}:", json.dumps(report[m + suffix]), flush=True)
        finish(dict(report), t0, out)
    finish(report, t0, out)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--methods", default="ewc,scrub",
                    help=f"comma list of {','.join(RECIPES)}")
    ap.add_argument("--unsaturated", action="store_true",
                    help="harder stand-in (noise 2.4, Softmax head, fewer "
                         "pretrain epochs) so CE is not saturated: the "
                         "regime where the gradient-based baselines (EWC "
                         "importance, LIRF relabel-CE) have signal")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    methods = check_methods(m.strip() for m in a.methods.split(",")
                            if m.strip())
    resolve_device(a.device)
    t0 = time.time()
    model = flagship.model_config(a.unsaturated)
    train, test = flagship.stand_in(model, flagship.noise(a.unsaturated))
    params = flagship.pretrained_base(
        model, train, flagship.pretrain_epochs(a.unsaturated), a.device,
        flagship.checkpoint_path(a.unsaturated))
    return run_methods(methods, params, train, test, model, flagship.BS,
                       a.device, suffix="_unsat" if a.unsaturated else "",
                       out=a.out, t0=t0)


if __name__ == "__main__":
    main()
