"""Flagship-scale continual integration (port of
scripts/integration_continual.py): 4-task GS-LoRA++ on the synthetic
CASIA-100 stand-in (ViT-P8S8, 19.2 M parameters, bf16 compute): classes
are erased task by task, and classes forgotten earlier must stay
forgotten.

    python3 -m gslora_tpu_torch.tools.integration_continual \
        [--unsaturated] [--boundary merge_reinit|keep] [--few_shot] \
        [--compute_dtype bfloat16|float32] [--epochs 12] [--dropout 0.1] \
        [--attn_impl auto|dpa] [--metrics_dir DIR] [--out report.json] \
        [--device cpu]

Modes:
  --unsaturated  pretrain the unsaturated base the baseline zoo uses
                 (Softmax head, noise 2.4): a CosFace head at s = 64
                 saturates CE to 0 on separable blobs and flatters the
                 relu(BND - CE) ascent term.
  --boundary keep  keep the adapters across tasks instead of the
                 reference's merge + reinit (cl.py:523-536), to tell
                 old-class resurfacing caused by the fold from that caused
                 by a task's training.
  --few_shot     the run_cl_forget.sh few-shot recipe (4 images a class).
  --compute_dtype, --epochs, --dropout, --attn_impl  arms of the recipe
                 (bf16 compute, 12 epochs a task, the model's dropout
                 0.1 and its fused attention, K1 on the card): the
                 compute dtype, the epochs a task, the dropout (and the
                 embedding's), the attention (dpa: K1's plain version).
  --metrics_dir  write the task loop's metrics (every 5th step's losses,
                 the evals, the LoRA group norms) to DIR/metrics.jsonl.

The pretrained base comes from tools/flagship.pretrained_base: cached
as a port checkpoint at ``PRETRAIN_CKPT`` (default
``flagship_pretrained.pth`` in the temporary directory; the unsaturated
one with ``_unsat`` before the suffix) and reused when it exists, or read
from a ``.msgpack`` the JAX package's scripts wrote there. Reports
pretrain test accuracy, and per task forget_before, forget_after,
remain_after, old_acc_before (after the boundary, before training),
old_acc and best_H, and the wall time, to ``--out``, else to
``integration_cl_report[_unsat][_keep][_fs].json`` in the temporary
directory. Beyond the JAX script's keys the report holds, per task, the
task's wall and the kernels' launches in it (engine/continual.TaskResult),
and ``base_change``, the largest change of a base weight over the run:
0 under ``keep``, which trains the adapters alone.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

from gslora_tpu_torch.config import (DataConfig, ForgetConfig, OptimConfig,
                                     RunConfig)
from gslora_tpu_torch.data.splits import make_order_list
from gslora_tpu_torch.engine.continual import run_continual_forgetting
from gslora_tpu_torch.engine.loop import resolve_device
from gslora_tpu_torch.metrics.logging import MetricLogger
from gslora_tpu_torch.models.convert import flatten_tree
from gslora_tpu_torch.tools import flagship

EPOCHS = 12
EVAL_BS = 250


def forget_config(head_type: str, few_shot: bool) -> ForgetConfig:
    """The script's GS-LoRA++ recipe: 4 tasks of 80 first and 20 forgotten
    classes. BND bounds the forget batch's CE: 105 suits CosFace's s = 64
    logit scale (run_cl_forget.sh:9-22); a Softmax head's CE lives near
    ln(100) ~ 4.6, so the unsaturated runs take the single-task zoo's
    10."""
    fcfg = ForgetConfig(num_of_first_cls=80, per_forget_cls=20,
                        num_tasks=4,
                        bnd=105.0 if head_type == "CosFace" else 10.0,
                        cl_beta_list=(0.3, 0.4, 0.28, 0.2),
                        alpha=1e-4, alpha_epoch=0,
                        prototype=True, bnd_pro=50.0,
                        cl_prof_list=(0.015, 0.06, 0.025, 0.012),
                        pro_r_weight=0.0, data_ratio=0.4)
    if few_shot:
        fcfg = dataclasses.replace(fcfg, few_shot=True, few_shot_num=4)
    return fcfg


def run_config(model, few_shot: bool, num_tasks: int, device: str,
               epochs: int = EPOCHS,
               compute_dtype: str = "bfloat16") -> RunConfig:
    """The script's run: lr 1e-2, batch 48 (4 few-shot), merged LoRA, one
    fused forward of the forget and remain batches, the first
    ``num_tasks`` tasks of :func:`forget_config`."""
    return RunConfig(
        model=model, lora=flagship.LORA,
        optim=OptimConfig(lr=1e-2, warmup_epochs=0, epochs=epochs),
        forget=dataclasses.replace(forget_config(model.head_type, few_shot),
                                   num_tasks=num_tasks),
        data=DataConfig(batch_size=4 if few_shot else flagship.BS),
        num_epoch=epochs, ver_freq=10_000, compute_dtype=compute_dtype,
        lora_apply="merged", fused_batch=True, device=device)


def default_out(unsaturated: bool, boundary: str, few_shot: bool) -> str:
    tag = ("_unsat" if unsaturated else "") + \
        ("_keep" if boundary == "keep" else "") + \
        ("_fs" if few_shot else "")
    return os.path.join(tempfile.gettempdir(),
                        f"integration_cl_report{tag}.json")


def base_change(start, final) -> float:
    """The largest |final - start| over the base's weights."""
    start, final = flatten_tree(start["base"]), flatten_tree(final["base"])
    return max(float((final[k].detach().cpu().float() -
                      start[k].detach().cpu().float()).abs().max())
               for k in start)


def run(params, train, test, model, *, unsaturated: bool,
        boundary: str = "merge_reinit", few_shot: bool = False,
        num_tasks: int = 4, device: str = "cuda", epochs: int = EPOCHS,
        compute_dtype: str = "bfloat16", out: str | None = None,
        t0: float | None = None, metrics_dir: str | None = None) -> dict:
    """The script's run from the base ``params``: its test accuracy, then
    ``num_tasks`` tasks of the recipe; writes and returns the report.
    ``t0``: when the run began (the wall time counts from it);
    ``metrics_dir``: where the task loop's metrics.jsonl goes."""
    t0 = time.time() if t0 is None else t0
    dev = resolve_device(device)
    acc = flagship.accuracy(params, test, model, dev, EVAL_BS,
                            mask_padding=dev.type != "cpu",
                            compute_dtype=flagship.dtype(compute_dtype))
    print("pretrain test acc", acc, flush=True)
    cfg = run_config(model, few_shot, num_tasks, str(dev), epochs,
                     compute_dtype)
    order = make_order_list(100, seed=1337)
    res = run_continual_forgetting(cfg, params, train, test, order,
                                   logger=MetricLogger(outdir=metrics_dir),
                                   boundary=boundary)
    report = {"pretrain_test_acc": acc,
              "head": model.head_type, "noise": flagship.noise(unsaturated),
              "boundary": boundary, "few_shot": few_shot,
              "device": flagship.device_name(dev),
              "tasks": [
                  {"task": t.task,
                   "forget_before": t.result.forget_acc_before,
                   "forget_after": t.result.forget_acc,
                   "remain_after": t.result.remain_acc,
                   "old_acc_before": t.old_acc_before,
                   "old_acc": t.old_acc,
                   "best_H": t.result.best_h,
                   "wall_s": t.wall_s, "launches": t.launches}
                  for t in res.tasks],
              "base_change": base_change(params, res.final_params),
              "wallclock_s": round(time.time() - t0, 1)}
    print(json.dumps(report, indent=2), flush=True)
    with open(out or default_out(unsaturated, boundary, few_shot), "w") as f:
        json.dump(report, f)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--unsaturated", action="store_true")
    ap.add_argument("--boundary", default="merge_reinit",
                    choices=["merge_reinit", "keep"])
    ap.add_argument("--few_shot", action="store_true")
    ap.add_argument("--compute_dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--dropout", type=float, default=None)
    ap.add_argument("--attn_impl", default=None, choices=["auto", "dpa"])
    ap.add_argument("--metrics_dir", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    resolve_device(a.device)
    model = flagship.model_config(a.unsaturated)
    t0 = time.time()
    train, test = flagship.stand_in(model, flagship.noise(a.unsaturated))
    params = flagship.pretrained_base(
        model, train, flagship.pretrain_epochs(a.unsaturated), a.device,
        flagship.checkpoint_path(a.unsaturated))
    # the arm's model: the base's, with the dropout and attention asked for
    if a.dropout is not None:
        model = dataclasses.replace(model, dropout=a.dropout,
                                    emb_dropout=a.dropout)
    if a.attn_impl is not None:
        model = dataclasses.replace(model, attn_impl=a.attn_impl)
    return run(params, train, test, model, unsaturated=a.unsaturated,
               boundary=a.boundary, few_shot=a.few_shot, device=a.device,
               epochs=a.epochs, compute_dtype=a.compute_dtype, out=a.out,
               t0=t0, metrics_dir=a.metrics_dir)


if __name__ == "__main__":
    main()
