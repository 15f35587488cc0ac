"""Flagship-scale continual integration (port of
scripts/integration_continual.py): 4-task GS-LoRA++ on the synthetic
CASIA-100 stand-in (ViT-P8S8, 19.2 M parameters, bf16 compute): classes
are erased task by task, and classes forgotten earlier must stay
forgotten.

    python3 -m gslora_tpu_torch.tools.integration_continual \
        [--unsaturated] [--boundary merge_reinit|keep] [--few_shot] \
        [--out report.json] [--device cpu]

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

The pretrained base is cached as a port checkpoint at ``PRETRAIN_CKPT``
(default ``flagship_pretrained.pth`` in the temporary directory; the
unsaturated one with ``_unsat`` before the suffix) and reused when it
exists. Reports pretrain test accuracy, and per task forget_before,
forget_after, remain_after, old_acc_before (after the boundary, before
training), old_acc and best_H, and the wall time.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import torch

from gslora_tpu_torch.checkpoints.io import load_params, save_params
from gslora_tpu_torch.config import (DataConfig, ForgetConfig, LoraConfig,
                                     OptimConfig, RunConfig, ViTConfig)
from gslora_tpu_torch.data.pipeline import BatchLoader
from gslora_tpu_torch.data.splits import make_order_list
from gslora_tpu_torch.data.synthetic import synthetic_face_dataset
from gslora_tpu_torch.engine.continual import detached, \
    run_continual_forgetting
from gslora_tpu_torch.engine.evaluate import eval_accuracy, make_eval_step
from gslora_tpu_torch.engine.loop import resolve_device
from gslora_tpu_torch.engine.pretrain import pretrain
from gslora_tpu_torch.models.vit import init_vit_params

MODEL = ViTConfig(image_size=112, patch_size=8, dim=512, depth=6, heads=8,
                  dim_head=64, mlp_dim=2048, num_class=100, dropout=0.1,
                  emb_dropout=0.1, head_type="CosFace")
LORA = LoraConfig(rank=8)


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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--unsaturated", action="store_true")
    ap.add_argument("--boundary", default="merge_reinit",
                    choices=["merge_reinit", "keep"])
    ap.add_argument("--few_shot", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    device = resolve_device(a.device)

    model = MODEL
    ckpt = os.environ.get("PRETRAIN_CKPT", os.path.join(
        tempfile.gettempdir(), "flagship_pretrained.pth"))
    noise, pre_epochs = 1.0, 25
    if a.unsaturated:
        model = dataclasses.replace(model, head_type="Softmax")
        root, ext = os.path.splitext(ckpt)
        ckpt = f"{root}_unsat{ext}"
        noise, pre_epochs = 2.4, 12

    t0 = time.time()
    train = synthetic_face_dataset(num_classes=100, per_class=24,
                                   image_size=112, seed=0, noise=noise)
    test = synthetic_face_dataset(num_classes=100, per_class=5,
                                  image_size=112, seed=77, noise=noise)
    params = init_vit_params(torch.Generator().manual_seed(0), model, LORA)
    if os.path.exists(ckpt):
        params = load_params(ckpt)
        print("loaded pretrained", ckpt, flush=True)
    else:
        pre_cfg = RunConfig(
            model=dataclasses.replace(model, remat=True), lora=LORA,
            optim=OptimConfig(lr=3e-4, warmup_epochs=2, epochs=pre_epochs),
            data=DataConfig(batch_size=240), device=a.device)
        state, _ = pretrain(pre_cfg, params,
                            lambda: BatchLoader(train, 240, seed=3),
                            epochs=pre_epochs, compute_dtype=torch.bfloat16)
        params = detached(state.params)
        save_params(ckpt, params)
        print("pretrained + saved", round(time.time() - t0, 1), "s",
              flush=True)
    ev = make_eval_step(model, LORA, compute_dtype=torch.bfloat16)
    acc = eval_accuracy(ev, detached(params, device),
                        BatchLoader(test, 250, shuffle=False, prefetch=0,
                                    mask_padding=device.type != "cpu"))
    print("pretrain test acc", acc, flush=True)

    cfg = RunConfig(
        model=model, lora=LORA,
        optim=OptimConfig(lr=1e-2, warmup_epochs=0, epochs=12),
        forget=forget_config(model.head_type, a.few_shot),
        data=DataConfig(batch_size=4 if a.few_shot else 48),
        num_epoch=12, ver_freq=10_000, compute_dtype="bfloat16",
        lora_apply="merged", fused_batch=True, device=a.device)
    order = make_order_list(100, seed=1337)
    out = run_continual_forgetting(cfg, params, train, test, order,
                                   boundary=a.boundary)
    report = {"pretrain_test_acc": acc,
              "head": model.head_type, "noise": noise,
              "boundary": a.boundary, "few_shot": a.few_shot,
              "device": torch.cuda.get_device_name(device)
              if device.type == "cuda" else "cpu",
              "tasks": [
                  {"task": t.task,
                   "forget_before": t.result.forget_acc_before,
                   "forget_after": t.result.forget_acc,
                   "remain_after": t.result.remain_acc,
                   "old_acc_before": t.old_acc_before,
                   "old_acc": t.old_acc,
                   "best_H": t.result.best_h} for t in out.tasks],
              "wallclock_s": round(time.time() - t0, 1)}
    print(json.dumps(report, indent=2), flush=True)
    tag = ("_unsat" if a.unsaturated else "") + \
        ("_keep" if a.boundary == "keep" else "") + \
        ("_fs" if a.few_shot else "")
    with open(a.out or os.path.join(tempfile.gettempdir(),
                                    f"integration_cl_report{tag}.json"),
              "w") as f:
        json.dump(report, f)
    return report


if __name__ == "__main__":
    main()
