"""Checkpoint evaluation harness (port of gslora_tpu/cli/test_model.py;
reference test/test_own.py via scripts/test_sub.sh): overall and per-class
top-1 on the test split; writes class_accuracy.txt and report.json.

Usage (recipe gslora_tpu_torch/scripts/test.sh):
  python -m gslora_tpu_torch.cli.test_model -d casia100 -n VIT \
      --vit_depth 6 --head CosFace --lora_rank 8 -r <ckpt> -b 240 \
      --outdir <dir> [--gemm_impl int8] [--ver_targets lfw,agedb_30] \
      [--device cpu]

``-r`` takes the port's ``.pth``, a reference-named ``.pth`` or a JAX
``.msgpack`` (cli/common.build_params); an ImageNet-100 run cuts a resumed
1000-way head down to its classes. ``--gemm_impl int8`` serves the
projection GEMMs in W8A8 (ops/quant). ``--ver_targets`` runs pair
verification on ``<data_root>/<name>.bin`` with ROC artifacts. Runs on the
GPU unless ``--device cpu`` is given.
"""
from __future__ import annotations

import json
import os
import warnings
from collections import defaultdict

import numpy as np
import torch

from gslora_tpu_torch.cli.common import (build_datasets, build_params,
                                         prepare_imagenet_head)
from gslora_tpu_torch.config import build_parser, config_from_args
from gslora_tpu_torch.data.pipeline import BatchLoader
from gslora_tpu_torch.engine.continual import detached
from gslora_tpu_torch.engine.loop import _dtype, resolve_device
from gslora_tpu_torch.models.vit import vit_apply


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    device = resolve_device(cfg.device)
    cdt = _dtype(cfg)
    _, test_ds = build_datasets(cfg)
    params = build_params(cfg)
    if cfg.data.data_mode == "imagenet100":
        # a resumed 1000-way torchvision head is cut to the run's classes
        # as the training drivers do (modify_head flow,
        # train_own_forget_cl.py:180-296); the full head against local
        # labels would report ~0%
        params, _ = prepare_imagenet_head(cfg, params, test_ds)
    params = detached(params, device)

    correct = total = 0
    per_class = defaultdict(lambda: [0, 0])
    # static batch shapes on the card, as the JAX CLI off the CPU: pad
    # rows carry the -1 label sentinel and are skipped below
    pad = device.type != "cpu"
    with torch.inference_mode():
        for x, y in BatchLoader(test_ds, cfg.data.batch_size, shuffle=False,
                                uint8_transfer=cfg.data.uint8_transfer,
                                mask_padding=pad, prefetch=0):
            logits, _ = vit_apply(params, torch.from_numpy(x).to(device),
                                  torch.from_numpy(y).to(device), cfg.model,
                                  cfg.lora, train=False, compute_dtype=cdt)
            pred = torch.argmax(logits, dim=-1).cpu().numpy()
            for p, t in zip(pred, y):
                if t < 0:  # pad sentinel
                    continue
                per_class[int(t)][1] += 1
                total += 1
                if p == t:
                    per_class[int(t)][0] += 1
                    correct += 1

    acc = 100.0 * correct / max(total, 1)
    class_acc = {c: 100.0 * k / max(n, 1)
                 for c, (k, n) in sorted(per_class.items())}
    report = {"test_acc": acc, "num_samples": total}

    # optional LFW-style pair verification with ROC artifacts
    # (train_own.py perform_val + util/utils.py:298-313 buffer_val tap)
    targets = [t for t in args.ver_targets.split(",") if t]
    if targets:
        from gslora_tpu_torch.data.recordio import get_val_data
        from gslora_tpu_torch.evaluation.verification import perform_val
        from gslora_tpu_torch.metrics.logging import (MetricLogger,
                                                      buffer_val,
                                                      gen_roc_plot)
        logger = MetricLogger(use_wandb=cfg.log_wandb, outdir=cfg.outdir)

        @torch.inference_mode()
        def embed(b):
            x = torch.from_numpy(np.ascontiguousarray(b)).to(device)
            return vit_apply(params, x, None, cfg.model, cfg.lora,
                             train=False, compute_dtype=cdt).cpu().numpy()

        found = get_val_data(cfg.data.data_root, targets,
                             cfg.model.image_size)
        missing = sorted(set(targets) - {name for name, *_ in found})
        if missing:
            # a typoed target or wrong data_root must not read as a clean
            # run with the metric silently absent
            warnings.warn(f"verification targets without a .bin under "
                          f"{cfg.data.data_root}: {missing}")
        for name, data_set, issame in found:
            vacc, vstd, xnorm, thr, (fpr, tpr) = perform_val(
                embed, data_set, issame, embedding_size=cfg.model.dim,
                return_roc=True)
            buffer_val(logger, name, vacc, vstd, xnorm, thr,
                       gen_roc_plot(fpr, tpr), batch=0)
            report[f"{name}_verification_acc"] = vacc
        logger.finish()
    print(json.dumps(report, indent=2))
    if cfg.outdir:
        os.makedirs(cfg.outdir, exist_ok=True)
        with open(os.path.join(cfg.outdir, "class_accuracy.txt"), "w") as fh:
            for c, a in class_acc.items():
                fh.write(f"{c}\t{a:.2f}\n")
        with open(os.path.join(cfg.outdir, "report.json"), "w") as fh:
            json.dump({**report, "class_acc": class_acc}, fh, indent=2)
    return report


if __name__ == "__main__":
    main()
