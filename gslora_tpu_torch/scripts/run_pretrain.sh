#!/bin/bash
# Port of the JAX package's scripts/run_pretrain.sh: the same flags, run by
# gslora_tpu_torch's CLIs (on the GPU; append --device cpu through
# GSLORA_EXTRA_ARGS to run on the CPU).
# Pretrain ViT-P8S8 on CASIA-100 (mirrors reference scripts/run_sub.sh:
# CosFace, bs 480, lr 3e-4, 1200 epochs, warmup 10, decay 150)
set -e
# GSLORA_EXTRA_ARGS: optional extra/override flags appended to the
# python invocation (last occurrence wins in argparse) — used by the
# smoke suite (tests/test_torch_scripts.py) to shrink runs; empty by default.
python -m gslora_tpu_torch.cli.train_pretrain -b 480 -d casia100 -n VIT -e 1200 \
    --head CosFace --vit_depth 6 --lora_rank 0 \
    --outdir ./results/ViT-P8S8_casia100_cosface \
    --warmup-epochs 10 --lr 3e-4 --decay-epochs 150 $GSLORA_EXTRA_ARGS
# bs 480 full-model pretrain peaked at 20.93 GB on an NVIDIA H100 80GB HBM3
# at 700 W (PERF.md) — `--remat` or `--grad_accum 4` lower it, or
# raise the effective batch further; dynamics are identical for full
# batches.
