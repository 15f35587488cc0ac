#!/bin/bash
# Port of the JAX package's scripts/test.sh: the same flags, run by
# gslora_tpu_torch's CLIs (on the GPU; append --device cpu through
# GSLORA_EXTRA_ARGS to run on the CPU).
# Checkpoint accuracy harness (mirrors reference scripts/test_sub.sh)
set -e
# GSLORA_EXTRA_ARGS: optional extra/override flags appended to the
# python invocation (last occurrence wins in argparse) — used by the
# smoke suite (tests/test_torch_scripts.py) to shrink runs; empty by default.
CKPT=${1:?usage: test.sh <ckpt> [outdir]}
python -m gslora_tpu_torch.cli.test_model -d casia100 -n VIT --vit_depth 6 \
    --head CosFace --lora_rank 8 -r "$CKPT" -b 240 \
    --outdir "${2:-./exps/test_out}" $GSLORA_EXTRA_ARGS
