#!/bin/bash
# Port of the JAX package's scripts/run_cl_forget_image.sh: the same flags, run by
# gslora_tpu_torch's CLIs (on the GPU; append --device cpu through
# GSLORA_EXTRA_ARGS to run on the CPU).
# Continual forgetting on ImageNet-100 with ViT-B/16
# (mirrors reference scripts/run_cl_forget_image.sh)
set -e
# GSLORA_EXTRA_ARGS: optional extra/override flags appended to the
# python invocation (last occurrence wins in argparse) — used by the
# smoke suite (tests/test_torch_scripts.py) to shrink runs; empty by default.
CKPT=${1:?usage: run_cl_forget_image.sh <vit_b16_ckpt.pth> [miss_root]}
# held-out-class val dirs for the missing-class eval (reference hardcodes
# data/imagenet_val_split/nonexist, train_own_forget_cl.py:163); pass ""
# to skip
MISS=${2-data/imagenet_val_split/nonexist}
MISS_ARGS=()
if [ -n "$MISS" ]; then
    if [ ! -d "$MISS" ] && [ $# -ge 2 ]; then
        # an explicitly-passed nonexistent path is a mistake, not a skip
        echo "miss_root '$MISS' does not exist (pass \"\" to skip)" >&2
        exit 1
    fi
    [ -d "$MISS" ] && MISS_ARGS=(--imagenet_miss_root "$MISS")
fi

python -m gslora_tpu_torch.cli.train_forget_cl --one_stage -b 48 -d imagenet100 \
    -n VIT_B16 -e 100 --head Softmax \
    --outdir ./exps/cl_forget_image/gs_lora \
    --warmup-epochs 0 --lr 1e-2 --lora_rank 8 --decay-epochs 100 \
    --num_of_first_cls 80 --per_forget_cls 20 \
    -r "$CKPT" --num_tasks 4 "${MISS_ARGS[@]}" \
    --BND 10 --cl_beta_list 0.15 0.15 0.15 0.15 --alpha 1e-4 \
    --alpha_epoch 0 --min-lr 1e-5 $GSLORA_EXTRA_ARGS
