#!/bin/bash
# Port of the JAX package's scripts/run_cl_forget_open.sh: the same flags, run by
# gslora_tpu_torch's CLIs (on the GPU; append --device cpu through
# GSLORA_EXTRA_ARGS to run on the CPU).
# Continual open-set forgetting (mirrors reference
# scripts/run_cl_forget_open.sh:1-24: bs 48, BND 105, alpha warmup to 0.015
# at epoch 30, open classes never replayed)
set -e
# GSLORA_EXTRA_ARGS: optional extra/override flags appended to the
# python invocation (last occurrence wins in argparse) — used by the
# smoke suite (tests/test_torch_scripts.py) to shrink runs; empty by default.
CKPT=${1:?usage: run_cl_forget_open.sh <pretrained_ckpt>}

python -m gslora_tpu_torch.cli.train_forget_cl --one_stage -b 48 -d casia100 \
    -n VIT -e 100 --head CosFace \
    --outdir ./exps/cl_forget_open/gs_lora \
    --warmup-epochs 0 --lr 1e-2 --lora_rank 8 --decay-epochs 100 \
    --vit_depth 6 --num_of_first_cls 80 --per_forget_cls 20 \
    -r "$CKPT" --num_tasks 4 --open_cls_num 10 \
    --BND 105 --cl_beta_list 0.14 0.14 0.2 0.15 \
    --warmup_alpha --big_alpha 0.015 --alpha_epoch 30 --min-lr 1e-5 \
    --prototype --pro_f_weight 0.0003 --pro_r_weight 0 $GSLORA_EXTRA_ARGS
