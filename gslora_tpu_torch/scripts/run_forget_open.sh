#!/bin/bash
# Port of the JAX package's scripts/run_forget_open.sh: the same flags, run by
# gslora_tpu_torch's CLIs (on the GPU; append --device cpu through
# GSLORA_EXTRA_ARGS to run on the CPU).
# Single-step OPEN-SET forgetting recipes (mirrors reference
# scripts/run_forget_open.sh): 3-way split — remain / forget / open classes,
# where the open classes are excluded from training and replay entirely and
# only evaluated.
#
# Reference-behavior note: every line of the reference script passes
# --one_stage, and its driver dispatches on one_stage FIRST
# (train_own_forget_open.py:785), so the "--l2 --l2_lambda 0.01 --replay"
# flags on the active line are DEAD — the run that actually executes is the
# one-stage loop with lora_rank 0, i.e. bounded-ascent FULL-MODEL
# fine-tuning ("train all parameters", train_own_forget_open.py:699-706)
# at lr 1e-4 with the default BND=10 / beta=0.03. METHOD=full mirrors that
# literal behavior; METHOD=gs_lora mirrors the commented rank-8 template
# (run_forget_open.sh:13-26).
set -e
# GSLORA_EXTRA_ARGS: optional extra/override flags appended to the
# python invocation (last occurrence wins in argparse) — used by the
# smoke suite (tests/test_torch_scripts.py) to shrink runs; empty by default.
NUM_FIRST_CLS=70
PER_FORGET_CLS=$((100 - NUM_FIRST_CLS))
RATIO=0.1
OPEN=40
EPOCH=100
CKPT=${1:?usage: run_forget_open.sh <pretrained_ckpt> [gs_lora|full]}
METHOD=${2:-full}

if [ "$METHOD" = "gs_lora" ]; then
    # GS-LoRA single-step open (run_forget_open.sh:13-26 template)
    for lr in 1e-2; do for beta in 0.1; do for alpha in 0; do
    python -m gslora_tpu_torch.cli.train_forget -b 48 -d casia100 -n VIT -e $EPOCH \
        --head CosFace --group_type block --data_ratio $RATIO --alpha_epoch 0 \
        --open_cls_num $OPEN \
        --outdir ./exps/forget-open/ratio${RATIO}start${NUM_FIRST_CLS}forget${PER_FORGET_CLS}lr${lr}beta${beta}alpha${alpha}open${OPEN} \
        --warmup-epochs 0 --lr $lr --lora_rank 8 --decay-epochs $EPOCH \
        --vit_depth 6 --num_of_first_cls $NUM_FIRST_CLS \
        --per_forget_cls $PER_FORGET_CLS -r "$CKPT" \
        --BND 110 --beta $beta --alpha $alpha --min-lr 1e-5 $GSLORA_EXTRA_ARGS
    done; done; done
else
    # The reference's ACTIVE open-set config (run_forget_open.sh:29-42):
    # one-stage, lora_rank 0 -> all 19.2M params train under the dual-batch
    # bounded loss; default BND/beta; the dead --l2/--replay flags are
    # intentionally not carried over.
    for lr in 1e-4; do
    python -m gslora_tpu_torch.cli.train_forget -b 48 -d casia100 -n VIT \
        -e $EPOCH --head CosFace --group_type block --data_ratio $RATIO \
        --alpha_epoch 0 --open_cls_num $OPEN \
        --outdir ./exps/forget-open/full-ratio${RATIO}start${NUM_FIRST_CLS}forget${PER_FORGET_CLS}lr${lr}open${OPEN} \
        --warmup-epochs 0 --lr $lr --lora_rank 0 --decay-epochs $EPOCH \
        --vit_depth 6 --num_of_first_cls $NUM_FIRST_CLS \
        --per_forget_cls $PER_FORGET_CLS -r "$CKPT" \
        --min-lr 1e-5 $GSLORA_EXTRA_ARGS
    done
fi
