#!/bin/bash
# Port of the JAX package's scripts/run_forget.sh: the same flags, run by
# gslora_tpu_torch's CLIs (on the GPU; append --device cpu through
# GSLORA_EXTRA_ARGS to run on the CPU).
# Single-step GS-LoRA++ forgetting, few-shot recipe
# (mirrors reference scripts/run_forget.sh:35-56)
set -e
# GSLORA_EXTRA_ARGS: optional extra/override flags appended to the
# python invocation (last occurrence wins in argparse) — used by the
# smoke suite (tests/test_torch_scripts.py) to shrink runs; empty by default.
NUM_FIRST_CLS=90
PER_FORGET_CLS=10
EPOCH=100
CKPT=${1:?usage: run_forget.sh <pretrained_ckpt>}

for lr in 1e-2; do for shot in 2; do for beta in 0.15; do for alpha in 0.01; do
for fpweight in 0.5; do
python -m gslora_tpu_torch.cli.train_forget -b 4 -d casia100 -n VIT -e $EPOCH \
    --head CosFace --group_type block --data_ratio 0.1 --alpha_epoch 20 \
    --outdir ./exps/forget/few${shot}_lr${lr}_beta${beta}_alpha${alpha} \
    --warmup-epochs 0 --lr $lr --lora_rank 8 --decay-epochs $EPOCH \
    --vit_depth 6 --num_of_first_cls $NUM_FIRST_CLS \
    --per_forget_cls $PER_FORGET_CLS -r "$CKPT" \
    --BND 110 --beta $beta --alpha $alpha --min-lr 1e-5 \
    --warmup_alpha --big_alpha $alpha \
    --prototype --pro_f_weight $fpweight --pro_r_weight 0 \
    --average_weight --ema_epoch 50 --ema_decay 0.9 \
    --few_shot --few_shot_num $shot --aug_num 5 $GSLORA_EXTRA_ARGS
done; done; done; done; done
