#!/bin/bash
# Port of the JAX package's scripts/run_cl_forget.sh: the same flags, run by
# gslora_tpu_torch's CLIs (on the GPU; append --device cpu through
# GSLORA_EXTRA_ARGS to run on the CPU).
# Continual GS-LoRA++ — the main-table recipe
# (mirrors reference scripts/run_cl_forget.sh:6-22: 4 tasks, start 80 /
# forget 20 per task, few-shot 4, per-task beta + prototype weights)
set -e
# GSLORA_EXTRA_ARGS: optional extra/override flags appended to the
# python invocation (last occurrence wins in argparse) — used by the
# smoke suite (tests/test_torch_scripts.py) to shrink runs; empty by default.
CKPT=${1:?usage: run_cl_forget.sh <pretrained_ckpt>}

python -m gslora_tpu_torch.cli.train_forget_cl --one_stage -b 4 -d casia100 \
    -n VIT -e 100 --head CosFace \
    --outdir ./exps/cl_forget/gs_lora_pp \
    --warmup-epochs 0 --lr 1e-2 --lora_rank 8 --decay-epochs 100 \
    --vit_depth 6 --num_of_first_cls 80 --per_forget_cls 20 \
    -r "$CKPT" --num_tasks 4 \
    --BND 105 --cl_beta_list 0.3 0.4 0.28 0.2 --alpha 1e-4 --alpha_epoch 0 \
    --min-lr 1e-5 \
    --prototype --BND_pro 50 --cl_prof_list 0.015 0.06 0.025 0.012 \
    --pro_r_weight 0 \
    --average_weight --ema_epoch 30 --ema_decay 0.9 \
    --few_shot --few_shot_num 4 $GSLORA_EXTRA_ARGS

# ---- baseline templates (reference keeps these commented the same way) ----
# retrain: ... train_forget_cl --retrain --lora_rank 0 --num_tasks 4 ...
# l2/ewc/mas: ... --l2 --l2_lambda 0.1 | --ewc --ewc_lambda 0.1 | --MAS ...
# lwf: ... --Lwf --Lwf_lambda_remain 2 ...
# der/der++: ... --Der --DER_lambda 0.1 [--DER_plus --DER_plus_lambda 0.1]
# fdr: ... --FDR --FDR_lambda 0.1 ...
# scrub: ... --SCRUB --sgda_learning_rate 1e-4 --SCRUB_superepoch 10 ...
# lirf: ... --LIRF --LIRF_T 10 --LIRF_alpha 0.1 ...
