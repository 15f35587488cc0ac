"""Single-step GS-LoRA(++) forgetting entry point (port of
gslora_tpu/cli/train_forget.py; reference train/train_own_forget.py).

Usage:
  python -m gslora_tpu_torch.cli.train_forget --net VIT --vit_depth 6 \
      --lora_rank 8 --head CosFace --lr 1e-2 -b 48 -e 100 --BND 110 \
      --beta 0.15 --alpha 0.01 --num_of_first_cls 90 --per_forget_cls 10 \
      [--prototype ...] [--device cpu]

Runs on the GPU unless ``--device cpu`` is given. ``-r`` resumes from a
port checkpoint or a reference-named ``.pth`` (cli/common.build_params);
``--profile_dir`` writes a profiler trace of the run there. Only the
GS-LoRA path is ported: the single-step baselines, ``--dp`` and
``--gemm_impl int8`` raise.
"""
from __future__ import annotations

import json
import os

from gslora_tpu_torch.cli.common import build_datasets, build_params, \
    param_summary
from gslora_tpu_torch.config import build_parser, config_from_args
from gslora_tpu_torch.data.splits import (few_shot_subset, make_order_list,
                                          open_single_windows, ratio_subset,
                                          split_by_class_window)
from gslora_tpu_torch.engine.loop import ForgetData, resolve_device, \
    run_forget_training
from gslora_tpu_torch.metrics.logging import MetricLogger, make_run_name


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    f = cfg.forget
    if cfg.baseline.method != "gs_lora" and not args.one_stage:
        raise NotImplementedError(f"method {cfg.baseline.method!r} is not "
                                  "ported yet (GS-LoRA only)")
    if args.dp:
        raise NotImplementedError("--dp (data parallel) is not ported yet")
    if args.gemm_impl == "int8":
        raise NotImplementedError("gemm_impl='int8' (an eval and serving "
                                  "path) is not ported yet")
    resolve_device(cfg.device)  # no card when one is asked for: fail first
    params = build_params(cfg)

    train_ds, test_ds = build_datasets(cfg)
    order = make_order_list(cfg.model.num_class, seed=cfg.data.seed)

    if f.open_cls_num > 0:
        (rs, re), (fs, fe), (os_, oe) = open_single_windows(
            f.num_of_first_cls, f.per_forget_cls, f.open_cls_num)
    else:
        rs, re = 0, f.num_of_first_cls
        fs, fe = f.num_of_first_cls, f.num_of_first_cls + f.per_forget_cls
        os_ = oe = None

    remain_tr, forget_tr = split_by_class_window(train_ds, order, rs, re,
                                                 fs, fe)
    remain_te, forget_te = split_by_class_window(test_ds, order, rs, re,
                                                 fs, fe)
    test_open = None
    if os_ is not None:
        _, test_open = split_by_class_window(test_ds, order, 0, 0, os_, oe)

    if f.few_shot:
        forget_sub = few_shot_subset(forget_tr, f.few_shot_num,
                                     cfg.data.seed)
        remain_sub = few_shot_subset(remain_tr, f.few_shot_num,
                                     cfg.data.seed + 7919)  # uncorrelated
    else:
        forget_sub = ratio_subset(forget_tr, f.data_ratio, cfg.data.seed)
        remain_sub = ratio_subset(remain_tr, f.data_ratio, cfg.data.seed)

    data = ForgetData(train_forget=forget_sub, train_remain=remain_sub,
                      test_forget=forget_te, test_remain=remain_te,
                      test_open=test_open)

    logger = MetricLogger(use_wandb=cfg.log_wandb, outdir=cfg.outdir,
                          config=json.loads(cfg.to_json()))
    print("params:", json.dumps(param_summary(params)))
    if args.profile_dir:
        # a torch.profiler trace around the whole run (every step and eval)
        from gslora_tpu_torch.utils.profiling import trace
        with trace(args.profile_dir):
            res = run_forget_training(cfg, params, data, logger=logger,
                                      workdir=cfg.outdir)
    else:
        res = run_forget_training(cfg, params, data, logger=logger,
                                  workdir=cfg.outdir)
    # run name assembled from hyperparameters at exit
    # (train_own_forget.py:844-877)
    logger.set_run_name(make_run_name(cfg))

    report = {
        "forget_acc_before": res.forget_acc_before,
        "forget_acc": res.forget_acc, "remain_acc": res.remain_acc,
        "open_acc": res.open_acc, "best_H_mean": res.best_h,
        "norm_list": res.norm_list,
    }
    print(json.dumps(report, indent=2))
    if cfg.outdir:
        with open(os.path.join(cfg.outdir, "report.json"), "w") as fh:
            json.dump(report, fh, indent=2)
    logger.finish()
    return report


if __name__ == "__main__":
    main()
