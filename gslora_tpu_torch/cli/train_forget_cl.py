"""Continual forgetting entry point, the flagship (port of
gslora_tpu/cli/train_forget_cl.py; reference train/train_own_forget_cl.py,
recipe scripts/run_cl_forget.sh).

Usage (GS-LoRA++ main-table recipe):
  python -m gslora_tpu_torch.cli.train_forget_cl --one_stage --num_tasks 4 \
      --num_of_first_cls 80 --per_forget_cls 20 --few_shot --few_shot_num 4 \
      --lr 1e-2 -b 4 -e 100 --BND 105 --cl_beta_list 0.3 0.4 0.28 0.2 \
      --prototype --BND_pro 50 --cl_prof_list 0.015 0.06 0.025 0.012 \
      --average_weight --ema_epoch 30 [--structure_mode prox] [--device cpu]

Runs on the GPU unless ``--device cpu`` is given; ``-r`` resumes as in
cli/common.build_params. Only the GS-LoRA(++) method is ported
(``--one_stage``, or no baseline flag): the baseline zoo, ``imagenet100``,
``--dp`` and ``--profile_dir`` raise.
"""
from __future__ import annotations

import json
import os

from gslora_tpu_torch.cli.common import build_datasets, build_params, \
    param_summary
from gslora_tpu_torch.config import build_parser, config_from_args
from gslora_tpu_torch.data.splits import make_order_list
from gslora_tpu_torch.engine.continual import run_continual_forgetting
from gslora_tpu_torch.engine.loop import resolve_device
from gslora_tpu_torch.metrics.logging import MetricLogger, make_run_name


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if cfg.baseline.method != "gs_lora" and not args.one_stage:
        raise NotImplementedError(
            f"method {cfg.baseline.method!r}: the continual baseline zoo "
            "(ROADMAP Slice 5) is not ported yet (GS-LoRA only)")
    if cfg.data.data_mode == "imagenet100":
        raise NotImplementedError(
            "imagenet100 (ViT-B/16 head slicing and the missing-class "
            "eval, ROADMAP Slice 4) is not ported yet")
    if args.dp:
        raise NotImplementedError("--dp (data parallel, ROADMAP Slice 7) is "
                                  "not ported yet")
    if args.profile_dir:
        raise NotImplementedError("--profile_dir (profiler trace) is not "
                                  "ported yet")
    resolve_device(cfg.device)  # no card when one is asked for: fail first
    train_ds, test_ds = build_datasets(cfg)
    order = make_order_list(cfg.model.num_class, seed=cfg.data.seed)
    params = build_params(cfg)
    print("params:", json.dumps(param_summary(params)))
    logger = MetricLogger(use_wandb=cfg.log_wandb, outdir=cfg.outdir,
                          config=json.loads(cfg.to_json()))

    out = run_continual_forgetting(cfg, params, train_ds, test_ds, order,
                                   logger=logger, workdir=cfg.outdir)
    report = [{
        "task": t.task, "forget_acc_before": t.result.forget_acc_before,
        "forget_acc": t.result.forget_acc,
        "remain_acc": t.result.remain_acc, "old_acc": t.old_acc,
        "old_acc_before": t.old_acc_before,
        "open_acc": t.result.open_acc,
        "best_H_mean": t.result.best_h, "norm_list": t.result.norm_list,
        "time_to_forget_s": round(t.result.wallclock_s, 2),
    } for t in out.tasks]

    print(json.dumps(report, indent=2))
    if cfg.outdir:
        os.makedirs(cfg.outdir, exist_ok=True)
        with open(os.path.join(cfg.outdir, "report.json"), "w") as fh:
            json.dump(report, fh, indent=2)
    logger.set_run_name(make_run_name(cfg, cl=True))
    logger.finish()
    return report


if __name__ == "__main__":
    main()
