"""Continual forgetting entry point, the flagship (port of
gslora_tpu/cli/train_forget_cl.py; reference train/train_own_forget_cl.py,
recipe scripts/run_cl_forget.sh).

Usage (GS-LoRA++ main-table recipe):
  python -m gslora_tpu_torch.cli.train_forget_cl --one_stage --num_tasks 4 \
      --num_of_first_cls 80 --per_forget_cls 20 --few_shot --few_shot_num 4 \
      --lr 1e-2 -b 4 -e 100 --BND 105 --cl_beta_list 0.3 0.4 0.28 0.2 \
      --prototype --BND_pro 50 --cl_prof_list 0.015 0.06 0.025 0.012 \
      --average_weight --ema_epoch 30 [--structure_mode prox] [--device cpu]

ImageNet-100 with ViT-B/16 (recipe scripts/run_cl_forget_image.sh):
  python -m gslora_tpu_torch.cli.train_forget_cl --one_stage -b 48 \
      -d imagenet100 -n VIT_B16 --head Softmax --lora_rank 8 --lr 1e-2 \
      --BND 10 --alpha 1e-4 --num_tasks 4 --num_of_first_cls 80 \
      --per_forget_cls 20 --cl_beta_list 0.15 0.15 0.15 0.15 \
      -r <torchvision vit_b_16 .pth> [--imagenet_miss_root <held-out dir>]
  The resumed 1000-way head is cut down to the run's 100 classes by
  <data_root>/imagenet_folder_names.txt; with --imagenet_miss_root the
  held-out classes are scored with the 1000-way head put back, before and
  after (logged as imagenet-val-miss_{before,after}).

Runs on the GPU unless ``--device cpu`` is given; ``-r`` resumes as in
cli/common.build_params. Only the GS-LoRA(++) method is ported
(``--one_stage``, or no baseline flag): the baseline zoo and ``--dp``
raise. ``--profile_dir`` is accepted and ignored, as by the JAX CLI.
"""
from __future__ import annotations

import json
import os

from gslora_tpu_torch.cli.common import (build_datasets,
                                         build_missing_dataset, build_params,
                                         param_summary, prepare_imagenet_head)
from gslora_tpu_torch.config import build_parser, config_from_args
from gslora_tpu_torch.data.pipeline import BatchLoader
from gslora_tpu_torch.data.splits import make_order_list
from gslora_tpu_torch.engine.continual import (detached,
                                               run_continual_forgetting)
from gslora_tpu_torch.engine.evaluate import eval_accuracy, make_eval_step
from gslora_tpu_torch.engine.loop import _dtype, resolve_device
from gslora_tpu_torch.metrics.logging import MetricLogger, make_run_name
from gslora_tpu_torch.models.vit_imagenet import resume_head


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if cfg.baseline.method != "gs_lora" and not args.one_stage:
        raise NotImplementedError(
            f"method {cfg.baseline.method!r}: the continual baseline zoo "
            "(ROADMAP Slice 5) is not ported yet (GS-LoRA only)")
    if args.dp:
        raise NotImplementedError("--dp (data parallel, ROADMAP Slice 7) is "
                                  "not ported yet")
    if args.gemm_impl == "int8":
        raise NotImplementedError("gemm_impl='int8' (an eval and serving "
                                  "path) is not ported yet")
    device = resolve_device(cfg.device)  # no card when asked for: fail first
    train_ds, test_ds = build_datasets(cfg)
    order = make_order_list(cfg.model.num_class, seed=cfg.data.seed)
    params = build_params(cfg)
    # ImageNet-100: cut a resumed 1000-way torchvision head down to the
    # run's classes; keep the original for the missing-class eval
    # (reference modify_head / resume_head flow, cl.py:180-312)
    original_head = miss_ds = None
    if cfg.data.data_mode == "imagenet100":
        params, original_head = prepare_imagenet_head(cfg, params, train_ds)
        if args.imagenet_miss_root and original_head is not None:
            miss_ds = build_missing_dataset(cfg, args.imagenet_miss_root)
    print("params:", json.dumps(param_summary(params)))
    logger = MetricLogger(use_wandb=cfg.log_wandb, outdir=cfg.outdir,
                          config=json.loads(cfg.to_json()))

    # one eval step for both missing-class evals, padded batches on the
    # card as every eval of the port
    miss_ev = make_eval_step(cfg.model, cfg.lora, compute_dtype=_dtype(cfg))

    def missing_acc(tag, p):
        """Held-out-class accuracy with the 1000-way head put back
        (cl.py:294-312, :1738-1763)."""
        if miss_ds is None:
            return None
        acc = eval_accuracy(
            miss_ev, detached(resume_head(p, original_head), device),
            BatchLoader(miss_ds, cfg.data.batch_size, shuffle=False,
                        prefetch=0, mask_padding=device.type != "cpu"))
        print(f"missing-class acc {tag}: {acc:.2f}%")
        logger.log({f"imagenet-val-miss_{tag}": acc})
        return acc

    missing_acc("before", params)
    out = run_continual_forgetting(cfg, params, train_ds, test_ds, order,
                                   logger=logger, workdir=cfg.outdir)
    missing_acc("after", out.final_params)
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
