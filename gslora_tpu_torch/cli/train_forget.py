"""Single-step GS-LoRA(++) forgetting entry point (port of
gslora_tpu/cli/train_forget.py; reference train/train_own_forget.py).

Usage:
  python -m gslora_tpu_torch.cli.train_forget --net VIT --vit_depth 6 \
      --lora_rank 8 --head CosFace --lr 1e-2 -b 48 -e 100 --BND 110 \
      --beta 0.15 --alpha 0.01 --num_of_first_cls 90 --per_forget_cls 10 \
      [--prototype ...] [--device cpu]

Without ``--one_stage``, ``--retrain``, ``--l2``, ``--ewc`` and ``--MAS``
run the baselines of the reference's single-step script
(:func:`run_single_step_baseline`); every other baseline raises
ValueError, as it has no single-step path in the reference either.

Runs on the GPU unless ``--device cpu`` is given. ``-r`` resumes from a
port checkpoint or a reference-named ``.pth`` (cli/common.build_params);
``--profile_dir`` writes a profiler trace of the run there. ``--dp``
trains GS-LoRA (and ``--one_stage``) and the single-step baselines
data-parallel over torch.distributed ranks, one per card:
  torchrun --nproc_per_node N -m gslora_tpu_torch.cli.train_forget --dp ...
each rank loading its rows of every global batch (engine/loop,
:func:`run_single_step_baseline`). Both also run on JAX's
``(data, model)`` mesh, every ``-n`` and ``--lora_pos``: ``--mesh_model
M`` shards the head's classes over ``model``, ``--tp`` the FFN hidden,
``--fsdp`` the block kernels over ``data`` (parallel/sharding), ``--sp``
the activations' tokens over ``model``, ``--pp [--pp_micro N]`` the
layers in stages over ``model`` (parallel/pipeline; GS-LoRA only: a
baseline raises JAX's ValueError), and ``--mesh_slices S`` the outer dcn
data axis over all of them; a mesh smaller than the world
(``--mesh_data``, ``--mesh_model``) leaves the other ranks idle, e.g. on
the CPU
  torchrun --nproc_per_node 4 -m gslora_tpu_torch.cli.train_forget \
      --device cpu --dp --tp --fsdp --mesh_model 2 ...
  torchrun --nproc_per_node 2 -m gslora_tpu_torch.cli.train_forget \
      --device cpu --dp --pp --mesh_model 2 --pp_micro 2 ...
  torchrun --nproc_per_node 8 -m gslora_tpu_torch.cli.train_forget \
      --device cpu --dp --mesh_slices 2 --tp --fsdp --sp --mesh_model 2 ...
``--gemm_impl int8`` raises the model's ValueError at the first training
step, as in the JAX CLI.
"""
from __future__ import annotations

import dataclasses
import json
import os
from functools import partial

from gslora_tpu_torch.baselines.regularization import (
    estimate_importance, run_regularization_task)
from gslora_tpu_torch.cli.common import build_datasets, build_params, \
    idle_rank
from gslora_tpu_torch.config import build_parser, config_from_args
from gslora_tpu_torch.data.folders import ConcatDataset
from gslora_tpu_torch.data.splits import (few_shot_subset, make_order_list,
                                          open_single_windows,
                                          random_relabel, ratio_subset,
                                          split_by_class_window,
                                          unique_classes)
from gslora_tpu_torch.engine.continual import detached
from gslora_tpu_torch.engine.loop import ForgetData, _dtype, \
    resolve_device, run_forget_training
from gslora_tpu_torch.metrics.logging import MetricLogger, make_run_name
from gslora_tpu_torch.parallel.mesh import (check_baseline_placement,
                                            check_batch_divisible,
                                            check_placement, make_mesh)
from gslora_tpu_torch.parallel.multihost import process_sharded_loader
from gslora_tpu_torch.utils.params import param_summary

# The methods the reference's single-step open script runs besides
# --one_stage (train_own_forget_open.py:837-1063); every other one has no
# single-step path there either and raises, never silently running
# GS-LoRA.
SINGLE_STEP_METHODS = ("retrain", "l2", "ewc", "mas")


def single_step_data(cfg, train_ds, test_ds, order) -> ForgetData:
    """The single-step split: remain ``[0, first)`` and forget ``[first,
    first + per)`` of the order list, or the open windows under
    ``--open_cls_num``; the forget and remain training subsets are
    few-shot or ratio draws (train_own_forget_open.py:413-504)."""
    f = cfg.forget
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
    return ForgetData(train_forget=forget_sub, train_remain=remain_sub,
                      test_forget=forget_te, test_remain=remain_te,
                      test_open=test_open)


def importance_split(cfg, train_ds, order):
    """The single-step importance set: the FULL ``[0, first - per)``
    window split, the CL first-task window even under --open_cls_num
    (train_own_forget_open.py:687-698; quirk kept)."""
    f = cfg.forget
    en1 = f.num_of_first_cls - f.per_forget_cls
    imp_ds, _ = split_by_class_window(train_ds, order, 0, en1, en1,
                                      f.num_of_first_cls)
    return imp_ds


def run_single_step_baseline(cfg, train_ds, data: ForgetData, order,
                             logger=None, mesh=None):
    """The reg-family dispatch of the reference's single-step script
    (train_own_forget_open.py:837-1063; JAX cli/train_forget.py:27-125):

    * ``retrain``: the checkpoint resume is skipped (":642 `if
      BACKBONE_RESUME_ROOT and not args.retrain`"), so a fresh model
      trains on the remain subset with lambda 0 (:837-870);
    * ``l2`` / ``ewc`` / ``mas``: anchored at the resumed params, the
      importance taken over the FULL ``[0, first - per)`` window split
      (:687-698, the CL first-task window even under --open_cls_num; quirk
      kept), trained on concat(relabeled forget subset, remain subset)
      (:498-504, :564-573, :1039) under the quadratic penalty.

    ``mesh``: an optional parallel/mesh.DataMesh, passed to the runner as
    JAX passes its mesh: every loader (the remain subset for Retrain, the
    importance batches, relabeled forget + remain, the tests) gives this
    rank's rows of the global batches."""
    b = cfg.baseline
    method = b.method
    if method not in SINGLE_STEP_METHODS:
        raise ValueError(
            f"method {method!r} has no single-step dispatch (the reference "
            "single-step scripts dispatch only one_stage/retrain/l2/ewc/MAS"
            " — train_own_forget_open.py:785,837,1028); run it through "
            "train_forget_cl --num_tasks 1 instead")
    device = resolve_device(cfg.device)
    # static batch shapes on the card and under a mesh
    pad = mesh is not None or device.type != "cpu"
    bs = cfg.data.batch_size
    test_bs = bs * cfg.data.test_batch_scale
    check_batch_divisible(mesh, bs)

    def loader(ds, batch_size, **kw):
        return process_sharded_loader(mesh, ds, batch_size, mask_padding=pad,
                                      uint8_transfer=cfg.data.uint8_transfer,
                                      **kw)

    def test_loader(ds):
        return lambda: loader(ds, test_bs, shuffle=False, prefetch=0)

    tbo = test_loader(data.test_open) \
        if data.test_open is not None and len(data.test_open) else None
    common = dict(logger=logger, test_batches_open=tbo, mesh=mesh)
    if method == "retrain":
        params = build_params(dataclasses.replace(cfg, resume=""))
        rl = loader(data.train_remain, bs, seed=cfg.data.seed)
        out = run_regularization_task(
            cfg, params, lambda: iter(rl), test_loader(data.test_forget),
            test_loader(data.test_remain), lam=0.0, anchors=[],
            importances=[], **common)
    else:
        params = build_params(cfg)
        # importance over the full first-task window split, not the ratio
        # subset
        imp_ds = importance_split(cfg, train_ds, order)
        names, n_cls = unique_classes(imp_ds)
        if mesh is None or mesh.is_main:
            print("importance class", names, n_cls)  # :698 print parity
        importance = estimate_importance(
            method, detached(params, device),
            loader(imp_ds, bs, shuffle=False, prefetch=0), cfg.model,
            cfg.lora, _dtype(cfg), grad_accum=cfg.optim.grad_accum,
            mesh=mesh)
        lam = {"l2": b.l2_lambda, "ewc": b.ewc_lambda,
               "mas": b.mas_lambda}[method]
        relabeled = random_relabel(data.train_forget, cfg.model.num_class,
                                   seed=cfg.data.seed)
        tl = loader(ConcatDataset(relabeled, data.train_remain), bs,
                    seed=cfg.data.seed)
        out = run_regularization_task(
            cfg, params, lambda: iter(tl), test_loader(data.test_forget),
            test_loader(data.test_remain), lam=lam, anchors=[params],
            importances=[importance], **common)
    return {
        "forget_acc_before": out["forget_acc_before"],
        "forget_acc": out["forget_acc"], "remain_acc": out["remain_acc"],
        "open_acc": out["open_acc"], "best_H_mean": out["best_h"],
        "norm_list": None,  # get_norm_of_lora is one_stage-only (:1068)
    }


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    baseline = cfg.baseline.method != "gs_lora" and not args.one_stage
    # the parallel flags are checked before any process group is made, by
    # the baseline runners' guard for a baseline
    mesh = make_mesh(cfg.mesh, cfg.device, dp=args.dp,
                     check=check_baseline_placement if baseline
                     else check_placement)
    if idle_rank(mesh):
        return None
    if mesh is not None:
        cfg = dataclasses.replace(cfg, device=str(mesh.device))
    main_rank = mesh is None or mesh.is_main
    resolve_device(cfg.device)  # no card when one is asked for: fail first
    # a baseline builds its own model (Retrain skips the -r resume)
    params = None if baseline else build_params(cfg)

    train_ds, test_ds = build_datasets(cfg)
    order = make_order_list(cfg.model.num_class, seed=cfg.data.seed)

    data = single_step_data(cfg, train_ds, test_ds, order)

    logger = MetricLogger(use_wandb=cfg.log_wandb and main_rank,
                          outdir=cfg.outdir if main_rank else None,
                          config=json.loads(cfg.to_json()))
    # method dispatch as in the reference script: one_stage first
    # (train_own_forget_open.py:785), then the reg family
    if baseline:
        report = run_single_step_baseline(cfg, train_ds, data, order,
                                          logger=logger, mesh=mesh)
    else:
        if main_rank:
            print("params:", json.dumps(param_summary(params)))
        run = partial(run_forget_training, cfg, params, data, logger=logger,
                      workdir=cfg.outdir, mesh=mesh)
        if args.profile_dir:
            # a torch.profiler trace around the whole run (every step and
            # eval)
            from gslora_tpu_torch.utils.profiling import trace
            with trace(args.profile_dir):
                res = run()
        else:
            res = run()
        report = {
            "forget_acc_before": res.forget_acc_before,
            "forget_acc": res.forget_acc, "remain_acc": res.remain_acc,
            "open_acc": res.open_acc, "best_H_mean": res.best_h,
            "norm_list": res.norm_list,
        }
    # run name assembled from hyperparameters at exit
    # (train_own_forget.py:844-877)
    logger.set_run_name(make_run_name(cfg))
    if main_rank:
        print(json.dumps(report, indent=2))
        if cfg.outdir:
            with open(os.path.join(cfg.outdir, "report.json"), "w") as fh:
                json.dump(report, fh, indent=2)
    logger.finish()
    if mesh is not None:
        mesh.barrier()  # rank 0's files are complete for every rank
    return report


if __name__ == "__main__":
    main()
