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

Baselines (the same per-task class windows, per-task checkpoints and
old-class eval): ``--retrain``, ``--replay``, ``--l2``, ``--ewc``,
``--MAS``, ``--Lwf``, ``--Der``, ``--DER_plus``, ``--FDR``, ``--SCRUB``,
``--LIRF`` instead of ``--one_stage``, e.g.
  python -m gslora_tpu_torch.cli.train_forget_cl --ewc -b 48 -e 100 \
      --num_tasks 4 --num_of_first_cls 80 --per_forget_cls 20 \
      --open_cls_num 10 --lora_rank 0 -r <pretrained.pth> [--device cpu]

Runs on the GPU unless ``--device cpu`` is given; ``-r`` resumes as in
cli/common.build_params. ``--dp`` runs every method data-parallel over
torch.distributed ranks, one per card (``torchrun --nproc_per_node N -m
gslora_tpu_torch.cli.train_forget_cl --dp ...``; engine/continual for
GS-LoRA(++) and ``--one_stage``, :func:`run_baseline_continual` for the
baselines), each rank loading its rows of every global batch; every
method takes ``--mesh_slices S`` (the outer dcn data axis) and
``--mesh_data D`` meshes smaller than the world, whose other ranks leave
at once (``rank r idle``). GS-LoRA (``--one_stage``) also runs on JAX's
whole ``(dcn, data, model)`` mesh: ``--mesh_model M``, ``--tp``,
``--fsdp``, ``--sp`` (parallel/sharding) and ``--pp [--pp_micro N]``
(parallel/pipeline; the prox step under ``--tp`` or ``--pp`` raises JAX's
ValueError); the baselines on the same mesh but ``--pp`` (JAX's
ValueError), e.g. on the CPU
  torchrun --nproc_per_node 4 -m gslora_tpu_torch.cli.train_forget_cl \
      --device cpu --dp --SCRUB --fsdp --mesh_model 2 ...
Every ``-n`` and ``--lora_pos`` runs under every layout.
``--gemm_impl int8`` raises the model's ValueError at the first training
step, as in the JAX CLI (int8 is an eval and serving path).
``--profile_dir`` is accepted and ignored, as by the JAX CLI.
"""
from __future__ import annotations

import dataclasses
import json
import os

import torch

from gslora_tpu_torch.baselines.distill import run_distill_task
from gslora_tpu_torch.baselines.lirf import run_lirf_task
from gslora_tpu_torch.baselines.regularization import (
    estimate_importance, run_regularization_task)
from gslora_tpu_torch.baselines.scrub import run_scrub_task
from gslora_tpu_torch.checkpoints.io import save_task_checkpoint
from gslora_tpu_torch.cli.common import (build_datasets,
                                         build_missing_dataset, build_params,
                                         idle_rank, prepare_imagenet_head)
from gslora_tpu_torch.config import RunConfig, build_parser, \
    config_from_args
from gslora_tpu_torch.data.folders import ConcatDataset
from gslora_tpu_torch.data.pipeline import CyclingLoader
from gslora_tpu_torch.data.splits import (make_order_list, random_relabel,
                                          split_by_class_window,
                                          task_windows, unique_classes)
from gslora_tpu_torch.engine.continual import (detached,
                                               run_continual_forgetting,
                                               split_task_data)
from gslora_tpu_torch.engine.evaluate import eval_accuracy, make_eval_step
from gslora_tpu_torch.engine.loop import _dtype, resolve_device
from gslora_tpu_torch.metrics.logging import MetricLogger, make_run_name
from gslora_tpu_torch.models.vit_imagenet import resume_head
from gslora_tpu_torch.parallel import sharding
from gslora_tpu_torch.parallel.mesh import (check_baseline_placement,
                                            check_batch_divisible,
                                            check_placement, make_mesh)
from gslora_tpu_torch.parallel.multihost import process_sharded_loader
from gslora_tpu_torch.utils.params import param_summary


def run_baseline_continual(cfg: RunConfig, params, train_ds, test_ds,
                           order, logger, workdir, mesh=None):
    """The task loop of every method but GS-LoRA, on ``cfg.device``
    (JAX ``run_baseline_continual``, cli/train_forget_cl.py:42-234).
    Returns (per-task results, final parameter tree).

    ``mesh``: an optional parallel/mesh.DataMesh, passed to every task
    runner as JAX passes its mesh: every loader, train and test, gives
    this rank's rows of the global batches (the relabeling and the
    subsets are drawn on the whole dataset first, with the same seeds on
    every rank), the evals sum their counts over the ranks, and rank 0
    alone writes the task snapshots. The trees between the tasks are
    whole on every rank; each runner keeps its shards of them under the
    mesh's layout (tp, fsdp, sp, a model axis) and returns them whole,
    and the old-class eval runs on this rank's shards."""
    f, b = cfg.forget, cfg.baseline
    method = b.method
    device = resolve_device(cfg.device)
    eval_step = make_eval_step(cfg.model, cfg.lora,
                               compute_dtype=_dtype(cfg))
    bs = cfg.data.batch_size
    test_bs = bs * cfg.data.test_batch_scale
    check_batch_divisible(mesh, bs)
    # static batch shapes on the card and under a mesh
    pad = mesh is not None or device.type != "cpu"
    main_rank = mesh is None or mesh.is_main

    def loader(ds, batch_size, **kw):
        return process_sharded_loader(mesh, ds, batch_size, mask_padding=pad,
                                      uint8_transfer=cfg.data.uint8_transfer,
                                      **kw)

    def test_loader(ds):
        return lambda: loader(ds, test_bs, shuffle=False, prefetch=0)

    def importance(params, ds):
        return estimate_importance(
            method, detached(params, device),
            loader(ds, bs, shuffle=False, prefetch=0), cfg.model, cfg.lora,
            _dtype(cfg), grad_accum=cfg.optim.grad_accum, mesh=mesh)

    results = []
    anchors, importances = [], []
    lam = {"l2": b.l2_lambda, "ewc": b.ewc_lambda,
           "mas": b.mas_lambda}.get(method, 0.0)
    # state across tasks: the reference creates the distill / SCRUB
    # teacher, the SWA model and the four LIRF models once before the task
    # loop (train_own_forget_cl.py:330-476, loop at :515); every task
    # anchors to the ORIGINAL pretrained model
    pretrained = params
    scrub_swa, scrub_teacher, scrub_n_avg = None, None, 0
    lirf_carry = None

    for task in range(f.num_tasks):
        # the per-task split of GS-LoRA: the paper's tables compare the
        # methods on the same windows and subsets
        data, old_te = split_task_data(cfg, train_ds, test_ds, order, task,
                                       cfg.data.seed + task)
        forget_sub, remain_sub = data.train_forget, data.train_remain
        tbf, tbr = test_loader(data.test_forget), test_loader(data.test_remain)
        tbo = test_loader(data.test_open) if data.test_open is not None \
            and len(data.test_open) else None
        relabeled = random_relabel(forget_sub, cfg.model.num_class,
                                   seed=cfg.data.seed + task)
        fl = loader(relabeled, bs, seed=cfg.data.seed + task)
        rl = loader(remain_sub, bs, seed=cfg.data.seed + task + 1)
        common = dict(logger=logger, test_batches_open=tbo, mesh=mesh)

        if method in ("l2", "ewc", "mas"):
            if task == 0:
                anchors.append(params)
                names, n_cls = unique_classes(remain_sub)
                if main_rank:
                    print("importance class", names, n_cls)  # :707
                importances.append(importance(params, remain_sub))
            out = run_regularization_task(
                cfg, params, lambda: iter(fl), tbf, tbr, lam=lam,
                anchors=anchors, importances=importances, **common)
            params = out["params"]
            if task < f.num_tasks - 1:
                # the next task's importance over its FULL remain split
                # (cl.py:1637-1692)
                anchors.append(params)
                importances.append(importance(
                    params, next_remain(cfg, train_ds, order, task + 1)))
        elif method == "retrain":
            fresh = build_params(dataclasses.replace(cfg, resume=""),
                                 seed=cfg.data.seed + 7 + task)
            out = run_regularization_task(
                cfg, fresh, lambda: iter(rl), tbf, tbr, lam=0.0,
                anchors=[], importances=[], **common)
            params = out["params"]
        elif method == "replay":
            tl = loader(ConcatDataset(relabeled, remain_sub), bs,
                        seed=cfg.data.seed + task)
            out = run_regularization_task(
                cfg, params, lambda: iter(tl), tbf, tbr, lam=0.0,
                anchors=[], importances=[], **common)
            params = out["params"]
        elif method in ("lwf", "der", "der_plus", "fdr"):
            # teacher = the pretrained model, every task (cl.py:453-476)
            out = run_distill_task(cfg, params, pretrained, lambda: iter(fl),
                                   CyclingLoader(rl), tbf, tbr, **common)
            params = out["params"]
        elif method == "scrub":
            # SCRUB takes the TRUE labels of the forget set
            fl_true = loader(forget_sub, bs, seed=cfg.data.seed + task)
            out = run_scrub_task(
                cfg, params, lambda: iter(fl_true), lambda: iter(rl), tbf,
                tbr, teacher=(scrub_teacher if scrub_teacher is not None
                              else pretrained),
                swa=scrub_swa, n_averaged=scrub_n_avg, **common)
            params = out["params"]
            # SWA and teacher persist across tasks (cl.py:441-451)
            scrub_teacher, scrub_swa = out["teacher"], out["swa"]
            scrub_n_avg = out["n_averaged"]
        elif method == "lirf":
            out = run_lirf_task(cfg, params, lambda: iter(fl),
                                CyclingLoader(rl), tbf, tbr, carry=lirf_carry,
                                **common)
            lirf_carry = {k: out[k] for k in ("teacher", "student_low",
                                               "deposit_low")}
            params = {"base": lirf_model(out["teacher"], out["student_low"],
                                         cfg.model.depth // 2),
                      # any LoRA was folded into the teacher at the first
                      # task: carrying it on would apply it twice
                      "lora": {}}
        else:
            raise ValueError(f"unknown method {method}")

        old_acc = None
        if old_te is not None and len(old_te):
            old_acc = eval_accuracy(
                eval_step, sharding.shard_tree(mesh, detached(params, device)),
                test_loader(old_te)(), mesh=mesh)
        out["old_acc"] = old_acc
        for key in ("params", "swa", "student_low", "deposit_low",
                    "teacher"):
            out.pop(key, None)
        results.append({"task": task, **out})
        if workdir and main_rank:
            save_task_checkpoint(workdir, task, params, extra=results[-1])
    return results, params


def next_remain(cfg: RunConfig, train_ds, order, task: int):
    """The FULL remain split of ``task``'s window, over which the reg
    family takes that task's importance (cl.py:1637-1692; the closed-set
    window even under --open_cls_num, as in the reference)."""
    f = cfg.forget
    s1, e1, _, _ = task_windows(f.num_of_first_cls, f.per_forget_cls, task)
    remain, _ = split_by_class_window(train_ds, order, s1, e1, 0, 0)
    return remain


def lirf_model(teacher, student_low, half: int):
    """LIRF's deployable model, teacher_up(student_low): the teacher with
    the student's patch, CLS, pos-embed and low blocks put in."""
    base = dict(teacher)
    base["blocks"] = _put_low(teacher["blocks"], student_low["blocks"],
                              half)
    for k in ("patch", "cls_token", "pos_embed"):
        base[k] = student_low[k]
    return base


def _put_low(blocks, low, half):
    return {k: _put_low(v, low[k], half) if isinstance(v, dict)
            else torch.cat([low[k].detach(), v[half:]]) for k, v in
            blocks.items()}


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    gs_lora = cfg.baseline.method == "gs_lora" or args.one_stage
    # the parallel flags are checked before any process group is made, by
    # the baseline runners' guard for a baseline
    mesh = make_mesh(cfg.mesh, cfg.device, dp=args.dp,
                     check=check_placement if gs_lora
                     else check_baseline_placement)
    if idle_rank(mesh):
        return None
    if mesh is not None:
        cfg = dataclasses.replace(cfg, device=str(mesh.device))
    main_rank = mesh is None or mesh.is_main
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
    if main_rank:
        print("params:", json.dumps(param_summary(params)))
    logger = MetricLogger(use_wandb=cfg.log_wandb and main_rank,
                          outdir=cfg.outdir if main_rank else None,
                          config=json.loads(cfg.to_json()))

    # one eval step for both missing-class evals, padded batches on the
    # card as every eval of the port
    miss_ev = make_eval_step(cfg.model, cfg.lora, compute_dtype=_dtype(cfg))

    def missing_acc(tag, p):
        """Held-out-class accuracy with the 1000-way head put back
        (cl.py:294-312, :1738-1763), on this rank's shards of the whole
        tree ``p`` (under a model axis the 1000 classes split over it, as
        the run's head does)."""
        if miss_ds is None:
            return None
        acc = eval_accuracy(
            miss_ev, sharding.shard_tree(mesh, detached(
                resume_head(p, original_head), device)),
            process_sharded_loader(mesh, miss_ds, cfg.data.batch_size,
                                   shuffle=False, prefetch=0,
                                   mask_padding=device.type != "cpu"),
            mesh=mesh)
        if main_rank:
            print(f"missing-class acc {tag}: {acc:.2f}%")
        logger.log({f"imagenet-val-miss_{tag}": acc})
        return acc

    missing_acc("before", params)
    if gs_lora:
        out = run_continual_forgetting(cfg, params, train_ds, test_ds, order,
                                       logger=logger, workdir=cfg.outdir,
                                       mesh=mesh)
        final_params = out.final_params
        report = [{
            "task": t.task, "forget_acc_before": t.result.forget_acc_before,
            "forget_acc": t.result.forget_acc,
            "remain_acc": t.result.remain_acc, "old_acc": t.old_acc,
            "old_acc_before": t.old_acc_before,
            "open_acc": t.result.open_acc,
            "best_H_mean": t.result.best_h, "norm_list": t.result.norm_list,
            "time_to_forget_s": round(t.result.wallclock_s, 2),
        } for t in out.tasks]
    else:
        report, final_params = run_baseline_continual(
            cfg, params, train_ds, test_ds, order, logger, cfg.outdir,
            mesh=mesh)
    missing_acc("after", final_params)

    if main_rank:
        print(json.dumps(report, indent=2))
        if cfg.outdir:
            os.makedirs(cfg.outdir, exist_ok=True)
            with open(os.path.join(cfg.outdir, "report.json"), "w") as fh:
                json.dump(report, fh, indent=2)
    logger.set_run_name(make_run_name(cfg, cl=True))
    logger.finish()
    if mesh is not None:
        mesh.barrier()  # rank 0's files are complete for every rank
    return report


if __name__ == "__main__":
    main()
