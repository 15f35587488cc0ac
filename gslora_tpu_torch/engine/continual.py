"""Continual forgetting task loop, GS-LoRA / GS-LoRA++ (port of
gslora_tpu/engine/continual.py; reference train_own_forget_cl.py:515-1763,
the one_stage method).

Task boundary: the reference saves the eval-mode (loralib-MERGED)
state_dict at task end and re-loads + LoRA-reinits at the next task start
(:523-536, :1696-1714). Here that is the fold ``base <- merged(base,
lora); lora <- reinit`` with no file round-trip; task snapshots are still
written. The parameters live on ``cfg.device`` for the whole run. Under a
``(dcn, data, model)`` mesh every rank runs the task loop on the rows of
its batch block and on its shards of the parameters (parallel/sharding), the
boundaries included: the fold adds each shard's part of B@A, the reinit
draws each whole A from one identically seeded generator and keeps the
rank's shard, so the ranks keep one set of parameters; rank 0 alone
writes the snapshots, gathered. Under sp without tp the LoRA stays whole
on every rank, so the prox (K2) runs on it there; under pp (the loss
mode only, as in JAX) each stage folds and reinits its own layers.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from gslora_tpu_torch.checkpoints.io import save_task_checkpoint
from gslora_tpu_torch.config import RunConfig
from gslora_tpu_torch.data.folders import Dataset
from gslora_tpu_torch.data.splits import (few_shot_subset, open_task_windows,
                                          ratio_subset,
                                          split_by_class_window,
                                          task_windows)
from gslora_tpu_torch.engine.ema import merged_params
from gslora_tpu_torch.engine.evaluate import eval_accuracy, make_eval_step
from gslora_tpu_torch.engine.loop import ForgetData, ForgetResult, _dtype, \
    resolve_device, run_forget_training
from gslora_tpu_torch.engine.prototypes import calculate_prototypes
from gslora_tpu_torch.lora.core import reinit_lora
from gslora_tpu_torch.metrics.logging import MetricLogger
from gslora_tpu_torch.models.convert import flatten_tree
from gslora_tpu_torch.ops import attention as A
from gslora_tpu_torch.ops import group_lasso as G
from gslora_tpu_torch.parallel import sharding
from gslora_tpu_torch.parallel.mesh import data_parallel_size, set_active
from gslora_tpu_torch.parallel.multihost import process_sharded_loader

PROTO_BATCH = 500  # per-task prototype batch (cl.py:634-644)


@dataclass
class TaskResult:
    task: int
    result: ForgetResult
    old_acc: Optional[float] = None
    # old-class accuracy right AFTER the task-boundary fold and BEFORE
    # this task trains: separates what the fold (merge + reinit) does to
    # previously forgotten classes from what this task's training does
    old_acc_before: Optional[float] = None
    # seconds from the task's start (before the fold) to its end (after
    # the old-class eval and the snapshot), the device synchronized
    wall_s: Optional[float] = None
    # the kernels' launches in those seconds (:func:`kernel_launches`)
    launches: Optional[Dict[str, int]] = None


def kernel_launches() -> Dict[str, int]:
    """The kernels' launch counters: K1 forward and backward in bf16
    (``attention_*``) and fp32 (``attention_*_fp32``), and the group
    kernels. Plain versions count nothing, so on the CPU all stay 0."""
    return {"attention_fwd": A.FWD_BY_DTYPE[torch.bfloat16],
            "attention_bwd": A.BWD_BY_DTYPE[torch.bfloat16],
            "attention_fwd_fp32": A.FWD_BY_DTYPE[torch.float32],
            "attention_bwd_fp32": A.BWD_BY_DTYPE[torch.float32],
            "group_prox": G.PROX_LAUNCHES, "group_norms": G.NORMS_LAUNCHES,
            "group_scale": G.SCALE_LAUNCHES}


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class ContinualResult:
    tasks: List[TaskResult] = field(default_factory=list)
    final_params: Any = None


def split_task_data(cfg: RunConfig, train_ds: Dataset, test_ds: Dataset,
                    order_list: List[int], task: int, seed: int
                    ) -> tuple[ForgetData, Optional[Dataset]]:
    """Per-task window split + few-shot/ratio subsetting
    (train_own_forget_cl.py:546-750). Returns (data, test_old)."""
    f = cfg.forget
    test_open = None
    if f.open_cls_num > 0:
        # open classes live at the front of the order list and are never
        # replayed (train_own_forget_cl_open.py:413-463)
        (s1, e1), (s2, e2), (os_, oe) = open_task_windows(
            f.num_of_first_cls, f.per_forget_cls, f.open_cls_num, task)
        _, test_open = split_by_class_window(test_ds, order_list, 0, 0,
                                             os_, oe)
    else:
        s1, e1, s2, e2 = task_windows(f.num_of_first_cls, f.per_forget_cls,
                                      task)
    remain_train, forget_train = split_by_class_window(train_ds, order_list,
                                                       s1, e1, s2, e2)
    remain_test, forget_test = split_by_class_window(test_ds, order_list,
                                                     s1, e1, s2, e2)
    if f.few_shot:
        # distinct seeds: the forget and remain draws must be uncorrelated
        forget_sub = few_shot_subset(forget_train, f.few_shot_num, seed)
        remain_sub = few_shot_subset(remain_train, f.few_shot_num,
                                     seed + 7919)
    else:
        forget_sub = ratio_subset(forget_train, f.data_ratio, seed)
        remain_sub = ratio_subset(remain_train, f.data_ratio, seed)
    data = ForgetData(train_forget=forget_sub, train_remain=remain_sub,
                      test_forget=forget_test, test_remain=remain_test,
                      test_open=test_open)
    test_old = None
    if task > 0:
        # classes forgotten by earlier tasks: order_list[e2 : NUM_CLASS]
        # (cl.py:543-545 old_st/old_en)
        _, test_old = split_by_class_window(test_ds, order_list, 0, 0, e2,
                                            cfg.model.num_class)
    return data, test_old


def detached(tree, device=None):
    """A tree of plain tensors (parameters detached), moved to device."""
    return {k: detached(v, device) if isinstance(v, dict)
            else v.detach().to(device if device is not None else v.device)
            for k, v in tree.items()}


def run_continual_forgetting(cfg: RunConfig, params, train_ds: Dataset,
                             test_ds: Dataset, order_list: List[int],
                             logger: Optional[MetricLogger] = None,
                             workdir: Optional[str] = None,
                             boundary: str = "merge_reinit",
                             mesh=None) -> ContinualResult:
    """GS-LoRA(++) over cfg.forget.num_tasks tasks on ``cfg.device``.

    ``boundary``: "merge_reinit" (reference semantics: every task after
    the first starts with the fold, merged save + reload + LoRA reinit,
    cl.py:523-536; the reinit draws from one CPU generator seeded with the
    run's seed) or "keep" (the adapters carry over untouched: an A/B knob
    that tells old-class resurfacing caused by the fold from that caused
    by a task's training).

    ``mesh``: an optional parallel/mesh.DataMesh, passed to every task's
    run_forget_training as JAX passes its mesh (continual.py:98-176); the
    old-class evals and the prototypes sum their counts over the batch
    axis (dcn x data). The whole ``params`` are broadcast from rank 0 and
    sharded once; ``final_params`` is the whole tree again, on every
    rank."""
    if boundary not in ("merge_reinit", "keep"):
        raise ValueError(f"boundary must be merge_reinit|keep, "
                         f"got {boundary!r}")
    logger = logger or MetricLogger()
    model, lora, f = cfg.model, cfg.lora, cfg.forget
    device = resolve_device(cfg.device)
    cdt = _dtype(cfg)
    eval_step = make_eval_step(model, lora, compute_dtype=cdt)
    test_bs = cfg.data.batch_size * cfg.data.test_batch_scale
    # static batch shapes on the card and under a mesh
    pad = mesh is not None or device.type != "cpu"
    u8 = cfg.data.uint8_transfer
    out = ContinualResult()
    generator = torch.Generator().manual_seed(cfg.data.seed)
    params = detached(params, device)
    set_active(mesh)
    if mesh is not None:
        mesh.broadcast_(list(flatten_tree(params).values()))
        params = sharding.shard_tree(mesh, params)

    def loader(ds, bs):
        return process_sharded_loader(mesh, ds, bs, shuffle=False,
                                      prefetch=0, mask_padding=pad,
                                      uint8_transfer=u8)

    for task in range(f.num_tasks):
        _synchronize(device)
        t0, launched = time.perf_counter(), kernel_launches()
        if task > 0 and boundary == "merge_reinit":
            # task boundary: fold LoRA into the base, fresh LoRA
            # (reference merged-save + reload + reinit, cl.py:523-536)
            with torch.no_grad():
                params = {
                    "base": merged_params(params["base"], params["lora"],
                                          lora.scaling),
                    "lora": reinit_lora(generator, params["lora"]),
                }
        data, test_old = split_task_data(cfg, train_ds, test_ds, order_list,
                                         task, cfg.data.seed + task)

        def old_eval(p):
            return eval_accuracy(eval_step, p, loader(test_old, test_bs),
                                 mesh=mesh)

        old_acc_before = None
        if test_old is not None and len(test_old) > 0:
            # post-fold, pre-training: a bounce seen HERE is the fold's
            # doing; one seen only after training is the task's
            old_acc_before = old_eval(params)
            logger.log({f"Task {task} old Accuracy before": old_acc_before})

        protos = None
        if f.prototype:
            # prototypes from the CURRENT backbone over the task subsets
            # (cl.py:634-644), in batches the data-parallel ways divide
            # (each row's embedding is its own, so the batch is free)
            ways = data_parallel_size(mesh)
            pbs = -(-PROTO_BATCH // ways) * ways
            pb = list(loader(data.train_forget, pbs)) + \
                list(loader(data.train_remain, pbs))
            protos = calculate_prototypes(params, pb, model, lora,
                                          model.num_class, compute_dtype=cdt,
                                          mesh=mesh)

        beta = f.cl_beta_list[task] if task < len(f.cl_beta_list) else f.beta
        w_pro_f = f.cl_prof_list[task] if task < len(f.cl_prof_list) else \
            f.pro_f_weight

        res = run_forget_training(
            cfg, params, data, logger=logger,
            workdir=f"{workdir}/task_{task}" if workdir else None,
            protos=protos, beta=beta, pro_f_weight=w_pro_f,
            seed_offset=task * 1000,
            h_eps=1e-8,  # CL H-mean guard (engine_cl.py:279)
            continual=True,  # engine_cl: remain drives, no alpha gate
            mesh=mesh, local=True)
        params = detached(res.state.params)

        old_acc = None
        if test_old is not None and len(test_old) > 0:
            old_acc = old_eval(params)
            logger.log({f"Task {task} old Accuracy": old_acc})
        if workdir:
            with torch.no_grad():
                merged = sharding.gather_tree(mesh, merged_params(
                    params["base"], params["lora"], lora.scaling))
        if workdir and (mesh is None or mesh.is_main):
            save_task_checkpoint(
                workdir, task, {"base": merged},
                extra={"task": task, "best_h": res.best_h,
                       "forget_acc": res.forget_acc,
                       "remain_acc": res.remain_acc, "old_acc": old_acc})
        _synchronize(device)
        out.tasks.append(TaskResult(
            task=task, result=res, old_acc=old_acc,
            old_acc_before=old_acc_before, wall_s=time.perf_counter() - t0,
            launches={k: v - launched[k]
                      for k, v in kernel_launches().items()}))

    out.final_params = sharding.gather_tree(mesh, params)
    return out
