"""Supervised pretraining entry point (port of gslora_tpu/cli/train_pretrain.py;
reference train/train_own.py; recipe scripts/run_pretrain.sh: ViT-P8S8,
CASIA-100, CosFace, bs 480, lr 3e-4).

Usage:
  python -m gslora_tpu_torch.cli.train_pretrain --net VIT --vit_depth 6 \
      --head CosFace -b 480 --lr 3e-4 -e 1200 -d casia100 [--device cpu]

Runs on the GPU unless ``--device cpu`` is given. Trains every parameter;
with ``--lora_rank > 0`` and ``-r`` (a base checkpoint) only the LoRA
trains (train_own.py:385-386). Every 20 batches it evaluates the test
split, saves the best-accuracy checkpoint under ``--outdir`` and runs the
``--ver_targets`` pair verification; then a final eval and
``report.json``.

``--dp`` trains data-parallel over torch.distributed ranks, one per card
(the reference's 8-GPU ``nn.DataParallel`` recipe, train_own.py:403-406):
  torchrun --nproc_per_node N -m gslora_tpu_torch.cli.train_pretrain \
      --dp -b 480 ...
Each rank loads its rows of every global batch of ``-b``; the loss and its
gradient are the global batch's (engine/pretrain._accumulated); rank 0
alone logs, verifies (on the parameters every rank gathers whole) and
writes checkpoints. Under one process ``--dp``
changes nothing, as in JAX on one device. ``--mesh_model M``, ``--tp``
and ``--fsdp`` lay the ranks out as JAX's ``(data, model)`` mesh and
shard the parameters and their optimizer moments (parallel/sharding);
``--sp`` shards the activations' tokens over ``model`` and ``--pp``
stages the layers over it (parallel/pipeline); ``--mesh_slices S`` adds
the outer dcn data axis (fsdp shards within a slice, the batch over dcn x
data), and a mesh smaller than the world leaves the other ranks idle:
  torchrun --nproc_per_node 8 -m gslora_tpu_torch.cli.train_pretrain \
      --dp --mesh_slices 2 --tp --fsdp --sp --mesh_model 2 -b 480 ...
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
import warnings

import numpy as np
import torch

from gslora_tpu_torch.checkpoints.io import BestHCheckpointer
from gslora_tpu_torch.cli.common import build_datasets, build_params, \
    idle_rank
from gslora_tpu_torch.config import build_parser, config_from_args
from gslora_tpu_torch.data.pipeline import DevicePrefetcher
from gslora_tpu_torch.engine.evaluate import eval_accuracy, make_eval_step
from gslora_tpu_torch.engine.loop import _dtype, resolve_device
from gslora_tpu_torch.engine.pretrain import PretrainState, is_lora, \
    make_pretrain_step
from gslora_tpu_torch.engine.schedule import timm_cosine_lr
from gslora_tpu_torch.engine.state import make_optimizer
from gslora_tpu_torch.metrics.logging import MetricLogger, buffer_val, \
    gen_roc_plot
from gslora_tpu_torch.models.vit import ViT, vit_apply
from gslora_tpu_torch.parallel import sharding
from gslora_tpu_torch.parallel.mesh import check_batch_divisible, \
    data_parallel_size, inactive, make_mesh
from gslora_tpu_torch.parallel.multihost import process_sharded_loader
from gslora_tpu_torch.utils.params import param_summary

VER_FREQ = 20  # train_own.py:483-544: eval + checkpoint every 20 batches


def main(argv=None, return_state: bool = False):
    """Run the pretraining; returns the report (and the final
    ``PretrainState`` with ``return_state``)."""
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    # the parallel flags are checked (JAX placement()) before any process
    # group is made
    mesh = make_mesh(cfg.mesh, cfg.device, dp=args.dp)
    if idle_rank(mesh):
        return (None, None) if return_state else None
    if mesh is not None:
        cfg = dataclasses.replace(cfg, device=str(mesh.device))
        check_batch_divisible(mesh, cfg.data.batch_size)
    main_rank = mesh is None or mesh.is_main
    world = data_parallel_size(mesh)
    device = resolve_device(cfg.device)
    cdt = _dtype(cfg)

    train_ds, test_ds = build_datasets(cfg)
    params = build_params(cfg)
    if main_rank:
        print("params:", json.dumps(param_summary(params)))
    logger = MetricLogger(use_wandb=cfg.log_wandb and main_rank,
                          outdir=cfg.outdir if main_rank else None,
                          config=json.loads(cfg.to_json()))

    opt = make_optimizer(cfg.optim)
    # LoRA-only pretraining when a rank is set AND a base checkpoint resumed
    lora_only = cfg.lora.rank > 0 and bool(cfg.resume)
    vit = ViT(params, cfg.model, cfg.lora).to(device)
    if mesh is not None:
        mesh.broadcast_(list(vit.parameters()))  # one set of weights
        if sharding.sharded(mesh):  # this rank's shards (JAX put_params)
            vit = ViT(sharding.shard_tree(mesh, vit.tree()), cfg.model,
                      cfg.lora)
    state = PretrainState.create(vit, opt,
                                 trains=is_lora if lora_only else None)
    step = make_pretrain_step(cfg.model, cfg.lora, opt, compute_dtype=cdt,
                              grad_accum=cfg.optim.grad_accum, mesh=mesh)
    eval_step = make_eval_step(cfg.model, cfg.lora, compute_dtype=cdt)

    # static batch shapes on the card and under a mesh (label -1
    # sentinels), as the JAX CLI pads off the CPU; each rank loads its rows
    pad = mesh is not None or device.type != "cpu"
    u8 = cfg.data.uint8_transfer
    loader = process_sharded_loader(mesh, train_ds, cfg.data.batch_size,
                                    seed=cfg.data.seed, mask_padding=pad,
                                    uint8_transfer=u8)

    def test_batches():
        return process_sharded_loader(
            mesh, test_ds, cfg.data.batch_size * cfg.data.test_batch_scale,
            shuffle=False, prefetch=0, mask_padding=pad, uint8_transfer=u8)

    ckpt = BestHCheckpointer(cfg.outdir, name=cfg.net,
                             async_save=device.type != "cpu") \
        if cfg.outdir and main_rank else None
    if ckpt:
        ckpt.save_config(cfg.to_json())

    # in-training LFW-style pair verification (train_own.py evaluates
    # perform_val + buffer_val per VER_FREQ window, util/utils.py:167-232)
    ver_sets = []
    # rank 0 alone verifies, with the whole parameters
    verify = any(args.ver_targets.split(","))
    targets = [t for t in args.ver_targets.split(",") if t and main_rank]
    if targets:
        from gslora_tpu_torch.data.recordio import get_val_data
        ver_sets = get_val_data(cfg.data.data_root, targets,
                                cfg.model.image_size)
        missing = sorted(set(targets) - {name for name, *_ in ver_sets})
        if missing:
            warnings.warn(f"verification targets without a .bin under "
                          f"{cfg.data.data_root}: {missing}")

    def run_verification(batch):
        if not verify:
            return
        # every rank: the gather is a collective
        params_now = sharding.gather_tree(mesh, state.params)
        if not ver_sets:
            return
        from gslora_tpu_torch.evaluation.verification import perform_val

        @torch.no_grad()
        def embed(b):
            x = torch.from_numpy(np.ascontiguousarray(b)).to(device)
            return vit_apply(params_now, x, None, cfg.model, cfg.lora,
                             train=False, compute_dtype=cdt).cpu().numpy()

        # the whole parameters on rank 0 alone: no collective inside
        with inactive():
            for name, data_set, issame in ver_sets:
                vacc, vstd, xnorm, thr, (fpr, tpr) = perform_val(
                    embed, data_set, issame, embedding_size=cfg.model.dim,
                    return_roc=True)
                buffer_val(logger, name, vacc, vstd, xnorm, thr,
                           gen_roc_plot(fpr, tpr), batch=batch)

    # each batch block draws its rows' dropout masks from a stream of its
    # own; the ranks of one model group draw the same masks
    block = 0 if mesh is None else mesh.block
    generator = torch.Generator(device=device).manual_seed(
        cfg.data.seed + 7919 * block)
    best_acc = float("-inf")
    batch = 0
    for epoch in range(cfg.num_epoch):
        lr = timm_cosine_lr(cfg.optim, epoch)
        ep_t0, ep_images = time.perf_counter(), 0
        # a host span per epoch: utils/profiling.device_summary's window
        with torch.profiler.record_function("epoch"):
            for x, y in DevicePrefetcher(iter(loader), device, depth=2):
                state, metrics = step(state, x, y, lr, generator)
                if (batch + 1) % cfg.disp_freq == 0:
                    logger.log({k: float(v) for k, v in metrics.items()},
                               step=batch)
                if (batch + 1) % VER_FREQ == 0:
                    acc = eval_accuracy(eval_step, state.params,
                                        test_batches(), mesh=mesh)
                    logger.log({"Test Accuracy": acc}, step=batch)
                    run_verification(batch)
                    # the best accuracy is tracked where a checkpoint is kept
                    # (on every rank alike: rank 0 alone writes it)
                    if acc > best_acc and cfg.outdir:
                        best_acc = acc
                        # every rank: the gather is a collective
                        whole = sharding.gather_tree(mesh, state.params)
                        if ckpt:
                            ckpt.maybe_save(acc, whole, epoch, batch)
                batch += 1
                ep_images += int(x.shape[0]) * world
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        dt = time.perf_counter() - ep_t0
        if dt > 0 and ep_images:
            logger.log({"images_per_sec": ep_images / dt, "epoch": epoch,
                        "lr": lr}, step=batch)

    acc = eval_accuracy(eval_step, state.params, test_batches(), mesh=mesh)
    if ckpt:
        ckpt.wait()  # drain an in-flight async save
    report = {"final_test_acc": acc, "best_test_acc": max(best_acc, acc)}
    if main_rank:
        print(json.dumps(report, indent=2))
    if cfg.outdir and main_rank:
        with open(os.path.join(cfg.outdir, "report.json"), "w") as fh:
            json.dump(report, fh, indent=2)
    logger.finish()
    if mesh is not None:
        mesh.barrier()  # rank 0's files are complete for every rank
    return (report, state) if return_state else report


if __name__ == "__main__":
    main()
