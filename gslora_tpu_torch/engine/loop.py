"""Single-step GS-LoRA(++) training orchestration on one device (port of
gslora_tpu/engine/loop.py; reference engine.py:13-433 +
train_own_forget.py:722-826).

* dual-stream epochs: the LONGER stream drives the epoch, the shorter one
  cycles mid-epoch (engine.py:53/237; cycling engine.py:416-421);
* eval on test forget/remain before training, every VER_FREQ batches and
  at the end, with H-mean-gated checkpointing (engine.py:381-409);
* per-epoch alpha-warmup/beta-decay and timm cosine LR;
* EMA of the merged model after ema_epoch (train_own_forget.py:783-826);
* the ``(dcn, data, model)`` mesh over torch.distributed ranks
  (``mesh``, a parallel/mesh.DataMesh): each rank loads the rows of its
  batch block (``dcn·D + data``) of every global batch and holds its
  shards of the parameters (parallel/sharding: a model axis, tp, fsdp,
  the pipeline stages of pp), the forward shards the tokens under sp and
  runs the GPipe schedule under pp (``--pp_micro`` micro-batches a rank,
  every model rank in lockstep, evaluations and prototypes included),
  the step computes the global-batch loss, evaluations sum their counts
  over the batch axis (dcn x data), and rank 0 alone writes
  checkpoints, of the gathered tree.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from gslora_tpu_torch.checkpoints.io import BestHCheckpointer
from gslora_tpu_torch.config import RunConfig
from gslora_tpu_torch.data.folders import Dataset
from gslora_tpu_torch.data.pipeline import CyclingLoader, DevicePrefetcher
from gslora_tpu_torch.engine.ema import ema_init, ema_update
from gslora_tpu_torch.engine.evaluate import eval_accuracy, h_mean, \
    make_eval_step
from gslora_tpu_torch.engine.forget import make_forget_step, scalars_for_epoch
from gslora_tpu_torch.engine.prototypes import calculate_prototypes
from gslora_tpu_torch.engine.schedule import timm_cosine_lr
from gslora_tpu_torch.engine.state import ForgetState, make_optimizer
from gslora_tpu_torch.lora.core import lora_group_norms
from gslora_tpu_torch.metrics.logging import MetricLogger
from gslora_tpu_torch.models.vit import ViT
from gslora_tpu_torch.parallel import sharding
from gslora_tpu_torch.parallel.mesh import check_batch_divisible, \
    check_placement, check_prox_placement, data_parallel_size, set_active
from gslora_tpu_torch.parallel.multihost import process_sharded_loader


@dataclass
class ForgetData:
    train_forget: Dataset
    train_remain: Dataset
    test_forget: Dataset
    test_remain: Dataset
    test_open: Optional[Dataset] = None


@dataclass
class ForgetResult:
    state: Any
    best_h: float
    forget_acc_before: float
    forget_acc: float
    remain_acc: float
    open_acc: Optional[float] = None
    norm_list: List[float] = field(default_factory=list)
    ema: Any = None  # fp32 merged-model EMA tree (average_weight)
    history: List[Dict] = field(default_factory=list)
    wallclock_s: float = 0.0  # time-to-forget (BASELINE.json metric)


def _dtype(cfg: RunConfig):
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32


def resolve_device(name: str) -> torch.device:
    """The run's device; CUDA requested but missing raises (no silent
    fallback to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA GPU is "
                           "visible; pass device='cpu' (--device cpu) to "
                           "run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return device


def run_forget_training(cfg: RunConfig, params, data: ForgetData,
                        logger: Optional[MetricLogger] = None,
                        workdir: Optional[str] = None,
                        protos: Optional[torch.Tensor] = None,
                        beta: Optional[float] = None,
                        pro_f_weight: Optional[float] = None,
                        seed_offset: int = 0,
                        h_eps: float = 0.0,
                        continual: bool = False,
                        mesh=None, local: bool = False) -> ForgetResult:
    """Train ``params`` (a parameter tree, moved to ``cfg.device``) with
    the GS-LoRA recipe of ``cfg``.

    ``mesh``: an optional parallel/mesh.DataMesh, as JAX's ``mesh``
    (loop.py:125-160): the whole parameters are broadcast from rank 0 and
    each rank keeps its shards (parallel/sharding.shard_tree: JAX's
    ``put_params``), the train and test batches split over the batch
    axis, dcn x data (padded static global batches), the LoRA gradients
    are summed over it; the ranks of a model group end with the same
    shards, every rank with the same history. ``cfg.device`` is the rank's device. ``local``:
    ``params`` are this rank's shards already (a continual run's next
    task); ``ForgetResult.state`` holds the rank's shards.

    ``continual``: engine_cl semantics for a CL task — the remain loader
    ALWAYS drives the epoch (engine_cl.py:50-60) and the structure loss
    has no bare alpha_epoch gate."""
    model, lora, fcfg = cfg.model, cfg.lora, cfg.forget
    device = resolve_device(cfg.device)
    cdt = _dtype(cfg)
    logger = logger or MetricLogger()
    seed = cfg.data.seed + seed_offset
    set_active(mesh)
    check_prox_placement(cfg, mesh)
    check_placement(cfg.mesh, mesh)
    check_batch_divisible(mesh, cfg.data.batch_size)

    vit = ViT(params, model, lora).to(device)
    if mesh is not None and not local:
        mesh.broadcast_(list(vit.parameters()))  # one set of weights
        if sharding.sharded(mesh):
            vit = ViT(sharding.shard_tree(mesh, vit.tree()), model, lora)
    # static batch shapes on the card and under a mesh (label -1
    # sentinels, masked by every loss/accuracy reduction), as the JAX loop
    # pads off the CPU; one-process CPU runs keep the reference's ragged
    # tails
    auto_pad = mesh is not None or device.type != "cpu"
    u8 = cfg.data.uint8_transfer

    def loader(ds, bs, **kw):
        return process_sharded_loader(mesh, ds, bs, mask_padding=auto_pad,
                                      uint8_transfer=u8, **kw)

    # lora_rank 0 -> the reference trains ALL parameters under the same
    # dual-batch loss (train_own_forget_open.py:699-706)
    trainable = "lora" if params.get("lora") else "base"
    opt = make_optimizer(cfg.optim)
    step_fn = make_forget_step(model, lora, fcfg, opt, compute_dtype=cdt,
                               lora_apply=cfg.lora_apply,
                               structure_mode=cfg.structure_mode,
                               fused_batch=cfg.fused_batch,
                               trainable=trainable,
                               grad_accum=cfg.optim.grad_accum, mesh=mesh)
    state = ForgetState.create(vit, opt, trainable=trainable)
    eval_step = make_eval_step(model, lora, compute_dtype=cdt)

    # prototypes from the *pretrained* model over forget ∪ remain subsets
    # (train_own_forget.py:591-611)
    if fcfg.prototype and protos is None:
        aug_repeat = 20 if fcfg.aug_num > 0 else 0
        # RandAugment's draws run in one sequence over the whole set, so
        # augmented prototypes take every row on every rank
        pmesh = None if aug_repeat else mesh
        proto_batches = [
            b for ds in (data.train_forget, data.train_remain)
            for b in process_sharded_loader(
                pmesh, ds, cfg.data.batch_size, shuffle=False, prefetch=0,
                mask_padding=auto_pad, uint8_transfer=u8)]
        protos = calculate_prototypes(
            state.params, proto_batches, model, lora, model.num_class,
            compute_dtype=cdt, aug_repeat=aug_repeat,
            seed=seed, aug_magnitude=fcfg.aug_num,  # utils.py:511
            mesh=pmesh)
    if protos is None:
        protos = torch.zeros((model.num_class, model.dim), device=device)

    bs = cfg.data.batch_size
    test_bs = bs * cfg.data.test_batch_scale
    loader_f = loader(data.train_forget, bs, seed=seed)
    loader_r = loader(data.train_remain, bs, seed=seed + 1)

    def test_batches(ds):
        return loader(ds, test_bs, shuffle=False, prefetch=0)

    def accuracy(ds, params=None):
        return eval_accuracy(eval_step, state.params if params is None
                             else params, test_batches(ds), mesh=mesh)

    forget_acc_before = accuracy(data.test_forget)
    remain_acc_before = accuracy(data.test_remain)
    logger.log({"forget_acc_before": forget_acc_before,
                "remain_acc_before": remain_acc_before}, step=0)

    # async saves on the card: the loop never blocks on checkpoint IO;
    # under a mesh rank 0 alone writes
    main_rank = mesh is None or mesh.is_main
    ckpt = BestHCheckpointer(workdir, name=cfg.net,
                             async_save=device.type != "cpu") \
        if workdir and main_rank else None
    if ckpt:
        ckpt.save_config(cfg.to_json())

    # single-step: the longer stream drives the epoch (engine.py:53);
    # continual: remain always drives (engine_cl.py:50-60)
    forget_drives = (not continual and fcfg.few_shot and
                     len(loader_f) > len(loader_r))

    # under a mesh each batch block draws its rows' dropout masks from a
    # stream of its own (block 0's is the one-process stream); the ranks
    # of one model group draw the same masks, so their replicated
    # activations stay equal
    block = 0 if mesh is None else mesh.block
    generator = torch.Generator(device=device).manual_seed(
        seed + 7919 * block)
    world = data_parallel_size(mesh)
    batch = 0
    best_h = 0.0  # reference highest_H_mean init (train_own_forget.py:548)
    last = {"forget_acc": forget_acc_before, "remain_acc": remain_acc_before,
            "open_acc": None}
    ema = None
    history: List[Dict] = []

    def run_eval(epoch):
        nonlocal best_h
        facc = accuracy(data.test_forget)
        racc = accuracy(data.test_remain)
        oacc = accuracy(data.test_open) if data.test_open is not None \
            else None
        h = h_mean(forget_acc_before, facc, racc, eps=h_eps)
        payload = {"Test forget Accuracy": facc, "Test remain Accuracy": racc,
                   "H_mean": h}
        if oacc is not None:
            payload["Test open Accuracy"] = oacc
        logger.log(payload, step=batch)
        if h > best_h:
            best_h = h
            if workdir:  # every rank: the gather is a collective
                whole = sharding.gather_tree(mesh, state.params)
                if ckpt:
                    ckpt.maybe_save(h, whole, epoch, batch)
        last.update(forget_acc=facc, remain_acc=racc, open_acc=oacc)
        history.append({"epoch": epoch, "batch": batch, **payload})

    run_t0 = time.perf_counter()
    for epoch in range(cfg.num_epoch):
        lr = timm_cosine_lr(cfg.optim, epoch)
        scalars = scalars_for_epoch(cfg, epoch, lr=lr, beta=beta,
                                    w_pro_f=pro_f_weight,
                                    continual=continual)
        ep_t0, ep_images = time.perf_counter(), 0
        if forget_drives:
            lead, cycler = loader_f, CyclingLoader(loader_r)
        else:
            lead, cycler = loader_r, CyclingLoader(loader_f)
        # the stream that drives the epoch stays 2 batches ahead, already
        # copied to the device (non_blocking copies overlap the last step)
        for xd, yd in DevicePrefetcher(iter(lead), device, depth=2):
            xc, yc = (torch.from_numpy(a).to(device) for a in cycler.next())
            if forget_drives:
                xf, yf, xr, yr = xd, yd, xc, yc
            else:
                xf, yf, xr, yr = xc, yc, xd, yd
            state, metrics = step_fn(state, xf, yf, xr, yr, protos, scalars,
                                     generator)
            if (batch + 1) % cfg.disp_freq == 0:
                logger.log({k: float(v) for k, v in metrics.items()},
                           step=batch)
            if (batch + 1) % cfg.ver_freq == 0:
                run_eval(epoch)
            batch += 1
            ep_images += (int(xf.shape[0]) + int(xr.shape[0])) * world
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - ep_t0
        if dt > 0 and ep_images:
            logger.log({"images_per_sec": ep_images / dt,
                        "epoch": epoch, "lr": lr}, step=batch)

        # EMA of the merged model (train_own_forget.py:783-826)
        if fcfg.average_weight:
            p = state.params
            if epoch == fcfg.ema_epoch:
                ema = ema_init(p["base"], p["lora"], lora.scaling)
            elif epoch > fcfg.ema_epoch and ema is not None:
                ema = ema_update(ema, p["base"], p["lora"], lora.scaling,
                                 fcfg.ema_decay)
            if ema is not None:
                ema_params = {"base": ema, "lora": {}}
                logger.log({
                    "Test forget-ema Accuracy": accuracy(data.test_forget,
                                                         ema_params),
                    "Test remain-ema Accuracy": accuracy(data.test_remain,
                                                         ema_params),
                }, step=batch)

    run_eval(cfg.num_epoch - 1)
    if ckpt:
        ckpt.wait()  # drain any in-flight async save before returning
    if mesh is not None:
        mesh.barrier()  # rank 0's files are complete for every rank
    norms = lora_group_norms(state.params["lora"], fcfg.group_pos)
    logger.log({f"norm_group_{i}": n for i, n in enumerate(norms)},
               step=batch)
    return ForgetResult(
        state=state, best_h=best_h, forget_acc_before=forget_acc_before,
        forget_acc=last["forget_acc"], remain_acc=last["remain_acc"],
        open_acc=last["open_acc"], norm_list=norms, ema=ema, history=history,
        wallclock_s=time.perf_counter() - run_t0)
