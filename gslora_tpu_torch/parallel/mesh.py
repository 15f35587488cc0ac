"""Data parallelism over torch.distributed, and the guards of the parallel
flags (port of gslora_tpu/parallel/mesh.py, the ``data`` axis only).

A JAX device of a one-axis ``data`` mesh becomes one process (rank) here,
launched by ``torchrun``; :class:`DataMesh` names the rank, the world and
the rank's device, and carries the two collectives the training paths use:
a SUM ``all_reduce`` over flat buckets and a ``broadcast`` from rank 0
(gloo on CUDA tensors offers only those two, and NCCL both). There is no
mesh for one process, as JAX has none on one device (``make_mesh`` returns
None).

:func:`check_placement` holds the parallel flags to what JAX's
``placement()`` accepts, in its order and with its messages; those JAX
would accept but this port does not run yet (tp, pp, sp and a model axis,
fsdp, multi-slice, a data axis smaller than the world) raise
NotImplementedError naming the flag.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from gslora_tpu_torch.config import MeshConfig

DATA_AXIS = "data"
MODEL_AXIS = "model"
DCN_AXIS = "dcn"
BUCKET_ELEMENTS = 1 << 22  # 16 MiB of fp32 per all_reduce


@dataclass(frozen=True)
class DataMesh:
    """One rank of a data-parallel world: every rank holds the whole model
    and ``1/world`` of each global batch (rows ``[rank·B/W, (rank+1)·B/W)``,
    parallel/multihost)."""

    rank: int
    world: int
    device: torch.device

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def all_reduce_(self, tensors: Sequence[torch.Tensor]) -> None:
        """SUM each tensor over the ranks, in place: the tensors of one
        dtype go through flat buckets of at most ``BUCKET_ELEMENTS``."""
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            bucket, size = [], 0
            for t in group:
                if bucket and size + t.numel() > BUCKET_ELEMENTS:
                    _all_reduce_flat(bucket)
                    bucket, size = [], 0
                bucket.append(t)
                size += t.numel()
            _all_reduce_flat(bucket)

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Overwrite each tensor with rank 0's, in place."""
        import torch.distributed as dist
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t.data, src=0)

    def sum(self, values: Sequence[float]) -> List[float]:
        """SUM host numbers over the ranks (fp64 on the rank's device)."""
        t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                         device=self.device)
        self.all_reduce_([t])
        return t.tolist()

    def barrier(self) -> None:
        """Wait for every rank (an all_reduce of one number)."""
        self.sum([0.0])


def _all_reduce_flat(bucket: List[torch.Tensor]) -> None:
    import torch.distributed as dist
    flat = torch.cat([t.reshape(-1) for t in bucket])
    dist.all_reduce(flat)
    offset = 0
    for t in bucket:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def data_parallel_size(mesh: Optional[DataMesh]) -> int:
    """The data-parallel ways — what batch sizes must divide."""
    return 1 if mesh is None else mesh.world


def check_batch_divisible(mesh: Optional[DataMesh], batch_size: int) -> None:
    """Fail fast when a global batch cannot split evenly over the ranks."""
    if mesh is None:
        return
    dsize = data_parallel_size(mesh)
    if batch_size % dsize != 0:
        raise ValueError(
            f"batch_size {batch_size} not divisible by the mesh "
            f"data-parallel ways ({dsize}) — padded batches cannot shard")


def jax_mesh_shape(cfg: MeshConfig, world: int) -> Dict[str, int]:
    """The axes JAX's ``make_mesh(cfg)`` would build over ``world``
    devices."""
    model = max(cfg.model, 1)
    slices = max(cfg.slices, 1)
    data = cfg.data if cfg.data > 0 else world // (model * slices)
    shape = {DATA_AXIS: data, MODEL_AXIS: model}
    return {DCN_AXIS: slices, **shape} if slices > 1 else shape


def check_placement(cfg: MeshConfig, mesh: Optional[DataMesh]) -> None:
    """The guards of JAX ``placement()`` (parallel/mesh.py:370-391) for a
    run on ``mesh`` (None: one process, JAX's one-device case), then the
    flags this port does not run yet.

    Without a mesh, tp/fsdp/pp/sp raise JAX's ValueError. With one, what
    JAX refuses (tp/pp/sp on a model axis of 1, fsdp on a data axis of 1,
    sp with pp) raises its ValueError, and what JAX would run but the port
    does not raises NotImplementedError."""
    if mesh is None:
        if cfg.tp or cfg.fsdp or cfg.pp or cfg.sp:
            raise ValueError(
                "tp/fsdp/pp/sp need a device mesh — run with --dp and a "
                "mesh that has the axis to shard over (--mesh_model N for "
                "tp/pp/sp; a data axis > 1 for fsdp)")
        return
    shape = jax_mesh_shape(cfg, mesh.world)
    if (cfg.tp or cfg.pp or cfg.sp) and shape[MODEL_AXIS] <= 1:
        which = "tp" if cfg.tp else ("pp" if cfg.pp else "sp")
        raise ValueError(
            f"{which}=True is a no-op on a model axis "
            f"of 1 — set --mesh_model N (mesh is {shape})")
    if cfg.fsdp and shape[DATA_AXIS] <= 1:
        raise ValueError(
            f"fsdp=True is a no-op on a data axis of 1 (mesh is {shape})")
    if cfg.sp and cfg.pp:
        raise ValueError(
            "sp excludes pp: the pipeline body is a fully manual "
            "shard_map over the model axis, so GSPMD sharding "
            "constraints cannot reference it there")
    for flag, on in (("--tp", cfg.tp), ("--pp", cfg.pp), ("--sp", cfg.sp),
                     ("--fsdp", cfg.fsdp),
                     ("--mesh_slices > 1", cfg.slices > 1),
                     ("--mesh_model > 1", cfg.model > 1)):
        if on:
            raise NotImplementedError(
                f"{flag} is not ported yet: gslora_tpu_torch runs the data "
                f"axis only (--dp, one rank per device)")
    if cfg.data not in (-1, mesh.world):
        raise NotImplementedError(
            f"--mesh_data {cfg.data} on a world of {mesh.world} is not "
            f"ported yet: the data axis spans every rank (-1)")


def check_baseline_placement(cfg: MeshConfig,
                             mesh: Optional[DataMesh] = None) -> None:
    """The guards of JAX's baseline runners (e.g. baselines/
    regularization.py:170-181) for a run on ``mesh``: pp raises JAX's
    ValueError first, then :func:`check_placement` (so tp/sp/fsdp and
    multi-slice under a world raise NotImplementedError naming the flag,
    and without a mesh JAX's ValueError)."""
    if cfg.pp:
        raise ValueError(
            "MeshConfig.pp is supported by the GS-LoRA forget and "
            "pretrain engines only; baseline runners support "
            "dp/tp/fsdp")
    check_placement(cfg, mesh)


def world_size() -> int:
    """The launched world: the default process group's size once one
    exists, else torchrun's ``WORLD_SIZE`` (1 when unset)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def make_mesh(cfg: MeshConfig, device: str = "cuda", dp: bool = True,
              check=check_placement) -> Optional[DataMesh]:
    """The data mesh of a ``--dp`` run, or None (``--dp`` off, or a world of
    one: JAX's ``len(jax.devices()) > 1`` rule). The flags are checked by
    ``check`` (:func:`check_placement`, or :func:`check_baseline_placement`
    for a baseline) before any process group is made; then the
    default group is initialised from torchrun's environment unless one
    exists (nccl for the card, gloo for ``device='cpu'``). A rank's device
    is ``cuda:<LOCAL_RANK % device_count>``, or the CPU when asked for."""
    world = world_size() if dp else 1
    mesh = None
    if world > 1:
        rank = int(os.environ.get("RANK", "0"))
        mesh = DataMesh(rank=rank, world=world, device=torch.device("cpu"))
    check(cfg, mesh)
    if mesh is None:
        return None
    import torch.distributed as dist
    on_card = torch.device(device).type == "cuda"
    if not dist.is_initialized():
        dist.init_process_group("nccl" if on_card else "gloo")
    if on_card:
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA GPU is "
                               "visible; pass --device cpu to run on the CPU")
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    return DataMesh(rank=dist.get_rank(), world=dist.get_world_size(),
                    device=dev)
