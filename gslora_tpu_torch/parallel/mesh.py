"""The (data, model) mesh over torch.distributed, and the guards of the
parallel flags (port of gslora_tpu/parallel/mesh.py without the
multi-slice mode).

A JAX device of a ``(data, model)`` mesh becomes one process (rank) here,
launched by ``torchrun``. JAX's mesh is ``devices.reshape(data, model)``,
so rank ``r`` sits at data index ``r // M`` and model index ``r % M``: the
ranks of one model group are contiguous, those of one data group strided.
:class:`DataMesh` names the rank, its two indices and its device, and
carries the collectives of each group: a SUM ``all_reduce`` over flat
buckets (over ``data``, where the batch splits), ``all_gather`` and
``reduce_scatter`` along a tensor dim over either axis, the pipeline's
stage-to-stage ``shift`` over ``model`` (JAX's ``ppermute`` to the next
or the previous stage), a ``broadcast`` from rank 0 over the world. What
is sharded, and how, is parallel/sharding.py's; the pipeline schedule is
parallel/pipeline.py's. There is no mesh for one process, as JAX has none
on one device (``make_mesh`` returns None).

The route of ``all_gather``, ``reduce_scatter`` and ``shift`` follows the
backend and the device: NCCL, and gloo on CPU tensors, run the native
collectives (``isend``/``irecv`` for the shift); gloo on CUDA tensors
(ranks that share one card) offers only all_reduce and broadcast, so
there an all_gather is the all_reduce of a zero-filled whole buffer
holding the rank's shard at its offset, a reduce_scatter the all_reduce
of the whole buffer, sliced, and a shift the all_reduce of a zero-filled
buffer of one slot per model rank in which only the senders' slots are
filled: adding zeros is exact.

:func:`check_placement` holds the parallel flags to what JAX's
``placement()`` accepts, in its order and with its messages; those JAX
would accept but this port does not run yet (multi-slice, a mesh smaller
than the world) raise NotImplementedError naming the flag.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import torch

from gslora_tpu_torch.config import MeshConfig

DATA_AXIS = "data"
MODEL_AXIS = "model"
DCN_AXIS = "dcn"
BUCKET_ELEMENTS = 1 << 22  # 16 MiB of fp32 per all_reduce
ROUTES = ("native", "all_reduce")


@dataclass(frozen=True)
class DataMesh:
    """One rank of a ``(data, model)`` world of ``world = D·M`` ranks: it
    loads ``1/D`` of each global batch (the rows of its data index,
    parallel/multihost) and holds its shards of the parameters
    (parallel/sharding). ``model = 1`` is plain data parallelism.

    ``groups`` are the process groups of the rank's data and model axes
    (None: the default group, or an axis of one rank); ``route`` is how
    all_gather, reduce_scatter and shift run (module docstring). ``pp``
    stages the layers over ``model`` in ``pp_micro`` micro-batches (0:
    the stage count, as JAX's ``set_pipeline``); ``sp`` shards the
    activations' token dim over ``model``."""

    rank: int
    world: int
    device: torch.device
    model: int = 1
    tp: bool = False
    fsdp: bool = False
    route: str = "native"
    pp: bool = False
    pp_micro: int = 0
    sp: bool = False
    groups: Dict[str, object] = field(default_factory=dict, compare=False,
                                      repr=False)

    @property
    def data(self) -> int:
        return self.world // self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def size(self, axis: str) -> int:
        return self.data if axis == DATA_AXIS else self.model

    def index(self, axis: str) -> int:
        return self.data_index if axis == DATA_AXIS else self.model_index

    def group(self, axis: str):
        return self.groups.get(axis)

    def all_reduce_(self, tensors: Sequence[torch.Tensor],
                    axis: str = DATA_AXIS) -> None:
        """SUM each tensor over the ranks of ``axis`` (the data axis by
        default: the ranks that split the batch), in place: the tensors of
        one dtype go through flat buckets of at most
        ``BUCKET_ELEMENTS``."""
        if self.size(axis) == 1:
            return
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            bucket, size = [], 0
            for t in group:
                if bucket and size + t.numel() > BUCKET_ELEMENTS:
                    _all_reduce_flat(bucket, self.group(axis))
                    bucket, size = [], 0
                bucket.append(t)
                size += t.numel()
            _all_reduce_flat(bucket, self.group(axis))

    def all_gather(self, t: torch.Tensor, axis: str,
                   dim: int) -> torch.Tensor:
        """The shards of ``t`` over ``axis``, concatenated along ``dim`` in
        index order."""
        import torch.distributed as dist
        n = self.size(axis)
        if n == 1:
            return t
        shard = t.movedim(dim, 0).contiguous()
        out = shard.new_zeros((n * shard.shape[0],) + shard.shape[1:])
        if self.route == "native":
            dist.all_gather_into_tensor(out, shard, group=self.group(axis))
        else:
            lo = self.index(axis) * shard.shape[0]
            out[lo:lo + shard.shape[0]] = shard
            dist.all_reduce(out, group=self.group(axis))
        return out.movedim(0, dim)

    def reduce_scatter(self, t: torch.Tensor, axis: str,
                       dim: int) -> torch.Tensor:
        """This rank's shard (along ``dim``) of the SUM of ``t`` over
        ``axis``."""
        import torch.distributed as dist
        n = self.size(axis)
        if n == 1:
            return t
        whole = t.movedim(dim, 0).contiguous()
        per = whole.shape[0] // n
        if self.route == "native":
            out = whole.new_empty((per,) + whole.shape[1:])
            dist.reduce_scatter_tensor(out, whole, group=self.group(axis))
        else:
            whole = whole.clone()  # the all_reduce sums in place
            dist.all_reduce(whole, group=self.group(axis))
            lo = self.index(axis) * per
            out = whole[lo:lo + per]
        return out.movedim(0, dim)

    def shift(self, t: torch.Tensor, step: int = 1) -> torch.Tensor:
        """JAX's ``ppermute`` over ``model`` by ``step`` (+1: each stage
        sends ``t`` to the next, -1: to the previous): the tensor of model
        index ``i - step``, zeros where there is none. Every model rank
        calls it with a tensor of one shape."""
        import torch.distributed as dist
        n, i = self.model, self.model_index
        t = t.contiguous()
        sends, recvs = 0 <= i + step < n, 0 <= i - step < n
        group = self.group(MODEL_AXIS)
        if self.route == "native":
            out = torch.zeros_like(t)
            first = self.rank - i  # global rank of model index 0
            ops = ([dist.P2POp(dist.isend, t, first + i + step, group)]
                   if sends else []) + \
                ([dist.P2POp(dist.irecv, out, first + i - step, group)]
                 if recvs else [])
            if ops:
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
            return out
        buf = t.new_zeros((n,) + t.shape)
        if sends:
            buf[i] = t
        dist.all_reduce(buf, group=group)
        return buf[i - step] if recvs else torch.zeros_like(t)

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Overwrite each tensor with rank 0's, in place."""
        import torch.distributed as dist
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t.data, src=0)

    def sum(self, values: Sequence[float]) -> List[float]:
        """SUM host numbers over the data axis (fp64 on the rank's
        device): the ranks of one model group hold the same rows."""
        t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                         device=self.device)
        self.all_reduce_([t])
        return t.tolist()

    def barrier(self) -> None:
        """Wait for every rank (an all_reduce of one number)."""
        import torch.distributed as dist
        dist.all_reduce(torch.zeros(1, device=self.device))


def _all_reduce_flat(bucket: List[torch.Tensor], group=None) -> None:
    import torch.distributed as dist
    flat = torch.cat([t.reshape(-1) for t in bucket])
    dist.all_reduce(flat, group=group)
    offset = 0
    for t in bucket:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


# The mesh the model's forward shards over (JAX's trace-time registries,
# set_attention_mesh and friends): set by make_mesh and by the engines
# that take a mesh; None on one process.
_ACTIVE: Optional[DataMesh] = None


def set_active(mesh: Optional[DataMesh]) -> None:
    global _ACTIVE
    _ACTIVE = mesh


def active_mesh() -> Optional[DataMesh]:
    return _ACTIVE


def data_parallel_size(mesh: Optional[DataMesh]) -> int:
    """The data-parallel ways — what batch sizes must divide."""
    return 1 if mesh is None else mesh.data


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
    sp with pp, a mesh larger than the world) raises its ValueError; what
    JAX would run but the port does not (multi-slice, a mesh that leaves
    ranks idle) raises NotImplementedError. ``--mesh_model``,
    ``--tp``, ``--fsdp``, ``--sp`` and ``--pp`` run on a mesh of the
    whole world. JAX raises "pp excludes tp/fsdp" in ``param_shardings``
    (parallel/mesh.py:258-261), here with the other guards; the pp depth
    divisibility, as there, where the tree is sharded
    (parallel/sharding.leaf_spec)."""
    if mesh is None:
        if cfg.tp or cfg.fsdp or cfg.pp or cfg.sp:
            raise ValueError(
                "tp/fsdp/pp/sp need a device mesh — run with --dp and a "
                "mesh that has the axis to shard over (--mesh_model N for "
                "tp/pp/sp; a data axis > 1 for fsdp)")
        return
    shape = jax_mesh_shape(cfg, mesh.world)
    slices = shape.get(DCN_AXIS, 1)
    if shape[DATA_AXIS] < 1 or \
            slices * shape[DATA_AXIS] * shape[MODEL_AXIS] > mesh.world:
        raise ValueError(f"mesh {slices}x{shape[DATA_AXIS]}x"
                         f"{shape[MODEL_AXIS]} does not fit {mesh.world} "
                         f"devices")
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
    if cfg.pp and (cfg.tp or cfg.fsdp):
        raise ValueError("pp excludes tp/fsdp: pipeline stages own the "
                         "model axis and the pipeline body is a fully "
                         "manual shard_map")
    if slices > 1:
        raise NotImplementedError(
            "--mesh_slices > 1 is not ported yet: gslora_tpu_torch runs "
            "the (data, model) mesh: --dp, --mesh_model, --tp, --fsdp, "
            "--sp, --pp")
    if shape[DATA_AXIS] * shape[MODEL_AXIS] != mesh.world:
        raise NotImplementedError(
            f"--mesh_data {shape[DATA_AXIS]} x --mesh_model "
            f"{shape[MODEL_AXIS]} on a world of {mesh.world} is not ported "
            f"yet: the mesh spans every rank (JAX leaves the others idle)")


def check_prox_placement(cfg, mesh: Optional[DataMesh]) -> None:
    """JAX's refusal of the prox step under tp/pp (engine/loop.py:132-141):
    the prox applies a kernel to whole LoRA factors, which tp shards."""
    if mesh is not None and (cfg.mesh.tp or cfg.mesh.pp) and \
            cfg.structure_mode == "prox" and \
            jax_mesh_shape(cfg.mesh, mesh.world)[MODEL_AXIS] > 1:
        raise ValueError("structure_mode='prox' is incompatible with "
                         "MeshConfig.tp/.pp — use the default 'loss' mode")


def check_baseline_placement(cfg: MeshConfig,
                             mesh: Optional[DataMesh] = None) -> None:
    """The guards of JAX's baseline runners (e.g. baselines/
    regularization.py:170-181) for a run on ``mesh``: pp raises JAX's
    ValueError first, then :func:`check_placement`; under a world the
    baselines run the data axis only, so tp, fsdp, sp and a model axis
    raise NotImplementedError naming the flag (without a mesh, JAX's
    ValueError)."""
    if cfg.pp:
        raise ValueError(
            "MeshConfig.pp is supported by the GS-LoRA forget and "
            "pretrain engines only; baseline runners support "
            "dp/tp/fsdp")
    check_placement(cfg, mesh)
    if mesh is None:
        return
    for flag, on in (("--tp", cfg.tp), ("--fsdp", cfg.fsdp),
                     ("--sp", cfg.sp), ("--mesh_model > 1", cfg.model > 1)):
        if on:
            raise NotImplementedError(
                f"{flag} is not ported yet for the baseline runners: they "
                f"run the data axis only (--dp, one rank per device; "
                f"--tp, --fsdp, --sp, --pp and a model axis are refused)")


def world_size() -> int:
    """The launched world: the default process group's size once one
    exists, else torchrun's ``WORLD_SIZE`` (1 when unset)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def axis_groups(world: int, model: int, rank: int) -> Dict[str, object]:
    """The process groups of ``rank``'s data and model axes. Every rank
    makes every group, in one order (``dist.new_group`` is collective);
    an axis that spans the world uses the default group (None) and one of
    a single rank none at all."""
    import torch.distributed as dist
    data = world // model
    groups: Dict[str, object] = {}
    if model > 1 and data > 1:
        for j in range(data):
            g = dist.new_group(list(range(j * model, (j + 1) * model)))
            if rank // model == j:
                groups[MODEL_AXIS] = g
        for k in range(model):
            g = dist.new_group(list(range(k, world, model)))
            if rank % model == k:
                groups[DATA_AXIS] = g
    return groups


def collective_route(backend: str, device: torch.device) -> str:
    """How all_gather, reduce_scatter and shift run: gloo on CUDA tensors
    has none of them, so there they go through all_reduce; elsewhere
    natively."""
    return "all_reduce" if backend == "gloo" and device.type == "cuda" \
        else "native"


def make_mesh(cfg: MeshConfig, device: str = "cuda", dp: bool = True,
              check=check_placement) -> Optional[DataMesh]:
    """The ``(data, model)`` mesh of a ``--dp`` run, or None (``--dp`` off,
    or a world of one: JAX's ``len(jax.devices()) > 1`` rule). The flags
    are checked by ``check`` (:func:`check_placement`, or
    :func:`check_baseline_placement` for a baseline) before any process
    group is made; then the default group is initialised from torchrun's
    environment unless one exists (nccl for the card, gloo for
    ``device='cpu'``) and the axis groups are made. A rank's device is
    ``cuda:<LOCAL_RANK % device_count>``, or the CPU when asked for. The
    mesh becomes the active one (:func:`active_mesh`), which the model's
    forward shards over."""
    world = world_size() if dp else 1
    mesh = None
    if world > 1:
        rank = int(os.environ.get("RANK", "0"))
        mesh = DataMesh(rank=rank, world=world, device=torch.device("cpu"))
    check(cfg, mesh)
    set_active(None)
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
    rank, world = dist.get_rank(), dist.get_world_size()
    model = jax_mesh_shape(cfg, world)[MODEL_AXIS]
    route = collective_route(dist.get_backend(), dev)
    mesh = DataMesh(rank=rank, world=world, device=dev, model=model,
                    tp=cfg.tp, fsdp=cfg.fsdp, route=route, pp=cfg.pp,
                    pp_micro=cfg.pp_micro, sp=cfg.sp,
                    groups=axis_groups(world, model, rank))
    if mesh.is_main:
        print(f"mesh: data {mesh.data} x model {model} (tp={cfg.tp}, "
              f"fsdp={cfg.fsdp}, sp={cfg.sp}, pp={cfg.pp}), "
              f"{dist.get_backend()} on {dev.type}, collective route "
              f"{route}", flush=True)
    set_active(mesh)
    return mesh
