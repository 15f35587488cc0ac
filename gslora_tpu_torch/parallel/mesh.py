"""The ``(dcn, data, model)`` mesh over torch.distributed, and the guards
of the parallel flags (port of gslora_tpu/parallel/mesh.py).

A JAX device of a mesh becomes one process (rank) here, launched by
``torchrun``. JAX's mesh is ``devices[:S·D·M].reshape(S, D, M)`` (without
``--mesh_slices``, ``reshape(D, M)``), so rank ``r`` sits at dcn index
``r // (D·M)``, data index ``(r // M) % D`` and model index ``r % M``: the
ranks of one model group are contiguous, those of one data group strided
within a slice. Ranks from ``S·D·M`` on are idle, as JAX leaves the
devices past the mesh unused. The batch splits over ``dcn × data`` (the
batch axis: the ranks of one model index), in blocks ``dcn·D + data``;
tp, sp and pp stay on ``model`` and fsdp's shards on ``data``, both
within a slice, so only the batch sums cross ``dcn`` (on GPUs the node
axis: the fsdp and model collectives stay inside a node).

:class:`DataMesh` names the rank, its indices and its device, and
carries the collectives of each group: a SUM ``all_reduce`` over flat
buckets (over the batch axis by default), ``all_gather`` and
``reduce_scatter`` along a tensor dim over an axis, the pipeline's
stage-to-stage ``shift`` over ``model`` (JAX's ``ppermute`` to the next
or the previous stage), and a ``broadcast`` from rank 0 and a barrier
over the ranks the mesh uses. No collective runs on the default group
once the groups are made, unless the mesh spans the world: the idle
ranks leave. What is sharded, and how, is parallel/sharding.py's; the
pipeline schedule is parallel/pipeline.py's. There is no mesh for one
process, as JAX has none on one device (``make_mesh`` returns None).

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
``placement()`` accepts, in its order and with its messages.
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import torch

from gslora_tpu_torch.config import MeshConfig

DATA_AXIS = "data"
MODEL_AXIS = "model"
DCN_AXIS = "dcn"
# the batch axis, dcn x data: the ranks of one model index
BATCH_AXIS = "batch"
# the group of the ranks the mesh uses (all but the idle ones)
MESH_GROUP = "mesh"
BUCKET_ELEMENTS = 1 << 22  # 16 MiB of fp32 per all_reduce
ROUTES = ("native", "all_reduce")


@dataclass(frozen=True)
class DataMesh:
    """One rank of a ``(dcn, data, model)`` mesh of ``S·D·M`` ranks out of
    a launched ``world``: it loads ``1/(S·D)`` of each global batch (the
    rows of its block, parallel/multihost) and holds its shards of the
    parameters (parallel/sharding). ``model = 1`` and ``slices = 1`` is
    plain data parallelism; ``data = 0`` takes the world's ranks that
    ``slices`` and ``model`` leave (JAX's ``--mesh_data -1``). A rank past
    the mesh is :attr:`idle`.

    ``groups`` are the process groups of the rank's axes and of the
    mesh's ranks (absent: the axis or the mesh spans the world, which the
    default group serves, or holds one rank); ``route`` is how
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
    slices: int = 1
    data: int = 0

    def __post_init__(self):
        if self.data <= 0:
            object.__setattr__(self, "data",
                               self.world // (self.slices * self.model))

    @property
    def dcn_index(self) -> int:
        return self.rank // (self.data * self.model)

    @property
    def data_index(self) -> int:
        return (self.rank // self.model) % self.data

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def block(self) -> int:
        """The rank's batch block, ``dcn·D + data`` of ``S·D``."""
        return self.dcn_index * self.data + self.data_index

    @property
    def idle(self) -> bool:
        """A rank past the mesh: JAX's devices past ``S·D·M``."""
        return self.rank >= self.size()

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def size(self, axis: Optional[str] = None) -> int:
        """The ranks of ``axis``; without one, the ranks the mesh uses."""
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model,
                DCN_AXIS: self.slices, BATCH_AXIS: self.slices * self.data,
                None: self.slices * self.data * self.model}[axis]

    def index(self, axis: str) -> int:
        return {DATA_AXIS: self.data_index, MODEL_AXIS: self.model_index,
                DCN_AXIS: self.dcn_index, BATCH_AXIS: self.block}[axis]

    def group(self, axis: str):
        return self.groups.get(axis)

    def all_reduce_(self, tensors: Sequence[torch.Tensor],
                    axis: str = BATCH_AXIS) -> None:
        """SUM each tensor over the ranks of ``axis`` (the batch axis by
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
        """Overwrite each tensor with rank 0's, in place, over the mesh's
        ranks."""
        import torch.distributed as dist
        if self.size() == 1:
            return
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t.data, src=0, group=self.group(MESH_GROUP))

    def sum(self, values: Sequence[float],
            axis: str = BATCH_AXIS) -> List[float]:
        """SUM host numbers over ``axis`` (fp64 on the rank's device; the
        batch axis by default: the ranks of one model group hold the same
        rows)."""
        t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                         device=self.device)
        self.all_reduce_([t], axis=axis)
        return t.tolist()

    def barrier(self) -> None:
        """Wait for every rank of the mesh (an all_reduce of one
        number)."""
        import torch.distributed as dist
        if self.size() > 1:
            dist.all_reduce(torch.zeros(1, device=self.device),
                            group=self.group(MESH_GROUP))


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


@contextmanager
def inactive():
    """No active mesh inside the block (a forward of whole parameters on
    one rank alone), the active one again after it."""
    was = _ACTIVE
    set_active(None)
    try:
        yield
    finally:
        set_active(was)


def data_parallel_size(mesh: Optional[DataMesh]) -> int:
    """Total data-parallel ways (dcn x data) — what batch sizes must
    divide."""
    return 1 if mesh is None else mesh.size(BATCH_AXIS)


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
    run on ``mesh`` (None: one process, JAX's one-device case).

    Without a mesh, tp/fsdp/pp/sp raise JAX's ValueError. With one, what
    JAX refuses (a mesh larger than the world, tp/pp/sp on a model axis of
    1, fsdp on a data axis of 1, sp with pp) raises its ValueError; every
    other layout runs, ``--mesh_slices`` and a mesh that leaves ranks idle
    included. JAX raises "pp excludes tp/fsdp" in ``param_shardings``
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
    ValueError first, then :func:`check_placement`; every other layout
    runs (tp, fsdp, sp, a model axis, ``--mesh_slices`` and a mesh that
    leaves ranks idle)."""
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


def axis_ranks(slices: int, data: int,
               model: int) -> Dict[str, List[List[int]]]:
    """The ranks of every group of an ``S x D x M`` mesh, by axis (and
    :data:`MESH_GROUP`), each group in rank order: rank ``r`` sits at
    ``(r // (D·M), (r // M) % D, r % M)``."""
    grid = [[[(s * data + j) * model + k for k in range(model)]
             for j in range(data)] for s in range(slices)]
    return {
        MODEL_AXIS: [grid[s][j] for s in range(slices)
                     for j in range(data)],
        DATA_AXIS: [[grid[s][j][k] for j in range(data)]
                    for s in range(slices) for k in range(model)],
        DCN_AXIS: [[grid[s][j][k] for s in range(slices)]
                   for j in range(data) for k in range(model)],
        BATCH_AXIS: [[grid[s][j][k] for s in range(slices)
                      for j in range(data)] for k in range(model)],
        MESH_GROUP: [list(range(slices * data * model))],
    }


def axis_groups(world: int, rank: int, slices: int, data: int,
                model: int) -> Dict[str, object]:
    """The process groups of ``rank``'s axes and of the mesh's ranks.
    Every rank of the world makes every group, in one order, idle ranks
    too (``dist.new_group`` is collective); axes of the same ranks (the
    batch axis and ``data`` on one slice) share one group. A group of one
    rank is not made (its collectives are no-ops); one of the whole world
    is the default group, so a mesh that leaves ranks idle runs on groups
    of its own alone."""
    import torch.distributed as dist
    groups: Dict[str, object] = {}
    made: Dict[tuple, object] = {}
    for name, lists in axis_ranks(slices, data, model).items():
        for ranks in lists:
            if len(ranks) == 1 or len(ranks) == world:
                continue
            if tuple(ranks) not in made:
                made[tuple(ranks)] = dist.new_group(ranks)
            if rank in ranks:
                groups[name] = made[tuple(ranks)]
    return groups


def collective_route(backend: str, device: torch.device) -> str:
    """How all_gather, reduce_scatter and shift run: gloo on CUDA tensors
    has none of them, so there they go through all_reduce; elsewhere
    natively."""
    return "all_reduce" if backend == "gloo" and device.type == "cuda" \
        else "native"


def make_mesh(cfg: MeshConfig, device: str = "cuda", dp: bool = True,
              check=check_placement) -> Optional[DataMesh]:
    """The ``(dcn, data, model)`` mesh of a ``--dp`` run, or None (``--dp``
    off, or a world of one: JAX's ``len(jax.devices()) > 1`` rule). The
    flags are checked by ``check`` (:func:`check_placement`, or
    :func:`check_baseline_placement` for a baseline) before any process
    group is made; then the default group is initialised from torchrun's
    environment unless one exists (nccl for the card, gloo for
    ``device='cpu'``) and the groups are made, by every rank. A rank's
    device is ``cuda:<LOCAL_RANK % device_count>``, or the CPU when asked
    for. The mesh becomes the active one (:func:`active_mesh`), which the
    model's forward shards over; on an :attr:`DataMesh.idle` rank none
    is, and the caller leaves."""
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
    shape = jax_mesh_shape(cfg, world)
    slices, data, model = (shape.get(DCN_AXIS, 1), shape[DATA_AXIS],
                           shape[MODEL_AXIS])
    route = collective_route(dist.get_backend(), dev)
    mesh = DataMesh(rank=rank, world=world, device=dev, model=model,
                    tp=cfg.tp, fsdp=cfg.fsdp, route=route, pp=cfg.pp,
                    pp_micro=cfg.pp_micro, sp=cfg.sp, slices=slices,
                    data=data,
                    groups=axis_groups(world, rank, slices, data, model))
    if mesh.is_main:
        used = mesh.size()
        idle = "" if used == world else ", idle ranks " + ", ".join(
            str(r) for r in range(used, world))
        print(f"mesh: dcn {slices} x data {data} x model {model} (tp="
              f"{cfg.tp}, fsdp={cfg.fsdp}, sp={cfg.sp}, pp={cfg.pp}), "
              f"{used} of {world} ranks{idle}, {dist.get_backend()} on "
              f"{dev.type}, collective route {route}", flush=True)
    if not mesh.idle:
        set_active(mesh)
    return mesh
