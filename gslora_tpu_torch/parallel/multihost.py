"""Process-sharded feeding of a data-parallel run (port of
gslora_tpu/parallel/multihost.py; the global-array assembly of JAX has no
counterpart, as each rank's tensors are its own).

The batch dim of a global batch splits over the flattened (dcn, data) mesh
axes in row-major order: the device at mesh position ``(dcn_i, data_j,
model_k)`` owns batch block ``dcn_i·data + data_j``, and block ``b`` of
``n = dcn·data`` holds rows ``[b·B/n, (b+1)·B/n)``. Here one rank drives
one device, so rank ``r`` loads its block's rows through
``BatchLoader(local_bounds=...)``; a rank past the mesh (idle) owns none.
Every rank's loader takes the same seed, so the global shuffle order is
the same on all of them.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from gslora_tpu_torch.parallel.mesh import (BATCH_AXIS, DATA_AXIS,
                                            DCN_AXIS, MODEL_AXIS)


def device_blocks(axis_names: Sequence[str],
                  mesh_shape: Sequence[int]) -> np.ndarray:
    """Array (the mesh's shape) of the batch block each position owns:
    ``dcn_i·data_size + data_j`` on a dcn mesh, ``data_j`` otherwise."""
    names = list(axis_names)
    shape = tuple(mesh_shape)
    data_ax = names.index(DATA_AXIS)
    idx = np.indices(shape)
    blocks = idx[data_ax]
    if DCN_AXIS in names:
        blocks = idx[names.index(DCN_AXIS)] * shape[data_ax] + idx[data_ax]
    return blocks


def process_block_map(axis_names: Sequence[str],
                      process_of_device: np.ndarray) -> Dict[int, List[int]]:
    """{process: sorted batch blocks it owns} for a mesh whose device
    array has ``process_of_device[pos]`` = the owning process."""
    blocks = device_blocks(axis_names, process_of_device.shape)
    out: Dict[int, set] = {}
    for pos in np.ndindex(process_of_device.shape):
        out.setdefault(int(process_of_device[pos]), set()).add(
            int(blocks[pos]))
    return {pid: sorted(bs) for pid, bs in out.items()}


def blocks_to_bounds(global_batch: int, n_blocks: int,
                     blocks: Sequence[int]) -> Tuple[int, int]:
    """Global-batch row bounds [start, stop) of a process owning
    ``blocks`` out of ``n_blocks``; the blocks must be contiguous."""
    if global_batch % n_blocks != 0:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n_blocks} data-parallel blocks")
    bs = sorted(blocks)
    if not bs:
        raise ValueError("process owns no batch blocks — is it part of "
                         "the mesh?")
    if bs != list(range(bs[0], bs[-1] + 1)):
        raise ValueError(
            f"process owns non-contiguous batch blocks {bs} — this mesh/"
            f"process layout cannot be fed with one row slice per host")
    per = global_batch // n_blocks
    return bs[0] * per, (bs[-1] + 1) * per


def rank_owners(mesh) -> np.ndarray:
    """The mesh's device array of ranks: ``arange(S·D·M)`` reshaped to
    ``(S, D, M)`` (JAX's ``devices[:S·D·M].reshape``), one device per
    rank."""
    return np.arange(mesh.size()).reshape(mesh.slices, mesh.data,
                                          mesh.model)


def host_batch_bounds(mesh, global_batch: int,
                      process_index: Optional[int] = None
                      ) -> Tuple[int, int]:
    """Rows of the global batch that rank ``process_index`` (this rank by
    default) loads: its block ``dcn·D + data`` of the ``S·D`` blocks
    (:func:`device_blocks` over the mesh of :func:`rank_owners`). The
    ranks of one model group load the same rows; an idle rank owns no
    devices and raises."""
    pid = mesh.rank if process_index is None else process_index
    blocks = process_block_map((DCN_AXIS, DATA_AXIS, MODEL_AXIS),
                               rank_owners(mesh)).get(pid)
    if blocks is None:
        raise ValueError(f"process {pid} owns no devices in this mesh")
    return blocks_to_bounds(global_batch, mesh.size(BATCH_AXIS), blocks)


# The global batch sizes of the loaders made by process_sharded_loader:
# a rank's feed must be one of these sizes' share (check_local_feed), so a
# full global batch fed on every rank (the one-process habit) raises
# instead of training on a W-fold batch.
_DECLARED_BATCHES: set = set()


def declare_global_batch(n: int) -> None:
    if n > 0:
        _DECLARED_BATCHES.add(int(n))


def check_local_feed(mesh, rows: int) -> None:
    """Raise unless ``rows`` is this rank's share of a declared global
    batch (the guard of JAX ``make_global_batch``)."""
    if mesh is None or not _DECLARED_BATCHES:
        return
    ways = mesh.size(BATCH_AXIS)
    if not any(b % ways == 0 and b // ways == rows
               for b in _DECLARED_BATCHES):
        raise ValueError(
            f"process {mesh.rank}'s feed of {rows} rows matches no declared "
            f"global batch size {sorted(_DECLARED_BATCHES)} at its "
            f"1/{ways} share — a full-global-batch feed from every "
            f"rank? Use process_sharded_loader so each rank decodes only "
            f"its row span")


def process_sharded_loader(mesh, dataset, batch_size: int, **kw):
    """BatchLoader of this rank's rows of each global batch of
    ``batch_size``; static shapes are required across ranks, so padded
    tails carry label -1 (``mask_padding``), as JAX forces under a mesh.
    With ``mesh=None`` it is the plain one-process loader."""
    from gslora_tpu_torch.data.pipeline import BatchLoader
    if mesh is None:
        return BatchLoader(dataset, batch_size, **kw)
    kw["mask_padding"] = True
    declare_global_batch(batch_size)
    bounds = host_batch_bounds(mesh, batch_size)
    return BatchLoader(dataset, batch_size, local_bounds=bounds, **kw)
