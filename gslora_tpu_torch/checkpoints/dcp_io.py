"""Rank-aware checkpoints through ``torch.distributed.checkpoint`` (port of
gslora_tpu/checkpoints/orbax_io.py, the orbax backend of SURVEY §5.4):
saves that every rank of a data-parallel run takes part in, synchronous or
with the write off the training thread. The single-file ``.pth`` path
(checkpoints/io.py) stays the default; nothing in the CLIs calls this
module, as nothing in the JAX CLIs calls orbax_io.

A checkpoint is a directory (DCP's file-system layout: one ``.distcp``
file per writing rank and a ``.metadata``). A state dict is a nested dict
of tensors, lists of tensors and plain values (a train state: parameters,
Adam moments, counts). Works in one process and under a gloo or nccl
default group: every rank calls each function with the same keys; plain
tensors count as replicated, and rank 0 writes each of them once. Given a
``mesh`` (parallel/mesh.DataMesh), the ranks the mesh uses take part, over
their own group, so that the idle ranks of a mesh smaller than the world
are not waited on (a mesh of one rank saves as one process).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional


def _planner():
    from torch.distributed.checkpoint import DefaultSavePlanner
    # replicated entries are written once, by the lowest rank holding them
    return DefaultSavePlanner(dedup_save_to_lowest_rank=True)


def _no_dist(mesh=None) -> bool:
    """One process: no group to plan over."""
    import torch.distributed as dist
    return not (dist.is_available() and dist.is_initialized()) or (
        mesh is not None and mesh.size() == 1)


def _group(mesh):
    """The mesh's ranks' group (None: the default group)."""
    from gslora_tpu_torch.parallel.mesh import MESH_GROUP
    return None if mesh is None else mesh.group(MESH_GROUP)


def _writer(path: str):
    """A file-system writer that replaces what ``path`` holds (orbax's
    ``force=True``), whatever DCP's default for ``overwrite`` is."""
    from torch.distributed.checkpoint import FileSystemWriter
    return FileSystemWriter(path, overwrite=True)


def save_dcp(path: str, state_dict: Dict[str, Any], mesh=None) -> None:
    """Write ``state_dict`` to the directory ``path`` (replaced if it
    exists, as orbax's ``force=True``); every rank of a group (of
    ``mesh``'s ranks, when given) calls it."""
    import torch.distributed.checkpoint as dcp
    path = os.path.abspath(path)
    dcp.save(state_dict, storage_writer=_writer(path), planner=_planner(),
             process_group=_group(mesh), no_dist=_no_dist(mesh))


def load_dcp(path: str, template: Optional[Dict[str, Any]] = None,
             mesh=None) -> Dict[str, Any]:
    """Read the checkpoint at ``path``. With ``template`` (a state dict of
    the same keys, shapes and dtypes) its tensors are loaded in place, on
    the template's devices, and the template is returned; without one the
    tree is rebuilt from the checkpoint's metadata, its tensors on the
    CPU (an empty subtree, which holds nothing to save, is not
    rebuilt). Under ``mesh`` its ranks read, over their group."""
    import torch
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata
    path = os.path.abspath(path)
    if template is not None:
        dcp.load(template, checkpoint_id=path, process_group=_group(mesh),
                 no_dist=_no_dist(mesh))
        return template
    meta = dcp.FileSystemReader(path).read_metadata()
    # one flat entry per saved leaf: an empty tensor of its shape and dtype,
    # or a placeholder the saved value replaces
    flat = {fqn: torch.empty(m.size, dtype=m.properties.dtype)
            if isinstance(m, TensorStorageMetadata) else None
            for fqn, m in meta.state_dict_metadata.items()}
    dcp.load(flat, checkpoint_id=path, process_group=_group(mesh),
             no_dist=_no_dist(mesh))
    out: Dict[str, Any] = {}
    for fqn, value in flat.items():
        # the leaf's path in the saved tree: dict keys and list indices
        *parents, leaf = meta.planner_data.get(fqn, (fqn,))
        node = out
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return _lists(out)


def _lists(node):
    """The rebuilt tree with each dict of list indices as a list."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        return [node[i] for i in range(len(node))]
    return node


class AsyncSaver:
    """Saves whose device-to-host copy happens in :meth:`save` and whose
    write runs on a background thread, so the training loop does not wait
    for the disk (orbax_io.AsyncSaver). One save is in flight at a time: a
    new save first waits for the last. Call :meth:`wait` before reading a
    checkpoint back, and :meth:`close` before exiting.

    Under a process group the background write exchanges its plan over a
    gloo group of its own, made here (every rank constructs the saver; of
    ``mesh``'s ranks, when given, which alone make it: the idle ranks of
    a mesh smaller than the world have left), so its collectives never
    interleave with the training thread's and a CPU backend exists also
    under nccl."""

    def __init__(self, mesh=None):
        import torch.distributed as dist
        self._group = None
        if not _no_dist(mesh):
            ranks = None if mesh is None else list(range(mesh.size()))
            self._group = dist.new_group(
                ranks, backend="gloo",
                use_local_synchronization=ranks is not None)
        self._pending = None

    def save(self, path: str, state_dict: Dict[str, Any]) -> None:
        import torch.distributed.checkpoint as dcp
        self.wait()
        self._pending = dcp.async_save(
            state_dict, storage_writer=_writer(os.path.abspath(path)),
            planner=_planner(), process_group=self._group,
            no_dist=self._group is None)

    def wait(self) -> None:
        """Block until the last save is on disk; re-raise its error."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def close(self) -> None:
        self.wait()
        if self._group is not None:
            import torch.distributed as dist
            dist.destroy_process_group(self._group)
            self._group = None
