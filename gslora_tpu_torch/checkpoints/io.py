"""Checkpointing: best-H-mean retention policy (port of
gslora_tpu/checkpoints/io.py).

Reference policy (engine.py:465-497): save only on a new best H-mean,
keep at most 2 checkpoints next to config.txt; task-level
``Backbone_task_{i}`` snapshots between continual tasks. A checkpoint is
a ``torch.save`` of the flat state dict (the JAX pytree paths as names,
models/convert.py), copied to host memory.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, List

import torch

from gslora_tpu_torch.models.convert import flatten_tree, unflatten_tree
from gslora_tpu_torch.parallel import sharding
from gslora_tpu_torch.utils.trees import tree_map


def save_params(path: str, tree: Any) -> None:
    """torch.save the parameter tree as a flat CPU state dict."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in flatten_tree(tree).items()},
               path)


def load_params(path: str) -> Any:
    """The parameter tree :func:`save_params` wrote (CPU tensors), the
    counterpart of the JAX package's ``load_pytree``; ``"lora"`` is present
    (empty for a rank-0 checkpoint)."""
    flat = torch.load(path, map_location="cpu", weights_only=True)
    tree = unflatten_tree(flat)
    tree.setdefault("lora", {})
    return tree


def get_time() -> str:
    return time.strftime("%Y-%m-%d-%H-%M-%S", time.localtime())


class BestHCheckpointer:
    """Best-H-mean gated saver, pruning to ``keep`` checkpoints.

    ``async_save=True``: the device->host copy stays inline (the values at
    save time are what land on disk) but the disk write moves to a daemon
    thread, so the eval/train loop never blocks on IO."""

    def __init__(self, workdir: str, name: str = "VIT", keep: int = 2,
                 async_save: bool = False):
        self.workdir = workdir
        self.name = name
        self.keep = keep
        self.best_h = float("-inf")
        self._saved: List[str] = []
        self._pending = None
        self._error: BaseException | None = None
        self.async_save = async_save
        os.makedirs(workdir, exist_ok=True)

    def save_config(self, cfg_json: str) -> None:
        with open(os.path.join(self.workdir, "config.txt"), "w") as f:
            f.write(cfg_json)

    def maybe_save(self, h: float, tree: Any, epoch: int, batch: int) -> bool:
        """Save iff h beats the best so far (engine.py:465); prune oldest
        beyond ``keep``. Returns True if saved."""
        if h <= self.best_h:
            return False
        self.best_h = h
        fname = (f"Backbone_{self.name}_Epoch_{epoch + 1}_Batch_{batch + 1}"
                 f"_Time_{get_time()}_checkpoint.pth")
        path = os.path.join(self.workdir, fname)
        if self.async_save:
            # a copy: the optimizer updates the parameters in place
            host_tree = {k: v.detach().to("cpu", copy=True)
                         for k, v in flatten_tree(tree).items()}
            self.wait()  # raises here if the previous background save died

            def _write():
                try:
                    save_params(path, host_tree)
                except BaseException as e:  # surfaced by the next wait()
                    self._error = e

            t = threading.Thread(target=_write, daemon=True)
            t.start()
            self._pending = t
        else:
            save_params(path, tree)
        self._saved.append(path)
        while len(self._saved) > self.keep:
            old = self._saved.pop(0)
            if os.path.exists(old):
                os.remove(old)
        return True

    def wait(self) -> None:
        """Drain the in-flight async save; re-raise a background write
        failure instead of silently reporting a checkpoint that was never
        written."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"async checkpoint write failed: {err!r}") from err

    def latest(self) -> str | None:
        return self._saved[-1] if self._saved else None


def _per_leaf(state: Any, opt_state: Any, fn) -> Any:
    """``opt_state`` with ``fn(tensor, name)`` applied to each tensor of
    its per-parameter lists (Adam's moments, a trace), which follow the
    trainable parameters' order."""
    names = state.trainable_names()
    return {k: [fn(t, n) for t, n in zip(v, names)]
            if isinstance(v, list) and len(v) == len(names) else v
            for k, v in opt_state.items()}


def save_train_state(path: str, state: Any, mesh=None) -> None:
    """Full snapshot of a ForgetState or PretrainState (parameters,
    optimizer state, step) for recovery in the middle of a task, finer
    than the reference's per-task granularity (SURVEY §5.3: a crash there
    loses the task's progress). Tensors are copied to host memory.

    ``mesh`` (parallel/mesh.DataMesh): every rank calls it; the parameters
    and the optimizer's per-parameter tensors are gathered whole (the
    names of one process's snapshot) and rank 0 writes."""
    def whole(t, name):
        return sharding.gather(mesh, t, sharding.named_specs(
            mesh, [name], [t])[0]) if sharding.sharded(mesh) else t

    params = flatten_tree(sharding.gather_tree(mesh, state.params))
    opt_state = _per_leaf(state, state.opt_state, whole)
    if mesh is not None and not mesh.is_main:
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"params": {k: v.detach().cpu() for k, v in params.items()},
                "opt_state": tree_map(
                    lambda x: x.detach().cpu() if isinstance(
                        x, torch.Tensor) else x, opt_state),
                "step": state.step}, path)


def restore_train_state(path: str, template: Any, mesh=None) -> Any:
    """Load a :func:`save_train_state` snapshot into ``template``, a fresh
    state of the same model, optimizer and trainable scope (the JAX
    package's restore into a template pytree): the parameters are copied
    in place (shapes and dtypes checked), the optimizer's tensors moved to
    the template's device. Returns the template. Under a sharding
    ``mesh`` the template holds the rank's shards, and each takes its
    shard of the whole snapshot (JAX's ``place_like``)."""
    snap = torch.load(path, map_location="cpu", weights_only=True)

    def shard(t, name):
        if not sharding.sharded(mesh):
            return t
        return sharding.take_shard(mesh, t, sharding.leaf_spec(
            mesh, name.split("."), t.shape))

    own = dict(template.model.named_parameters())
    if set(own) != set(snap["params"]):
        diff = sorted(set(own) ^ set(snap["params"]))
        raise KeyError(f"restore {path}: parameters differ from the "
                       f"template's: {diff[:5]}")
    with torch.no_grad():
        for name, p in own.items():
            _copy_into(p, shard(snap["params"][name], name),
                       f"{path}: {name}")

    def restored(t, saved):
        # optimizer tensors move to the template's device in their saved
        # dtype (RMSprop's trace of bf16 parameters turns fp32 after its
        # first update); plain values (the step count) are taken as saved
        if not isinstance(t, torch.Tensor):
            return saved
        if t.shape != saved.shape:
            raise ValueError(f"restore {path}: optimizer tensor of shape "
                             f"{tuple(saved.shape)} where the template has "
                             f"{tuple(t.shape)}")
        return saved.to(t.device)

    template.opt_state = tree_map(
        restored, template.opt_state,
        _per_leaf(template, snap["opt_state"], shard))
    template.step = snap["step"]
    return template


def _copy_into(dst: torch.Tensor, src: torch.Tensor, what: str) -> None:
    if dst.shape != src.shape or dst.dtype != src.dtype:
        raise ValueError(f"restore {what}: {tuple(src.shape)} {src.dtype} "
                         f"where the template has {tuple(dst.shape)} "
                         f"{dst.dtype}")
    dst.copy_(src)


def save_task_checkpoint(workdir: str, task: int, tree: Any,
                         extra: dict | None = None) -> str:
    """Per-task snapshot (train_own_forget_cl.py:1696-1714):
    ``task-level/Backbone_task_{task}.pth`` in the :func:`save_params`
    format, and ``task_{task}_meta.json`` with ``extra``."""
    tdir = os.path.join(workdir, "task-level")
    os.makedirs(tdir, exist_ok=True)
    path = os.path.join(tdir, f"Backbone_task_{task}.pth")
    save_params(path, tree)
    if extra:
        with open(os.path.join(tdir, f"task_{task}_meta.json"), "w") as f:
            json.dump(extra, f, indent=2)
    return path
