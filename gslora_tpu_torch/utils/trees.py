"""Maps over parameter and optimizer-state trees (nested dicts and lists
of tensors), the port's stand-in for ``jax.tree.map``."""
from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, *trees: Any) -> Any:
    """``fn`` over the leaves of trees of one structure (nested dicts and
    lists); empty subtrees (a rank-0 run's ``lora``) stay. Trees whose keys
    or lengths differ raise ValueError."""
    first = trees[0]
    if isinstance(first, dict):
        for t in trees[1:]:
            if t.keys() != first.keys():
                raise ValueError(f"tree_map: keys {sorted(t)} against "
                                 f"{sorted(first)}")
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, list):
        for t in trees[1:]:
            if len(t) != len(first):
                raise ValueError(f"tree_map: {len(t)} leaves against "
                                 f"{len(first)}")
        return [tree_map(fn, *leaves) for leaves in zip(*trees)]
    return fn(*trees)
