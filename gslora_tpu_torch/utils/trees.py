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


class PairwiseSum:
    """Sum of lists of tensors given one by one, added as a balanced binary
    tree: parts 0..3 give (p0 + p1) + (p2 + p3). With the micro-batches of
    a step split evenly over two data-parallel ranks, each rank's total is
    one subtree and the ranks' all_reduce adds the last pair, so the sum
    is one process's to the bit."""

    def __init__(self):
        self._stack: list = []  # (level, parts), levels decreasing

    def add(self, parts) -> None:
        level = 0
        while self._stack and self._stack[-1][0] == level:
            _, prev = self._stack.pop()
            parts = [a + b for a, b in zip(prev, parts)]
            level += 1
        self._stack.append((level, list(parts)))

    def total(self) -> list:
        out = self._stack[0][1]
        for _, parts in self._stack[1:]:
            out = [a + b for a, b in zip(out, parts)]
        return out
