"""Maps over parameter trees (nested dicts of tensors), the port's stand-in
for ``jax.tree.map``."""
from __future__ import annotations

from typing import Callable, Dict


def tree_map(fn: Callable, *trees: Dict) -> Dict:
    """``fn`` over the leaves of trees of one structure; empty subtrees
    (a rank-0 run's ``lora``) stay."""
    first = trees[0]
    return {k: tree_map(fn, *(t[k] for t in trees)) if isinstance(v, dict)
            else fn(*(t[k] for t in trees)) for k, v in first.items()}
