"""The parameter layout of a ``(dcn, data, model)`` mesh and the
collectives the model runs under it (port of ``param_shardings``,
``replicate`` and ``place_like``, gslora_tpu/parallel/mesh.py:220-346).

JAX states a layout as a NamedSharding per leaf and lets GSPMD derive the
collectives. Here every rank builds the whole tree from one seed,
:func:`shard_tree` keeps the rank's shard of each leaf (the shard JAX's
NamedSharding gives that device), and the forward calls the collectives
itself, as autograd functions:

* tp (Megatron): :func:`copy_to_model` (f: identity forward, SUM over
  ``model`` backward) where a replicated tensor enters the sharded FFN, and
  :func:`reduce_from_model` (g: SUM over ``model`` forward, identity
  backward) where the FFN's row-parallel product leaves it;
* a class-sharded head: :func:`gather_from_model` of its scores (backward:
  the rank's columns);
* fsdp: :func:`gather_from_data`, the per-layer all_gather of a kernel's
  shards, whose backward is a reduce_scatter;
* sp (Megatron-SP): the block activations hold the rank's span of the
  tokens (:func:`token_shard`: GSPMD's padded split, 197 tokens over 2 as
  99 and 98); :func:`gather_tokens` gathers whole sequences before the
  attention (and, under tp, before the FFN: Megatron's f), its backward a
  reduce_scatter, or at the end of the stack, where the whole tokens feed
  replicated work, its backward the rank's span; :func:`scatter_tokens`
  is Megatron's g under tp (a SUM over ``model`` that keeps the rank's
  span; backward an all_gather).

The rules are JAX's: tp shards fc1 (L, d, m) by columns and its bias,
fc2 (L, m, d) by rows, LoRA B1 (L, m, r) on dim 1 and A2 (L, r, m) on
dim 2 over ``model``; fsdp the d dim of the qkv, attn_out, fc1 and fc2
kernels over ``data``; pp every stacked (L, ...) leaf of the blocks and
of the LoRA on its layer dim over ``model`` (the stages); the head
weight's class dim goes over ``model`` whenever that axis is > 1 and pp
is off. sp changes no layout. Optimizer moments follow their parameters.

On a mesh with ``--mesh_slices`` the rules are the same: fsdp shards
over ``data`` within a slice, tp, sp and pp over ``model``; every slice
holds the same shards.

Gradients (:func:`sync_grads`): under sp and pp a rank's gradient of a
leaf it holds whole inside the stack, or of the embedding, is its part of
the whole (its tokens; its stage), summed over ``model``; the head and
the final LayerNorm run replicated on the gathered (sp) or broadcast (pp)
tokens, so each rank holds their whole gradient already.

A sum over the elements of sharded leaves (a baseline's quadratic
penalty, SCRUB's per-tensor distance) is each leaf's part summed over the
axes it is sharded on (:func:`whole_sums`); a replicated leaf's part is
whole already. Every model (the face ViT, its soft split, ViT-B/16) and
LoRA position takes these rules: no rule names the attention LoRA but
pp's, so it stays replicated under tp and fsdp.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from gslora_tpu_torch.parallel.mesh import (DATA_AXIS, DCN_AXIS, MODEL_AXIS,
                                            DataMesh)

Spec = Tuple[Optional[str], ...]

# (path names to match, leaf ndim, sharded dim), gslora_tpu/parallel/
# mesh.py:220-238
_TP_RULES = (
    (("fc1", "kernel"), 3, 2),
    (("fc1", "bias"), 2, 1),
    (("fc2", "kernel"), 3, 1),
    (("ffn", "B1"), 3, 1),
    (("ffn", "A2"), 3, 2),
)
_FSDP_RULES = (
    (("qkv", "kernel"), 3, 1),
    (("attn_out", "kernel"), 3, 2),
    (("fc1", "kernel"), 3, 1),
    (("fc2", "kernel"), 3, 2),
)


def tp_on(mesh: Optional[DataMesh]) -> bool:
    return mesh is not None and mesh.tp and mesh.model > 1


def fsdp_on(mesh: Optional[DataMesh]) -> bool:
    return mesh is not None and mesh.fsdp and mesh.data > 1


def pp_on(mesh: Optional[DataMesh]) -> bool:
    return mesh is not None and mesh.pp and mesh.model > 1


def sp_on(mesh: Optional[DataMesh]) -> bool:
    return mesh is not None and mesh.sp and mesh.model > 1


def head_split(mesh: Optional[DataMesh]) -> bool:
    return mesh is not None and mesh.model > 1 and not mesh.pp


def sharded(mesh: Optional[DataMesh]) -> bool:
    """Whether any leaf is sharded under ``mesh``."""
    return head_split(mesh) or fsdp_on(mesh) or pp_on(mesh)


def leaf_spec(mesh: Optional[DataMesh], names: Sequence[str],
              shape: Sequence[int]) -> Spec:
    """The mesh axis of each dim of the leaf at path ``names`` (None:
    whole), as JAX's ``param_shardings`` places it (``shard_head=True``,
    its default and the only value its callers pass), with its
    divisibility errors."""
    spec: List[Optional[str]] = [None] * len(shape)
    if mesh is None:
        return tuple(spec)
    names = list(names)
    mp, dp = mesh.model, mesh.data
    if mesh.pp and mp > 1 and ("blocks" in names or "ffn" in names or
                               "attn" in names):
        # pipeline stages: the stacked layer dim (gslora_tpu/parallel/
        # mesh.py:272-283)
        if shape[0] % mp != 0:
            raise ValueError(
                f"pp: depth {shape[0]} of "
                f"{'/'.join(map(str, names))} not divisible by the "
                f"model axis ({mp} stages)")
        return (MODEL_AXIS,) + (None,) * (len(shape) - 1)
    if "head" in names and "weight" in names and \
            len(shape) == 2 and mp > 1 and not mesh.pp:
        if shape[0] % mp != 0:
            raise ValueError(
                f"head weight class dim {shape[0]} not divisible "
                f"by model axis {mp} — pick a model axis that divides "
                f"num_class")
        return (MODEL_AXIS, None)
    active = []
    if mesh.tp and mp > 1:
        active.append(("tp", _TP_RULES, MODEL_AXIS, mp))
    if mesh.fsdp and dp > 1:
        active.append(("fsdp", _FSDP_RULES, DATA_AXIS, dp))
    for mode, rules, axis, size in active:
        for keys, ndim, dim in rules:
            if all(k in names for k in keys) and len(shape) == ndim:
                if shape[dim] % size != 0:
                    raise ValueError(
                        f"{mode}=True: {'/'.join(map(str, names))} dim "
                        f"{dim} size {shape[dim]} not divisible "
                        f"by {axis} axis {size}")
                spec[dim] = axis
    return tuple(spec)


def take_shard(mesh: DataMesh, t: torch.Tensor, spec: Spec) -> torch.Tensor:
    """This rank's shard of the whole tensor ``t`` under ``spec``."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            t = t.chunk(mesh.size(axis), dim=dim)[mesh.index(axis)]
    return t


def _walk(tree: Dict, fn, path: Tuple[str, ...] = ()) -> Dict:
    return {k: _walk(v, fn, path + (k,)) if isinstance(v, dict)
            else fn(path + (k,), v) for k, v in tree.items()}


def shard_tree(mesh: Optional[DataMesh], tree: Dict) -> Dict:
    """This rank's shards of a whole parameter tree (every rank built the
    same one), contiguous; the tree itself without a sharding mesh."""
    if not sharded(mesh):
        return tree
    return _walk(tree, lambda path, t: take_shard(
        mesh, t, leaf_spec(mesh, path, t.shape)).contiguous())


def whole_shape(mesh: Optional[DataMesh], names: Sequence[str],
                shape: Sequence[int]) -> Tuple[int, ...]:
    """The whole shape of a shard of ``shape`` at path ``names`` (the
    shape itself for a whole one). The rules look at the ndim and the
    names only, so the shard's shape finds its spec."""
    spec = _spec_by_names(mesh, names, len(shape))
    return tuple(n * (1 if a is None else mesh.size(a))
                 for n, a in zip(shape, spec))


def _spec_by_names(mesh, names, ndim) -> Spec:
    """leaf_spec without the divisibility checks (sizes of 0 divide)."""
    return leaf_spec(mesh, names, (0,) * ndim)


def gather(mesh: DataMesh, t: torch.Tensor, spec: Spec) -> torch.Tensor:
    """The whole tensor from every rank's shard of it (no autograd)."""
    with torch.no_grad():
        for dim, axis in enumerate(spec):
            if axis is not None:
                t = mesh.all_gather(t, axis, dim)
    return t


def gather_tree(mesh: Optional[DataMesh], tree: Dict) -> Dict:
    """The whole tree from this rank's shards, on every rank (a collective:
    every rank calls it); detached tensors."""
    if not sharded(mesh):
        return tree
    return _walk(tree, lambda path, t: gather(
        mesh, t.detach(), _spec_by_names(mesh, path, t.ndim)))


def named_specs(mesh: Optional[DataMesh],
                names: Sequence[str], tensors: Sequence[torch.Tensor]
                ) -> List[Spec]:
    """The specs of parameters named by dotted paths (``nn.Module``
    names, ``base.blocks.fc1.kernel``)."""
    return [_spec_by_names(mesh, n.split("."), t.ndim)
            for n, t in zip(names, tensors)]


def fit_shard(mesh: Optional[DataMesh], t: torch.Tensor,
              shape: Sequence[int]) -> torch.Tensor:
    """``t`` cut down to a shard of ``shape`` where a dim is larger: a
    whole-over-data product (a LoRA fold) added to an fsdp kernel shard."""
    for dim, n in enumerate(shape):
        if t.shape[dim] != n:
            t = t.narrow(dim, mesh.data_index * n, n)
    return t


# ---------------------------------------------------------------------------
# the collectives of the forward, as autograd functions
# ---------------------------------------------------------------------------


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        ctx.mesh.all_reduce_([g], axis=MODEL_AXIS)
        return g, None


class _ReduceOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        out = x.contiguous().clone()
        mesh.all_reduce_([out], axis=axis)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, x.shape[dim]
        return mesh.all_gather(x, MODEL_AXIS, dim)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.mesh.model_index * ctx.n
        return g.narrow(ctx.dim, lo, ctx.n), None, None


class _GatherFromData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.all_gather(x, DATA_AXIS, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_scatter(g, DATA_AXIS, ctx.dim), None, None


def copy_to_model(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Megatron's f: ``x`` as is; its gradient summed over ``model``."""
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Megatron's g: the SUM of ``x`` over ``model``; its gradient as
    is."""
    return _ReduceOver.apply(x, mesh, MODEL_AXIS)


def whole_sums(mesh: Optional[DataMesh], names: Sequence[str],
               tensors: Sequence[torch.Tensor],
               values: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each leaf's sum over the whole leaf, from ``values[i]``, a rank's
    sum of a quantity over its shard of the leaf at dotted path
    ``names[i]`` (shaped as ``tensors[i]``): each is summed over the axes
    its leaf is sharded on (one all_reduce per set of axes), a whole
    leaf's is its own, so every rank holds the whole tree's sums; the
    gradient of each stays the rank's own (g)."""
    out = list(values)
    if not sharded(mesh):
        return out
    groups: Dict[Tuple[str, ...], List[int]] = {}
    for i, spec in enumerate(named_specs(mesh, names, tensors)):
        axes = tuple(a for a in spec if a is not None)
        if axes:
            groups.setdefault(axes, []).append(i)
    for axes, idx in groups.items():
        s = torch.stack([values[i] for i in idx])
        for axis in axes:
            s = _ReduceOver.apply(s, mesh, axis)
        for j, i in enumerate(idx):
            out[i] = s[j]
    return out


def gather_from_model(x: torch.Tensor, mesh: DataMesh,
                      dim: int = -1) -> torch.Tensor:
    """The shards of ``x`` over ``model`` concatenated along ``dim`` (the
    head's class scores); the gradient of the rank's part is its slice."""
    return _GatherFromModel.apply(x, mesh, dim % x.ndim)


def gather_from_data(x: torch.Tensor, mesh: DataMesh,
                     dim: int) -> torch.Tensor:
    """The shards of ``x`` over ``data`` concatenated along ``dim`` (an
    fsdp kernel, one layer at a time); the gradient is reduce_scattered
    back, so each rank holds its shard's SUM over the data axis."""
    return _GatherFromData.apply(x, mesh, dim % x.ndim)


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard, partial):
        ctx.shard, ctx.partial = shard, partial
        return shard.gather(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            return ctx.shard.reduce_scatter(g), None, None
        return ctx.shard.take(g), None, None


class _ScatterTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return shard.reduce_scatter(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.shard.gather(g), None


class TokenShard:
    """The rank's span [lo, hi) of ``n`` tokens over ``model`` under sp:
    GSPMD's split of a dim the axis does not divide, ceil(n / M) tokens a
    rank and the short span (or none) last. Gathers and reduce_scatters
    pad each span to ceil(n / M) rows (no autograd)."""

    def __init__(self, mesh: DataMesh, n: int):
        self.mesh, self.n = mesh, n
        self.per = -(-n // mesh.model)
        self.lo = min(mesh.model_index * self.per, n)
        self.hi = min(self.lo + self.per, n)

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's span of whole tokens (dim 1)."""
        return x[:, self.lo:self.hi]

    def _padded(self, x: torch.Tensor, rows: int) -> torch.Tensor:
        pad = rows - x.shape[1]
        if pad == 0:
            return x
        return torch.cat([x, x.new_zeros((x.shape[0], pad) +
                                         x.shape[2:])], dim=1)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        whole = self.mesh.all_gather(self._padded(x, self.per), MODEL_AXIS,
                                     1)
        return whole[:, :self.n]

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        x = self._padded(x, self.per * self.mesh.model)
        return self.mesh.reduce_scatter(x, MODEL_AXIS, 1)[
            :, :self.hi - self.lo]


def token_shard(mesh: Optional[DataMesh], n: int) -> Optional[TokenShard]:
    """The rank's span of ``n`` tokens under sp, else None."""
    return TokenShard(mesh, n) if sp_on(mesh) else None


def gather_tokens(x: torch.Tensor, shard: TokenShard,
                  partial: bool = True) -> torch.Tensor:
    """Whole sequences from each rank's span (dim 1). ``partial``: the
    rank's work on them gives only its part of their gradient (the
    attention, whose output the rank keeps its span of; the tp FFN's
    column shard), so the backward is a reduce_scatter; else (the stack's
    output, feeding replicated work) the rank's span of the gradient."""
    return _GatherTokens.apply(x, shard, partial)


def scatter_tokens(x: torch.Tensor, shard: TokenShard) -> torch.Tensor:
    """Megatron-SP's g: the SUM over ``model`` of whole-token partial
    products, the rank's span of it; the gradient is gathered whole."""
    return _ScatterTokens.apply(x, shard)


def gather_layer(mesh: Optional[DataMesh], blk: Dict) -> Dict:
    """One layer's block tensors with their fsdp shards gathered (the
    stacked rules' dims less the layer dim)."""
    if not fsdp_on(mesh):
        return blk
    out = dict(blk)
    for (name, leaf), _, dim in _FSDP_RULES:
        sub = dict(out[name])
        sub[leaf] = gather_from_data(sub[leaf], mesh, dim - 1)
        out[name] = sub
    return out


def model_partial(mesh: Optional[DataMesh], names: Sequence[str],
                  spec: Spec) -> bool:
    """Whether a rank's gradient of the leaf at ``names`` is its part of
    the whole, to be summed over ``model``: under sp or pp, every leaf not
    sharded over ``model`` but the head's and the final LayerNorm's."""
    return (sp_on(mesh) or pp_on(mesh)) and MODEL_AXIS not in spec and \
        "head" not in names and "head_ln" not in names


def sync_model_grads(mesh: Optional[DataMesh], names: Sequence[str],
                     grads: Sequence[torch.Tensor]) -> None:
    """SUM over ``model``, in place, the gradients :func:`model_partial`
    names."""
    if not (sp_on(mesh) or pp_on(mesh)):
        return
    specs = named_specs(mesh, names, grads)
    mesh.all_reduce_([g for g, s, n in zip(grads, specs, names)
                      if model_partial(mesh, n.split("."), s)],
                     axis=MODEL_AXIS)


def sync_grads(mesh: Optional[DataMesh], names: Sequence[str],
               grads: Sequence[torch.Tensor]) -> None:
    """SUM each gradient over the batch axis (dcn x data) in place, but
    those of fsdp shards, which the backward of :func:`gather_from_data`
    already summed over ``data`` within the slice: theirs cross ``dcn``
    alone. First those that are a rank's part over ``model`` (sp, pp) are
    summed over that axis."""
    if mesh is None:
        return
    sync_model_grads(mesh, names, grads)
    specs = named_specs(mesh, names, grads)
    mesh.all_reduce_([g for g, s in zip(grads, specs) if DATA_AXIS in s],
                     axis=DCN_AXIS)
    mesh.all_reduce_([g for g, s in zip(grads, specs)
                      if DATA_AXIS not in s])
