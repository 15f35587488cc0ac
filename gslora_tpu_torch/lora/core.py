"""Stacked LoRA parameter trees: init / merge / reinit / group-Lasso.

Port of ``gslora_tpu/lora/core.py``. LoRA factors for all L transformer
blocks are stacked on a leading layer axis — ``A1[L, r, d]``,
``B1[L, m, r]``, ``A2[L, r, m]``, ``B2[L, d, r]`` (Attention placement:
``A[L, 3, r, d]``, ``B[L, 3, inner, r]``) — so the group-Lasso over
per-block groups and the merge are reductions over the layer axis.

loralib semantics: forward adds ``x @ A^T @ B^T * (alpha/r)``; init A ~
kaiming-uniform(a=sqrt(5)), B = 0; between continual tasks A is re-drawn
with a=sqrt(50) and B zeroed (util/utils.py:428-441).
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from gslora_tpu_torch.config import LoraConfig, ViTConfig
from gslora_tpu_torch.parallel import sharding
from gslora_tpu_torch.parallel.mesh import MODEL_AXIS, active_mesh
from gslora_tpu_torch.utils.inits import kaiming_uniform

LoraTree = Dict[str, Dict[str, torch.Tensor]]


def _init_stacked_A(generator, depth: int, rank: int, fan_in: int, a: float,
                    dtype):
    # one independent kaiming draw per layer, stacked on axis 0
    return torch.stack([kaiming_uniform(generator, (rank, fan_in), a=a,
                                        dtype=dtype) for _ in range(depth)])


def init_lora(generator, model: ViTConfig, lora: LoraConfig,
              dtype=torch.float32) -> LoraTree:
    """Fresh LoRA tree (on the CPU) for the configured placement."""
    if lora.rank <= 0:
        return {}
    L, d, m, r = model.depth, model.dim, model.mlp_dim, lora.rank
    a = math.sqrt(5)
    if lora.pos == "FFN":
        return {"ffn": {
            "A1": _init_stacked_A(generator, L, r, d, a, dtype),
            "B1": torch.zeros((L, m, r), dtype=dtype),
            "A2": _init_stacked_A(generator, L, r, m, a, dtype),
            "B2": torch.zeros((L, d, r), dtype=dtype),
        }}
    if lora.pos == "Attention":
        A = torch.stack([_init_stacked_A(generator, L, r, d, a, dtype)
                         for _ in range(3)], dim=1)  # (L, 3, r, d)
        return {"attn": {
            "A": A,
            "B": torch.zeros((L, 3, model.inner_dim, r), dtype=dtype),
        }}
    raise ValueError(f"unknown lora pos {lora.pos}")


def reinit_lora(generator, lora_tree: LoraTree,
                a: float = math.sqrt(50)) -> LoraTree:
    """Between continual tasks: A <- kaiming-uniform(a=sqrt(50)) (~=0), B <- 0
    (util/utils.py:428-441). Draws on the CPU generator, then moves each
    tensor to its original device. A tensor sharded under the active mesh
    (A2 under tp) is drawn whole and the rank keeps its shard, so the
    stream is one process's."""
    mesh = active_mesh()
    out: LoraTree = {}
    for pos, sub in lora_tree.items():
        out[pos] = {}
        for name, arr in sub.items():
            if name.startswith("A"):
                path = ("lora", pos, name)
                shape = sharding.whole_shape(mesh, path, arr.shape)
                # one draw per (layer[, chunk]) matrix of shape (r, fan_in)
                mats = [kaiming_uniform(generator, tuple(shape[-2:]), a=a,
                                        dtype=arr.dtype)
                        for _ in range(math.prod(shape[:-2]))]
                whole = torch.stack(mats).reshape(shape)
                out[pos][name] = sharding.take_shard(
                    mesh, whole, sharding.leaf_spec(mesh, path, shape)).to(
                        arr.device)
            else:
                out[pos][name] = torch.zeros_like(arr)
    return out


def lora_delta(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
               scaling: float) -> torch.Tensor:
    """Low-rank update ``x @ A^T @ B^T * scaling`` for one layer.

    x: (..., fan_in); A: (r, fan_in); B: (fan_out, r). Two skinny matmuls —
    B@A (fan_in x fan_out) is never materialized."""
    h = x @ A.to(x.dtype).t()
    return (h @ B.to(x.dtype).t()) * scaling


def merge_lora(base_blocks: dict, lora_tree: LoraTree,
               scaling: float) -> dict:
    """Pure merge: block params with ``kernel += scaling * (B A)^T``.

    Kernels are stored (fan_in, fan_out); the delta per layer is
    ``A^T @ B^T``, batched over the stacked layer axis (the FFN's also of
    one layer's tensors). Gradients flow through the fold into A and B.
    On the shards of a mesh (parallel/sharding) the tp dims of the FFN
    factors and kernels agree; an fsdp kernel shard takes its rows or
    columns of the delta."""
    blocks = dict(base_blocks)
    if not lora_tree:
        return blocks
    mesh = active_mesh()

    def add(kernel, delta):
        delta = sharding.fit_shard(mesh, delta, kernel.shape)
        return kernel + delta.to(kernel.dtype)

    if "ffn" in lora_tree:
        f = lora_tree["ffn"]
        d1 = torch.einsum("...rd,...mr->...dm", f["A1"], f["B1"]) * scaling
        d2 = torch.einsum("...rm,...dr->...md", f["A2"], f["B2"]) * scaling
        fc1, fc2 = dict(blocks["fc1"]), dict(blocks["fc2"])
        fc1["kernel"] = add(fc1["kernel"], d1)
        fc2["kernel"] = add(fc2["kernel"], d2)
        blocks["fc1"], blocks["fc2"] = fc1, fc2
    if "attn" in lora_tree:
        a = lora_tree["attn"]
        # (L, 3, r, d) x (L, 3, inner, r) -> (L, d, 3, inner) -> (L, d, 3*inner)
        delta = torch.einsum("lcrd,lcor->ldco", a["A"], a["B"]) * scaling
        delta = delta.reshape(delta.shape[0], delta.shape[1], -1)
        qkv = dict(blocks["qkv"])
        qkv["kernel"] = add(qkv["kernel"], delta)
        blocks["qkv"] = qkv
    return blocks


def _per_layer_sq(arr: torch.Tensor) -> torch.Tensor:
    """Sum of squares per leading-layer index -> (L,) in fp32."""
    a = arr.float()
    return torch.sum(a.reshape(a.shape[0], -1) ** 2, dim=-1)


def _ffn_sq(ffn: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per-layer sums of squares of the FFN factors; under tp (the active
    mesh's) B1 and A2 hold shards, whose partial sums are summed over
    ``model`` (g: the gradient of each shard stays its own)."""
    mesh = active_mesh()
    sq = {k: _per_layer_sq(v) for k, v in ffn.items()}
    if sharding.tp_on(mesh):
        for k in ("B1", "A2"):
            sq[k] = sharding.reduce_from_model(sq[k], mesh)
    return sq


def group_lasso(lora_tree: LoraTree, group_type: str = "block",
                group_pos: str = "FFN") -> torch.Tensor:
    """Sparse group-Lasso  sum_g sqrt(sum_{p in g} ||p||^2)
    (engine.py:532-687, groups as layer-axis reductions):
      block  — one group per transformer block {A1,B1,A2,B2}      (L groups)
      lora   — per block {A1,B1} and {A2,B2}                       (2L groups)
      matrix — every tensor its own group                          (4L groups)
    Attention placement groups {A,B} per block (engine.py:652-656)."""
    if not lora_tree:
        return torch.zeros(())
    # eps inside the sqrt keeps the gradient finite for all-zero groups
    # (B=0 at init): d/dp sqrt(sum p^2 + eps) = p/sqrt(.) = 0 at p = 0
    eps = 1e-12

    def root(s):
        return torch.sqrt(s + eps)

    mesh = active_mesh()
    if group_pos == "FFN":
        sq = _ffn_sq(lora_tree["ffn"])
        if group_type == "block":
            total = torch.sum(root(sq["A1"] + sq["B1"] + sq["A2"] +
                                   sq["B2"]))
        elif group_type == "lora":
            total = torch.sum(root(sq["A1"] + sq["B1"])) + torch.sum(
                root(sq["A2"] + sq["B2"]))
        elif group_type == "matrix":
            total = sum(torch.sum(root(s)) for s in sq.values())
        else:
            raise ValueError("group_type should be block or lora or matrix")
    elif group_pos == "Attention":
        # no tp rule shards the attention LoRA: its squares are whole
        a = lora_tree["attn"]
        total = torch.sum(root(_per_layer_sq(a["A"]) +
                               _per_layer_sq(a["B"])))
    else:
        raise ValueError(f"unknown group_pos {group_pos}")
    if sharding.pp_on(mesh):
        # each stage holds its layers' groups: the sum over the stages
        # (g: each stage's gradient stays its layers')
        total = sharding.reduce_from_model(total, mesh)
    return total


@torch.no_grad()
def lora_group_norms(lora_tree: LoraTree, group_pos: str = "FFN",
                     ord: int = 2) -> List[float]:
    """Per-block group norms (reference util/cal_norm.py:get_norm_of_lora)."""
    if not lora_tree:
        return []
    mesh = active_mesh()

    def whole(norms):
        # under pp each stage holds its layers: the stages' in order
        if sharding.pp_on(mesh):
            norms = mesh.all_gather(norms, MODEL_AXIS, 0)
        return [float(x) for x in norms]

    if group_pos == "FFN":
        f = lora_tree["ffn"]
        if ord == 2:
            sq = _ffn_sq(f)
            sq = sum(sq[k] for k in ("A1", "B1", "A2", "B2"))
            return whole(torch.sqrt(sq))
        l1 = {k: torch.sum(v.float().abs().reshape(v.shape[0], -1), dim=-1)
              for k, v in f.items()}
        if sharding.tp_on(mesh):
            # B1 and A2 hold shards: their sums over ``model``
            for k in ("B1", "A2"):
                l1[k] = sharding.reduce_from_model(l1[k], mesh)
        return whole(sum(l1[k] for k in ("A1", "B1", "A2", "B2")))
    a = lora_tree["attn"]
    sq = _per_layer_sq(a["A"]) + _per_layer_sq(a["B"])
    return whole(torch.sqrt(sq))
