"""Face Vision Transformer with stacked LoRA (port of gslora_tpu/models/vit.py).

Pre-norm transformer, learnable pos-embed + CLS, LayerNorm "mlp_head" on
the CLS token, margin head on top (reference vit_face.py:449-548). The
parameters keep the JAX package's layout: one nested dict
``{"base": ..., "lora": ...}`` whose block tensors are stacked on a leading
layer axis, kernels stored (fan_in, fan_out). :class:`ViT` holds that
tree as an ``nn.Module`` whose parameter names are the JAX pytree paths
(``base.blocks.fc1.kernel``, ``lora.ffn.A1``, ...); the forward functions
take the tree itself.

Casts are explicit where the JAX code makes them (no autocast): matmuls and
activations in ``compute_dtype``, LayerNorm, GELU and heads in fp32.
Reference quirks kept: erf GELU, (p1 p2 c) patch layout, attention scale
dim**-0.5 (vit_face.py:346).

Attention (``ViTConfig.attn_impl``): "auto" and "pallas" go to the fused
attention of ops/attention.py (for tensors on the card the CUDA kernel of
the compute dtype, bf16 or fp32; its plain version on the CPU; any other
dtype on the card raises); "dpa" goes to that plain version on any
device (fp32 scores, as ``jax.nn.dot_product_attention``); "xla" and
"bnhd" run the JAX model's einsums, whose scores are rounded to the
compute dtype before the fp32 softmax. Dropout draws from an explicit
``torch.Generator`` with the "uniform" semantics; the TPU RNG variants
(``bits*``) map to it.

Under the active mesh's sp and pp (parallel/sharding, parallel/pipeline)
the fused attention stays on both paths, on whole sequences, where JAX
switches to its einsums (vit.py:236-243,388): a choice of kernel, not of
result.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from gslora_tpu_torch.config import (IMAGENET_MEAN, IMAGENET_STD, LoraConfig,
                                     ViTConfig)
from gslora_tpu_torch.lora.core import init_lora, lora_delta, merge_lora
from gslora_tpu_torch.models.convert import flatten_tree, unflatten_tree
from gslora_tpu_torch.models.heads import apply_head
from gslora_tpu_torch.ops.attention import fused_attention_bhnd
from gslora_tpu_torch.ops.quant import int8_linear
from gslora_tpu_torch.parallel import sharding
from gslora_tpu_torch.parallel.mesh import active_mesh
from gslora_tpu_torch.parallel.pipeline import pipeline_stack
from gslora_tpu_torch.utils.inits import (kaiming_uniform, lecun_linear_bias,
                                          xavier_normal, xavier_uniform)

Params = Dict


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _linear_init(generator, fan_in: int, fan_out: int, dtype,
                 bias: bool = True):
    """torch nn.Linear default init; kernel stored (fan_in, fan_out)."""
    w = kaiming_uniform(generator, (fan_out, fan_in), a=math.sqrt(5),
                        dtype=dtype).t().contiguous()
    p = {"kernel": w}
    if bias:
        p["bias"] = lecun_linear_bias(generator, fan_in, (fan_out,), dtype)
    return p


def _stack_linears(generator, depth, fan_in, fan_out, dtype, bias=True):
    ps = [_linear_init(generator, fan_in, fan_out, dtype, bias)
          for _ in range(depth)]
    return {k: torch.stack([p[k] for p in ps]) for k in ps[0]}


def init_vit_params(generator: torch.Generator, model: ViTConfig,
                    lora: Optional[LoraConfig] = None,
                    param_dtype=torch.float32) -> Params:
    """Build the {"base": ..., "lora": ...} tree on the CPU from a CPU
    generator (LoRA always fp32, as in the JAX package)."""
    d, L, m, inner = model.dim, model.depth, model.mlp_dim, model.inner_dim
    dt = param_dtype

    def ln(shape):
        return {"scale": torch.ones(shape, dtype=dt),
                "bias": torch.zeros(shape, dtype=dt)}

    blocks = {
        "attn_ln": ln((L, d)),
        "qkv": _stack_linears(generator, L, d, 3 * inner, dt,
                              bias=model.qkv_bias),
        "attn_out": _stack_linears(generator, L, inner, d, dt),
        "ffn_ln": ln((L, d)),
        "fc1": _stack_linears(generator, L, d, m, dt),
        "fc2": _stack_linears(generator, L, m, d, dt),
    }
    base = {
        "patch": _linear_init(generator, model.patch_dim, d, dt),
        "cls_token": torch.randn((d,), generator=generator).to(dt),
        "pos_embed": torch.randn((model.seq_len, d), generator=generator).to(dt),
        "blocks": blocks,
        "head_ln": ln((d,)),
    }
    if model.head_type != "None":
        C = model.num_class
        if model.head_type == "Softmax":
            base["head"] = {"weight": xavier_uniform(generator, (C, d),
                                                     dtype=dt),
                            "bias": torch.zeros((C,), dtype=dt)}
        elif model.head_type == "SFace":
            base["head"] = {"weight": xavier_normal(generator, (C, d),
                                                    gain=2.0, dtype=dt)}
        else:  # CosFace / ArcFace: xavier uniform (vit_face.py:169,98)
            base["head"] = {"weight": xavier_uniform(generator, (C, d),
                                                     dtype=dt)}
    lora_tree = init_lora(generator, model, lora, dtype=torch.float32) \
        if (lora is not None and lora.rank > 0) else {}
    return {"base": base, "lora": lora_tree}


class _Node(nn.Module):
    """One level of a parameter tree: tensors become parameters (copies:
    training updates them in place), dicts become child nodes, under the
    tree's own keys."""

    def __init__(self, tree: Dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, _Node(value))
            else:
                self.register_parameter(
                    name, nn.Parameter(value.detach().clone()))

    def tree(self) -> Dict:
        out = {name: p for name, p in self._parameters.items()}
        out.update({name: m.tree() for name, m in self._modules.items()})
        return out


class ViT(nn.Module):
    """The ViT's parameters as an nn.Module (names = JAX pytree paths);
    ``forward`` is :func:`vit_apply` on them."""

    def __init__(self, params: Params, model: ViTConfig, lora: LoraConfig):
        super().__init__()
        self.cfg, self.lora_cfg = model, lora
        self.base = _Node(params["base"])
        self.lora = _Node(params.get("lora", {}))

    def tree(self) -> Params:
        return {"base": self.base.tree(), "lora": self.lora.tree()}

    def forward(self, images, labels=None, **kwargs):
        return vit_apply(self.tree(), images, labels, self.cfg,
                         self.lora_cfg, **kwargs)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _layer_norm(x, scale, bias, eps: float = 1e-5, ln_dtype: str = "fp32"):
    """LayerNorm in fp32 (torch nn.LayerNorm eps=1e-5); ``ln_dtype="bf16"``
    keeps the input dtype (ViTConfig.ln_dtype)."""
    xf = x.float() if ln_dtype == "fp32" else x
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y * scale.to(xf.dtype) + bias.to(xf.dtype)


def _proj(x, kernel, model: ViTConfig):
    """x @ kernel for the projection GEMMs (qkv, attn_out, fc1, fc2 and the
    patch embedding), by ``model.gemm_impl``: "default" in the compute
    dtype; "int8" W8A8 dynamic quantization of x and of the kernel as
    stored (ops/quant.int8_linear, eval only), out in the compute dtype."""
    if model.gemm_impl == "int8":
        return int8_linear(x, kernel, out_dtype=x.dtype)
    return x @ kernel.to(x.dtype)


def _dropout(x, rate: float, generator, deterministic: bool,
             shards: int = 1, index: int = 0, tokens=None):
    """Keep with probability 1-rate and scale by 1/keep (vit.py:170-172).
    ``x`` the ``index``-th of ``shards`` column shards of a tensor (the
    tp-sharded FFN hidden), or the span of ``tokens`` (an sp
    parallel/sharding.TokenShard) of the whole sequence: the mask is that
    slice of the whole tensor's draw, so every rank of a model group draws
    as one process does."""
    if deterministic or rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    shape = x.shape[:-1] + (x.shape[-1] * shards,)
    if tokens is not None:
        shape = shape[:1] + (tokens.n,) + shape[2:]
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if shards > 1:
        mask = mask.chunk(shards, dim=-1)[index]
    if tokens is not None:
        mask = tokens.take(mask)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def patchify(images, model: ViTConfig):
    """(B, C, H, W) -> (B, N, patch_dim) tokens.

    Hard split (ViT_face, vit_face.py:530): token layout (p1 p2 c).
    Soft split (ViTs_face, vits_face.py:446-450, and ViT-B/16's conv
    patch-embed with kernel = stride = 16, pad 0): overlapping unfold with
    channel-major (c kh kw) features, the order ``F.unfold`` gives."""
    if model.soft_split:
        patches = torch.nn.functional.unfold(
            images, kernel_size=model.ac_patch_size,
            stride=model.patch_size, padding=model.pad)  # (B, C*k*k, N)
        return patches.transpose(1, 2)
    p = model.patch_size
    b, c, hh, ww = images.shape
    x = images.reshape(b, c, hh // p, p, ww // p, p)
    x = x.permute(0, 2, 4, 3, 5, 1)  # b h w p1 p2 c
    return x.reshape(b, (hh // p) * (ww // p), p * p * c)


def _attention_block(x, blk, lora_blk, model: ViTConfig, scaling: float,
                     generator, deterministic: bool, tokens=None):
    """Pre-norm MHA with residual (vit_face.py:341-379). Under sp
    (``tokens``, the rank's parallel/sharding.TokenShard) ``x`` holds the
    rank's span of the tokens: the normed span is gathered into whole
    sequences, the attention runs on them (the fused kernel on whole
    (B·H, n, d) slices), and the rank keeps its span of the attention's
    output before the output projection."""
    cdt = x.dtype
    h = _layer_norm(x, blk["attn_ln"]["scale"], blk["attn_ln"]["bias"],
                    ln_dtype=model.ln_dtype).to(cdt)
    if tokens is not None:
        h = sharding.gather_tokens(h, tokens)
    qkv = _proj(h, blk["qkv"]["kernel"], model)
    if "bias" in blk["qkv"]:
        qkv = qkv + blk["qkv"]["bias"].to(cdt)
    if lora_blk and "attn" in lora_blk:
        A, B = lora_blk["attn"]["A"], lora_blk["attn"]["B"]
        qkv = qkv + torch.cat([lora_delta(h, A[c], B[c], scaling)
                               for c in range(3)], dim=-1)
    b, n = h.shape[0], h.shape[1]
    hd = model.dim_head

    def heads(t):  # (b, n, h*d) -> (b, h, n, d)
        return t.reshape(b, n, -1, hd).transpose(1, 2)

    q, k, v = (heads(t) for t in qkv.chunk(3, dim=-1))
    # vit_face quirk: dim**-0.5 (vit_face.py:346); "dim_head" = standard
    scale = (model.dim if model.attn_scale == "dim" else model.dim_head) \
        ** -0.5
    if model.attn_impl in ("xla", "bnhd"):
        # the JAX einsum path (vit.py:295-297): scores in the compute dtype,
        # softmax in fp32; "bnhd" is the same function in another layout
        dots = torch.einsum("bhid,bhjd->bhij", q, k) * scale
        attn = torch.softmax(dots.float(), dim=-1).to(cdt)
        out = torch.einsum("bhij,bhjd->bhid", attn, v)
    else:
        # "dpa" keeps fp32 scores, as jax.nn.dot_product_attention does:
        # the fused attention's plain version on any device
        out = fused_attention_bhnd(q, k, v, scale,
                                   plain=model.attn_impl == "dpa")
    out = out.transpose(1, 2).reshape(b, n, -1)
    if tokens is not None:
        out = tokens.take(out)
    out = _proj(out, blk["attn_out"]["kernel"], model)
    out = out + blk["attn_out"]["bias"].to(cdt)
    out = _dropout(out, model.dropout, generator, deterministic,
                   tokens=tokens)
    return x + out


def _tp_lora(lora_blk, mesh):
    """The FFN LoRA factors that stay whole under tp (A1, B2) but meet
    sharded ones (B1, A2) in a product: through f, so that their gradient,
    partial on each model rank, is summed over ``model``. Not under sp,
    where parallel/sharding.sync_grads sums their gradients, partial over
    the tokens too, with those of the other leaves held whole."""
    if not sharding.tp_on(mesh) or sharding.sp_on(mesh) or not lora_blk \
            or "ffn" not in lora_blk:
        return lora_blk
    f = dict(lora_blk["ffn"])
    f["A1"] = sharding.copy_to_model(f["A1"], mesh)
    f["B2"] = sharding.copy_to_model(f["B2"], mesh)
    return {**lora_blk, "ffn": f}


def _ffn_block(x, blk, lora_blk, model: ViTConfig, scaling: float, generator,
               deterministic: bool, tokens=None):
    """Pre-norm LoRA-FFN with residual (vit_face.py:326-338): where the
    GS-LoRA trainable parameters live.

    Under tp (the active mesh's, parallel/sharding) fc1 and B1 hold this
    rank's columns of the hidden, fc2 and A2 its rows: the normed input
    enters through f, the row-parallel output leaves through g (a SUM over
    ``model``, in fp32), and fc2's bias is added once, after the sum.
    Under sp (``tokens``) ``x`` is the rank's span of the tokens: without
    tp the FFN runs on it; with tp f and g become Megatron-SP's gather of
    whole sequences and reduce_scatter back to the span."""
    mesh = active_mesh()
    tp = sharding.tp_on(mesh)
    cdt = x.dtype
    h = _layer_norm(x, blk["ffn_ln"]["scale"], blk["ffn_ln"]["bias"],
                    ln_dtype=model.ln_dtype).to(cdt)
    whole = None if tp else tokens  # the span the hidden holds, if any
    if tp and tokens is not None:
        h = sharding.gather_tokens(h, tokens)
    elif tp:
        h = sharding.copy_to_model(h, mesh)
    lora_blk = _tp_lora(lora_blk, mesh)
    u = _proj(h, blk["fc1"]["kernel"], model) + blk["fc1"]["bias"].to(cdt)
    if lora_blk and "ffn" in lora_blk:
        u = u + lora_delta(h, lora_blk["ffn"]["A1"], lora_blk["ffn"]["B1"],
                           scaling)
    if model.gelu_impl == "erf":
        # torch nn.GELU parity: exact erf in fp32
        u = torch.nn.functional.gelu(u.float()).to(cdt)
    elif model.gelu_impl == "erf_bf16":
        u = torch.nn.functional.gelu(u)
    else:  # "tanh" — parity-diverging ablation
        u = torch.nn.functional.gelu(u, approximate="tanh")
    u = _dropout(u, model.dropout, generator, deterministic,
                 *((mesh.model, mesh.model_index) if tp else ()),
                 tokens=whole)
    y = _proj(u, blk["fc2"]["kernel"], model)
    if not tp:
        y = y + blk["fc2"]["bias"].to(cdt)
    if lora_blk and "ffn" in lora_blk:
        y = y + lora_delta(u, lora_blk["ffn"]["A2"], lora_blk["ffn"]["B2"],
                           scaling)
    if tp:
        # the partial products are summed in fp32, so the whole is rounded
        # to the compute dtype once, as one process's GEMM rounds it
        y = sharding.scatter_tokens(y.float(), tokens) if tokens is not None \
            else sharding.reduce_from_model(y.float(), mesh)
        y = y.to(cdt) + blk["fc2"]["bias"].to(cdt)
    y = _dropout(y, model.dropout, generator, deterministic, tokens=tokens)
    return x + y


def _layer(tree: Dict, i: int) -> Dict:
    """Layer i of a tree of stacked [L, ...] tensors."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _rematerialized(fn, x, generator):
    """``fn(x)`` under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are dropped after the forward and recomputed in the
    backward. The checkpoint stashes only the global RNGs, so the explicit
    dropout generator is handled here: the recompute starts from the
    generator state the forward started from, and the generator is put
    back where it was afterwards, so the recompute draws the forward's
    masks and later draws are untouched."""
    if generator is None:
        return checkpoint(fn, x, use_reentrant=False,
                          preserve_rng_state=False)
    start = generator.get_state()
    calls = []

    def run(x):
        if not calls:  # the forward itself
            calls.append(1)
            return fn(x)
        after = generator.get_state()
        generator.set_state(start)
        try:
            return fn(x)
        finally:
            generator.set_state(after)

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


def transformer_stack(x, blocks: Params, lora_tree: Params, model: ViTConfig,
                      scaling: float, generator, deterministic: bool,
                      layer_range: Optional[Tuple[int, int]] = None,
                      fold: bool = False):
    """Apply the stacked transformer blocks, one layer after another.
    ``layer_range=(lo, hi)`` runs only layers [lo, hi) of the stack (the
    LIRF low/up split, vit_face.py:382-446, as a slice of the stacked
    parameters; a half-depth stack takes (0, depth // 2)); the default is
    the model's whole depth. ``model.remat`` checkpoints each layer while
    autograd records (the JAX package's ``jax.checkpoint`` on the scan
    body, vit.py:424): the backward reruns each layer's forward, attention
    included.

    Under fsdp (the active mesh's) each layer gathers its kernels' shards
    over ``data`` inside the layer function, so a rematerialized layer
    gathers again in its recompute and only one layer is ever whole;
    ``fold`` then merges the layer's LoRA into the gathered kernels (the
    merged apply mode).

    Under sp the stack keeps the rank's span of the tokens between the
    layers (``x`` comes in whole, replicated over ``model``) and gathers
    whole sequences at its end (parallel/sharding.gather_tokens). Under pp
    (JAX's pipeline branch, vit.py:372-405) the whole stack runs as the
    GPipe schedule over the stages' local layers (parallel/pipeline), each
    layer rematerialized inside its stage under ``model.remat``; as in
    JAX only the whole stack pipelines, and a ``layer_range`` (the LIRF
    split, whose baselines refuse pp) raises here."""
    remat = model.remat and torch.is_grad_enabled()
    mesh = active_mesh()

    def run(x, blk, lora_blk, tokens=None):
        def layer(x):
            b = sharding.gather_layer(mesh, blk)
            lb = lora_blk
            if fold:
                b = merge_lora(b, _tp_lora(lb, mesh), scaling)
                lb = None
            x = _attention_block(x, b, lb, model, scaling, generator,
                                 deterministic, tokens)
            return _ffn_block(x, b, lb, model, scaling, generator,
                              deterministic, tokens)

        return _rematerialized(layer, x, generator) if remat else layer(x)

    if sharding.pp_on(mesh):
        if layer_range is not None:
            raise NotImplementedError(
                "a layer_range of the stack under --pp is not ported: the "
                "pipeline runs the whole stack")
        flat_b, flat_l = flatten_tree(blocks), flatten_tree(lora_tree or {})
        nb, n_local = len(flat_b), next(iter(flat_b.values())).shape[0]

        def stage(x, leaves):
            blk_tree = unflatten_tree(dict(zip(flat_b, leaves[:nb])))
            lora_loc = unflatten_tree(dict(zip(flat_l, leaves[nb:])))
            for j in range(n_local):
                x = run(x, _layer(blk_tree, j),
                        _layer(lora_loc, j) if lora_loc else None)
            return x

        return pipeline_stack(x, [*flat_b.values(), *flat_l.values()],
                              stage, mesh)
    lo, hi = layer_range if layer_range is not None else (0, model.depth)
    tokens = sharding.token_shard(mesh, x.shape[1])
    if tokens is not None:
        x = tokens.take(x)
    for i in range(lo, hi):
        x = run(x, _layer(blocks, i),
                _layer(lora_tree, i) if lora_tree else None, tokens)
    if tokens is not None:
        x = sharding.gather_tokens(x, tokens, partial=False)
    return x


def vit_embed(params: Params, images, model: ViTConfig, lora: LoraConfig, *,
              train: bool = False, generator=None,
              compute_dtype=torch.bfloat16,
              layer_range: Optional[Tuple[int, int]] = None,
              tokens_in: Optional[torch.Tensor] = None,
              return_tokens: bool = False,
              lora_apply: str = "factored"):
    """Backbone forward -> post-LN CLS embedding (B, dim) in fp32.

    ``tokens_in`` / ``return_tokens`` expose the token sequence between
    layers, and ``layer_range`` picks the layers that run (the LIRF low/up
    split, vit_face.py:638-665, 755-781): the low half embeds the images
    and returns the tokens after layer depth // 2; the up half takes them
    in and runs the rest.

    ``lora_apply``: "factored" runs the low-rank path as two skinny matmuls
    per adapted linear; "merged" folds B@A into the kernels once per call
    (gradients flow through the fold). With bf16 base params the fold is
    quantized to the kernel dtype (vit.py:450-454)."""
    if train and model.gemm_impl == "int8":
        # int8 rounding has zero gradient: training would see dead
        # gradients through every projection
        raise ValueError("gemm_impl='int8' is an inference/serving path; "
                         "train with the default bf16 GEMMs")
    base = params["base"]
    lora_tree = params.get("lora", {})
    # under fsdp the fold waits for each layer's gather (transformer_stack)
    fold = bool(lora_tree) and lora_apply == "merged" and \
        sharding.fsdp_on(active_mesh())
    if lora_tree and lora_apply == "merged" and not fold:
        base = dict(base)
        base["blocks"] = merge_lora(base["blocks"],
                                    _tp_lora(lora_tree, active_mesh()),
                                    lora.scaling)
        lora_tree = {}
    cdt = compute_dtype
    deterministic = not train

    if tokens_in is not None:
        x = tokens_in.to(cdt)
    else:
        if images.dtype == torch.uint8:
            # uint8-transfer path: k/255 in fp32 is the exact host ToTensor
            # value, then the same cast to the compute dtype (vit.py:475-489)
            images = images.float() / 255.0
            if model.input_norm == "imagenet":
                mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                                    device=images.device).reshape(1, 3, 1, 1)
                std = torch.tensor(IMAGENET_STD, dtype=torch.float32,
                                   device=images.device).reshape(1, 3, 1, 1)
                images = (images - mean) / std
        x = patchify(images.to(cdt), model)
        x = _proj(x, base["patch"]["kernel"], model)
        x = x + base["patch"]["bias"].to(cdt)
        cls = base["cls_token"].to(cdt).expand(x.shape[0], 1, model.dim)
        x = torch.cat([cls, x], dim=1)
        x = x + base["pos_embed"].to(cdt)[None, : x.shape[1]]
        x = _dropout(x, model.emb_dropout, generator, deterministic)

    x = transformer_stack(x, base["blocks"], lora_tree, model, lora.scaling,
                          generator, deterministic, layer_range, fold=fold)
    if return_tokens:
        return x
    pooled = x.mean(dim=1) if model.pool == "mean" else x[:, 0]
    return _layer_norm(pooled, base["head_ln"]["scale"],
                       base["head_ln"]["bias"])  # fp32


def params_device(params: Params) -> torch.device:
    """The device the parameter tree lives on."""
    return params["base"]["patch"]["kernel"].device


def vit_apply(params: Params, images, labels, model: ViTConfig,
              lora: LoraConfig, *, train: bool = False, generator=None,
              compute_dtype=torch.bfloat16, lora_apply: str = "factored"):
    """Full forward. With labels: (logits, emb) like ViT_face.forward
    (vit_face.py:523-548); without: emb only."""
    emb = vit_embed(params, images, model, lora, train=train,
                    generator=generator, compute_dtype=compute_dtype,
                    lora_apply=lora_apply)
    if labels is None or model.head_type == "None":
        return emb
    logits = apply_head(model.head_type, params["base"]["head"], emb, labels)
    return logits, emb
