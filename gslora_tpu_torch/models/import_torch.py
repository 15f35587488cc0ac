"""Reference-named ``.pth`` state dicts to and from the port's parameter tree
(port of gslora_tpu/models/import_torch.py, face-ViT naming).

The reference ships ViT_face state dicts with names like
``transformer.layers.{i}.1.fn.fn.net.0.lora_A`` (vit_face.py:449-548). This
module maps that naming onto the stacked tree of models/vit.py: kernels
transposed to (fan_in, fan_out), per-layer tensors stacked on the leading
layer axis, the MergedLinear qkv LoRA reshaped to (3, r, ...). The
torchvision naming of the ViT-B/16 path is models/vit_imagenet.py's.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from gslora_tpu_torch.config import LoraConfig, ViTConfig


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` state dict (or a pickled module's) as CPU tensors."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.detach().cpu() for k, v in sd.items()}


def _tensor(a) -> torch.Tensor:
    return a.detach().cpu() if isinstance(a, torch.Tensor) \
        else torch.from_numpy(np.array(a, copy=True))


def from_state_dict(sd: Dict, model: ViTConfig,
                    lora: Optional[LoraConfig] = None,
                    param_dtype=torch.float32,
                    strict_lora: bool = False) -> Dict:
    """state dict (reference naming; tensors or numpy arrays) ->
    {"base": ..., "lora": ...}.

    Missing LoRA keys are tolerated like the reference's strict=False
    resume that only allows lora_* keys to be absent
    (train_own_forget.py:629-638): an absent LoRA comes back as zeros (A
    and B; callers wanting a fresh kaiming A replace it). Missing non-LoRA
    keys raise."""
    L, d, m, inner = model.depth, model.dim, model.mlp_dim, model.inner_dim
    dt = param_dtype

    def get(name):
        if name not in sd:
            raise KeyError(f"reference checkpoint missing non-LoRA key "
                           f"{name!r}")
        return _tensor(sd[name])

    def one(name):
        return get(name).to(dt).contiguous()

    def stack(fmt, transpose=False):
        arrs = [get(fmt.format(i)) for i in range(L)]
        return torch.stack([a.t() if transpose else a
                            for a in arrs]).to(dt).contiguous()

    base = {
        "patch": {"kernel": get("patch_to_embedding.weight").t().to(dt)
                  .contiguous(),
                  "bias": one("patch_to_embedding.bias")},
        "cls_token": get("cls_token").reshape(-1).to(dt),
        "pos_embed": get("pos_embedding").reshape(model.seq_len, d).to(dt),
        "blocks": {
            "attn_ln": {
                "scale": stack("transformer.layers.{}.0.fn.norm.weight"),
                "bias": stack("transformer.layers.{}.0.fn.norm.bias"),
            },
            "qkv": {"kernel": stack(
                "transformer.layers.{}.0.fn.fn.to_qkv.weight",
                transpose=True)},
            "attn_out": {
                "kernel": stack(
                    "transformer.layers.{}.0.fn.fn.to_out.0.weight",
                    transpose=True),
                "bias": stack("transformer.layers.{}.0.fn.fn.to_out.0.bias"),
            },
            "ffn_ln": {
                "scale": stack("transformer.layers.{}.1.fn.norm.weight"),
                "bias": stack("transformer.layers.{}.1.fn.norm.bias"),
            },
            "fc1": {
                "kernel": stack("transformer.layers.{}.1.fn.fn.net.0.weight",
                                transpose=True),
                "bias": stack("transformer.layers.{}.1.fn.fn.net.0.bias"),
            },
            "fc2": {
                "kernel": stack("transformer.layers.{}.1.fn.fn.net.3.weight",
                                transpose=True),
                "bias": stack("transformer.layers.{}.1.fn.fn.net.3.bias"),
            },
        },
        "head_ln": {"scale": one("mlp_head.0.weight"),
                    "bias": one("mlp_head.0.bias")},
    }
    if "loss.weight" in sd:
        base["head"] = {"weight": one("loss.weight")}
        if "loss.bias" in sd:
            base["head"]["bias"] = one("loss.bias")
    elif model.head_type != "None":
        raise KeyError(
            f"checkpoint has no 'loss.weight' but head_type="
            f"{model.head_type!r} needs one: a backbone-only .pth can only "
            f"be loaded with head_type='None'")

    lora_tree: Dict = {}
    if lora is not None and lora.rank > 0:
        r = lora.rank

        def lora_stack(fmt, shape):
            arrs = []
            for i in range(L):
                name = fmt.format(i)
                if name in sd:
                    arrs.append(_tensor(sd[name]).float())
                elif strict_lora:
                    raise KeyError(name)
                else:
                    arrs.append(torch.zeros(shape))
            return torch.stack(arrs)

        if lora.pos == "FFN":
            lora_tree["ffn"] = {
                "A1": lora_stack(
                    "transformer.layers.{}.1.fn.fn.net.0.lora_A", (r, d)),
                "B1": lora_stack(
                    "transformer.layers.{}.1.fn.fn.net.0.lora_B", (m, r)),
                "A2": lora_stack(
                    "transformer.layers.{}.1.fn.fn.net.3.lora_A", (r, m)),
                "B2": lora_stack(
                    "transformer.layers.{}.1.fn.fn.net.3.lora_B", (d, r)),
            }
        elif lora.pos == "Attention":
            A = lora_stack("transformer.layers.{}.0.fn.fn.to_qkv.lora_A",
                           (3 * r, d))
            B = lora_stack("transformer.layers.{}.0.fn.fn.to_qkv.lora_B",
                           (3 * inner, r))
            lora_tree["attn"] = {"A": A.reshape(L, 3, r, d),
                                 "B": B.reshape(L, 3, inner, r)}
    return {"base": base, "lora": lora_tree}


def import_reference_checkpoint(path: str, model: ViTConfig,
                                lora: Optional[LoraConfig] = None,
                                param_dtype=torch.float32) -> Dict:
    return from_state_dict(load_torch_state_dict(path), model, lora,
                           param_dtype)


def to_state_dict(params: Dict, model: ViTConfig) -> Dict[str, torch.Tensor]:
    """The port's tree (a models.vit.ViT's ``tree()`` or a parameter tree)
    -> reference-named CPU tensors in the tree's dtypes."""
    def t(a):
        return a.detach().cpu()

    base = params["base"]
    sd: Dict[str, torch.Tensor] = {
        "patch_to_embedding.weight": t(base["patch"]["kernel"]).t(),
        "patch_to_embedding.bias": t(base["patch"]["bias"]),
        "cls_token": t(base["cls_token"]).reshape(1, 1, -1),
        "pos_embedding": t(base["pos_embed"])[None],
        "mlp_head.0.weight": t(base["head_ln"]["scale"]),
        "mlp_head.0.bias": t(base["head_ln"]["bias"]),
    }
    b = base["blocks"]
    for i in range(model.depth):
        p = f"transformer.layers.{i}"
        sd[f"{p}.0.fn.norm.weight"] = t(b["attn_ln"]["scale"][i])
        sd[f"{p}.0.fn.norm.bias"] = t(b["attn_ln"]["bias"][i])
        sd[f"{p}.0.fn.fn.to_qkv.weight"] = t(b["qkv"]["kernel"][i]).t()
        sd[f"{p}.0.fn.fn.to_out.0.weight"] = t(b["attn_out"]["kernel"][i]).t()
        sd[f"{p}.0.fn.fn.to_out.0.bias"] = t(b["attn_out"]["bias"][i])
        sd[f"{p}.1.fn.norm.weight"] = t(b["ffn_ln"]["scale"][i])
        sd[f"{p}.1.fn.norm.bias"] = t(b["ffn_ln"]["bias"][i])
        sd[f"{p}.1.fn.fn.net.0.weight"] = t(b["fc1"]["kernel"][i]).t()
        sd[f"{p}.1.fn.fn.net.0.bias"] = t(b["fc1"]["bias"][i])
        sd[f"{p}.1.fn.fn.net.3.weight"] = t(b["fc2"]["kernel"][i]).t()
        sd[f"{p}.1.fn.fn.net.3.bias"] = t(b["fc2"]["bias"][i])
    if "head" in base:
        sd["loss.weight"] = t(base["head"]["weight"])
        if "bias" in base["head"]:
            sd["loss.bias"] = t(base["head"]["bias"])
    lt = params.get("lora", {})
    if "ffn" in lt:
        f = lt["ffn"]
        for i in range(model.depth):
            p = f"transformer.layers.{i}.1.fn.fn"
            sd[f"{p}.net.0.lora_A"] = t(f["A1"][i])
            sd[f"{p}.net.0.lora_B"] = t(f["B1"][i])
            sd[f"{p}.net.3.lora_A"] = t(f["A2"][i])
            sd[f"{p}.net.3.lora_B"] = t(f["B2"][i])
    if "attn" in lt:
        a = lt["attn"]
        for i in range(a["A"].shape[0]):
            p = f"transformer.layers.{i}.0.fn.fn.to_qkv"
            sd[f"{p}.lora_A"] = t(a["A"][i]).reshape(-1, a["A"].shape[-1])
            sd[f"{p}.lora_B"] = t(a["B"][i]).reshape(-1, a["B"].shape[-1])
    return {k: v.contiguous() for k, v in sd.items()}
