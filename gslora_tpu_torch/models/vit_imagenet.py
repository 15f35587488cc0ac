"""ViT-B/16 (torchvision-equivalent) for the ImageNet-100 path (port of
gslora_tpu/models/vit_imagenet.py).

The reference wraps torchvision vit_b_16 in ModifiedViT (modified_VIT.py:
5-39) and swaps every FFN linear for lora.Linear (util/utils.py:552-576
replace_ffn_with_lora). The port's ViT of models/vit.py expresses it by
config (``ViTConfig.vit_b16``): the conv patch-embed is the soft split with
kernel = stride = 16 and pad 0, qkv bias on, the head-dim attention scale,
a plain Linear (Softmax) head. torchvision's final encoder LayerNorm is
``head_ln`` on the CLS token (LayerNorm is per token, so norm-then-select
equals select-then-norm).

Also: the importer from a torchvision vit_b_16 state dict and its inverse,
and the head slice / restore of util/utils.py:579-649 that cut the
1000-class ImageNet head down to the run's 100 classes and put it back.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from gslora_tpu_torch.config import LoraConfig, ViTConfig
from gslora_tpu_torch.lora.core import init_lora
from gslora_tpu_torch.models.import_torch import _tensor

_LAYER = "encoder.layers.encoder_layer_{}"
# loralib-surgered FFN names (engine_cl.py:349-432) -> the port's LoRA keys
_LORA_KEYS = (("A1", ".mlp.0.lora_A"), ("B1", ".mlp.0.lora_B"),
              ("A2", ".mlp.3.lora_A"), ("B2", ".mlp.3.lora_B"))


def vit_b16_config(num_class: int = 100) -> ViTConfig:
    return ViTConfig.vit_b16(num_class=num_class)


def from_torchvision_state_dict(sd: Dict, model: ViTConfig,
                                lora: Optional[LoraConfig] = None,
                                param_dtype=torch.float32,
                                generator: Optional[torch.Generator] = None
                                ) -> Dict:
    """torchvision vit_b_16 state dict (tensors or numpy arrays, optionally
    with the loralib keys ``encoder.layers.encoder_layer_{i}.mlp.{0,3}.
    lora_{A,B}``) -> the port's {"base", "lora"} tree on the CPU. Without
    those keys a rank > 0 run gets a fresh LoRA drawn from ``generator``
    (default: a CPU generator seeded with 0)."""
    L, d = model.depth, model.dim
    dt = param_dtype

    def get(name):
        if name not in sd:
            raise KeyError(f"torchvision checkpoint missing {name!r}")
        return _tensor(sd[name])

    def one(name):
        return get(name).to(dt).contiguous()

    def stack(suffix, transpose=False):
        arrs = [get(_LAYER.format(i) + suffix) for i in range(L)]
        return torch.stack([a.t() if transpose else a
                            for a in arrs]).to(dt).contiguous()

    # conv_proj (768, 3, 16, 16) -> (c*k*k, 768): the channel-major flatten
    # is the (c, kh, kw) order of the soft split's unfold
    base = {
        "patch": {"kernel": get("conv_proj.weight").reshape(d, -1).t()
                  .to(dt).contiguous(),
                  "bias": one("conv_proj.bias")},
        "cls_token": get("class_token").reshape(-1).to(dt),
        "pos_embed": get("encoder.pos_embedding").reshape(
            model.seq_len, d).to(dt),
        "blocks": {
            "attn_ln": {"scale": stack(".ln_1.weight"),
                        "bias": stack(".ln_1.bias")},
            "qkv": {"kernel": stack(".self_attention.in_proj_weight", True),
                    "bias": stack(".self_attention.in_proj_bias")},
            "attn_out": {
                "kernel": stack(".self_attention.out_proj.weight", True),
                "bias": stack(".self_attention.out_proj.bias")},
            "ffn_ln": {"scale": stack(".ln_2.weight"),
                       "bias": stack(".ln_2.bias")},
            "fc1": {"kernel": stack(".mlp.0.weight", True),
                    "bias": stack(".mlp.0.bias")},
            "fc2": {"kernel": stack(".mlp.3.weight", True),
                    "bias": stack(".mlp.3.bias")},
        },
        "head_ln": {"scale": one("encoder.ln.weight"),
                    "bias": one("encoder.ln.bias")},
        "head": {"weight": one("heads.head.weight"),
                 "bias": one("heads.head.bias")},
    }
    lora_tree: Dict = {}
    if lora is not None and lora.rank > 0:
        if all(_LAYER.format(0) + s in sd for _, s in _LORA_KEYS):
            lora_tree["ffn"] = {
                key: torch.stack([get(_LAYER.format(i) + s)
                                  for i in range(L)]).float().contiguous()
                for key, s in _LORA_KEYS}
        else:
            gen = generator if generator is not None \
                else torch.Generator().manual_seed(0)
            lora_tree = init_lora(gen, model, lora)
    return {"base": base, "lora": lora_tree}


def to_torchvision_state_dict(params: Dict, model: ViTConfig
                              ) -> Dict[str, torch.Tensor]:
    """The port's tree -> torchvision vit_b_16 names (the inverse of
    :func:`from_torchvision_state_dict`) as CPU tensors in the tree's
    dtypes, with the loralib FFN keys when the tree has a LoRA, so a
    checkpoint trained here loads into the reference's ImageNet-100 resume
    (train_own_forget_cl.py:206-243)."""
    def t(a):
        return a.detach().cpu()

    base = params["base"]
    d, k = model.dim, model.patch_size
    sd: Dict[str, torch.Tensor] = {
        "conv_proj.weight": t(base["patch"]["kernel"]).t().reshape(
            d, model.channels, k, k),
        "conv_proj.bias": t(base["patch"]["bias"]),
        "class_token": t(base["cls_token"]).reshape(1, 1, -1),
        "encoder.pos_embedding": t(base["pos_embed"])[None],
        "encoder.ln.weight": t(base["head_ln"]["scale"]),
        "encoder.ln.bias": t(base["head_ln"]["bias"]),
        "heads.head.weight": t(base["head"]["weight"]),
        "heads.head.bias": t(base["head"]["bias"]),
    }
    b = base["blocks"]
    for i in range(model.depth):
        p = _LAYER.format(i)
        sd[f"{p}.ln_1.weight"] = t(b["attn_ln"]["scale"][i])
        sd[f"{p}.ln_1.bias"] = t(b["attn_ln"]["bias"][i])
        sd[f"{p}.self_attention.in_proj_weight"] = t(b["qkv"]["kernel"][i]).t()
        sd[f"{p}.self_attention.in_proj_bias"] = t(b["qkv"]["bias"][i])
        sd[f"{p}.self_attention.out_proj.weight"] = t(
            b["attn_out"]["kernel"][i]).t()
        sd[f"{p}.self_attention.out_proj.bias"] = t(b["attn_out"]["bias"][i])
        sd[f"{p}.ln_2.weight"] = t(b["ffn_ln"]["scale"][i])
        sd[f"{p}.ln_2.bias"] = t(b["ffn_ln"]["bias"][i])
        sd[f"{p}.mlp.0.weight"] = t(b["fc1"]["kernel"][i]).t()
        sd[f"{p}.mlp.0.bias"] = t(b["fc1"]["bias"][i])
        sd[f"{p}.mlp.3.weight"] = t(b["fc2"]["kernel"][i]).t()
        sd[f"{p}.mlp.3.bias"] = t(b["fc2"]["bias"][i])
    ffn = params.get("lora", {}).get("ffn")
    if ffn:
        for i in range(model.depth):
            for key, s in _LORA_KEYS:
                sd[_LAYER.format(i) + s] = t(ffn[key][i])
    return {k: v.contiguous() for k, v in sd.items()}


def modify_head(params: Dict, class_id_map: Dict[int, int]) -> Dict:
    """Slice the 1000-class head down to the run's classes
    (util/utils.py:579-619): row i of the new head is original ImageNet
    row ``class_id_map[i]``. Returns new params with the original head
    under ``"original_head"`` (see :func:`resume_head`)."""
    head = params["base"]["head"]
    idx = torch.tensor([class_id_map[i] for i in sorted(class_id_map)],
                       dtype=torch.long, device=head["weight"].device)
    new_head = {k: v.index_select(0, idx) for k, v in head.items()}
    base = dict(params["base"])
    base["head"] = new_head
    return {"base": base, "lora": params.get("lora", {}),
            "original_head": head}


def resume_head(params: Dict, original_head: Dict) -> Dict:
    """Put the kept 1000-class head back (util/utils.py:621-634): the
    missing-class eval over the held-out classes uses it."""
    base = dict(params["base"])
    base["head"] = original_head
    return {"base": base, "lora": params.get("lora", {})}
