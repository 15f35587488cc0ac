"""Export a checkpoint to the reference's ``.pth`` format (port of
gslora_tpu/cli/export_torch.py).

Writes a torch state dict in fp32 under the reference ViT_face names
(``transformer.layers.{i}.1.fn.fn.net.{0,3}.lora_{A,B}``, vit_face.py:
449-548) or, for ``-n VIT_B16``, under torchvision's vit_b_16 names with
the loralib FFN keys (``encoder.layers.encoder_layer_{i}.mlp.{0,3}.
lora_{A,B}``, the surgered model of train_own_forget_cl.py:206-243);
loadable by the reference's resume (train_own_forget.py:624-648), by the
JAX package's ``-r`` and by the port's own. Two forms, as loralib's
train/eval modes:

* ``unmerged``: base weights untouched plus the current lora_A/lora_B
  (``torch.save(model.state_dict())`` in train mode);
* ``merged``: FFN/qkv kernels += scaling * (B @ A), lora_A/lora_B kept
  (what the reference writes at continual task boundaries, engine.py:449).

Usage::

    python -m gslora_tpu_torch.cli.export_torch -r runs/.../ckpt.pth \
        --lora_rank 8 --export_out model.pth --export_form merged
"""
from __future__ import annotations

import json
import os

import torch

from gslora_tpu_torch.cli.common import build_params
from gslora_tpu_torch.config import build_parser, config_from_args
from gslora_tpu_torch.lora.core import merge_lora
from gslora_tpu_torch.models.import_torch import to_state_dict
from gslora_tpu_torch.models.vit_imagenet import to_torchvision_state_dict


def export_state_dict(params: dict, model_cfg, lora_cfg,
                      form: str = "unmerged", naming: str = "vit_face"
                      ) -> dict:
    """The port's tree -> reference-named state dict, merged or unmerged;
    ``naming`` "vit_face" (ViT_face / ViTs_face) or "torchvision"
    (the ViT-B/16 of the ImageNet-100 path)."""
    if form not in ("merged", "unmerged"):
        raise ValueError(f"export form must be merged|unmerged, got {form!r}")
    if form == "merged" and params.get("lora"):
        base = dict(params["base"])
        base["blocks"] = merge_lora(base["blocks"], params["lora"],
                                    lora_cfg.scaling)
        params = {"base": base, "lora": params["lora"]}
    if naming == "torchvision":
        return to_torchvision_state_dict(params, model_cfg)
    return to_state_dict(params, model_cfg)


def save_pth(sd: dict, path: str) -> None:
    """torch.save the state dict as contiguous fp32 CPU tensors."""
    out = {k: v.detach().to("cpu", torch.float32).contiguous()
           for k, v in sd.items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(out, path)


def main(argv=None):
    parser = build_parser()
    parser.add_argument("--export_out", required=True,
                        help="output .pth path (reference-format state_dict)")
    parser.add_argument("--export_form", default="unmerged",
                        choices=["unmerged", "merged", "both"],
                        help="loralib train-mode (unmerged) or eval-mode "
                             "(merged) state_dict; 'both' writes "
                             "<out> and <out stem>_merged.pth")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    if not cfg.resume:
        parser.error("export requires a checkpoint: pass -r/--resume")
    naming = "torchvision" if cfg.net == "VIT_B16" else "vit_face"
    params = build_params(cfg)

    forms = (["unmerged", "merged"] if args.export_form == "both"
             else [args.export_form])
    written = []
    for form in forms:
        path = args.export_out
        if args.export_form == "both" and form == "merged":
            stem, ext = os.path.splitext(path)
            path = f"{stem}_merged{ext or '.pth'}"
        save_pth(export_state_dict(params, cfg.model, cfg.lora, form,
                                   naming=naming), path)
        written.append({"path": path, "form": form, "naming": naming})
    print(json.dumps({"exported": written}))
    return written


if __name__ == "__main__":
    main()
