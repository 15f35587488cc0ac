"""Which parameters a baseline trains (port of gslora_tpu/baselines/freeze.py).

Every reference CL-baseline branch (EWC/MAS/L2/Retrain/Replay/LwF/DER/
DER++/FDR/SCRUB and the single-step reg family; not LIRF, whose optimizer
holds only the student's low half) freezes the margin head:

* ``"loss" in n and not args.ffn_open`` -> ``requires_grad = False``
  (train_own_forget_cl.py:426, train_own_forget_cl_open.py:316,
  train_own_forget_open.py:711): the margin head (``base.head``) never
  trains unless --ffn_open;
* ``data_mode == "imagenet100"`` freezes ``"head"`` always
  (train_own_forget_cl.py:429-431);
* ``--only_ffn`` (cl.py:432-439) trains ONLY the FFN Linears (``fc1`` and
  ``fc2`` of every block, and their LoRA factors) and, on the face models,
  the margin head.

As in the reference, a frozen parameter does not require grad and the
optimizer holds no state for it (engine/pretrain.PretrainState.create
takes :func:`trains` as its scope). The JAX package zeroes the frozen
leaves' updates instead; for AdamW and SGD both give the same trajectory.
"""
from __future__ import annotations


def trains(name: str, *, ffn_open: bool = False, only_ffn: bool = False,
           imagenet: bool = False) -> bool:
    """Whether the parameter of dotted name ``name`` (``base.head.weight``,
    ``lora.ffn.A1``, ...) trains under the flags."""
    keys = name.split(".")
    head = keys[:2] == ["base", "head"]
    if only_ffn:
        if keys[:1] == ["lora"]:
            return "ffn" in keys
        if "fc1" in keys or "fc2" in keys:
            return True
        # the imagenet model's class head stays frozen under --only_ffn
        return head and not imagenet
    return not head or (ffn_open and not imagenet)


def freeze_flags(cfg) -> dict:
    """The :func:`trains` flags of a RunConfig."""
    return {"ffn_open": cfg.baseline.ffn_open,
            "only_ffn": cfg.baseline.only_ffn,
            "imagenet": cfg.data.data_mode == "imagenet100"}
