"""Head-only finetune probe (port of gslora_tpu/cli/backbone_probe.py;
reference train/backbone_forget_main.py): freeze everything but the
classification head (reference :595-600 freezes all but ``loss.*``), train
on the combined forget + remain data, and track the forget and remain
accuracy curves, saved as .npy (:757-761).

This probes how much forgetting the head alone achieves: the control
experiment for GS-LoRA's claim that backbone adapters are needed.

Usage:
  python -m gslora_tpu_torch.cli.backbone_probe -d casia100 -n VIT \
      --vit_depth 6 --head CosFace -r <ckpt> -b 48 -e 10 --lr 1e-3 \
      --num_of_first_cls 90 --per_forget_cls 10 --outdir <dir> \
      [--device cpu]

The backbone is frozen the port's way: only ``base.head.*`` requires grad
and has optimizer state (``PretrainState.create(trains=...)``). The JAX
package takes the whole gradient and zeroes every update but the head's;
its optimizer has no global-norm clipping, so the head's update is the
same. Nothing upstream of the head trains, so autograd never enters the
transformer and the attention backward never runs.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from gslora_tpu_torch.cli.common import build_datasets, build_params
from gslora_tpu_torch.config import build_parser, config_from_args
from gslora_tpu_torch.data.folders import ConcatDataset
from gslora_tpu_torch.data.pipeline import BatchLoader
from gslora_tpu_torch.data.splits import make_order_list, \
    split_by_class_window
from gslora_tpu_torch.engine.evaluate import eval_accuracy, make_eval_step
from gslora_tpu_torch.engine.loop import _dtype, resolve_device
from gslora_tpu_torch.engine.pretrain import PretrainState
from gslora_tpu_torch.engine.schedule import timm_cosine_lr
from gslora_tpu_torch.engine.state import make_optimizer
from gslora_tpu_torch.losses.classification import cross_entropy, \
    top1_accuracy
from gslora_tpu_torch.models.vit import ViT, vit_apply


def is_head(name: str) -> bool:
    """The ``trains`` scope of the probe: the classification head only
    (backbone_forget_main.py:595-600)."""
    return name.startswith("base.head.")


def make_head_only_step(model, lora, optimizer, compute_dtype):
    """step(state, x, y, lr, generator) -> (state, acc): CE of a training
    forward, its gradient over the head and the optimizer update, in
    place."""
    def step(state: PretrainState, x, y, lr, generator):
        logits, _ = vit_apply(state.params, x, y, model, lora, train=True,
                              generator=generator,
                              compute_dtype=compute_dtype)
        leaves = state.trainable_params()
        grads = torch.autograd.grad(cross_entropy(logits, y), leaves)
        optimizer.update(leaves, grads, state.opt_state, lr)
        state.step += 1
        return state, top1_accuracy(logits.detach(), y)

    return step


def probe_data(cfg, train_ds, test_ds):
    """(combined forget + remain train set, forget test set, remain test
    set) of the probe's class windows: the first ``num_of_first_cls``
    classes of the seeded order remain, the next ``per_forget_cls`` are
    forgotten."""
    order = make_order_list(cfg.model.num_class, seed=cfg.data.seed)
    f = cfg.forget
    first, end = f.num_of_first_cls, f.num_of_first_cls + f.per_forget_cls
    remain_tr, forget_tr = split_by_class_window(train_ds, order, 0, first,
                                                 first, end)
    remain_te, forget_te = split_by_class_window(test_ds, order, 0, first,
                                                 first, end)
    # combined forget + remain training stream (backbone_forget_main.py)
    return ConcatDataset(forget_tr, remain_tr), forget_te, remain_te


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    device = resolve_device(cfg.device)
    cdt = _dtype(cfg)

    train, forget_te, remain_te = probe_data(cfg, *build_datasets(cfg))
    u8 = cfg.data.uint8_transfer
    loader = BatchLoader(train, cfg.data.batch_size, seed=cfg.data.seed,
                         uint8_transfer=u8)

    params = build_params(cfg)
    opt = make_optimizer(cfg.optim)
    state = PretrainState.create(ViT(params, cfg.model, cfg.lora).to(device),
                                 opt, trains=is_head)
    step = make_head_only_step(cfg.model, cfg.lora, opt, cdt)
    eval_step = make_eval_step(cfg.model, cfg.lora, compute_dtype=cdt)
    test_bs = cfg.data.batch_size * cfg.data.test_batch_scale
    pad = device.type != "cpu"  # static eval shapes on the card

    def accuracy(ds):
        return eval_accuracy(eval_step, state.params, BatchLoader(
            ds, test_bs, shuffle=False, prefetch=0, mask_padding=pad,
            uint8_transfer=u8))

    generator = torch.Generator(device=device).manual_seed(cfg.data.seed)
    forget_curve, remain_curve = [], []
    for epoch in range(cfg.num_epoch):
        lr = timm_cosine_lr(cfg.optim, epoch)
        for x, y in loader:
            state, _ = step(state, torch.from_numpy(x).to(device),
                            torch.from_numpy(y).to(device), lr, generator)
        forget_curve.append(accuracy(forget_te))
        remain_curve.append(accuracy(remain_te))

    # only the head moved
    final = state.params["base"]
    backbone_same = torch.equal(params["base"]["patch"]["kernel"],
                                final["patch"]["kernel"].detach().cpu())
    head_moved = not torch.equal(params["base"]["head"]["weight"],
                                 final["head"]["weight"].detach().cpu())
    report = {"forget_acc_curve": forget_curve,
              "remain_acc_curve": remain_curve,
              "backbone_frozen": bool(backbone_same),
              "head_trained": bool(head_moved)}
    print(json.dumps(report, indent=2))
    if cfg.outdir:
        os.makedirs(cfg.outdir, exist_ok=True)
        np.save(os.path.join(cfg.outdir, "forget_acc_curve.npy"),
                np.asarray(forget_curve))
        np.save(os.path.join(cfg.outdir, "remain_acc_curve.npy"),
                np.asarray(remain_curve))
    return report


if __name__ == "__main__":
    main()
