"""Single-step GS-LoRA at the full recipe on the flagship (port of
scripts/integration_synthetic.py): the ViT-P8S8 base on the synthetic
CASIA-100 stand-in forgets 10 of its 100 classes with the alpha warm-up,
the prototype loss and EMA averaging, bf16 compute.

    python3 -m gslora_tpu_torch.tools.integration_synthetic \
        [--unsaturated] [--out report.json] [--device cpu]

``--unsaturated`` starts from the unsaturated base the baseline zoo uses
(Softmax head, noise 2.4); BND drops from 110 to 10, since a Softmax
head's CE lives near ln(100) ~ 4.6 and not at CosFace's s = 64 scale.
The base comes from tools/flagship.pretrained_base (``$PRETRAIN_CKPT``,
a port ``.pth`` or the JAX package's ``.msgpack``). The report (pretrain
test accuracy, forget accuracy before and after, remain accuracy,
best H-mean, the LoRA group norms, wall time, device) goes to ``--out``,
else to ``integration_report[_unsat].json`` in the temporary directory.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

from gslora_tpu_torch.config import (DataConfig, ForgetConfig, OptimConfig,
                                     RunConfig)
from gslora_tpu_torch.data.splits import (make_order_list, ratio_subset,
                                          split_by_class_window)
from gslora_tpu_torch.engine.loop import (ForgetData, resolve_device,
                                          run_forget_training)
from gslora_tpu_torch.tools import flagship

EPOCHS = 25
EVAL_BS = 250


def forget_data(train, test) -> ForgetData:
    """The 90 / 10 class window of the seed-1337 order, half of each
    training split (seed 1337)."""
    order = make_order_list(100, seed=1337)
    remain_tr, forget_tr = split_by_class_window(train, order, 0, 90, 90, 100)
    remain_te, forget_te = split_by_class_window(test, order, 0, 90, 90, 100)
    return ForgetData(train_forget=ratio_subset(forget_tr, 0.5, seed=1337),
                      train_remain=ratio_subset(remain_tr, 0.5, seed=1337),
                      test_forget=forget_te, test_remain=remain_te)


def run_config(model, unsaturated: bool, device: str, epochs: int = EPOCHS,
               bs: int = flagship.BS,
               compute_dtype: str = "bfloat16") -> RunConfig:
    """The full GS-LoRA++ recipe: lr 1e-2, BND 110 (10 unsaturated), beta
    0.15, alpha 0.01 warmed up to epoch 10, prototypes (pro_f 0.1, BND_pro
    18), EMA from epoch 12 at decay 0.9, an eval every 30 batches, merged
    LoRA."""
    return RunConfig(
        model=model, lora=flagship.LORA,
        optim=OptimConfig(lr=1e-2, warmup_epochs=0, epochs=epochs),
        forget=ForgetConfig(bnd=10.0 if unsaturated else 110.0, beta=0.15,
                            alpha=0.01, warmup_alpha=True, big_alpha=0.01,
                            alpha_epoch=10, prototype=True, pro_f_weight=0.1,
                            pro_r_weight=0.0, bnd_pro=18.0,
                            average_weight=True, ema_epoch=12,
                            ema_decay=0.9),
        data=DataConfig(batch_size=bs), num_epoch=epochs, ver_freq=30,
        compute_dtype=compute_dtype, lora_apply="merged", device=device)


def default_out(unsaturated: bool) -> str:
    return os.path.join(tempfile.gettempdir(),
                        "integration_report_unsat.json" if unsaturated
                        else "integration_report.json")


def run(params, train, test, model, *, unsaturated: bool,
        device: str = "cuda", epochs: int = EPOCHS, bs: int = flagship.BS,
        compute_dtype: str = "bfloat16", out: str | None = None,
        t0: float | None = None) -> dict:
    """The script's run from the base ``params``: its test accuracy, then
    the forget run; writes and returns the report. ``t0``: when the run
    began (the wall time counts from it)."""
    t0 = time.time() if t0 is None else t0
    dev = resolve_device(device)
    acc = flagship.accuracy(params, test, model, dev, EVAL_BS,
                            mask_padding=False,
                            compute_dtype=flagship.dtype(compute_dtype))
    print("pretrain test acc", acc, flush=True)
    cfg = run_config(model, unsaturated, str(dev), epochs, bs, compute_dtype)
    res = run_forget_training(cfg, params, forget_data(train, test))
    report = {
        "pretrain_test_acc": acc,
        "head": model.head_type, "noise": flagship.noise(unsaturated),
        "forget_acc_before": res.forget_acc_before,
        "forget_acc_after": res.forget_acc,
        "remain_acc_after": res.remain_acc,
        "best_H_mean": res.best_h,
        "norm_list": [round(n, 3) for n in res.norm_list],
        "wallclock_s": round(time.time() - t0, 1),
        "device": flagship.device_name(dev),
    }
    print(json.dumps(report, indent=2), flush=True)
    with open(out or default_out(unsaturated), "w") as f:
        json.dump(report, f)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--unsaturated", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    resolve_device(a.device)
    t0 = time.time()
    model = flagship.model_config(a.unsaturated)
    train, test = flagship.stand_in(model, flagship.noise(a.unsaturated))
    print("data built", round(time.time() - t0, 1), "s", flush=True)
    params = flagship.pretrained_base(
        model, train, flagship.pretrain_epochs(a.unsaturated), a.device,
        flagship.checkpoint_path(a.unsaturated))
    return run(params, train, test, model, unsaturated=a.unsaturated,
               device=a.device, out=a.out, t0=t0)


if __name__ == "__main__":
    main()
