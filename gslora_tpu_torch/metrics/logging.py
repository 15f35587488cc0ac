"""Metric logging: console + optional wandb (the reference's load-bearing
observability, SURVEY §5.5 — per-step loss dict every DISP_FREQ, per-eval
accuracy, task-suffixed keys, final lora norm_list)."""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricLogger:
    def __init__(self, use_wandb: bool = False, project: str = "gslora_tpu",
                 run_name: Optional[str] = None, outdir: str | None = None,
                 config: dict | None = None):
        self._wandb = None
        self._jsonl = None
        if use_wandb:
            try:
                # swanlab mirrors wandb when present (reference
                # train_own_forget.py:9-11 swanlab.sync_wandb)
                try:
                    import swanlab
                    swanlab.sync_wandb(wandb_run=False)
                except ImportError:
                    pass
                import wandb
                wandb.init(project=project, name=run_name, config=config)
                # assign only AFTER init succeeds: a failed init (no API
                # key, offline host) must degrade to console, not leave a
                # wandb handle whose .log() crashes the run
                self._wandb = wandb
            except Exception as e:  # wandb missing or offline: degrade
                self._wandb = None
                print(f"[metrics] wandb unavailable ({e}); console only")
        if outdir:
            os.makedirs(outdir, exist_ok=True)
            self._jsonl = open(os.path.join(outdir, "metrics.jsonl"), "a")
        self._t0 = time.time()

    def log(self, metrics: Dict, step: int | None = None) -> None:
        payload = {k: (float(v) if hasattr(v, "__float__") else v)
                   for k, v in metrics.items()}
        if self._wandb is not None:
            self._wandb.log(payload, step=step)
        if self._jsonl is not None:
            rec = {"t": round(time.time() - self._t0, 3), "step": step,
                   **payload}
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()

    def set_run_name(self, name: str) -> None:
        if self._wandb is not None and self._wandb.run is not None:
            self._wandb.run.name = name

    def log_image(self, name: str, image_bytes: bytes,
                  step: int | None = None, ext: str = "jpg") -> Optional[str]:
        """Log an image artifact: written next to metrics.jsonl (and to
        wandb when live). Returns the file path written, if any."""
        path = None
        if self._jsonl is not None:
            outdir = os.path.dirname(self._jsonl.name)
            fname = f"{name.replace('/', '_')}" + \
                (f"_step{step}" if step is not None else "") + f".{ext}"
            path = os.path.join(outdir, fname)
            with open(path, "wb") as fh:
                fh.write(image_bytes)
            self.log({f"{name}_path": path}, step=step)
        if self._wandb is not None:
            import io as _io
            try:
                from PIL import Image
                img = Image.open(_io.BytesIO(image_bytes))
                self._wandb.log({name: self._wandb.Image(img)}, step=step)
            except Exception:
                pass
        return path

    def finish(self) -> None:
        if self._wandb is not None and self._wandb.run is not None:
            self._wandb.finish()
        if self._jsonl is not None:
            self._jsonl.close()


def gen_roc_plot(fpr, tpr) -> bytes:
    """Render an ROC curve to JPEG bytes (util/utils.py:129-142 gen_plot):
    the curve over the unit square with its axes, "FPR", "TPR" and "ROC
    Curve" written on them. Drawn with PIL, which the port needs anyway:
    the machines with the card need not have matplotlib."""
    import io as _io

    import numpy as np
    from PIL import Image, ImageDraw

    size = 480  # pixels a side
    img = Image.new("RGB", (size, size), "white")
    draw = ImageDraw.Draw(img)
    lo, hi = 50, size - 30  # plot area in pixels

    def xy(f, t):
        return lo + f * (hi - lo), hi - t * (hi - lo)

    draw.rectangle([lo, lo - 20, hi, hi], outline="black")
    for v in (0.0, 0.5, 1.0):  # ticks
        x, y = xy(v, v)
        draw.text((x - 8, hi + 4), f"{v:.1f}", fill="black")
        draw.text((lo - 30, y - 6), f"{v:.1f}", fill="black")
    draw.text(((lo + hi) // 2 - 12, hi + 16), "FPR", fill="black")
    draw.text((4, (lo + hi) // 2), "TPR", fill="black")
    draw.text(((lo + hi) // 2 - 30, 10), "ROC Curve", fill="black")
    pts = [xy(float(f), float(t)) for f, t in
           zip(np.clip(fpr, 0, 1), np.clip(tpr, 0, 1))]
    if len(pts) > 1:
        draw.line(pts, fill="blue", width=2)
    buf = _io.BytesIO()
    img.save(buf, format="JPEG")
    return buf.getvalue()


def buffer_val(logger: MetricLogger, db_name: str, acc: float, std: float,
               xnorm: float, best_threshold: float, roc_image: bytes | None,
               batch: int | None = None) -> None:
    """Verification-eval tap (util/utils.py:298-313 buffer_val): scalar
    metrics keyed ``{db}_Accuracy/...`` plus the rendered ROC artifact."""
    logger.log({
        f"{db_name}_Accuracy": acc,
        f"{db_name}_Std": std,
        f"{db_name}_XNorm": xnorm,
        f"{db_name}_Best_Threshold": best_threshold,
    }, step=batch)
    if roc_image is not None:
        logger.log_image(f"{db_name}_ROC_Curve", roc_image, step=batch)


def make_run_name(cfg, num_epoch: int | None = None,
                  cl: bool = False) -> str:
    """Run name assembled from hyperparameters at exit — byte-for-byte the
    reference recipes.

    Single-step (default; train_own_forget.py:844-877): base
    ``remain-{first}-forget-{per}-lora_rank-{r}beta{b}lr{lr}BND{bnd}alpha{a}``
    with ``-warmup_alpha{big}`` appended and few-shot / EMA prefixes.

    ``cl=True`` (train_own_forget_cl.py:1764-1807): the base stops at
    ``lr{lr}``, and every baseline method branch prepends its prefix
    (``ewc{λ}``, ``mas{λ}``, ``l2{λ}``, ``retrain-``, ``LIRF``,
    ``SCRUB{smoothing}``, ``Lwf``, ``DER{plus}{λ}``, ``FDR{λ}``), then
    few-shot and ``imagenet100-`` prepend outermost."""
    f = cfg.forget
    # str() everywhere matches the reference exactly: its values come
    # straight from argparse-typed floats/ints through str concatenation
    name = ("remain-" + str(f.num_of_first_cls) + "-forget-" +
            str(f.per_forget_cls) + "-lora_rank-" + str(cfg.lora.rank) +
            "beta" + str(f.beta) + "lr" + str(cfg.optim.lr))
    if not cl:
        name = name + "BND" + str(f.bnd) + "alpha" + str(f.alpha)
    else:
        b = cfg.baseline
        m = b.method
        if m == "ewc":
            name = "ewc" + str(b.ewc_lambda) + name
        elif m == "mas":
            name = "mas" + str(b.mas_lambda) + name
        elif m == "l2":
            name = "l2" + str(b.l2_lambda) + name
        elif m == "retrain":
            name = "retrain-" + name
        elif m == "lirf":
            name = "LIRF" + name
        elif m == "scrub":
            name = "SCRUB" + str(b.sgda_smoothing) + name
        elif m == "lwf":
            name = "Lwf" + name
        elif m in ("der", "der_plus"):
            name = ("DER" + str(m == "der_plus" or b.der_plus) +
                    str(b.der_lambda) + name)
        elif m == "fdr":
            name = "FDR" + str(b.fdr_lambda) + name
    if f.few_shot:
        name = ("few_shot-" + str(f.few_shot_num) + "epoch-" +
                str(cfg.num_epoch if num_epoch is None else num_epoch) + name)
    if cl and cfg.data.data_mode == "imagenet100":
        name = "imagenet100-" + name
    if f.warmup_alpha:
        name = name + "-warmup_alpha" + str(f.big_alpha)
    if not cl and f.average_weight:
        name = "EMA" + str(f.ema_decay) + "-epoch" + str(f.ema_epoch) + name
    return name
