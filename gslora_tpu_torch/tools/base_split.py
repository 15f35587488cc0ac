"""Which of the pretrain's init, seed, compute dtype, remat and attention
moves the remain accuracy GS-LoRA keeps: bases pretrained with the
scripts' recipe under each arm, each forgotten by the single-step recipe
at several data seeds.

    python3 -m gslora_tpu_torch.tools.base_split --jax_init init.msgpack \
        [--arms torch0_bf16,jax0_bf16,...] [--seeds 3] \
        [--pretrain_epochs 12] [--epochs 25] [--out split.json] \
        [--device cuda] [--tiny]

The arms (``ARMS``): the init of torch seeds 0, 1 and 2
(``init_vit_params(torch.Generator().manual_seed(s))``) and the JAX
package's seed-0 init, read from ``--jax_init`` (the ``.msgpack`` that
the JAX package's checkpoints/io ``save_pytree`` writes of its
models/vit ``init_vit_params`` at key 0 for the unsaturated flagship and
a rank-8 LoRA; README.md shows how), each pretrained in bf16 (the
recipe's) and in fp32; torch seed 0 in bf16 also without remat and with
the plain attention ("dpa"). Each base is pretrained by
tools/flagship.pretrain_recipe (12 epochs of bs 240 on the noise-2.4
stand-in, AdamW lr 3e-4, 2 warm-up epochs, dropout 0.1), evaluated in
bf16 with K1 (test accuracy, the accuracy on the recipe's 10 forget
classes) and run through tools/integration_synthetic's ``--unsaturated``
forget recipe at data seeds 0 .. seeds - 1 (tools/attention_split.one_run:
bf16, K1, as the recipe runs it, so the arms differ in the base alone).
Any arm of the same grammar runs too: ``torch<s>`` or ``jax<s>`` (the
JAX init of seed s, from ``--jax_init`` with ``{seed}`` in the path),
``_bf16`` or ``_fp32``, then ``_noremat`` or ``_dpa``; ``--seeds 0``
pretrains and evaluates the bases alone.

The report (``--out``, else ``base_split.json`` in the temporary
directory; written again after every base) holds per base its arm, the
pretrain's test and forget-class accuracy, final loss, L2 norms (patch
kernel, pos_embed, cls_token, each block's qkv / fc1 / fc2 kernel, the
head's weight), wall and K1 launches by dtype, its forget runs (forget
accuracy before and after, remain accuracy, best H-mean, wall, K1
launches) and their mean and range over the seeds. On the card a "dpa"
pretrain must launch no K1, any other only the kernel of its dtype, and
each forget run only the bf16 kernel.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import tempfile
import time

import torch

from gslora_tpu_torch.checkpoints import msgpack
from gslora_tpu_torch.engine.loop import resolve_device
from gslora_tpu_torch.models.convert import flatten_tree
from gslora_tpu_torch.models.vit import init_vit_params
from gslora_tpu_torch.tools import attention_split as AS
from gslora_tpu_torch.tools import flagship
from gslora_tpu_torch.tools import integration_synthetic as IS

# the split's arms: <torch|jax><init seed>_<bf16|fp32>[_noremat|_dpa]
ARMS = ("torch0_bf16", "torch0_fp32", "torch1_bf16", "torch1_fp32",
        "torch2_bf16", "torch2_fp32", "jax0_bf16", "jax0_fp32",
        "torch0_bf16_noremat", "torch0_bf16_dpa")
_ARM = re.compile(r"((?:torch|jax)\d+)_(bf16|fp32)(_noremat|_dpa)?")
FORGET_DTYPE, FORGET_IMPL = "bfloat16", "auto"  # the forget recipe's


def arm(name: str):
    """(init, pretrain compute dtype, remat, attn_impl) of an arm's name:
    the init ``torch<s>`` or ``jax<s>``, bf16 or fp32, remat unless
    ``_noremat``, K1 unless ``_dpa`` (the plain attention)."""
    m = _ARM.fullmatch(name)
    if m is None:
        raise ValueError(f"unknown arm {name!r}: <torch|jax><seed>_<bf16|"
                         f"fp32>[_noremat|_dpa], as {', '.join(ARMS)}")
    init, tag, extra = m.groups()
    return (init, "bfloat16" if tag == "bf16" else "float32",
            extra != "_noremat", "dpa" if extra == "_dpa" else "auto")


def jax_init_path(jax_init: str | None, seed: int) -> str:
    """The file of the JAX init of ``seed``: ``{seed}`` in ``jax_init``
    replaced, or ``jax_init`` itself for seed 0."""
    if jax_init and "{seed}" in jax_init:
        return jax_init.format(seed=seed)
    if not jax_init or seed:
        raise ValueError(f"a jax{seed} arm needs --jax_init: the JAX "
                         f"package's init as a .msgpack (with {{seed}} in "
                         f"the path for seeds other than 0)")
    return jax_init


def init_tree(init: str, model, jax_init: str | None = None):
    """The parameter tree an arm starts from: ``torch<s>`` the port's init
    of torch seed s, ``jax<s>`` the JAX package's init of seed s read
    from :func:`jax_init_path` (its leaves must have the port's names and
    shapes)."""
    jax = init.startswith("jax")
    seed = int(init[len("jax" if jax else "torch"):])
    want = init_vit_params(torch.Generator().manual_seed(seed), model,
                           flagship.LORA)
    if not jax:
        return want
    path = jax_init_path(jax_init, seed)
    params = msgpack.load(path)
    got, ref = flatten_tree(params), flatten_tree(want)
    shapes = {k: tuple(v.shape) for k, v in got.items()}
    if shapes != {k: tuple(v.shape) for k, v in ref.items()}:
        raise ValueError(f"{path} does not hold the model's tree: "
                         f"{sorted(set(shapes) ^ set(ref))[:5]}")
    return params


def norms(params) -> dict:
    """L2 norms of the embedding, each block's projection kernels and the
    head's weight."""
    base = params["base"]
    blocks = base["blocks"]

    def l2(t):
        return float(torch.linalg.vector_norm(t.float()))

    return {"patch": l2(base["patch"]["kernel"]),
            "pos_embed": l2(base["pos_embed"]),
            "cls_token": l2(base["cls_token"]),
            **{k: [l2(t) for t in blocks[k]["kernel"]]
               for k in ("qkv", "fc1", "fc2")},
            "head": l2(base["head"]["weight"])}


def pretrain_arm(name, model, train, test, data, *, epochs, device,
                 jax_init=None):
    """The arm's base and its numbers; raises on the card unless K1 ran
    as the arm says."""
    init, dtype, remat, impl = arm(name)
    dev = resolve_device(device)
    start = init_tree(init, model, jax_init)
    AS.sync(dev)
    counted = AS.k1_launches()
    t0 = time.perf_counter()
    params, metrics = flagship.pretrain_recipe(
        model, train, epochs, str(dev), start,
        compute_dtype=flagship.dtype(dtype), remat=remat, attn_impl=impl)
    AS.sync(dev)
    wall = time.perf_counter() - t0
    launches = AS.k1_launches(since=counted)
    if dev.type == "cuda":
        used = {k for k, v in launches.items() if any(v)}
        if used != ({dtype} if impl == "auto" else set()):
            raise RuntimeError(f"{name}: pretrain K1 launches {launches}")

    def acc(ds):
        return flagship.accuracy(params, ds, model, dev, IS.EVAL_BS,
                                 mask_padding=False)

    return params, {
        "arm": name, "init": init, "compute_dtype": dtype, "remat": remat,
        "attn_impl": impl, "pretrain_epochs": epochs,
        "pretrain_test_acc": acc(test),
        "forget_classes_acc": acc(data.test_forget),
        "final_loss": metrics["loss"], "final_acc": metrics["acc"],
        "norms": norms(params), "pretrain_wall_s": round(wall, 1),
        "k1_launches": launches}


def summarize(runs) -> dict:
    """Mean and range of each forget metric over the seeds (none without
    runs)."""
    return {} if not runs else {m: {"mean": statistics.fmean(r[m] for r in runs),
                "min": min(r[m] for r in runs),
                "max": max(r[m] for r in runs)} for m in AS.METRICS}


def card_line(dev) -> str:
    """``nvidia-smi``'s name and power limit of the cards ('cpu' off the
    card)."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def run_split(model, train, test, *, arms, seeds: int, pretrain_epochs: int,
              epochs: int, device: str = "cuda", jax_init: str | None = None,
              out: str | None = None) -> dict:
    """Every arm's base, then its forget runs; writes the report after
    each base and returns it."""
    dev = resolve_device(device)
    for name in arms:  # refuse before any pretrain
        init = arm(name)[0]
        if init.startswith("jax"):
            jax_init_path(jax_init, int(init[len("jax"):]))
    out = out or os.path.join(tempfile.gettempdir(), "base_split.json")
    report = {"card": card_line(dev), "device": flagship.device_name(dev),
              "pretrain_epochs": pretrain_epochs, "epochs": epochs,
              "seeds": seeds, "forget": {"compute_dtype": FORGET_DTYPE,
                                         "attn_impl": FORGET_IMPL},
              "bases": {}}
    print(report["card"], flush=True)
    data = IS.forget_data(train, test)
    for name in arms:
        params, base = pretrain_arm(name, model, train, test, data,
                                    epochs=pretrain_epochs, device=device,
                                    jax_init=jax_init)
        print(json.dumps(base), flush=True)
        base["runs"] = []
        for seed in range(seeds):
            run = AS.one_run(params, data, model, dtype=FORGET_DTYPE,
                             impl=FORGET_IMPL, seed=seed, epochs=epochs,
                             device=device)
            print(json.dumps({"arm": name, **run}), flush=True)
            base["runs"].append(run)
        base["summary"] = summarize(base["runs"])
        report["bases"][name] = base
        with open(out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({k: {"pretrain_test_acc": b["pretrain_test_acc"],
                          "forget_classes_acc": b["forget_classes_acc"],
                          **b["summary"].get("remain_acc_after", {})}
                      for k, b in report["bases"].items()}, indent=1),
          flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arms", default=",".join(ARMS),
                    help="comma-separated arms (default: ARMS); any "
                         "<torch|jax><seed>_<bf16|fp32>[_noremat|_dpa]")
    ap.add_argument("--jax_init", default=None,
                    help="the JAX package's seed-0 init (.msgpack) for the "
                         "jax0 arms; {seed} in the path for jax<seed>")
    ap.add_argument("--seeds", type=int, default=3,
                    help="forget runs per base (0: the bases alone)")
    ap.add_argument("--pretrain_epochs", type=int,
                    default=flagship.pretrain_epochs(True))
    ap.add_argument("--epochs", type=int, default=IS.EPOCHS)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="the integration tools' tiny model (a CPU run)")
    a = ap.parse_args(argv)
    resolve_device(a.device)
    model = flagship.model_config(True, tiny=a.tiny)
    train, test = flagship.stand_in(model, flagship.noise(True))
    return run_split(model, train, test, arms=a.arms.split(","),
                     seeds=a.seeds, pretrain_epochs=a.pretrain_epochs,
                     epochs=a.epochs, device=a.device, jax_init=a.jax_init,
                     out=a.out)


if __name__ == "__main__":
    main()
