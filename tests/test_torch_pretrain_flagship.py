"""The port's pretrain (gslora_tpu_torch/engine/pretrain.pretrain, as
tools/flagship.pretrain_recipe runs it) against the JAX package's
``pretrain`` at the flagship's widths: image 112 with patch 8 (197
tokens), dim 512, 8 heads x 64, mlp 2048, a Softmax head over 100
classes, rank-8 LoRA (trained with the rest, as the scripts' pretrain
does), AdamW at lr 3e-4 with the timm schedule's 2 warm-up epochs,
remat, fp32 and dropout 0 on the CPU. Both start from the JAX seed-0
init (params_from_jax). The JAX attention is its plain reference
(attn_impl "auto" is the einsum on the CPU, as in
tests/test_torch_integration_flagship.py: interpret-mode Pallas is held
at TINY in tests/test_torch_pretrain.py and is too slow at 197 tokens);
the port's is K1's plain version.

The tier-1 test cuts the depth to 1 and takes 3 steps of 24 numpy-drawn
images over 2 epochs of the schedule (2 steps at the warm-up's first lr,
1 at its second), with remat and without: loss and accuracy per step to
rtol 1e-4, atol 1e-5, every parameter at the end to rtol 5e-3, atol 5e-5
(tests/test_torch_pretrain.py's tolerances).

The slow test runs depth 6 at bs 240 over the 2400-image noise-2.4
stand-in in the recipe's batch order (BatchLoader(train, 240, seed=3)),
``$FLAGSHIP_PRETRAIN_EPOCHS`` epochs of the 12-epoch schedule (1 by
default: 10 steps): the per-step loss of the first epoch to rtol 1e-4,
the test accuracy on the 500-image test set after the run to 1 point;
both packages' numbers are printed:

    JAX_PLATFORMS=cpu FLAGSHIP_PRETRAIN_EPOCHS=2 python -m pytest \\
        tests/test_torch_pretrain_flagship.py -m slow -s
"""
import os

import numpy as np
import pytest
import torch

import gslora_tpu.config as jc
import gslora_tpu_torch.config as tc
from gslora_tpu_torch.models import vit as V
from gslora_tpu_torch.models.convert import flatten_tree, params_from_jax, \
    params_to_jax
from gslora_tpu_torch.tools import flagship

from torch_baselines_setup import (LOSS_RTOL, PARAM_ATOL, PARAM_RTOL,
                                   np_tree, one_torch_thread)
from torch_integration_setup import (FLAGSHIP, jax_accuracy, jax_tree,
                                     stand_in)

# tier-1 runs several processes at once: one intra-op thread each
_one_torch_thread = pytest.fixture(one_torch_thread)
WIDTHS = {**FLAGSHIP, "dropout": 0.0, "emb_dropout": 0.0}
OPTIM = dict(lr=3e-4, warmup_epochs=2, epochs=12)  # the scripts' recipe
LORA_RANK = 8


def model(C, depth, remat=True):
    return C.ViTConfig(**{**WIDTHS, "depth": depth}, head_type="Softmax",
                       remat=remat)


def run_config(C, depth, remat, bs, **over):
    return C.RunConfig(model=model(C, depth, remat),
                       lora=C.LoraConfig(rank=LORA_RANK),
                       optim=C.OptimConfig(**OPTIM),
                       data=C.DataConfig(batch_size=bs), **over)


def recorded(monkeypatch, module, log):
    """``module.pretrain`` with every step's metrics appended to ``log``:
    its ``make_pretrain_step`` wrapped, neither package edited."""
    make = module.make_pretrain_step

    def wrapped(*args, **kwargs):
        step = make(*args, **kwargs)

        def logged(*a, **k):
            state, metrics = step(*a, **k)
            log.append({name: float(v) for name, v in metrics.items()})
            return state, metrics

        return logged

    monkeypatch.setattr(module, "make_pretrain_step", wrapped)


def run_both(monkeypatch, tree, depth, remat, bs, batches_fn, epochs):
    """Both packages' ``pretrain`` from ``tree`` (numpy leaves) over
    ``batches_fn(pkg)`` for ``epochs`` epochs in fp32: (JAX's params as
    numpy leaves, its per-step metrics, the port's state, its per-step
    metrics)."""
    import jax
    import jax.numpy as jnp

    import gslora_tpu.engine.pretrain as JP
    import gslora_tpu_torch.engine.pretrain as TP

    jlog, tlog = [], []
    recorded(monkeypatch, JP, jlog)
    recorded(monkeypatch, TP, tlog)
    jstate, _ = JP.pretrain(run_config(jc, depth, remat, bs), jax_tree(tree),
                            lambda: batches_fn("jax"), epochs=epochs,
                            compute_dtype=jnp.float32)
    tstate, _ = TP.pretrain(run_config(tc, depth, remat, bs, device="cpu"),
                            params_from_jax(tree),
                            lambda: batches_fn("torch"), epochs=epochs,
                            compute_dtype=torch.float32)
    return jax.tree.map(np.asarray, jstate.params), jlog, tstate, tlog


def assert_steps_close(got, want, steps, keys=("loss", "acc")):
    assert len(got) == len(want) >= steps
    for s in range(steps):
        assert set(got[s]) == set(want[s]) == {"loss", "acc"}
        for k in keys:
            np.testing.assert_allclose(got[s][k], want[s][k], rtol=LOSS_RTOL,
                                       atol=1e-5, err_msg=f"step {s}: {k}")


@pytest.mark.usefixtures("_one_torch_thread")
@pytest.mark.parametrize("remat", [True, False])
def test_flagship_width_pretrain_matches_jax(monkeypatch, remat):
    """Depth 1 at the flagship's widths: 3 steps of 24 images, 2 in the
    schedule's epoch 0 (lr 1e-6) and 1 in its epoch 1 (lr 1.505e-4)."""
    rng = np.random.RandomState(0)
    data = [(rng.rand(24, 3, 112, 112).astype(np.float32),
             rng.randint(0, 100, 24).astype(np.int32)) for _ in range(3)]
    epochs = {"jax": iter([data[:2], data[2:]]),
              "torch": iter([data[:2], data[2:]])}
    blocks = []
    attention = V._attention_block

    def counted(*args, **kwargs):
        blocks.append(1)
        return attention(*args, **kwargs)

    monkeypatch.setattr(V, "_attention_block", counted)
    tree = np_tree(0, rank=LORA_RANK, model={**WIDTHS, "depth": 1,
                                             "head_type": "Softmax"})
    want, jlog, tstate, tlog = run_both(
        monkeypatch, tree, 1, remat, 24, lambda pkg: iter(next(epochs[pkg])),
        epochs=2)
    # remat reruns the one block's forward in each step's backward
    assert len(blocks) == 3 * (2 if remat else 1)
    assert_steps_close(tlog, jlog, 3)
    got = flatten_tree(params_to_jax(tstate.model))
    want = flatten_tree(want)
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=name)
    start = flatten_tree(tree)
    # every parameter trains: the LoRA's B leaves zero after the first step
    assert all(not np.array_equal(want[n], start[n])
               for n in ("base.patch.kernel", "base.blocks.qkv.kernel",
                         "lora.ffn.B1", "lora.ffn.B2", "base.head.weight"))


@pytest.mark.slow
def test_flagship_pretrain_matches_jax(monkeypatch):
    """Depth 6 at bs 240 over the stand-in in the recipe's batch order
    for ``$FLAGSHIP_PRETRAIN_EPOCHS`` epochs (printed)."""
    from gslora_tpu.data.pipeline import BatchLoader as JaxLoader
    from gslora_tpu_torch.data.pipeline import BatchLoader

    epochs = int(os.environ.get("FLAGSHIP_PRETRAIN_EPOCHS", "1"))
    data = {"jax": stand_in("jax", 2.4, image_size=112),
            "torch": flagship.stand_in(model(tc, 6), 2.4)}
    loader = {"jax": JaxLoader, "torch": BatchLoader}
    tree = np_tree(0, rank=LORA_RANK, model={**WIDTHS, "head_type":
                                             "Softmax"})
    want, jlog, tstate, tlog = run_both(
        monkeypatch, tree, 6, True, 240,
        lambda pkg: loader[pkg](data[pkg][0], 240, seed=3), epochs=epochs)
    per_epoch = -(-len(data["torch"][0].images) // 240)
    jax_acc = jax_accuracy(jax_tree(want), data["jax"][1], model(jc, 6),
                           250, False)
    port_acc = flagship.accuracy(tstate.params, data["torch"][1],
                                 model(tc, 6), torch.device("cpu"), 250,
                                 mask_padding=False,
                                 compute_dtype=torch.float32)
    for name, log, acc in (("jax", jlog, jax_acc), ("port", tlog, port_acc)):
        print(name, {"epochs": epochs, "test_acc": acc,
                     "loss": [round(m["loss"], 6) for m in log],
                     "acc": [round(m["acc"], 4) for m in log]}, flush=True)
    assert len(tlog) == len(jlog) == epochs * per_epoch
    assert_steps_close(tlog, jlog, per_epoch, keys=("loss",))
    assert abs(port_acc - jax_acc) <= 1.0, (port_acc, jax_acc)
