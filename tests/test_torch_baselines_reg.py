"""The regularization baselines of the port (Retrain / Replay / L2 / EWC /
MAS: gslora_tpu_torch/baselines/regularization.py) against the JAX
package's, on the same numpy-drawn weights and data (fp32, dropout 0):
the importances, one task of training with padded batches (the -1
sentinel every loader on the card emits), micro-batched steps against
one call, and the continual CLI for each method over two tasks.

Tolerances: trained parameters and importances 5e-3 relative (as
tests/test_training_parity.py), logged losses 1e-3, accuracies equal
(the same predictions)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gslora_tpu.cli.train_forget_cl as jcli
import gslora_tpu.config as jc
from gslora_tpu.baselines.regularization import \
    estimate_importance as jax_importance
from gslora_tpu.baselines.regularization import \
    run_regularization_task as jax_reg_task

import gslora_tpu_torch.cli.train_forget_cl as tcli
import gslora_tpu_torch.config as tc
from gslora_tpu_torch.baselines.freeze import trains
from gslora_tpu_torch.baselines.regularization import (estimate_importance,
                                                       make_reg_step,
                                                       run_regularization_task)
from gslora_tpu_torch.engine.pretrain import PretrainState
from gslora_tpu_torch.engine.state import make_optimizer
from gslora_tpu_torch.models.convert import params_from_jax
from gslora_tpu_torch.models.vit import ViT

from torch_baselines_setup import (CL_ARGS, MODEL, Recorder,
                                   assert_reports_match, assert_trees_close,
                                   loaders, np_tree, one_torch_thread,
                                   patch_clis, run_both_clis, run_config,
                                   task_data, to_jax, to_numpy)

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)


def _importance_batches(pkg):
    """The remain split in batches of 7 padded to full size: a ragged
    tail of 2 rows repeated unevenly (30 = 4 * 7 + 2)."""
    from gslora_tpu_torch.data.pipeline import BatchLoader as TL
    if pkg == "jax":
        from gslora_tpu.data.pipeline import BatchLoader
    else:
        BatchLoader = TL
    return BatchLoader(task_data(pkg)[1], 7, shuffle=False, prefetch=0,
                       mask_padding=True)


@pytest.fixture(scope="module")
def jax_importances():
    """method -> the JAX package's importance of the seed-0 tree over
    :func:`_importance_batches`, computed once per method."""
    cache = {}

    def get(method):
        if method not in cache:
            cache[method] = to_numpy(jax_importance(
                method, to_jax(np_tree(0)), _importance_batches("jax"),
                jc.ViTConfig(**MODEL), jc.LoraConfig(rank=0), jnp.float32))
        return cache[method]

    return get


@pytest.mark.parametrize("method", ["l2", "ewc", "mas"])
def test_importance_matches_jax(method, jax_importances):
    p = np_tree(0)
    want = jax_importances(method)
    got = estimate_importance(method, params_from_jax(p),
                              _importance_batches("torch"),
                              tc.ViTConfig(**MODEL), tc.LoraConfig(rank=0),
                              torch.float32)
    # importances are small numbers: atol is 1e-4 of each leaf's largest
    assert_trees_close(got, want, atol=1e-4, scaled=True, what=method)
    if method != "l2":
        assert float(got["base"]["patch"]["kernel"].abs().sum()) > 0


def test_reg_task_matches_jax(jax_importances):
    """EWC with one anchor term (lambda 50), padded forget batches, an
    eval every 2 steps."""
    p = np_tree(0)
    imp = jax_importances("ewc")
    out = {}
    for pkg, C, run, conv in (("jax", jc, jax_reg_task, to_jax),
                              ("torch", tc, run_regularization_task,
                               params_from_jax)):
        fl, _, tbf, tbr = loaders(pkg)
        rec = Recorder()
        cfg = run_config(C, "ewc", epochs=2,
                         **({"device": "cpu"} if pkg == "torch" else {}))
        res = run(cfg, conv(p), lambda: iter(fl), tbf, tbr, lam=50.0,
                  anchors=[conv(p)], importances=[conv(imp)], logger=rec,
                  eval_every=2)
        out[pkg] = (res, rec)
    (jres, jrec), (tres, trec) = out["jax"], out["torch"]
    for key in ("forget_acc_before", "forget_acc", "remain_acc", "best_h"):
        assert tres[key] == pytest.approx(jres[key], abs=1e-6), key
    for key in ("loss_CE", "loss_regularization", "loss_total"):
        assert len(trec.series(key)) == len(jrec.series(key)) == 4
        np.testing.assert_allclose(trec.series(key), jrec.series(key),
                                   rtol=1e-3, atol=1e-6, err_msg=key)
    assert trec.series("loss_regularization")[-1] > 0
    assert_trees_close(tres["params"], jres["params"])
    # the margin head is frozen (baselines/freeze.py)
    assert torch.equal(tres["params"]["base"]["head"]["weight"],
                       torch.tensor(p["base"]["head"]["weight"]))


def _pad_batch(seed, n, valid):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(n, 3, 16, 16).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 8, n).astype(np.int64))
    y[valid:] = -1
    return x, y


def test_grad_accum_equals_one_call():
    """Two micro-batches of a padded batch (7 valid of 8, one micro with a
    pad row) and one call give the same update, penalty included."""
    p = params_from_jax(np_tree(0))
    anchor = params_from_jax(np_tree(1))
    imp = params_from_jax(np_tree(2))
    x, y = _pad_batch(0, 8, 7)
    model, lora = tc.ViTConfig(**MODEL), tc.LoraConfig(rank=0)
    after = {}
    for n in (1, 2):
        opt = make_optimizer(tc.OptimConfig(lr=1e-3))
        state = PretrainState.create(ViT(p, model, lora), opt,
                                     trains=trains)
        step = make_reg_step(model, lora, opt, compute_dtype=torch.float32,
                             grad_accum=n)
        state, m = step(state, x, y, [anchor], [imp], 0.5, 1e-3)
        after[n] = (state.params, m)
    np.testing.assert_allclose(float(after[2][1]["loss_total"]),
                               float(after[1][1]["loss_total"]), rtol=1e-5)
    assert_trees_close(after[2][0], after[1][0], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("flag", ["--retrain", "--replay", "--l2", "--ewc",
                                  "--MAS"])
def test_cl_cli_matches_jax(flag, monkeypatch, tmp_path):
    """train_forget_cl over two tasks: the reports and each task's
    snapshot. Retrain's fresh model of each task is the same numpy-drawn
    tree in both packages; EWC, MAS and L2 anchor to task 0's start and
    end, with task 1's importance over its full remain split."""
    patch_clis(monkeypatch, jcli, tcli)
    runs = run_both_clis(jcli, tcli, CL_ARGS + [flag], tmp_path)
    (jrep, jsnaps), (trep, tsnaps) = runs["jax"], runs["torch"]
    assert_reports_match(trep, jrep)
    for t, (got, want) in enumerate(zip(tsnaps, jsnaps)):
        assert_trees_close(got, want, what=f"{flag} task {t}")
    start = np_tree(0)["base"]
    moved = np.abs(tsnaps[1]["base"]["patch"]["kernel"] -
                   start["patch"]["kernel"]).max()
    assert moved > 0  # the task trained the patch embedding
