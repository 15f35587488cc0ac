"""The teacher-student baselines of the port (LwF / DER / DER++ / FDR:
gslora_tpu_torch/baselines/distill.py) against the JAX package's, on the
same numpy-drawn weights and data (fp32, dropout 0): one task of each
with padded batches (the -1 sentinel every loader on the card emits),
micro-batched steps against one call, the teacher across tasks, and the
continual CLI for each method over two tasks.

Tolerances: trained parameters 5e-3 relative (as
tests/test_training_parity.py), logged losses 1e-3, accuracies equal
(the same predictions)."""
import numpy as np
import pytest
import torch

import gslora_tpu.cli.train_forget_cl as jcli
import gslora_tpu.config as jc
from gslora_tpu.baselines.distill import run_distill_task as jax_task
from gslora_tpu.data.pipeline import CyclingLoader as JaxCycling

import gslora_tpu_torch.cli.train_forget_cl as tcli
import gslora_tpu_torch.config as tc
from gslora_tpu_torch.baselines.distill import (make_distill_step,
                                                run_distill_task)
from gslora_tpu_torch.baselines.freeze import trains
from gslora_tpu_torch.data.pipeline import CyclingLoader
from gslora_tpu_torch.engine.pretrain import PretrainState
from gslora_tpu_torch.engine.state import make_optimizer
from gslora_tpu_torch.models.convert import params_from_jax
from gslora_tpu_torch.models.vit import ViT

from torch_baselines_setup import (CL_ARGS, MODEL, Recorder,
                                   assert_reports_match, assert_trees_close,
                                   loaders, np_tree, one_torch_thread,
                                   patch_clis, run_both_clis, run_config,
                                   to_jax)

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)

METHODS = ["lwf", "der", "der_plus", "fdr"]
TERMS = {"lwf": ["loss_KD", "loss_remain"], "der": ["loss_DER"],
         "der_plus": ["loss_DER", "loss_CE_next"], "fdr": ["loss_FDR"]}


def _run(pkg, method, teacher_seed=0, **bkw):
    """One task of ``method`` in package ``pkg`` from the seed-3 tree,
    the seed-``teacher_seed`` tree as the teacher, padded loaders, two
    epochs."""
    p, t = np_tree(3), np_tree(teacher_seed)
    fl, rl, tbf, tbr = loaders(pkg)
    rec = Recorder()
    if pkg == "jax":
        res = jax_task(run_config(jc, method, epochs=2, **bkw), to_jax(p),
                       to_jax(t), lambda: iter(fl), JaxCycling(rl), tbf,
                       tbr, logger=rec)
    else:
        res = run_distill_task(
            run_config(tc, method, device="cpu", epochs=2, **bkw),
            params_from_jax(p), params_from_jax(t), lambda: iter(fl),
            CyclingLoader(rl), tbf, tbr, logger=rec)
    return res, rec


@pytest.mark.parametrize("method", METHODS)
def test_distill_task_matches_jax(method):
    (jres, jrec), (tres, trec) = _run("jax", method), _run("torch", method)
    for key in ("forget_acc_before", "forget_acc", "remain_acc", "best_h"):
        assert tres[key] == pytest.approx(jres[key], abs=1e-6), key
    for key in ["loss_CE", "loss_total"] + TERMS[method]:
        assert len(trec.series(key)) == len(jrec.series(key)) == 4
        np.testing.assert_allclose(trec.series(key), jrec.series(key),
                                   rtol=1e-3, atol=1e-6, err_msg=key)
    assert_trees_close(tres["params"], jres["params"])


def test_lwf_faithful_zero_kd():
    """The reference's own LwF term is identically zero; the flag keeps
    it so, and the run still trains on both CE terms."""
    res, rec = _run("torch", "lwf", lwf_faithful_zero_kd=True)
    assert rec.series("loss_KD") == [0.0] * 4
    assert all(v > 0 for v in rec.series("loss_remain"))


def _streams(seed, valid):
    """Forget, remain and second remain batches of 8 with ``valid`` valid
    rows each (pad rows last)."""
    rng = np.random.RandomState(seed)
    out = []
    for v in valid:
        x = torch.from_numpy(rng.randn(8, 3, 16, 16).astype(np.float32))
        y = torch.from_numpy(rng.randint(0, 8, 8).astype(np.int64))
        y[v:] = -1
        out += [x, y]
    return out


@pytest.mark.parametrize("method", METHODS)
def test_grad_accum_equals_one_call(method):
    """Two micro-batches per stream, padded tails of different lengths
    (one micro of the second remain batch is all padding), against one
    call: the same update and the same metrics."""
    teacher = params_from_jax(np_tree(0))
    p = params_from_jax(np_tree(3))
    model, lora = tc.ViTConfig(**MODEL), tc.LoraConfig(rank=0)
    hp = {"T": 2.0, "lambda_kd": 0.5, "lambda_remain": 1.0,
          "lambda_der": 0.5, "lambda_der_plus": 0.3, "lambda_fdr": 0.5}
    batches = _streams(0, (7, 5, 3))
    after = {}
    for n in (1, 2):
        opt = make_optimizer(tc.OptimConfig(lr=1e-3))
        state = PretrainState.create(ViT(p, model, lora), opt,
                                     trains=trains)
        step = make_distill_step(method, model, lora, opt, hp,
                                 compute_dtype=torch.float32, grad_accum=n)
        state, m = step(state, teacher, *batches, 1e-3)
        after[n] = (state.params, m)
    assert set(after[1][1]) == set(after[2][1])
    for k, v in after[1][1].items():
        np.testing.assert_allclose(float(after[2][1][k]), float(v),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert_trees_close(after[2][0], after[1][0], rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """flag -> (both CLIs' two-task runs, the (params, teacher) each task
    of the port's run was given): one run of each package per method,
    shared by the parity and the teacher tests."""
    cache = {}

    def get(flag):
        if flag not in cache:
            seen = []
            orig = tcli.run_distill_task

            def spy(cfg, params, teacher, *a, **k):
                seen.append((params, teacher))
                return orig(cfg, params, teacher, *a, **k)

            with pytest.MonkeyPatch.context() as mp:
                patch_clis(mp, jcli, tcli)
                mp.setattr(tcli, "run_distill_task", spy)
                runs = run_both_clis(jcli, tcli, CL_ARGS + [flag],
                                     tmp_path_factory.mktemp(flag[2:]))
            cache[flag] = (runs, seen)
        return cache[flag]

    return get


def test_teacher_is_the_pretrained_model_every_task(cli_runs):
    """The reference deep-copies the teacher once before the task loop
    (train_own_forget_cl.py:453-476): task 1's teacher is the pretrained
    model, not task 0's student."""
    _, seen = cli_runs("--Der")
    start = np_tree(0)
    assert len(seen) == 2
    for params, teacher in seen:
        assert_trees_close(teacher, start, rtol=0, atol=0)
    moved = seen[1][0]["base"]["patch"]["kernel"].numpy() - \
        start["base"]["patch"]["kernel"]
    assert np.abs(moved).max() > 0  # task 1 starts from task 0's student


@pytest.mark.parametrize("flag", ["--Lwf", "--Der", "--DER_plus", "--FDR"])
def test_cl_cli_matches_jax(flag, cli_runs):
    """train_forget_cl over two tasks: the reports and each task's
    snapshot."""
    runs, _ = cli_runs(flag)
    (jrep, jsnaps), (trep, tsnaps) = runs["jax"], runs["torch"]
    assert_reports_match(trep, jrep)
    for t, (got, want) in enumerate(zip(tsnaps, jsnaps)):
        assert_trees_close(got, want, what=f"{flag} task {t}")
