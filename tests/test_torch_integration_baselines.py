"""The port's single-task baseline integration tool (gslora_tpu_torch/
tools/integration_baselines.py) against the JAX package's composition of
scripts/integration_baselines.py (tests/torch_integration_setup.py), every
one of its twelve methods, from one base, at the scripts' tiny model and
data, fp32, dropout 0, every epoch count cut to 1. The continual tool is
held in tests/test_torch_integration_baselines_cl.py.

Tolerances: accuracies equal (the same predictions, to float rounding),
best H-means to 1e-6. Every run takes the scripts' batch of 48."""
import json
import os

import pytest

import gslora_tpu.config as jc
import gslora_tpu_torch.config as tc
from gslora_tpu_torch.models.convert import params_from_jax
from gslora_tpu_torch.tools import integration_baselines as B
from gslora_tpu_torch.tools import integration_baselines_cl as CL

from torch_baselines_setup import np_tree, one_torch_thread
from torch_integration_setup import (TINY, assert_close, jax_single_task,
                                     jax_tree, stand_in, tiny_model,
                                     trained_base)

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)

NOISE = 2.4  # the unsaturated stand-in
ONE_EPOCH = B.with_epochs(B.RECIPES, 1)


@pytest.fixture(scope="module")
def setup():
    """The base (numpy), Retrain's fresh start (the JAX init of seed 11),
    and both packages' data."""
    return {"base": trained_base("Softmax", NOISE),
            "fresh": np_tree(11, rank=8, model={**TINY,
                                                "head_type": "Softmax"}),
            "jax": stand_in("jax", NOISE), "torch": stand_in("torch", NOISE)}


def port_single(setup, methods, tmp_path, out=None, **kw):
    return B.run_methods(
        methods, params_from_jax(setup["base"]), *setup["torch"],
        tiny_model(tc), 48, "cpu", fresh_params=params_from_jax(
            setup["fresh"]), recipes=ONE_EPOCH, suffix="_unsat",
        compute_dtype="float32", out=out or str(tmp_path / "report.json"),
        **kw)


@pytest.mark.parametrize("method", ["gs_lora", "ewc", "lwf", "lirf", "scrub",
                                    "replay", "retrain", "mas", "l2", "der",
                                    "der_plus", "fdr"])
def test_single_task_matches_jax(setup, tmp_path, method):
    """One method of the single-task matrix: the pretrain accuracy and the
    method's forget-before, forget, remain accuracies and best H as the
    JAX composition gives them from the same base."""
    pre, want = jax_single_task(method, jax_tree(setup["base"]),
                                jax_tree(setup["fresh"]), *setup["jax"],
                                tiny_model(jc), 48, 1)
    report = port_single(setup, [method], tmp_path)
    assert set(report) == {"pretrain_test_acc_unsat", method + "_unsat",
                           "total_wallclock_s"}
    assert_close(report["pretrain_test_acc_unsat"], pre, "pretrain")
    got = report[method + "_unsat"]
    assert set(got) == {*want, "wallclock_s"}
    for key in ("forget_acc_before", "forget_acc", "remain_acc"):
        assert_close(got[key], want[key], (method, key))
    assert_close(got["best_h"], want["best_h"], method)


def test_recipes_are_the_scripts():
    """The twelve methods in the script's order, the script's SystemExit
    for unknown ones, and every epoch count (SCRUB's superepochs too)
    cut by with_epochs."""
    assert list(B.RECIPES) == ["gs_lora", "lwf", "der", "der_plus", "fdr",
                               "lirf", "ewc", "mas", "l2", "retrain",
                               "replay", "scrub"]
    with pytest.raises(SystemExit, match=r"unknown --methods \['sgd'\]; "
                       r"choose from \['der', 'der_plus', 'ewc'"):
        B.check_methods(["ewc", "sgd"])
    with pytest.raises(SystemExit, match=r"unknown --methods \[\]"):
        B.main(["--methods", ",", "--device", "cpu"])
    assert {r["n_ep"] for r in ONE_EPOCH.values()} == {1}
    assert ONE_EPOCH["scrub"]["baseline"]["scrub_superepoch"] == 1
    assert B.RECIPES["scrub"]["baseline"]["scrub_superepoch"] == 2
    assert set(CL.RECIPES) == set(B.RECIPES) - {"gs_lora"}


def test_reports_merge_where_asked(setup, tmp_path, monkeypatch):
    """--out is honoured, a second method merges into the first's report,
    the default is the temporary directory's integration_baselines.json,
    and nothing is written to the working directory."""
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    out = tmp_path / "mine.json"
    port_single(setup, ["l2"], tmp_path, out=str(out))
    port_single(setup, ["replay"], tmp_path, out=str(out))
    merged = json.loads(out.read_text())
    assert set(merged) == {"pretrain_test_acc_unsat", "l2_unsat",
                           "replay_unsat", "total_wallclock_s"}
    temp = tmp_path / "temp"
    temp.mkdir()
    monkeypatch.setattr("tempfile.tempdir", str(temp))
    assert B.default_out() == str(temp / "integration_baselines.json")
    assert CL.default_out() == str(temp / "integration_baselines_cl.json")
    (temp / "integration_baselines.json").write_text("not json")
    B.run_methods(["l2"], params_from_jax(setup["base"]), *setup["torch"],
                  tiny_model(tc), 48, "cpu", recipes=ONE_EPOCH,
                  compute_dtype="float32")
    written = json.loads((temp / "integration_baselines.json").read_text())
    assert set(written) == {"pretrain_test_acc", "l2", "total_wallclock_s"}
    assert os.listdir(work) == []
