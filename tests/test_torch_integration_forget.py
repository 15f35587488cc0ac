"""The port's GS-LoRA integration tools (gslora_tpu_torch/tools/
integration_synthetic.py and integration_continual.py) against the JAX
package's compositions of scripts/integration_synthetic.py and
scripts/integration_continual.py (tests/torch_integration_setup.py), from
one base, at the scripts' tiny model and data, fp32, dropout 0, 1 epoch;
the base cache of tools/flagship.py (a JAX ``.msgpack`` read to the bit);
and every tool's ``main`` on a machine without a card.

Tolerances: accuracies equal (the same predictions, to float rounding),
best H-means to 1e-6, the LoRA group norms (3 decimals, as the report
rounds them) to rtol 5e-3 and one unit of the last decimal (as
tests/test_training_parity.py)."""
import json
import os

import numpy as np
import pytest
import torch

import gslora_tpu.config as jc
import gslora_tpu.engine.continual as jcont
from gslora_tpu.checkpoints.io import save_pytree
from gslora_tpu.data.splits import make_order_list
import gslora_tpu_torch.config as tc
from gslora_tpu_torch.models.convert import flatten_tree, params_from_jax
from gslora_tpu_torch.models.vit import init_vit_params
from gslora_tpu_torch.tools import flagship
from gslora_tpu_torch.tools import integration_baselines as B
from gslora_tpu_torch.tools import integration_baselines_cl as CL
from gslora_tpu_torch.tools import integration_continual as C
from gslora_tpu_torch.tools import integration_synthetic as S

from torch_baselines_setup import one_torch_thread
from torch_integration_setup import (assert_close, jax_accuracy,
                                     jax_synthetic, jax_tree, patch_reinit,
                                     stand_in, tiny_model, trained_base)

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)

NOISE = 2.4  # the unsaturated stand-in


@pytest.fixture(scope="module")
def setup():
    return {"base": trained_base("Softmax", NOISE),
            "jax": stand_in("jax", NOISE), "torch": stand_in("torch", NOISE)}


@pytest.fixture
def clean_dirs(tmp_path, monkeypatch):
    """An empty working directory and a temporary directory of the test's
    own; returns both."""
    work, temp = tmp_path / "work", tmp_path / "temp"
    work.mkdir()
    temp.mkdir()
    monkeypatch.chdir(work)
    monkeypatch.setattr("tempfile.tempdir", str(temp))
    return work, temp


def test_synthetic_matches_jax(setup, clean_dirs):
    """The full recipe (alpha warm-up, prototypes, EMA; 1 epoch at batch
    48): the report as the JAX composition's, the LoRA group norms too,
    written to the temporary directory's integration_report_unsat.json
    and nowhere else."""
    work, temp = clean_dirs
    want = jax_synthetic(jax_tree(setup["base"]), *setup["jax"],
                         tiny_model(jc), True, 48, 1)
    report = S.run(params_from_jax(setup["base"]), *setup["torch"],
                   tiny_model(tc), unsaturated=True, device="cpu", epochs=1,
                   bs=48, compute_dtype="float32")
    assert set(report) == {*want, "wallclock_s", "device"}
    assert report["device"] == "cpu"
    assert (report["head"], report["noise"]) == ("Softmax", 2.4)
    for key in ("pretrain_test_acc", "forget_acc_before", "forget_acc_after",
                "remain_acc_after"):
        assert_close(report[key], want[key], key)
    assert_close(report["best_H_mean"], want["best_H_mean"], "best_H_mean")
    assert len(report["norm_list"]) == len(want["norm_list"]) > 0
    np.testing.assert_allclose(report["norm_list"],
                               [round(n, 3) for n in want["norm_list"]],
                               rtol=5e-3, atol=1e-3)
    assert want["pretrain_test_acc"] > 10.0  # a base with something to forget
    assert os.listdir(work) == []
    assert json.loads((temp / "integration_report_unsat.json").read_text()) \
        == json.loads(json.dumps(report))
    assert S.default_out(False) == str(temp / "integration_report.json")


def test_continual_matches_jax(setup, clean_dirs, monkeypatch):
    """scripts/integration_continual.py:92-145 (--unsaturated, 2 of its
    4 tasks, 1 epoch): every task's report as the JAX run's; the report
    goes to --out."""
    work, temp = clean_dirs
    patch_reinit(monkeypatch)
    model = tiny_model(jc)
    params = jax_tree(setup["base"])
    acc = jax_accuracy(params, setup["jax"][1], model, 250, False)
    fcfg = jc.ForgetConfig(  # :98-106
        num_of_first_cls=80, per_forget_cls=20, num_tasks=2, bnd=10.0,
        cl_beta_list=(0.3, 0.4, 0.28, 0.2), alpha=1e-4, alpha_epoch=0,
        prototype=True, bnd_pro=50.0,
        cl_prof_list=(0.015, 0.06, 0.025, 0.012), pro_r_weight=0.0,
        data_ratio=0.4)
    cfg = jc.RunConfig(  # :109-114
        model=model, lora=jc.LoraConfig(rank=8),
        optim=jc.OptimConfig(lr=1e-2, warmup_epochs=0, epochs=1),
        forget=fcfg, data=jc.DataConfig(batch_size=48), num_epoch=1,
        ver_freq=10_000, compute_dtype="float32", lora_apply="merged",
        fused_batch=True)
    jout = jcont.run_continual_forgetting(cfg, params, *setup["jax"],
                                          make_order_list(100, seed=1337))
    out = temp / "mine.json"
    report = C.run(params_from_jax(setup["base"]), *setup["torch"],
                   tiny_model(tc), unsaturated=True, num_tasks=2,
                   device="cpu", epochs=1, compute_dtype="float32",
                   out=str(out))
    assert json.loads(out.read_text()) == json.loads(json.dumps(report))
    # the JAX script's keys and the port's base_change
    assert set(report) == {"pretrain_test_acc", "head", "noise", "boundary",
                           "few_shot", "device", "tasks", "wallclock_s",
                           "base_change"}
    assert_close(report["pretrain_test_acc"], acc, "pretrain")
    assert [t["task"] for t in report["tasks"]] == [0, 1]
    for got, t in zip(report["tasks"], jout.tasks):
        for key, want in (("forget_before", t.result.forget_acc_before),
                          ("forget_after", t.result.forget_acc),
                          ("remain_after", t.result.remain_acc),
                          ("old_acc_before", t.old_acc_before),
                          ("old_acc", t.old_acc)):
            if want is None:
                assert got[key] is None and t.task == 0, (t.task, key)
            else:
                assert_close(got[key], want, (t.task, key))
        assert_close(got["best_H"], t.result.best_h, t.task)
    assert os.listdir(work) == []
    assert C.default_out(True, "keep", True) == str(
        temp / "integration_cl_report_unsat_keep_fs.json")


def test_msgpack_base_loads_to_the_bit(setup, tmp_path, monkeypatch):
    """A base the JAX package wrote (checkpoints/io.save_pytree) at
    $PRETRAIN_CKPT with the CL script's suffixes: read to the bit, and
    integration_baselines_cl's main from it gives the report that run()
    gives from the tree passed in directly."""
    monkeypatch.setenv("PRETRAIN_CKPT",
                       str(tmp_path / "flagship_pretrained.msgpack"))
    path = flagship.checkpoint_path(unsaturated=True, tiny=True)
    assert path == str(tmp_path / "flagship_pretrained_unsat_tiny.msgpack")
    save_pytree(path, jax_tree(setup["base"]))
    model = flagship.model_config(unsaturated=True, tiny=True)
    assert model == tiny_model(tc)
    train, test = flagship.stand_in(model, flagship.noise(True))
    loaded = flagship.pretrained_base(model, train, 1, "cpu", path)
    want = flatten_tree(setup["base"])
    got = flatten_tree(loaded)
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].dtype == torch.float32, name
        np.testing.assert_array_equal(got[name].numpy(), w, err_msg=name)

    argv = ["--tiny", "--methods", "lwf", "--num_tasks", "1", "--device",
            "cpu"]
    from_file = CL.main(argv + ["--out", str(tmp_path / "a.json")])
    direct = CL.run(["lwf"], params_from_jax(setup["base"]), train, test,
                    model, CL.TINY_BS, "cpu", 1,
                    out=str(tmp_path / "b.json"))
    for report in (from_file, direct):
        report.pop("total_wallclock_s")
        report["lwf"].pop("wallclock_s")
    assert json.loads(json.dumps(from_file)) == json.loads(json.dumps(direct))


def test_missing_base_is_pretrained_and_cached(tmp_path):
    """With no file at $PRETRAIN_CKPT the scripts' recipe pretrains the
    base (1 epoch here) and saves it as a port .pth, beside a .msgpack
    path too; the next call loads it."""
    model = flagship.model_config(unsaturated=True, tiny=True)
    train, _ = flagship.stand_in(model, flagship.noise(True))
    path = str(tmp_path / "base_unsat.msgpack")
    made = flagship.pretrained_base(model, train, 1, "cpu", path)
    assert not os.path.exists(path)
    assert os.listdir(tmp_path) == ["base_unsat.pth"]
    again = flagship.pretrained_base(model, train, 1, "cpu", path)
    for name, t in flatten_tree(made).items():
        assert torch.equal(flatten_tree(again)[name], t), name
    fresh = flatten_tree(init_vit_params(torch.Generator().manual_seed(0),
                                         model, flagship.LORA))
    assert any(not torch.equal(fresh[n], t)
               for n, t in flatten_tree(made).items() if n.startswith("base"))


@pytest.mark.parametrize("tool", [S, B, CL, C],
                         ids=["synthetic", "baselines", "baselines_cl",
                              "continual"])
def test_main_defaults_to_the_card(monkeypatch, tool, clean_dirs):
    """Without --device every tool runs on the card, and raises before it
    builds anything where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device 'cuda' requested but no "
                       "CUDA GPU"):
        tool.main([])
    work, temp = clean_dirs
    assert os.listdir(work) == [] and os.listdir(temp) == []
