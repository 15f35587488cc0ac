"""Sequence parallelism (``--sp``, gslora_tpu_torch/parallel/sharding's
token shard and models/vit's sp branch) in the forget, continual and
pretrain CLIs, with gloo ranks on the CPU, against the JAX CLI's
one-device run (the JAX suite shows its sp runs equal that one,
tests/test_mesh_loop.py:528-560 and tests/test_mesh_pretrain.py:57-70)
and the port's one-process run:

* forget 1 x 2 with sp alone and 2 x 2 with tp + sp: the 5 tokens (16 px
  / patch 8 + CLS) split 3 and 2 over ``model``;
* the continual, 1 x 2 sp with the prox step (K2's plain version on the
  whole LoRA on every rank) and EMA over two tasks;
* pretrain 2 x 2 with tp + fsdp + sp, every parameter training;
* JAX's guard messages word for word.

The ranks are spawned once for the module (4 ranks and 2 together),
fresh interpreters (tests/torch_mesh_worker.py); the references run while
the ranks do.
"""
import numpy as np
import pytest
import torch

import torch_mesh_setup as setup
import torch_mesh_worker as mw
from gslora_tpu_torch.config import MeshConfig
from gslora_tpu_torch.parallel import mesh as tmesh

WORLD4 = ["forget_tp_sp", "pretrain_tp_fsdp_sp"]
WORLD2 = ["forget_sp", "continual_sp"]
PARITY = WORLD4 + WORLD2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_sp")
    mp = pytest.MonkeyPatch()
    try:
        init = setup.init_tree()
        pre = setup.pretrained_tree(init, mp)
        setup.save_tree(init, out / "init.npz")
        setup.save_tree(pre, out / "pretrained.npz")
        wait4 = setup.start_ranks(out, WORLD4, 4)
        wait2 = setup.start_ranks(out, WORLD2, 2)
        one, jax_ref = setup.references(PARITY, {"init": init,
                                                 "pretrained": pre}, mp)
        ranks = {4: wait4(), 2: wait2()}
    finally:
        mp.undo()
    return {"ranks": ranks, "one": one, "jax": jax_ref, "out": out}


def _ranks(runs, name):
    return [r[name] for r in runs["ranks"][mw.SCENARIOS[name][5]]]


@pytest.mark.parametrize("name", PARITY)
def test_sp_equals_the_jax_one_device_run(runs, name):
    """Final parameters (gathered whole) to rtol 1e-4 / atol 1e-5, every
    eval's accuracies and H, the report's to 1e-3, on every rank."""
    want = runs["jax"][name]
    for r, got in enumerate(_ranks(runs, name)):
        setup.assert_params(got["params"], want["params"], what=f"rank {r}")
        setup.assert_history(got["history"], want["history"])
        setup.assert_reports(got["report"], want["report"])


@pytest.mark.parametrize("name", PARITY)
def test_sp_equals_the_port_one_process_run(runs, name):
    """One set of parameters on every rank, to the bit, and the one
    process's to the JAX suite's tolerance."""
    ranks = _ranks(runs, name)
    for rank in ranks[1:]:
        for k, v in ranks[0]["params"].items():
            np.testing.assert_array_equal(rank["params"][k], v, err_msg=k)
    want = runs["one"][name]
    setup.assert_params(ranks[0]["params"], want["params"])
    setup.assert_history(ranks[0]["history"], want["history"])
    setup.assert_reports(ranks[0]["report"], want["report"])


@pytest.mark.parametrize("name", PARITY)
def test_sp_keeps_the_jax_layout(runs, name):
    """sp changes no layout: each rank holds its slice of the whole tree
    by the rules of its other flags (the head by class over ``model``; tp
    and fsdp as without sp); the LoRA stays whole without tp."""
    layout = setup.layout_of(name)
    for r, rank in enumerate(_ranks(runs, name)):
        assert set(rank["shards"]) == set(rank["params"])
        for k, v in rank["shards"].items():
            want = setup.expected_shard(rank["params"][k], k, r, *layout)
            np.testing.assert_array_equal(v, want, err_msg=k)
        if not layout[2]:
            for k in ("lora.ffn.A1", "lora.ffn.B1", "lora.ffn.A2",
                      "lora.ffn.B2"):
                if k in rank["shards"]:
                    assert rank["shards"][k].shape == rank["params"][k].shape


def test_sp_runs_move(runs):
    """The comparisons see real change: the LoRA moves in every GS-LoRA
    run, forgetting drops the forget accuracy with a positive H, and the
    pretrain learns."""
    init = setup.init_tree()["lora"]["ffn"]
    for name in ("forget_sp", "forget_tp_sp", "continual_sp"):
        got = _ranks(runs, name)[0]["params"]
        assert not np.allclose(got["lora.ffn.B1"], init["B1"]), name
    for name in ("forget_sp", "forget_tp_sp"):
        report = _ranks(runs, name)[0]["report"]
        assert report["forget_acc_before"] > report["forget_acc"], name
        assert report["best_H_mean"] > 0, name
    assert _ranks(runs, "pretrain_tp_fsdp_sp")[0]["report"][
        "final_test_acc"] > 30


def test_sp_train_state_round_trips(runs):
    """save_train_state under tp + fsdp + sp gathers the shards whole
    (rank 0 writes) and restore_train_state gives each rank its shards of
    the parameters and moments back to the bit."""
    name = "pretrain_tp_fsdp_sp"
    assert all(rank["restored"] for rank in _ranks(runs, name))
    snap = torch.load(runs["out"] / f"{name}.state.pt", weights_only=True)
    whole = _ranks(runs, name)[0]["params"]
    for k, v in snap["params"].items():
        np.testing.assert_array_equal(v.numpy(), whole[k], err_msg=k)


@pytest.mark.parametrize("mesh_kw,flags", [
    ({"data": 4, "model": 2}, {"sp": True, "pp": True}),
    ({"data": 4, "model": 2}, {"sp": True, "pp": True, "tp": True}),
    ({"data": 8, "model": 1}, {"sp": True}),
    (None, {"sp": True}),
], ids=["sp_pp", "sp_pp_tp", "model1", "no_mesh"])
def test_sp_guards_equal_jax(mesh_kw, flags):
    """sp with pp, sp on a model axis of 1 and sp without a mesh raise
    JAX placement()'s ValueError, word for word (tests/test_mesh_loop.py:
    563-575)."""
    import gslora_tpu.config as jc
    from gslora_tpu.parallel.mesh import make_mesh, placement
    try:
        with pytest.raises(ValueError) as jerr:
            placement(None if mesh_kw is None else
                      make_mesh(jc.MeshConfig(**mesh_kw)), **flags)
    finally:
        placement(None)
    mesh = None if mesh_kw is None else tmesh.DataMesh(
        rank=0, world=8, device=torch.device("cpu"))
    with pytest.raises(ValueError) as terr:
        tmesh.check_placement(MeshConfig(**(mesh_kw or {}), **flags), mesh)
    assert str(terr.value) == str(jerr.value)
