"""The GS-LoRA forget and continual CLIs on the port's ``(data, model)``
mesh (gslora_tpu_torch/parallel: ``--mesh_model``, ``--tp``, ``--fsdp``)
against the JAX CLI's one-device run (the JAX suite shows its mesh runs
equal that one, tests/test_mesh_loop.py:253-347) and the port's
one-process run, with gloo ranks on the CPU:

* forget: 2 x 2 tp factored and merged, 2 x 2 tp + fsdp, 1 x 2 with the
  head's classes over ``model`` (CosFace), 2 x 1 fsdp;
* continual: 2 x 2 fsdp with a model axis, the prox step (K2's plain
  version) and EMA over two tasks;
* dropout under tp: the replicated leaves stay equal across the ranks of
  a model group;
* the all_reduce route of all_gather and reduce_scatter (what the ranks
  sharing one card take) equals the native collectives to the bit.

The ranks are spawned twice for the module (4 ranks, then 2), fresh
interpreters (tests/torch_mesh_worker.py) with a time limit of their own;
the references run while the 4 ranks do.
"""
import numpy as np
import pytest
import torch

import torch_mesh_setup as setup
import torch_mesh_worker as mw

WORLD4 = ["forget_tp", "forget_tp_merged", "forget_tp_fsdp",
          "continual_fsdp_model2", "forget_tp_dropout"]
WORLD2 = ["forget_model2", "forget_fsdp"]
PARITY = [n for n in WORLD4 + WORLD2 if n != "forget_tp_dropout"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_forget")
    mp = pytest.MonkeyPatch()
    try:
        init = setup.init_tree()
        pre = setup.pretrained_tree(init, mp)
        setup.save_tree(pre, out / "pretrained.npz")
        wait4 = setup.start_ranks(out, WORLD4 + ["collectives"], 4)
        one, jax_ref = setup.references(PARITY, {"pretrained": pre}, mp)
        ranks = {4: wait4()}
        ranks[2] = setup.start_ranks(out, WORLD2 + ["collectives"], 2)()
    finally:
        mp.undo()
    return {"ranks": ranks, "one": one, "jax": jax_ref}


def _ranks(runs, name):
    return [r[name] for r in runs["ranks"][mw.SCENARIOS[name][5]]]


@pytest.mark.parametrize("name", PARITY)
def test_mesh_equals_the_jax_one_device_run(runs, name):
    """Final parameters (gathered whole) to rtol 1e-4 / atol 1e-5, every
    eval's accuracies and H, the report's to 1e-3, on every rank."""
    want = runs["jax"][name]
    for r, got in enumerate(_ranks(runs, name)):
        setup.assert_params(got["params"], want["params"], what=f"rank {r}")
        setup.assert_history(got["history"], want["history"])
        setup.assert_reports(got["report"], want["report"])


@pytest.mark.parametrize("name", PARITY)
def test_mesh_equals_the_port_one_process_run(runs, name):
    ranks = _ranks(runs, name)
    for r, rank in enumerate(ranks[1:], 1):
        for k, v in ranks[0]["params"].items():
            # one set of parameters on every rank, to the bit
            np.testing.assert_array_equal(rank["params"][k], v, err_msg=k)
    want = runs["one"][name]
    setup.assert_params(ranks[0]["params"], want["params"])
    setup.assert_history(ranks[0]["history"], want["history"])
    setup.assert_reports(ranks[0]["report"], want["report"])


@pytest.mark.parametrize("name", PARITY + ["forget_tp_dropout"])
def test_each_rank_holds_its_jax_shard(runs, name):
    """Each rank's leaves are its slice of the whole tree by JAX's rules:
    fc1 and fc2 by the hidden and the head by class over ``model``, the
    block kernels by d over ``data`` (tests/test_torch_mesh_pretrain.py
    holds the rules against JAX's param_shardings itself)."""
    layout = setup.layout_of(name)
    sharded = 0
    for r, rank in enumerate(_ranks(runs, name)):
        assert set(rank["shards"]) == set(rank["params"])
        for k, v in rank["shards"].items():
            want = setup.expected_shard(rank["params"][k], k, r, *layout)
            assert v.shape == want.shape, (r, k, v.shape, want.shape)
            np.testing.assert_array_equal(v, want, err_msg=k)
            sharded += v.shape != rank["params"][k].shape
    assert sharded > 0


def test_dropout_keeps_the_model_ranks_equal(runs):
    """With dropout 0.1 under 2 x 2 tp, the leaves every rank of a model
    group holds whole (A1, B2, and the frozen base's replicated leaves)
    are equal to the bit across the model ranks after training, and A1 and
    B2 across the data ranks too (their gradients are summed over
    ``data``); the FFN hidden's shards differ as they should."""
    ranks = _ranks(runs, "forget_tp_dropout")
    shards = [r["shards"] for r in ranks]
    for k, v in shards[0].items():
        if k in ("lora.ffn.B1", "lora.ffn.A2") or k.startswith(
                ("base.blocks.fc1", "base.blocks.fc2.kernel",
                 "base.head.weight")):
            assert not np.array_equal(shards[1][k], v), k
            continue
        np.testing.assert_array_equal(shards[1][k], v, err_msg=k)
        np.testing.assert_array_equal(shards[3][k], shards[2][k], err_msg=k)
    for k in ("lora.ffn.A1", "lora.ffn.B2"):
        np.testing.assert_array_equal(shards[2][k], shards[0][k], err_msg=k)
    # the LoRA moved: the run trained
    init = setup.init_tree()["lora"]["ffn"]["A1"]
    assert not np.allclose(shards[0]["lora.ffn.A1"], init)


def test_the_forget_runs_move(runs):
    """The comparisons above see real change: every run moves the LoRA,
    and on the Softmax base's own head the forget accuracy falls and H is
    positive (the CosFace run scores the forget classes at 0 from the
    start)."""
    init = setup.init_tree()["lora"]["ffn"]
    for name in PARITY:
        got = _ranks(runs, name)[0]["params"]
        assert not np.allclose(got["lora.ffn.B1"], init["B1"]), name
    for name in ("forget_tp", "forget_tp_fsdp", "forget_fsdp"):
        report = _ranks(runs, name)[0]["report"]
        assert report["forget_acc_before"] > report["forget_acc"], name
        assert report["best_H_mean"] > 0, name


@pytest.mark.parametrize("world", [2, 4])
def test_all_reduce_route_equals_the_native_collectives(runs, world):
    """all_gather and reduce_scatter along each dim over each axis (the
    data axis of 2 ranks; both axes of 2 x 2): the all_reduce route,
    forced here on CPU tensors, equals gloo's native collectives to the
    bit, and both equal the concatenation and the sum of the ranks'
    inputs."""
    outs = [r["collectives"] for r in runs["ranks"][world]]
    model = 2 if world == 4 else 1
    for r, o in enumerate(outs):
        assert o["route"] == "native"
        for axis in ("data", "model") if model > 1 else ("data",):
            group = [q for q in range(world)
                     if (q % model == r % model if axis == "data"
                         else q // model == r // model)]
            for dim in (0, 1, 2):
                ins = [outs[q][f"input.{axis}.{dim}"] for q in group]
                total = ins[0].clone()
                for t in ins[1:]:
                    total += t
                mine = total.chunk(len(group), dim=dim)[group.index(r)]
                for which in ("native", "all_reduce"):
                    assert torch.equal(o[f"gather.{axis}.{dim}.{which}"],
                                       torch.cat(ins, dim=dim))
                    assert torch.equal(o[f"scatter.{axis}.{dim}.{which}"],
                                       mine)
