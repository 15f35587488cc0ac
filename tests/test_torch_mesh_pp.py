"""GPipe pipeline parallelism (``--pp``, gslora_tpu_torch/parallel/
pipeline.py) in the forget, continual and pretrain CLIs, with gloo ranks
on the CPU, against the JAX CLI's one-device run (the JAX suite shows its
pp runs equal that one, tests/test_mesh_loop.py:349-466 and
tests/test_mesh_pretrain.py:57-70) and the port's one-process run:

* forget 1 x 2 at depth 2 in 2 micro-batches, and 2 x 2 at depth 4;
* the continual 1 x 2 in the loss mode (JAX refuses the prox under pp);
* pretrain 2 x 2, every parameter training, whose rank 0 writes the
  batch-20 checkpoint of the whole depth;
* dropout under pp (finite, the LoRA moves, the ranks agree);
* the pipeline's gradients with ``remat`` equal those without;
* the shift's two routes equal to the bit;
* the layout and JAX's guard messages against JAX's own.

The ranks are spawned once for the module (4 ranks and 2 together),
fresh interpreters (tests/torch_mesh_worker.py); the references run while
the ranks do.
"""
import glob

import jax
import numpy as np
import pytest
import torch

import torch_dp_worker as dpw
import torch_mesh_setup as setup
import torch_mesh_worker as mw
from gslora_tpu_torch.config import MeshConfig
from gslora_tpu_torch.models.convert import flatten_tree
from gslora_tpu_torch.parallel import mesh as tmesh
from gslora_tpu_torch.parallel import sharding
from gslora_tpu_torch.parallel.mesh import DataMesh

WORLD4 = ["forget_pp_depth4", "pretrain_pp"]
WORLD2 = ["forget_pp", "forget_pp_dropout", "continual_pp"]
PARITY = ["forget_pp", "forget_pp_depth4", "continual_pp", "pretrain_pp"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_pp")
    mp = pytest.MonkeyPatch()
    try:
        trees = {"init": setup.init_tree(), "init4": setup.init_tree(4)}
        trees["pretrained"] = setup.pretrained_tree(trees["init"], mp)
        for name, tree in trees.items():
            setup.save_tree(tree, out / f"{name}.npz")
        wait4 = setup.start_ranks(out, WORLD4, 4)
        wait2 = setup.start_ranks(out, WORLD2 + ["pp_remat", "collectives"],
                                  2)
        one, jax_ref = setup.references(PARITY, trees, mp, outdir=out)
        ranks = {4: wait4(), 2: wait2()}
    finally:
        mp.undo()
    return {"ranks": ranks, "one": one, "jax": jax_ref, "out": out}


def _ranks(runs, name):
    return [r[name] for r in runs["ranks"][mw.SCENARIOS[name][5]]]


@pytest.mark.parametrize("name", PARITY)
def test_pp_equals_the_jax_one_device_run(runs, name):
    """Final parameters (gathered whole) to rtol 1e-4 / atol 1e-5, every
    eval's accuracies and H, the report's to 1e-3, on every rank."""
    want = runs["jax"][name]
    for r, got in enumerate(_ranks(runs, name)):
        setup.assert_params(got["params"], want["params"], what=f"rank {r}")
        setup.assert_history(got["history"], want["history"])
        setup.assert_reports(got["report"], want["report"])


@pytest.mark.parametrize("name", PARITY)
def test_pp_equals_the_port_one_process_run(runs, name):
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


@pytest.mark.parametrize("name", PARITY + ["forget_pp_dropout"])
def test_each_stage_holds_its_layers(runs, name):
    """Each rank holds its stage's L/S consecutive layers of every block
    and LoRA leaf, the rest whole (the head too: not class-split under
    pp), by JAX's rules."""
    layout = setup.layout_of(name)
    for r, rank in enumerate(_ranks(runs, name)):
        assert set(rank["shards"]) == set(rank["params"])
        for k, v in rank["shards"].items():
            want = setup.expected_shard(rank["params"][k], k, r, *layout)
            np.testing.assert_array_equal(v, want, err_msg=k)
            staged = ".blocks." in k or k.startswith("lora.")
            assert (v.shape[0] * 2 == rank["params"][k].shape[0]) == staged


def test_pp_dropout_trains(runs):
    """Dropout 0.1 (and on the embedding) under pp: finite evals, the LoRA
    moved, every rank ends with one set of parameters (each stage draws
    its own masks per micro-batch, so no equivalence with one process:
    tests/test_mesh_loop.py:398-421)."""
    ranks = _ranks(runs, "forget_pp_dropout")
    for h in ranks[0]["history"][0]:
        for k in ("Test forget Accuracy", "Test remain Accuracy", "H_mean"):
            assert np.isfinite(h[k]), (k, h)
    for k, v in ranks[0]["params"].items():
        np.testing.assert_array_equal(ranks[1]["params"][k], v, err_msg=k)
    init = setup.init_tree()["lora"]["ffn"]
    assert not np.allclose(ranks[0]["params"]["lora.ffn.A1"], init["A1"])


def test_pp_remat_grads_equal_the_plain_pipeline(runs):
    """The pipeline's LoRA gradients with every layer rematerialized
    inside its stage equal those without (tests/test_mesh_loop.py:
    424-466: rtol 1e-5 / atol 1e-6), on both ranks; and they are not
    zero."""
    for rank in runs["ranks"][2]:
        got = rank["pp_remat"]
        plain, remat = got["remat=False"], got["remat=True"]
        assert set(plain) == {"ffn.A1", "ffn.B1", "ffn.A2", "ffn.B2"}
        for k, v in plain.items():
            assert v.shape[0] == 4, k  # the whole depth, gathered
            np.testing.assert_allclose(remat[k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        assert float(np.abs(plain["ffn.B1"]).max()) > 0


def test_shift_routes_equal_to_the_bit(runs):
    """The shift over ``model`` (JAX's ppermute to s + 1, and back):
    rank 1 receives rank 0's tensor forward and rank 0 rank 1's backward,
    the ends receive zeros; the all_reduce route (the ranks sharing one
    card) equals the native isend / irecv to the bit."""
    outs = [r["collectives"] for r in runs["ranks"][2]]
    x0, x1 = outs[0]["shift.input"], outs[1]["shift.input"]
    want = {(0, 1): torch.zeros_like(x0), (1, 1): x0,
            (0, -1): x1, (1, -1): torch.zeros_like(x1)}
    for r, o in enumerate(outs):
        for step in (1, -1):
            for which in ("native", "all_reduce"):
                assert torch.equal(o[f"shift.{step}.{which}"],
                                   want[(r, step)]), (r, step, which)


def test_rank0_checkpoint_holds_the_whole_depth(runs):
    """Rank 0's batch-20 checkpoint of the pp pretrain (the stages'
    layers gathered) has one process's names and shapes, and its values
    to rtol 1e-4 / atol 1e-5; only rank 0 wrote."""
    out = runs["out"]

    def load(sub):
        (path,) = glob.glob(str(out / sub / "*_Batch_20_*checkpoint.pth"))
        return torch.load(path, weights_only=True)

    got, want = load("pretrain_pp.out"), load("pretrain_pp.one")
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        np.testing.assert_allclose(got[k].numpy(), v.numpy(),
                                   rtol=setup.RTOL, atol=setup.ATOL,
                                   err_msg=k)
    assert got["base.blocks.qkv.kernel"].shape[0] == 2
    assert all(rank["restored"] for rank in _ranks(runs, "pretrain_pp"))


# ---------------------------------------------------------------------------
# the layout and the guards against JAX's
# ---------------------------------------------------------------------------

def _jax_tree(depth):
    import gslora_tpu.config as jc
    from gslora_tpu.models.vit import init_vit_params
    return jax.tree.map(np.asarray, init_vit_params(
        jax.random.key(0), jc.ViTConfig(**{**dpw.MODEL, "depth": depth}),
        jc.LoraConfig(rank=4)))


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)], ids=["pp4x2", "pp2x4"])
def test_every_stage_shard_equals_jax_param_shardings(shape):
    """For every leaf and every device of an 8-device mesh, the port's
    shard under pp (depth 4) equals the shard JAX's
    ``param_shardings(pp=True)`` puts on that device."""
    import gslora_tpu.config as jc
    from gslora_tpu.parallel.mesh import make_mesh, param_shardings
    d, m = shape
    params = _jax_tree(4)
    jmesh = make_mesh(jc.MeshConfig(data=d, model=m))
    flat = flatten_tree(params)
    flat_sh = flatten_tree(param_shardings(jmesh, params, pp=True))
    for r in range(8):
        mesh = DataMesh(rank=r, world=8, device=torch.device("cpu"),
                        model=m, pp=True)
        mine = flatten_tree(sharding.shard_tree(mesh, jax.tree.map(
            lambda a: torch.from_numpy(a.copy()), params)))
        for k, whole in flat.items():
            arr = jax.device_put(whole, flat_sh[k])
            (want,) = [s.data for s in arr.addressable_shards
                       if s.device.id == jmesh.devices.flat[r].id]
            np.testing.assert_array_equal(mine[k].numpy(),
                                          np.asarray(want), err_msg=k)


def test_pp_depth_divisibility_error_equals_jax():
    """Depth 3 over 2 stages: JAX's param_shardings message, word for
    word, from the port's shard_tree."""
    import gslora_tpu.config as jc
    from gslora_tpu.parallel.mesh import make_mesh, param_shardings
    params = _jax_tree(3)
    with pytest.raises(ValueError) as jerr:
        param_shardings(make_mesh(jc.MeshConfig(data=4, model=2)), params,
                        pp=True)
    mesh = DataMesh(rank=0, world=8, device=torch.device("cpu"), model=2,
                    pp=True)
    with pytest.raises(ValueError) as terr:
        sharding.shard_tree(mesh, jax.tree.map(
            lambda a: torch.from_numpy(a.copy()), params))
    assert str(terr.value) == str(jerr.value)
    assert "not divisible by the model axis (2 stages)" in str(terr.value)


@pytest.mark.parametrize("flags", [{"tp": True}, {"fsdp": True},
                                   {"tp": True, "fsdp": True}],
                         ids=["tp", "fsdp", "tp_fsdp"])
def test_pp_excludes_tp_fsdp_as_jax(flags):
    """pp with tp or fsdp: JAX's param_shardings ValueError, word for
    word, from the port's check_placement (before any process group)."""
    import gslora_tpu.config as jc
    from gslora_tpu.parallel.mesh import make_mesh, param_shardings
    with pytest.raises(ValueError) as jerr:
        param_shardings(make_mesh(jc.MeshConfig(data=4, model=2)),
                        _jax_tree(2), pp=True, **flags)
    with pytest.raises(ValueError) as terr:
        tmesh.check_placement(MeshConfig(data=4, model=2, pp=True, **flags),
                              DataMesh(rank=0, world=8,
                                       device=torch.device("cpu")))
    assert str(terr.value) == str(jerr.value)
