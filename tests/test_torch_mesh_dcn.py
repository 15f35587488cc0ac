"""The whole JAX mesh in the port: the outer ``dcn`` data axis
(``--mesh_slices``) under dp, tp, fsdp, sp and pp, and meshes smaller
than the world, with gloo ranks on the CPU, against the JAX CLI's
one-device run (the JAX suite shows its dcn runs equal that one,
tests/test_mesh_multislice.py:47) and the port's one-process run:

* on a world of 8, JAX's three compositions through the forget CLI:
  ``dcn_dp`` (2 x 4 x 1, also equal to plain ``--dp`` on the same world
  to the bit), ``dcn_tp_fsdp_sp`` and ``dcn_pp`` (2 x 2 x 2); the
  continual with the prox step and fsdp (2 x 4 x 1); the pretrain with
  tp and fsdp (2 x 2 x 2), whose fsdp gradients must cross ``dcn``;
* on a world of 4, ``--mesh_data 2`` and ``--mesh_data 1 --mesh_model 2
  --tp``: ranks 2 and 3 idle, writing nothing, and no collective of the
  run on the default group once the groups are made;
* each rank's place and rows against JAX's ``make_mesh`` and
  ``device_blocks``; the sums over ``dcn`` and the batch axis on
  rank-unique values; the shards against JAX's ``param_shardings`` on a
  dcn mesh; JAX's guards, word for word.

The ranks are spawned once for the module (8 ranks and 4 together),
fresh interpreters (tests/torch_mesh_worker.py); the references run
while the ranks do.
"""
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
from gslora_tpu_torch.parallel import multihost as tmh
from gslora_tpu_torch.parallel import sharding
from gslora_tpu_torch.parallel.mesh import DataMesh

WORLD8 = ["forget_dp8", "forget_dcn_dp", "forget_dcn_tp_fsdp_sp",
          "forget_dcn_pp", "continual_dcn_fsdp", "pretrain_dcn_tp_fsdp"]
WORLD4 = ["forget_subworld", "forget_subworld_tp"]
PARITY = [n for n in WORLD8 + WORLD4 if n != "forget_dp8"]
SHARDED = ["forget_dcn_tp_fsdp_sp", "forget_dcn_pp", "continual_dcn_fsdp",
           "pretrain_dcn_tp_fsdp", "forget_subworld_tp"]
MESHES = {"2x2x2": MeshConfig(data=2, model=2, slices=2),
          "2x4x1": MeshConfig(data=4, model=1, slices=2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_dcn")
    mp = pytest.MonkeyPatch()
    try:
        trees = {"init": setup.init_tree()}
        trees["pretrained"] = setup.pretrained_tree(trees["init"], mp)
        for name, tree in trees.items():
            setup.save_tree(tree, out / f"{name}.npz")
        wait8 = setup.start_ranks(out, ["dcn_sums"] + WORLD8, 8)
        wait4 = setup.start_ranks(out, WORLD4, 4)
        one, jax_ref = setup.references(PARITY, trees, mp)
        ranks = {8: wait8(), 4: wait4()}
    finally:
        mp.undo()
    return {"ranks": ranks, "one": one, "jax": jax_ref, "out": out}


def _used(name):
    """The ranks the scenario's mesh uses."""
    data, model, *_, slices = setup.layout_of(name)
    return slices * data * model


def _ranks(runs, name, idle=False):
    """The scenario's results of the used ranks (``idle``: of the
    others)."""
    got = [r[name] for r in runs["ranks"][mw.SCENARIOS[name][5]]]
    return got[_used(name):] if idle else got[:_used(name)]


@pytest.mark.parametrize("name", PARITY)
def test_dcn_equals_the_jax_one_device_run(runs, name):
    """Final parameters (gathered whole) to rtol 1e-4 / atol 1e-5, every
    eval's accuracies and H, the report's to 1e-3, on every used rank."""
    want = runs["jax"][name]
    for r, got in enumerate(_ranks(runs, name)):
        setup.assert_params(got["params"], want["params"], what=f"rank {r}")
        setup.assert_history(got["history"], want["history"])
        setup.assert_reports(got["report"], want["report"])


@pytest.mark.parametrize("name", PARITY)
def test_dcn_equals_the_port_one_process_run(runs, name):
    """One set of parameters on every used rank, to the bit, and the one
    process's to the JAX suite's tolerance."""
    ranks = _ranks(runs, name)
    for rank in ranks[1:]:
        for k, v in ranks[0]["params"].items():
            np.testing.assert_array_equal(rank["params"][k], v, err_msg=k)
    want = runs["one"][name]
    setup.assert_params(ranks[0]["params"], want["params"])
    setup.assert_history(ranks[0]["history"], want["history"])
    setup.assert_reports(ranks[0]["report"], want["report"])


def test_dcn_dp_equals_plain_dp_to_the_bit(runs):
    """2 x 4 x 1 and plain --dp on the same 8 ranks: the same rows on each
    rank, the same sums over the same ranks, so the same parameters,
    history and report to the bit."""
    for r, (dcn, dp) in enumerate(zip(_ranks(runs, "forget_dcn_dp"),
                                      _ranks(runs, "forget_dp8"))):
        assert set(dcn["params"]) == set(dp["params"])
        for k, v in dp["params"].items():
            np.testing.assert_array_equal(dcn["params"][k], v,
                                          err_msg=f"rank {r} {k}")
        assert dcn["history"] == dp["history"]
        assert dcn["report"] == dp["report"]


@pytest.mark.parametrize("name", SHARDED)
def test_shards_follow_the_jax_layout_within_a_slice(runs, name):
    """Each used rank holds its slice of the whole tree by JAX's rules,
    the same in every slice: fsdp cuts the block kernels by the data axis
    of a slice (D), never by dcn x data; the pretrain's Adam moments have
    the shards' shapes."""
    data, model, tp, fsdp, pp, slices = setup.layout_of(name)
    ranks = _ranks(runs, name)
    for r, rank in enumerate(ranks):
        assert set(rank["shards"]) == set(rank["params"])
        for k, v in rank["shards"].items():
            want = setup.expected_shard(rank["params"][k], k, r, data, model,
                                        tp, fsdp, pp, slices)
            np.testing.assert_array_equal(v, want, err_msg=f"rank {r} {k}")
            if r >= data * model:  # the same shard as in the first slice
                np.testing.assert_array_equal(
                    v, ranks[r % (data * model)]["shards"][k], err_msg=k)
        if "moments" in rank:
            assert rank["moments"] == {k: v.shape
                                       for k, v in rank["shards"].items()}
    if fsdp:
        shards, whole = ranks[0]["shards"], ranks[0]["params"]
        k = "base.blocks.qkv.kernel"
        assert shards[k].size * data == whole[k].size


def test_rank_positions_and_rows_equal_jax(runs):
    """Each rank's (dcn, data, model) indices are device r's position in
    JAX's ``make_mesh(...).devices``, its block is ``device_blocks`` there
    and its rows of a batch of 16 are JAX's ``blocks_to_bounds``, on
    2 x 2 x 2 and 2 x 4 x 1."""
    from gslora_tpu.parallel import mesh as jmesh
    from gslora_tpu.parallel import multihost as jmh
    for tag, cfg in MESHES.items():
        import gslora_tpu.config as jc
        devices = jmesh.make_mesh(jc.MeshConfig(
            data=cfg.data, model=cfg.model, slices=cfg.slices)).devices
        ids = np.vectorize(lambda d: d.id)(devices)
        blocks = jmh.device_blocks(("dcn", "data", "model"), ids.shape)
        by_proc = jmh.process_block_map(("dcn", "data", "model"), ids)
        for r, rank in enumerate(runs["ranks"][8]):
            got = rank["dcn_sums"][tag]
            pos = tuple(int(i) for i in np.argwhere(ids == r)[0])
            assert got["index"] == pos, (tag, r)
            assert got["block"] == blocks[pos], (tag, r)
            assert got["rows"] == jmh.blocks_to_bounds(
                16, cfg.slices * cfg.data, by_proc[r]), (tag, r)


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_sums_cross_the_batch_axis(runs, tag):
    """Rank-unique values 2^r: a replicated leaf's gradient and
    ``mesh.sum`` add the ranks of the rank's model index over dcn x data;
    an fsdp shard's gradient (which the backward already summed over
    ``data``) adds the ranks of its position in the other slices."""
    cfg = MESHES[tag]
    D, M = cfg.data, cfg.model
    for r, rank in enumerate(runs["ranks"][8]):
        got = rank["dcn_sums"][tag]
        batch = sum(2.0 ** q for q in range(8) if q % M == r % M)
        assert got["replicated_grad"] == batch, (tag, r)
        assert got["sum"] == batch, (tag, r)
        fsdp = cfg.model > 1  # the 2 x 2 x 2 mesh shards over data
        assert ("data" in got["specs"][0]) == fsdp
        across = sum(2.0 ** q for q in range(8) if q % (D * M) == r % (D * M))
        assert got["fsdp_grad"] == (across if fsdp else batch), (tag, r)


@pytest.mark.parametrize("name", WORLD4)
def test_idle_ranks_leave_and_write_nothing(runs, name):
    """Ranks 2 and 3 of the world of 4 report nothing and hold no
    parameters; rank 0 alone wrote its outdir (each rank had one of its
    own); every rank exited 0 (the spawn checks it)."""
    out = runs["out"]
    for r, rank in enumerate(_ranks(runs, name, idle=True), _used(name)):
        assert rank["report"] is None and "params" not in rank, r
        assert not (out / f"{name}.out{r}").exists(), r
    assert (out / f"{name}.out0" / "report.json").exists()
    assert not (out / f"{name}.out1").exists()


@pytest.mark.parametrize("name", WORLD4)
def test_no_default_group_collective_once_the_groups_are_made(runs, name):
    """On a mesh smaller than the world every collective of the run goes
    over a group of the used ranks: none on the default group, which
    would wait for the idle ranks that have left."""
    for r, rank in enumerate(runs["ranks"][4]):
        assert rank[name]["default_group_calls"] == [], r


def test_idle_rank_prints_its_line(capsys):
    from gslora_tpu_torch.cli.common import idle_rank
    mesh = DataMesh(rank=3, world=4, device=torch.device("cpu"), data=2)
    assert mesh.idle and mesh.size() == 2
    assert idle_rank(mesh)
    assert capsys.readouterr().out == \
        "rank 3 idle: the mesh uses 2 of 4 ranks\n"
    assert not idle_rank(DataMesh(rank=1, world=4,
                                  device=torch.device("cpu"), data=2))
    assert not idle_rank(None)


# ---------------------------------------------------------------------------
# the layout and the guards against JAX's
# ---------------------------------------------------------------------------

def _jax_tree():
    import gslora_tpu.config as jc
    from gslora_tpu.models.vit import init_vit_params
    return jax.tree.map(np.asarray, init_vit_params(
        jax.random.key(0), jc.ViTConfig(**dpw.MODEL), jc.LoraConfig(rank=4)))


@pytest.mark.parametrize("shape,flags", [
    ((2, 2, 2), {"tp": True, "fsdp": True}),
    ((2, 2, 2), {"pp": True}),
    ((2, 4, 1), {"fsdp": True}),
], ids=["tp_fsdp", "pp", "fsdp"])
def test_every_shard_equals_jax_param_shardings_on_dcn(shape, flags):
    """For every leaf and every device of an 8-device dcn mesh, the
    port's shard (rank r = device r) equals the shard JAX's
    ``param_shardings`` puts on that device."""
    import gslora_tpu.config as jc
    from gslora_tpu.parallel.mesh import make_mesh, param_shardings
    s, d, m = shape
    params = _jax_tree()
    jmesh = make_mesh(jc.MeshConfig(data=d, model=m, slices=s))
    flat = flatten_tree(params)
    flat_sh = flatten_tree(param_shardings(jmesh, params, **flags))
    for r in range(8):
        mesh = DataMesh(rank=r, world=8, device=torch.device("cpu"),
                        model=m, slices=s, data=d, **flags)
        mine = flatten_tree(sharding.shard_tree(mesh, jax.tree.map(
            lambda a: torch.from_numpy(a.copy()), params)))
        for k, whole in flat.items():
            arr = jax.device_put(whole, flat_sh[k])
            (want,) = [sh.data for sh in arr.addressable_shards
                       if sh.device.id == r]
            np.testing.assert_array_equal(mine[k].numpy(),
                                          np.asarray(want), err_msg=k)


def test_batch_guard_equals_jax():
    """Batch 12 on 2 x 4 x 1: JAX's "data-parallel ways" message, word
    for word (dcn x data = 8 ways, not 4)."""
    import gslora_tpu.config as jc
    from gslora_tpu.parallel.mesh import check_batch_divisible, make_mesh
    jmesh = make_mesh(jc.MeshConfig(data=4, slices=2))
    with pytest.raises(ValueError) as jerr:
        check_batch_divisible(jmesh, 12)
    mesh = DataMesh(rank=0, world=8, device=torch.device("cpu"), slices=2)
    with pytest.raises(ValueError) as terr:
        tmesh.check_batch_divisible(mesh, 12)
    assert str(terr.value) == str(jerr.value)
    assert "data-parallel ways (8)" in str(terr.value)
    from gslora_tpu.parallel.mesh import data_parallel_size
    assert tmesh.data_parallel_size(mesh) == data_parallel_size(jmesh) == 8


@pytest.mark.parametrize("kw", [{"data": 4, "model": 2, "slices": 2},
                                {"data": 3, "model": 1, "slices": 3},
                                {"data": 9}],
                         ids=["2x4x2", "3x3x1", "data9"])
def test_oversubscribed_mesh_raises_the_jax_words(kw):
    """A mesh larger than the world: JAX's "does not fit" assertion, word
    for word, as the port's ValueError from check_placement."""
    import gslora_tpu.config as jc
    from gslora_tpu.parallel.mesh import make_mesh
    with pytest.raises(AssertionError) as jerr:
        make_mesh(jc.MeshConfig(**kw))
    with pytest.raises(ValueError) as terr:
        tmesh.check_placement(MeshConfig(**kw), DataMesh(
            rank=0, world=8, device=torch.device("cpu")))
    assert str(terr.value) == str(jerr.value)
    assert "does not fit 8 devices" in str(terr.value)


def test_axis_ranks_follow_the_jax_device_array():
    """Every group of 2 x 2 x 2 holds the ranks JAX's mesh puts on that
    axis: the model groups are rows of the device array, the data and dcn
    groups its other axes, the batch groups a model index's (dcn, data)
    plane."""
    import gslora_tpu.config as jc
    from gslora_tpu.parallel.mesh import make_mesh
    ids = np.vectorize(lambda d: d.id)(make_mesh(jc.MeshConfig(
        data=2, model=2, slices=2)).devices)
    got = tmesh.axis_ranks(2, 2, 2)
    want = {"model": ids.reshape(-1, 2),
            "data": ids.transpose(0, 2, 1).reshape(-1, 2),
            "dcn": ids.transpose(1, 2, 0).reshape(-1, 2),
            "batch": ids.transpose(2, 0, 1).reshape(2, -1),
            "mesh": ids.reshape(1, -1)}
    for axis, lists in want.items():
        assert sorted(map(list, got[axis])) == sorted(lists.tolist()), axis
    assert tmh.rank_owners(DataMesh(rank=0, world=8, device=torch.device(
        "cpu"), model=2, slices=2)).tolist() == ids.tolist()
