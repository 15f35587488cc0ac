"""The pretrain CLI on the port's ``(data, model)`` mesh against the JAX
CLI's one-device run (the JAX suite shows its mesh runs equal that one,
tests/test_mesh_pretrain.py:57-70) and the port's one-process run, with
four gloo ranks on the CPU: 2 x 2 tp, 2 x 2 tp + fsdp with --remat (the
layers gather their fsdp shards again in the recompute), and 2 x 2 tp
with dropout. Also the layout itself against JAX's ``param_shardings`` on
an 8-device CPU mesh: every leaf's shard on every device, and the
divisibility errors.
"""
import jax
import numpy as np
import pytest
import torch

import torch_dp_worker as dpw
import torch_mesh_setup as setup
from gslora_tpu_torch.models.convert import flatten_tree
from gslora_tpu_torch.parallel import sharding
from gslora_tpu_torch.parallel.mesh import DataMesh

WORLD4 = ["pretrain_tp", "pretrain_tp_fsdp", "pretrain_tp_dropout"]
PARITY = ["pretrain_tp", "pretrain_tp_fsdp"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_pretrain")
    mp = pytest.MonkeyPatch()
    try:
        init = setup.init_tree()
        setup.save_tree(init, out / "init.npz")
        wait = setup.start_ranks(out, WORLD4, 4)
        one, jax_ref = setup.references(PARITY, {"init": init}, mp)
        ranks = wait()
    finally:
        mp.undo()
    return {"ranks": ranks, "one": one, "jax": jax_ref, "init": init,
            "out": out}


def _ranks(runs, name):
    return [r[name] for r in runs["ranks"]]


@pytest.mark.parametrize("name", PARITY)
def test_mesh_pretrain_equals_the_jax_one_device_run(runs, name):
    want = runs["jax"][name]
    for r, got in enumerate(_ranks(runs, name)):
        setup.assert_params(got["params"], want["params"], what=f"rank {r}")
        setup.assert_reports(got["report"], want["report"])


@pytest.mark.parametrize("name", PARITY)
def test_mesh_pretrain_equals_the_port_one_process_run(runs, name):
    ranks = _ranks(runs, name)
    for rank in ranks[1:]:
        for k, v in ranks[0]["params"].items():
            np.testing.assert_array_equal(rank["params"][k], v, err_msg=k)
    setup.assert_params(ranks[0]["params"], runs["one"][name]["params"])
    setup.assert_reports(ranks[0]["report"], runs["one"][name]["report"])
    assert ranks[0]["report"]["final_test_acc"] > 30


@pytest.mark.parametrize("name", WORLD4)
def test_shards_and_moments_follow_the_jax_layout(runs, name):
    """Each rank's parameters are its slice of the whole tree by JAX's
    rules, and its Adam moments have the shards' shapes (the ZeRO claim of
    tests/test_mesh_loop.py:313-316: fc1 and fc2 cut four ways under
    tp + fsdp, qkv and attn_out two)."""
    layout = setup.layout_of(name)
    for r, rank in enumerate(_ranks(runs, name)):
        for k, v in rank["shards"].items():
            want = setup.expected_shard(rank["params"][k], k, r, *layout)
            np.testing.assert_array_equal(v, want, err_msg=k)
        assert rank["moments"] == {k: v.shape
                                   for k, v in rank["shards"].items()}
    if layout[3]:  # tp + fsdp: a quarter of fc1 and fc2 on each rank
        shards = _ranks(runs, name)[0]["shards"]
        whole = _ranks(runs, name)[0]["params"]
        for k in ("base.blocks.fc1.kernel", "base.blocks.fc2.kernel"):
            assert shards[k].size * 4 == whole[k].size
        for k in ("base.blocks.qkv.kernel", "base.blocks.attn_out.kernel"):
            assert shards[k].size * 2 == whole[k].size


@pytest.mark.parametrize("name", WORLD4)
def test_train_state_round_trips_under_the_mesh(runs, name):
    """save_train_state gathers the shards whole (rank 0 writes, under one
    process's names and shapes) and restore_train_state gives each rank
    its shards of parameters and moments back to the bit."""
    assert all(rank["restored"] for rank in _ranks(runs, name))
    snap = torch.load(runs["out"] / f"{name}.state.pt", weights_only=True)
    whole = _ranks(runs, name)[0]["params"]
    assert set(snap["params"]) == set(whole)
    for k, v in snap["params"].items():
        np.testing.assert_array_equal(v.numpy(), whole[k], err_msg=k)
    assert [tuple(t.shape) for t in snap["opt_state"]["mu"]] == \
        [whole[k].shape for k in _ranks(runs, name)[0]["moments"]]


def test_dropout_keeps_the_model_ranks_equal(runs):
    """Dropout 0.1 under 2 x 2 tp, every parameter training: the leaves
    held whole (LayerNorms, attention, embeddings, fc2's bias) end equal
    to the bit across the ranks of a model group and across the data
    ranks; the sharded ones differ across the model ranks."""
    shards = [r["shards"] for r in _ranks(runs, "pretrain_tp_dropout")]
    split = [k for k, v in shards[0].items()
             if v.shape != _ranks(runs, "pretrain_tp_dropout")[0][
                 "params"][k].shape]
    assert sorted(split) == ["base.blocks.fc1.bias",
                             "base.blocks.fc1.kernel",
                             "base.blocks.fc2.kernel", "base.head.weight",
                             "lora.ffn.A2", "lora.ffn.B1"]
    for k, v in shards[0].items():
        if k in split:
            assert not np.array_equal(shards[1][k], v), k
            continue
        for r in (1, 2, 3):
            np.testing.assert_array_equal(shards[r][k], v, err_msg=k)
    init = flatten_tree(runs["init"])
    assert not np.allclose(shards[0]["base.blocks.attn_ln.scale"],
                           init["base.blocks.attn_ln.scale"])


# ---------------------------------------------------------------------------
# the layout against JAX's param_shardings
# ---------------------------------------------------------------------------

def _trees(model_kw=None):
    import gslora_tpu.config as jc
    from gslora_tpu.models.vit import init_vit_params
    model = jc.ViTConfig(**{**dpw.MODEL, **(model_kw or {})})
    return jax.tree.map(np.asarray, init_vit_params(
        jax.random.key(0), model, jc.LoraConfig(rank=4)))


@pytest.mark.parametrize("shape,tp,fsdp", [
    ((4, 2), True, False), ((8, 1), False, True), ((4, 2), True, True),
    ((2, 4), True, True), ((1, 8), False, False), ((2, 4), False, True),
], ids=["tp4x2", "fsdp8", "tp_fsdp4x2", "tp_fsdp2x4", "model8", "fsdp2x4"])
def test_every_shard_equals_jax_param_shardings(shape, tp, fsdp):
    """For every leaf of the tree and every device of an 8-device mesh,
    the port's shard (rank r = device r, at ``(r // M, r % M)``) equals the
    shard JAX's NamedSharding puts on that device."""
    import gslora_tpu.config as jc
    from gslora_tpu.parallel.mesh import make_mesh, param_shardings
    d, m = shape
    params = _trees({"num_class": 8})
    jmesh = make_mesh(jc.MeshConfig(data=d, model=m))
    shs = param_shardings(jmesh, params, tp=tp, fsdp=fsdp)
    flat, flat_sh = flatten_tree(params), flatten_tree(shs)
    for r in range(8):
        mesh = DataMesh(rank=r, world=8, device=torch.device("cpu"),
                        model=m, tp=tp, fsdp=fsdp)
        mine = flatten_tree(sharding.shard_tree(
            mesh, jax.tree.map(lambda a: torch.from_numpy(a.copy()),
                               params)))
        for k, whole in flat.items():
            arr = jax.device_put(whole, flat_sh[k])
            (want,) = [s.data for s in arr.addressable_shards
                       if s.device.id == jmesh.devices.flat[r].id]
            np.testing.assert_array_equal(mine[k].numpy(),
                                          np.asarray(want), err_msg=k)


@pytest.mark.parametrize("shape,tp,fsdp,model_kw", [
    ((1, 8), True, False, {"mlp_dim": 60}),
    ((2, 4), False, False, {"num_class": 6}),
    ((8, 1), False, True, {"dim": 36, "dim_head": 18}),
], ids=["tp_hidden", "head_classes", "fsdp_dim"])
def test_divisibility_errors_equal_jax(shape, tp, fsdp, model_kw):
    import gslora_tpu.config as jc
    from gslora_tpu.parallel.mesh import make_mesh, param_shardings
    d, m = shape
    params = _trees(model_kw)
    with pytest.raises(ValueError) as jerr:
        param_shardings(make_mesh(jc.MeshConfig(data=d, model=m)), params,
                        tp=tp, fsdp=fsdp)
    mesh = DataMesh(rank=0, world=8, device=torch.device("cpu"), model=m,
                    tp=tp, fsdp=fsdp)
    with pytest.raises(ValueError) as terr:
        sharding.shard_tree(mesh, jax.tree.map(
            lambda a: torch.from_numpy(a.copy()), params))
    assert str(terr.value) == str(jerr.value)


def test_whole_shape_inverts_the_shard():
    mesh = DataMesh(rank=3, world=8, device=torch.device("cpu"), model=2,
                    tp=True, fsdp=True)
    params = jax.tree.map(lambda a: torch.from_numpy(a.copy()), _trees())
    local = sharding.shard_tree(mesh, params)
    for (k, whole), shard in zip(flatten_tree(params).items(),
                                 flatten_tree(local).values()):
        assert sharding.whole_shape(mesh, k.split("."), shard.shape) == \
            tuple(whole.shape), k


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_reinit_draws_whole_and_keeps_the_shard(rank):
    """The continual boundary's LoRA reinit under 2 x 2 tp: each rank's
    A2 shard is its slice of one process's whole draw from the same
    generator state (the stream stays one process's), A1 whole, the B
    factors zero."""
    from gslora_tpu_torch.config import LoraConfig, ViTConfig
    from gslora_tpu_torch.lora.core import init_lora, reinit_lora
    from gslora_tpu_torch.parallel.mesh import set_active
    model = ViTConfig(**dpw.MODEL)
    whole = init_lora(torch.Generator().manual_seed(0), model,
                      LoraConfig(rank=4))
    want = reinit_lora(torch.Generator().manual_seed(5), whole)
    mesh = DataMesh(rank=rank, world=4, device=torch.device("cpu"),
                    model=2, tp=True)
    local = sharding.shard_tree(mesh, {"lora": whole})["lora"]
    assert local["ffn"]["A2"].shape[2] * 2 == whole["ffn"]["A2"].shape[2]
    try:
        set_active(mesh)
        got = reinit_lora(torch.Generator().manual_seed(5), local)
    finally:
        set_active(None)
    shard = sharding.shard_tree(mesh, {"lora": want})["lora"]
    for k, v in shard["ffn"].items():
        assert torch.equal(got["ffn"][k], v), k
    assert float(got["ffn"]["A2"].abs().max()) > 0
