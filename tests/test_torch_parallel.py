"""The port's data parallelism (gslora_tpu_torch/parallel, ``--dp`` in the
three training CLIs) against the JAX package: the mesh-flag guards against
``gslora_tpu.parallel.mesh.placement``, the block math against
``gslora_tpu.parallel.multihost``, and two gloo ranks on the CPU running
each CLI with ``--dp`` against the JAX CLI's one-device run (the JAX suite
shows its mesh run equals that one, tests/test_mesh_loop.py) and against
the port's one-process run.

The ranks are spawned once for the module (tests/torch_dp_worker.py, a
fresh interpreter each: never a fork of this JAX-loaded process), with a
time limit of their own so a hung rendezvous fails instead of stalling
the suite."""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dp_worker as worker
from gslora_tpu_torch.config import MeshConfig
from gslora_tpu_torch.parallel import mesh as tmesh
from gslora_tpu_torch.parallel import multihost as tmh
from gslora_tpu_torch.parallel import sharding

ROOT = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 150
# The JAX suite's data-parallel tolerance at fp32 (tests/test_mesh_loop.py
# :79-80): two ranks sum their shares where one device sums the batch,
# which reorders the fp32 sums of the losses and the gradients.
RTOL, ATOL = 1e-4, 1e-5
ACC_TOL = 1e-3
# the scenarios run on the CPU (forget_card is the card test's)
CPU_SCENARIOS = [n for n in worker.SCENARIOS if n != "forget_card"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# the mesh-flag guards, against JAX placement()
# ---------------------------------------------------------------------------

def _jax_outcome(mesh_kw, flags):
    """What JAX's placement() does for ``flags`` on the mesh of
    ``mesh_kw`` (None: no mesh): (exception type, message) or None."""
    import gslora_tpu.config as jc
    from gslora_tpu.parallel.mesh import make_mesh, placement
    try:
        mesh = None if mesh_kw is None else make_mesh(jc.MeshConfig(**mesh_kw))
        placement(mesh, **flags)
        return None
    except (ValueError, AssertionError) as e:
        return type(e), str(e)
    finally:
        placement(None)  # clear JAX's trace-time registries


def _port_outcome(mesh_kw, flags, world=8):
    cfg = MeshConfig(**(mesh_kw or {}), **flags)
    mesh = None if mesh_kw is None else tmesh.DataMesh(
        rank=0, world=world, device=torch.device("cpu"))
    try:
        tmesh.check_placement(cfg, mesh)
        return None
    except ValueError as e:
        return type(e), str(e)


@pytest.mark.parametrize("mesh_kw,flags", [
    (None, {"tp": True}), (None, {"fsdp": True}), (None, {"pp": True}),
    (None, {"sp": True}),
    ({"data": 8, "model": 1}, {"tp": True}),
    ({"data": 8, "model": 1}, {"pp": True}),
    ({"data": 8, "model": 1}, {"sp": True}),
    ({"data": 1, "model": 8}, {"fsdp": True}),
    ({"data": 4, "model": 2}, {"sp": True, "pp": True}),
], ids=["none-tp", "none-fsdp", "none-pp", "none-sp", "data8-tp",
        "data8-pp", "data8-sp", "model8-fsdp", "sp-pp"])
def test_refusals_match_jax_placement(mesh_kw, flags):
    """What JAX refuses, the port refuses with the same type and message
    (the mesh JAX would build over 8 devices, the port's world of 8)."""
    want = _jax_outcome(mesh_kw, flags)
    assert want is not None and want[0] is ValueError
    assert _port_outcome(mesh_kw, flags) == want


def _jax_layout(mesh_kw, flags, tree, baseline):
    """JAX's outcome for ``flags`` on the mesh of ``mesh_kw`` over its 8
    host devices: the baseline runners' pp guard (``baseline``), then
    placement() and param_shardings of ``tree``: (exception type,
    message), or each leaf's mesh axes by dotted name."""
    import jax

    import gslora_tpu.config as jc
    import torch_mesh_setup
    from gslora_tpu.parallel.mesh import make_mesh, param_shardings, \
        placement
    from gslora_tpu_torch.models.convert import flatten_tree
    if baseline and flags.get("pp"):
        return ValueError, torch_mesh_setup.jax_refusal(mesh_kw, flags,
                                                        baseline=True)
    try:
        mesh = make_mesh(jc.MeshConfig(**mesh_kw))
        placement(mesh, **flags)
        shardings = param_shardings(
            mesh, tree, **{k: v for k, v in flags.items()
                           if k in ("tp", "fsdp", "pp")})
    except ValueError as e:
        return ValueError, str(e)
    finally:
        placement(None)
    flat = flatten_tree(jax.tree.map(lambda s: s.spec, shardings,
                                     is_leaf=lambda s: hasattr(s, "spec")))
    leaves = flatten_tree(tree)
    return {k: tuple(spec) + (None,) * (leaves[k].ndim - len(spec))
            for k, spec in flat.items()}


def _port_layout(mesh_kw, flags, tree, baseline):
    """The port's outcome for the same: its guard
    (``check_baseline_placement`` for a baseline, else
    ``check_placement``) on a world of 8, then parallel/sharding's spec of
    each leaf."""
    from gslora_tpu_torch.models.convert import flatten_tree
    cfg = MeshConfig(**mesh_kw, **flags)
    world = tmesh.DataMesh(rank=0, world=8, device=torch.device("cpu"))
    try:
        (tmesh.check_baseline_placement if baseline
         else tmesh.check_placement)(cfg, world)
        shape = tmesh.jax_mesh_shape(cfg, 8)
        mesh = tmesh.DataMesh(rank=0, world=8, device=torch.device("cpu"),
                              model=shape["model"], data=shape["data"],
                              slices=cfg.slices, tp=cfg.tp, fsdp=cfg.fsdp,
                              sp=cfg.sp, pp=cfg.pp)
        return {k: sharding.leaf_spec(mesh, k.split("."), v.shape)
                for k, v in flatten_tree(tree).items()}
    except ValueError as e:
        return ValueError, str(e)


def _layout_tree(what):
    """The tiny model's tree (numpy, JAX's init) for ``what``: a baseline's
    (rank 0, the face ViT), ViT-B/16's structure with a 100-way Softmax
    head and a rank-4 FFN LoRA, or the face ViT with a rank-4 attention
    LoRA."""
    import jax

    import gslora_tpu.config as jc
    from gslora_tpu.models.vit import init_vit_params
    model = dict(worker.MODEL)
    lora = jc.LoraConfig(rank=0 if what == "baseline" else 4,
                         pos="Attention" if what == "Attention" else "FFN")
    if what == "VIT_B16":
        model.update(soft_split=True, ac_patch_size=8, pad=0, qkv_bias=True,
                     attn_scale="dim_head", num_class=100)
    return jax.tree.map(np.asarray, init_vit_params(
        jax.random.key(0), jc.ViTConfig(**model), lora))


@pytest.mark.parametrize("mesh_kw,flags,what", [
    ({"data": 4, "model": 2}, {"tp": True}, "baseline"),
    ({"data": 4, "slices": 2}, {"fsdp": True}, "baseline"),
    ({"data": 1, "model": 2, "slices": 2}, {"sp": True}, "baseline"),
    ({"data": 2, "model": 2}, {}, "baseline"),
    ({"data": 2, "model": 2, "slices": 2}, {"tp": True}, "VIT_B16"),
    ({"data": 4, "model": 2}, {"pp": True}, "VIT_B16"),
    ({"data": 2, "slices": 2}, {"fsdp": True}, "Attention"),
], ids=["baseline_tp", "baseline_slices2_fsdp", "baseline_slices2_sp",
        "baseline_model2", "vit_b16_slices2_tp", "vit_b16_pp",
        "attention_slices2_fsdp"])
def test_unported_layouts_raise_not_implemented(mesh_kw, flags, what):
    """What the port once refused, JAX runs, and so does the port now: a
    baseline under tp, fsdp, sp or a model axis (with or without
    --mesh_slices), ``-n VIT_B16`` and an attention LoRA under a sharded
    layout pass both guards, and every leaf takes JAX's layout
    (param_shardings). ``_jax_layout`` and ``_port_layout`` also hold the
    ValueErrors alike, word for word (test_layout_refusals_match_jax)."""
    tree = _layout_tree(what)
    baseline = what == "baseline"
    want = _jax_layout(mesh_kw, flags, tree, baseline)
    assert not isinstance(want, tuple), want
    assert _port_layout(mesh_kw, flags, tree, baseline) == want


@pytest.mark.parametrize("mesh_kw,flags,what", [
    ({"data": 2, "model": 2}, {"pp": True}, "baseline"),
    ({"data": 2, "model": 3}, {"tp": True}, "VIT_B16"),
    ({"data": 4, "model": 2}, {"tp": True, "pp": True}, "Attention"),
], ids=["baseline_pp", "vit_b16_head_model3", "attention_tp_pp"])
def test_layout_refusals_match_jax(mesh_kw, flags, what):
    """Where JAX refuses, the port raises its ValueError, word for word: a
    baseline under pp (the runners' guard), a 100-way head on a model
    axis of 3 (param_shardings), pp with tp (placement)."""
    tree = _layout_tree(what)
    baseline = what == "baseline"
    want = _jax_layout(mesh_kw, flags, tree, baseline)
    assert want[0] is ValueError
    assert _port_layout(mesh_kw, flags, tree, baseline) == want


@pytest.mark.parametrize("mesh_kw,flags", [
    ({"data": 4, "model": 2}, {"tp": True}),
    ({"data": 8, "model": 1}, {"fsdp": True}),
    ({"data": 4, "model": 2}, {}),
    ({"model": 2}, {"tp": True, "fsdp": True}),
    ({"data": 1, "model": 8}, {"tp": True}),
    ({"data": 4, "model": 2}, {"sp": True}),
    ({"model": 2}, {"tp": True, "fsdp": True, "sp": True}),
    ({"data": 4, "model": 2}, {"pp": True, "pp_micro": 4}),
    ({"data": 1, "model": 8}, {"pp": True}),
    ({"data": 1, "model": 2, "slices": 2}, {"pp": True}),
    ({"data": 1, "model": 2, "slices": 2}, {"tp": True, "sp": True}),
    ({"data": 1, "model": 2}, {"sp": True}),
    ({"data": 2, "model": 2, "slices": 2}, {"tp": True}),
    ({"data": 2, "model": 2}, {}),
    ({"data": 4, "model": 1}, {}),
    ({"data": 4, "model": 1, "slices": 2}, {}),
], ids=["tp", "fsdp", "model2", "tp_fsdp", "model8_tp", "sp",
        "tp_fsdp_sp", "pp", "model8_pp", "slices2_pp", "slices2_tp_sp",
        "data1_model2_sp", "slices2_tp", "data2_model2", "data4",
        "slices2"])
def test_mesh_layouts_pass_the_guards(mesh_kw, flags):
    """--mesh_model, --tp, --fsdp, --sp, --pp, --mesh_slices and their
    compositions run, on the whole world or on a mesh that leaves ranks
    idle, as JAX's placement() accepts them; a baseline runs them all but
    pp, which raises JAX's own ValueError."""
    assert _jax_outcome(mesh_kw, flags) is None
    assert _port_outcome(mesh_kw, flags) is None
    world = tmesh.DataMesh(rank=0, world=8, device=torch.device("cpu"))
    cfg = MeshConfig(**mesh_kw, **flags)
    if flags.get("pp"):
        with pytest.raises(ValueError, match="pp is supported"):
            tmesh.check_baseline_placement(cfg, world)
    else:
        tmesh.check_baseline_placement(cfg, world)


def test_prox_under_tp_raises_the_jax_error():
    """The prox step under tp on a model axis > 1 raises JAX's ValueError
    (gslora_tpu/engine/loop.py:132-141), word for word, from the forget
    loop; under fsdp or a model axis alone it runs."""
    import gslora_tpu.config as jc
    from gslora_tpu.engine.loop import run_forget_training as jax_run
    from gslora_tpu.parallel.mesh import make_mesh, placement

    import gslora_tpu_torch.config as tc
    from gslora_tpu_torch.engine.loop import run_forget_training
    try:
        with pytest.raises(ValueError) as jerr:
            jax_run(jc.RunConfig(mesh=jc.MeshConfig(data=4, model=2,
                                                    tp=True),
                                 structure_mode="prox"), {}, None,
                    mesh=make_mesh(jc.MeshConfig(data=4, model=2)))
    finally:
        placement(None)
    cfg = tc.RunConfig(mesh=MeshConfig(data=4, model=2, tp=True),
                       structure_mode="prox", device="cpu")
    mesh = tmesh.DataMesh(rank=0, world=8, device=torch.device("cpu"),
                          model=2, tp=True)
    try:
        with pytest.raises(ValueError) as terr:
            run_forget_training(cfg, {}, None, mesh=mesh)
        assert str(terr.value) == str(jerr.value)
        for mesh_cfg in (MeshConfig(fsdp=True), MeshConfig(model=2)):
            tmesh.check_prox_placement(
                tc.RunConfig(mesh=mesh_cfg, structure_mode="prox"), mesh)
    finally:
        tmesh.set_active(None)


def test_plain_data_mesh_passes():
    assert _port_outcome({}, {}) is None
    assert _port_outcome({"data": 8}, {}) is None
    assert _port_outcome(None, {}) is None


def test_baseline_runner_guards_match_jax():
    """Each baseline runner checks the mesh flags first, as JAX's do:
    --pp with its own message, then placement() without a mesh."""
    import gslora_tpu.config as jc
    from gslora_tpu.baselines.regularization import \
        run_regularization_task as jax_run

    import gslora_tpu_torch.config as tc
    from gslora_tpu_torch.baselines.regularization import \
        run_regularization_task as port_run
    for flags in ({"pp": True}, {"tp": True}, {"fsdp": True}):
        errs = []
        for C, run in ((jc, jax_run), (tc, port_run)):
            cfg = C.RunConfig(mesh=C.MeshConfig(**flags))
            with pytest.raises(ValueError) as err:
                run(cfg, {}, None, None, None, lam=0.0, anchors=[],
                    importances=[])
            errs.append(str(err.value))
        assert errs[0] == errs[1], flags


def test_baseline_placement_under_a_world(monkeypatch):
    """A baseline runs plain --dp, --fsdp, --tp and a model axis under a
    world of 2, as JAX's runners do; --pp raises the ValueError of JAX's
    baseline runners, through the guard itself and through make_mesh's
    check before any process group is made."""
    import gslora_tpu.config as jc
    from gslora_tpu.baselines.regularization import \
        run_regularization_task as jax_run
    with pytest.raises(ValueError) as jerr:
        jax_run(jc.RunConfig(mesh=jc.MeshConfig(pp=True)), {}, None, None,
                None, lam=0.0, anchors=[], importances=[])
    world = tmesh.DataMesh(rank=0, world=2, device=torch.device("cpu"))
    for cfg in (MeshConfig(), MeshConfig(fsdp=True),
                MeshConfig(tp=True, model=2), MeshConfig(model=2),
                MeshConfig(sp=True, model=2)):
        tmesh.check_baseline_placement(cfg, world)
    for mesh_kw in ({}, {"model": 2}):
        with pytest.raises(ValueError) as err:
            tmesh.check_baseline_placement(MeshConfig(pp=True, **mesh_kw),
                                           world)
        assert str(err.value) == str(jerr.value)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError) as err:
        tmesh.make_mesh(MeshConfig(pp=True, model=2), "cpu",
                        check=tmesh.check_baseline_placement)
    assert str(err.value) == str(jerr.value)


def test_dp_on_one_process_makes_no_mesh(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert tmesh.make_mesh(MeshConfig(), "cpu", dp=True) is None
    with pytest.raises(ValueError, match="need a device mesh"):
        tmesh.make_mesh(MeshConfig(tp=True), "cpu", dp=True)


def test_check_batch_divisible_matches_jax():
    import gslora_tpu.config as jc
    from gslora_tpu.parallel.mesh import check_batch_divisible, make_mesh
    with pytest.raises(ValueError) as jerr:
        check_batch_divisible(make_mesh(jc.MeshConfig(data=8)), 12)
    with pytest.raises(ValueError) as terr:
        tmesh.check_batch_divisible(
            tmesh.DataMesh(0, 8, torch.device("cpu")), 12)
    assert str(terr.value) == str(jerr.value)
    tmesh.check_batch_divisible(None, 7)


# ---------------------------------------------------------------------------
# block math and process-sharded feeding, against JAX multihost
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis_names,shape", [
    (("data", "model"), (4, 2)), (("data", "model"), (8, 1)),
    (("dcn", "data", "model"), (2, 2, 2)),
    (("dcn", "data", "model"), (2, 4, 1)),
])
def test_block_maps_match_jax(axis_names, shape):
    from gslora_tpu.parallel import multihost as jmh
    np.testing.assert_array_equal(tmh.device_blocks(axis_names, shape),
                                  jmh.device_blocks(axis_names, shape))
    blocks = jmh.device_blocks(axis_names, shape)
    for n_procs in (1, 2, 4):
        procs = (blocks // ((blocks.max() + 1) // n_procs)).astype(np.int32)
        assert tmh.process_block_map(axis_names, procs) == \
            jmh.process_block_map(axis_names, procs)


@pytest.mark.parametrize("world", [1, 2, 4, 8])
@pytest.mark.parametrize("batch", [8, 48, 480, 12])
def test_host_batch_bounds_match_jax(world, batch):
    """A rank's rows are its block of the (data, model=1) mesh, as JAX's
    pure math gives them for one device per process; an uneven split
    raises JAX's error."""
    from gslora_tpu.parallel import multihost as jmh
    owner = np.arange(world).reshape(world, 1)
    for rank in range(world):
        mesh = tmesh.DataMesh(rank, world, torch.device("cpu"))
        blocks = jmh.process_block_map(("data", "model"), owner)[rank]
        try:
            want = jmh.blocks_to_bounds(batch, world, blocks)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                tmh.host_batch_bounds(mesh, batch)
            continue
        assert tmh.host_batch_bounds(mesh, batch) == want
        assert tmh.blocks_to_bounds(batch, world, blocks) == want


def test_blocks_to_bounds_rejects_what_jax_rejects():
    from gslora_tpu.parallel import multihost as jmh
    for args in ((16, 4, [0, 2]), (16, 4, []), (10, 4, [0])):
        with pytest.raises(ValueError) as jerr:
            jmh.blocks_to_bounds(*args)
        with pytest.raises(ValueError) as terr:
            tmh.blocks_to_bounds(*args)
        assert str(terr.value) == str(jerr.value)


def test_process_sharded_loader_splits_the_global_batches():
    """Rank r's batches are rows [r·B/W, (r+1)·B/W) of the global padded
    batches, as JAX's BatchLoader(local_bounds=...) gives them, with the
    padded tail's labels -1 wherever it falls."""
    from gslora_tpu.data.folders import ArrayDataset as JArray
    from gslora_tpu.data.pipeline import BatchLoader as JLoader

    from gslora_tpu_torch.data.folders import ArrayDataset
    from gslora_tpu_torch.data.pipeline import BatchLoader
    n, bs, world = 21, 8, 4
    imgs = np.random.RandomState(0).rand(n, 3, 4, 4).astype(np.float32)
    labels = np.arange(n) % 5
    whole = list(BatchLoader(ArrayDataset(imgs, labels), bs, seed=3,
                             mask_padding=True, prefetch=0))
    assert (whole[-1][1] == -1).sum() == 3
    for rank in range(world):
        mesh = tmesh.DataMesh(rank, world, torch.device("cpu"))
        got = list(tmh.process_sharded_loader(
            mesh, ArrayDataset(imgs, labels), bs, seed=3, prefetch=0))
        want = list(JLoader(JArray(imgs, labels), bs, seed=3,
                            mask_padding=True, prefetch=0,
                            local_bounds=tmh.host_batch_bounds(mesh, bs)))
        lo, hi = rank * bs // world, (rank + 1) * bs // world
        assert len(got) == len(whole) == len(want)
        for (x, y), (wx, wy), (jx, jy) in zip(got, whole, want):
            np.testing.assert_array_equal(x, wx[lo:hi])
            np.testing.assert_array_equal(y, wy[lo:hi])
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)
    assert tmh.process_sharded_loader(None, ArrayDataset(imgs, labels),
                                      bs).local_bounds is None


def test_a_full_global_batch_feed_raises():
    mesh = tmesh.DataMesh(1, 2, torch.device("cpu"))
    tmh.declare_global_batch(16)
    tmh.check_local_feed(mesh, 8)
    with pytest.raises(ValueError, match="full-global-batch"):
        tmh.check_local_feed(mesh, 16)
    tmh.check_local_feed(None, 16)


# ---------------------------------------------------------------------------
# two gloo ranks on the CPU against JAX's one-device run
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(outdir, device, names, world=2):
    """Run ``names`` in ``world`` fresh ranks; raise with a rank's log if
    any fails or outlives RANK_TIMEOUT_S."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("RANK", "WORLD_SIZE", "LOCAL_RANK",
                                "MASTER_"))}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), str(ROOT / "tests")])
    env["OMP_NUM_THREADS"] = "1"
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "torch_dp_worker", str(r), str(world),
         str(port), str(outdir), device, *names], cwd=outdir, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    return [{name: torch.load(Path(outdir) / f"{name}.rank{r}.pt",
                              weights_only=False) for name in names}
            for r in range(world)]


def _init_tree():
    """One parameter tree for both packages (numpy leaves, drawn by the JAX
    package's init), its LoRA B factors nonzero."""
    import jax

    import gslora_tpu.config as jc
    from gslora_tpu.models.vit import init_vit_params
    p = jax.tree.map(np.asarray, init_vit_params(
        jax.random.key(0), jc.ViTConfig(**worker.MODEL),
        jc.LoraConfig(rank=4)))
    rng = np.random.RandomState(1)
    for name in ("B1", "B2"):
        b = p["lora"]["ffn"][name]
        p["lora"]["ffn"][name] = (0.05 * rng.randn(*b.shape)).astype(
            np.float32)
    return p


def _save(tree, path):
    from gslora_tpu_torch.models.convert import flatten_tree
    np.savez(path, **flatten_tree(tree))


def _jax_run(name, tree, monkeypatch):
    """The JAX CLI of scenario ``name`` on one device, with the same flags
    (no --dp, no --device) and the same tiny model and tree."""
    import importlib

    import jax
    import jax.numpy as jnp

    import gslora_tpu.config as jc
    cli, argv, _ = worker.SCENARIOS[name]
    module = importlib.import_module(f"gslora_tpu.cli.{cli}")
    orig = jc.config_from_args

    def config(args):
        cfg = orig(args)
        cfg.model = jc.ViTConfig(**{**worker.MODEL,
                                    "depth": args.vit_depth,
                                    "head_type": args.head})
        cfg.ver_freq = worker.VER_FREQ
        return cfg

    monkeypatch.setattr(module, "config_from_args", config)
    monkeypatch.setattr(module, "build_params", lambda cfg, seed=None:
                        jax.tree.map(jnp.asarray, tree))
    seen = {"history": []}

    def host(t):
        from gslora_tpu_torch.models.convert import flatten_tree
        return {k: np.asarray(v, np.float32)
                for k, v in flatten_tree(jax.tree.map(np.asarray, t)).items()}

    if cli == "train_pretrain":
        make = module.make_pretrain_step

        def spy_make(*a, **k):
            step = make(*a, **k)

            def spy_step(state, *args):
                state, m = step(state, *args)
                seen["state"] = state
                return state, m
            return spy_step
        monkeypatch.setattr(module, "make_pretrain_step", spy_make)
    elif cli == "train_forget":
        run = module.run_forget_training

        def spy(*a, **k):
            res = run(*a, **k)
            seen["params"] = host(res.state.params)
            seen["history"] = [res.history]
            return res
        monkeypatch.setattr(module, "run_forget_training", spy)
    else:
        from gslora_tpu.engine import continual
        monkeypatch.setattr(continual, "reinit_lora", lambda key, tree:
                            jax.tree.map(jnp.asarray,
                                         worker.np_reinit(tree)))
        run = module.run_continual_forgetting

        def spy(*a, **k):
            out = run(*a, **k)
            seen["params"] = host(out.final_params)
            seen["history"] = [t.result.history for t in out.tasks]
            return out
        monkeypatch.setattr(module, "run_continual_forgetting", spy)
    report = module.main(list(argv) + ["--outdir", ""])
    if "state" in seen:
        seen["params"] = host(seen.pop("state").params)
    return {"report": report, **seen}


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """Every scenario on 2 gloo ranks (one spawn), in one port process,
    with ``--dp`` in one port process, and through the JAX CLI."""
    out = tmp_path_factory.mktemp("dp")
    init = _init_tree()
    _save(init, out / "init.npz")
    mp = pytest.MonkeyPatch()
    try:
        one = {"pretrain": worker.run_scenario("pretrain", init,
                                               setattr_=mp.setattr)}
        # the forget runs start from the one-process pretrained base
        pre = {"base": {}, "lora": init["lora"]}
        from gslora_tpu_torch.models.convert import unflatten_tree
        pre["base"] = unflatten_tree(
            {k[5:]: v for k, v in one["pretrain"]["params"].items()
             if k.startswith("base.")})
        _save(pre, out / "pretrained.npz")
        trees = {"init": init, "pretrained": pre}
        names = CPU_SCENARIOS
        ranks = spawn_ranks(out, "cpu", names)
        for name in names:
            tree = trees[worker.SCENARIOS[name][2]]
            if name not in one:
                one[name] = worker.run_scenario(name, tree,
                                                setattr_=mp.setattr)
        dp_one = {"forget": worker.run_scenario(
            "forget", pre, ["--dp"], setattr_=mp.setattr)}
        jax_ref = {name: _jax_run(name, trees[worker.SCENARIOS[name][2]], mp)
                   for name in names}
    finally:
        mp.undo()
    return {"ranks": ranks, "one": one, "dp_one": dp_one, "jax": jax_ref}


def _assert_params(got, want, rtol=RTOL, atol=ATOL, what=""):
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")


def _assert_history(got, want):
    assert len(got) == len(want)
    for gt, wt in zip(got, want):
        assert len(gt) == len(wt) > 0
        for g, w in zip(gt, wt):
            assert (g["epoch"], g["batch"]) == (w["epoch"], w["batch"])
            for k in ("Test forget Accuracy", "Test remain Accuracy",
                      "H_mean"):
                assert abs(g[k] - w[k]) < ACC_TOL, (k, g[k], w[k])


def _assert_reports(got, want):
    got, want = json.loads(json.dumps(got)), json.loads(json.dumps(want))
    for g, w in zip(got if isinstance(got, list) else [got],
                    want if isinstance(want, list) else [want]):
        for k, v in w.items():
            if k == "time_to_forget_s":
                continue
            if k == "norm_list":
                np.testing.assert_allclose(g[k], v, rtol=RTOL, atol=ATOL)
            elif isinstance(v, float):
                assert abs(g[k] - v) < ACC_TOL, (k, g[k], v)
            else:
                assert g[k] == v, (k, g[k], v)


@pytest.mark.parametrize("name", CPU_SCENARIOS)
def test_two_ranks_equal_the_jax_one_device_run(dp_runs, name):
    """Final parameters to rtol 1e-4 / atol 1e-5, every eval's accuracies
    and H, the report's accuracies and best H to 1e-3. Ragged tails are
    padded across the ranks; pretrain_accum runs --grad_accum 2 on each
    rank's rows; continual runs the prox step (K2) on both ranks."""
    want = dp_runs["jax"][name]
    for r, rank in enumerate(dp_runs["ranks"]):
        got = rank[name]
        _assert_params(got["params"], want["params"], what=f"rank {r}")
        _assert_history(got["history"], want["history"])
        _assert_reports(got["report"], want["report"])


@pytest.mark.parametrize("name", CPU_SCENARIOS)
def test_two_ranks_equal_the_port_one_process_run(dp_runs, name):
    ranks = dp_runs["ranks"]
    for k, v in ranks[0][name]["params"].items():
        # one set of parameters on every rank, to the bit
        np.testing.assert_array_equal(ranks[1][name]["params"][k], v)
    want = dp_runs["one"][name]
    got = ranks[0][name]
    _assert_params(got["params"], want["params"])
    _assert_history(got["history"], want["history"])
    _assert_reports(got["report"], want["report"])


def test_the_forget_runs_move(dp_runs):
    """The comparisons above see real change: the forget accuracy falls
    from its starting value and H is positive."""
    report = dp_runs["ranks"][0]["forget"]["report"]
    assert report["forget_acc_before"] > report["forget_acc"]
    assert report["best_H_mean"] > 0
    assert dp_runs["ranks"][0]["pretrain"]["report"]["final_test_acc"] > 30


def test_dp_on_one_process_equals_no_dp(dp_runs):
    """--dp in a world of one is the run without it, to the bit."""
    got, want = dp_runs["dp_one"]["forget"], dp_runs["one"]["forget"]
    assert got["report"] == want["report"]
    assert got["history"] == want["history"]
    for k, v in want["params"].items():
        np.testing.assert_array_equal(got["params"][k], v)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card(card, tmp_path):
    """Two ranks sharing cuda:0 through gloo run the forget CLI with --dp
    in bf16 through the kernels; both end with one set of parameters,
    equal to a one-process run on the card with --grad_accum 2, whose
    micro-batches are the ranks' rows."""
    import gslora_tpu_torch.config as tc
    from gslora_tpu_torch.models.vit import init_vit_params
    init = worker.numpy_tree(init_vit_params(  # no JAX on the card's machine
        torch.Generator().manual_seed(0), tc.ViTConfig(**worker.MODEL),
        tc.LoraConfig(rank=4)))
    np.savez(tmp_path / "pretrained.npz", **init)
    from gslora_tpu_torch.models.convert import unflatten_tree
    init = unflatten_tree(init)
    ranks = spawn_ranks(tmp_path, "cuda", ["forget_card"])
    one = worker.run_scenario("forget_card", init, ["--grad_accum", "2"],
                              device="cuda")
    got = ranks[0]["forget_card"]
    for k, v in got["params"].items():
        np.testing.assert_array_equal(ranks[1]["forget_card"]["params"][k],
                                      v)
    _assert_params(got["params"], one["params"])
    _assert_history(got["history"], one["history"])


@pytest.mark.cuda
def test_baseline_under_tp_on_one_card(card, tmp_path):
    """Two ranks sharing cuda:0 through gloo run train_forget --ewc --tp
    --mesh_model 2 (the FFN hidden and the head's classes split over
    ``model``, K1 on every rank) in bf16 through the kernels: both end
    with one model, within 4 times the recipe's bf16 noise floor (one
    process at --grad_accum 1 against itself at 2, another order of the
    same sums) of one process, as chip_smoke's layout phase holds its
    runs."""
    import gslora_tpu_torch.config as tc
    import torch_mesh_setup as setup
    import torch_mesh_worker as mw
    from gslora_tpu_torch.models.convert import unflatten_tree
    from gslora_tpu_torch.models.vit import init_vit_params
    base = worker.numpy_tree(init_vit_params(  # no JAX on the card's machine
        torch.Generator().manual_seed(0), tc.ViTConfig(**worker.MODEL),
        tc.LoraConfig(rank=0)))
    np.savez(tmp_path / "base.npz", **base)
    wait = setup.start_ranks(tmp_path, ["ewc_tp_card"], 2, device="cuda")
    mp = pytest.MonkeyPatch()
    try:
        one, floor = (mw.run("ewc_tp_card", unflatten_tree(base),
                             layout=False, setattr_=mp.setattr,
                             device="cuda", extra=extra)
                      for extra in ([], ["--grad_accum", "2"]))
        ranks = [r["ewc_tp_card"] for r in wait()]
    finally:
        mp.undo()

    def rel(a, b):
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))

    noise = max(rel(floor["params"][k], v) for k, v in one["params"].items())
    moved = max(rel(v, base[k]) for k, v in one["params"].items())
    assert 0 < noise < moved
    for k, v in ranks[0]["params"].items():
        np.testing.assert_array_equal(ranks[1]["params"][k], v, err_msg=k)
        assert rel(v, one["params"][k]) <= 4 * noise, k
