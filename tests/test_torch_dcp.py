"""checkpoints/dcp_io.py (the port's counterpart of
gslora_tpu/checkpoints/orbax_io.py, through torch.distributed.checkpoint):
a port train state (parameters, Adam moments, counts) round-trips in one
process and in two gloo ranks, synchronously and through AsyncSaver, with
and without a template, and reads back the arrays the JAX package's
save_orbax / load_orbax give for the same tree."""
import numpy as np
import pytest
import torch

import torch_dp_baselines_worker as W
from gslora_tpu_torch.checkpoints.dcp_io import (AsyncSaver, load_dcp,
                                                 save_dcp)


def _assert_same(got, want, what=""):
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want)))
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype, (what, k)
            np.testing.assert_array_equal(got[k], w, err_msg=f"{what} {k}")
        else:
            assert got[k] == w, (what, k, got[k], w)


@pytest.fixture(scope="module")
def state():
    st = W.train_state()
    flat = W.flat_state(st)
    # the state is a real one: moments moved, counts set, a LoRA trained
    assert st["opt_state"]["count"] == st["step"] == 1
    assert any(np.abs(v).max() > 0 for k, v in flat.items()
               if k.startswith("/opt_state/nu/"))
    return st


def test_round_trip_in_one_process(state, tmp_path):
    save_dcp(str(tmp_path / "ckpt"), state)
    want = W.flat_state(state)
    _assert_same(W.flat_state(load_dcp(str(tmp_path / "ckpt"))), want,
                 "no template")
    template = W.zeroed(state)
    back = load_dcp(str(tmp_path / "ckpt"), template)
    assert back is template
    _assert_same(W.flat_state(back), want, "template")
    # the template's own tensors were filled in place
    assert back["params"]["lora"]["ffn"]["A1"].data_ptr() == \
        template["params"]["lora"]["ffn"]["A1"].data_ptr()


def test_async_saver_copies_in_the_call(state, tmp_path):
    """What save() was given is what lands on disk, though the caller
    changes its tensors before the write ends; a second save waits for
    the first."""
    live = W.train_state()  # seeded: the same values as ``state``
    saver = AsyncSaver()
    saver.save(str(tmp_path / "a"), live)
    with torch.no_grad():
        live["params"]["base"]["head"]["weight"].add_(1.0)
    saver.save(str(tmp_path / "b"), live)
    saver.wait()
    saver.close()
    want = W.flat_state(state)
    _assert_same(W.flat_state(load_dcp(str(tmp_path / "a"))), want, "a")
    moved = W.flat_state(load_dcp(str(tmp_path / "b")))
    np.testing.assert_array_equal(
        moved["/params/base/head/weight"],
        want["/params/base/head/weight"] + np.float32(1.0))


def test_matches_the_jax_orbax_round_trip(state, tmp_path):
    """The same tree through the JAX package's orbax_io and through
    dcp_io reads back the same arrays."""
    from gslora_tpu.checkpoints.orbax_io import load_orbax, save_orbax
    tree = {"params": W.flat_state(state["params"]),
            "mu": [t.numpy() for t in state["opt_state"]["mu"]],
            "count": np.int64(state["opt_state"]["count"])}
    save_orbax(str(tmp_path / "orbax"), tree)
    jax_back = load_orbax(str(tmp_path / "orbax"))
    save_dcp(str(tmp_path / "dcp"), {
        "params": {k: torch.from_numpy(v) for k, v in
                   tree["params"].items()},
        "mu": [torch.from_numpy(v) for v in tree["mu"]],
        "count": int(tree["count"])})
    back = load_dcp(str(tmp_path / "dcp"))
    assert set(back["params"]) == set(jax_back["params"]) == \
        set(tree["params"])
    for k, v in jax_back["params"].items():
        np.testing.assert_array_equal(back["params"][k].numpy(),
                                      np.asarray(v))
    assert len(back["mu"]) == len(jax_back["mu"]) == len(tree["mu"])
    for a, b in zip(back["mu"], jax_back["mu"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert back["count"] == int(jax_back["count"]) == 1


def test_two_ranks_save_and_load_a_replicated_state(state, tmp_path):
    """Two gloo ranks save the same state (save_dcp and AsyncSaver), rank
    0 alone writing its bytes; each rank reads it back equal, with and
    without a template."""
    procs = W.start_ranks(tmp_path, ["dcp"])
    ranks = W.collect(procs, tmp_path, ["dcp"])
    want = W.flat_state(state)
    for r, rank in enumerate(ranks):
        out = rank["dcp"]
        _assert_same(out["want"], want, f"rank {r} state")
        for key in ("dcp_sync", "dcp_async", "dcp_sync_template",
                    "dcp_async_template"):
            _assert_same(out[key], want, f"rank {r} {key}")
    for name in ("dcp_sync", "dcp_async"):
        sizes = {p.name: p.stat().st_size for p in (tmp_path / name).iterdir()
                 if p.suffix == ".distcp"}
        assert sizes["__1_0.distcp"] == 0 < sizes["__0_0.distcp"], sizes


@pytest.mark.parametrize("saver", ["sync", "async"])
def test_a_second_save_to_one_path_replaces_the_first(state, tmp_path,
                                                      saver):
    """Two trees saved to one path read back as the second (orbax's
    ``force=True``): the writer asks DCP to overwrite, whatever its
    default for ``overwrite`` becomes."""
    from gslora_tpu_torch.checkpoints import dcp_io
    live = W.train_state()
    path = str(tmp_path / "ckpt")
    assert dcp_io._writer(path).overwrite is True
    if saver == "sync":
        save_dcp(path, live)
        with torch.no_grad():
            live["params"]["base"]["head"]["weight"].mul_(-2.0)
        save_dcp(path, live)
    else:
        s = AsyncSaver()
        s.save(path, live)
        s.wait()
        with torch.no_grad():
            live["params"]["base"]["head"]["weight"].mul_(-2.0)
        s.save(path, live)
        s.close()
    back = W.flat_state(load_dcp(path))
    want = W.flat_state(state)
    np.testing.assert_array_equal(back["/params/base/head/weight"],
                                  want["/params/base/head/weight"] *
                                  np.float32(-2.0))
    for k, v in want.items():
        if k != "/params/base/head/weight" and isinstance(v, np.ndarray):
            np.testing.assert_array_equal(back[k], v, err_msg=k)
