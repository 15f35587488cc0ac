"""Every model and LoRA position under the layouts JAX runs them on, with
gloo ranks on the CPU (tests/torch_mesh_worker.py), against the JAX CLI's
one-device run from the same tree (the JAX suite's fp32 tolerance, rtol
1e-4 / atol 1e-5; accuracies within 1e-3):

* ``-n VIT_B16`` at the tiny width with ViT-B/16's structure (qkv bias,
  head-dim scale, conv patchify, a Softmax head whose bias is added whole
  after the class scores are gathered) under tp + fsdp 2 x 2, sp 1 x 2
  and pp 1 x 2, through the forget CLI;
* ``-n VITs`` (the overlapping soft split) under tp 2 x 2;
* ``--lora_pos Attention`` under fsdp 2 x 1 (the fold on the rank's qkv
  shard), tp 2 x 2 (the attention LoRA replicated, its squares not summed
  over ``model``), sp 1 x 2 (its gradient the rank's part, summed over
  ``model``) and pp 1 x 2 (cut on its layer dim; the group-Lasso and the
  report's group norms over the stages);
* the pretrain CLI's ``--ver_targets`` under tp + fsdp 2 x 2: every rank
  gathers the parameters, rank 0 verifies with the whole ones;
* the L1 group norms of a tp-sharded FFN LoRA (B1 and A2 summed over
  ``model``).

The ranks are spawned once for the module (4 ranks and 2 together),
fresh interpreters; the references run while the ranks do.
"""
import io
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

import torch_mesh_setup as setup
import torch_mesh_worker as mw
from gslora_tpu_torch.models.convert import flatten_tree

WORLD4 = ["b16_tp_fsdp", "vits_tp", "attn_tp", "pretrain_ver_tp_fsdp"]
WORLD2 = ["b16_sp", "b16_pp", "attn_fsdp", "attn_sp", "attn_pp"]
PARITY = WORLD4 + WORLD2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _lfw(root, pairs=12, seed=7):
    """A pair-verification .bin of 2 * pairs random 16x16 JPEGs,
    alternating same / different (tests/test_torch_eval_cli.py's)."""
    rng = np.random.RandomState(seed)
    bins = []
    for _ in range(2 * pairs):
        img = Image.fromarray((rng.rand(16, 16, 3) * 255).astype(np.uint8))
        buf = io.BytesIO()
        img.save(buf, format="JPEG")
        bins.append(buf.getvalue())
    with open(root / "lfw.bin", "wb") as f:
        pickle.dump((bins, [True, False] * (pairs // 2)), f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_models")
    mp = pytest.MonkeyPatch()
    try:
        trees = {"init": setup.init_tree(),
                 "b16": setup.init_tree(overrides=mw.B16),
                 "vits": setup.init_tree(overrides=mw.VITS),
                 "attn": setup.init_tree(pos="Attention")}
        for name, tree in trees.items():
            setup.save_tree(tree, out / f"{name}.npz")
        _lfw(out)
        wait4 = setup.start_ranks(out, WORLD4, 4)
        wait2 = setup.start_ranks(out, WORLD2 + ["l1_norms"], 2)
        mp.chdir(out)  # the .bin the verification reads
        one, jax_ref = setup.references(PARITY, trees, mp, outdir=out)
        ranks = {4: wait4(), 2: wait2()}
    finally:
        mp.undo()
    return {"ranks": ranks, "one": one, "jax": jax_ref, "trees": trees}


def _ranks(runs, name):
    world = 2 if name == "l1_norms" else mw.SCENARIOS[name][5]
    return [r[name] for r in runs["ranks"][world]]


@pytest.mark.parametrize("name", PARITY)
def test_model_layout_equals_the_jax_one_device_run(runs, name):
    """Final parameters (gathered whole) to rtol 1e-4 / atol 1e-5, every
    eval's accuracies and H, the report's (group norms included) to
    1e-3, on every rank."""
    want = runs["jax"][name]
    for r, got in enumerate(_ranks(runs, name)):
        setup.assert_params(got["params"], want["params"], what=f"rank {r}")
        setup.assert_history(got["history"], want["history"])
        setup.assert_reports(got["report"], want["report"])


@pytest.mark.parametrize("name", PARITY)
def test_model_layout_keeps_the_jax_layout(runs, name):
    """One set of parameters on every rank, to the bit, each rank holding
    its slice of it by JAX's rules (the attention LoRA by no tp or fsdp
    rule, on its layer dim under pp); training moved the LoRA (the whole
    model in the pretrain) off its start."""
    layout = setup.layout_of(name)
    ranks = _ranks(runs, name)
    for r, rank in enumerate(ranks):
        for k, v in ranks[0]["params"].items():
            np.testing.assert_array_equal(rank["params"][k], v, err_msg=k)
        assert set(rank["shards"]) == set(rank["params"])
        for k, v in rank["shards"].items():
            want = setup.expected_shard(rank["params"][k], k, r, *layout)
            np.testing.assert_array_equal(v, want, err_msg=f"rank {r} {k}")
    start = flatten_tree(runs["trees"][mw.SCENARIOS[name][3]])
    key = "base.blocks.fc1.kernel" if name.startswith("pretrain") else \
        ("lora.attn.B" if name.startswith("attn") else "lora.ffn.B1")
    assert not np.allclose(ranks[0]["params"][key], start[key]), name


def test_pp_gathers_the_attention_norms_over_the_stages(runs):
    """Under pp each stage holds one of the two layers' attention LoRA:
    the report's group norms are both layers', equal to the JAX run's and
    to the norms of the final parameters."""
    got = _ranks(runs, "attn_pp")[0]
    norms = got["report"]["norm_list"]
    assert len(norms) == 2
    p = got["params"]
    want = [np.sqrt(np.sum(p["lora.attn.A"][i] ** 2) +
                    np.sum(p["lora.attn.B"][i] ** 2)) for i in range(2)]
    np.testing.assert_allclose(norms, want, rtol=1e-5)
    np.testing.assert_allclose(norms, runs["jax"]["attn_pp"]["report"][
        "norm_list"], rtol=setup.RTOL, atol=setup.ATOL)


def test_ver_targets_under_tp_fsdp_verify_the_whole_model(runs):
    """Rank 0 alone verifies (the others log nothing), at batch 20, with
    the gathered parameters: the same accuracy as the port's one process
    and as the JAX CLI's one device."""
    name = "pretrain_ver_tp_fsdp"
    ranks = _ranks(runs, name)
    assert all(not r["verification"] for r in ranks[1:])
    got = ranks[0]["verification"]
    assert [(t, b) for t, b, *_ in got] == [("lfw", 19)]
    for want in (runs["one"][name]["verification"],
                 runs["jax"][name]["verification"]):
        assert [(t, b) for t, b, *_ in want] == [("lfw", 19)]
        np.testing.assert_allclose([a for *_, a, _ in got],
                                   [a for *_, a, _ in want], atol=1e-9)


def test_l1_group_norms_under_tp_equal_jax(runs):
    """The per-block L1 norms (and L2) of an FFN LoRA whose B1 and A2 are
    split over ``model``: the sums of |B1| and |A2| over the shards, not
    those of |A1| and |B2|, equal the JAX package's norms of the whole
    tree on every rank."""
    import jax.numpy as jnp

    from gslora_tpu.lora.core import lora_group_norms
    lora = {pos: {k: jnp.asarray(v) for k, v in sub.items()}
            for pos, sub in runs["trees"]["init"]["lora"].items()}
    for r, rank in enumerate(_ranks(runs, "l1_norms")):
        assert rank["shards"]["ffn.B1"].shape[1] * 2 == \
            lora["ffn"]["B1"].shape[1]
        for o in (1, 2):
            np.testing.assert_allclose(
                rank[f"ord{o}"], lora_group_norms(lora, "FFN", ord=o),
                rtol=1e-6, err_msg=f"rank {r} ord {o}")
