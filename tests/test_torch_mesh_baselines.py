"""The baseline zoo under the sharded layouts of JAX's baseline runners
(``placement(mesh, tp=, fsdp=, sp=)`` in each, gslora_tpu/baselines/
regularization.py:179-181, distill.py:296-298, scrub.py:174-176,
lirf.py:312-314): gloo ranks on the CPU (tests/torch_dp_baselines_worker.py,
``layout_runs``: 2 ranks and 4 started together, fresh interpreters) run
each runner family at the tiny model with every tree sharded by JAX's
rules, against the JAX runners' one-device run of the same family from
the same trees on the same padded global batches (the JAX suite's fp32
tolerance, rtol 1e-4 / atol 1e-5; accuracies within 1e-3):

* EWC at its second task (two anchors, each with its Fisher taken under
  the layout) under tp 1 x 2, fsdp 2 x 1 and sp 1 x 2: under sp each
  rank's gradient of a leaf held whole inside the stack is its tokens'
  part, so the Fisher matches only if it is squared after the ``model``
  sum; MAS the same way under sp;
* LwF, DER++ and FDR under tp + fsdp 2 x 2 (KD, DER and FDR on the class
  scores and embeddings the model gathers whole);
* SCRUB under fsdp and a model axis 2 x 2 (its SWA distance summed over
  the shards before the square root), and that distance on the shards
  against the whole trees' and JAX's, gradient included;
* LIRF's split under tp + fsdp + sp 2 x 2;
* DER++ under ``--mesh_slices 2`` with tp (2 x 1 x 2)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dp_baselines_worker as W
from gslora_tpu_torch.models.convert import flatten_tree
from torch_baselines_setup import one_torch_thread, to_jax

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)

RUNS = {name: spec for name, spec in W.layout_runs().items()
        if spec[0] is not None}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_baselines")
    p = W.pretrained_tree(3)
    trees = {"p": p, "teacher": p, "swa": W.pretrained_tree(4)}
    W.save_trees(out, trees)
    by_world = {}
    for name, (_, _, world) in W.layout_runs().items():
        by_world.setdefault(world, []).append(name)
    procs = {w: W.start_ranks(out, names, w) for w, names in
             by_world.items()}
    try:
        jax_ref = {family: W.jax_family(family, trees, one_device=True)
                   for family in sorted({f for f, _, _ in RUNS.values()})}
    except BaseException:
        for ps in procs.values():
            for proc in ps:
                proc.kill()
                proc.wait()
        raise
    ranks = {w: W.collect(procs[w], out, by_world[w]) for w in procs}
    return {"ranks": {name: [r[name] for r in ranks[w]]
                      for w, names in by_world.items() for name in names},
            "jax": jax_ref, "trees": trees}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_layout_equals_the_jax_one_device_run(runs, name):
    """Every rank's final trees (the student; SCRUB's SWA model; the
    second EWC / MAS importance), gathered whole, to rtol 1e-4 / atol
    1e-5, and every runner call's accuracies and best H to 1e-3."""
    family = RUNS[name][0]
    W.check_against_jax({"jax": {name: runs["jax"][family]}}, name,
                        ranks=[{name: r} for r in runs["ranks"][name]])


@pytest.mark.parametrize("name", sorted(RUNS))
def test_layout_ranks_hold_one_model(runs, name):
    """The trees every rank returns (gathered whole) are one, to the bit,
    and training moved the student off its start."""
    ranks = runs["ranks"][name]
    for key in ("params", "swa", "importance"):
        if key not in ranks[0]:
            continue
        for rank in ranks[1:]:
            for k, v in ranks[0][key].items():
                np.testing.assert_array_equal(rank[key][k], v, err_msg=k)
    start = flatten_tree(runs["trees"]["p"])
    # LIRF's student is the low half, named without "base."
    moved = [k for k, v in ranks[0]["params"].items()
             if not np.array_equal(v, start.get(k, start.get("base." + k)))]
    assert moved, name


def test_param_dist_on_shards_equals_the_whole_tree(runs):
    """SCRUB's SWA distance on the fsdp + model shards (each leaf's
    squares summed over its shards before the square root) equals the
    whole trees' on every rank, and so does its gradient gathered whole;
    both equal the JAX package's ``param_dist`` and its ``jax.grad``."""
    from gslora_tpu.baselines.scrub import param_dist
    p, swa = (to_jax(runs["trees"][k]) for k in ("p", "swa"))
    value, grads = jax.value_and_grad(
        lambda a: param_dist(a, swa, 0.1))(p)
    want = {k: np.asarray(v) for k, v in flatten_tree(
        jax.tree.map(np.asarray, grads)).items()}
    for r, rank in enumerate(runs["ranks"]["param_dist"]):
        (whole_v, whole_g), (shard_v, shard_g) = rank["whole"], \
            rank["sharded"]
        assert abs(shard_v - whole_v) <= 1e-6 * abs(whole_v), r
        assert abs(shard_v - float(value)) <= 1e-5 * abs(float(value)), r
        assert set(shard_g) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(shard_g[k], whole_g[k], rtol=1e-6,
                                       atol=1e-9, err_msg=f"rank {r} {k}")
            np.testing.assert_allclose(shard_g[k], w, rtol=W.RTOL,
                                       atol=W.ATOL, err_msg=f"rank {r} {k}")
    assert float(jnp.abs(value)) > 0
