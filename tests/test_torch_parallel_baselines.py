"""The regularization baselines under the port's data parallelism
(gslora_tpu_torch/baselines/regularization.py with a
parallel/mesh.DataMesh): two gloo ranks on the CPU
(tests/torch_dp_baselines_worker.py, spawned once for the module, a fresh
interpreter each) run EWC at its second task (two anchors, each with its
global Fisher) and the EWC and MAS importances, on padded global batches
of 8 whose tails leave rank 1's forget rows all padding in a step and
split the remain tail unevenly; the other families are in
tests/test_torch_parallel_baselines_distill.py.

Held to:
* the JAX runner with ``mesh=make_mesh(MeshConfig(data=2))`` (the JAX
  suite's data-parallel tolerance, tests/test_mesh_loop.py:79-80: rtol
  1e-4, atol 1e-5; accuracies within 1e-3);
* the port's one process with ``--grad_accum 2``, whose micro-batches are
  the ranks' rows: equal to the bit, as the rows, shapes and fp32 sum
  order match (each rank's gradient a micro-batch's, the all_reduce the
  micro-batches' sum);
* the importances also against one process without micro-batches, which
  sums a batch's rows in one backward: that order differs, so the JAX
  tolerance holds there.

Four more gloo ranks, started beside the two, run the data axes of the
whole JAX mesh: EWC under ``--mesh_slices 2`` (2 x 2 x 1), held to the
JAX runner on ``make_mesh(MeshConfig(data=2, slices=2))`` and to plain
``--dp`` on the same four ranks (to the bit: the same rows and sums), and
SCRUB on ``--mesh_data 2`` (ranks 2 and 3 idle), held to the JAX runner
on a 2-device mesh and to the two ranks' ``--dp`` run (to the bit)."""
import numpy as np
import pytest

import torch_dp_baselines_worker as W
from gslora_tpu_torch.models.convert import flatten_tree
from torch_baselines_setup import one_torch_thread

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)

NAMES = ["reg_ewc", "importance", "scrub"]
MESH_NAMES = ["reg_ewc_dcn", "reg_ewc_dp4", "scrub_subworld"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return W.family_runs(tmp_path_factory.mktemp("dp_reg"), NAMES,
                         MESH_NAMES)


def _mesh_ranks(runs, name, idle=False):
    """The results of ``name`` on the used ranks of its mesh (``idle``:
    on the others)."""
    got = [r[name] for r in runs["mesh_ranks"]]
    return [g for g in got if g.get("idle", False) == idle]


def test_two_ranks_equal_the_jax_mesh_run(runs):
    """Each rank's final parameters and second Fisher to rtol 1e-4 / atol
    1e-5, both runner calls' accuracies and best H to 1e-3."""
    W.check_against_jax(runs, "reg_ewc")


@pytest.mark.parametrize("name", NAMES)
def test_two_ranks_equal_one_process_with_grad_accum_2(runs, name):
    """Equal to the bit, on both ranks: one process with --grad_accum 2
    runs the ranks' rows as its micro-batches, at the same shapes, and
    adds the gradients and the masked sums in the same order."""
    W.check_against_one_process(runs, name)


@pytest.mark.parametrize("method", ["ewc", "mas"])
def test_importance_of_two_ranks_is_the_global_batch_s(runs, method):
    """The gradient is summed over the ranks before it is squared (EWC)
    or its absolute value taken (MAS), and the EWC weight counts the
    global batch's valid rows: against one process that takes each batch
    whole (another sum order inside the backward), to the JAX tolerance;
    the tail batch's valid rows split 4 / 1 over the ranks."""
    want = runs["one_whole"][method]
    assert max(float(np.abs(v).max()) for v in want.values()) > 0
    for rank in runs["ranks"]:
        # a relative tolerance: the importances' scale is far from the
        # parameters'
        got = rank["importance"][method]
        for k, w in want.items():
            np.testing.assert_allclose(
                got[k], w, rtol=W.RTOL, atol=W.ATOL * float(np.abs(w).max()),
                err_msg=f"{method} {k}")


def test_the_run_moves(runs):
    """The comparisons see real change: the forget accuracy falls from
    where the pretrained tree starts it, and the parameters leave it."""
    one = runs["one"]["reg_ewc"]
    first = one["acc"][0]
    assert first["forget_acc_before"] > first["forget_acc"]
    start = flatten_tree(runs["trees"]["p"])
    assert max(float(np.abs(one["params"][k] - start[k]).max())
               for k in start) > 1e-3


@pytest.mark.parametrize("name", ["reg_ewc_dcn", "scrub_subworld"])
def test_mesh_runs_equal_the_jax_mesh_run(runs, name):
    """EWC on 2 x 2 x 1 against the JAX runner on the same dcn mesh, SCRUB
    on the 2 used ranks of 4 against the JAX runner on 2 devices: each
    used rank's final trees to rtol 1e-4 / atol 1e-5, the accuracies and
    best H to 1e-3."""
    used = _mesh_ranks(runs, name)
    assert len(used) == {"reg_ewc_dcn": 4, "scrub_subworld": 2}[name]
    W.check_against_jax(runs, name, [{name: g} for g in used])


@pytest.mark.parametrize("name,dp", [("reg_ewc_dcn", "reg_ewc_dp4"),
                                     ("scrub_subworld", "scrub")])
def test_mesh_runs_equal_the_dp_run_to_the_bit(runs, name, dp):
    """--mesh_slices 2 equals plain --dp on the same four ranks, and
    --mesh_data 2 on four ranks equals --dp on two, to the bit: every
    used rank loads the same rows and sums over the same ranks."""
    dp_ranks = [r[dp] for r in runs["ranks"]] if dp == "scrub" \
        else _mesh_ranks(runs, dp)
    used = _mesh_ranks(runs, name)
    assert len(used) == len(dp_ranks)
    for r, (got, want) in enumerate(zip(used, dp_ranks)):
        assert got["acc"] == want["acc"], r
        for key in ("params", "swa", "importance"):
            if key not in want:
                continue
            for k, w in want[key].items():
                np.testing.assert_array_equal(got[key][k], w,
                                              err_msg=f"rank {r} {key} {k}")


def test_subworld_idle_ranks_leave_without_a_default_group_call(runs):
    """Ranks 2 and 3 of the --mesh_data 2 run are idle and leave; no
    collective of the used ranks' run goes over the default group once
    the groups are made (the idle ranks would never join it)."""
    assert len(_mesh_ranks(runs, "scrub_subworld", idle=True)) == 2
    for rank in runs["mesh_ranks"]:
        assert rank["scrub_subworld"]["default_group_calls"] == []
