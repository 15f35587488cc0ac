"""The teacher-student baselines under the port's data parallelism
(gslora_tpu_torch/baselines/{distill,scrub,lirf}.py with a
parallel/mesh.DataMesh): two gloo ranks on the CPU
(tests/torch_dp_baselines_worker.py, spawned once for the module) run
DER++ (a raw SUM term and a second remain batch from the cycler), SCRUB
(max and min passes, SWA distance 0.1) and LIRF (the student's low half
through the teacher's upper half), on the padded global batches of
tests/test_torch_parallel_baselines.py, and are held, as there, to the
JAX runners on a 2-device CPU mesh (rtol 1e-4, atol 1e-5, accuracies
within 1e-3) and to the port's one process with ``--grad_accum 2``
(equal to the bit: the same rows, shapes and fp32 sum order)."""
import numpy as np
import pytest

import torch_dp_baselines_worker as W
from gslora_tpu_torch.models.convert import flatten_tree
from torch_baselines_setup import one_torch_thread

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)

NAMES = ["distill_der_plus", "scrub", "lirf"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return W.family_runs(tmp_path_factory.mktemp("dp_distill"), NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_two_ranks_equal_the_jax_mesh_run(runs, name):
    """Each rank's final student (and SCRUB's SWA model) to rtol 1e-4 /
    atol 1e-5, the accuracies and best H to 1e-3."""
    W.check_against_jax(runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_two_ranks_equal_one_process_with_grad_accum_2(runs, name):
    W.check_against_one_process(runs, name)


def test_the_runs_move(runs):
    """The comparisons see real change: each family's forget accuracy
    falls from where the pretrained tree starts it, and DER++'s and
    SCRUB's students leave it."""
    one = runs["one"]
    for name in NAMES:
        first = one[name]["acc"][0]
        assert first["forget_acc_before"] > first["forget_acc"], name
    start = flatten_tree(runs["trees"]["p"])
    for name in ("distill_der_plus", "scrub"):
        moved = one[name]["params"]
        assert max(float(np.abs(moved[k] - start[k]).max())
                   for k in moved) > 1e-3, name
