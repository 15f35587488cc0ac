"""The port's continual baseline integration tool (gslora_tpu_torch/
tools/integration_baselines_cl.py) against the JAX package's composition
of scripts/integration_baselines_cl.py (tests/torch_integration_setup.py):
each of the eleven rows of its RECIPES for 2 tasks, with the method's
state across the tasks, from one base, at the scripts' tiny model and
data, fp32, dropout 0, every epoch count cut to 1.

Tolerances: accuracies equal (the same predictions, to float rounding),
best H-means to 1e-6. Every run takes the scripts' batch of 48 (the CL
script's --tiny batch of 8 would give SCRUB 840 steps a task)."""
import json

import numpy as np
import pytest

import gslora_tpu.cli.train_forget_cl as jcl
import gslora_tpu.config as jc
import gslora_tpu_torch.cli.train_forget_cl as tcl
import gslora_tpu_torch.config as tc
from gslora_tpu_torch.models.convert import params_from_jax
from gslora_tpu_torch.tools import integration_baselines as B
from gslora_tpu_torch.tools import integration_baselines_cl as CL

from torch_baselines_setup import assert_reports_match, np_tree, \
    one_torch_thread
from torch_integration_setup import (TINY, assert_close,
                                     jax_continual_baselines, jax_tree,
                                     stand_in, tiny_model, trained_base)

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)

NOISE = 2.4  # the unsaturated stand-in


@pytest.fixture(scope="module")
def setup():
    return {"base": trained_base("Softmax", NOISE),
            "jax": stand_in("jax", NOISE), "torch": stand_in("torch", NOISE)}


@pytest.fixture
def one_fresh_init(monkeypatch):
    """Retrain's fresh start of each task, the JAX init of the seed the
    runner asks for, in both packages (their generators draw different
    numbers)."""
    def build(jax_side):
        def fresh(cfg, seed=None):
            tree = np_tree(seed, rank=8,
                           model={**TINY, "head_type": "Softmax"})
            return jax_tree(tree) if jax_side else params_from_jax(tree)
        return fresh

    monkeypatch.setattr(jcl, "build_params", build(True))
    monkeypatch.setattr(tcl, "build_params", build(False))


@pytest.mark.parametrize("method", list(CL.RECIPES))
def test_continual_baselines_match_jax(setup, tmp_path, one_fresh_init,
                                       method):
    """One method for 2 tasks: every task's results as the JAX
    composition's, and the report's keys the script's."""
    pre, want = jax_continual_baselines([method], jax_tree(setup["base"]),
                                        *setup["jax"], tiny_model(jc),
                                        48, 2, 1)
    out = tmp_path / "cl.json"
    report = CL.run([method], params_from_jax(setup["base"]),
                    *setup["torch"], tiny_model(tc), 48, "cpu", 2,
                    recipes=B.with_epochs(CL.RECIPES, 1),
                    compute_dtype="float32", out=str(out))
    assert json.loads(out.read_text()) == json.loads(json.dumps(report))
    assert set(report) == {"pretrain_test_acc", "num_tasks",
                           "total_wallclock_s", method}
    assert report["num_tasks"] == 2
    assert_close(report["pretrain_test_acc"], pre, "pretrain")
    assert set(report[method]) == {"tasks", "wallclock_s"}
    assert_reports_match(report[method]["tasks"], want[method])
    # the base tells the classes apart, so the runs have something to
    # forget
    assert pre > 10.0
    assert np.isfinite([t["best_h"] for t in report[method]["tasks"]]).all()
