"""The baseline dispatch of the port's forget CLIs
(gslora_tpu_torch/cli/train_forget.run_single_step_baseline and
cli/train_forget_cl.run_baseline_continual) against the JAX CLIs on the
same numpy-drawn weights and data (fp32, dropout 0): the single-step
reg family, a continual baseline with open-set windows, and Retrain's
skipped resume. Each method's two-task continual run against the JAX CLI
lives with its family (tests/test_torch_baselines_{reg,distill,
scrub_lirf}.py).

Tolerances: task snapshots 5e-3 relative (as
tests/test_training_parity.py), accuracies equal (the same
predictions)."""
import json

import pytest

import gslora_tpu.cli.train_forget as jsingle
import gslora_tpu.cli.train_forget_cl as jcl

import gslora_tpu_torch.cli.train_forget as tsingle
import gslora_tpu_torch.cli.train_forget_cl as tcl

from torch_baselines_setup import (CL_ARGS, assert_reports_match,
                                   assert_trees_close, np_tree_torch,
                                   one_torch_thread, patch_clis,
                                   run_both_clis)

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)

SINGLE_ARGS = ["-d", "synthetic", "--vit_depth", "2", "--head", "Softmax",
               "--lora_rank", "0", "-b", "8", "-e", "2", "--lr", "1e-3",
               "--warmup-epochs", "0", "--num_of_first_cls", "6",
               "--per_forget_cls", "2", "--few_shot", "--few_shot_num", "4",
               "--compute_dtype", "float32", "--ewc_lambda", "50",
               "--mas_lambda", "50", "--l2_lambda", "50"]


@pytest.mark.parametrize("flag", ["--ewc", "--retrain", "--MAS", "--l2"])
def test_single_step_cli_matches_jax(flag, monkeypatch, tmp_path):
    """train_forget without --one_stage: Retrain trains a fresh model on
    remain; L2, EWC and MAS train on relabeled forget + remain, anchored
    at the start with the importance over the full first window."""
    patch_clis(monkeypatch, jsingle, tsingle)
    reports = {}
    for name, mod, extra in (("jax", jsingle, []),
                             ("torch", tsingle, ["--device", "cpu"])):
        out = tmp_path / name
        reports[name] = mod.main(SINGLE_ARGS + [flag, "--outdir", str(out)]
                                 + extra)
        assert json.loads((out / "report.json").read_text()) == \
            json.loads(json.dumps(reports[name]))
    assert reports["torch"]["norm_list"] is None
    assert_reports_match([reports["torch"]], [reports["jax"]])


def test_single_step_retrain_skips_the_resume(monkeypatch, tmp_path):
    """The reference skips -r under --retrain (train_own_forget_open.py:
    642): a checkpoint path that does not exist is never read."""
    patch_clis(monkeypatch, tsingle)

    def build(cfg, seed=None):
        assert not cfg.resume, "a resume was read"
        return np_tree_torch()

    monkeypatch.setattr(tsingle, "build_params", build)
    report = tsingle.main(SINGLE_ARGS + [
        "--retrain", "-r", str(tmp_path / "missing.pth"), "--device", "cpu",
        "--outdir", str(tmp_path)])
    assert report["forget_acc_before"] >= 0


def test_cl_cli_open_set_matches_jax(monkeypatch, tmp_path):
    """Continual DER++ with two open classes at the order list's front,
    never trained on, scored after every task."""
    patch_clis(monkeypatch, jcl, tcl)
    runs = run_both_clis(jcl, tcl, CL_ARGS + ["--DER_plus", "--open_cls_num",
                                              "2"], tmp_path)
    (jrep, jsnaps), (trep, tsnaps) = runs["jax"], runs["torch"]
    assert all(r["open_acc"] is not None for r in trep)
    assert_reports_match(trep, jrep)
    for t, (got, want) in enumerate(zip(tsnaps, jsnaps)):
        assert_trees_close(got, want, what=f"task {t}")
