"""GS-LoRA's open-set recipes through the port's forget CLIs against the
JAX CLIs, on the same numpy-drawn weights and data (fp32, dropout 0):

- ``scripts/run_forget_open.sh``'s ``gs_lora`` arm: train_forget, rank-8
  FFN LoRA, BND 110, beta 0.1, alpha 0, data_ratio 0.1, open classes
  scored after training and never trained on;
- its ``full`` arm: train_forget with ``--lora_rank 0`` at lr 1e-4, every
  parameter trained under the bounded forget loss (the patch embedding
  too, so block 0's attention backward runs);
- ``scripts/run_cl_forget_open.sh``: train_forget_cl --one_stage
  (GS-LoRA++), the open classes at the order list's front, BND 105, the
  per-task beta list, the alpha warm-up (``--warmup_alpha --big_alpha``)
  and prototypes.

The tier-1 cases run the tiny model of tests/torch_baselines_setup.py
(16 px, dim 32, depth 2) over 20 synthetic classes, at batch 8 for 2
epochs, with each recipe's class windows scaled from 100 classes to 20
(70 / 30 / 40 -> 14 / 6 / 8; 80 / 20 / 10 -> 16 / 4 / 2, 2 tasks) and
``--alpha_epoch`` cut from 30 to 1, so the continual run trains an epoch
in each alpha regime. The merge boundary's LoRA reinit draws one numpy
draw in both packages (torch_integration_setup.patch_reinit).

The slow test holds run_cl_forget_open.sh's recipe at the flagship's
widths (112 px, patch 8, dim 512, depth 6, 8 heads x 64, mlp 2048,
CosFace over 100 classes) for 2 tasks of 1 epoch, from the JAX seed-0
init (its LoRA's B = 0) whose CosFace head holds the port's fp32
embeddings of each class's mean training image (a nearest-class-mean
head), over the CLIs' own
synthetic set (20 training images a class, 2 of them drawn by data_ratio
0.1; 5 test images a class):

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_open_recipes.py \\
        -m slow -s

Tolerances: reports equal under torch_baselines_setup.assert_reports_match
(the same predictions; H-means to 1e-6), open_acc present; trained
parameters and task snapshots within 5e-3 relative (as
tests/test_training_parity.py). At the flagship every per-task accuracy
and H-mean within 5e-5 (equal to 4 decimals), and the task snapshots as
above: the recipe's first epoch at lr 1e-2 moves the features away from
the nearest-class-mean head, whose CosFace margin then takes every
prediction, so both packages read 0.0 after training there and the
snapshots carry the comparison."""
import numpy as np
import pytest
import torch

import gslora_tpu.cli.train_forget as jsingle
import gslora_tpu.cli.train_forget_cl as jcl

import gslora_tpu_torch.cli.train_forget as tsingle
import gslora_tpu_torch.cli.train_forget_cl as tcl
from gslora_tpu_torch.models.convert import flatten_tree

from torch_baselines_setup import (MODEL, assert_reports_match,
                                   assert_trees_close, np_tree,
                                   one_torch_thread, run_both_clis,
                                   to_numpy)
from torch_integration_setup import patch_reinit

# the tier-1 cases share the machine with the suite's other workers; the
# slow test takes every core
one_thread = pytest.fixture(one_torch_thread)

TINY = {**MODEL, "num_class": 20, "head_type": "CosFace"}
TINY_RUN = ["-d", "synthetic", "-n", "VIT", "--vit_depth", "2", "-b", "8",
            "-e", "2", "--compute_dtype", "float32"]
# scripts/run_forget_open.sh (both arms), its windows at 20 classes
FORGET_OPEN = ["--head", "CosFace", "--group_type", "block",
               "--data_ratio", "0.1", "--alpha_epoch", "0",
               "--open_cls_num", "8", "--warmup-epochs", "0",
               "--decay-epochs", "100", "--num_of_first_cls", "14",
               "--per_forget_cls", "6", "--min-lr", "1e-5"]
GS_LORA_OPEN = FORGET_OPEN + ["--lr", "1e-2", "--lora_rank", "8",
                              "--BND", "110", "--beta", "0.1",
                              "--alpha", "0"]
FULL_OPEN = FORGET_OPEN + ["--lr", "1e-4", "--lora_rank", "0"]
# scripts/run_cl_forget_open.sh, its windows at 20 classes and 2 tasks
CL_OPEN = ["--one_stage", "--head", "CosFace", "--warmup-epochs", "0",
           "--lr", "1e-2", "--lora_rank", "8", "--decay-epochs", "100",
           "--num_of_first_cls", "16", "--per_forget_cls", "4",
           "--num_tasks", "2", "--open_cls_num", "2", "--BND", "105",
           "--cl_beta_list", "0.14", "0.14", "0.2", "0.15",
           "--warmup_alpha", "--big_alpha", "0.015", "--alpha_epoch", "1",
           "--min-lr", "1e-5", "--prototype", "--pro_f_weight", "0.0003",
           "--pro_r_weight", "0"]


def start_tree(model, rank, seed=0, nonzero_b=True):
    """The JAX init of ``seed`` (numpy leaves), with a nonzero LoRA B
    (``nonzero_b``), so every LoRA factor gets a gradient from the first
    step."""
    tree = np_tree(seed, rank=rank, model=model)
    if not nonzero_b:
        return tree
    rng = np.random.RandomState(seed + 1)
    for name, b in tree["lora"].get("ffn", {}).items():
        if name.startswith("B"):
            tree["lora"]["ffn"][name] = (0.05 * rng.randn(*b.shape)) \
                .astype(np.float32)
    return tree


def patch_clis(monkeypatch, model, tree, *modules):
    """Each CLI's config gets ``model`` (a dict of ViTConfig fields), its
    build_params ``tree`` (numpy leaves) in its package's form."""
    import gslora_tpu.config as jc
    import gslora_tpu_torch.config as tc
    from gslora_tpu_torch.models.convert import params_from_jax

    from torch_baselines_setup import to_jax

    for module in modules:
        jax_side = module.__name__.startswith("gslora_tpu.")
        C = jc if jax_side else tc
        orig = C.config_from_args

        def patched(args, orig=orig, C=C):
            cfg = orig(args)
            cfg.model = C.ViTConfig(**model)
            return cfg

        def build(cfg, seed=None, jax_side=jax_side):
            return to_jax(tree) if jax_side else params_from_jax(tree)

        monkeypatch.setattr(module, "config_from_args", patched)
        monkeypatch.setattr(module, "build_params", build)


def final_params(monkeypatch, *modules):
    """The trained parameters each single-step CLI's run_forget_training
    ends with, by package ("gslora_tpu" / "gslora_tpu_torch")."""
    got = {}
    for module in modules:
        run = module.run_forget_training

        def spy(*args, run=run, pkg=module.__name__.split(".")[0], **kw):
            res = run(*args, **kw)
            got[pkg] = to_numpy(res.state.params)
            return res

        monkeypatch.setattr(module, "run_forget_training", spy)
    return got


def class_mean_cosface(model, argv, rank, nonzero_b=True):
    """:func:`start_tree` of ``model`` and ``rank`` whose CosFace head rows
    are the port's fp32 embeddings of each class's mean training image of
    the CLI's synthetic set, less their mean m, and whose post-LN bias
    takes m off every embedding: a nearest-class-mean head, so the
    recipes start from a model that tells classes apart."""
    import gslora_tpu_torch.config as tc
    from gslora_tpu_torch.cli.common import build_datasets
    from gslora_tpu_torch.models.convert import params_from_jax, \
        params_to_jax
    from gslora_tpu_torch.models.vit import vit_embed

    cfg = tc.config_from_args(tc.build_parser().parse_args(argv))
    cfg.model = tc.ViTConfig(**model)
    train, _ = build_datasets(cfg)
    params = params_from_jax(start_tree(model, rank, nonzero_b=nonzero_b))
    labels = np.asarray(train.targets)
    means = np.stack([train.decode_batch(np.flatnonzero(labels == c))
                      .mean(0) for c in range(model["num_class"])])
    with torch.no_grad():
        mu = vit_embed(params, torch.from_numpy(means), cfg.model,
                       tc.LoraConfig(rank), compute_dtype=torch.float32)
    m = mu.mean(0)
    # the post-LN bias centres every embedding on the class means' mean:
    # the head scores cos(e - m, mu_c - m)
    params["base"]["head_ln"]["bias"] = params["base"]["head_ln"]["bias"] - m
    params["base"]["head"] = {"weight": mu - m}
    return to_numpy(params_to_jax(params))


def assert_open_reports_match(got, want, points=None):
    """Per-task reports of GS-LoRA: the LoRA group norms (``norm_list``)
    to the trained parameters' 5e-3, the wall (``time_to_forget_s``) not
    compared, the rest as torch_baselines_setup.assert_reports_match
    holds it, or, with ``points``, every number within ``points``."""
    got, want = [dict(r) for r in got], [dict(r) for r in want]
    for g, w in zip(got, want):
        for r in (g, w):
            r.pop("time_to_forget_s", None)
        np.testing.assert_allclose(g.pop("norm_list"), w.pop("norm_list"),
                                   rtol=5e-3, err_msg=str(w["task"]))
    if points is None:
        assert_reports_match(got, want)
        return
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k, v in w.items():
            assert (g[k] is None) == (v is None), (w["task"], k)
            if v is not None:
                assert abs(g[k] - v) <= points, (w["task"], k, g[k], v)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("arm", ["gs_lora", "full"])
def test_forget_open_recipe_matches_jax(arm, monkeypatch, tmp_path):
    """run_forget_open.sh through train_forget: the same report (open_acc
    scored), the same trained LoRA (gs_lora) or whole model (full)."""
    rank = 8 if arm == "gs_lora" else 0
    argv = TINY_RUN + (GS_LORA_OPEN if arm == "gs_lora" else FULL_OPEN)
    tree = class_mean_cosface(TINY, argv, rank)
    patch_clis(monkeypatch, TINY, tree, jsingle, tsingle)
    params = final_params(monkeypatch, jsingle, tsingle)
    runs = run_both_clis(jsingle, tsingle, argv, tmp_path, tasks=0)
    (jrep, _), (trep, _) = runs["jax"], runs["torch"]
    print(f"{arm}, port / JAX:", trep, jrep)
    assert trep["open_acc"] is not None
    assert len(trep["norm_list"]) == (2 if rank else 0)
    assert_open_reports_match([{"task": 0, **trep}], [{"task": 0, **jrep}])
    got, want = params["gslora_tpu_torch"], params["gslora_tpu"]
    trained = "lora" if rank else "base"
    start = flatten_tree(tree[trained])
    end = flatten_tree(got[trained])
    assert all(not np.array_equal(end[k], v) for k, v in start.items()
               if k.startswith(("ffn", "blocks.qkv")))
    assert_trees_close(got, want, what=f"{arm} final parameters")


@pytest.mark.usefixtures("one_thread")
def test_cl_forget_open_recipe_matches_jax(monkeypatch, tmp_path):
    """run_cl_forget_open.sh through train_forget_cl --one_stage: the same
    per-task reports (open_acc of each task) and task snapshots."""
    patch_reinit(monkeypatch)
    argv = TINY_RUN + CL_OPEN
    patch_clis(monkeypatch, TINY, class_mean_cosface(TINY, argv, 8), jcl,
               tcl)
    runs = run_both_clis(jcl, tcl, argv, tmp_path)
    (jrep, jsnaps), (trep, tsnaps) = runs["jax"], runs["torch"]
    print("continual, port / JAX:", trep, jrep)
    assert [r["task"] for r in trep] == [0, 1]
    assert all(r["open_acc"] is not None for r in trep)
    assert_open_reports_match(trep, jrep)
    for t, (got, want) in enumerate(zip(tsnaps, jsnaps)):
        assert_trees_close(got, want, what=f"task {t}")


FLAGSHIP = dict(image_size=112, patch_size=8, dim=512, depth=6, heads=8,
                dim_head=64, mlp_dim=2048, num_class=100, dropout=0.0,
                emb_dropout=0.0, head_type="CosFace")
FLAGSHIP_RUN = ["-d", "synthetic", "-n", "VIT", "--vit_depth", "6", "-b",
                "48", "-e", "1", "--compute_dtype", "float32"]
# scripts/run_cl_forget_open.sh at its own windows, cut to 2 tasks of 1
# epoch (the alpha warm-up's epoch 30 is never reached)
FLAGSHIP_CL_OPEN = ["--one_stage", "--head", "CosFace", "--warmup-epochs",
                    "0", "--lr", "1e-2", "--lora_rank", "8",
                    "--decay-epochs", "100", "--num_of_first_cls", "80",
                    "--per_forget_cls", "20", "--num_tasks", "2",
                    "--open_cls_num", "10", "--BND", "105",
                    "--cl_beta_list", "0.14", "0.14", "0.2", "0.15",
                    "--warmup_alpha", "--big_alpha", "0.015",
                    "--alpha_epoch", "30", "--min-lr", "1e-5",
                    "--prototype", "--pro_f_weight", "0.0003",
                    "--pro_r_weight", "0"]


@pytest.mark.slow
def test_flagship_cl_forget_open_matches_jax(monkeypatch, tmp_path):
    """run_cl_forget_open.sh's GS-LoRA++ at the flagship's widths, 2 tasks
    of 1 epoch: every per-task accuracy and H-mean equal to 4 decimals,
    the task snapshots within 5e-3. From this untrained base only the
    forget accuracy before training and the parameters carry the
    comparison: every accuracy after training reads 0.0 in both."""
    patch_reinit(monkeypatch)
    argv = FLAGSHIP_RUN + FLAGSHIP_CL_OPEN
    # the LoRA as initialised (B = 0): the run starts from the base
    patch_clis(monkeypatch, FLAGSHIP, class_mean_cosface(
        FLAGSHIP, argv, 8, nonzero_b=False), jcl, tcl)
    runs = run_both_clis(jcl, tcl, argv, tmp_path)
    (jrep, jsnaps), (trep, tsnaps) = runs["jax"], runs["torch"]
    print("flagship open-set continual, port / JAX:", trep, jrep)
    assert [r["task"] for r in trep] == [r["task"] for r in jrep] == [0, 1]
    assert all(r["open_acc"] is not None for r in trep)
    assert_open_reports_match(trep, jrep, points=5e-5)
    for t, (got, want) in enumerate(zip(tsnaps, jsnaps)):
        assert_trees_close(got, want, what=f"task {t}")
