"""Small modules of the port against the JAX package's: utils/meters
AverageMeter, utils/params param_summary, losses/classification
topk_accuracy (tied logits and the pad sentinel), the forget CLIs'
``params:`` line; utils/profiling.forward_throughput and the serving
bench tools/bench_inference on the CPU; utils/trees.tree_map over dicts
and lists."""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gslora_tpu.config as jc
from gslora_tpu.cli import train_forget as jax_forget
from gslora_tpu.cli import train_forget_cl as jax_forget_cl
from gslora_tpu.losses.classification import topk_accuracy as jax_topk
from gslora_tpu.models.vit import init_vit_params as jax_init
from gslora_tpu.utils.meters import AverageMeter as JaxMeter
from gslora_tpu.utils.params import param_summary as jax_summary

import gslora_tpu_torch.config as tc
from gslora_tpu_torch.cli import train_forget, train_forget_cl
from gslora_tpu_torch.losses.classification import top1_accuracy, \
    topk_accuracy
from gslora_tpu_torch.models.vit import init_vit_params, vit_apply
from gslora_tpu_torch.tools import bench_inference
from gslora_tpu_torch.utils.meters import AverageMeter
from gslora_tpu_torch.utils.params import count_params, param_summary
from gslora_tpu_torch.utils.profiling import forward_throughput
from gslora_tpu_torch.utils.trees import tree_map


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several processes on one machine: one intra-op
    thread per process keeps torch's idle threads off the others' cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


TINY = dict(image_size=16, patch_size=8, dim=32, depth=2, heads=2,
            dim_head=16, mlp_dim=64, num_class=8, dropout=0.0,
            emb_dropout=0.0, head_type="CosFace")


def test_average_meter_matches_jax():
    ours, ref = AverageMeter(), JaxMeter()
    for val, n in ((1.5, 1), (2.0, 4), (-0.25, 3), (7, 2)):
        ours.update(val, n)
        ref.update(val, n)
        assert (ours.val, ours.sum, ours.count, ours.avg) == \
            (ref.val, ref.sum, ref.count, ref.avg)
    ours.reset()
    assert (ours.val, ours.avg, ours.sum, ours.count) == (0.0, 0.0, 0.0, 0)


@pytest.mark.parametrize("rank,pos", [(0, "FFN"), (4, "FFN"),
                                      (8, "Attention")])
def test_param_summary_matches_jax(rank, pos):
    jp = jax_init(jax.random.key(0), jc.ViTConfig(**TINY),
                  jc.LoraConfig(rank=rank, pos=pos))
    tp = init_vit_params(torch.Generator().manual_seed(0),
                         tc.ViTConfig(**TINY), tc.LoraConfig(rank=rank,
                                                             pos=pos))
    assert param_summary(tp) == jax_summary(jp)
    assert count_params(tp["base"]) == param_summary(tp)["base"]


LOGITS = {
    # every row tied: the lower class index wins, as in jax.lax.top_k
    "ties": np.array([[1.0, 3.0, 3.0, 0.0, 3.0],
                      [2.0, 2.0, 2.0, 2.0, 2.0],
                      [0.0, 1.0, 1.0, 1.0, -1.0],
                      [5.0, 5.0, 4.0, 4.0, 4.0]], np.float32),
    "random": np.random.RandomState(0).randn(12, 7).astype(np.float32),
}
LABELS = {
    "ties": np.array([2, 3, 1, 0], np.int32),
    # the last two are pad sentinels, masked out of every k
    "random": np.array([0, 1, 2, 3, 4, 5, 6, 0, 1, 2, -1, -1], np.int32),
}


@pytest.mark.parametrize("case", sorted(LOGITS))
@pytest.mark.parametrize("topk", [(1,), (1, 2), (1, 3, 5), (2, 4)])
def test_topk_accuracy_matches_jax(case, topk):
    x, y = LOGITS[case], LABELS[case]
    want = [float(v) for v in jax_topk(jnp.asarray(x), jnp.asarray(y), topk)]
    got = [float(v) for v in topk_accuracy(torch.from_numpy(x),
                                           torch.from_numpy(y).long(), topk)]
    assert got == pytest.approx(want, abs=1e-5)
    if topk == (1,):
        assert float(top1_accuracy(torch.from_numpy(x),
                                   torch.from_numpy(y).long())) == \
            pytest.approx(want[0], abs=1e-5)


def test_forward_throughput_on_cpu():
    cfg, lora = tc.ViTConfig(**TINY), tc.LoraConfig(rank=4)
    params = init_vit_params(torch.Generator().manual_seed(0), cfg, lora)
    labels = torch.zeros(4, dtype=torch.long)

    def apply_fn(x):
        return vit_apply(params, x, labels, cfg, lora,
                         compute_dtype=torch.float32)[0]

    ips = forward_throughput(apply_fn, torch.randn(4, 3, 16, 16), iters=3)
    assert math.isfinite(ips) and ips > 0


class _Stop(Exception):
    pass


@pytest.mark.parametrize("cli", ["train_forget", "train_forget_cl"])
def test_forget_clis_print_the_params_line_as_jax(monkeypatch, capsys, cli):
    """Both packages' forget CLIs print ``params: {...}`` with the same
    counts for the same flags, before any training."""
    def stop(*args, **kwargs):
        raise _Stop

    out = {}
    for name, mod, C, extra in (
            ("jax", {"train_forget": jax_forget,
                     "train_forget_cl": jax_forget_cl}[cli], jc, []),
            ("torch", {"train_forget": train_forget,
                       "train_forget_cl": train_forget_cl}[cli], tc,
             ["--device", "cpu"])):
        orig = C.config_from_args

        def patched(args, orig=orig, C=C):
            cfg = orig(args)
            cfg.model = C.ViTConfig(**{**TINY, "depth": args.vit_depth})
            return cfg

        monkeypatch.setattr(mod, "config_from_args", patched)
        runner = "run_forget_training" if cli == "train_forget" else \
            "run_continual_forgetting"
        monkeypatch.setattr(mod, runner, stop)
        capsys.readouterr()
        with pytest.raises(_Stop):
            mod.main(["-d", "synthetic", "--vit_depth", "2", "--lora_rank",
                      "4", "-b", "8", "--one_stage", "--num_of_first_cls",
                      "6", "--per_forget_cls", "2"] + extra)
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("params: ")]
        assert len(lines) == 1, lines
        out[name] = json.loads(lines[0][len("params: "):])
    assert out["torch"] == out["jax"]
    assert out["torch"]["lora"] > 0


def test_bench_inference_smoke_on_cpu():
    """One point of the serving bench at ViT-P8S8's full width, two
    images, one forward: a positive rate, and no device metric from a
    CPU run."""
    points = bench_inference.main(["--device", "cpu", "--batches", "2",
                                   "--k", "1"])
    assert len(points) == 1
    p = points[0]
    assert p["model"] == "p8s8" and p["gemm_impl"] == "default"
    assert p["device"] == "cpu" and p["batch"] == 2
    assert p["images_per_sec"] > 0 and math.isfinite(p["ms_per_batch"])
    assert p["mfu"] is None and p["peak_mem_gb"] is None


def test_bench_inference_peaks_by_card():
    """mfu is against the card's own dense peak, int8 at twice bf16; an
    unknown card raises."""
    assert bench_inference.dense_peak("NVIDIA H100 80GB HBM3",
                                      "default") == 989e12
    assert bench_inference.dense_peak("NVIDIA H100 80GB HBM3",
                                      "int8") == 2 * 989e12
    assert bench_inference.dense_peak("NVIDIA H100 PCIe", "default") == \
        756e12
    with pytest.raises(RuntimeError, match="no published rates"):
        bench_inference.dense_peak("TPU v5 lite", "default")


def test_roc_plot_needs_no_matplotlib(monkeypatch):
    """The ROC artifact renders where matplotlib is missing (the machines
    with the card have none): a JPEG of the curve."""
    import io
    import sys

    from PIL import Image

    from gslora_tpu_torch.metrics.logging import gen_roc_plot
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    fpr = np.linspace(0, 1, 20)
    img = Image.open(io.BytesIO(gen_roc_plot(fpr, np.sqrt(fpr))))
    assert img.format == "JPEG" and img.size == (480, 480)


def test_tree_map_walks_dicts_and_lists():
    """tree_map keeps the structure of nested dicts and lists (an
    optimizer state's), leaves plain values to ``fn`` and refuses trees
    whose keys or lengths differ."""
    a = {"count": 2, "mu": [torch.ones(2), torch.zeros(3)], "lora": {}}
    b = {"count": 3, "mu": [torch.ones(2), torch.ones(3)], "lora": {}}
    got = tree_map(lambda x, y: x + y, a, b)
    assert got["count"] == 5 and got["lora"] == {}
    assert [t.tolist() for t in got["mu"]] == [[2.0, 2.0], [1.0, 1.0, 1.0]]
    with pytest.raises(ValueError, match="keys"):
        tree_map(lambda x, y: x, a, {**b, "nu": []})
    with pytest.raises(ValueError, match="leaves"):
        tree_map(lambda x, y: x, a, {**b, "mu": b["mu"][:1]})
