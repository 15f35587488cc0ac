"""The port's eval CLIs (gslora_tpu_torch/cli/test_model.py,
cli/backbone_probe.py) against the JAX package's on the CPU: test_model on
one tiny checkpoint that the JAX train_pretrain wrote (a .msgpack), in
fp32, W8A8 int8 and with pair verification; backbone_probe from one
numpy-drawn tree patched into both CLIs; and both forget CLIs refusing to
train in int8 with the same ValueError."""
import io
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

from gslora_tpu.cli import backbone_probe as jax_probe
from gslora_tpu.cli import test_model as jax_test_model
from gslora_tpu.cli import train_forget as jax_forget
from gslora_tpu.cli import train_forget_cl as jax_forget_cl
from gslora_tpu.cli import train_pretrain as jax_pretrain

from gslora_tpu_torch.cli import backbone_probe, test_model, train_forget, \
    train_forget_cl
from gslora_tpu_torch.ops import attention as A
from torch_baselines_setup import (PARAM_ATOL, PARAM_RTOL,
                                   one_torch_thread, patch_clis, to_numpy)

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)

TINY = dict(image_size=16, patch_size=8, dim=32, heads=2, dim_head=16,
            mlp_dim=64, num_class=8, dropout=0.0, emb_dropout=0.0)
ARGS = ["-d", "synthetic", "-n", "VIT", "--vit_depth", "2", "--head",
        "Softmax", "--lora_rank", "4", "-b", "8", "--seed", "1337",
        "--compute_dtype", "float32"]


def _tiny(C):
    orig = C.config_from_args

    def patched(args):
        cfg = orig(args)
        cfg.model = C.ViTConfig(**TINY, depth=args.vit_depth,
                                head_type=args.head,
                                gemm_impl=args.gemm_impl)
        return cfg

    return patched


@pytest.fixture
def tiny_clis(monkeypatch):
    """Every CLI module of both packages builds the tiny model."""
    import gslora_tpu.config as jc
    import gslora_tpu_torch.config as tc
    for mod in (jax_pretrain, jax_test_model, jax_forget, jax_forget_cl):
        monkeypatch.setattr(mod, "config_from_args", _tiny(jc))
    for mod in (test_model, train_forget, train_forget_cl):
        monkeypatch.setattr(mod, "config_from_args", _tiny(tc))


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A .msgpack from the JAX pretrain CLI (2 epochs, 8 classes): its
    batch-20 and batch-40 evals save; the last one is taken."""
    import gslora_tpu.config as jc
    out = tmp_path_factory.mktemp("pretrain")
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_pretrain, "config_from_args", _tiny(jc))
    try:
        jax_pretrain.main(ARGS + ["-e", "2", "--lr", "3e-3", "--outdir",
                                  str(out)])
    finally:
        mp.undo()
    ckpts = sorted(out.glob("*.msgpack"))
    assert ckpts
    return str(ckpts[-1])


def _lfw(root, pairs=12, seed=7):
    """A pair-verification .bin as tests/test_cli.py builds one: JPEG
    bytes of 2 * pairs random 16x16 images, alternating same/different."""
    rng = np.random.RandomState(seed)
    bins = []
    for _ in range(2 * pairs):
        img = Image.fromarray((rng.rand(16, 16, 3) * 255).astype(np.uint8))
        buf = io.BytesIO()
        img.save(buf, format="JPEG")
        bins.append(buf.getvalue())
    with open(root / "lfw.bin", "wb") as f:
        pickle.dump((bins, [True, False] * (pairs // 2)), f)


def _both(argv, tmp_path):
    out = {}
    for name, mod, extra in (("jax", jax_test_model, []),
                             ("torch", test_model, ["--device", "cpu"])):
        out[name] = mod.main(argv + ["--outdir", str(tmp_path / name)] +
                             extra)
    return out["jax"], out["torch"]


def test_test_model_matches_jax(tiny_clis, jax_checkpoint, tmp_path):
    """fp32: the same overall and per-class accuracy from the JAX
    checkpoint; the port writes the same files."""
    argv = ARGS + ["-r", jax_checkpoint]
    want, got = _both(argv, tmp_path)
    assert got == want
    assert got["num_samples"] == 40 and got["test_acc"] > 100 / 8
    for f in ("class_accuracy.txt", "report.json"):
        assert (tmp_path / "torch" / f).read_text() == \
            (tmp_path / "jax" / f).read_text()


def test_test_model_int8_matches_jax(tiny_clis, jax_checkpoint, tmp_path):
    """--gemm_impl int8: the two packages' predictions differ in at most
    one test image (a rounding tie at quantization can flip one), and
    each stays within 2 points of its own fp32 eval (the bound of the JAX
    package's tests/test_cli.py)."""
    argv = ARGS + ["-r", jax_checkpoint]
    j32, t32 = _both(argv, tmp_path / "fp32")
    j8, t8 = _both(argv + ["--gemm_impl", "int8"], tmp_path / "int8")
    n = t8["num_samples"]
    assert abs(t8["test_acc"] - j8["test_acc"]) * n / 100 <= 1 + 1e-9
    assert abs(t8["test_acc"] - t32["test_acc"]) <= 2.0
    assert abs(j8["test_acc"] - j32["test_acc"]) <= 2.0


def test_test_model_verification_matches_jax(tiny_clis, jax_checkpoint,
                                             tmp_path):
    """--ver_targets lfw: the same verification accuracy, the ROC artifact
    written; a target without a .bin warns."""
    _lfw(tmp_path)
    argv = ARGS + ["-r", jax_checkpoint, "--data_root", str(tmp_path),
                   "--ver_targets", "lfw,cfp_fp"]
    with pytest.warns(UserWarning, match="cfp_fp"):
        want = jax_test_model.main(argv + ["--outdir",
                                           str(tmp_path / "jax")])
    with pytest.warns(UserWarning, match="cfp_fp"):
        got = test_model.main(argv + ["--outdir", str(tmp_path / "torch"),
                                      "--device", "cpu"])
    assert np.isfinite(got["lfw_verification_acc"])
    assert abs(got["lfw_verification_acc"] -
               want["lfw_verification_acc"]) <= 1e-9
    assert got["test_acc"] == want["test_acc"]
    assert list((tmp_path / "torch").glob("lfw_ROC_Curve*.jpg"))


def test_backbone_probe_matches_jax(monkeypatch, tmp_path):
    """The head-only probe from one numpy tree in both CLIs: equal
    accuracy curves, head weights within 5e-3, the backbone unchanged, and
    no attention backward at all (nothing upstream of the head trains)."""
    patch_clis(monkeypatch, jax_probe, backbone_probe)
    calls = []
    plain_bwd = A.attention_bwd_plain

    def counted(*args, **kwargs):
        calls.append(1)
        return plain_bwd(*args, **kwargs)

    monkeypatch.setattr(A, "attention_bwd_plain", counted)
    argv = ["-d", "synthetic", "--vit_depth", "2", "--head", "Softmax",
            "--lora_rank", "0", "-b", "8", "-e", "2", "--lr", "1e-2",
            "--warmup-epochs", "0", "--num_of_first_cls", "6",
            "--per_forget_cls", "2", "--compute_dtype", "float32"]
    heads = {}
    reports = {}
    for name, mod, extra in (("jax", jax_probe, []),
                             ("torch", backbone_probe, ["--device", "cpu"])):
        states = []
        if name == "torch":
            real = backbone_probe.PretrainState.create

            def keep(*a, real=real, **k):
                states.append(real(*a, **k))
                return states[-1]

            monkeypatch.setattr(backbone_probe.PretrainState, "create",
                                keep)
        else:
            real_step = jax_probe.make_head_only_step

            def keep_step(*a, real=real_step, **k):
                step = real(*a, **k)

                def wrapped(state, *sa):
                    state, acc = step(state, *sa)
                    states[:] = [state]
                    return state, acc

                return wrapped

            monkeypatch.setattr(jax_probe, "make_head_only_step", keep_step)
        reports[name] = mod.main(argv + ["--outdir", str(tmp_path / name)] +
                                 extra)
        heads[name] = to_numpy(states[-1].params["base"]["head"])
    want, got = reports["jax"], reports["torch"]
    assert got == want
    assert got["backbone_frozen"] and got["head_trained"]
    assert len(got["forget_acc_curve"]) == 2
    np.testing.assert_array_equal(
        np.load(tmp_path / "torch" / "remain_acc_curve.npy"),
        np.asarray(got["remain_acc_curve"]))
    for k in heads["jax"]:
        np.testing.assert_allclose(heads["torch"][k], heads["jax"][k],
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL)
    assert not calls


@pytest.mark.parametrize("package", ["jax", "torch"])
@pytest.mark.parametrize("cli", ["train_forget", "train_forget_cl"])
def test_forget_clis_refuse_to_train_in_int8(tiny_clis, tmp_path, package,
                                             cli):
    """--gemm_impl int8 is eval and serving only: both packages' forget
    CLIs raise the model's ValueError at the first training step."""
    mods = {("jax", "train_forget"): (jax_forget, []),
            ("jax", "train_forget_cl"): (jax_forget_cl, ["--one_stage"]),
            ("torch", "train_forget"): (train_forget, ["--device", "cpu"]),
            ("torch", "train_forget_cl"): (train_forget_cl,
                                           ["--one_stage", "--device",
                                            "cpu"])}
    mod, extra = mods[(package, cli)]
    argv = ARGS + ["-e", "1", "--lr", "1e-3", "--num_of_first_cls", "6",
                   "--per_forget_cls", "2", "--num_tasks", "1",
                   "--gemm_impl", "int8", "--outdir", str(tmp_path)] + extra
    with pytest.raises(ValueError, match="inference/serving"):
        mod.main(argv)


@pytest.mark.parametrize("mod", [test_model, backbone_probe],
                         ids=["test_model", "backbone_probe"])
def test_eval_clis_need_the_card_unless_told(monkeypatch, tmp_path, mod):
    """Asked for the card where none is visible, each eval CLI raises
    rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        mod.main(ARGS + ["--outdir", str(tmp_path)])
