"""The port's training loop and CLI (gslora_tpu_torch/engine/loop.py,
cli/train_forget.py): one epoch of ``run_forget_training`` against the JAX
package's on the same converted weights and data, and the CLI end to end
on the CPU."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gslora_tpu.config as jc
from gslora_tpu.data.splits import split_by_class_window as jax_split
from gslora_tpu.data.synthetic import synthetic_face_dataset as jax_synth
from gslora_tpu.engine.loop import ForgetData as JaxData
from gslora_tpu.engine.loop import run_forget_training as jax_run
from gslora_tpu.models.vit import init_vit_params as jax_init

import gslora_tpu_torch.config as tc
from gslora_tpu_torch.data.splits import make_order_list, \
    split_by_class_window
from gslora_tpu_torch.data.synthetic import synthetic_face_dataset
from gslora_tpu_torch.engine.loop import ForgetData, resolve_device, \
    run_forget_training
from gslora_tpu_torch.models.convert import flatten_tree, params_from_jax


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several processes on one machine: one intra-op
    thread per process keeps torch's idle threads off the others' cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


MODEL = dict(image_size=16, patch_size=8, dim=32, depth=2, heads=2,
             dim_head=16, mlp_dim=64, num_class=6, dropout=0.0,
             emb_dropout=0.0, head_type="CosFace")


def _run_config(C, fkw=(), epochs=1, **extra):
    return C.RunConfig(
        model=C.ViTConfig(**MODEL), lora=C.LoraConfig(rank=4),
        optim=C.OptimConfig(lr=1e-2, warmup_epochs=0, epochs=epochs),
        forget=C.ForgetConfig(bnd=10.0, beta=0.3, alpha=5e-4, alpha_epoch=0,
                              prototype=True, pro_f_weight=0.01,
                              pro_r_weight=0.01, **dict(fkw)),
        data=C.DataConfig(batch_size=8, data_mode="synthetic"),
        num_epoch=epochs, ver_freq=3, disp_freq=1, compute_dtype="float32",
        **extra)


class _Recorder:
    def __init__(self):
        self.records = []

    def log(self, metrics, step=None):
        self.records.append((step, dict(metrics)))

    def losses(self):
        return [float(m["loss_total"]) for _, m in self.records
                if "loss_total" in m]


def _data(synth, split, Data):
    train = synth(num_classes=6, per_class=10, image_size=16, seed=0,
                  noise=1.0)
    test = synth(num_classes=6, per_class=4, image_size=16, seed=1,
                 noise=1.0)
    order = make_order_list(6, seed=1337)
    remain_tr, forget_tr = split(train, order, 0, 4, 4, 6)
    remain_te, forget_te = split(test, order, 0, 4, 4, 6)
    return Data(train_forget=forget_tr, train_remain=remain_tr,
                test_forget=forget_te, test_remain=remain_te)


def _jax_params():
    p = jax_init(jax.random.key(0), jc.ViTConfig(**MODEL), jc.LoraConfig(4))
    rng = np.random.RandomState(1)
    for name in ("B1", "B2"):
        p["lora"]["ffn"][name] = jnp.asarray(
            0.05 * rng.randn(*p["lora"]["ffn"][name].shape)
            .astype(np.float32))
    return jax.tree.map(np.asarray, p)


def test_one_epoch_matches_jax_loop():
    p = _jax_params()
    jrec, trec = _Recorder(), _Recorder()
    jres = jax_run(_run_config(jc), jax.tree.map(jnp.asarray, p),
                   _data(jax_synth, jax_split, JaxData), logger=jrec)
    tres = run_forget_training(_run_config(tc, device="cpu"),
                               params_from_jax(p),
                               _data(synthetic_face_dataset,
                                     split_by_class_window, ForgetData),
                               logger=trec)

    jl, tl = jrec.losses(), trec.losses()
    assert len(tl) == len(jl) == 5  # 40 remain images / 8 per batch
    np.testing.assert_allclose(tl, jl, rtol=1e-3, atol=1e-3)
    for key in ("forget_acc_before", "forget_acc", "remain_acc", "best_h"):
        assert getattr(tres, key) == pytest.approx(getattr(jres, key),
                                                   abs=1e-6), key
    assert len(tres.history) == len(jres.history) == 2  # batch 3 and final
    np.testing.assert_allclose(tres.norm_list, jres.norm_list, rtol=5e-3)
    want = flatten_tree(jax.tree.map(np.asarray, jres.state.lora))
    got = flatten_tree(tres.state.params["lora"])
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w, rtol=5e-3,
                                   atol=5e-5, err_msg=name)


def test_ema_matches_jax_loop():
    """EMA of the merged model (average_weight, ema_epoch 0, 2 epochs):
    init after epoch 0, one update after epoch 1, an eval of it each."""
    p = _jax_params()
    fkw = {"average_weight": True, "ema_epoch": 0, "ema_decay": 0.9}
    jrec, trec = _Recorder(), _Recorder()
    jres = jax_run(_run_config(jc, fkw, epochs=2),
                   jax.tree.map(jnp.asarray, p),
                   _data(jax_synth, jax_split, JaxData), logger=jrec)
    tres = run_forget_training(_run_config(tc, fkw, epochs=2, device="cpu"),
                               params_from_jax(p),
                               _data(synthetic_face_dataset,
                                     split_by_class_window, ForgetData),
                               logger=trec)

    def ema_logs(rec):
        return [(step, m["Test forget-ema Accuracy"],
                 m["Test remain-ema Accuracy"]) for step, m in rec.records
                if "Test forget-ema Accuracy" in m]

    assert len(ema_logs(trec)) == len(ema_logs(jrec)) == 2
    np.testing.assert_allclose(ema_logs(trec), ema_logs(jrec), atol=5e-3)
    want = flatten_tree(jax.tree.map(np.asarray, jres.ema))
    got = flatten_tree(tres.ema)
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].dtype == torch.float32
        np.testing.assert_allclose(got[name].numpy(), w, rtol=5e-3,
                                   atol=5e-5, err_msg=name)


def test_cuda_requested_without_a_card_raises(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


@pytest.fixture
def tiny_cli(monkeypatch):
    """Shrink the CLI's flagship model to tiny dims (as tests/test_cli.py
    does for the JAX CLI)."""
    from gslora_tpu_torch.cli import train_forget
    orig = tc.config_from_args

    def patched(args):
        cfg = orig(args)
        cfg.model = tc.ViTConfig(**{**MODEL, "num_class": 8,
                                    "depth": args.vit_depth,
                                    "head_type": args.head})
        return cfg

    monkeypatch.setattr(train_forget, "config_from_args", patched)
    return train_forget


def test_cli_runs_end_to_end_on_cpu(tiny_cli, tmp_path):
    report = tiny_cli.main([
        "-d", "synthetic", "--vit_depth", "2", "--head", "CosFace",
        "--lora_rank", "4", "-b", "8", "-e", "1", "--lr", "1e-3",
        "--alpha_epoch", "0", "--num_of_first_cls", "6",
        "--per_forget_cls", "2", "--data_ratio", "1.0", "--prototype",
        "--pro_f_weight", "0.01", "--compute_dtype", "float32",
        "--device", "cpu", "--outdir", str(tmp_path)])
    on_disk = json.loads((tmp_path / "report.json").read_text())
    assert on_disk == json.loads(json.dumps(report))
    assert len(report["norm_list"]) == 2
    assert all(np.isfinite(report[k]) for k in
               ("forget_acc", "remain_acc", "best_H_mean"))
    assert (tmp_path / "config.txt").exists()
    logged = [json.loads(line) for line in
              (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert any("loss_total" in rec for rec in logged)


@pytest.mark.parametrize("flags,mesh_kw,jax_flags", [
    (["--dp", "--MAS", "--pp", "--mesh_model", "2"], {"model": 2},
     {"pp": True}),
    (["--dp", "--ewc", "--tp"], {"data": 2}, {"tp": True}),
])
def test_cli_unported_paths_raise(monkeypatch, tiny_cli, tmp_path, flags,
                                  mesh_kw, jax_flags):
    """Under a world of 2 (torchrun's WORLD_SIZE) a baseline runs every
    layout JAX's runners take; what they refuse (pp; tp on a model axis
    of 1) raises JAX's ValueError, word for word, before any process
    group is made."""
    import torch_mesh_setup
    want = torch_mesh_setup.jax_refusal(mesh_kw, jax_flags, baseline=True)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError) as err:
        tiny_cli.main(["-d", "synthetic", "--vit_depth", "1", "-b", "8",
                       "-e", "1", "--device", "cpu", "--num_of_first_cls",
                       "6", "--per_forget_cls", "2", "--outdir",
                       str(tmp_path)] + flags)
    assert str(err.value) == want


@pytest.mark.parametrize("flag,method", [
    ("--SCRUB", "scrub"), ("--Lwf", "lwf"), ("--LIRF", "lirf"),
])
def test_cli_single_step_rejects_cl_only_methods(tiny_cli, tmp_path, flag,
                                                 method):
    """As the JAX single-step CLI: only retrain, l2, ewc and MAS have a
    single-step path in the reference; the others raise ValueError."""
    with pytest.raises(ValueError, match=f"{method}.*no single-step"):
        tiny_cli.main(["-d", "synthetic", "--vit_depth", "1", "-b", "8",
                       "-e", "1", "--device", "cpu", "--num_of_first_cls",
                       "6", "--per_forget_cls", "2", "--outdir",
                       str(tmp_path), flag])


def test_cli_defaults_to_the_card(monkeypatch, tiny_cli, tmp_path):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tiny_cli.main(["-d", "synthetic", "--vit_depth", "1", "-b", "8",
                       "-e", "1", "--num_of_first_cls", "6",
                       "--per_forget_cls", "2", "--outdir", str(tmp_path)])
