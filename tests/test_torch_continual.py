"""Continual forgetting of the port (gslora_tpu_torch/engine/continual.py,
cli/train_forget_cl.py) against the JAX package's
``gslora_tpu.engine.continual`` on the same converted weights and data
(fp32, dropout 0), and the CL CLI end to end on the CPU.

JAX keys and torch generators draw different numbers, so the LoRA reinit
at the task boundary is replaced in both packages by one numpy-drawn
function. Tolerances: per-task losses rtol/atol 1e-3, accuracies abs
1e-6 (the same predictions), norms, LoRA and merged base 5e-3 / 5e-5
(as tests/test_torch_loop.py)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gslora_tpu.config as jc
import gslora_tpu.engine.continual as jcont
from gslora_tpu.data.synthetic import synthetic_face_dataset as jax_synth
from gslora_tpu.models.vit import init_vit_params as jax_init

import gslora_tpu_torch.config as tc
import gslora_tpu_torch.engine.continual as tcont
from gslora_tpu_torch.data.splits import make_order_list
from gslora_tpu_torch.data.synthetic import synthetic_face_dataset
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
             dim_head=16, mlp_dim=64, num_class=8, dropout=0.0,
             emb_dropout=0.0, head_type="CosFace")


def _np_reinit(lora_tree):
    """LoRA reinit from numpy: A ~ U(+-sqrt(6 / (51 fan_in))) (the bound
    of kaiming-uniform with a = sqrt(50)), B = 0; seeded per tensor name,
    so the draw does not depend on the tree's key order."""
    out = {}
    for pos, sub in lora_tree.items():
        out[pos] = {}
        for name, arr in sub.items():
            shape = tuple(arr.shape)
            if name.startswith("A"):
                rng = np.random.RandomState(sum(map(ord, pos + name)))
                b = np.sqrt(6.0 / (51.0 * shape[-1]))
                out[pos][name] = rng.uniform(-b, b, shape).astype(np.float32)
            else:
                out[pos][name] = np.zeros(shape, np.float32)
    return out


@pytest.fixture
def same_reinit(monkeypatch):
    monkeypatch.setattr(jcont, "reinit_lora", lambda key, tree: jax.tree.map(
        jnp.asarray, _np_reinit(tree)))
    monkeypatch.setattr(tcont, "reinit_lora", lambda gen, tree: {
        pos: {k: torch.from_numpy(v).to(tree[pos][k].device)
              for k, v in sub.items()}
        for pos, sub in _np_reinit(tree).items()})


def _cfg(C, mode, device=None, **fkw):
    alpha = 1.0 if mode == "prox" else 5e-4
    return C.RunConfig(
        model=C.ViTConfig(**MODEL), lora=C.LoraConfig(rank=4),
        optim=C.OptimConfig(lr=1e-2, warmup_epochs=0, epochs=1),
        forget=C.ForgetConfig(num_of_first_cls=6, per_forget_cls=2,
                              num_tasks=2, bnd=10.0, beta=0.3, alpha=alpha,
                              alpha_epoch=0, prototype=True,
                              cl_beta_list=(0.3, 0.2),
                              cl_prof_list=(0.01, 0.02), pro_r_weight=0.01,
                              bnd_pro=18.0, data_ratio=1.0,
                              average_weight=True, ema_epoch=0, **fkw),
        data=C.DataConfig(batch_size=8, data_mode="synthetic"),
        num_epoch=1, ver_freq=10_000, disp_freq=1, compute_dtype="float32",
        structure_mode=mode, **({"device": device} if device else {}))


def _datasets(synth):
    return (synth(num_classes=8, per_class=4, image_size=16, seed=0,
                  noise=1.0),
            synth(num_classes=8, per_class=4, image_size=16, seed=1,
                  noise=1.0))


class _Recorder:
    def __init__(self):
        self.records = []

    def log(self, metrics, step=None):
        self.records.append(dict(metrics))

    def losses(self):
        return [float(m["loss_total"]) for m in self.records
                if "loss_total" in m]


@pytest.mark.parametrize("fkw", [
    {}, {"few_shot": True, "few_shot_num": 3}, {"open_cls_num": 2},
])
def test_split_task_data_matches_jax(fkw):
    order = make_order_list(8, seed=1337)
    jtrain, jtest = _datasets(jax_synth)
    ttrain, ttest = _datasets(synthetic_face_dataset)
    jcfg, tcfg = _cfg(jc, "loss", **fkw), _cfg(tc, "loss", **fkw)
    for task in range(2):
        jd, jold = jcont.split_task_data(jcfg, jtrain, jtest, order, task,
                                         5 + task)
        td, told = tcont.split_task_data(tcfg, ttrain, ttest, order, task,
                                         5 + task)
        for name in ("train_forget", "train_remain", "test_forget",
                     "test_remain", "test_open"):
            a, b = getattr(td, name), getattr(jd, name)
            assert (a is None) == (b is None), name
            if a is not None:
                assert a.indices == b.indices, (task, name)
                assert a.targets == b.targets, (task, name)
        assert (told is None) == (jold is None) == (task == 0)
        if told is not None:
            assert told.indices == jold.indices
    # the windows themselves (as tests/test_continual.py)
    d0, _ = tcont.split_task_data(tcfg, ttrain, ttest, order, 0, 0)
    d1, old1 = tcont.split_task_data(tcfg, ttrain, ttest, order, 1, 0)
    if not fkw.get("open_cls_num"):
        assert set(d0.train_forget.targets) == set(order[6:8])
        assert set(d1.train_forget.targets) == set(order[4:6])
        assert set(old1.targets) == set(order[6:8])
    else:
        assert set(d0.test_open.targets) == set(order[0:2])


@pytest.mark.parametrize("mode", ["prox", "loss"])
def test_two_tasks_match_jax(same_reinit, tmp_path, mode):
    p = jax_init(jax.random.key(0), jc.ViTConfig(**MODEL), jc.LoraConfig(4))
    rng = np.random.RandomState(1)
    for name in ("B1", "B2"):
        p["lora"]["ffn"][name] = jnp.asarray(
            0.05 * rng.randn(*p["lora"]["ffn"][name].shape)
            .astype(np.float32))
    p = jax.tree.map(np.asarray, p)
    order = make_order_list(8, seed=1337)

    jrec, trec = _Recorder(), _Recorder()
    jout = jcont.run_continual_forgetting(
        _cfg(jc, mode), jax.tree.map(jnp.asarray, p), *_datasets(jax_synth),
        order, logger=jrec)
    tout = tcont.run_continual_forgetting(
        _cfg(tc, mode, device="cpu"),
        params_from_jax(p), *_datasets(synthetic_face_dataset), order,
        logger=trec, workdir=str(tmp_path))

    jl, tl = jrec.losses(), trec.losses()
    assert len(tl) == len(jl) == 3 + 2  # 24, then 16 remain images / 8
    np.testing.assert_allclose(tl, jl, rtol=1e-3, atol=1e-3)
    assert len(tout.tasks) == len(jout.tasks) == 2
    for t, j in zip(tout.tasks, jout.tasks):
        for key in ("forget_acc_before", "forget_acc", "remain_acc"):
            assert getattr(t.result, key) == pytest.approx(
                getattr(j.result, key), abs=1e-6), (t.task, key)
        for key in ("old_acc", "old_acc_before"):
            want = getattr(j, key)
            assert (getattr(t, key) is None) == (want is None) == \
                (t.task == 0)
            if want is not None:
                assert getattr(t, key) == pytest.approx(want, abs=1e-6)
        np.testing.assert_allclose(t.result.norm_list, j.result.norm_list,
                                   rtol=5e-3, atol=5e-5)
    ema_logs = [[(m["Test forget-ema Accuracy"],
                  m["Test remain-ema Accuracy"]) for m in rec.records
                 if "Test forget-ema Accuracy" in m] for rec in (trec, jrec)]
    assert len(ema_logs[0]) == 2
    np.testing.assert_allclose(ema_logs[0], ema_logs[1], atol=1e-6)
    want = flatten_tree(jax.tree.map(np.asarray, jout.final_params))
    got = flatten_tree(tout.final_params)
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w, rtol=5e-3,
                                   atol=5e-5, err_msg=name)
    for task in range(2):
        level = tmp_path / "task-level"
        assert (level / f"Backbone_task_{task}.pth").exists()
        meta = json.loads((level / f"task_{task}_meta.json").read_text())
        assert meta["task"] == task
    if mode == "prox":
        # no structure term in the loss under prox
        assert all(m["loss_structure"] == 0.0 for m in trec.records
                   if "loss_structure" in m)


@pytest.mark.parametrize("mode", ["prox", "loss"])
def test_keep_boundary_matches_jax(monkeypatch, mode):
    """boundary="keep": no fold and no reinit, task 1 trains on from task
    0's final LoRA, in both packages; per-task accuracies the same, the
    final LoRA and base within 5e-3 / 5e-5."""
    def never(*args):
        raise AssertionError("keep must not reinit the LoRA")

    monkeypatch.setattr(jcont, "reinit_lora", never)
    monkeypatch.setattr(tcont, "reinit_lora", never)
    p = jax_init(jax.random.key(0), jc.ViTConfig(**MODEL), jc.LoraConfig(4))
    p = jax.tree.map(np.asarray, p)
    order = make_order_list(8, seed=1337)
    starts = []
    run_forget = tcont.run_forget_training

    def recorded(cfg, params, *args, **kwargs):
        starts.append({k: v.clone() for k, v in
                       flatten_tree(params["lora"]).items()})
        return run_forget(cfg, params, *args, **kwargs)

    monkeypatch.setattr(tcont, "run_forget_training", recorded)
    jout = jcont.run_continual_forgetting(
        _cfg(jc, mode), jax.tree.map(jnp.asarray, p), *_datasets(jax_synth),
        order, logger=_Recorder(), boundary="keep")
    tout = tcont.run_continual_forgetting(
        _cfg(tc, mode, device="cpu"), params_from_jax(p),
        *_datasets(synthetic_face_dataset), order, logger=_Recorder(),
        boundary="keep")
    for t, j in zip(tout.tasks, jout.tasks):
        for key in ("forget_acc_before", "forget_acc", "remain_acc"):
            assert getattr(t.result, key) == pytest.approx(
                getattr(j.result, key), abs=1e-6), (t.task, key)
        if t.task:
            assert t.old_acc == pytest.approx(j.old_acc, abs=1e-6)
            assert t.old_acc_before == pytest.approx(j.old_acc_before,
                                                     abs=1e-6)
    # task 1 started from task 0's final LoRA, not a fresh one
    final0 = flatten_tree(tout.tasks[0].result.state.params["lora"])
    assert all(torch.equal(starts[1][k], final0[k].detach())
               for k in final0)
    assert float(starts[1]["ffn.B1"].abs().max()) > 0
    want = flatten_tree(jax.tree.map(np.asarray, jout.final_params))
    got = flatten_tree(tout.final_params)
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w, rtol=5e-3,
                                   atol=5e-5, err_msg=name)


def test_unknown_boundary_raises_as_jax():
    cfg = _cfg(tc, "loss", device="cpu")
    data = _datasets(synthetic_face_dataset)
    order = make_order_list(8, seed=1337)
    with pytest.raises(ValueError, match="merge_reinit|keep") as terr:
        tcont.run_continual_forgetting(cfg, {}, *data, order,
                                       boundary="fold")
    jdata = _datasets(jax_synth)
    with pytest.raises(ValueError) as jerr:
        jcont.run_continual_forgetting(_cfg(jc, "loss"), {}, *jdata, order,
                                       boundary="fold")
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# the CL CLI
# ---------------------------------------------------------------------------


@pytest.fixture
def tiny_cl_cli(monkeypatch):
    """Shrink the CLI's flagship model to tiny dims (as tests/test_cli.py
    does for the JAX CLI)."""
    from gslora_tpu_torch.cli import train_forget_cl
    orig = tc.config_from_args

    def patched(args):
        cfg = orig(args)
        cfg.model = tc.ViTConfig(**{**MODEL, "depth": args.vit_depth,
                                    "head_type": args.head})
        return cfg

    monkeypatch.setattr(train_forget_cl, "config_from_args", patched)
    return train_forget_cl


CLI_ARGS = ["-d", "synthetic", "--vit_depth", "2", "--lora_rank", "4",
            "-b", "8", "-e", "1", "--lr", "1e-3", "--num_tasks", "2",
            "--num_of_first_cls", "6", "--per_forget_cls", "2",
            "--data_ratio", "0.5", "--compute_dtype", "float32"]


def test_cl_cli_runs_end_to_end_on_cpu(tiny_cl_cli, tmp_path):
    report = tiny_cl_cli.main(CLI_ARGS + [
        "--one_stage", "--structure_mode", "prox", "--alpha", "0.5",
        "--prototype", "--BND_pro", "50", "--cl_beta_list", "0.3", "0.2",
        "--cl_prof_list", "0.01", "0.02", "--average_weight",
        "--ema_epoch", "0", "--device", "cpu", "--outdir", str(tmp_path)])
    on_disk = json.loads((tmp_path / "report.json").read_text())
    assert on_disk == json.loads(json.dumps(report))
    assert [r["task"] for r in report] == [0, 1]
    assert report[0]["old_acc"] is None and report[1]["old_acc"] is not None
    for r in report:
        assert len(r["norm_list"]) == 2
        assert all(np.isfinite(r[k]) for k in
                   ("forget_acc", "remain_acc", "best_H_mean",
                    "time_to_forget_s"))
    for task in range(2):
        assert (tmp_path / "task-level" / f"Backbone_task_{task}.pth"
                ).exists()
        assert (tmp_path / f"task_{task}" / "config.txt").exists()
    saved = torch.load(tmp_path / "task-level" / "Backbone_task_1.pth")
    assert saved and all(k.startswith("base.") for k in saved)
    logged = [json.loads(line) for line in
              (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert any("Test forget-ema Accuracy" in rec for rec in logged)


@pytest.mark.parametrize("flags,mesh_kw,jax_flags", [
    (["--dp", "--SCRUB", "--fsdp", "--mesh_model", "2"],
     {"data": 1, "model": 2}, {"fsdp": True}),
    (["--dp", "--LIRF", "--sp", "--pp", "--mesh_model", "2"], {"model": 2},
     {"sp": True, "pp": True}),
    (["--dp", "--replay", "--sp"], {"data": 2}, {"sp": True}),
])
def test_cl_cli_unported_paths_raise(monkeypatch, tiny_cl_cli, tmp_path,
                                     flags, mesh_kw, jax_flags):
    """Under a world of 2 (torchrun's WORLD_SIZE) a baseline runs every
    layout JAX's runners take; what they refuse (fsdp on a data axis of
    1; pp, before sp's own refusal; sp on a model axis of 1) raises JAX's
    ValueError, word for word, before any process group is made."""
    import torch_mesh_setup
    want = torch_mesh_setup.jax_refusal(mesh_kw, jax_flags, baseline=True)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError) as err:
        tiny_cl_cli.main(CLI_ARGS + ["--device", "cpu", "--outdir",
                                     str(tmp_path)] + flags)
    assert str(err.value) == want


def test_cl_cli_accepts_and_ignores_profile_dir(tiny_cl_cli, tmp_path):
    """As the JAX CL CLI, which parses --profile_dir and never reads it."""
    report = tiny_cl_cli.main(CLI_ARGS + [
        "--one_stage", "--device", "cpu", "--profile_dir",
        str(tmp_path / "prof"), "--outdir", str(tmp_path / "out")])
    assert [r["task"] for r in report] == [0, 1]
    assert (tmp_path / "out" / "report.json").exists()
    assert not (tmp_path / "prof").exists()


def test_cl_cli_defaults_to_the_card(monkeypatch, tiny_cl_cli, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tiny_cl_cli.main(CLI_ARGS + ["--one_stage", "--outdir",
                                     str(tmp_path)])
