"""SCRUB and LIRF in the port (gslora_tpu_torch/baselines/{scrub,lirf}.py)
against the JAX package's, on the same numpy-drawn weights and data (fp32,
dropout 0): one task of each with padded batches (the -1 sentinel every
loader on the card emits), micro-batched steps against one call, their
state across tasks in the continual CLI, and that CLI for each over two
tasks. The JAX package's own tests/test_baselines.py::test_scrub asserts
forgetting at a boundary the frozen head no longer reaches; here SCRUB is
held to parity with ``run_scrub_task``, not to forgetting.

Card case (marker ``cuda``): one LIRF step's gradient of the student's
low half, whose path runs back through the frozen teacher's upper blocks
(attention inputs need a gradient, weights do not), with attention
through kernel K1 against the plain attention, within chip_smoke's
MODEL_TOL. JAX is imported only inside the CPU cases, so on a machine
with a card and without JAX it runs as ``python -m pytest --noconftest
-m cuda tests/test_torch_baselines_scrub_lirf.py``.

Tolerances: trained parameters 5e-3 relative (as
tests/test_training_parity.py), logged losses 1e-3, accuracies equal
(the same predictions)."""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

import gslora_tpu_torch.cli.train_forget_cl as tcli
import gslora_tpu_torch.config as tc
from gslora_tpu_torch.baselines.freeze import trains
from gslora_tpu_torch.baselines.lirf import (LIRFState, _Node, low_slice,
                                             make_lirf_step, run_lirf_task)
from gslora_tpu_torch.baselines.scrub import make_scrub_steps, \
    run_scrub_task
from gslora_tpu_torch.data.pipeline import CyclingLoader
from gslora_tpu_torch.engine.pretrain import PretrainState
from gslora_tpu_torch.engine.state import make_optimizer
from gslora_tpu_torch.models.convert import params_from_jax
from gslora_tpu_torch.models.vit import ViT, init_vit_params

from torch_baselines_setup import (CL_ARGS, MODEL, Recorder,
                                   assert_reports_match, assert_trees_close,
                                   loaders, np_tree, one_torch_thread,
                                   patch_clis, run_both_clis, run_config,
                                   to_jax)

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)


def test_scrub_task_matches_jax():
    """One superepoch (5 max passes over forget with its true labels, 10
    min passes over the first two remain batches), SWA distance 0.1, a
    teacher and an SWA model that are not the student (the state a
    second task starts from)."""
    import gslora_tpu.config as jc
    from gslora_tpu.baselines.scrub import run_scrub_task as jax_task

    p, teacher, swa = np_tree(3), np_tree(0), np_tree(4)
    out = {}
    for pkg, C, run, conv in (("jax", jc, jax_task, to_jax),
                              ("torch", tc, run_scrub_task,
                               params_from_jax)):
        fl, rl, tbf, tbr = loaders(pkg, relabel=False)
        cfg = run_config(C, "scrub",
                         **({"device": "cpu"} if pkg == "torch" else {}))
        out[pkg] = run(cfg, conv(p), lambda: iter(fl),
                       lambda: itertools.islice(iter(rl), 2), tbf, tbr,
                       logger=Recorder(), teacher=conv(teacher),
                       swa=conv(swa), n_averaged=1)
    jres, tres = out["jax"], out["torch"]
    assert tres["n_averaged"] == jres["n_averaged"] == 2
    for key in ("forget_acc_before", "forget_acc", "remain_acc", "best_h"):
        assert tres[key] == pytest.approx(jres[key], abs=1e-6), key
    assert_trees_close(tres["params"], jres["params"], what="student")
    assert_trees_close(tres["swa"], jres["swa"], what="swa")
    assert_trees_close(tres["teacher"], teacher, rtol=0, atol=0)


@pytest.mark.parametrize("rank", [0, 4])
def test_lirf_task_matches_jax(rank):
    """Two epochs of LIRF from a fresh carry; with a LoRA-carrying model
    (rank 4, nonzero B) the teacher is the merged model."""
    import gslora_tpu.config as jc
    from gslora_tpu.baselines.lirf import run_lirf_task as jax_task
    from gslora_tpu.data.pipeline import CyclingLoader as JaxCycling

    p = np_tree(3, rank=rank)
    if rank:
        rng = np.random.RandomState(5)
        for name in ("B1", "B2"):
            p["lora"]["ffn"][name] = 0.05 * rng.randn(
                *p["lora"]["ffn"][name].shape).astype(np.float32)
    out = {}
    for pkg, C, run, conv, cyc in (
            ("jax", jc, jax_task, to_jax, JaxCycling),
            ("torch", tc, run_lirf_task, params_from_jax, CyclingLoader)):
        fl, rl, tbf, tbr = loaders(pkg)
        cfg = run_config(C, "lirf", epochs=2,
                         **({"device": "cpu"} if pkg == "torch" else {}))
        cfg.lora = C.LoraConfig(rank=rank)
        rec = Recorder()
        out[pkg] = (run(cfg, conv(p), lambda: iter(fl), cyc(rl), tbf, tbr,
                        logger=rec), rec)
    (jres, jrec), (tres, trec) = out["jax"], out["torch"]
    for key in ("forget_acc_before", "forget_acc", "remain_acc", "best_h"):
        assert tres[key] == pytest.approx(jres[key], abs=1e-6), key
    for key in ("loss_CE", "loss_AT", "loss_kdKP", "loss_pt_re",
                "loss_remain", "loss_total"):
        assert len(trec.series(key)) == len(jrec.series(key)) == 4
        np.testing.assert_allclose(trec.series(key), jrec.series(key),
                                   rtol=1e-3, atol=1e-6, err_msg=key)
    assert_trees_close(tres["teacher"], jres["teacher"], rtol=1e-6,
                       atol=1e-7, what="teacher")
    assert_trees_close(tres["student_low"], jres["student_low"],
                       what="student_low")
    # the deposit never trains: it is the teacher's low half
    assert_trees_close(tres["deposit_low"], low_slice(tres["teacher"], 1),
                       rtol=0, atol=0)


def _streams(seed, valid, n=8):
    rng = np.random.RandomState(seed)
    out = []
    for v in valid:
        x = torch.from_numpy(rng.randn(n, 3, 16, 16).astype(np.float32))
        y = torch.from_numpy(rng.randint(0, 8, n).astype(np.int64))
        y[v:] = -1
        out += [x, y]
    return out


def test_scrub_grad_accum_equals_one_call():
    """The max and the min step in two micro-batches of a padded batch (5
    valid of 8) against one call, SWA distance included."""
    model, lora = tc.ViTConfig(**MODEL), tc.LoraConfig(rank=0)
    p, teacher, swa = (params_from_jax(np_tree(s)) for s in (3, 0, 4))
    x, y = _streams(0, (5,))
    for which in (0, 1):
        after = {}
        for n in (1, 2):
            opt = make_optimizer(tc.OptimConfig(opt="sgd", lr=5e-3,
                                                weight_decay=5e-4))
            state = PretrainState.create(ViT(p, model, lora), opt,
                                         trains=trains)
            steps = make_scrub_steps(model, lora, opt, 2.0, 0.1, 0.99, 0.001,
                                     compute_dtype=torch.float32,
                                     grad_accum=n)
            state, m = steps[which](state, teacher, swa, x, y, 5e-3)
            after[n] = (state.params, m)
        for k, v in after[1][1].items():
            np.testing.assert_allclose(float(after[2][1][k]), float(v),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        assert_trees_close(after[2][0], after[1][0], rtol=1e-5, atol=1e-7)


def _lirf_state(p, opt):
    student = _Node(low_slice(p["base"], 1))
    return LIRFState(student=student, deposit_low=low_slice(p["base"], 1),
                     opt_state=opt.init(list(student.parameters())))


def test_lirf_grad_accum_equals_one_call():
    model, lora = tc.ViTConfig(**MODEL), tc.LoraConfig(rank=0)
    p = params_from_jax(np_tree(3))
    batches = _streams(1, (6, 3))
    after = {}
    for n in (1, 2):
        opt = make_optimizer(tc.OptimConfig(lr=1e-3))
        state = _lirf_state(p, opt)
        step = make_lirf_step(model, lora, opt, split=2, T=10.0, alpha=0.1,
                              compute_dtype=torch.float32, grad_accum=n)
        state, m = step(state, p["base"], *batches, 1e-3)
        after[n] = (state.student_low, m)
    for k, v in after[1][1].items():
        np.testing.assert_allclose(float(after[2][1][k]), float(v),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert_trees_close(after[2][0], after[1][0], rtol=1e-5, atol=1e-7)


RUNNERS = {"--SCRUB": "run_scrub_task", "--LIRF": "run_lirf_task"}


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """flag -> (both CLIs' two-task runs, the port's runner calls, its
    output directory): one run of each package per method, shared by the
    parity and the cross-task state tests. Each runner call keeps its
    keyword arguments and, under "out", its result."""
    import gslora_tpu.cli.train_forget_cl as jcli
    cache = {}

    def get(flag):
        if flag not in cache:
            calls = []
            orig = getattr(tcli, RUNNERS[flag])

            def spy(*a, **k):
                calls.append(dict(k))
                out = orig(*a, **k)
                calls[-1]["out"] = dict(out)  # the CLI pops the trees
                return out

            d = tmp_path_factory.mktemp(flag.strip("-"))
            with pytest.MonkeyPatch.context() as mp:
                patch_clis(mp, jcli, tcli)
                mp.setattr(tcli, RUNNERS[flag], spy)
                runs = run_both_clis(jcli, tcli, CL_ARGS + [flag], d)
            cache[flag] = (runs, calls, d / "torch")
        return cache[flag]

    return get


def test_scrub_teacher_and_swa_persist_across_tasks(cli_runs):
    """The reference builds SCRUB's teacher and SWA model once before the
    task loop (train_own_forget_cl.py:441-451): task 0 gets the
    pretrained model and no SWA, task 1 task 0's teacher, SWA and count."""
    _, calls, _ = cli_runs("--SCRUB")
    assert len(calls) == 2
    assert_trees_close(calls[0]["teacher"], np_tree(0), rtol=0, atol=0)
    assert calls[0]["swa"] is None and calls[0]["n_averaged"] == 0
    assert calls[1]["teacher"] is calls[0]["out"]["teacher"]
    assert calls[1]["swa"] is calls[0]["out"]["swa"]
    assert calls[1]["n_averaged"] == 1 and calls[1]["out"]["n_averaged"] == 2


def test_lirf_carry_threads_across_tasks(cli_runs):
    """LIRF's teacher, student and deposit carry into the next task, and
    the deployable model of each task is the teacher with the student's
    low half put in, with no LoRA."""
    _, calls, outdir = cli_runs("--LIRF")
    assert len(calls) == 2 and calls[0]["carry"] is None
    carry = calls[1]["carry"]
    for key in ("teacher", "student_low", "deposit_low"):
        assert carry[key] is calls[0]["out"][key]
    from gslora_tpu_torch.checkpoints.io import load_params
    snap = load_params(str(outdir / "task-level" / "Backbone_task_1.pth"))
    out = calls[1]["out"]
    assert snap["lora"] == {}
    assert_trees_close(low_slice(snap["base"], 1), out["student_low"],
                       rtol=0, atol=0)
    for k in ("head", "head_ln"):
        assert_trees_close(snap["base"][k], out["teacher"][k], rtol=0,
                           atol=0)
    np.testing.assert_array_equal(
        snap["base"]["blocks"]["fc1"]["kernel"][1].numpy(),
        out["teacher"]["blocks"]["fc1"]["kernel"][1].numpy())


@pytest.mark.parametrize("flag", ["--SCRUB", "--LIRF"])
def test_cl_cli_matches_jax(flag, cli_runs):
    """train_forget_cl over two tasks: the reports (SCRUB's SWA count
    included) and each task's snapshot."""
    runs, _, _ = cli_runs(flag)
    (jrep, jsnaps), (trep, tsnaps) = runs["jax"], runs["torch"]
    assert_reports_match(trep, jrep)
    for t, (got, want) in enumerate(zip(tsnaps, jsnaps)):
        assert_trees_close(got, want, what=f"{flag} task {t}")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def lirf_student_grads(model, params, batches, impl, device):
    """The gradient of the student's low half in one LIRF step (bf16
    compute, no update), with attention ``impl`` ("auto": kernel K1 for
    tensors on the card; "dpa": its plain version)."""
    model = dataclasses.replace(model, attn_impl=impl)
    lora = tc.LoraConfig(rank=0)
    teacher = {k: v for k, v in params["base"].items()}
    grads = []

    class Capture:
        def update(self, leaves, g, state, lr):
            grads.extend(g)

        def init(self, leaves):
            return {}

    half = model.depth // 2
    student = _Node(low_slice(teacher, half)).to(device)
    state = LIRFState(student=student, deposit_low=low_slice(teacher, half),
                      opt_state={})
    step = make_lirf_step(model, lora, Capture(), split=20, T=10.0,
                          alpha=0.1, compute_dtype=torch.bfloat16)
    step(state, teacher, *batches, 0.0)
    names = [n for n, _ in student.named_parameters()]
    return dict(zip(names, grads))


@pytest.mark.cuda
def test_lirf_student_grads_through_kernels_match_plain(cuda_device):
    from gslora_tpu_torch.ops import attention as A
    model = tc.ViTConfig(image_size=32, patch_size=8, dim=128, depth=4,
                         heads=2, dim_head=64, mlp_dim=256, num_class=40,
                         dropout=0.0, emb_dropout=0.0, head_type="CosFace")
    params = init_vit_params(torch.Generator().manual_seed(0), model,
                             tc.LoraConfig(rank=0))
    params = {"base": {k: v for k, v in params["base"].items()}}

    def to_dev(tree):
        return {k: to_dev(v) if isinstance(v, dict) else v.to(cuda_device)
                for k, v in tree.items()}

    params = to_dev(params)
    g = torch.Generator().manual_seed(1)
    batches = []
    for n_valid in (6, 8):
        x = torch.randn(8, 3, 32, 32, generator=g)
        y = torch.randint(0, 40, (8,), generator=g)
        y[n_valid:] = -1
        batches += [x.to(cuda_device), y.to(cuda_device)]
    A.reset_launch_counts()
    got = lirf_student_grads(model, params, batches, "auto", cuda_device)
    # student forget and remain forwards back through all 4 blocks each
    assert (A.FWD_LAUNCHES, A.BWD_LAUNCHES) == (16, 8)
    want = lirf_student_grads(model, params, batches, "dpa", cuda_device)
    for name, w in want.items():
        a, b = got[name].float(), w.float()
        err = float(torch.linalg.vector_norm(a - b) /
                    torch.linalg.vector_norm(b).clamp_min(1e-30))
        print(f"LIRF student grad {name}: relative L2 {err:.2e}")
        assert err <= 3e-2, name
