"""The port's continual GS-LoRA++ recipe (gslora_tpu_torch/tools/
integration_continual.py: its run_config through engine/continual) against
the JAX package's run_continual_forgetting at the recipe of
scripts/integration_continual.py --unsaturated (tests/
torch_integration_setup.jax_continual), task by task, at the flagship's
widths: image 112 with patch 8 (197 tokens), dim 512, 8 heads x 64, mlp
2048, the Softmax head over 100 classes, rank-8 FFN LoRA, fp32 on the CPU,
dropout 0. Both packages start from one base and read the 112-px
noise-2.4 stand-in with make_order_list(100, seed=1337); the merge
boundary's LoRA reinit is patched in both to one numpy draw
(torch_integration_setup.np_reinit), since the packages' generators
differ by design.

The tier-1 tests cut the depth to 1 layer, the run to 2 tasks of 1 epoch,
the recipe's data_ratio from 0.4 to 0.1, and the stand-in's test split
from 5 images a class to 1 (the same construction at seed 77), so the
file stays CPU-small: each task then trains on 1 forget batch of 48 and 4
(task 0) or 3 (task 1) remain batches of 48, and evaluates 20 forget and
80 (task 0) or 60 (task 1) remain images. Every part of the continual
path still runs: the fold (or its absence under ``keep``), the
prototypes from the current backbone over each task's subsets, the
per-task beta and prototype weights, the remain-driven epoch, and the
old-class evals before and after task 1. Their base is the JAX seed-0 init with the class-mean
Softmax head of tests/test_torch_integration_flagship.py
(torch_integration_setup.class_mean_base).

The slow tests run the recipe at 6 layers for its 4 tasks, in each of
its modes (merge + reinit, keep, few-shot at batch 4 with 4 images a
class), at the recipe's data_ratio 0.4 (16 / 12 / 8 / 4 remain steps of
48 + 48 a task epoch), for ``$FLAGSHIP_EPOCHS`` epochs a task (default
1; the recipe has 12), from the JAX fp32 base that scripts/
integration_continual.py --unsaturated reads
(torch_integration_setup.jax_flagship_base at ``$FLAGSHIP_JAX_BASE``;
over an hour on an 8-core CPU when it is missing); and the few-shot mode
at depth 1 over 2 tasks from the class-mean base:

    JAX_PLATFORMS=cpu FLAGSHIP_JAX_BASE=/path/base_unsat.msgpack \\
        FLAGSHIP_EPOCHS=1 python -m pytest \\
        tests/test_torch_integration_continual_flagship.py -m slow -s

Tolerances: at depth 1, every per-task accuracy equal (the same
predictions, to float rounding) and best H-means to 1e-6, the LoRA group
norms as tests/test_torch_integration_forget.py holds them (rtol 5e-3,
atol 1e-3); the fold moves the base in both packages, keep leaves it.
At depth 6 every per-task accuracy within 0.5 points, the per-task
criterion of BASELINE.json (the forget test sets hold 100 images, so
equal there). Few-shot trains at batch 4 (80 / 60 / 40 / 20 steps a task
epoch) at lr 1e-2, and there a task's result is not pinned down by fp32
arithmetic: JAX's own run from a start nudged by a relative 1e-5 moves
task 1 at depth 1 by more than a point. So few-shot runs JAX from its
base and from NUDGE_SEEDS' nudged starts too (the draws), holds to 0.5
points task 0 and every later leading task that no nudged draw moves
further than that (held_tasks), at depth 1 every task's first loss to
1e-3 of JAX's, and each later task's numbers within 0.5 points of the
draws' spread (their least to their largest)."""
import dataclasses
import os
import tempfile

import numpy as np
import pytest

import gslora_tpu.config as jc
import gslora_tpu_torch.config as tc
import gslora_tpu_torch.engine.continual as tcont
from gslora_tpu_torch.data.splits import make_order_list
from gslora_tpu_torch.models.convert import flatten_tree, params_from_jax
from gslora_tpu_torch.tools import flagship
from gslora_tpu_torch.tools import integration_continual as C

from torch_baselines_setup import one_torch_thread
from torch_integration_setup import (DEPTH_1, assert_close, class_mean_base,
                                     jax_accuracy, jax_continual,
                                     jax_flagship_base, jax_tree,
                                     patch_reinit, stand_in)

# the tier-1 cases share the machine with the suite's other workers; the
# slow tests take every core
one_thread = pytest.fixture(one_torch_thread)

NOISE = 2.4  # the unsaturated stand-in
TIER1_RATIO = 0.1  # the tier-1 cut of the recipe's data_ratio 0.4
# (report key, JAX TaskResult reader) for every per-task number
TASK_KEYS = (
    ("forget_before", lambda t: t.result.forget_acc_before),
    ("forget_after", lambda t: t.result.forget_acc),
    ("remain_after", lambda t: t.result.remain_acc),
    ("old_acc_before", lambda t: t.old_acc_before),
    ("old_acc", lambda t: t.old_acc),
    ("best_H", lambda t: t.result.best_h))
BASELINE_POINTS = 0.5  # BASELINE.json: parity within 0.5 % per task
NUDGE = 1e-5  # the relative nudge of a few-shot draw's start
NUDGE_SEEDS = (5, 6, 7)  # the nudged draws of the few-shot tests


def model(C_, **over):
    return C_.ViTConfig(**{**DEPTH_1, **over}, head_type="Softmax")


def tier1_test(pkg):
    """The stand-in's test split at 1 image a class in ``pkg``."""
    if pkg == "jax":
        from gslora_tpu.data.synthetic import synthetic_face_dataset
    else:
        from gslora_tpu_torch.data.synthetic import synthetic_face_dataset
    return synthetic_face_dataset(num_classes=100, per_class=1,
                                  image_size=112, seed=77, noise=NOISE)


@pytest.fixture(scope="module")
def setup():
    torch_data = flagship.stand_in(model(tc), NOISE)
    jax_data = stand_in("jax", NOISE, image_size=112)
    return {"jax": jax_data, "torch": torch_data,
            "base": class_mean_base(torch_data[0]),
            "jax_tier1": (jax_data[0], tier1_test("jax")),
            "torch_tier1": (torch_data[0], tier1_test("torch"))}


def port_continual(base, data, boundary, few_shot, num_tasks, epochs,
                   data_ratio, logger=None, disp_freq=5, **over):
    """tools/integration_continual's recipe (run_config) in fp32 on the
    CPU through engine/continual, ``data_ratio`` in place of 0.4;
    ``logger`` gets the step metrics every ``disp_freq`` steps."""
    cfg = C.run_config(model(tc, **over), few_shot, num_tasks, "cpu",
                       epochs, "float32")
    cfg = dataclasses.replace(cfg, disp_freq=disp_freq, forget=dataclasses
                              .replace(cfg.forget, data_ratio=data_ratio))
    return tcont.run_continual_forgetting(
        cfg, params_from_jax(base), *data, make_order_list(100, seed=1337),
        logger=logger, boundary=boundary)


class LossLog:
    """Each task's total loss at every logged step (a task's steps end
    where the loop logs its LoRA group norms)."""

    def __init__(self):
        self.tasks = []
        self.ended = True

    def log(self, metrics, step=None):
        if "norm_group_0" in metrics:
            self.ended = True
        elif "loss_total" in metrics:
            if self.ended:
                self.tasks.append([])
                self.ended = False
            self.tasks[-1].append(float(metrics["loss_total"]))


def nudged(tree, seed):
    """``tree`` (numpy leaves) with every weight scaled by 1 + NUDGE z, z
    a standard normal draw of ``seed``: a start some 170 units in the
    last place away, about as far as the packages' rounding carries them
    apart over one few-shot task (their losses' relative gap reaches
    ~1e-4)."""
    rng = np.random.RandomState(seed)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else
                (v * (1 + NUDGE * rng.standard_normal(v.shape)))
                .astype(np.float32) for k, v in t.items()}

    return walk(tree)


def held_tasks(want, nudges):
    """How many leading tasks JAX's result pins down, at least task 0:
    those where every JAX run from a :func:`nudged` base lands within 0.5
    points of it on every number (reports as lists of dicts). From the
    first task that a nudge moves further, no single run is the
    reference."""
    for n, w in enumerate(want):
        if n and any(w[k] is not None and abs(w[k] - v[n][k]) >
                     BASELINE_POINTS for v in nudges for k, _ in TASK_KEYS):
            return n
    return len(want)


def assert_tasks_within(got, want, tasks=None, draws=()):
    """The first ``tasks`` (all by default) tasks of ``got`` within 0.5
    points of ``want`` on every number; every later one within 0.5
    points of the spread of ``want`` and the ``draws`` (reports of JAX
    from nudged starts)."""
    tasks = len(want) if tasks is None else tasks
    for n, (g, w) in enumerate(zip(got, want)):
        for key, _ in TASK_KEYS:
            if w[key] is None:
                assert g[key] is None and w["task"] == 0, key
            elif w["task"] < tasks:
                assert abs(g[key] - w[key]) <= BASELINE_POINTS, \
                    (w["task"], key, g[key], w[key])
            else:
                seen = [w[key]] + [d[n][key] for d in draws]
                assert min(seen) - BASELINE_POINTS <= g[key] <= \
                    max(seen) + BASELINE_POINTS, (w["task"], key, g[key],
                                                  seen)


def print_loss_gaps(name, want, got):
    """Each task's relative gap between two LossLogs' losses, printed;
    asserts that every task starts where JAX's does (its first loss
    within 1e-3)."""
    for task, (j, t) in enumerate(zip(want.tasks, got.tasks)):
        assert len(j) == len(t) > 0, (name, task)
        gap = [abs(a - b) / abs(a) for a, b in zip(j, t)]
        print(f"{name} task {task}: {len(j)} steps, loss gap to jax first "
              f"{gap[0]:.1e}, max {max(gap):.1e} at step "
              f"{gap.index(max(gap))}", flush=True)
        assert gap[0] <= 1e-3, (name, task, gap[0])


def task_report(t):
    return {key: read(t) for key, read in TASK_KEYS}


def assert_tasks_equal(got, want):
    """Every per-task number of two continual results (the port's, the
    JAX package's) equal, and each task's LoRA group norms close."""
    assert [t.task for t in got.tasks] == [t.task for t in want.tasks]
    for g, w in zip(got.tasks, want.tasks):
        for key, read in TASK_KEYS:
            if read(w) is None:
                assert read(g) is None and w.task == 0, (w.task, key)
            else:
                assert_close(read(g), read(w), (w.task, key))
        assert len(g.result.norm_list) == len(w.result.norm_list) > 0
        np.testing.assert_allclose(g.result.norm_list, w.result.norm_list,
                                   rtol=5e-3, atol=1e-3, err_msg=w.task)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("boundary", ["merge_reinit", "keep"])
def test_continual_tasks_match_jax(setup, monkeypatch, boundary):
    """2 tasks of the recipe at depth 1 (data_ratio 0.1): per task the
    forget accuracy before and after, the remain accuracy, the old-class
    accuracy before and after training and the best H as JAX's; the LoRA
    group norms too. merge + reinit folds the task-0 LoRA into the base,
    keep leaves the base as it was."""
    patch_reinit(monkeypatch)
    want = jax_continual(jax_tree(setup["base"]), *setup["jax_tier1"],
                         model(jc), boundary, False, 2, 1,
                         data_ratio=TIER1_RATIO)
    got = port_continual(setup["base"], setup["torch_tier1"], boundary,
                         False, 2, 1, TIER1_RATIO)
    assert_tasks_equal(got, want)
    assert got.tasks[1].old_acc_before is not None
    # the fold writes task 0's LoRA into the base in both packages; keep
    # trains the LoRA alone, so the base ends as it began
    start = flatten_tree(params_from_jax(setup["base"]))
    for result in (got, want):
        final = flatten_tree(result.final_params)
        moved = [n for n, t in start.items() if n.startswith("base") and
                 not np.array_equal(np.asarray(final[n]), t.numpy())]
        assert bool(moved) == (boundary == "merge_reinit"), moved


def _epochs():
    """``$FLAGSHIP_EPOCHS`` epochs a task, else 1 (the recipe's 12 are
    hours a package on the CPU)."""
    return int(os.environ.get("FLAGSHIP_EPOCHS", 1))


def _print(what, tasks):
    for t in tasks:
        print(what, {k: round(v, 4) if isinstance(v, float) else v
                     for k, v in t.items()}, flush=True)


@pytest.mark.slow
def test_few_shot_depth_1_matches_jax(setup, monkeypatch):
    """The few-shot mode (batch 4, 4 images a class) at depth 1 for 2
    tasks of 1 epoch (80 and 60 steps of 4 + 4). Task 0 holds every
    number as JAX's to 1e-6, the LoRA group norms too; every task starts
    where JAX's does (its first loss within 1e-3); the tasks JAX pins
    down (held_tasks over the NUDGE_SEEDS draws) within 0.5 points, the
    rest within 0.5 points of the draws' spread. Prints the runs' reports
    and the losses' gaps per task."""
    patch_reinit(monkeypatch)
    logs = {"jax": LossLog(), "port": LossLog()}
    runs = {"jax": jax_continual(jax_tree(setup["base"]), *setup["jax"],
                                 model(jc), "merge_reinit", True, 2, 1,
                                 logger=logs["jax"], disp_freq=1),
            **{f"jax, start nudged by seed {s}": jax_continual(
                jax_tree(nudged(setup["base"], s)), *setup["jax"],
                model(jc), "merge_reinit", True, 2, 1)
               for s in NUDGE_SEEDS},
            "port": port_continual(setup["base"], setup["torch"],
                                   "merge_reinit", True, 2, 1, 0.4,
                                   logger=logs["port"], disp_freq=1)}
    reports = {name: [{"task": t.task, **task_report(t)} for t in r.tasks]
               for name, r in runs.items()}
    for name, tasks in reports.items():
        _print(f"{name} few-shot depth 1", tasks)
    print_loss_gaps("port", logs["jax"], logs["port"])
    draws = [v for k, v in reports.items() if k.startswith("jax, ")]
    held = held_tasks(reports["jax"], draws)
    print(f"few-shot depth 1: JAX pins down its first {held} tasks",
          flush=True)
    got, want = runs["port"], runs["jax"]
    assert_tasks_equal(dataclasses.replace(got, tasks=got.tasks[:1]),
                       dataclasses.replace(want, tasks=want.tasks[:1]))
    assert_tasks_within(reports["port"], reports["jax"], held, draws)


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["merge_reinit", "keep", "few_shot"])
def test_flagship_continual_matches_jax(tmp_path, monkeypatch, mode):
    """The recipe at 6 layers for its 4 tasks, ``_epochs()`` epochs a
    task, from the JAX fp32 base in both packages (printed): the base's
    test accuracy equal, and every per-task accuracy and best H within
    BASELINE.json's 0.5 points. In few-shot (80 / 60 / 40 / 20 steps of
    4 + 4 a task epoch) only task 0 and the leading tasks that JAX's own
    runs from nudged starts keep within 0.5 points (held_tasks) are held
    so, the rest within 0.5 points of the spread of JAX's runs
    from its base and from the NUDGE_SEEDS nudged starts."""
    patch_reinit(monkeypatch)
    path = os.environ.get("FLAGSHIP_JAX_BASE", os.path.join(
        tempfile.gettempdir(), "flagship_jax_fp32_unsat.msgpack"))
    base = jax_flagship_base(path)
    jdata = stand_in("jax", NOISE, image_size=112)
    tdata = flagship.stand_in(model(tc, depth=6), NOISE)
    few_shot = mode == "few_shot"
    boundary = "keep" if mode == "keep" else "merge_reinit"
    jmodel = model(jc, depth=6)
    pre = jax_accuracy(jax_tree(base), jdata[1], jmodel, C.EVAL_BS, False)
    want = jax_continual(jax_tree(base), *jdata, jmodel, boundary, few_shot,
                         4, _epochs())
    want_tasks = [{"task": t.task, **task_report(t)} for t in want.tasks]
    _print(f"jax {mode} (base {pre})", want_tasks)
    held, draws = len(want_tasks), []
    if few_shot:
        for s in NUDGE_SEEDS:
            nudge = jax_continual(jax_tree(nudged(base, s)), *jdata, jmodel,
                                  boundary, few_shot, 4, _epochs())
            draws.append([{"task": t.task, **task_report(t)}
                          for t in nudge.tasks])
            _print(f"jax {mode}, start nudged by seed {s}", draws[-1])
        held = held_tasks(want_tasks, draws)
        print(f"{mode}: JAX pins down its first {held} tasks", flush=True)
    report = C.run(params_from_jax(base), *tdata, model(tc, depth=6),
                   unsaturated=True, boundary=boundary, few_shot=few_shot,
                   device="cpu", epochs=_epochs(), compute_dtype="float32",
                   out=str(tmp_path / "report.json"))
    _print(f"port {mode} (base {report['pretrain_test_acc']}, "
           f"{report['wallclock_s']} s)", report["tasks"])
    assert_close(report["pretrain_test_acc"], pre, "pretrain")
    assert [t["task"] for t in report["tasks"]] == [0, 1, 2, 3]
    assert_tasks_within(report["tasks"], want_tasks, held, draws)
