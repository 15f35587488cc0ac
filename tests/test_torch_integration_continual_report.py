"""tools/integration_continual's report at the integration tools' tiny
model on the CPU: beyond the JAX script's keys, per task the task's wall
and the kernels' launches in it (engine/continual.TaskResult), and the
base's largest change over the run, in two of the recipe's arms (keep in
fp32, few-shot merge + reinit in bf16) from one base; and the task loop's
metrics in ``--metrics_dir``.

On the CPU the attention runs K1's plain version, so the launch counters
stay at 0; the test counts what the card would launch by counting the
model's calls into the fused attention that do not ask for the plain
version (``plain=False``) as K1 forward launches of the query's dtype."""
import json

import pytest

from gslora_tpu_torch.models import vit as V
from gslora_tpu_torch.models.convert import params_from_jax
from gslora_tpu_torch.ops import attention as A
from gslora_tpu_torch.tools import flagship
from gslora_tpu_torch.tools import integration_continual as IC

from torch_baselines_setup import np_tree, one_torch_thread
from torch_integration_setup import TINY

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)

TASK_KEYS = {"task", "forget_before", "forget_after", "remain_after",
             "old_acc_before", "old_acc", "best_H", "wall_s", "launches"}
LAUNCH_KEYS = {"attention_fwd", "attention_bwd", "attention_fwd_fp32",
               "attention_bwd_fp32", "group_prox", "group_norms",
               "group_scale"}


@pytest.fixture
def k1_calls(monkeypatch):
    """The model's fused-attention calls that would launch K1 on the
    card, counted into ops/attention's forward counters by dtype."""
    fused = V.fused_attention_bhnd

    def counted(q, k, v, scale, plain=False):
        if not plain:
            A.FWD_BY_DTYPE[q.dtype] += 1
        return fused(q, k, v, scale, plain=plain)

    monkeypatch.setattr(V, "fused_attention_bhnd", counted)


@pytest.mark.usefixtures("k1_calls")
@pytest.mark.parametrize("boundary,few_shot,dtype", [
    ("keep", False, "float32"), ("merge_reinit", True, "bfloat16")])
def test_report_holds_task_walls_and_launches(tmp_path, boundary, few_shot,
                                              dtype):
    """The recipe's 4 tasks in the report written and returned, each with
    a positive wall (together within the run's), K1 forward only in the
    run's dtype and in every task (each evaluates and trains), no group
    kernel; the base unchanged under keep, moved by the fold else."""
    model = flagship.model_config(True, tiny=True)
    train, test = flagship.stand_in(model, flagship.noise(True))
    base = params_from_jax(np_tree(0, rank=8, model={
        **TINY, "head_type": "Softmax"}))
    out = tmp_path / "report.json"
    report = IC.run(base, train, test, model, unsaturated=True,
                    boundary=boundary, few_shot=few_shot, device="cpu",
                    epochs=1, compute_dtype=dtype, out=str(out),
                    metrics_dir=str(tmp_path / "metrics"))
    assert json.loads(out.read_text()) == json.loads(json.dumps(report))
    assert [t["task"] for t in report["tasks"]] == [0, 1, 2, 3]
    assert sum(t["wall_s"] for t in report["tasks"]) <= \
        report["wallclock_s"] + 0.1
    fwd = "attention_fwd_fp32" if dtype == "float32" else "attention_fwd"
    for t in report["tasks"]:
        assert set(t) == TASK_KEYS
        assert set(t["launches"]) == LAUNCH_KEYS
        assert t["wall_s"] > 0
        assert t["launches"][fwd] > 0, t
        assert not any(v for k, v in t["launches"].items() if k != fwd), t
        assert 0.0 <= t["remain_after"] <= 100.0
    assert (report["base_change"] > 0) == (boundary == "merge_reinit")
    # the task loop's metrics: every 5th step's losses, each task's norms
    lines = (tmp_path / "metrics" / "metrics.jsonl").read_text()
    records = [json.loads(line) for line in lines.splitlines()]
    assert sum("norm_group_0" in r for r in records) == 4
    assert any("loss_total" in r for r in records)
