"""Both forget CLIs run every baseline under ``--dp``: two gloo ranks on
the CPU (tests/torch_dp_baselines_worker.py, spawned once for the module)
launch ``train_forget_cl --dp`` with each of the eleven methods in turn
(Retrain, Replay, L2, EWC, MAS, LwF, DER, DER++, FDR, SCRUB, LIRF; two
tasks each, the continual tests' flags, tests/torch_baselines_setup.py
CL_ARGS) and ``train_forget --dp`` with ``--ewc`` and ``--retrain``. Each
report is held to the port's one-process CLI (no --dp, ragged tails on
the CPU): every accuracy, H and old-class accuracy within 1e-3 (the same
predictions), as the JAX suite holds a mesh run to one device
(tests/test_mesh_loop.py:131-132); rank 0 alone writes the report, the
metrics and the task snapshots."""
import json

import pytest

import torch_dp_baselines_worker as W
from torch_baselines_setup import one_torch_thread

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)

ACC_TOL = 1e-3
NAMES = list(W.CLI_RUNS)


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """Every CLI run on 2 gloo ranks (started first) and in one process."""
    out = tmp_path_factory.mktemp("dp_baselines_cli")
    procs = W.start_ranks(out, NAMES)
    try:
        one = {name: W.run(name, {}) for name in NAMES}
    except BaseException:
        for proc in procs:
            proc.kill()
            proc.wait()
        raise
    return {"ranks": W.collect(procs, out, NAMES), "one": one, "dir": out}


@pytest.mark.parametrize("name", NAMES)
def test_dp_cli_report_equals_one_process(reports, name):
    want = json.loads(json.dumps(reports["one"][name]))
    for rank in reports["ranks"]:
        got = json.loads(json.dumps(rank[name]))
        assert type(got) is type(want)
        for g, w in zip(*(r if isinstance(r, list) else [r]
                          for r in (got, want))):
            assert set(g) == set(w)
            for k, v in w.items():
                if isinstance(v, float):
                    assert abs(g[k] - v) < ACC_TOL, (name, k, g[k], v)
                else:
                    assert g[k] == v, (name, k, g[k], v)
    tasks = want if isinstance(want, list) else [want]
    assert len(tasks) == (2 if name.startswith("cl_") else 1)
    # the runs score something: the model forgets or the remain holds
    assert any(t["forget_acc"] != t["forget_acc_before"] or
               t["remain_acc"] > 0 for t in tasks)
    # rank 0 alone writes the report, the metrics and the task snapshots
    main, other = (reports["dir"] / f"{name}.out{r}" for r in (0, 1))
    written = sorted(p.relative_to(main).as_posix()
                     for p in main.rglob("*") if p.is_file())
    assert "report.json" in written and "metrics.jsonl" in written
    assert json.loads((main / "report.json").read_text()) == \
        json.loads(json.dumps(reports["ranks"][0][name]))
    if name.startswith("cl_"):
        assert {f"task-level/Backbone_task_{t}.pth" for t in (0, 1)} <= \
            set(written)
    assert not other.exists() or not any(
        p.is_file() for p in other.rglob("*"))
