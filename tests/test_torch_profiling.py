"""The port's profiler trace (gslora_tpu_torch/utils/profiling.py) and
``--profile_dir`` of cli/train_forget on the CPU; the device-timeline
summary on a hand-made Chrome trace."""
import json

import pytest
import torch

import gslora_tpu_torch.config as tc
from gslora_tpu_torch.utils.profiling import TRACE_FILE, device_summary, \
    trace


def _kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}


def test_device_summary_of_a_known_timeline(tmp_path):
    """Window 0..100 us: kernels a [10, 30), b [20, 40) overlapping, a
    [70, 80); a memcpy [90, 95): busy 30 + 10 + 5 = 45 us."""
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "steps", "ts": 0.0,
         "dur": 100.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 5.0,
         "dur": 50.0},
        _kernel("a", 10.0, 20.0), _kernel("b", 20.0, 20.0),
        _kernel("a", 70.0, 10.0),
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 90.0,
         "dur": 5.0},
        _kernel("outside", 150.0, 10.0),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = device_summary(str(path), window="steps", top=2, gaps=2,
                       families=[("copies", "Memcpy"), ("a", "^a$")])
    assert s["families_ms"] == pytest.approx(
        {"a": 0.03, "other": 0.02, "copies": 0.005})
    assert s["window_ms"] == pytest.approx(0.1)
    assert s["busy_share"] == pytest.approx(0.45)
    assert s["device_events"] == 4
    assert [(k["name"], k["count"]) for k in s["top_kernels"]] == \
        [("a", 2), ("b", 1)]
    assert s["top_kernels"][0]["ms"] == pytest.approx(0.03)
    assert [(g["after"], g["before"]) for g in s["idle_gaps"]] == \
        [("b", "a"), ("(window start)", "a")]
    assert s["idle_gaps"][0]["ms"] == pytest.approx(0.03)
    whole = device_summary(str(path))  # first to last device event
    assert whole["window_ms"] == pytest.approx(0.15)
    with pytest.raises(ValueError, match="no host span"):
        device_summary(str(path), window="missing")
    path.write_text(json.dumps({"traceEvents": events[:2]}))
    with pytest.raises(ValueError, match="no device events"):
        device_summary(str(path))


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)):
        with torch.profiler.record_function("window"):
            torch.randn(8, 8) @ torch.randn(8, 8)
    events = json.loads((tmp_path / TRACE_FILE).read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "window" in names and "aten::mm" in names


def test_train_forget_profile_dir_on_cpu(monkeypatch, tmp_path):
    from gslora_tpu_torch.cli import train_forget
    orig = tc.config_from_args

    def tiny(args):
        cfg = orig(args)
        cfg.model = tc.ViTConfig(image_size=16, patch_size=8, dim=32,
                                 depth=1, heads=2, dim_head=16, mlp_dim=64,
                                 num_class=8, head_type="CosFace")
        return cfg

    monkeypatch.setattr(train_forget, "config_from_args", tiny)
    prof = tmp_path / "prof"
    report = train_forget.main([
        "-d", "synthetic", "--vit_depth", "1", "-b", "8", "-e", "1",
        "--lora_rank", "4", "--num_of_first_cls", "6", "--per_forget_cls",
        "2", "--compute_dtype", "float32", "--device", "cpu",
        "--profile_dir", str(prof), "--outdir", str(tmp_path / "out")])
    assert "forget_acc" in report
    events = json.loads((prof / TRACE_FILE).read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
