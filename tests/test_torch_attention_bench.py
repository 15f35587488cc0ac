"""What gslora_tpu_torch/tools/attention_bench.py does without a card: its
arguments, the published rates it looks up, and the bounds it reports
(fp32 K1 at three TF32 passes on the tensor cores, and at the fp32 rate
outside them; bf16 K1 at the bf16 tensor-core rate)."""
import pytest
import torch

from gslora_tpu_torch.tools import attention_bench as AB

H100 = "NVIDIA H100 80GB HBM3"


def test_arguments():
    args = AB.parse_args([])
    assert (args.baseline, args.dtype) == (None, "float32")
    args = AB.parse_args(["--baseline", ".parent/attention.cu",
                          "--dtype", "bfloat16"])
    assert (args.baseline, args.dtype) == (".parent/attention.cu",
                                           "bfloat16")
    with pytest.raises(SystemExit):
        AB.parse_args(["--dtype", "float16"])


def test_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(SystemExit, match="no CUDA GPU"):
        AB.main([])


@pytest.mark.parametrize("name,rates", [
    (H100, (3.35e12, 989e12, 495e12, 67e12)),
    ("NVIDIA H100 PCIe", (2.0e12, 756e12, 378e12, 51e12)),
    ("NVIDIA H200", (4.8e12, 989e12, 495e12, 67e12))])
def test_card_rates(name, rates):
    assert AB.card_rates(name) == rates


def test_card_rates_refuse_an_unknown_card():
    with pytest.raises(RuntimeError, match="no published rates"):
        AB.card_rates("NVIDIA A100-SXM4-80GB")


def test_fp32_bounds_at_the_flagship_shape():
    """(384, 197, 64) fp32 on the H100: the forward's 4 tensors (77.5 MB)
    take 0.02312 ms at 3.35 TB/s and its two products, three TF32 passes
    each, 0.02312 ms at 495 TF/s; the backward's five products 0.05781 ms
    against 0.04047 ms of bytes. At 67 TF/s outside the tensor cores (the
    FFMA design's bound): 0.05694 and 0.14236 ms."""
    bw, _, tf32, ffma = AB.card_rates(H100)
    b = AB.fp32_bounds(384, 197, 64, bw, tf32, ffma)
    nbytes, flops = AB.k1_work(384, 197, 64, 4)["fwd"]
    assert nbytes == 4 * 384 * 197 * 64 * 4
    assert flops == 2 * 2 * 384 * 197 * 197 * 64
    assert b["fwd"]["bound_ms"] == pytest.approx(0.023123, rel=1e-4)
    assert b["bwd"]["bound_ms"] == pytest.approx(0.057806, rel=1e-4)
    assert b["bwd"]["bound_by"] == "operations"
    assert b["fwd"]["bound_ffma_ms"] == pytest.approx(0.056943, rel=1e-4)
    assert b["bwd"]["bound_ffma_ms"] == pytest.approx(0.142358, rel=1e-4)
    # three passes at the TF32 rate stay below one pass at the FFMA rate
    for key in ("fwd", "bwd"):
        assert b[key]["bound_ms"] < b[key]["bound_ffma_ms"]


def test_bf16_bounds_at_the_flagship_shape():
    bw, bf16, _, _ = AB.card_rates(H100)
    b = AB.bf16_bounds(384, 197, 64, bw, bf16)
    assert b["fwd"] == {"bound_ms": pytest.approx(0.011562, rel=1e-4),
                        "bound_by": "bytes"}
    assert b["bwd"] == {"bound_ms": pytest.approx(0.020233, rel=1e-4),
                        "bound_by": "bytes"}


def test_bound_takes_the_larger_time():
    assert AB.bound(2e9, 1e12, 1e12, 1e15) == (pytest.approx(2.0), "bytes")
    assert AB.bound(1e9, 3e12, 1e12, 1e15) == (pytest.approx(3.0),
                                                "operations")
