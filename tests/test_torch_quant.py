"""The port's W8A8 serving path (gslora_tpu_torch/ops/quant.py and
``ViTConfig.gemm_impl="int8"`` in models/vit.py) against the JAX
package's ops/quant.py and its int8 ``vit_apply``: the same quantized
operands and scales, outputs to 1e-6 relative, the model's logits and
embeddings within ROADMAP's 5e-3 / 1e-3; the envelope cases of
tests/test_quant.py; the train-mode refusal; and the float64-twin check
that chip_smoke.py runs on the card, shown to reject a planted fault."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gslora_tpu.config as jc
from gslora_tpu.models.vit import init_vit_params as jax_init
from gslora_tpu.models.vit import vit_apply as jax_vit_apply
from gslora_tpu.ops import quant as JQ

import gslora_tpu_torch.config as tc
from gslora_tpu_torch.models.convert import params_from_jax
from gslora_tpu_torch.models.vit import init_vit_params, vit_apply, \
    vit_embed
from gslora_tpu_torch.ops import quant as Q


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several processes on one machine: one intra-op
    thread per process keeps torch's idle threads off the others' cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


MODEL = dict(image_size=32, patch_size=8, dim=64, depth=2, heads=4,
             dim_head=16, mlp_dim=128, num_class=10, dropout=0.0,
             emb_dropout=0.0, head_type="Softmax")


def _x(shape, seed, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)) \
        .astype(np.float32)


INPUTS = {
    "gaussian": lambda: _x((64, 96), 0),
    "wide_range": lambda: _x((32, 48), 1) * np.logspace(-3, 3, 48,
                                                         dtype=np.float32),
    "with_zero_column": lambda: np.concatenate(
        [_x((40, 24), 2), np.zeros((40, 8), np.float32)], axis=1),
}


@pytest.mark.parametrize("kind", sorted(INPUTS))
def test_quantizers_match_jax(kind):
    """Equal int8 values and equal fp32 scales, per tensor and per
    channel (the all-zero column takes the 1e-12 floor)."""
    x = INPUTS[kind]()
    for jfn, tfn in ((JQ.quantize_per_tensor, Q.quantize_per_tensor),
                     (JQ.quantize_per_channel, Q.quantize_per_channel)):
        jq, js = jfn(jnp.asarray(x))
        tq, ts = tfn(torch.from_numpy(x))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("shape", [(64, 96, 128), (4, 16, 8), (3, 40, 24)])
def test_int8_linear_matches_jax(shape):
    m, k, n = shape
    x, w = _x((m, k), 3), _x((k, n), 4, scale=0.05)
    want = np.asarray(JQ.int8_linear(jnp.asarray(x), jnp.asarray(w)))
    got = Q.int8_linear(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    twin = Q.int8_linear_reference(torch.from_numpy(x), torch.from_numpy(w))
    assert Q.quant_mismatch(torch.from_numpy(got), twin)["ok"]


def test_quantize_roundtrip_exact_for_representable_values():
    s = 0.5
    x = torch.from_numpy(np.arange(-127, 128, dtype=np.float32) * s)
    q, scale = Q.quantize_per_tensor(x)
    assert float(scale) == s
    np.testing.assert_allclose((q.float() * scale).numpy(), x.numpy(),
                               rtol=1e-6)


def test_per_channel_scales_isolate_columns():
    w = np.ones((8, 2), np.float32)
    w[:, 0] *= 1e-3
    w[:, 1] *= 1e3
    q, s = Q.quantize_per_channel(torch.from_numpy(w))
    np.testing.assert_allclose((q.float() * s).numpy(), w, rtol=0.01)


def test_int8_linear_error_envelope():
    """tests/test_quant.py's envelope: normalized RMS error under 0.02
    against the float product, leading dimensions kept."""
    x, w = torch.from_numpy(_x((64, 96), 0)), torch.from_numpy(_x((96, 128),
                                                                  1))
    y = Q.int8_linear(x, w, out_dtype=torch.float32)
    ref = x @ w
    err = float(torch.sqrt(torch.mean((y - ref) ** 2)) /
                torch.sqrt(torch.mean(ref ** 2)))
    assert err < 0.02, err
    assert y.shape == ref.shape
    y3 = Q.int8_linear(x.reshape(4, 16, 96), w)
    np.testing.assert_allclose(y3.reshape(64, 128).numpy(), y.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_int8_linear_zero_input():
    y = Q.int8_linear(torch.zeros(4, 8), torch.zeros(8, 3))
    assert torch.equal(y, torch.zeros(4, 3))


def test_twin_check_rejects_per_tensor_weight_scales():
    """The card's check holds int8_linear to its float64 twin; a fault
    planted in the product path (one scale for the whole weight instead
    of one per output channel) fails it, on weights whose columns differ
    in range as trained ones do."""
    x = torch.from_numpy(_x((48, 64), 5))
    w = torch.from_numpy(_x((64, 32), 6) *
                         np.linspace(0.1, 2.0, 32, dtype=np.float32))

    def faulty(x, w):
        qx, sx = Q.quantize_per_tensor(x)
        qw, sw = Q.quantize_per_tensor(w)  # the fault
        return Q.int8_matmul(qx, qw).float() * (sx * sw)

    twin = Q.int8_linear_reference(x, w)
    assert Q.quant_mismatch(Q.int8_linear(x, w), twin)["ok"]
    bad = Q.quant_mismatch(faulty(x, w), twin)
    assert not bad["ok"], bad


def _models(rank=4):
    jm = jc.ViTConfig(**MODEL, gemm_impl="int8")
    tm = tc.ViTConfig(**MODEL, gemm_impl="int8")
    p = jax_init(jax.random.key(0), jm, jc.LoraConfig(rank=rank))
    rng = np.random.RandomState(1)
    for name in ("B1", "B2"):  # nonzero B: the LoRA path carries signal
        p["lora"]["ffn"][name] = jnp.asarray(
            0.05 * rng.randn(*p["lora"]["ffn"][name].shape)
            .astype(np.float32))
    p = jax.tree.map(np.asarray, p)
    return jm, tm, p


@pytest.mark.parametrize("lora_apply", ["factored", "merged"])
def test_model_int8_eval_matches_jax(lora_apply):
    """The int8 eval forward of both packages on the same weights and
    images: logits within 5e-3, embeddings within 1e-3."""
    jm, tm, p = _models()
    x = np.random.RandomState(2).randn(16, 3, 32, 32).astype(np.float32)
    y = (np.arange(16) % 10).astype(np.int32)
    jl, je = jax_vit_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                           jnp.asarray(y), jm, jc.LoraConfig(rank=4),
                           train=False, compute_dtype=jnp.float32,
                           lora_apply=lora_apply)
    tl, te = vit_apply(params_from_jax(p), torch.from_numpy(x),
                       torch.from_numpy(y).long(), tm,
                       tc.LoraConfig(rank=4), train=False,
                       compute_dtype=torch.float32, lora_apply=lora_apply)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=5e-3,
                               atol=5e-3)


def test_model_int8_eval_close_to_fp32():
    """tests/test_quant.py's model envelope on the port: embedding cosine
    above 0.99 and top-1 agreement of at least 0.9 against the fp32
    forward."""
    cfg = tc.ViTConfig(**MODEL)
    lora = tc.LoraConfig(rank=4)
    params = init_vit_params(torch.Generator().manual_seed(0), cfg, lora)
    x = torch.from_numpy(np.random.RandomState(1).randn(16, 3, 32, 32)
                         .astype(np.float32))
    y = torch.arange(16) % 10
    lg32, emb32 = vit_apply(params, x, y, cfg, lora,
                            compute_dtype=torch.float32)
    lg8, emb8 = vit_apply(params, x, y,
                          dataclasses.replace(cfg, gemm_impl="int8"), lora,
                          compute_dtype=torch.float32)
    cos = torch.nn.functional.cosine_similarity(emb32, emb8)
    assert float(cos.min()) > 0.99
    agree = float((lg32.argmax(1) == lg8.argmax(1)).float().mean())
    assert agree >= 0.9, agree


def test_int8_refuses_train_mode_as_jax():
    """Both packages refuse a training forward in int8 with the same
    ValueError."""
    jm, tm, p = _models()
    with pytest.raises(ValueError, match="inference/serving") as jerr:
        jax_vit_apply(jax.tree.map(jnp.asarray, p),
                      jnp.zeros((2, 3, 32, 32)), jnp.zeros((2,), jnp.int32),
                      jm, jc.LoraConfig(rank=4), train=True,
                      rng=jax.random.key(1), compute_dtype=jnp.float32)
    with pytest.raises(ValueError, match="inference/serving") as terr:
        vit_embed(params_from_jax(p), torch.zeros(2, 3, 32, 32), tm,
                  tc.LoraConfig(rank=4), train=True,
                  generator=torch.Generator(), compute_dtype=torch.float32)
    assert str(terr.value) == str(jerr.value)
