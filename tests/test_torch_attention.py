"""Attention of the PyTorch port (gslora_tpu_torch/ops/attention.py)
against the JAX package's fused attention, and kernel K1 against its plain
version on the card.

CPU cases: the port's plain version against ``gslora_tpu.ops.attention.
fused_attention``, which runs its Pallas kernel in interpret mode on the
CPU (as tests/test_pallas_attention.py runs it). Inputs come from a numpy
seed, both sides fp32. Also on the CPU: the tolerance the kernel is held
to (``plain_mismatch``) passes a reordering of the sums and rejects
planted faults at the flagship's n, d and scale, in bf16 and in fp32
(where rounding below fp32 anywhere is a fault); and that the model sends
fp32 attention to the kernel path (``FusedAttention`` with plain=False)
under attn_impl "auto".

Card cases (marker ``cuda``): the CUDA kernels (csrc/attention.cu for
bf16, csrc/attention_fp32.cu for fp32) against the plain version in each
dtype, at the flagship shape, at ragged shapes and on the edges of the
64-row tiles and 16-key blocks up to the longest sequence; the backward's
row statistics against ``attention_bwd_stats_plain``; the length limit;
the refusal of other dtypes; and that two launches repeat bit for bit. They skip without a GPU. JAX is imported only inside
the CPU cases, so on a machine with a card and without JAX they run as
``python -m pytest --noconftest -m cuda tests/test_torch_attention.py``.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from gslora_tpu_torch.ops import attention as A


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several processes on one machine: one intra-op
    thread per process keeps torch's idle threads off the others' cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


FLAGSHIP_SCALE = 512 ** -0.5


def _jax_attention(q, k, v, scale, w=None):
    """JAX fused attention (Pallas, interpret mode on the CPU): output and,
    for a cotangent ``w``, the gradients of sum(out * w)."""
    import jax
    import jax.numpy as jnp

    from gslora_tpu.ops.attention import fused_attention

    q, k, v = (jnp.asarray(t) for t in (q, k, v))
    out = np.asarray(fused_attention(q, k, v, scale))
    if w is None:
        return out
    grads = jax.grad(lambda a, b, c: jnp.sum(fused_attention(a, b, c, scale)
                                             * jnp.asarray(w)),
                     argnums=(0, 1, 2))(q, k, v)
    return out, [np.asarray(g) for g in grads]


def _torch_attention(q, k, v, scale, w):
    ts = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    out = A.fused_attention(*ts, scale)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _randn(rng, shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def test_plain_forward_matches_jax():
    rng = np.random.RandomState(0)
    q, k, v = (_randn(rng, (6, 17, 8)) for _ in range(3))
    want = _jax_attention(q, k, v, 0.25)
    got = A.fused_attention(*(torch.from_numpy(t) for t in (q, k, v)), 0.25)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_plain_gradients_match_jax():
    rng = np.random.RandomState(1)
    q, k, v, w = (_randn(rng, (4, 11, 8)) for _ in range(4))
    _, want = _jax_attention(q, k, v, 0.25, w)
    _, got = _torch_attention(q, k, v, 0.25, w)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4,
                                   err_msg=f"d{name}")


@settings(max_examples=10, deadline=None)
@given(bh=st.integers(1, 9), n=st.integers(1, 31), d=st.integers(1, 17),
       seed=st.integers(0, 2**31 - 1))
def test_plain_matches_jax_any_shape(bh, n, d, seed):
    rng = np.random.RandomState(seed)
    q, k, v, w = (_randn(rng, (bh, n, d), 0.5) for _ in range(4))
    scale = float(d) ** -0.5
    want_o, want_g = _jax_attention(q, k, v, scale, w)
    got_o, got_g = _torch_attention(q, k, v, scale, w)
    np.testing.assert_allclose(got_o, want_o, rtol=2e-4, atol=2e-4)
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-4)


def test_bhnd_front_end_and_plain_flag_agree():
    """(b, h, n, d) front end == (BH, n, d) call; the plain flag (the
    model's attn_impl "dpa") computes the same function on the CPU."""
    rng = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(_randn(rng, (2, 3, 9, 8))) for _ in range(3))
    flat = A.fused_attention(*(t.reshape(6, 9, 8) for t in (q, k, v)), 0.3)
    for plain in (False, True):
        o = A.fused_attention_bhnd(q, k, v, 0.3, plain=plain)
        torch.testing.assert_close(o.reshape(6, 9, 8), flat, rtol=0, atol=0)


def test_backward_from_row_statistics_matches_plain():
    """The kernel's split of the backward (row statistics m, l and
    D = rowsum(dp ⊙ p) first, then p = exp(s - m) / l and ddots from them)
    is the direct backward: in fp32 the two agree to float rounding
    (rtol 1e-5, atol 1e-6 on values of order 1e-2 to 1)."""
    rng = np.random.RandomState(4)
    q, k, v, g = (torch.from_numpy(_randn(rng, (3, 70, 16)))
                  for _ in range(4))
    m, l_, dsum = A.attention_bwd_stats_plain(q, k, v, g, 0.25)
    assert m.shape == l_.shape == dsum.shape == (3, 70)
    got = A.attention_bwd_from_stats_plain(q, k, v, g, 0.25, m, l_, dsum)
    want = A.attention_bwd_plain(q, k, v, g, 0.25)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=name)
    dots = torch.einsum("xid,xjd->xij", q, k) * 0.25
    torch.testing.assert_close(m, dots.amax(-1), rtol=0, atol=0)
    torch.testing.assert_close(torch.logsumexp(dots, -1), m + torch.log(l_),
                               rtol=1e-6, atol=1e-6)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never run a plain version themselves: a CPU
    tensor handed to them directly is refused."""
    q = torch.zeros(2, 5, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        A.attention_fwd_kernel(q, q, q, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        A.attention_bwd_kernel(q, q, q, q, 0.1)


def test_launch_counts_untouched_on_cpu():
    A.reset_launch_counts()
    q = torch.randn(2, 5, 8, requires_grad=True)
    A.fused_attention(q, q, q, 0.2).sum().backward()
    assert (A.FWD_LAUNCHES, A.BWD_LAUNCHES) == (0, 0)


# ---------------------------------------------------------------------------
# the tolerance the kernels are held to (A.plain_mismatch), at the flagship's
# n, d and scale, where the values are small (|dq| ~ 0.03 rms)
# ---------------------------------------------------------------------------

DTYPES = [torch.bfloat16, torch.float32]


def _flagship_inputs(dtype, bh=16, seed=3):
    """Inputs at n=197, d=64 (the outputs' size, and so the check's power,
    does not depend on bh)."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(bh, 197, 64, generator=g).to(dtype)
            for _ in range(4)]


def _plain_outputs(q, k, v, g):
    return [A.attention_fwd_plain(q, k, v, FLAGSHIP_SCALE),
            *A.attention_bwd_plain(q, k, v, g, FLAGSHIP_SCALE)]


def _all_ok(got, want):
    return all(A.plain_mismatch(a, b)["ok"] for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_mismatch_check_accepts_reordered_sums(dtype):
    """Permuting the keys (k and v rows together) and the head dim (every
    tensor's columns) leaves the function as it is and reorders the fp32
    sums, which is all a correct kernel changes: the check passes it."""
    q, k, v, g = _flagship_inputs(dtype)
    keys = torch.randperm(197, generator=torch.Generator().manual_seed(0))
    cols = torch.randperm(64, generator=torch.Generator().manual_seed(1))
    o, dq, dk, dv = _plain_outputs(q[..., cols], k[:, keys][..., cols],
                                   v[:, keys][..., cols], g[..., cols])
    back_k, back_c = torch.argsort(keys), torch.argsort(cols)
    got = [o[..., back_c], dq[..., back_c], dk[:, back_k][..., back_c],
           dv[:, back_k][..., back_c]]
    want = _plain_outputs(q, k, v, g)
    assert any((a != b).any() for a, b in zip(got, want))
    assert _all_ok(got, want)


def _tf32(t):
    """t rounded to TF32 (10 mantissa bits, to nearest), what single-pass
    TF32 tensor cores read."""
    bits = t.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_product(eq, a, b, passes):
    """einsum(eq, a, b) as fp32 K1's tensor cores take it: each operand
    split into hi = tf32(x) and lo = tf32(x - hi), and the product summed
    in fp32 as (lo_a hi_b + hi_a lo_b) + hi_a hi_b, the small terms first
    (three passes); two passes drop lo_a hi_b, one keeps hi_a hi_b alone."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    out = torch.einsum(eq, a_hi, b_hi)
    if passes == 1:
        return out
    cross = torch.einsum(eq, a_hi, b_lo)
    if passes == 3:
        cross = torch.einsum(eq, a_lo, b_hi) + cross
    return cross + out


def _tf32_outputs(q, k, v, g, passes):
    """o, dq, dk, dv with every product of the forward and backward (p and
    ddots split too) on ``passes``-pass TF32, everything else in fp32."""
    def mm(eq, a, b):
        return _tf32_product(eq, a, b, passes)

    p = torch.softmax(mm("xid,xjd->xij", q, k) * FLAGSHIP_SCALE, dim=-1)
    dp = mm("xid,xjd->xij", g, v)
    dd = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    return [mm("xij,xjd->xid", p, v),
            mm("xij,xjd->xid", dd, k) * FLAGSHIP_SCALE,
            mm("xij,xid->xjd", dd, q) * FLAGSHIP_SCALE,
            mm("xij,xid->xjd", p, g)]


@pytest.mark.parametrize("bh,n,d", [(16, 197, 64), (16, 256, 128),
                                    (6, 17, 64)])
def test_three_pass_tf32_passes_fp32_limits(bh, n, d):
    """The fp32 kernel's arithmetic, emulated: every product on three TF32
    passes lands near 1e-6 of the plain fp32 version, inside the fp32
    limits of plain_mismatch at the flagship's n and d, the longest
    sequence at d = 128 and a ragged shape."""
    gen = torch.Generator().manual_seed(7)
    q, k, v, g = (torch.randn(bh, n, d, generator=gen) for _ in range(4))
    got = _tf32_outputs(q, k, v, g, passes=3)
    want = _plain_outputs(q, k, v, g)
    for a, b in zip(got, want):
        m = A.plain_mismatch(a, b)
        assert m["ok"] and m["max_rel"] < 1e-5 and m["rel_l2"] < 5e-6, m


def _faulty_outputs(fault, q, k, v, g):
    """What a kernel with a planted fault would return."""
    o, dq, dk, dv = _plain_outputs(q, k, v, g)
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    if fault == "no_rowsum":  # ddots = p * dp, without the fp32 rowsum
        p = torch.softmax(torch.einsum("xid,xjd->xij", qf, kf)
                          * FLAGSHIP_SCALE, dim=-1)
        dd = (p * torch.einsum("xid,xjd->xij", gf, vf)).to(q.dtype).float()
        dq = (torch.einsum("xij,xjd->xid", dd, kf)
              * FLAGSHIP_SCALE).to(q.dtype)
        dk = (torch.einsum("xij,xid->xjd", dd, qf)
              * FLAGSHIP_SCALE).to(q.dtype)
    elif fault == "dq_scale_1pct":
        dq = (dq.float() * 1.01).to(q.dtype)
    elif fault == "unmasked_pad_key":  # one zero key/value row in the softmax
        kp, vp = (torch.cat([t, torch.zeros_like(t[:, :1])], dim=1)
                  for t in (k, v))
        o, dq, dk, dv = _plain_outputs(q, kp, vp, g)
        dk, dv = dk[:, :-1], dv[:, :-1]
    elif fault == "tf32_operands":  # products on single-pass TF32
        o, dq, dk, dv = _plain_outputs(*(_tf32(t) for t in (q, k, v, g)))
    elif fault == "tf32_two_pass":  # three-pass TF32 with lo·hi dropped
        o, dq, dk, dv = _tf32_outputs(qf, kf, vf, gf, passes=2)
    elif fault == "p_bf16":  # p rounded to bf16 before p v and pᵀ g
        p = torch.softmax(torch.einsum("xid,xjd->xij", qf, kf)
                          * FLAGSHIP_SCALE, dim=-1)
        pb = p.to(torch.bfloat16).float()
        o = torch.einsum("xij,xjd->xid", pb, vf)
        dv = torch.einsum("xij,xid->xjd", pb, gf)
    elif fault == "bf16_path":  # the bf16 kernel's function, cast back
        o, dq, dk, dv = (t.to(q.dtype) for t in _plain_outputs(
            *(t.to(torch.bfloat16) for t in (q, k, v, g))))
    return [o, dq, dk, dv]


FAULTS = ["no_rowsum", "dq_scale_1pct", "unmasked_pad_key"]
# rounding below fp32: faults of the fp32 kernel only (the bf16 kernel
# rounds there by design)
FP32_FAULTS = ["tf32_operands", "tf32_two_pass", "p_bf16", "bf16_path"]


@pytest.mark.parametrize("dtype,fault", [
    *((torch.bfloat16, f) for f in FAULTS),
    *((torch.float32, f) for f in FAULTS + FP32_FAULTS)],
    ids=lambda x: str(x).replace("torch.", ""))
def test_mismatch_check_rejects_planted_faults(dtype, fault):
    q, k, v, g = _flagship_inputs(dtype)
    want = _plain_outputs(q, k, v, g)
    assert _all_ok(want, want)
    assert not _all_ok(_faulty_outputs(fault, q, k, v, g), want)


def test_model_sends_fp32_attention_to_the_kernel_path(monkeypatch):
    """Under attn_impl "auto" an fp32 model's attention goes through
    FusedAttention with plain=False, as bf16's does: on the card that is
    the fp32 kernel (a CPU tensor takes the plain version inside it)."""
    from gslora_tpu_torch.config import LoraConfig, ViTConfig
    from gslora_tpu_torch.models.vit import init_vit_params, vit_apply

    calls = []
    apply = A.FusedAttention.apply

    def spy(q, k, v, scale, plain):
        calls.append((q.dtype, plain))
        return apply(q, k, v, scale, plain)

    monkeypatch.setattr(A.FusedAttention, "apply", spy)
    model = ViTConfig(image_size=16, patch_size=8, dim=32, depth=2, heads=2,
                      dim_head=16, mlp_dim=64, num_class=5, dropout=0.0,
                      emb_dropout=0.0, head_type="Softmax")
    assert model.attn_impl == "auto"
    lora = LoraConfig(rank=2)
    params = init_vit_params(torch.Generator().manual_seed(0), model, lora)
    images = torch.from_numpy(np.random.RandomState(0).rand(
        2, 3, 16, 16).astype(np.float32))
    logits, _ = vit_apply(params, images, torch.tensor([0, 1]), model, lora,
                          compute_dtype=torch.float32)
    assert torch.isfinite(logits).all()
    assert calls == [(torch.float32, False)] * model.depth


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _card_inputs(bh, n, d, device, seed=0, dtype=torch.bfloat16):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(bh, n, d, generator=g).to(device, dtype)
            for _ in range(4)]


def _assert_matches_plain(got, want, names, where):
    for name, a, b in zip(names, got, want):
        m = A.plain_mismatch(a, b)
        print(f"kernel vs plain {where} {name}: {m}")
        assert m["ok"], f"{name} at {where}: {m}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("bh,n,d", [
    (384, 197, 64), (6, 17, 64), (5, 1, 64), (3, 33, 16), (2, 70, 32),
    (2, 40, 128),
    # edges of the 64-row tiles, of the 16-key blocks and of a last query
    # tile of 1 to 3 such blocks, and the longest sequence
    (7, 63, 64), (7, 64, 64), (7, 65, 64), (5, 128, 64), (5, 129, 64),
    (5, 49, 64), (5, 193, 64), (5, 208, 64), (4, 232, 64),
    (4, A.KERNEL_MAX_N, 64), (3, A.KERNEL_MAX_N, 128)])
def test_kernel_matches_plain(cuda_device, bh, n, d, dtype):
    q, k, v, g = _card_inputs(bh, n, d, cuda_device, dtype=dtype)
    o = A.attention_fwd_kernel(q, k, v, FLAGSHIP_SCALE)
    torch.cuda.synchronize()
    got = A.attention_bwd_kernel(q, k, v, g, FLAGSHIP_SCALE)
    torch.cuda.synchronize()
    _assert_matches_plain([o, *got], _plain_outputs(q, k, v, g),
                          ("o", "dq", "dk", "dv"), (bh, n, d, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_autograd_goes_through_kernels(cuda_device, dtype):
    q, k, v, g = _card_inputs(4, 197, 64, cuda_device, seed=1, dtype=dtype)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    A.reset_launch_counts()
    out = A.fused_attention(q, k, v, FLAGSHIP_SCALE)
    out.backward(g)
    torch.cuda.synchronize()
    assert (A.FWD_LAUNCHES, A.BWD_LAUNCHES) == (1, 1)
    assert (A.FWD_BY_DTYPE[dtype], A.BWD_BY_DTYPE[dtype]) == (1, 1)
    ref = A.attention_bwd_plain(q.detach(), k.detach(), v.detach(), g,
                                FLAGSHIP_SCALE)
    _assert_matches_plain([q.grad, k.grad, v.grad], ref,
                          ("dq", "dk", "dv"), "autograd")


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    q, k, v, _ = _card_inputs(2, 17, 64, cuda_device)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        A.attention_fwd_kernel(q.half(), k.half(), v.half(), 0.1)
    with pytest.raises(ValueError, match="head dims"):
        A.attention_fwd_kernel(q[..., :8].contiguous(),
                               k[..., :8].contiguous(),
                               v[..., :8].contiguous(), 0.1)


@pytest.mark.cuda
def test_kernel_refuses_one_past_the_longest_sequence(cuda_device):
    q, k, v, g = _card_inputs(1, A.KERNEL_MAX_N + 1, 64, cuda_device)
    with pytest.raises(ValueError, match=f"n <= {A.KERNEL_MAX_N}"):
        A.attention_fwd_kernel(q, k, v, 0.1)
    with pytest.raises(ValueError, match=f"n <= {A.KERNEL_MAX_N}"):
        A.attention_bwd_kernel(q, k, v, g, 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_kernel_repeats_bit_for_bit(cuda_device, dtype):
    """No atomics and a fixed order of every sum: a second launch on the
    same inputs gives the same bits."""
    q, k, v, g = _card_inputs(96, 197, 64, cuda_device, seed=2, dtype=dtype)
    first = [A.attention_fwd_kernel(q, k, v, FLAGSHIP_SCALE),
             *A.attention_bwd_kernel(q, k, v, g, FLAGSHIP_SCALE)]
    second = [A.attention_fwd_kernel(q, k, v, FLAGSHIP_SCALE),
              *A.attention_bwd_kernel(q, k, v, g, FLAGSHIP_SCALE)]
    torch.cuda.synchronize()
    for name, a, b in zip(("o", "dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("bh,n,d", [(384, 197, 64), (5, 65, 32)])
def test_backward_row_statistics_match_plain(cuda_device, bh, n, d, dtype):
    """The rows kernel's m, l and D against attention_bwd_stats_plain on the
    same inputs: fp32 values that differ only in the order of sums, each
    held to 1e-4 of its largest magnitude; its 1 / l is the correctly
    rounded reciprocal of its l."""
    q, k, v, g = _card_inputs(bh, n, d, cuda_device, seed=5, dtype=dtype)
    _, stats = A.attention_bwd_rows_kernel(q, k, v, g, FLAGSHIP_SCALE)
    torch.cuda.synchronize()
    got = dict(zip(A.STATS, stats))
    want = A.attention_bwd_stats_plain(q, k, v, g, FLAGSHIP_SCALE)
    for name, b in zip(("m", "l", "D"), want):
        err = float((got[name] - b).abs().max())
        print(f"row statistics {name} at {(bh, n, d, dtype)}: max abs "
              f"{err}")
        assert err <= 1e-4 * float(b.abs().max()), name
    assert torch.equal(got["inv_l"], 1.0 / got["l"])
