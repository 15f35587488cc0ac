"""Group-Lasso kernels of the PyTorch port (gslora_tpu_torch/ops/
group_lasso.py): K2 (group prox) and K3 (group norms, rescale, and the
fused group-Lasso built on them).

CPU cases: the port's plain versions against the JAX package's Pallas
kernels (``group_prox_pallas``, ``group_lasso_pallas``), which run in
interpret mode on the CPU as tests/test_pallas_ops.py runs them. Inputs
come from a numpy seed. Tolerances: value rtol 1e-5, gradients rtol 1e-4 /
atol 1e-5, prox outputs rtol 1e-5 (fp32: the two differ only in the order
of the fp32 sums); bf16 inputs within one bf16 ulp. Also on the CPU: the
tolerance the kernels are held to (``group_mismatch``) rejects faults
planted in the plain version at the flagship shape.

The launch plan (``group_plan``, ``share_edges``) is checked on the CPU:
every element of every span has exactly one owner at any base alignment,
share edges sit on 16-byte addresses, and the shared memory stays within
its budget.

Card cases (marker ``cuda``): the CUDA kernels (csrc/group_lasso.cu)
against the plain versions at the flagship LoRA shapes, ViT-B/16's rank-8
LoRA and ragged ones, fp32 and bf16, with an all-zero layer and a
threshold that kills some layers and shrinks the others; on the streamed
path, at cluster sizes 8 and 16, at unaligned bases, in place, and two
launches bit for bit. They skip without a GPU. JAX is imported
only inside the CPU cases, so on a machine with a card and without JAX
they run as
``python -m pytest --noconftest -m cuda tests/test_torch_group_lasso.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from gslora_tpu_torch.ops import group_lasso as G


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several processes on one machine: one intra-op
    thread per process keeps torch's idle threads off the others' cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


FLAGSHIP = (6, 8, 512, 2048)  # L, r, d, m of the flagship FFN LoRA
VIT_B = (12, 8, 768, 3072)  # ViT-B/16's rank-8 FFN LoRA
RAGGED = [(1, 1, 1, 3), (3, 5, 17, 33)]


def _factors(L, r, d, m, seed=0, zero_layer=None, spread=True):
    """A1 (L,r,d), B1 (L,m,r), A2 (L,r,m), B2 (L,d,r) as numpy fp32; with
    ``spread`` layer l is scaled by (l + 1), so the layer norms differ."""
    rng = np.random.RandomState(seed)
    out = []
    for shape in ((L, r, d), (L, m, r), (L, r, m), (L, d, r)):
        a = rng.randn(*shape).astype(np.float32) * 0.3
        if spread:
            a *= np.arange(1, L + 1, dtype=np.float32).reshape(-1, 1, 1)
        if zero_layer is not None:
            a[zero_layer] = 0.0
        out.append(a)
    return out


def _killing_threshold(parts):
    """A threshold between the smallest nonzero layer norm and the next:
    that layer dies, the larger ones shrink."""
    norms = np.sqrt(sum((p.astype(np.float64).reshape(p.shape[0], -1) ** 2)
                        .sum(1) for p in parts))
    live = np.sort(norms[norms > 0])
    if len(live) == 1:
        return float(live[0]) * 0.5
    return float(0.5 * (live[0] + live[1]))


def _bf16_np(parts):
    """Round fp32 numpy factors to bf16 values (kept as fp32 numpy)."""
    return [torch.from_numpy(p).to(torch.bfloat16).float().numpy()
            for p in parts]


# ---------------------------------------------------------------------------
# plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def _jax_value_and_grads(parts, dtype="float32"):
    import jax
    import jax.numpy as jnp

    from gslora_tpu.ops.group_lasso import group_lasso_pallas

    args = [jnp.asarray(p, dtype) for p in parts]
    val, grads = jax.value_and_grad(
        lambda *a: group_lasso_pallas(*a), argnums=(0, 1, 2, 3))(*args)
    return float(val), [np.array(g.astype(jnp.float32)) for g in grads]


def _torch_value_and_grads(parts, dtype=torch.float32):
    ts = [torch.from_numpy(p).to(dtype).requires_grad_(True) for p in parts]
    val = G.group_lasso_fused(*ts)
    val.backward()
    return float(val.detach()), [t.grad for t in ts]


def _jax_prox(parts, thr, dtype="float32"):
    import jax.numpy as jnp

    from gslora_tpu.ops.group_lasso import group_prox_pallas

    outs = group_prox_pallas(*(jnp.asarray(p, dtype) for p in parts), thr)
    return [np.array(o.astype(jnp.float32)) for o in outs]


def _assert_bf16_within_ulp(got, want, what):
    m = G.group_mismatch(got, torch.from_numpy(want).to(torch.bfloat16))
    assert m["ok"], f"{what}: {m}"


@pytest.mark.parametrize("zero_layer", [None, 0])
def test_fused_value_and_grads_match_pallas(zero_layer):
    parts = _factors(3, 4, 10, 14, seed=1, zero_layer=zero_layer)
    want_v, want_g = _jax_value_and_grads(parts)
    got_v, got_g = _torch_value_and_grads(parts)
    np.testing.assert_allclose(got_v, want_v, rtol=1e-5)
    for name, a, b in zip(("A1", "B1", "A2", "B2"), got_g, want_g):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_norms_match_pallas_value():
    parts = _factors(4, 3, 9, 11, seed=2)
    want_v, _ = _jax_value_and_grads(parts)
    norms = G.group_norms_plain(*(torch.from_numpy(p) for p in parts))
    assert norms.shape == (4,) and norms.dtype == torch.float32
    np.testing.assert_allclose(float(norms.sum()), want_v, rtol=1e-5)


@pytest.mark.parametrize("zero_layer", [None, 1])
def test_prox_matches_pallas(zero_layer):
    parts = _factors(3, 4, 10, 14, seed=3, zero_layer=zero_layer)
    thr = _killing_threshold(parts)
    want = _jax_prox(parts, thr)
    got = G.group_prox_plain(*(torch.from_numpy(p) for p in parts), thr)
    for name, a, b in zip(("A1", "B1", "A2", "B2"), got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    killed = G.group_norms_plain(*got)
    assert (killed == 0).sum() >= 1 + (zero_layer is not None)
    assert (killed > 0).any()


def test_bf16_prox_and_grads_within_one_ulp_of_pallas():
    parts = _bf16_np(_factors(3, 4, 10, 14, seed=4, zero_layer=2))
    thr = _killing_threshold(parts)
    want = _jax_prox(parts, thr, "bfloat16")
    got = G.group_prox_plain(*(torch.from_numpy(p).to(torch.bfloat16)
                               for p in parts), thr)
    for name, a, b in zip(("A1", "B1", "A2", "B2"), got, want):
        assert a.dtype == torch.bfloat16
        _assert_bf16_within_ulp(a, b, f"prox {name}")
    want_v, want_g = _jax_value_and_grads(parts, "bfloat16")
    got_v, got_g = _torch_value_and_grads(parts, torch.bfloat16)
    np.testing.assert_allclose(got_v, want_v, rtol=1e-5)
    for name, a, b in zip(("A1", "B1", "A2", "B2"), got_g, want_g):
        assert a.dtype == torch.bfloat16
        _assert_bf16_within_ulp(a, b, f"grad {name}")


@settings(max_examples=8, deadline=None)
@given(L=st.integers(1, 5), r=st.integers(1, 6), d=st.integers(1, 16),
       m=st.integers(1, 16), thr=st.floats(0.0, 5.0),
       seed=st.integers(0, 2**31 - 1), zero_layer=st.booleans())
def test_plain_matches_pallas_any_shape(L, r, d, m, thr, seed, zero_layer):
    """Value, gradients and prox of arbitrary stacked LoRA shapes down to
    one element per span, with an all-zero group (the clamp edge)."""
    parts = _factors(L, r, d, m, seed=seed, zero_layer=0 if zero_layer
                     else None, spread=False)
    want_v, want_g = _jax_value_and_grads(parts)
    got_v, got_g = _torch_value_and_grads(parts)
    np.testing.assert_allclose(got_v, want_v, rtol=1e-5, atol=1e-6)
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5)
    want = _jax_prox(parts, thr)
    got = G.group_prox_plain(*(torch.from_numpy(p) for p in parts), thr)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6)


def test_fp32_threshold_is_the_fp32_product():
    import jax.numpy as jnp

    for lr, alpha in ((1e-3, 300.0), (0.01, 1e4), (3e-4, 0.7), (0.1, 0.1)):
        want = float(jnp.float32(lr) * jnp.float32(alpha))
        assert G.fp32_threshold(lr, alpha) == want


# ---------------------------------------------------------------------------
# the tree front end and the device dispatch (CPU)
# ---------------------------------------------------------------------------


def test_lora_group_prox_in_place_and_no_op_trees():
    parts = _factors(2, 3, 5, 7, seed=5)
    thr = _killing_threshold(parts)
    tree = {"ffn": dict(zip(("A1", "B1", "A2", "B2"),
                            (torch.from_numpy(p.copy()) for p in parts)))}
    ids = {k: id(v) for k, v in tree["ffn"].items()}
    want = G.group_prox_plain(*(torch.from_numpy(p) for p in parts), thr)
    assert G.lora_group_prox(tree, thr) is tree
    for name, w in zip(("A1", "B1", "A2", "B2"), want):
        assert id(tree["ffn"][name]) == ids[name]  # updated in place
        torch.testing.assert_close(tree["ffn"][name], w, rtol=0, atol=0)
    assert G.lora_group_prox({}, thr) == {}
    attn = {"attn": {"A": torch.ones(2, 3, 4, 5)}}
    assert G.lora_group_prox(attn, 1e9) is attn
    assert bool((attn["attn"]["A"] == 1).all())


def test_kernel_wrappers_refuse_cpu_tensors():
    ts = [torch.from_numpy(p) for p in _factors(2, 3, 5, 7)]
    with pytest.raises(ValueError, match="CUDA"):
        G.group_prox_kernel(*ts, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        G.group_norms_kernel(*ts)
    with pytest.raises(ValueError, match="CUDA"):
        G.group_scale_kernel(*ts, torch.ones(2))


def test_launch_counts_untouched_on_cpu():
    G.reset_launch_counts()
    ts = [torch.from_numpy(p).requires_grad_(True)
          for p in _factors(2, 3, 5, 7)]
    G.group_lasso_fused(*ts).backward()
    G.lora_group_prox({"ffn": dict(zip(("A1", "B1", "A2", "B2"),
                                       (t.detach() for t in ts)))}, 0.5)
    assert (G.PROX_LAUNCHES, G.NORMS_LAUNCHES, G.SCALE_LAUNCHES) == (0, 0, 0)


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------


def _spans(shape):
    L, r, d, m = shape
    return L, (r * d, m * r, r * m, d * r)


def _assert_plan_covers(plan, n, esize, bases, L):
    """Every element of every span of every layer owned exactly once; body
    edges on 16-byte addresses; shares within the plan's vectors."""
    V = 16 // esize
    for t, nt in enumerate(n):
        for l in range(L):
            mis = bases[t] * esize + l * nt * esize
            owners = np.zeros(nt, np.int64)
            for rank in range(plan.blocks):
                head, lo, hi, tail0 = G.share_edges(plan, t, nt, esize, mis,
                                                    rank)
                assert 0 <= head < V or head == nt
                assert head <= lo <= hi <= tail0 <= nt and nt - tail0 < V
                assert hi - lo <= plan.vecs[t] * V
                if hi > lo:
                    assert (mis + lo * esize) % 16 == 0
                    assert (mis + hi * esize) % 16 == 0
                owners[lo:hi] += 1
                if rank == plan.edge_owner:
                    owners[:head] += 1
                    owners[tail0:] += 1
            assert (owners == 1).all(), (t, l, np.flatnonzero(owners != 1))


@settings(max_examples=40, deadline=None)
@given(L=st.integers(1, 4), r=st.integers(1, 16), d=st.integers(1, 800),
       m=st.integers(1, 3100), bf16=st.booleans(),
       bases=st.lists(st.integers(0, 7), min_size=4, max_size=4),
       cluster=st.sampled_from([None, 1, 2, 3, 8, 16, 40]),
       budget=st.sampled_from([None, 0, 64, 4096, G.SMEM_LIMIT]))
def test_plan_owns_every_element_once(L, r, d, m, bf16, bases, cluster,
                                      budget):
    dtype = torch.bfloat16 if bf16 else torch.float32
    esize = 2 if bf16 else 4
    _, n = _spans((L, r, d, m))
    plan = G.group_plan(L, *n, dtype, cluster=cluster,
                        max_share_bytes=budget)
    assert plan.blocks == (G.CLUSTER if cluster is None else cluster)
    assert 0 <= plan.edge_owner < plan.blocks
    share = 16 * sum(plan.vecs)
    limit = G.MAX_SHARE_BYTES if budget is None else budget
    assert plan.onchip == (share <= limit)
    assert plan.smem_bytes == (share if plan.onchip else 0)
    assert plan.smem_bytes <= min(limit, G.SMEM_LIMIT)
    _assert_plan_covers(plan, n, esize, [b % (16 // esize) for b in bases],
                        L)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [FLAGSHIP, VIT_B])
def test_plan_defaults_hold_the_share_on_chip(shape, dtype):
    L, n = _spans(shape)
    plan = G.group_plan(L, *n, dtype)
    esize = 4 if dtype == torch.float32 else 2
    assert plan.blocks == G.CLUSTER == 8 and plan.onchip
    # the layer's bytes, split evenly over the cluster (30 KB per block at
    # ViT-B/16 in fp32)
    assert plan.smem_bytes == sum(n) * esize // 8
    _assert_plan_covers(plan, n, esize, [0, 1, 2, 3], L)
    small = G.group_plan(L, *n, dtype, max_share_bytes=1024)
    assert not small.onchip and small.smem_bytes == 0
    assert small.vecs == plan.vecs
    scale = G.group_plan(L, *n, dtype, cluster=G.SCALE_BLOCKS,
                         max_share_bytes=0)
    assert scale.blocks == G.SCALE_BLOCKS and not scale.onchip


def test_plan_refuses_what_the_kernels_cannot_run():
    for bad in (dict(L=0), dict(cluster=0), dict(cluster=G.MAX_BLOCKS + 1),
                dict(max_share_bytes=G.SMEM_LIMIT + 1),
                dict(max_share_bytes=-1)):
        args = dict(L=2, cluster=None, max_share_bytes=None)
        args.update(bad)
        with pytest.raises(ValueError, match="group plan"):
            G.group_plan(args["L"], 4, 4, 4, 4, torch.float32,
                         cluster=args["cluster"],
                         max_share_bytes=args["max_share_bytes"])
    with pytest.raises(ValueError, match="group plan"):
        G.group_plan(2, 4, 0, 4, 4, torch.float32)


# ---------------------------------------------------------------------------
# the tolerance the kernels are held to (G.group_mismatch), at the flagship
# ---------------------------------------------------------------------------


def _flagship(dtype):
    parts = _factors(*FLAGSHIP, seed=6, spread=True)
    # layer 0 small, so the threshold kills it and shrinks the rest
    for p in parts:
        p[0] *= 0.05
    return [torch.from_numpy(p).to(dtype) for p in parts], \
        _killing_threshold(parts)


def _faulty_prox(fault, ts, thr):
    """What a prox kernel with a planted fault would return."""
    A1, B1, A2, B2 = ts
    if fault == "tensor_left_out":  # B2 missing from the norm
        s = G._layer_sqsum(A1) + G._layer_sqsum(B1) + G._layer_sqsum(A2)
        scale = torch.clamp_min(1.0 - thr / torch.sqrt(s), 0.0)
        return G.group_scale_plain(*ts, scale.to(A1.dtype))
    if fault == "no_max0":  # max(0, .) dropped
        norm = G.group_norms_plain(*ts)
        return G.group_scale_plain(*ts, (1.0 - thr / norm).to(A1.dtype))
    outs = [t.clone() for t in G.group_prox_plain(*ts, thr)]
    if fault == "tail_unscaled":  # last element of each A2 span unscaled
        outs[2].view(outs[2].shape[0], -1)[:, -1] = \
            A2.view(A2.shape[0], -1)[:, -1]
    return outs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fault", ["tensor_left_out", "no_max0",
                                   "tail_unscaled"])
def test_mismatch_check_rejects_planted_faults(fault, dtype):
    ts, thr = _flagship(dtype)
    want = G.group_prox_plain(*ts, thr)
    assert all(G.group_mismatch(w, w)["ok"] for w in want)
    got = _faulty_prox(fault, ts, thr)
    assert not all(G.group_mismatch(a, b)["ok"] for a, b in zip(got, want))


def test_mismatch_check_norms_and_reordered_sums():
    """A reordering of the fp32 sums (what a right kernel changes) passes;
    a tensor left out of the norms fails."""
    ts, _ = _flagship(torch.float32)
    want = G.group_norms_plain(*ts)
    perm = [t.reshape(t.shape[0], -1).flip(-1) for t in ts]
    got = torch.sqrt(sum(torch.sum(p.double() ** 2, -1) for p in perm)
                     ).float()
    assert G.group_mismatch(got, want, norms=True)["ok"]
    short = torch.sqrt(sum(G._layer_sqsum(t) for t in ts[:3]))
    assert not G.group_mismatch(short, want, norms=True)["ok"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _card_case(shape, dtype, device, seed=0):
    """Four factors on the card with layer 0 all zero and a threshold that
    kills the smallest live layer and shrinks the others."""
    L = shape[0]
    parts = _factors(*shape, seed=seed, zero_layer=0 if L > 1 else None)
    if dtype == torch.bfloat16:
        parts = _bf16_np(parts)
    thr = _killing_threshold(parts)
    return [torch.from_numpy(p).to(device, dtype) for p in parts], thr


def _assert_ok(got, want, what, norms=False):
    m = G.group_mismatch(got, want, norms=norms)
    print(f"kernel vs plain {what}: {m}")
    assert m["ok"], f"{what}: {m}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [FLAGSHIP, VIT_B] + RAGGED)
def test_kernels_match_plain(cuda_device, shape, dtype):
    ts, thr = _card_case(shape, dtype, cuda_device)
    norms = G.group_norms_kernel(*ts)
    prox = G.group_prox_kernel(*ts, thr)
    inv = (1.0 / torch.clamp_min(norms, 1e-12)).to(dtype)
    scaled = G.group_scale_kernel(*ts, inv)
    torch.cuda.synchronize()
    _assert_ok(norms, G.group_norms_plain(*ts), f"norms {shape}", norms=True)
    for name, a, b in zip(("A1", "B1", "A2", "B2"), prox,
                          G.group_prox_plain(*ts, thr)):
        _assert_ok(a, b, f"prox {name} {shape} {dtype}")
    for name, a, b in zip(("A1", "B1", "A2", "B2"), scaled,
                          G.group_scale_plain(*ts, inv)):
        _assert_ok(a, b, f"scale {name} {shape} {dtype}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 5, 17, 33), FLAGSHIP, VIT_B])
def test_in_place_prox_equals_out_of_place(cuda_device, dtype, shape):
    ts, thr = _card_case(shape, dtype, cuda_device, seed=1)
    want = G.group_prox_kernel(*ts, thr)
    tree = {"ffn": dict(zip(("A1", "B1", "A2", "B2"),
                            (t.clone() for t in ts)))}
    G.reset_launch_counts()
    G.lora_group_prox(tree, thr)
    torch.cuda.synchronize()
    assert G.PROX_LAUNCHES == 1
    for name, w in zip(("A1", "B1", "A2", "B2"), want):
        assert torch.equal(tree["ffn"][name], w), name
    # the streamed path, in place, gives the same bits as the on-chip one
    L, n = _spans(shape)
    streamed = G.group_plan(L, *n, dtype, max_share_bytes=0)
    copies = [t.clone() for t in ts]
    G.group_prox_kernel(*copies, thr, inplace=True, plan=streamed)
    torch.cuda.synchronize()
    for name, a, w in zip(("A1", "B1", "A2", "B2"), copies, want):
        assert torch.equal(a, w), f"streamed {name}"


def _all_three(ts, thr, prox_plan=None, norms_plan=None, scale_plan=None):
    norms = G.group_norms_kernel(*ts, plan=norms_plan)
    prox = G.group_prox_kernel(*ts, thr, plan=prox_plan)
    inv = (1.0 / torch.clamp_min(G.group_norms_plain(*ts), 1e-12)).to(
        ts[0].dtype)
    scaled = G.group_scale_kernel(*ts, inv, plan=scale_plan)
    torch.cuda.synchronize()
    return [norms], list(prox), list(scaled), inv


def _assert_all_three_ok(got, ts, thr, what):
    norms, prox, scaled, inv = got
    _assert_ok(norms[0], G.group_norms_plain(*ts), f"norms {what}",
               norms=True)
    for name, a, b in zip(("A1", "B1", "A2", "B2"), prox,
                          G.group_prox_plain(*ts, thr)):
        _assert_ok(a, b, f"prox {name} {what}")
    for name, a, b in zip(("A1", "B1", "A2", "B2"), scaled,
                          G.group_scale_plain(*ts, inv)):
        _assert_ok(a, b, f"scale {name} {what}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [FLAGSHIP, VIT_B])
def test_kernels_repeat_bit_for_bit(cuda_device, shape, dtype):
    ts, thr = _card_case(shape, dtype, cuda_device, seed=3)
    first = _all_three(ts, thr)
    second = _all_three(ts, thr)
    for a, b in zip(sum(first[:3], []), sum(second[:3], [])):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [FLAGSHIP] + RAGGED)
def test_streamed_path_matches_plain(cuda_device, shape, dtype):
    """A share budget too small for the share forces the prox to stream
    it twice; the rescale runs over the same plan."""
    ts, thr = _card_case(shape, dtype, cuda_device, seed=4)
    L, n = _spans(shape)
    plan = G.group_plan(L, *n, dtype, max_share_bytes=0)
    assert not plan.onchip or sum(plan.vecs) == 0
    got = _all_three(ts, thr, plan, plan, plan)
    _assert_all_three_ok(got, ts, thr, f"streamed {shape} {dtype}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [FLAGSHIP, VIT_B, (3, 5, 17, 33)])
def test_cluster_of_8_and_of_16_agree(cuda_device, shape, dtype):
    ts, thr = _card_case(shape, dtype, cuda_device, seed=5)
    L, n = _spans(shape)
    p8, p16 = (G.group_plan(L, *n, dtype, cluster=c) for c in (8, 16))
    assert G.cluster_info(p8, dtype, L) > 0
    if G.cluster_info(p16, dtype, L) == 0 or \
            G.cluster_info(p16, dtype, L, "norms") == 0:
        pytest.skip("this card cannot place a cluster of 16 blocks")
    got8 = _all_three(ts, thr, p8, p8)
    got16 = _all_three(ts, thr, p16, p16, p16)
    _assert_all_three_ok(got16, ts, thr, f"C=16 {shape} {dtype}")
    _assert_ok(got16[0][0], got8[0][0], "norms C=16 vs C=8", norms=True)
    for a, b in zip(got16[1], got8[1]):
        _assert_ok(a, b, "prox C=16 vs C=8")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [FLAGSHIP, (3, 5, 17, 33)])
def test_kernels_at_unaligned_bases(cuda_device, shape, dtype):
    """Inputs that start off any 16-byte address (views into a larger
    buffer), out of place into aligned outputs and in place."""
    ts, thr = _card_case(shape, dtype, cuda_device, seed=6)
    views = []
    for i, t in enumerate(ts):
        buf = torch.zeros(t.numel() + 8, dtype=dtype, device=cuda_device)
        v = buf[1 + i:1 + i + t.numel()].view(t.shape)
        v.copy_(t)
        views.append(v)
    _assert_all_three_ok(_all_three(views, thr), views, thr,
                         f"unaligned {shape} {dtype}")
    want = G.group_prox_plain(*views, thr)
    G.group_prox_kernel(*views, thr, inplace=True)
    torch.cuda.synchronize()
    for name, a, b in zip(("A1", "B1", "A2", "B2"), views, want):
        _assert_ok(a, b, f"in-place prox {name} unaligned {shape}")


@pytest.mark.cuda
def test_kernels_refuse_a_plan_that_does_not_cover(cuda_device):
    ts, thr = _card_case(FLAGSHIP, torch.float32, cuda_device)
    L, n = _spans(FLAGSHIP)
    plan = G.group_plan(L, *n, torch.float32)
    short = dataclasses.replace(plan, vecs=(1,) + plan.vecs[1:])
    with pytest.raises(RuntimeError, match="launch failed"):
        G.group_prox_kernel(*ts, thr, plan=short)
    tight = dataclasses.replace(plan, smem_bytes=plan.smem_bytes - 16)
    with pytest.raises(RuntimeError, match="launch failed"):
        G.group_prox_kernel(*ts, thr, plan=tight)
    wide = G.group_plan(L, *n, torch.float32, cluster=G.MAX_CLUSTER + 1)
    with pytest.raises(RuntimeError, match="launch failed"):
        G.group_norms_kernel(*ts, plan=wide)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [FLAGSHIP, (3, 5, 17, 33)])
def test_autograd_goes_through_kernels(cuda_device, shape):
    ts, _ = _card_case(shape, torch.float32, cuda_device, seed=2)
    ts = [t.requires_grad_(True) for t in ts]
    G.reset_launch_counts()
    val = G.group_lasso_fused(*ts)
    val.backward()
    torch.cuda.synchronize()
    assert (G.NORMS_LAUNCHES, G.SCALE_LAUNCHES) == (1, 1)
    plain = [t.detach().cpu().requires_grad_(True) for t in ts]
    want = G.group_lasso_fused(*plain)
    want.backward()
    _assert_ok(val.detach().reshape(1), want.detach().reshape(1).to(
        cuda_device), "value", norms=True)
    for name, t, p in zip(("A1", "B1", "A2", "B2"), ts, plain):
        _assert_ok(t.grad, p.grad.to(cuda_device), f"grad {name}")


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda_device):
    ts, thr = _card_case((2, 3, 5, 7), torch.float32, cuda_device)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        G.group_prox_kernel(*(t.half() for t in ts), thr)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        G.group_norms_kernel(ts[0], ts[1].bfloat16(), ts[2], ts[3])
    with pytest.raises(ValueError, match="contiguous"):
        G.group_norms_kernel(ts[0].transpose(1, 2).contiguous()
                             .transpose(1, 2), *ts[1:])
    with pytest.raises(ValueError, match="same CUDA device"):
        G.group_prox_kernel(ts[0], ts[1].cpu(), ts[2], ts[3], thr)
    with pytest.raises(ValueError, match="A1 \\(L,r,d\\)"):
        G.group_norms_kernel(ts[0], ts[1], ts[3], ts[2])
    with pytest.raises(ValueError, match="scales"):
        G.group_scale_kernel(*ts, torch.ones(2, device=cuda_device,
                                             dtype=torch.bfloat16))
