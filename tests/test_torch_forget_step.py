"""Three GS-LoRA forget steps of the port (gslora_tpu_torch/engine/forget.py
and state.py) against the JAX package's ``make_forget_step`` on the same
converted weights and batches (fp32, dropout 0), as
tests/test_training_parity.py holds the JAX step against torch."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gslora_tpu.config as jc
from gslora_tpu.engine.forget import make_forget_step as jax_step
from gslora_tpu.engine.forget import scalars_for_epoch as jax_scalars
from gslora_tpu.engine.state import ForgetState as JaxState
from gslora_tpu.engine.state import make_optimizer as jax_optimizer
from gslora_tpu.models.vit import init_vit_params as jax_init
from gslora_tpu.models.vit import vit_apply as jax_vit_apply

import gslora_tpu_torch.config as tc
from gslora_tpu_torch.engine.forget import make_forget_step, \
    scalars_for_epoch
from gslora_tpu_torch.engine.state import AdamW, ForgetState, make_optimizer
from gslora_tpu_torch.lora.core import lora_group_norms
from gslora_tpu_torch.losses.classification import cross_entropy
from gslora_tpu_torch.losses.prototype import prototype_loss
from gslora_tpu_torch.models.convert import flatten_tree, params_from_jax
from gslora_tpu_torch.models.vit import ViT, init_vit_params, vit_apply


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several processes on one machine: one intra-op
    thread per process keeps torch's idle threads off the others' cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


MODEL = dict(image_size=16, patch_size=8, dim=32, depth=2, heads=2,
             dim_head=16, mlp_dim=64, num_class=6, dropout=0.0,
             emb_dropout=0.0, head_type="CosFace")
FORGET = dict(bnd=40.0, beta=0.3, alpha=0.01, alpha_epoch=0,
              pro_f_weight=0.2, pro_r_weight=0.1, bnd_pro=18.0)
SCALARS = dict(beta=0.3, alpha=0.01, lr=1e-3, bnd=40.0, bnd_pro=18.0,
               w_pro_f=0.2, w_pro_r=0.1)
STEPS = 3


def _setup(rank, small_layer0=False):
    jm, tm = jc.ViTConfig(**MODEL), tc.ViTConfig(**MODEL)
    jl, tl = jc.LoraConfig(rank=rank), tc.LoraConfig(rank=rank)
    p = jax_init(jax.random.key(0), jm, jl)
    if rank:
        rng = np.random.RandomState(1)
        for name in ("B1", "B2"):
            p["lora"]["ffn"][name] = jnp.asarray(
                0.05 * rng.randn(*p["lora"]["ffn"][name].shape)
                .astype(np.float32))
    p = jax.tree.map(np.array, p)
    if small_layer0:
        for a in p["lora"]["ffn"].values():
            a[0] *= 0.1
    return jm, tm, jl, tl, p


def _batches(seed=3):
    rng = np.random.RandomState(seed)
    return [(rng.rand(4, 3, 16, 16).astype(np.float32),
             rng.randint(4, 6, 4).astype(np.int32),
             rng.rand(4, 3, 16, 16).astype(np.float32),
             rng.randint(0, 4, 4).astype(np.int32)) for _ in range(STEPS)]


# lr·alpha of the prox case: between layer 0's group norm (scaled down
# to ~0.2 in _setup) and layer 1's (~2), so layer 0 dies and layer 1
# shrinks at every step
PROX_SCALARS = dict(SCALARS, alpha=300.0)


def _case(lora_apply, fused, proto, trainable, mode="loss"):
    name = f"{lora_apply}-{fused}-{proto}-{trainable}"
    return pytest.param(lora_apply, fused, proto, trainable, mode,
                        id=name if mode == "loss" else f"{name}-{mode}")


@pytest.mark.parametrize("lora_apply,fused,proto,trainable,mode", [
    _case("factored", False, False, "lora"),
    _case("merged", False, False, "lora"),
    _case("factored", True, True, "lora"),
    _case("merged", True, True, "lora"),
    _case("factored", False, True, "base"),
    _case("factored", False, True, "lora", "prox"),
])
def test_three_steps_match_jax(lora_apply, fused, proto, trainable, mode):
    rank = 4 if trainable == "lora" else 0
    jm, tm, jl, tl, p = _setup(rank, small_layer0=mode == "prox")
    optim = dict(opt="adamw", lr=1e-3, weight_decay=0.05)
    protos = np.random.RandomState(2).randn(6, 32).astype(np.float32)
    batches = _batches()
    scalars = PROX_SCALARS if mode == "prox" else SCALARS

    jopt = jax_optimizer(jc.OptimConfig(**optim))
    jstate = JaxState.create(p, jopt, trainable=trainable)
    jfn = jax_step(jm, jl, jc.ForgetConfig(**FORGET), jopt,
                   compute_dtype=jnp.float32, use_prototype=proto,
                   lora_apply=lora_apply, fused_batch=fused,
                   trainable=trainable, structure_mode=mode)
    jsc = {k: jnp.float32(v) for k, v in scalars.items()}

    topt = make_optimizer(tc.OptimConfig(**optim))
    tstate = ForgetState.create(ViT(params_from_jax(p), tm, tl), topt,
                                trainable=trainable)
    tfn = make_forget_step(tm, tl, tc.ForgetConfig(**FORGET), topt,
                           compute_dtype=torch.float32, use_prototype=proto,
                           lora_apply=lora_apply, fused_batch=fused,
                           trainable=trainable, structure_mode=mode)

    for s, (xf, yf, xr, yr) in enumerate(batches):
        jstate, jm_ = jfn(jstate, *(jnp.asarray(a) for a in (xf, yf, xr, yr)),
                          jnp.asarray(protos), jsc, jax.random.key(s))
        tstate, tm_ = tfn(tstate, *(torch.from_numpy(a)
                                    for a in (xf, yf, xr, yr)),
                          torch.from_numpy(protos), dict(scalars))
        if mode == "prox":
            # as test_pallas_ops.test_prox_mode_in_forget_step_sparsifies:
            # the structure term is not in the loss; layer 0 dies, layer 1
            # shrinks
            assert float(tm_["loss_structure"]) == 0.0
            norms = lora_group_norms(tstate.params["lora"])
            assert norms[0] == 0.0 and 1.0 < norms[1] < 2.5, norms
        assert set(tm_) == set(jm_)
        for k, v in jm_.items():
            np.testing.assert_allclose(float(tm_[k]), float(v), rtol=1e-4,
                                       atol=1e-6, err_msg=f"step {s}: {k}")
    assert tstate.step == STEPS
    want = flatten_tree(jax.tree.map(np.asarray, {"base": jstate.base,
                                                  "lora": jstate.lora}))
    got = {k: v.detach().numpy()
           for k, v in flatten_tree(tstate.params).items()}
    for name in (n for n in want if n.startswith(trainable + ".")):
        np.testing.assert_allclose(got[name], want[name], rtol=5e-3,
                                   atol=5e-5, err_msg=name)
    # the frozen subtree is untouched
    frozen = "base." if trainable == "lora" else "lora."
    for name in (n for n in want if n.startswith(frozen)):
        np.testing.assert_array_equal(got[name], flatten_tree(p)[name])


@pytest.mark.parametrize("epoch,kw", [
    (0, {}), (25, {}), (60, {"beta_decay": True}),
    (3, {"warmup_alpha": True, "alpha_epoch": 5}),
    (7, {"warmup_alpha": True, "alpha_epoch": 5}),
])
def test_scalars_for_epoch_match_jax(epoch, kw):
    f = dict(alpha_epoch=20, **{k: v for k, v in kw.items()
                                if k != "alpha_epoch"})
    if "alpha_epoch" in kw:
        f["alpha_epoch"] = kw["alpha_epoch"]
    want = jax_scalars(jc.RunConfig(forget=jc.ForgetConfig(**f)), epoch,
                       lr=0.01)
    got = scalars_for_epoch(tc.RunConfig(forget=tc.ForgetConfig(**f)), epoch,
                            lr=0.01)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(float(v), rel=1e-6), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_matches_optax(dtype):
    """optax.adamw semantics, including bf16 parameters (a bf16 b2 would
    round to 1.0 and make the first update NaN)."""
    rng = np.random.RandomState(5)
    p0 = rng.randn(5, 7).astype(np.float32)
    grads = [rng.randn(5, 7).astype(np.float32) for _ in range(3)]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jopt = jax_optimizer(jc.OptimConfig(lr=1e-2, weight_decay=0.05))
    jp = jnp.asarray(p0, jdt)
    jst = jopt.init(jp)
    t = torch.tensor(p0).to(dtype)
    opt = AdamW(lr=1e-2, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.05)
    st = opt.init([t])
    for g in grads:
        upd, jst = jopt.update(jnp.asarray(g, jdt), jst, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update([t], [torch.tensor(g).to(dtype)], st, 1e-2)
    got = t.float().numpy()
    assert np.isfinite(got).all()
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(got, np.asarray(jp, np.float32), rtol=tol,
                               atol=tol)


def test_unported_options_raise():
    """gemm_impl="int8" is ported as an eval and serving path: a training
    forward raises the JAX package's ValueError, word for word; an eval
    forward runs."""
    tm, tl = tc.ViTConfig(**MODEL), tc.LoraConfig(rank=4)
    params = init_vit_params(torch.Generator().manual_seed(0), tm, tl)
    x = np.random.RandomState(0).rand(2, 3, 16, 16).astype(np.float32)
    int8 = dataclasses.replace(tm, gemm_impl="int8")
    jm = jc.ViTConfig(**{**MODEL, "gemm_impl": "int8"})
    jp = jax_init(jax.random.key(0), jm, jc.LoraConfig(rank=4))
    with pytest.raises(ValueError) as jerr:
        jax_vit_apply(jp, jnp.asarray(x), None, jm, jc.LoraConfig(rank=4),
                      train=True, rng=jax.random.key(1),
                      compute_dtype=jnp.float32)
    with pytest.raises(ValueError) as terr:
        vit_apply(params, torch.from_numpy(x), None, int8, tl, train=True,
                  generator=torch.Generator(), compute_dtype=torch.float32)
    assert str(terr.value) == str(jerr.value)
    emb = vit_apply(params, torch.from_numpy(x), None, int8, tl,
                    compute_dtype=torch.float32)
    assert emb.shape == (2, tm.dim) and bool(torch.isfinite(emb).all())


def test_forget_step_rejects_bad_options():
    """As the JAX step: prox only for FFN LoRA, grad_accum >= 1."""
    tm = tc.ViTConfig(**MODEL)
    opt = make_optimizer(tc.OptimConfig())
    with pytest.raises(ValueError, match="lora_pos='FFN'"):
        make_forget_step(tm, tc.LoraConfig(rank=4, pos="Attention"),
                         tc.ForgetConfig(), opt, structure_mode="prox")
    with pytest.raises(ValueError, match="grad_accum"):
        make_forget_step(tm, tc.LoraConfig(rank=4), tc.ForgetConfig(), opt,
                         grad_accum=0)
    with pytest.raises(ValueError, match="structure_mode"):
        make_forget_step(tm, tc.LoraConfig(rank=4), tc.ForgetConfig(), opt,
                         structure_mode="l1")


# ---------------------------------------------------------------------------
# grad_accum: the two-phase exact scheme
# ---------------------------------------------------------------------------


class _GradRecorder:
    """An optimizer that only records the gradients it is given."""

    def init(self, params):
        return {}

    def update(self, params, grads, state, lr):
        self.grads = [g.detach().clone() for g in grads]


def _straddling_bounds(p, tm, tl, protos, batch):
    """BND and BND_pro between the two micro-batches' forget CE and forget
    prototype loss (micro-batches of 2): the global means gate ON, while
    a per-micro relu would switch the larger micro-batch's term off."""
    xf, yf = (torch.from_numpy(a) for a in batch[:2])
    vit = ViT(params_from_jax(p), tm, tl)
    with torch.no_grad():
        logits, emb = vit(xf, yf, compute_dtype=torch.float32)
    ce = [float(cross_entropy(logits[i:i + 2], yf[i:i + 2])) for i in (0, 2)]
    pro = [float(prototype_loss(emb[i:i + 2], yf[i:i + 2],
                                torch.from_numpy(protos))) for i in (0, 2)]
    lo, hi = sorted(ce)
    plo, phi = sorted(pro)
    assert hi - lo > 1e-3 and phi - plo > 1e-5
    return 0.3 * lo + 0.7 * hi, 0.3 * plo + 0.7 * phi


def _accum_setup():
    jm, tm, jl, tl, p = _setup(4)
    protos = np.random.RandomState(2).randn(6, 32).astype(np.float32)
    batches = _batches()
    bnd, bnd_pro = _straddling_bounds(p, tm, tl, protos, batches[0])
    forget = dict(FORGET, bnd=bnd, bnd_pro=bnd_pro)
    scalars = dict(SCALARS, bnd=bnd, bnd_pro=bnd_pro)
    return jm, tm, jl, tl, p, protos, batches, forget, scalars


def test_grad_accum_equals_the_full_batch_gradient():
    jm, tm, jl, tl, p, protos, batches, forget, scalars = _accum_setup()
    xf, yf, xr, yr = (torch.from_numpy(a) for a in batches[0])

    def grads(accum, sl=slice(None)):
        rec = _GradRecorder()
        state = ForgetState.create(ViT(params_from_jax(p), tm, tl), rec)
        step = make_forget_step(tm, tl, tc.ForgetConfig(**forget), rec,
                                compute_dtype=torch.float32,
                                use_prototype=True, grad_accum=accum)
        _, metrics = step(state, xf[sl], yf[sl], xr[sl], yr[sl],
                          torch.from_numpy(protos), dict(scalars))
        return rec.grads, metrics

    full, m_full = grads(1)
    acc, m_acc = grads(2)
    # a batch grad_accum does not divide runs unaccumulated, as in JAX
    for a, b in zip(grads(3)[0], full):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for k in m_full:
        np.testing.assert_allclose(float(m_acc[k]), float(m_full[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for a, b in zip(acc, full):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7)
    # the bounds straddle the micro-batches: averaging per-micro losses
    # (each relu on its own micro-batch) gives another gradient
    naive = [0.5 * (a + b) for a, b in zip(grads(1, slice(0, 2))[0],
                                           grads(1, slice(2, 4))[0])]
    assert max(float((a - b).abs().max() / b.abs().max())
               for a, b in zip(naive, full)) > 1e-3


def test_grad_accum_matches_jax():
    jm, tm, jl, tl, p, protos, batches, forget, scalars = _accum_setup()
    optim = dict(opt="adamw", lr=1e-3, weight_decay=0.05)
    jopt = jax_optimizer(jc.OptimConfig(**optim))
    jstate = JaxState.create(p, jopt)
    jfn = jax_step(jm, jl, jc.ForgetConfig(**forget), jopt,
                   compute_dtype=jnp.float32, use_prototype=True,
                   grad_accum=2)
    jsc = {k: jnp.float32(v) for k, v in scalars.items()}
    topt = make_optimizer(tc.OptimConfig(**optim))
    tstate = ForgetState.create(ViT(params_from_jax(p), tm, tl), topt)
    tfn = make_forget_step(tm, tl, tc.ForgetConfig(**forget), topt,
                           compute_dtype=torch.float32, use_prototype=True,
                           grad_accum=2)
    for s, batch in enumerate(batches):
        jstate, jm_ = jfn(jstate, *(jnp.asarray(a) for a in batch),
                          jnp.asarray(protos), jsc, jax.random.key(s))
        tstate, tm_ = tfn(tstate, *(torch.from_numpy(a) for a in batch),
                          torch.from_numpy(protos), dict(scalars))
        for k, v in jm_.items():
            np.testing.assert_allclose(float(tm_[k]), float(v), rtol=1e-4,
                                       atol=1e-6, err_msg=f"step {s}: {k}")
    want = flatten_tree(jax.tree.map(np.asarray, {"lora": jstate.lora}))
    got = flatten_tree({"lora": tstate.params["lora"]})
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w, rtol=5e-3,
                                   atol=5e-5, err_msg=name)
