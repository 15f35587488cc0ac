"""The baseline zoo's losses and building blocks in the port
(gslora_tpu_torch/losses/{regularization,distillation}.py,
baselines/{distill,scrub,lirf,freeze}.py, engine/schedule.step_decay_lr,
models/vit.py's layer_range / tokens_in / return_tokens) against the JAX
package's, on the same numpy inputs.

Every loss takes rows labelled -1 (the pad sentinel of every loader on
the card) and is held with pad rows in the batch, value and gradient to
rtol 1e-4; the clamped square roots of FDR and SCRUB give a finite zero
gradient where student and teacher agree."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gslora_tpu.baselines.distill as jdistill
import gslora_tpu.baselines.scrub as jscrub
import gslora_tpu.config as jc
import gslora_tpu.losses.distillation as jdl
from gslora_tpu.baselines.freeze import mask_updates
from gslora_tpu.baselines.lirf import _low_tokens as jax_low_tokens
from gslora_tpu.baselines.lirf import _up_logits as jax_up_logits
from gslora_tpu.baselines.lirf import low_slice as jax_low_slice
from gslora_tpu.engine.schedule import step_decay_lr as jax_step_decay
from gslora_tpu.losses.regularization import quadratic_penalty as jax_qp

import gslora_tpu_torch.baselines.distill as tdistill
import gslora_tpu_torch.baselines.scrub as tscrub
import gslora_tpu_torch.config as tc
import gslora_tpu_torch.losses.distillation as tdl
from gslora_tpu_torch.baselines.freeze import trains
from gslora_tpu_torch.baselines.lirf import _low_tokens, _up_logits, \
    low_slice
from gslora_tpu_torch.engine.pretrain import PretrainState
from gslora_tpu_torch.engine.schedule import step_decay_lr
from gslora_tpu_torch.engine.state import make_optimizer
from gslora_tpu_torch.losses.regularization import quadratic_penalty
from gslora_tpu_torch.models.convert import flatten_tree, params_from_jax
from gslora_tpu_torch.models.vit import ViT

from torch_baselines_setup import (LOSS_RTOL, MODEL, assert_trees_close,
                                   np_tree, one_torch_thread, to_jax)

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)

LABELS = np.array([3, -1, 0, 5, -1, 1], np.int32)  # two pad rows


def _randn(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _value_and_grads(jfn, tfn, arrays, labels):
    """fn(*arrays, labels) and its gradients w.r.t. each array, in both
    packages."""
    jl = None if labels is None else jnp.asarray(labels)
    tl = None if labels is None else torch.from_numpy(labels)
    jv, jg = jax.value_and_grad(
        lambda *a: jfn(*a, jl), argnums=tuple(range(len(arrays))))(
            *map(jnp.asarray, arrays))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    tv = tfn(*ts, tl)
    tg = torch.autograd.grad(tv, ts)
    return (float(tv.detach()), [g.numpy() for g in tg],
            float(jv), [np.asarray(g) for g in jg])


LOSSES = {
    "kd_kl": (lambda s, t, y: jdl.kd_kl_loss(s, t, 2.0, labels=y),
              lambda s, t, y: tdl.kd_kl_loss(s, t, 2.0, labels=y), (6, 8)),
    "kd_kl_T10": (lambda s, t, y: jdl.kd_kl_loss(s, t, 10.0, labels=y),
                  lambda s, t, y: tdl.kd_kl_loss(s, t, 10.0, labels=y),
                  (6, 8)),
    "lwf": (lambda s, t, y: jdl.lwf_kd_loss(s, t, 2.0, labels=y),
            lambda s, t, y: tdl.lwf_kd_loss(s, t, 2.0, labels=y), (6, 8)),
    "attention_transfer": (jdl.attention_transfer_loss,
                           tdl.attention_transfer_loss, (6, 5, 16)),
    "der": (jdistill.der_loss, tdistill.der_loss, (6, 32)),
    "fdr": (jdistill.fdr_loss, tdistill.fdr_loss, (6, 8)),
}


@pytest.mark.parametrize("pad", [True, False])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_match_jax(name, pad):
    jfn, tfn, shape = LOSSES[name]
    arrays = [_randn(1, *shape, scale=2.0), _randn(2, *shape, scale=2.0)]
    tv, tg, jv, jg = _value_and_grads(jfn, tfn, arrays,
                                      LABELS if pad else None)
    assert np.isfinite(tv)
    np.testing.assert_allclose(tv, jv, rtol=LOSS_RTOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=LOSS_RTOL, atol=1e-7)
    if pad:
        # a pad row neither counts nor gets a gradient
        for g in tg:
            assert not np.any(g[LABELS < 0])


@pytest.mark.parametrize("name", ["fdr", "kd_kl", "attention_transfer"])
def test_losses_at_student_equal_teacher(name):
    """The first step of every teacher-student baseline (dropout 0): the
    student is the teacher. FDR's clamped sqrt keeps its gradient a
    finite 0 there, as in JAX."""
    jfn, tfn, shape = LOSSES[name]
    a = _randn(3, *shape)
    tv, tg, jv, jg = _value_and_grads(jfn, tfn, [a, a.copy()], LABELS)
    np.testing.assert_allclose(tv, jv, rtol=LOSS_RTOL, atol=1e-6)
    for g, w in zip(tg, jg):
        assert np.all(np.isfinite(g))
        np.testing.assert_allclose(g, w, atol=1e-6)
    if name == "fdr":
        assert not np.any(tg[0])


def _trees(seeds):
    """Parameter-shaped numpy trees (the tiny model's base), one per
    seed."""
    base = flatten_tree(np_tree(0)["base"])
    out = []
    for s in seeds:
        rng = np.random.RandomState(s)
        out.append({k: rng.randn(*v.shape).astype(np.float32)
                    for k, v in base.items()})
    return out


def test_quadratic_penalty_matches_jax():
    p, a1, a2, w1, w2 = _trees(range(5))
    w1 = {k: np.abs(v) for k, v in w1.items()}
    w2 = {k: np.abs(v) for k, v in w2.items()}
    jv, jg = jax.jit(jax.value_and_grad(lambda q, a, w: jax_qp(q, a, w, 0.3)))(
        to_jax(p), [to_jax(a1), to_jax(a2)], [to_jax(w1), to_jax(w2)])
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tv = quadratic_penalty(tp, [params_from_jax(a1), params_from_jax(a2)],
                           [params_from_jax(w1), params_from_jax(w2)], 0.3)
    tg = torch.autograd.grad(tv, list(tp.values()))
    np.testing.assert_allclose(float(tv.detach()), float(jv),
                               rtol=LOSS_RTOL)
    for k, g in zip(tp, tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]),
                                   rtol=LOSS_RTOL, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("equal", [False, True])
def test_param_dist_matches_jax(equal):
    """SCRUB's distance to the SWA model; at params == swa (every
    superepoch's start) the gradient is a finite 0."""
    p, s = _trees([7, 8])
    if equal:
        s = {k: v.copy() for k, v in p.items()}
    jv, jg = jax.jit(jax.value_and_grad(lambda q, w: jscrub.param_dist(
        q, w, 0.1)))(to_jax(p), to_jax(s))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tv = tscrub.param_dist(tp, params_from_jax(s), 0.1)
    tg = torch.autograd.grad(tv, list(tp.values()))
    np.testing.assert_allclose(float(tv.detach()), float(jv),
                               rtol=LOSS_RTOL, atol=1e-12)
    for k, g in zip(tp, tg):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    assert float(tscrub.param_dist(tp, params_from_jax(s), 0.0)) == 0.0


def test_swa_update_matches_jax():
    swa, student = _trees([9, 10])
    first = tscrub.swa_update(params_from_jax(swa),
                              params_from_jax(student), 0)
    assert_trees_close(first, student, rtol=0, atol=0)
    got = tscrub.swa_update(params_from_jax(swa), params_from_jax(student),
                            3)
    want = jscrub.swa_update(to_jax(swa), to_jax(student), 3)
    assert_trees_close(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("epoch", [0, 5, 99, 100, 101, 250])
def test_step_decay_matches_jax(epoch):
    assert step_decay_lr(5e-4, epoch, [100, 200]) == \
        jax_step_decay(5e-4, epoch, [100, 200])


@pytest.mark.parametrize("flags", [
    {}, {"ffn_open": True}, {"only_ffn": True}, {"imagenet": True},
    {"ffn_open": True, "imagenet": True},
    {"only_ffn": True, "imagenet": True}])
def test_requires_grad_scope_matches_mask_updates(flags):
    """The port freezes as the reference does (requires_grad False, no
    optimizer state); the JAX package zeroes those leaves' updates. Both
    pick the same leaves, a model with attention and FFN LoRA included."""
    p = np_tree(0, rank=4)
    lora = {"attn": {"A": np.ones((2, 3, 4, 32), np.float32),
                     "B": np.ones((2, 3, 16 * 2, 4), np.float32)}}
    p["lora"].update(lora)
    ones = jax.tree.map(lambda a: jnp.ones(a.shape), p)
    kept = {k: bool(np.asarray(v).any()) for k, v in
            flatten_tree(jax.tree.map(np.asarray,
                                      mask_updates(ones, **flags))).items()}
    model = ViT(params_from_jax(p), tc.ViTConfig(**MODEL),
                tc.LoraConfig(rank=4))
    state = PretrainState.create(
        model, make_optimizer(tc.OptimConfig()),
        trains=lambda name: trains(name, **flags))
    got = {k: p.requires_grad for k, p in model.named_parameters()}
    assert got == kept
    assert len(state.opt_state["mu"]) == sum(kept.values())
    head = {k: v for k, v in got.items() if k.startswith("base.head.")}
    assert set(head.values()) == {
        (flags.get("ffn_open", False) or flags.get("only_ffn", False)) and
        not flags.get("imagenet", False)}


def test_low_and_up_halves_match_jax():
    """LIRF's split: the low half's tokens (of a half-depth subtree, which
    the converter carries across) and the teacher's up half's logits."""
    p = np_tree(0)
    x = _randn(4, 5, 3, 16, 16)
    y = np.array([1, 0, 7, -1, 2], np.int32)
    jm, jl = jc.ViTConfig(**MODEL), jc.LoraConfig(rank=0)
    tm, tl = tc.ViTConfig(**MODEL), tc.LoraConfig(rank=0)
    jlow = jax_low_slice(to_jax(p)["base"], 1)
    tlow = params_from_jax(jax.tree.map(np.asarray, jlow))
    assert "lora" not in tlow and tlow["blocks"]["fc1"]["kernel"].shape[0] \
        == 1
    assert_trees_close(tlow, low_slice(params_from_jax(p)["base"], 1),
                       rtol=0, atol=0)
    jmid = jax_low_tokens(jlow, jnp.asarray(x), jm, jl, train=False,
                          rng=None, cdt=jnp.float32)
    tmid = _low_tokens(tlow, torch.from_numpy(x), tm, tl, train=False,
                       generator=None, cdt=torch.float32)
    assert tuple(tmid.shape) == (5, 5, 32)
    np.testing.assert_allclose(tmid.numpy(), np.asarray(jmid), rtol=1e-4,
                               atol=1e-5)
    jlog, _ = jax_up_logits(to_jax(p)["base"], jmid, jnp.asarray(y), jm, jl,
                            jnp.float32)
    tlog = _up_logits(params_from_jax(p)["base"], tmid, torch.from_numpy(y),
                      tm, tl, torch.float32)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4,
                               atol=1e-5)
