"""The port's adam, sgd and rmsprop (gslora_tpu_torch/engine/state.py)
against the JAX package's ``make_optimizer`` (optax 0.2.6 semantics:
coupled weight decay, rmsprop's decay, eps inside the root and momentum
after the lr scaling): three steps, the learning rate changed at the
third, fp32 and bf16 parameters; parameters and every moment compared in
value and dtype."""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gslora_tpu.config as jc
from gslora_tpu.engine.forget import _with_lr
from gslora_tpu.engine.state import make_optimizer as jax_optimizer

import gslora_tpu_torch.config as tc
from gslora_tpu_torch.engine.state import make_optimizer

LRS = (1e-2, 1e-2, 3e-3)  # the lr changes at step 3, as at an epoch edge
SHAPES = ((5, 7), (7,))


def _jax_moments(name, state):
    """{moment name: [leaf per parameter]} of the optax state."""
    inner = state.inner_state[1]  # after add_decayed_weights' EmptyState
    if name == "adam":
        return {"mu": inner[0].mu, "nu": inner[0].nu}
    if name == "sgd":
        return {"trace": inner[0].trace}
    return {"nu": inner[0].nu, "trace": inner[2].trace}


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["adam", "sgd", "rmsprop"])
def test_optimizer_matches_optax(name, dtype):
    rng = np.random.RandomState(11)
    p0 = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[rng.randn(*s).astype(np.float32) for s in SHAPES]
             for _ in LRS]
    kw = dict(opt=name, lr=LRS[0], weight_decay=0.05, momentum=0.9)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    jopt = jax_optimizer(jc.OptimConfig(**kw))
    jp = [jnp.asarray(a, jdt) for a in p0]
    jst = jopt.init(jp)
    opt = make_optimizer(tc.OptimConfig(**kw))
    tp = [torch.tensor(a).to(dtype) for a in p0]
    st = opt.init(tp)
    for lr, g in zip(LRS, grads):
        jst = _with_lr(jst, jnp.float32(lr))
        upd, jst = jopt.update([jnp.asarray(a, jdt) for a in g], jst, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update(tp, [torch.tensor(a).to(dtype) for a in g], st, lr)

    tol = 1e-6 if dtype == torch.float32 else 1e-2
    pairs = [("param", jp, tp)] + [
        (k, v, st[k]) for k, v in _jax_moments(name, jst).items()]
    for what, want, got in pairs:
        for w, t in zip(want, got):
            assert _dtype_name(t) == str(w.dtype), (what, t.dtype, w.dtype)
            assert np.isfinite(_np(t)).all(), what
            np.testing.assert_allclose(_np(t), _np(w), rtol=tol, atol=tol,
                                       err_msg=what)
    if name == "adam":
        assert st["count"] == int(jst.inner_state[1][0].count)


def test_rmsprop_is_not_torchs():
    """The four optax differences are real: torch.optim.RMSprop with the
    same lr, momentum and coupled decay lands elsewhere."""
    rng = np.random.RandomState(3)
    p0 = rng.randn(6).astype(np.float32)
    grads = [rng.randn(6).astype(np.float32) for _ in LRS]
    opt = make_optimizer(tc.OptimConfig(opt="rmsprop", lr=LRS[0],
                                        weight_decay=0.05))
    ours = [torch.tensor(p0)]
    st = opt.init(ours)
    ref = torch.nn.Parameter(torch.tensor(p0))
    topt = torch.optim.RMSprop([ref], lr=LRS[0], momentum=0.9,
                               weight_decay=0.05)
    for lr, g in zip(LRS, grads):
        opt.update(ours, [torch.tensor(g)], st, lr)
        for group in topt.param_groups:
            group["lr"] = lr
        ref.grad = torch.tensor(g)
        topt.step()
    assert float((ours[0] - ref.detach()).abs().max()) > 1e-3
