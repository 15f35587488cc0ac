"""Recovery in the middle of a task (gslora_tpu_torch/checkpoints/io.py
``save_train_state`` / ``restore_train_state``): save the full state
after 6 of 10 steps, "crash", restore into a fresh template, run the last
4; the LoRA (or every parameter) and the optimizer state must equal the
uninterrupted run's bit for bit on the CPU, as tests/test_recovery.py asks
of the JAX package. For a ForgetState and for a PretrainState."""
import numpy as np
import pytest
import torch

import gslora_tpu_torch.config as tc
from gslora_tpu_torch.checkpoints.io import restore_train_state, \
    save_train_state
from gslora_tpu_torch.engine.forget import make_forget_step
from gslora_tpu_torch.engine.pretrain import PretrainState, \
    make_pretrain_step
from gslora_tpu_torch.engine.state import ForgetState, make_optimizer
from gslora_tpu_torch.models.convert import flatten_tree
from gslora_tpu_torch.models.vit import ViT, init_vit_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several processes on one machine: one intra-op
    thread per process keeps torch's idle threads off the others' cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


MODEL = tc.ViTConfig(image_size=16, patch_size=8, dim=32, depth=2, heads=2,
                     dim_head=16, mlp_dim=64, num_class=6, dropout=0.0,
                     emb_dropout=0.0, head_type="Softmax")
LORA = tc.LoraConfig(rank=4)


def _images(seed, n=4):
    return torch.from_numpy(np.random.RandomState(seed)
                            .randn(n, 3, 16, 16).astype(np.float32))


def _assert_equal_states(got, want):
    g, w = flatten_tree(got.params), flatten_tree(want.params)
    assert set(g) == set(w)
    for k in w:
        assert torch.equal(g[k], w[k]), k

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, list):
            return [x for v in tree for x in leaves(v)]
        return [tree]

    gl, wl = leaves(got.opt_state), leaves(want.opt_state)
    assert len(gl) == len(wl) and len(wl) > 1
    for a, b in zip(gl, wl):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b
    assert got.step == want.step


def _forget_setup(opt_name):
    params = init_vit_params(torch.Generator().manual_seed(0), MODEL, LORA)
    opt = make_optimizer(tc.OptimConfig(opt=opt_name, lr=1e-3))
    step = make_forget_step(MODEL, LORA, tc.ForgetConfig(bnd=10.0), opt,
                            compute_dtype=torch.float32,
                            use_prototype=False)
    xf, xr = _images(1), _images(2)
    yf, yr = torch.tensor([0, 1, 0, 1]), torch.tensor([2, 3, 4, 5])
    protos = torch.zeros(6, 32)
    sc = dict(beta=0.3, alpha=1e-4, lr=1e-3, bnd=10.0, bnd_pro=18.0,
              w_pro_f=0.0, w_pro_r=0.0)

    def fresh():
        return ForgetState.create(ViT(params, MODEL, LORA), opt)

    def run(state, start, end):
        for i in range(start, end):
            state, _ = step(state, xf, yf, xr, yr, protos, sc,
                            torch.Generator().manual_seed(i))
        return state

    return fresh, run


def _pretrain_setup(opt_name):
    model = MODEL
    params = init_vit_params(torch.Generator().manual_seed(0), model,
                             tc.LoraConfig(rank=0),
                             param_dtype=torch.bfloat16
                             if opt_name == "rmsprop" else torch.float32)
    opt = make_optimizer(tc.OptimConfig(opt=opt_name, lr=1e-3))
    step = make_pretrain_step(model, tc.LoraConfig(rank=0), opt,
                              compute_dtype=torch.float32)
    x, y = _images(3, 6), torch.tensor([0, 1, 2, 3, 4, 5])

    def fresh():
        return PretrainState.create(ViT(params, model, tc.LoraConfig(0)),
                                    opt)

    def run(state, start, end):
        for i in range(start, end):
            state, _ = step(state, x, y, 1e-3,
                            torch.Generator().manual_seed(i))
        return state

    return fresh, run


@pytest.mark.parametrize("kind,opt_name", [
    ("forget", "adamw"), ("pretrain", "adamw"),
    # bf16 parameters: RMSprop's trace turns fp32 after its first update
    ("pretrain", "rmsprop"),
])
def test_mid_task_recovery_is_exact(tmp_path, kind, opt_name):
    fresh, run = (_forget_setup if kind == "forget" else
                  _pretrain_setup)(opt_name)
    ref = run(fresh(), 0, 10)  # uninterrupted

    mid = run(fresh(), 0, 6)
    path = str(tmp_path / "state.pth")
    save_train_state(path, mid)
    del mid  # "crash"
    resumed = restore_train_state(path, fresh())
    assert resumed.step == 6
    final = run(resumed, 6, 10)
    _assert_equal_states(final, ref)


def test_restore_refuses_another_model(tmp_path):
    """A snapshot restores only into a template of the same parameters."""
    fresh, run = _forget_setup("adamw")
    path = str(tmp_path / "state.pth")
    save_train_state(path, run(fresh(), 0, 1))
    other = tc.ViTConfig(**{**MODEL.__dict__, "depth": 1})
    template = ForgetState.create(
        ViT(init_vit_params(torch.Generator().manual_seed(0), other, LORA),
            other, LORA), make_optimizer(tc.OptimConfig()))
    with pytest.raises(ValueError, match="template has"):
        restore_train_state(path, template)


def test_restore_refuses_another_optimizer(tmp_path):
    """An AdamW snapshot does not restore into an SGD template: the
    optimizer states' keys differ."""
    fresh, run = _forget_setup("adamw")
    path = str(tmp_path / "state.pth")
    save_train_state(path, run(fresh(), 0, 1))
    other, _ = _forget_setup("sgd")
    with pytest.raises(ValueError, match="keys"):
        restore_train_state(path, other())
