"""The port's supervised pretraining (gslora_tpu_torch/engine/pretrain.py,
cli/train_pretrain.py, the remat of models/vit.py) against the JAX
package's ``make_pretrain_step`` on the same converted weights and
batches: fp32, dropout 0, the JAX attention through the Pallas kernel in
interpret mode (attn_impl="pallas"), the port's through the kernel's plain
version (the CPU). Trained parameters within ROADMAP's 5e-3."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gslora_tpu.config as jc
from gslora_tpu.engine.pretrain import PretrainState as JaxState
from gslora_tpu.engine.pretrain import make_pretrain_step as jax_step
from gslora_tpu.engine.state import make_optimizer as jax_optimizer
from gslora_tpu.models.vit import init_vit_params as jax_init

import gslora_tpu_torch.config as tc
from gslora_tpu_torch.checkpoints.io import load_params
from gslora_tpu_torch.engine.pretrain import PretrainState, is_lora, \
    make_pretrain_step
from gslora_tpu_torch.engine.state import make_optimizer
from gslora_tpu_torch.losses.classification import cross_entropy
from gslora_tpu_torch.models import vit as V
from gslora_tpu_torch.models.convert import flatten_tree, params_from_jax, \
    params_to_jax


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
             emb_dropout=0.0)
OPTIM = dict(opt="adamw", lr=1e-3, weight_decay=0.05)


def _batch(n, seed, pad=0):
    """n images with labels in [0, 6); the last ``pad`` labels are the -1
    padding sentinel."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 6, n).astype(np.int32)
    if pad:
        y[-pad:] = -1
    return rng.rand(n, 3, 16, 16).astype(np.float32), y


# name -> (head, rank, lora_only, grad_accum, batches)
CASES = {
    "full": ("CosFace", 0, False, 1, [_batch(4, s) for s in range(3)]),
    "lora_only": ("CosFace", 4, True, 1, [_batch(4, 7)]),
    # a padded batch (its second micro-batch holds one valid sample),
    # then a ragged one that grad_accum=2 does not divide (one full call)
    "grad_accum": ("Softmax", 0, False, 2, [_batch(6, 8, pad=2),
                                            _batch(5, 9)]),
    "sface": ("SFace", 0, False, 1, [_batch(4, s) for s in (10, 11)]),
}


def _params(head, rank):
    p = jax_init(jax.random.key(0), jc.ViTConfig(**MODEL, head_type=head),
                 jc.LoraConfig(rank=rank))
    if rank:  # nonzero B: the LoRA path carries signal
        rng = np.random.RandomState(1)
        for name in ("B1", "B2"):
            p["lora"]["ffn"][name] = jnp.asarray(
                0.05 * rng.randn(*p["lora"]["ffn"][name].shape)
                .astype(np.float32))
    return jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("case", list(CASES))
def test_pretrain_steps_match_jax(case):
    head, rank, lora_only, accum, batches = CASES[case]
    p = _params(head, rank)
    jm = jc.ViTConfig(**MODEL, head_type=head, attn_impl="pallas")
    tm = tc.ViTConfig(**MODEL, head_type=head)
    jl, tl = jc.LoraConfig(rank=rank), tc.LoraConfig(rank=rank)

    jopt = jax_optimizer(jc.OptimConfig(**OPTIM))
    jstate = JaxState.create(p, jopt, lora_only=lora_only)
    jfn = jax_step(jm, jl, jopt, compute_dtype=jnp.float32,
                   lora_only=lora_only, grad_accum=accum)
    topt = make_optimizer(tc.OptimConfig(**OPTIM))
    tstate = PretrainState.create(V.ViT(params_from_jax(p), tm, tl), topt,
                                  trains=is_lora if lora_only else None)
    tfn = make_pretrain_step(tm, tl, topt, compute_dtype=torch.float32,
                             grad_accum=accum)
    for s, (x, y) in enumerate(batches):
        jstate, jmet = jfn(jstate, jnp.asarray(x), jnp.asarray(y),
                           jnp.float32(OPTIM["lr"]), jax.random.key(s))
        tstate, tmet = tfn(tstate, torch.from_numpy(x), torch.from_numpy(y),
                           OPTIM["lr"])
        assert set(tmet) == set(jmet) == {"loss", "acc"}
        for k, v in jmet.items():
            np.testing.assert_allclose(float(tmet[k]), float(v), rtol=1e-4,
                                       atol=1e-5, err_msg=f"step {s}: {k}")
    want = flatten_tree(jax.tree.map(np.asarray, jstate.params))
    got = flatten_tree(params_to_jax(tstate.model))
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=5e-3, atol=5e-5,
                                   err_msg=name)
    start = flatten_tree(p)
    moved = [n for n in want if not np.array_equal(want[n], start[n])]
    if lora_only:  # the base is frozen and has no optimizer state
        assert moved and all(n.startswith("lora.") for n in moved)
        assert len(tstate.opt_state["mu"]) == 4
    else:
        assert any(n.startswith("base.blocks.qkv") for n in moved)


def test_pretrain_loop_matches_jax():
    """``pretrain``: two epochs over two batches with the per-epoch
    timm cosine lr (warmup, then cosine), from the same weights."""
    from gslora_tpu.engine.pretrain import pretrain as jax_pretrain
    from gslora_tpu_torch.engine.pretrain import pretrain

    batches = [_batch(4, s) for s in (20, 21)]
    optim = dict(OPTIM, warmup_epochs=1, epochs=2, warmup_lr=1e-4)
    p = _params("Softmax", 0)
    jstate, _ = jax_pretrain(
        jc.RunConfig(model=jc.ViTConfig(**MODEL, head_type="Softmax"),
                     lora=jc.LoraConfig(rank=0),
                     optim=jc.OptimConfig(**optim)),
        jax.tree.map(jnp.asarray, p), lambda: iter(batches), epochs=2,
        compute_dtype=jnp.float32)
    tstate, metrics = pretrain(
        tc.RunConfig(model=tc.ViTConfig(**MODEL, head_type="Softmax"),
                     lora=tc.LoraConfig(rank=0),
                     optim=tc.OptimConfig(**optim), device="cpu"),
        params_from_jax(p), lambda: iter(batches), epochs=2,
        compute_dtype=torch.float32)
    assert tstate.step == 4 and np.isfinite(float(metrics["loss"]))
    want = flatten_tree(jax.tree.map(np.asarray, jstate.params))
    got = flatten_tree(params_to_jax(tstate.model))
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=5e-3, atol=5e-5,
                                   err_msg=name)


def test_grad_accum_equals_the_full_batch_gradient():
    """The accumulated gradient of a padded batch equals the full batch's
    (fp32 sums, normalised by the global valid count)."""
    class Recorder:
        def init(self, params):
            return {}

        def update(self, params, grads, state, lr):
            self.grads = [g.clone() for g in grads]

    tm, tl = tc.ViTConfig(**MODEL, head_type="CosFace"), tc.LoraConfig(0)
    x, y = (torch.from_numpy(a) for a in _batch(8, 3, pad=3))
    grads = {}
    for accum in (1, 2, 4):
        rec = Recorder()
        state = PretrainState.create(
            V.ViT(params_from_jax(_params("CosFace", 0)), tm, tl), rec)
        _, metrics = make_pretrain_step(tm, tl, rec,
                                        compute_dtype=torch.float32,
                                        grad_accum=accum)(state, x, y, 1e-3)
        grads[accum] = (rec.grads, metrics)
    for accum in (2, 4):
        for a, b in zip(grads[accum][0], grads[1][0]):
            # fp32 sums in another order: 1e-6 of the tensor's scale
            np.testing.assert_allclose(
                a.numpy(), b.numpy(), rtol=1e-5,
                atol=1e-6 * float(b.abs().max()))
        for k in ("loss", "acc"):
            np.testing.assert_allclose(float(grads[accum][1][k]),
                                       float(grads[1][1][k]), rtol=1e-5)


def test_remat_matches_no_remat(monkeypatch):
    """Remat reruns each layer in the backward and draws the forward's
    dropout masks again from the one explicit generator: gradients equal
    bit for bit, and the generator ends where it would without remat."""
    calls = []
    block = V._attention_block

    def counted(*args, **kwargs):
        calls.append(1)
        return block(*args, **kwargs)

    monkeypatch.setattr(V, "_attention_block", counted)
    tm = tc.ViTConfig(**{**MODEL, "dropout": 0.2, "emb_dropout": 0.1},
                      head_type="CosFace")
    tl = tc.LoraConfig(rank=4)
    params = params_from_jax(_params("CosFace", 4))
    x, y = (torch.from_numpy(a) for a in _batch(4, 5))
    out = {}
    for remat in (False, True):
        calls.clear()
        vit = V.ViT(params, dataclasses.replace(tm, remat=remat), tl)
        gen = torch.Generator().manual_seed(3)
        logits, _ = vit(x, y, train=True, generator=gen,
                        compute_dtype=torch.float32)
        grads = torch.autograd.grad(cross_entropy(logits, y),
                                    list(vit.parameters()))
        out[remat] = (grads, gen.get_state(), len(calls))
    assert out[False][2] == tm.depth and out[True][2] == 2 * tm.depth
    for a, b in zip(out[False][0], out[True][0]):
        assert torch.equal(a, b)
    assert torch.equal(out[False][1], out[True][1])
    # dropout is on: another generator seed gives other gradients
    vit = V.ViT(params, tm, tl)
    logits, _ = vit(x, y, train=True, compute_dtype=torch.float32,
                    generator=torch.Generator().manual_seed(4))
    other = torch.autograd.grad(cross_entropy(logits, y),
                                list(vit.parameters()))
    assert not all(torch.equal(a, b) for a, b in zip(other, out[False][0]))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.fixture
def tiny_pretrain(monkeypatch):
    """The CLI with its flagship model shrunk to tiny dims."""
    from gslora_tpu_torch.cli import train_pretrain
    orig = tc.config_from_args

    def patched(args):
        cfg = orig(args)
        cfg.model = tc.ViTConfig(**{**MODEL, "num_class": 8,
                                    "depth": args.vit_depth,
                                    "head_type": args.head,
                                    "remat": args.remat})
        return cfg

    monkeypatch.setattr(train_pretrain, "config_from_args", patched)
    return train_pretrain


CLI = ["-d", "synthetic", "--vit_depth", "2", "--head", "CosFace", "-b",
       "8", "--lr", "1e-3", "--warmup-epochs", "0", "--compute_dtype",
       "float32", "--device", "cpu"]


def test_cli_pretrain_then_lora_only_resume_on_cpu(tiny_pretrain, tmp_path):
    """20 full-model steps (160 synthetic images, batch 8) reach the
    batch-20 eval, which saves a checkpoint; a LoRA-only run resumed from
    it with remat keeps the loaded base and trains the LoRA."""
    out1 = tmp_path / "pretrain"
    report = tiny_pretrain.main(CLI + ["-e", "1", "--lora_rank", "0",
                                       "--outdir", str(out1)])
    assert json.loads((out1 / "report.json").read_text()) == report
    assert np.isfinite(report["final_test_acc"])
    ckpts = sorted(out1.glob("Backbone_VIT_Epoch_1_Batch_20_*.pth"))
    assert len(ckpts) == 1
    saved = load_params(str(ckpts[0]))
    assert saved["lora"] == {}
    logged = [json.loads(line) for line in
              (out1 / "metrics.jsonl").read_text().splitlines()]
    assert any("Test Accuracy" in r for r in logged)
    assert all(np.isfinite(r["loss"]) for r in logged if "loss" in r)

    report2, state = tiny_pretrain.main(
        CLI + ["-e", "1", "--lora_rank", "4", "--remat", "-r",
               str(ckpts[0]), "--outdir", str(tmp_path / "lora")],
        return_state=True)
    assert state.model.cfg.remat
    assert all(is_lora(n) == p.requires_grad
               for n, p in state.model.named_parameters())
    tree = state.params
    for name, t in flatten_tree(saved["base"]).items():
        assert torch.equal(flatten_tree(tree["base"])[name], t), name
    assert all(float(tree["lora"]["ffn"][b].detach().abs().max()) > 0
               for b in ("B1", "B2"))  # B starts at zero
    assert np.isfinite(report2["final_test_acc"])


@pytest.mark.parametrize("flags,error,match", [
    (["--dp", "--mesh_slices", "4"], ValueError,
     "mesh 4x0x1 does not fit 2 devices"),
    (["--device", "cuda"], RuntimeError, "no CUDA GPU"),
])
def test_cli_refuses_what_it_cannot_run(monkeypatch, tiny_pretrain,
                                        tmp_path, flags, error, match):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("WORLD_SIZE", "2")  # 4 slices do not fit 2 ranks
    args = [a for a in CLI if a not in ("--device", "cpu")]
    with pytest.raises(error, match=match):
        tiny_pretrain.main(args + ["-e", "1", "--outdir", str(tmp_path)] +
                           flags)
