"""Weights across the packages and the port's resume (gslora_tpu_torch/
models/import_torch.py, cli/export_torch.py, cli/common.build_params,
checkpoints/io.load_params): the reference naming against the JAX
package's ``to_state_dict`` / ``export_state_dict``, a JAX export loaded
by the port's ``-r`` and back, and the resume rules (a rank-0 checkpoint
into a LoRA run keeps the fresh LoRA, a rank-0 run drops a checkpoint's
LoRA, a mismatched LoRA or a missing key raises, a .msgpack raises)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import gslora_tpu.config as jc
from gslora_tpu.cli.export_torch import export_state_dict as jax_export
from gslora_tpu.cli.export_torch import save_pth as jax_save_pth
from gslora_tpu.models.import_torch import from_state_dict as jax_from_sd
from gslora_tpu.models.import_torch import to_state_dict as jax_to_sd
from gslora_tpu.models.vit import init_vit_params as jax_init

import gslora_tpu_torch.config as tc
from gslora_tpu_torch.checkpoints.io import load_params, save_params
from gslora_tpu_torch.cli import export_torch
from gslora_tpu_torch.cli.common import build_params
from gslora_tpu_torch.lora.core import init_lora
from gslora_tpu_torch.models.convert import flatten_tree, params_from_jax
from gslora_tpu_torch.models.import_torch import from_state_dict, \
    to_state_dict

MODEL = dict(image_size=16, patch_size=8, dim=32, depth=2, heads=2,
             dim_head=16, mlp_dim=64, num_class=6, dropout=0.0,
             emb_dropout=0.0, head_type="CosFace")


def _jax_params(rank, pos="FFN", seed=0):
    p = jax_init(jax.random.key(seed), jc.ViTConfig(**MODEL),
                 jc.LoraConfig(rank=rank, pos=pos))
    p = jax.tree.map(np.array, p)
    rng = np.random.RandomState(seed + 1)
    for sub in p["lora"].values():  # nonzero B: the LoRA carries signal
        for name in sub:
            if name.startswith("B"):
                sub[name] = 0.1 * rng.randn(*sub[name].shape).astype(
                    np.float32)
    return p


def _run_config(rank, resume="", pos="FFN", **kw):
    return tc.RunConfig(model=tc.ViTConfig(**MODEL),
                        lora=tc.LoraConfig(rank=rank, pos=pos),
                        resume=resume, device="cpu", **kw)


def _assert_trees_equal(got, want):
    got, want = flatten_tree(got), flatten_tree(want)
    assert set(got) == set(want)
    def tensor(a):
        return a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.asarray(a))

    for k in want:
        assert torch.equal(tensor(got[k]).float(), tensor(want[k]).float()), k


@pytest.mark.parametrize("rank,pos,form", [
    (0, "FFN", "unmerged"), (4, "FFN", "unmerged"), (4, "FFN", "merged"),
    (4, "Attention", "unmerged"), (4, "Attention", "merged")])
def test_reference_naming_matches_jax(rank, pos, form):
    p = _jax_params(rank, pos)
    jm, jl = jc.ViTConfig(**MODEL), jc.LoraConfig(rank=rank, pos=pos)
    tm, tl = tc.ViTConfig(**MODEL), tc.LoraConfig(rank=rank, pos=pos)
    want = jax_export(p, jm, jl, form)
    got = export_torch.export_state_dict(params_from_jax(p), tm, tl, form)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
        assert tuple(got[k].shape) == np.asarray(w).shape, k
    if form == "unmerged":  # a pure re-layout: exact, and back again
        for k, w in jax_to_sd(p, jm).items():
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(w))
        _assert_trees_equal(from_state_dict(got, tm, tl),
                            params_from_jax(p))


def test_jax_export_resumes_in_the_port_and_back(tmp_path, monkeypatch):
    """JAX export_state_dict -> .pth -> the port's -r; the port's
    export_torch CLI -> .pth -> the JAX from_state_dict: the same weights
    both ways."""
    p = _jax_params(4)
    jm, jl = jc.ViTConfig(**MODEL), jc.LoraConfig(rank=4)
    jax_pth = str(tmp_path / "from_jax.pth")
    jax_save_pth(jax_export(p, jm, jl), jax_pth)
    params = build_params(_run_config(4, jax_pth))
    _assert_trees_equal(params, params_from_jax(p))

    ckpt = str(tmp_path / "port.pth")
    save_params(ckpt, params)
    orig = tc.config_from_args

    def tiny(args):  # the CLI's flagship model shrunk to MODEL
        return dataclasses.replace(orig(args), model=tc.ViTConfig(**MODEL))

    monkeypatch.setattr(export_torch, "config_from_args", tiny)
    out = str(tmp_path / "exported.pth")
    export_torch.main(["-r", ckpt, "--export_out", out, "--lora_rank", "4",
                       "--device", "cpu"])
    sd = torch.load(out, weights_only=True)
    assert all(v.dtype == torch.float32 for v in sd.values())
    back = jax_from_sd({k: v.numpy() for k, v in sd.items()}, jm, jl)
    _assert_trees_equal(params_from_jax(jax.tree.map(np.asarray, back)),
                        params_from_jax(p))


def test_own_checkpoint_round_trip(tmp_path):
    """save_params -> load_params and -r: bit for bit, bf16 included."""
    p = params_from_jax(_jax_params(4))
    p["base"]["pos_embed"] = p["base"]["pos_embed"].to(torch.bfloat16)
    path = str(tmp_path / "ckpt.pth")
    save_params(path, p)
    loaded = load_params(path)
    _assert_trees_equal(loaded, p)
    assert loaded["base"]["pos_embed"].dtype == torch.bfloat16
    cfg = _run_config(4, path, param_dtype="float32")
    resumed = build_params(cfg)
    _assert_trees_equal(resumed, p)
    assert resumed["base"]["pos_embed"].dtype == torch.float32  # the run's


@pytest.mark.parametrize("fmt", ["own", "reference"])
def test_rank0_checkpoint_into_a_lora_run_keeps_the_fresh_lora(tmp_path,
                                                               fmt):
    p = params_from_jax(_jax_params(0))
    path = str(tmp_path / "rank0.pth")
    if fmt == "own":
        save_params(path, p)
    else:
        export_torch.save_pth(to_state_dict(p, tc.ViTConfig(**MODEL)), path)
    cfg = _run_config(8, path)
    resumed = build_params(cfg)
    _assert_trees_equal(resumed["base"], p["base"])
    fresh = build_params(dataclasses.replace(cfg, resume=""))["lora"]
    _assert_trees_equal(resumed["lora"], fresh)
    assert float(resumed["lora"]["ffn"]["A1"].abs().max()) > 0  # kaiming A
    assert float(resumed["lora"]["ffn"]["B1"].abs().max()) == 0


@pytest.mark.parametrize("fmt", ["own", "reference"])
def test_lora_resume_rules(tmp_path, fmt):
    p = params_from_jax(_jax_params(4))
    path = str(tmp_path / "rank4.pth")
    if fmt == "own":
        save_params(path, p)
    else:
        export_torch.save_pth(to_state_dict(p, tc.ViTConfig(**MODEL)), path)
    with pytest.warns(UserWarning, match="dropping its LoRA"):
        resumed = build_params(_run_config(0, path))
    assert resumed["lora"] == {}
    _assert_trees_equal(resumed["base"], p["base"])
    with pytest.raises(ValueError, match="Wrong resume"):
        build_params(_run_config(8, path))


@pytest.mark.parametrize("fmt", ["own", "reference"])
def test_missing_non_lora_key_raises(tmp_path, fmt):
    p = params_from_jax(_jax_params(0))
    path = str(tmp_path / "short.pth")
    if fmt == "own":
        flat = flatten_tree(p)
        del flat["base.blocks.fc1.bias"]
        torch.save(flat, path)
    else:
        sd = to_state_dict(p, tc.ViTConfig(**MODEL))
        del sd["transformer.layers.1.1.fn.fn.net.0.bias"]
        torch.save(sd, path)
    with pytest.raises(KeyError, match="fc1.bias|net.0.bias"):
        build_params(_run_config(0, path))


def test_unported_resume_formats_raise(tmp_path):
    """The JAX package's .msgpack trees and torchvision-named VIT_B16
    files load now (tests/test_torch_vit_imagenet.py); what is neither a
    parameter tree nor in the naming the run expects still raises."""
    from flax import serialization
    path = tmp_path / "x.msgpack"
    path.write_bytes(serialization.msgpack_serialize(
        {"step": np.int32(3), "params": {"w": np.zeros(2, np.float32)}}))
    with pytest.raises(ValueError, match="no 'base' subtree"):
        build_params(_run_config(0, str(path)))
    face = tmp_path / "face.pth"
    torch.save(to_state_dict(params_from_jax(_jax_params(0)),
                             tc.ViTConfig(**MODEL)), face)
    with pytest.raises(KeyError, match="torchvision checkpoint missing"):
        build_params(_run_config(0, str(face), net="VIT_B16"))


def test_port_weights_give_the_jax_forward_the_same_embeddings():
    """The port's weights carried to the JAX package by the reference
    naming (a fresh kaiming LoRA included) embed as the port does."""
    from gslora_tpu.models.vit import vit_apply as jax_apply
    from gslora_tpu_torch.models.vit import vit_apply
    p = params_from_jax(_jax_params(4))
    p["lora"] = init_lora(torch.Generator().manual_seed(2),
                          tc.ViTConfig(**MODEL), tc.LoraConfig(rank=4))
    sd = to_state_dict(p, tc.ViTConfig(**MODEL))
    jp = jax_from_sd({k: v.numpy() for k, v in sd.items()},
                     jc.ViTConfig(**MODEL), jc.LoraConfig(rank=4))
    x = np.random.RandomState(0).rand(2, 3, 16, 16).astype(np.float32)
    want = np.asarray(jax_apply(jp, x, None, jc.ViTConfig(**MODEL),
                                jc.LoraConfig(rank=4),
                                compute_dtype=np.float32))
    got = vit_apply(p, torch.from_numpy(x), None, tc.ViTConfig(**MODEL),
                    tc.LoraConfig(rank=4), compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)
