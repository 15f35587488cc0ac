"""The port's RandAugment (gslora_tpu_torch/data/randaugment.py) and the
few-shot RandAugment prototypes of engine/prototypes.py against the JAX
package's copies on the CPU: the augmented arrays bit for bit, per op and
per seed; the prototypes (fp32, dropout 0) within 1e-3, on the face path
and on the ImageNet path with host-normalized fp32 and with uint8 batches.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import gslora_tpu.config as jc
import gslora_tpu.data.randaugment as jra
from gslora_tpu.engine.prototypes import \
    calculate_prototypes as jax_prototypes
from gslora_tpu.models.vit import init_vit_params as jax_init

import gslora_tpu_torch.config as tc
import gslora_tpu_torch.data.randaugment as tra
from gslora_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from gslora_tpu_torch.engine.prototypes import calculate_prototypes
from gslora_tpu_torch.models.convert import params_from_jax


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several processes on one machine: one intra-op
    thread per process keeps torch's idle threads off the others' cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ALL_OPS = ["Identity", "ShearX", "ShearY", "TranslateX", "TranslateY",
           "Rotate", "Brightness", "Color", "Contrast", "Sharpness",
           "Posterize", "Solarize", "AutoContrast", "Equalize"]


@pytest.mark.parametrize("name", ALL_OPS)
def test_every_op_matches_jax_bit_for_bit(name):
    """Each op at every third magnitude bin, both signs, on a seeded
    image: the same pixels as the JAX package's copy."""
    rng = np.random.RandomState(ALL_OPS.index(name))
    img = Image.fromarray(rng.randint(0, 256, (28, 36, 3), np.uint8))
    for m in range(0, 31, 3):
        space = {n: (mag, signed) for n, mag, signed in
                 tra.RandAugment(magnitude=m)._space(*img.size)}
        jspace = {n: (mag, signed) for n, mag, signed in
                  jra.RandAugment(magnitude=m)._space(*img.size)}
        assert space == jspace
        mag, signed = space[name]
        for sign in ((1, -1) if signed else (1,)):
            got = np.asarray(tra._apply_op(img, name, sign * mag))
            want = np.asarray(jra._apply_op(img, name, sign * mag))
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {m}")


@pytest.mark.parametrize("seed,magnitude", [(0, 9), (1, 5), (7, 30)])
def test_policy_matches_jax_bit_for_bit(seed, magnitude):
    """The seeded draws (op, sign) and the batch round trip through uint8
    PIL: identical arrays, several calls in a row."""
    x = np.random.RandomState(seed + 10).rand(6, 3, 20, 20) \
        .astype(np.float32)
    ours = tra.RandAugment(num_ops=2, magnitude=magnitude, seed=seed)
    theirs = jra.RandAugment(num_ops=2, magnitude=magnitude, seed=seed)
    for _ in range(3):
        got, want = ours.apply_batch(x), theirs.apply_batch(x)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, x)


FACE = dict(image_size=16, patch_size=8, dim=32, depth=2, heads=2,
            dim_head=16, mlp_dim=64, num_class=6, dropout=0.0,
            emb_dropout=0.0, head_type="CosFace")
B16 = dict(image_size=32, patch_size=16, dim=32, depth=2, heads=2,
           dim_head=16, mlp_dim=64, num_class=6, head_type="Softmax",
           dropout=0.0, emb_dropout=0.0, soft_split=True, ac_patch_size=16,
           pad=0, qkv_bias=True, attn_scale="dim_head",
           input_norm="imagenet")


def _batches(model, kind):
    """Two batches (the second with a pad slot, label -1): [0, 1] pixels
    (face), host-normalized ImageNet fp32, or raw uint8."""
    rng = np.random.RandomState(3)
    size = model["image_size"]
    out = []
    for n in (5, 4):
        u8 = rng.randint(0, 256, (n, 3, size, size)).astype(np.uint8)
        y = rng.randint(0, model["num_class"], n)
        if n == 4:
            y[-1] = -1
        if kind == "uint8":
            x = u8
        else:
            x = u8.astype(np.float32) / 255.0
            if kind == "imagenet-fp32":
                mean = np.asarray(IMAGENET_MEAN, np.float32)[:, None, None]
                std = np.asarray(IMAGENET_STD, np.float32)[:, None, None]
                x = (x - mean) / std
        out.append((x, y))
    return out


@pytest.mark.parametrize("model,kind", [
    (FACE, "face-fp32"), (B16, "imagenet-fp32"), (B16, "uint8")],
    ids=["face", "imagenet-fp32", "imagenet-uint8"])
def test_randaugment_prototypes_match_jax(model, kind):
    p = jax_init(jax.random.key(0), jc.ViTConfig(**model), jc.LoraConfig(4))
    p = jax.tree.map(np.asarray, p)
    batches = _batches(model, kind)
    kw = dict(aug_repeat=3, seed=11, aug_magnitude=9)
    want = np.asarray(jax_prototypes(
        jax.tree.map(jnp.asarray, p), batches, jc.ViTConfig(**model),
        jc.LoraConfig(4), model["num_class"], compute_dtype=jnp.float32,
        **kw))
    got = calculate_prototypes(
        params_from_jax(p), batches, tc.ViTConfig(**model), tc.LoraConfig(4),
        model["num_class"], compute_dtype=torch.float32, **kw).numpy()
    assert got.shape == (model["num_class"], model["dim"])
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    # the augmented views differ from the clean pass
    clean = calculate_prototypes(
        params_from_jax(p), batches, tc.ViTConfig(**model), tc.LoraConfig(4),
        model["num_class"], compute_dtype=torch.float32).numpy()
    assert not np.allclose(got, clean, atol=1e-4)
