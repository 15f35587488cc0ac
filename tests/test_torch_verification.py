"""The port's copies of pair verification (gslora_tpu_torch/evaluation/
verification.py) and the RecordIO / .bin readers (data/recordio.py)
against the JAX package's on the same numpy arrays and files, and
``perform_val`` with a torch forward of the port's ViT as the embedding."""
import io
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

from gslora_tpu.data import recordio as jax_rec
from gslora_tpu.evaluation import verification as jax_ver

import gslora_tpu_torch.config as tc
from gslora_tpu_torch.data import recordio as rec
from gslora_tpu_torch.evaluation import verification as ver
from gslora_tpu_torch.models.vit import init_vit_params, vit_apply


def _pairs(n_pairs=40, d=16, seed=0):
    """Images and flips whose pairs are same / different by construction,
    with a fixed projection as the embedding."""
    rng = np.random.RandomState(seed)
    ids = rng.randn(n_pairs, 3, 8, 8).astype(np.float32)
    issame = [bool(i % 2) for i in range(n_pairs)]
    imgs = np.empty((2 * n_pairs, 3, 8, 8), np.float32)
    for i in range(n_pairs):
        imgs[2 * i] = ids[i]
        other = ids[i] if issame[i] else rng.randn(3, 8, 8)
        imgs[2 * i + 1] = other + 0.6 * rng.randn(3, 8, 8)
    proj = rng.randn(3 * 8 * 8, d).astype(np.float32)
    return (imgs, imgs[:, :, :, ::-1].copy()), issame, proj


@pytest.mark.parametrize("which", ["perform_val", "perform_val_deit"])
def test_perform_val_matches_jax(which):
    data_set, issame, proj = _pairs()
    tokens = []

    def embed(batch, token=None):
        tokens.append(token)
        return batch.reshape(len(batch), -1) @ proj

    kw = dict(embedding_size=16, batch_size=24, return_roc=True)
    args = (embed, "tok") if which == "perform_val_deit" else (embed,)
    want = getattr(jax_ver, which)(*args, data_set, issame, **kw)
    n_calls = len(tokens)
    got = getattr(ver, which)(*args, data_set, issame, **kw)
    assert tokens[n_calls:] == tokens[:n_calls]  # same batching, same tokens
    np.testing.assert_array_equal(np.array(got[:4]), np.array(want[:4]))
    for a, b in zip(got[4], want[4]):
        np.testing.assert_array_equal(a, b)
    assert 50.0 < 100 * got[0] <= 100.0


def test_roc_val_and_kfold_match_jax():
    rng = np.random.RandomState(4)
    e1, e2 = rng.randn(2, 55, 8)
    same = rng.rand(55) < 0.5
    thr = np.arange(0, 4, 0.01)
    for a, b in zip(ver.calculate_roc(thr, e1, e2, same),
                    jax_ver.calculate_roc(thr, e1, e2, same)):
        np.testing.assert_array_equal(a, b)
    assert ver.calculate_val(thr, e1, e2, same, 0.1) == \
        jax_ver.calculate_val(thr, e1, e2, same, 0.1)
    with pytest.raises(ValueError, match="number of splits"):
        list(ver._kfold_indices(5, 10))


def test_perform_val_with_the_ports_vit():
    """The embedding function is a torch forward on the run's device,
    returning numpy: finite accuracy, XNorm of post-LN embeddings."""
    model = tc.ViTConfig(image_size=8, patch_size=4, dim=16, depth=1,
                         heads=2, dim_head=8, mlp_dim=32, num_class=4,
                         dropout=0.0, emb_dropout=0.0)
    lora = tc.LoraConfig(rank=0)
    params = init_vit_params(torch.Generator().manual_seed(0), model, lora)
    data_set, issame, _ = _pairs(n_pairs=20)

    @torch.no_grad()
    def embed(batch):
        x = torch.from_numpy(np.ascontiguousarray(batch))
        return vit_apply(params, x, None, model, lora,
                         compute_dtype=torch.float32).numpy()

    acc, std, xnorm, thr = ver.perform_val(embed, data_set, issame,
                                           embedding_size=16, batch_size=8)
    assert np.isfinite([acc, std, xnorm, thr]).all() and xnorm > 0


def _png(rng, size):
    buf = io.BytesIO()
    Image.fromarray((rng.rand(size, size, 3) * 255).astype(np.uint8)).save(
        buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_recordio_round_trip_matches_jax(tmp_path, writer):
    """Either package's writer, both readers: the same index, labels,
    record bytes and decoded images."""
    rng = np.random.RandomState(0)
    records = [(np.asarray([i % 3], np.float32), _png(rng, 12))
               for i in range(7)]
    records.append((np.asarray([1.0, 2.0], np.float32), _png(rng, 12)))
    path = str(tmp_path / "train.rec")
    (rec if writer == "port" else jax_rec).write_recordio(
        path, records, header0=np.asarray([9.0, 11.0], np.float32))
    assert rec.read_idx_file(path[:-4] + ".idx") == \
        jax_rec.read_idx_file(path[:-4] + ".idx")
    with open(path, "rb") as fh:
        for key, off in rec.read_idx_file(path[:-4] + ".idx").items():
            labels, body = rec.read_record(fh, off)
            want_l, want_b = jax_rec.read_record(fh, off)
            np.testing.assert_array_equal(labels, want_l)
            assert body == want_b
            np.testing.assert_array_equal(
                rec.read_record_labels(fh, off), want_l)
    ours = rec.FaceRecordDataset(path, rand_mirror=True, seed=3)
    theirs = jax_rec.FaceRecordDataset(path, rand_mirror=True, seed=3)
    assert ours.samples == theirs.samples and len(ours) == 8
    np.testing.assert_array_equal(ours.decode_batch(range(8)),
                                  np.stack([theirs.decode(i)
                                            for i in range(8)]))


def test_val_bins_load_as_in_jax(tmp_path):
    rng = np.random.RandomState(7)
    for name in ("lfw", "cfp_ff"):
        bins = [_png(rng, 20) for _ in range(4)]
        with open(tmp_path / f"{name}.bin", "wb") as f:
            pickle.dump((bins, [True, False]), f)
    got = rec.get_val_data(str(tmp_path), ["lfw", "missing", "cfp_ff"], 16)
    want = jax_rec.get_val_data(str(tmp_path), ["lfw", "missing", "cfp_ff"],
                                16)
    assert [g[0] for g in got] == [w[0] for w in want] == ["lfw", "cfp_ff"]
    for (_, (gi, gf), gs), (_, (wi, wf), ws) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gf, wf)
        assert gs == ws == [True, False]
        assert gi.shape == (4, 3, 16, 16)
