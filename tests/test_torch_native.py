"""The port's native host IO (gslora_tpu_torch/native: csrc/recordio.cpp and
csrc/imagedec.cpp, built with g++ at first use) against its pure-Python
reader, PIL and the JAX package's own library (gslora_tpu/native).

The cases of tests/test_native.py run against the port's binding, which
never skips here: a build that fails raises. The JAX side is built by
``make -C native`` into this module's temporary directory (never over the
package's own ``libgslora_native.so``, which tests/test_native.py may be
building at the same time) and skips only where its toolchain is
missing."""
import io
import struct
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import gslora_tpu_torch.native as native
from gslora_tpu_torch.data.folders import ImageFolderDataset
from gslora_tpu_torch.data.recordio import (FaceRecordDataset, read_idx_file,
                                            read_record, read_record_labels,
                                            write_recordio)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's native module, loading a library built here."""
    import gslora_tpu.native as jn
    out = tmp_path_factory.mktemp("jax_native") / "libgslora_native.so"
    rc = subprocess.run(["make", "-C", str(ROOT / "native"), f"OUT={out}"],
                        capture_output=True).returncode
    if rc != 0 or not out.exists():
        pytest.skip("the JAX package's native toolchain is unavailable")
    mp = pytest.MonkeyPatch()
    mp.setattr(jn, "_LIB_PATH", str(out))
    mp.setattr(jn, "_lib", None)
    yield jn
    mp.undo()


def _write_fixture(tmp_path, n=10, size=8, fmt="PNG"):
    from PIL import Image
    rng = np.random.RandomState(0)
    records, bodies = [], []
    for i in range(n):
        img = Image.fromarray((rng.rand(size, size, 3) * 255).astype(np.uint8))
        buf = io.BytesIO()
        img.save(buf, format=fmt)
        bodies.append(buf.getvalue())
        records.append((np.asarray([float(i % 3)], np.float32), bodies[-1]))
    path = str(tmp_path / "train.rec")
    write_recordio(path, records, header0=np.asarray([99.0, 100.0],
                                                     np.float32))
    return path, bodies


def _image_folder(tmp_path, size=16):
    """Two classes of PNG and JPEG images at ``size``, one off-size JPEG
    (declined: it needs a resize) and one BMP (another codec)."""
    from PIL import Image
    rng = np.random.RandomState(0)
    for c in ("a", "b"):
        d = tmp_path / c
        d.mkdir(parents=True)
        for i in range(3):
            arr = (rng.rand(size, size, 3) * 255).astype(np.uint8)
            Image.fromarray(arr).save(d / f"{i}.png")
            Image.fromarray(arr).save(d / f"{i}.jpg", quality=90)
    Image.fromarray((rng.rand(size, size, 3) * 255).astype(np.uint8)).save(
        tmp_path / "a" / "odd.bmp")
    Image.fromarray((rng.rand(size + 4, size, 3) * 255).astype(
        np.uint8)).save(tmp_path / "b" / "big.jpg")
    return ImageFolderDataset(str(tmp_path), image_size=size)


# ---------------------------------------------------------------------------
# the cases of tests/test_native.py, against the port's binding
# ---------------------------------------------------------------------------

def test_native_single_reads(tmp_path):
    path, bodies = _write_fixture(tmp_path)
    r = native.NativeRecordReader(path)
    assert len(r) == 11  # header0 + 10 records
    label, body = r.read(r._key_to_pos[1])
    assert label == 0.0 and body == bodies[0]
    label, body = r.read(r._key_to_pos[5])
    assert label == float(4 % 3) and body == bodies[4]
    r.close()


def test_native_batched_reads_match_python(tmp_path):
    path, bodies = _write_fixture(tmp_path)
    r = native.NativeRecordReader(path, n_threads=3)
    positions = [r._key_to_pos[k] for k in range(1, 11)]
    labels, payloads = r.read_batch(positions)
    np.testing.assert_allclose(labels, [i % 3 for i in range(10)])
    assert payloads == bodies
    idx = read_idx_file(path[:-4] + ".idx")
    with open(path, "rb") as rec:
        for k, body in zip(range(1, 11), payloads):
            assert read_record(rec, idx[k])[1] == body
    ds = FaceRecordDataset(path, rand_mirror=False)
    assert ds.targets == [i % 3 for i in range(10)]
    r.close()


def test_native_reads_large_bodies_and_batches(tmp_path):
    """Bodies past the first buffer (64 KiB single, 1 MiB batched) make
    both reads retry with a larger one."""
    path, bodies = _write_fixture(tmp_path, n=4, size=400)
    assert min(len(b) for b in bodies) > 1 << 16
    r = native.NativeRecordReader(path)
    assert r.read(r._key_to_pos[2])[1] == bodies[1]
    _, payloads = r.read_batch([r._key_to_pos[k] for k in (1, 2, 3, 4)])
    assert payloads == bodies
    r.close()


def test_native_rejects_corrupt_records(tmp_path):
    """A label count past the payload, and a set continuation flag, fail
    the single and the batched read."""
    path, _ = _write_fixture(tmp_path)
    r = native.NativeRecordReader(path)
    pos = r._key_to_pos[1]
    idx = read_idx_file(path[:-4] + ".idx")
    with open(path, "r+b") as f:
        f.seek(idx[1] + 8)  # IRHeader.flag
        f.write(struct.pack("<I", 1_000_000))
    with pytest.raises(IOError):
        r.read(pos)
    with pytest.raises(IOError):
        r.read_batch([r._key_to_pos[2], pos])
    r.close()

    sub = tmp_path / "sub"
    sub.mkdir()
    path2, _ = _write_fixture(sub)
    r2 = native.NativeRecordReader(path2)
    idx2 = read_idx_file(path2[:-4] + ".idx")
    with open(path2, "r+b") as f:
        f.seek(idx2[1] + 4)
        lrec = struct.unpack("<I", f.read(4))[0]
        f.seek(idx2[1] + 4)
        f.write(struct.pack("<I", lrec | (1 << 29)))
    with pytest.raises(IOError):
        r2.read(r2._key_to_pos[1])
    with pytest.raises(IOError):
        r2.read_batch([r2._key_to_pos[1]])
    with pytest.raises(IOError):
        r2.read(len(r2))  # past the table
    r2.close()


def test_native_idx_malformed_line_fails_open(tmp_path):
    path, _ = _write_fixture(tmp_path)
    idx_path = path[:-4] + ".idx"
    lines = open(idx_path).read().splitlines()
    lines.insert(len(lines) // 2, "garbage line")
    open(idx_path, "w").write("\n".join(lines) + "\n")
    with pytest.raises(IOError):
        native.NativeRecordReader(path)
    with pytest.raises(IOError):
        native.NativeRecordReader(str(tmp_path / "missing.rec"))


@pytest.mark.parametrize("mirror", [False, True])
def test_face_record_dataset_native_batch_path(tmp_path, mirror):
    """decode_batch reads through the C++ reader and equals decode image by
    image; with mirroring, the draws stay in per-sample order."""
    path, _ = _write_fixture(tmp_path)
    ds = FaceRecordDataset(path, rand_mirror=mirror, seed=3)
    batch = ds.decode_batch(list(range(len(ds))))
    assert ds._native_reader is not None
    ref = FaceRecordDataset(path, rand_mirror=mirror, seed=3)
    want = np.stack([ref.decode(i) for i in range(len(ref))])
    np.testing.assert_array_equal(batch, want)


def test_face_record_dataset_read_error_raises(tmp_path):
    """An unreadable record raises from the batch path (no silent fall
    back to the Python reader)."""
    path, _ = _write_fixture(tmp_path)
    ds = FaceRecordDataset(path, rand_mirror=False)
    with open(path, "r+b") as f:
        f.seek(ds.idx[3])
        f.write(b"\0\0\0\0")  # bad magic
    with pytest.raises(IOError):
        ds.decode_batch([0, 1, 2])


def test_native_image_decode_matches_pil(tmp_path):
    ds = _image_folder(tmp_path)
    paths = [s[0] for s in ds.samples]
    res = native.decode_image_batch(paths, 16, 16, threads=3)
    assert res is not None, native.unavailable_reason()
    out, ok = res
    assert out.shape == (len(paths), 3, 16, 16) and out.dtype == np.float32
    for i, p in enumerate(paths):
        if p.endswith(("odd.bmp", "big.jpg")):
            assert not ok[i], p
        else:
            assert ok[i], p
            np.testing.assert_array_equal(out[i], ds.decode(i), err_msg=p)
    batch = ds.decode_batch(list(range(len(paths))))
    for i in range(len(paths)):
        np.testing.assert_array_equal(batch[i], ds.decode(i))


def test_face_record_dataset_thread_safe_decode(tmp_path):
    """Concurrent batched decodes (two loaders' prefetch threads over one
    dataset) share the reader and return the right records."""
    path, _ = _write_fixture(tmp_path, n=10)
    ds = FaceRecordDataset(path, rand_mirror=False)
    want = np.stack([ds.decode(i) for i in range(len(ds))])
    errors = []

    def worker(seed):
        rng = np.random.RandomState(seed)
        try:
            for _ in range(30):
                idxs = rng.permutation(len(ds))[:6]
                np.testing.assert_array_equal(ds.decode_batch(idxs),
                                              want[idxs])
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[0]


def test_face_record_dataset_label_scan_matches_full_read(tmp_path):
    path, _ = _write_fixture(tmp_path, n=6)
    ds = FaceRecordDataset(path, rand_mirror=False)
    r = native.NativeRecordReader(path)
    with open(path, "rb") as rec:
        for k in ds.imgidx:
            full_labels, _ = read_record(rec, ds.idx[k])
            np.testing.assert_array_equal(
                read_record_labels(rec, ds.idx[k]), full_labels)
            assert r.read(r._key_to_pos[k])[0] == full_labels[0]
        np.testing.assert_array_equal(read_record_labels(rec, ds.idx[0]),
                                      [99.0, 100.0])
    # the header's first label, as the C++ reader gives it
    assert r.read(r._key_to_pos[0]) == (99.0, b"")
    r.close()


# ---------------------------------------------------------------------------
# against the JAX package's library
# ---------------------------------------------------------------------------

def test_read_batch_matches_the_jax_library(jax_native, tmp_path):
    path, _ = _write_fixture(tmp_path, n=12, fmt="JPEG")
    ours = native.NativeRecordReader(path, n_threads=3)
    theirs = jax_native.NativeRecordReader(path, n_threads=2)
    assert list(ours.keys) == list(theirs.keys)
    pos = [ours._key_to_pos[k] for k in (5, 1, 12, 7, 0, 3)]
    lo, bo = ours.read_batch(pos)
    lt, bt = theirs.read_batch(pos)
    np.testing.assert_array_equal(lo, lt)
    assert bo == bt
    for p in pos:
        assert ours.read(p) == theirs.read(p)
    ours.close()
    theirs.close()


def test_decode_matches_the_jax_library(jax_native, tmp_path):
    ds = _image_folder(tmp_path)
    paths = [s[0] for s in ds.samples]
    out, ok = native.decode_image_batch(paths, 16, 16, threads=4)
    jout, jok = jax_native.decode_image_batch(paths, 16, 16, threads=2)
    np.testing.assert_array_equal(ok, jok)
    np.testing.assert_array_equal(out[ok], jout[jok])


def test_dataset_batches_match_the_jax_datasets(jax_native, tmp_path):
    from gslora_tpu.data.folders import ImageFolderDataset as JFolder
    from gslora_tpu.data.recordio import FaceRecordDataset as JFace
    ds = _image_folder(tmp_path / "folder")
    jds = JFolder(str(tmp_path / "folder"), image_size=16)
    idxs = list(range(len(ds)))[::-1]
    np.testing.assert_array_equal(ds.decode_batch(idxs),
                                  jds.decode_batch(idxs))
    (tmp_path / "rec").mkdir()
    path, _ = _write_fixture(tmp_path / "rec", fmt="JPEG")
    got = FaceRecordDataset(path, rand_mirror=True, seed=5)
    want = JFace(path, rand_mirror=True, seed=5)
    np.testing.assert_array_equal(got.decode_batch([4, 0, 9, 2]),
                                  want.decode_batch([4, 0, 9, 2]))


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

def test_a_failed_build_raises_with_the_log(monkeypatch, tmp_path):
    (tmp_path / "recordio.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_loaded", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for recordio"):
        native.load_library("recordio")


def test_built_once_per_source(monkeypatch):
    """The library is keyed by the source's hash: a second load builds
    nothing."""
    first = native.build("recordio")
    calls = []
    monkeypatch.setattr(native.subprocess, "run",
                        lambda *a, **k: calls.append(a))
    assert native.build("recordio") == first and calls == []
    assert first.parent == native.BUILD_DIR and first.exists()


def test_missing_codecs_make_the_decoder_unavailable(monkeypatch, tmp_path,
                                                    capsys):
    """Without libjpeg/libpng the decoder is unavailable for that stated
    reason, said once; the folder dataset decodes with PIL alone."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setattr(native, "_unavailable", {})
    monkeypatch.setattr(native, "_PROBE", "#include <no_such_codec.h>\n")
    ds = _image_folder(tmp_path / "folder")
    assert native.decode_image_batch([ds.samples[0][0]], 16, 16) is None
    assert "jpeglib.h" in native.unavailable_reason()
    assert native.decode_image_batch([ds.samples[0][0]], 16, 16) is None
    err = capsys.readouterr().err
    assert err.count("image decoder is unavailable") == 1
    batch = ds.decode_batch(list(range(len(ds))))
    for i in range(len(ds)):
        np.testing.assert_array_equal(batch[i], ds.decode(i))


# ---------------------------------------------------------------------------
# on the card machine
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_native_io_on_the_card_machine(card, tmp_path):
    """The record reader builds there; the decoder builds and equals PIL,
    or is unavailable for its stated reason."""
    path, bodies = _write_fixture(tmp_path, n=6, fmt="JPEG")
    r = native.NativeRecordReader(path)
    assert r.read_batch([r._key_to_pos[k] for k in range(1, 7)])[1] == bodies
    ds = _image_folder(tmp_path / "folder")
    res = native.decode_image_batch([s[0] for s in ds.samples], 16, 16)
    if res is None:
        print("decoder unavailable:", native.unavailable_reason(),
              file=sys.stderr)
        assert "jpeglib.h" in native.unavailable_reason()
        return
    out, ok = res
    for i in np.nonzero(ok)[0]:
        np.testing.assert_array_equal(out[i], ds.decode(int(i)))
