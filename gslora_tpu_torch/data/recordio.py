"""Legacy face-dataset ingestion: mxnet RecordIO (.rec/.idx) and .bin
verification-pair files — WITHOUT mxnet (the reference's only native-code
dependency besides torch, image_iter.py:18-86 / util/utils.py:38-75).

The port's own copy of ``gslora_tpu/data/recordio.py``: a pure-Python
reader, and :meth:`FaceRecordDataset.decode_batch` reading a batch's
records through the threaded C++ pread reader (gslora_tpu_torch/native,
``csrc/recordio.cpp``); PIL is imported only where an image is decoded.

RecordIO layout (mxnet C++ recordio.h): each record is
  uint32 magic (0xced7230a) | uint32 lrecord | payload | pad to 4 bytes
where lrecord's upper 3 bits are the continuation flag and lower 29 the
payload length. Payload starts with IRHeader ``struct {u32 flag; f32 label;
u64 id; u64 id2}``; flag>0 means ``flag`` float32 labels follow. The .idx
file is text "key\\toffset" lines.
"""
from __future__ import annotations

import io
import pickle
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

_MAGIC = 0xCED7230A
_IR = struct.Struct("<IfQQ")


def read_idx_file(path: str) -> Dict[int, int]:
    offsets = {}
    with open(path) as f:
        for line in f:
            parts = line.split("\t")
            if len(parts) >= 2:
                offsets[int(parts[0])] = int(parts[1])
    return offsets


def read_record(rec, offset: int) -> Tuple[np.ndarray, bytes]:
    """Read one record at offset -> (label array, content bytes)."""
    rec.seek(offset)
    magic, lrecord = struct.unpack("<II", rec.read(8))
    if magic != _MAGIC:
        raise ValueError(f"bad recordio magic at offset {offset}")
    length = lrecord & ((1 << 29) - 1)
    payload = rec.read(length)
    flag, label, _id, _id2 = _IR.unpack(payload[: _IR.size])
    body = payload[_IR.size:]
    if flag > 0:
        labels = np.frombuffer(body[: 4 * flag], np.float32)
        body = body[4 * flag:]
    else:
        labels = np.asarray([label], np.float32)
    return labels, body


def read_record_labels(rec, offset: int) -> np.ndarray:
    """Label-only record read: header + IRHeader (+ label floats), WITHOUT
    the image payload. The index-building scan over a multi-GB .rec only
    needs ~32 bytes per record — reading full JPEG bodies there would pull
    the entire file through python at construction."""
    rec.seek(offset)
    head = rec.read(8 + _IR.size)
    magic, _ = struct.unpack("<II", head[:8])
    if magic != _MAGIC:
        raise ValueError(f"bad recordio magic at offset {offset}")
    flag, label, _id, _id2 = _IR.unpack(head[8:])
    if flag > 0:
        return np.frombuffer(rec.read(4 * flag), np.float32)
    return np.asarray([label], np.float32)


class FaceRecordDataset:
    """Indexed .rec face dataset (reference FaceDataset,
    image_iter.py:34-86): record 0 is a header whose label gives the
    [start, end) range of per-identity header records; images are the
    records below that range. Decoding via PIL; optional random mirror."""

    def __init__(self, rec_path: str, idx_path: Optional[str] = None,
                 rand_mirror: bool = True, seed: int = 0):
        import threading
        self.rec_path = rec_path
        self.idx_path = idx_path or rec_path[:-4] + ".idx"
        self.idx = read_idx_file(self.idx_path)
        self.rand_mirror = rand_mirror
        self._rng = np.random.RandomState(seed)
        # decode() runs inside BatchLoader prefetch threads, and the
        # dual-loader protocol prefetches two loaders over subsets of the
        # SAME dataset concurrently: a shared handle's seek/read interleaves
        # across threads (reads the wrong record), so handles are
        # thread-local; the mirror RNG is shared for batch determinism and
        # lock-guarded (mtrand is not thread-safe)
        self._local = threading.local()
        self._rng_lock = threading.Lock()
        rec = self._handle()
        header0_label = read_record_labels(rec, self.idx[0])
        if len(header0_label) >= 2:
            id_start, id_end = int(header0_label[0]), int(header0_label[1])
            self.imgidx = [k for k in self.idx if 0 < k < id_start]
        else:
            self.imgidx = [k for k in self.idx if k > 0]
        self.samples: List[Tuple[int, int]] = []
        self.targets: List[int] = []
        for k in self.imgidx:
            # label-only reads: the full-record path would stream every
            # JPEG body through python just to build the index
            t = int(read_record_labels(rec, self.idx[k])[0])
            self.samples.append((k, t))
            self.targets.append(t)
        n_cls = (max(self.targets) + 1) if self.targets else 0
        self.classes = [str(i) for i in range(n_cls)]
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}

    def _handle(self):
        rec = getattr(self._local, "rec", None)
        if rec is None:
            rec = self._local.rec = open(self.rec_path, "rb")
        return rec

    def __len__(self):
        return len(self.samples)

    def decode(self, i: int) -> np.ndarray:
        key, _ = self.samples[i]
        _, body = read_record(self._handle(), self.idx[key])
        return self._decode_body(body)

    def _decode_body(self, body: bytes) -> np.ndarray:
        from PIL import Image
        img = Image.open(io.BytesIO(body)).convert("RGB")
        arr = np.asarray(img, np.float32) / 255.0
        if self.rand_mirror:
            with self._rng_lock:
                flip = self._rng.randint(2)
            if flip:
                arr = arr[:, ::-1]
        return arr.transpose(2, 0, 1).copy()

    def native_reader(self):
        """The threaded C++ reader of this .rec (built and opened at first
        use); an open error raises."""
        if getattr(self, "_native_reader", None) is None:
            from gslora_tpu_torch.native import (NativeRecordReader,
                                                 default_threads)
            self._native_reader = NativeRecordReader(
                self.rec_path, self.idx_path, n_threads=default_threads())
        return self._native_reader

    def decode_batch(self, idxs) -> np.ndarray:
        """Batched decode: the records' bytes come from the C++ pread
        thread pool in one call (byte-identical to the Python reader), PIL
        decodes them. Mirror draws stay in per-sample order, so the batch
        equals the one ``decode`` gives image by image."""
        reader = self.native_reader()
        pos = [reader._key_to_pos[self.samples[i][0]] for i in idxs]
        _, bodies = reader.read_batch(pos)
        return np.stack([self._decode_body(b) for b in bodies])


def write_recordio(path: str, records: List[Tuple[np.ndarray, bytes]],
                   header0: Optional[np.ndarray] = None) -> None:
    """Writer (for tests / dataset conversion): records are
    (label array, content bytes); header0 written as record key 0."""
    offsets = {}
    with open(path, "wb") as f:
        def emit(key, labels, body):
            offsets[key] = f.tell()
            labels = np.asarray(labels, np.float32)
            if len(labels) == 1:
                payload = _IR.pack(0, float(labels[0]), key, 0) + body
            else:
                payload = _IR.pack(len(labels), 0.0, key, 0) + \
                    labels.tobytes() + body
            f.write(struct.pack("<II", _MAGIC, len(payload)))
            f.write(payload)
            pad = (-len(payload)) % 4
            f.write(b"\x00" * pad)

        if header0 is not None:
            emit(0, header0, b"")
        for i, (labels, body) in enumerate(records, start=1):
            emit(i, labels, body)
    with open(path[:-4] + ".idx", "w") as f:
        for k in sorted(offsets):
            f.write(f"{k}\t{offsets[k]}\n")


def get_val_data(data_path: str, targets, image_size: int = 112):
    """Load several verification-pair sets by name (util/utils.py:60-75
    get_val_data): returns [(name, (imgs, flipped), issame), ...] for each
    <data_path>/<name>.bin present."""
    import os
    out = []
    for name in targets:
        p = os.path.join(data_path, f"{name}.bin")
        if os.path.exists(p):
            data_set, issame = load_bin(p, image_size)
            out.append((name, data_set, issame))
    return out


def load_bin(path: str, image_size: int = 112
             ) -> Tuple[Tuple[np.ndarray, np.ndarray], List[bool]]:
    """Verification-pair .bin loader (util/utils.py:38-57): a pickle of
    (bins, issame_list) where bins are encoded image bytes. Returns
    ((images, flipped_images) CHW float arrays, issame)."""
    from PIL import Image
    with open(path, "rb") as f:
        bins, issame = pickle.load(f, encoding="bytes")
    n = len(bins)
    imgs = np.zeros((n, 3, image_size, image_size), np.float32)
    for i, b in enumerate(bins):
        if isinstance(b, np.ndarray):
            b = b.tobytes()
        img = Image.open(io.BytesIO(b)).convert("RGB")
        if img.size != (image_size, image_size):
            img = img.resize((image_size, image_size))
        imgs[i] = (np.asarray(img, np.float32) / 255.0).transpose(2, 0, 1)
    flipped = imgs[:, :, :, ::-1].copy()
    return (imgs, flipped), list(issame)
