"""Batch assembly + host->device pipeline.

The port's copy of ``gslora_tpu/data/pipeline.py``: a background decode
thread keeps a small queue of ready numpy batches while the device
computes, and DevicePrefetcher keeps the next batches already on their
way to the device (pinned host memory, non_blocking copies) — what the
reference's CUDA-stream data_prefetcher (util/data_prefetcher.py) bought.

Epoch semantics reproduced from the reference dual-loader protocol: the
epoch is driven by one loader; the other CYCLES (restarts mid-epoch when
exhausted, engine.py:416-421) — see CyclingLoader.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from gslora_tpu_torch.data.folders import Dataset


class BatchLoader:
    """Shuffled (seeded) epoch iterator yielding (images, labels) numpy
    batches; drop_last=False like every reference loader."""

    def __init__(self, dataset: Dataset, batch_size: int,
                 shuffle: bool = True, seed: int = 1337,
                 pad_to_batch: bool = False, prefetch: int = 2,
                 drop_last: bool = False, mask_padding: bool = False,
                 uint8_transfer: bool = False,
                 local_bounds: "Optional[Tuple[int, int]]" = None):
        """The reference keeps ragged last batches (drop_last=False
        everywhere) — same default here. Runs that want static shapes can
        opt into ``pad_to_batch`` (wrap-around fill: the tail's loss mean
        weights wrapped samples twice) or ``drop_last``.

        ``mask_padding`` (implies pad_to_batch): padded slots get label -1,
        the sentinel every loss/accuracy reduction in this package masks
        out — static shapes WITHOUT double-weighting wrapped samples. The
        training loop uses it on the card, as the JAX loop does off the
        CPU.

        ``uint8_transfer``: ship batches as uint8 pixels and dequantize on
        device (vit_embed casts + /255) — 4x less host->device traffic
        than fp32, with a forward bit-identical to the fp32 path.
        Valid for ToTensor-only pipelines (face path, train_own.py:287:
        every pixel is exactly k/255) and for raw_uint8 datasets whose
        mean/std runs on device (ImageNet via ViTConfig.input_norm);
        datasets applying mean/std or float augmentation ON HOST must
        keep the fp32 default. EVERY assembled fp32 batch is validated
        for exact uint8 representability (a rint round-trip per batch —
        cheap next to decode; raw uint8 batches skip it).

        ``local_bounds`` (multi-host pods, parallel/multihost.py): decode
        only rows [start, stop) of each GLOBAL batch — ``batch_size``
        stays the global batch; every host runs an identically-seeded
        loader so the global shuffle order is in lockstep and host k
        materializes just its shard. Requires static shapes
        (mask_padding or drop_last): a ragged tail has no well-defined
        per-host row split."""
        if local_bounds is not None:
            lo, hi = local_bounds
            if not (0 <= lo < hi <= batch_size):
                raise ValueError(f"local_bounds {local_bounds} not within "
                                 f"[0, {batch_size}]")
            if not (mask_padding or drop_last):
                raise ValueError(
                    "local_bounds needs static global batches — enable "
                    "mask_padding (padded tail, -1 sentinel labels) or "
                    "drop_last")
        self.local_bounds = local_bounds
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.pad_to_batch = pad_to_batch or mask_padding
        self.mask_padding = mask_padding
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.uint8_transfer = uint8_transfer
        self._epoch = 0

    def __len__(self):
        if self.drop_last:
            return len(self.ds) // self.bs
        return (len(self.ds) + self.bs - 1) // self.bs

    def _assemble(self, idxs) -> Tuple[np.ndarray, np.ndarray]:
        idxs = list(idxs)
        valid = len(idxs)
        if self.pad_to_batch and len(idxs) < self.bs:
            need = self.bs - len(idxs)
            idxs = idxs + [idxs[i % len(idxs)] for i in range(need)]
        lo = 0
        if self.local_bounds is not None:
            # decode only this host's rows of the global batch
            lo, hi = self.local_bounds
            idxs = idxs[lo:hi]
        imgs = self.ds.decode_batch(idxs) if hasattr(self.ds, "decode_batch") \
            else np.stack([self.ds.decode(i) for i in idxs])
        labels = np.asarray([self.ds.samples[i][1] for i in idxs],
                            dtype=np.int32)
        if self.mask_padding and valid < lo + len(idxs):
            labels[max(valid - lo, 0):] = -1
        if self.uint8_transfer:
            return self._quantize(imgs), labels
        if imgs.dtype == np.uint8:
            raise ValueError(
                "dataset decodes raw uint8 pixels (raw_uint8=True) but "
                "the loader would ship fp32 without normalizing — pass "
                "uint8_transfer=True so the model dequantizes "
                "(vit_embed + ViTConfig.input_norm)")
        return imgs.astype(np.float32), labels

    def _quantize(self, imgs: np.ndarray) -> np.ndarray:
        """fp32 (k/255) -> uint8 k, validated exact per batch (cheap next
        to decode): q/255 in fp32 must reproduce the decoded values
        bit-for-bit (the dequant vit_embed performs on device)."""
        if imgs.dtype == np.uint8:
            return imgs
        q = np.rint(imgs.astype(np.float32) * 255.0)
        if (q.min() < 0 or q.max() > 255 or not np.array_equal(
                q.astype(np.uint8).astype(np.float32) /
                np.float32(255.0), imgs.astype(np.float32))):
            raise ValueError(
                "uint8_transfer requires ToTensor-only pixels (every "
                "value exactly k/255); this dataset yields values "
                "outside exact uint8 range (mean/std-normalized or "
                "float-augmented streams) — use the default float32 "
                "transfer")
        return q.astype(np.uint8)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(self.ds)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.RandomState(
                self.seed + self._epoch).permutation(n)
        self._epoch += 1
        end = (n // self.bs) * self.bs if self.drop_last else n
        chunks = [order[i:i + self.bs] for i in range(0, end, self.bs)]
        if self.prefetch <= 0:
            for c in chunks:
                yield self._assemble(c)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        STOP = object()
        abandoned = threading.Event()

        def put(item) -> bool:
            # never block forever: a consumer that abandons the epoch
            # mid-iteration (CyclingLoader at an epoch boundary) would
            # otherwise leave this thread parked in q.put holding decoded
            # batches — one leaked thread per epoch
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for c in chunks:
                    if not put(self._assemble(c)):
                        return
                put(STOP)
            except BaseException as e:  # surface decode errors, don't
                put(e)                  # silently truncate the epoch

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is STOP:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # runs on normal exhaustion AND on GeneratorExit/GC of a
            # half-consumed epoch; lets the worker exit promptly
            abandoned.set()


class DevicePrefetcher:
    """Keep N batches already on their way to the device while the current
    step runs: each numpy batch is copied into pinned host memory and sent
    with a non_blocking copy on the current stream, so the transfer
    overlaps the previous step. Wraps any (x, y) numpy iterator and yields
    (x, y) tensors on ``device``; on the CPU it only wraps the arrays."""

    def __init__(self, it: Iterator, device, depth: int = 2):
        import torch
        self._torch = torch
        self._it = iter(it)
        self._device = torch.device(device)
        self._buf: list = []
        self._depth = max(depth, 1)
        self._fill()

    def _put(self, batch):
        torch = self._torch
        out = []
        for a in batch:
            t = torch.from_numpy(np.ascontiguousarray(a))
            if self._device.type == "cuda":
                t = t.pin_memory().to(self._device, non_blocking=True)
            out.append(t)
        return tuple(out)

    def _fill(self):
        while len(self._buf) < self._depth:
            try:
                self._buf.append(self._put(next(self._it)))
            except StopIteration:
                break

    def __iter__(self):
        return self

    def __next__(self):
        if not self._buf:
            raise StopIteration
        batch = self._buf.pop(0)
        self._fill()
        return batch


class CyclingLoader:
    """Endless stream over a BatchLoader: restarts (with a fresh shuffle)
    whenever exhausted — the reference's prefetcher-recreate dance
    (engine.py:416-421) without the None sentinel.

    Over a process-sharded loader (parallel/multihost) every rank's
    loader has the same number of global batches and reshuffles with the
    same ``seed + epoch``, so every rank restarts at the same global batch
    and takes its rows of the same next batch."""

    def __init__(self, loader: BatchLoader):
        self.loader = loader
        self._it: Optional[Iterator] = None

    def next(self):
        if len(self.loader) == 0:
            raise ValueError("CyclingLoader over an empty loader")
        if self._it is None:
            self._it = iter(self.loader)
        try:
            return next(self._it)
        except StopIteration:
            self._it = iter(self.loader)
            return next(self._it)
