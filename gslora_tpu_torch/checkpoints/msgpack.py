"""Reader of the JAX package's ``.msgpack`` checkpoints, on the standard
library and numpy alone.

``gslora_tpu/checkpoints/io.py`` writes a parameter tree with
``flax.serialization.to_bytes``: the msgpack encoding
(https://github.com/msgpack/msgpack/blob/master/spec.md) of nested maps
whose leaves are arrays in flax's ext types:

* ext 1 (ndarray) and ext 3 (numpy scalar): the payload is itself msgpack
  of ``(shape, dtype name, raw C-order bytes)``; ``bfloat16``, which numpy
  lacks, comes back as a ``torch.bfloat16`` tensor viewed from ``uint16``;
* leaves over 2**30 bytes are split by flax into a map
  ``{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks":
  {"0": flat array, ...}}``, joined back here.

Arrays come back as CPU tensors; maps as dicts, with every other msgpack
value (nil, bools, ints, floats, strings, bytes, arrays) as in Python.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """One pass over a msgpack byte string."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:  # positive fixint
            return b
        if b >= 0xE0:  # negative fixint
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        sizes = {0: ">B", 1: ">H", 2: ">I"}
        if 0xC4 <= b <= 0xC6:  # bin 8/16/32
            return bytes(self.take(self.unpack(sizes[b - 0xC4])))
        if 0xD9 <= b <= 0xDB:  # str 8/16/32
            return self.str(self.unpack(sizes[b - 0xD9]))
        if b in (0xDC, 0xDD):  # array 16/32
            return self.array(self.unpack(sizes[b - 0xDB]))
        if b in (0xDE, 0xDF):  # map 16/32
            return self.map(self.unpack(sizes[b - 0xDD]))
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            return self.ext(1 << (b - 0xD4))
        if 0xC7 <= b <= 0xC9:  # ext 8/16/32
            return self.ext(self.unpack(sizes[b - 0xC7]))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(payload).reshape(())
        raise ValueError(f"msgpack: ext type {code} is not a flax array")


def _ndarray(payload: bytes) -> torch.Tensor:
    """flax's ``(shape, dtype name, bytes)`` array encoding -> tensor."""
    shape, name, raw = _Reader(payload).value()
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        flat = np.frombuffer(raw, dtype=np.uint16).copy()
        return torch.from_numpy(flat).view(torch.bfloat16).reshape(shape)
    flat = np.frombuffer(raw, dtype=np.dtype(name)).copy()
    return torch.from_numpy(flat.reshape(shape))


def _unchunk(tree: Any) -> Any:
    """Join flax's chunked leaves back into one array each."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED):
        shape = _in_order(tree["shape"])
        chunks = _in_order(tree["chunks"])
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def _in_order(d: dict) -> Tuple:
    """flax's tuple-as-map {"0": a, "1": b} -> (a, b)."""
    return tuple(d[str(i)] for i in range(len(d)))


def loads(data: bytes) -> Any:
    """The tree in a flax msgpack byte string."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("msgpack: trailing bytes after the tree")
    return _unchunk(tree)


def load(path: str) -> Any:
    """The tree in a ``.msgpack`` file of the JAX package."""
    with open(path, "rb") as fh:
        return loads(fh.read())
