"""Build and load the hand-written CUDA kernels of ``gslora_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``gslora_tpu_torch/_build/lib<name>-<hash>.so``,
keyed by a hash of its source and flags, then loaded with ``ctypes``.
Nothing is built at import time: the first call that needs a kernel builds
it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
# --split-compile=0: device code optimised in parallel on every host core
# (the fp32 attention library's many instantiations build in 84 s on an
# 8-core host beside an H100, 254 s without it)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of gslora_tpu_torch "
                       "are built from source on a machine with the CUDA "
                       "toolkit")


def _source(name: str, src: Optional[Path]) -> Path:
    return CSRC_DIR / f"{name}.cu" if src is None else Path(src)


def library_path(name: str, src: Optional[Path] = None) -> Path:
    """Where the library built from ``csrc/<name>.cu`` (or from ``src``,
    under the name ``name``) lives."""
    code = _source(name, src).read_bytes()
    key = hashlib.sha256(code + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(name: str, src: Optional[Path] = None) -> Path:
    """Compile ``csrc/<name>.cu`` (or the source ``src``) unless an
    up-to-date library exists. The compiler's report (registers, shared
    memory and spills from ``-Xptxas -v``) goes to ``_build/<name>.log``;
    a failed build raises with it."""
    out = library_path(name, src)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = BUILD_DIR / f"{name}.log"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_source(name, src))]
    with open(log, "w") as fh:
        rc = subprocess.run(cmd, stdout=fh, stderr=subprocess.STDOUT).returncode
    if rc != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{log.read_text()}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def load(name: str, src: Optional[Path] = None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or of ``src``, under the
    name ``name``), built first if needed."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name, src)))
    return _loaded[name]
