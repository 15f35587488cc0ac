"""Native host IO: the RecordIO reader (``csrc/recordio.cpp``) and the
batched JPEG/PNG decoder (``csrc/imagedec.cpp``), bound with ctypes (port
of gslora_tpu/native, with its own sources).

Each source is compiled by ``g++ -O2 -std=c++17 -fPIC -pthread`` into its
own library, ``gslora_tpu_torch/_build/lib<name>-<hash>.so``, keyed by a
hash of the source and the flags, at the first call that needs it; nothing
is built at import time. The reader needs libc and pthreads only. The
decoder needs libjpeg's and libpng's headers and libraries
(``jpeglib.h``, ``png.h``, ``-ljpeg -lpng -lz``): where the toolchain has
none of them, it is unavailable for that stated reason, said once on
stderr, and :func:`decode_image_batch` returns None as the JAX function
does where its library is not built. Any other failed build raises with
the compiler's log.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")
LIBS = {"recordio": (), "imagedec": ("-ljpeg", "-lpng", "-lz")}
_PROBE = ("#include <cstddef>\n#include <cstdio>\n#include <jpeglib.h>\n"
          "#include <png.h>\nint main() { return 0; }\n")

_lock = threading.Lock()  # loader threads may ask for a library at once
_loaded: Dict[str, ctypes.CDLL] = {}
_unavailable: Dict[str, str] = {}


def _cxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: gslora_tpu_torch's native host "
                           "IO is built from csrc/*.cpp at first use")
    return found


def library_path(name: str) -> Path:
    code = (CSRC_DIR / f"{name}.cpp").read_bytes()
    flags = " ".join(CXX_FLAGS + LIBS[name]).encode()
    key = hashlib.sha256(code + flags).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def _codecs_missing() -> Optional[str]:
    """Why the decoder cannot build here (None when it can): a probe that
    includes both headers and links the three libraries."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = BUILD_DIR / f"codec_probe.{os.getpid()}"
    out = subprocess.run([_cxx(), "-x", "c++", "-", "-o", str(exe),
                          *LIBS["imagedec"]], input=_PROBE,
                         capture_output=True, text=True)
    exe.unlink(missing_ok=True)
    if out.returncode == 0:
        return None
    first = next((ln for ln in out.stderr.splitlines() if "error" in ln),
                 out.stderr.strip())
    return ("libjpeg/libpng development files are not installed (needs "
            f"jpeglib.h, png.h, -ljpeg -lpng -lz): {first.strip()}")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cpp`` unless an up-to-date library exists; a
    failed build raises with the compiler's log (``_build/<name>.log``)."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = BUILD_DIR / f"{name}.log"
    cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cpp"),
           *LIBS[name]]
    with open(log, "w") as fh:
        rc = subprocess.run(cmd, stdout=fh,
                            stderr=subprocess.STDOUT).returncode
    if rc != 0:
        raise RuntimeError(f"g++ failed for {name}:\n{log.read_text()}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def _bind_recordio(lib: ctypes.CDLL) -> None:
    c = ctypes
    i64p, f32p, u8p = (c.POINTER(c.c_int64), c.POINTER(c.c_float),
                       c.POINTER(c.c_uint8))
    lib.ri_open.restype = c.c_void_p
    lib.ri_open.argtypes = [c.c_char_p, c.c_char_p]
    lib.ri_close.argtypes = [c.c_void_p]
    lib.ri_num_records.restype = c.c_int64
    lib.ri_num_records.argtypes = [c.c_void_p]
    lib.ri_keys.restype = c.c_int64
    lib.ri_keys.argtypes = [c.c_void_p, i64p, c.c_int64]
    lib.ri_read.restype = c.c_int64
    lib.ri_read.argtypes = [c.c_void_p, c.c_int64, f32p, u8p, c.c_int64]
    lib.ri_read_batch.restype = c.c_int
    lib.ri_read_batch.argtypes = [c.c_void_p, i64p, c.c_int64, f32p, u8p,
                                  c.c_int64, i64p, i64p, c.c_int]


def _bind_imagedec(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.id_decode_batch.restype = c.c_int
    lib.id_decode_batch.argtypes = [
        c.POINTER(c.c_char_p), c.c_int64, c.POINTER(c.c_float), c.c_int64,
        c.c_int64, c.c_int, c.POINTER(c.c_uint8)]


def load_library(name: str = "recordio") -> Optional[ctypes.CDLL]:
    """The loaded library of ``csrc/<name>.cpp``, built first if needed.
    Returns None only for the decoder where the codecs are not installed
    (:func:`unavailable_reason`): they are probed before a library is
    built or loaded, as one built where they are would not load here."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        if name in _unavailable:
            return None
        if name == "imagedec":
            reason = _codecs_missing()
            if reason is not None:
                _unavailable[name] = reason
                print(f"gslora_tpu_torch.native: the image decoder is "
                      f"unavailable: {reason}", file=sys.stderr)
                return None
        lib = ctypes.CDLL(str(build(name)))
        (_bind_recordio if name == "recordio" else _bind_imagedec)(lib)
        _loaded[name] = lib
        return lib


def unavailable_reason(name: str = "imagedec") -> Optional[str]:
    """Why ``name`` is unavailable here, or None when it loads."""
    load_library(name)
    return _unavailable.get(name)


def available() -> bool:
    """True when the record reader loads (it needs only g++)."""
    return load_library("recordio") is not None


def default_threads() -> int:
    return max(1, min(8, os.cpu_count() or 1))


def decode_image_batch(paths: List[str], height: int, width: int,
                       threads: int = 4
                       ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Decode JPEG/PNG files into (n, 3, H, W) float32 /255 on a C++
    thread pool -> (batch, ok): ok[i] is False where the caller decodes
    the image itself (a resize is needed, the codec is neither JPEG nor
    PNG, the file is unreadable). None where the decoder is unavailable."""
    lib = load_library("imagedec")
    if lib is None:
        return None
    n = len(paths)
    out = np.zeros((n, 3, height, width), np.float32)
    ok = np.zeros(n, np.uint8)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.id_decode_batch(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        height, width, threads,
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out, ok.astype(bool)


class NativeRecordReader:
    """Threaded batched record reads of a .rec/.idx pair; positions are
    rows of the .idx table (``_key_to_pos`` maps a key to its row)."""

    def __init__(self, rec_path: str, idx_path: Optional[str] = None,
                 n_threads: int = 4):
        self._lib = load_library("recordio")
        self._h = self._lib.ri_open(
            os.fsencode(rec_path),
            os.fsencode(idx_path or rec_path[:-4] + ".idx"))
        if not self._h:
            raise IOError(f"cannot open the recordio pair of {rec_path} "
                          "(missing file or malformed .idx line)")
        self.n_threads = n_threads
        n = self._lib.ri_num_records(self._h)
        keys = np.zeros(n, np.int64)
        self._lib.ri_keys(self._h, keys.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int64)), n)
        self.keys = keys
        self._key_to_pos = {int(k): i for i, k in enumerate(keys)}

    def __len__(self):
        return len(self.keys)

    def read(self, pos: int) -> Tuple[float, bytes]:
        """(first label, body bytes) of the record at table row ``pos``."""
        label = ctypes.c_float()
        cap = 1 << 16
        while True:
            buf = np.zeros(cap, np.uint8)
            n = self._lib.ri_read(
                self._h, pos, ctypes.byref(label),
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
            if n < 0:
                raise IOError(f"record read failed at pos {pos}")
            if n <= cap:
                return float(label.value), buf[:n].tobytes()
            cap = int(n)

    def read_batch(self, positions) -> Tuple[np.ndarray, List[bytes]]:
        """(first labels, body bytes) of the records at ``positions``, read
        on ``n_threads`` threads; one bad record fails the whole batch."""
        idxs = np.ascontiguousarray(positions, np.int64)
        n = len(idxs)
        labels = np.zeros(n, np.float32)
        starts = np.zeros(n, np.int64)
        lengths = np.zeros(n, np.int64)
        cap = 1 << 20
        while True:
            out = np.empty(cap, np.uint8)
            rc = self._lib.ri_read_batch(
                self._h, idxs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                n, labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
                starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                self.n_threads)
            if rc == 0:
                return labels, [out[s:s + ln].tobytes()
                                for s, ln in zip(starts, lengths)]
            if rc != -2:
                raise IOError("batched record read failed")
            cap *= 4

    def close(self):
        if self._h:
            self._lib.ri_close(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()
