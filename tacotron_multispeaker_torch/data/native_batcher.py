"""ctypes bindings of the native batch assembler (``native/batcher.cc``).

Port of ``tacotron_multispeaker_tpu/data/native_batcher.py`` over the
port's own copy of the C++ source.  At first use the source is compiled
with ``g++ -O3 -shared -fPIC -std=c++17`` into
``tacotron_multispeaker_torch/build/batcher-<hash>.so``, keyed by a hash of
the source and the flags (as ``ops/cuda_build.py`` keys the kernels), and
loaded.  :func:`available` says whether that worked; the Feeder keeps the
numpy path, the reference, where it did not.

The calls go through ``ctypes.CDLL``, which releases the interpreter lock
for their duration: C++ threads read and pad a batch while the train step
launches its work.  :func:`assemble_into` writes into a buffer the caller
gives (a pinned or shared-memory tensor's array), so a batch lands there
without another pass.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SRC = _PKG / "native" / "batcher.cc"
BUILD_DIR = _PKG / "build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_error: str | None = None


def _build() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"batcher-{digest}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp{os.getpid()}.so")
    proc = subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SRC), "-lpthread"],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SRC.name} (exit {proc.returncode}):\n"
                           f"{proc.stderr[-2000:]}")
    os.replace(tmp, so)             # atomic: concurrent builders each write their own tmp
    return so


def _load() -> None:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _build_error = f"{type(e).__name__}: {e}"
            return
        lib.assemble_batch.restype = ctypes.c_int
        lib.assemble_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
        lib.npy_rows.restype = ctypes.c_int64
        lib.npy_rows.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        _lib = lib


def available() -> bool:
    """Whether the library builds and loads here (built at the first call)."""
    _load()
    return _lib is not None


def build_error() -> str | None:
    """Why :func:`available` is false, else None."""
    _load()
    return _build_error


def _library() -> ctypes.CDLL:
    _load()
    if _lib is None:
        raise RuntimeError(f"native batcher unavailable: {_build_error}")
    return _lib


def npy_rows(path: str, cols: int) -> int:
    """Rows of a 2-D float32 .npy with ``cols`` columns, else -1."""
    return int(_library().npy_rows(path.encode(), cols))


def assemble_into(paths: list[str], out: np.ndarray, num_threads: int = 4) -> np.ndarray:
    """Load ``len(paths)`` float32 [T, cols] .npy files into ``out``
    ([len(paths), t_cap, cols] float32, C-contiguous, writable), each
    zero-padded or cut to ``t_cap`` rows; returns the rows taken of each
    (int32 [len(paths)]).  Raises ``IOError`` naming the files that failed."""
    lib = _library()
    n = len(paths)
    if (out.dtype != np.float32 or out.ndim != 3 or out.shape[0] != n
            or not out.flags.c_contiguous or not out.flags.writeable):
        raise ValueError(f"out must be a writable C-contiguous float32 [{n}, t_cap, cols] "
                         f"array, got {out.dtype} {out.shape}")
    _, t_cap, cols = out.shape
    lengths = np.empty((n,), np.int64)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failures = lib.assemble_batch(
        c_paths, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), t_cap, cols, num_threads)
    if failures:
        bad = [paths[i] for i in range(n) if lengths[i] < 0]
        raise IOError(f"native batcher failed on {failures} files: {bad[:3]}")
    return lengths.astype(np.int32)


def assemble_batch(paths: list[str], t_cap: int, cols: int,
                   num_threads: int = 4) -> tuple[np.ndarray, np.ndarray]:
    """:func:`assemble_into` a new [len(paths), t_cap, cols] array:
    (batch, lengths)."""
    out = np.empty((len(paths), t_cap, cols), np.float32)
    return out, assemble_into(paths, out, num_threads)
