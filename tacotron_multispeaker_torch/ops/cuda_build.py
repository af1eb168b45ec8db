"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers, so a
build takes seconds).  At first use it is compiled for ``sm_90a`` into
``tacotron_multispeaker_torch/build/<name>-<hash>.so``, keyed by a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, and loaded.
``nvcc -Xptxas -v`` reports each kernel's registers, shared memory and
spills; the report is kept beside the library (``.log``) and in
:data:`build_info`.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine without ``nvcc``.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_locks: dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()
# name -> {"seconds": build time (0.0 when the library was already built),
#          "ptxas": the -Xptxas -v report, "path": the .so}
build_info: dict[str, dict] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the port's CUDA "
                       "kernels are built from csrc/ at first use")


def _lock_for(name: str) -> threading.Lock:
    with _locks_guard:
        return _locks.setdefault(name, threading.Lock())


def _build(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    log = so.with_suffix(".log")
    if so.exists():
        build_info[name] = {"seconds": 0.0, "path": str(so),
                            "ptxas": log.read_text() if log.exists() else ""}
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp{os.getpid()}.so")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    report = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name} "
                           f"(exit {proc.returncode}):\n{report}")
    log.write_text(report)
    os.replace(tmp, so)
    build_info[name] = {"seconds": seconds, "path": str(so), "ptxas": report}
    return so


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock_for(name):
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_build(name)))
        return _libs[name]


def build_all(names) -> dict[str, dict]:
    """Build several kernel libraries at once (one nvcc each, in parallel)."""
    names = list(names)
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(library, names))
    return {n: build_info[n] for n in names}


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
