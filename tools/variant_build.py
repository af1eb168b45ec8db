"""Build one version of a kernel library from a copy of ``csrc/`` with changes.

Shared by the ``tools/*_variants.py`` scripts (decoder, teacher_bwd,
gru_bwd, gru_fwd, attention, ola, wgrad and dkeys).
``changes`` maps a file of ``csrc/`` to ``[[old, new], ...]`` (each ``old``
must occur once) or to a path in the repo that replaces the whole file.
"""

import ctypes
import os
import shutil
import subprocess
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build(name, changes, lib, symbols):
    """Compile ``csrc/<lib>.cu`` with the port's nvcc flags after applying
    ``changes`` → (name, the loaded library, ptxas register and spill
    lines).  ``symbols`` maps an exported function to (argtypes, restype)."""
    from tacotron_multispeaker_torch.ops import cuda_build
    d = tempfile.mkdtemp()
    for f in os.listdir(cuda_build.CSRC):
        shutil.copy(cuda_build.CSRC / f, d)
    for fname, change in changes.items():
        path = os.path.join(d, fname)
        if isinstance(change, str):
            shutil.copy(os.path.join(REPO, change), path)
            continue
        text = open(path).read()
        for old, new in change:
            if text.count(old) != 1:
                raise ValueError(f"{name}: {old!r} occurs {text.count(old)} times in {fname}")
            text = text.replace(old, new)
        open(path, "w").write(text)
    so = os.path.join(d, f"{lib}.so")
    proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", so,
                           os.path.join(d, f"{lib}.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr[-3000:]}")
    handle = ctypes.CDLL(so)
    for sym, (argtypes, restype) in symbols.items():
        getattr(handle, sym).argtypes = argtypes
        getattr(handle, sym).restype = restype
    handle._typed = True
    report = proc.stdout + proc.stderr
    regs = [ln.split(":", 1)[-1].strip() for ln in report.splitlines()
            if "registers" in ln or "spill" in ln]
    return name, handle, regs
