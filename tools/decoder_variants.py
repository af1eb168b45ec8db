#!/usr/bin/env python3
"""Time versions of kernel 5 (``csrc/decoder_loop.cu``) in turns, in one process.

    python3 tools/decoder_variants.py SPEC.json

SPEC.json maps a version name to its changes to copies of ``csrc/``:
``{"file.cuh": [[old, new], ...]}`` replaces text (each ``old`` must occur
once), ``{"file.cuh": "path/to/file"}`` replaces the whole file; ``{}`` is
the checkout's own source.  Every version is built with the port's nvcc
flags, then each is timed (CUDA events, 3 calls after one) at B=1 L=96 (C=16),
B=32 L=192 (C=2) and B=1 L=96 (C=1), 200 bf16 steps on ``chip_smoke.py``'s
inputs, in the order given and then in reverse.  ``d`` is the largest
frame difference from the first version's output.  Needs a CUDA device.
"""

import concurrent.futures
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def build(name, changes):
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
    so = os.path.join(d, "decoder_loop.so")
    proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", so,
                           os.path.join(d, "decoder_loop.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(so)
    lib.decoder_loop_launch.argtypes = [ctypes.c_void_p] * 3
    lib.decoder_loop_max_clusters.argtypes = [ctypes.c_void_p] * 2
    lib.decoder_loop_smem_bytes.argtypes = [ctypes.c_void_p]
    lib.decoder_loop_smem_bytes.restype = ctypes.c_size_t
    lib._typed = True
    spills = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines() if "spill" in ln]
    return name, lib, spills


def main() -> int:
    import torch
    import chip_smoke as c
    from tacotron_multispeaker_torch.ops import decoder_loop as dl
    if not torch.cuda.is_available():
        print("decoder_variants: no CUDA device", file=sys.stderr)
        return 1
    spec = json.load(open(sys.argv[1]))
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        built = list(pool.map(lambda kv: build(*kv), spec.items()))
    for name, _, spills in built:
        print(f"{name}: {spills}")
    cases = [(1, 96, 16), (32, 192, 2), (1, 96, 1)]
    inputs = {cs: c._decoder_case(cs[0], cs[1], 200, torch.bfloat16, scale=0.05, seed=6)
              for cs in cases}
    ref = {}
    for order in (built, built[::-1]):
        for name, lib, _ in order:
            dl._lib = lambda lib=lib: lib
            parts = []
            for cs in cases:
                args = inputs[cs]
                frames, _ = dl._decoder_loop_cuda(*args, cluster=cs[2])
                ref.setdefault(cs, frames)
                err = (frames - ref[cs]).abs().max().item()
                ms = c.cuda_time_ms(lambda: dl._decoder_loop_cuda(*args, cluster=cs[2]), reps=3)
                parts.append(f"B={cs[0]} C={cs[2]} {ms:.3f} ms (d {err:.1e})")
            print(f"{name:14s} " + " | ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
