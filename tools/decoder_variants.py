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
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from variant_build import build  # noqa: E402

p = ctypes.c_void_p
SYMBOLS = {"decoder_loop_launch": ([p] * 3, ctypes.c_int),
           "decoder_loop_max_clusters": ([p] * 2, ctypes.c_int),
           "decoder_loop_smem_bytes": ([p], ctypes.c_size_t)}


def main() -> int:
    import torch
    import chip_smoke as c
    from tacotron_multispeaker_torch.ops import decoder_loop as dl
    if not torch.cuda.is_available():
        print("decoder_variants: no CUDA device", file=sys.stderr)
        return 1
    spec = json.load(open(sys.argv[1]))
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        built = list(pool.map(lambda kv: build(*kv, "decoder_loop", SYMBOLS), spec.items()))
    for name, _, regs in built:
        print(f"{name}: {regs}")
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
