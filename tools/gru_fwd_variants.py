#!/usr/bin/env python3
"""Time versions of kernels 3 and 1 (``csrc/bigru_scan.cu``) in turns, in one process.

    python3 tools/gru_fwd_variants.py SPEC.json [B ...]

SPEC.json maps a version name to its changes to copies of ``csrc/`` (the
format of ``tools/variant_build.py``; ``{}`` is the checkout's own source).
Every version is built with the port's nvcc flags, then each is timed on
its tensor-core route at T=1000 F=128 bf16, two directions, for each B
given (32 and 1 without any) on ``chip_smoke.py``'s inputs (CUDA events
over 10 calls after one, and the launch's device time from the profiler),
in the order given and then in reverse.  ``d`` is the largest difference of
``ys`` from the first version's.  Needs a CUDA device.
"""

import concurrent.futures
import ctypes
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
LIB = "bigru_scan"

from variant_build import build  # noqa: E402

p, i = ctypes.c_void_p, ctypes.c_int
SYMBOLS = {"gru_scan_launch": ([p] * 6 + [i] * 6 + [p], i),
           "bigru_scan_smem_bytes": ([i, i, i], ctypes.c_size_t)}


def main() -> int:
    import torch
    import chip_smoke as c
    from tacotron_multispeaker_torch.ops import gru_scan as gs
    if not torch.cuda.is_available():
        print("gru_fwd_variants: no CUDA device", file=sys.stderr)
        return 1
    spec = json.load(open(sys.argv[1]))
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        built = list(pool.map(lambda kv: build(*kv, LIB, SYMBOLS), spec.items()))
    for name, _, regs in built:
        print(f"{name}: {regs}")
    cases = {B: c._bigru_inputs(1000, B, 128, torch.bfloat16, seed=7)
             for B in [int(b) for b in sys.argv[2:]] or [32, 1]}
    ref = {}
    for order in (built, built[::-1]):
        for name, lib, _ in order:
            gs._lib = lambda lib=lib: lib
            for B, args in cases.items():
                ys = gs._fwd_kernel(*args, route="mma")
                ref.setdefault(B, ys)
                err = (ys.float() - ref[B].float()).abs().max().item()
                run = lambda: gs._fwd_kernel(*args, route="mma")  # noqa: E731
                ms = c.cuda_time_ms(run, reps=10)
                dev = c._launch_device_ms(run, "bigru_scan")
                print(f"{name:16s} B={B:<3d} T=1000 {ms:.4f} ms (device {dev:.4f}; d {err:.1e})",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
