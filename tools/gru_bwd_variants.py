#!/usr/bin/env python3
"""Time versions of kernels 4 and 2 (``csrc/bigru_scan_bwd.cu``) in turns, in one process.

    python3 tools/gru_bwd_variants.py SPEC.json [T ...]

SPEC.json maps a version name to its changes to copies of ``csrc/`` (the
format of ``tools/variant_build.py``; ``{}`` is the checkout's own source).
Every version is built with the port's nvcc flags, then each is timed at
B=32 F=128 bf16, two directions, at each T given (T=1000 without one) on
``chip_smoke.py``'s inputs (the backward's two launches, CUDA events over 5
calls after one, and the device time of each launch from the profiler), in
the order given and then in reverse.  ``d`` is the largest difference of
``dxg`` and ``dh0`` from the first version's, relative to their peak.
Needs a CUDA device.
"""

import concurrent.futures
import ctypes
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
LIB = "bigru_scan_bwd"

from variant_build import build  # noqa: E402

p, i = ctypes.c_void_p, ctypes.c_int
SYMBOLS = {"gru_scan_bwd_remat_launch": ([p] * 7 + [i] * 5 + [p], i),
           "gru_scan_bwd_launch": ([p] * 8 + [i] * 5 + [p], i),
           "bigru_scan_bwd_smem_bytes": ([i, i], ctypes.c_size_t),
           "bigru_scan_bwd_remat_smem_bytes": ([i, i], ctypes.c_size_t)}


def main() -> int:
    import torch
    import chip_smoke as c
    from tacotron_multispeaker_torch.ops import gru_scan as gs
    if not torch.cuda.is_available():
        print("gru_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    spec = json.load(open(sys.argv[1]))
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        built = list(pool.map(lambda kv: build(*kv, LIB, SYMBOLS), spec.items()))
    for name, _, regs in built:
        print(f"{name}: {regs}")
    cases = {T: c._gru_bwd_case(2, T, 32, 128, torch.bfloat16, seed=11)
             for T in [int(t) for t in sys.argv[2:]] or [1000]}
    ref = {}
    stems = ("bigru_bwd_remat", "bigru_bwd_scan")
    for order in (built, built[::-1]):
        for name, lib, _ in order:
            gs._bwd_lib = lambda lib=lib: lib
            for T, args in cases.items():
                dxg, _, _, dh0 = gs._bwd_kernel(*args)
                ref.setdefault(T, (dxg, dh0))
                err = max(c._rel_err(a, b) for a, b in zip((dxg, dh0), ref[T]))
                run = lambda: gs._bwd_kernel(*args)  # noqa: E731
                ms = c.cuda_time_ms(run, reps=5)
                split, _ = c._device_split_ms(run, stems)
                print(f"{name:16s} T={T:<5d} {ms:.3f} ms (remat {split[stems[0]]:.4f}, scan "
                      f"{split[stems[1]]:.4f}; d {err:.1e})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
