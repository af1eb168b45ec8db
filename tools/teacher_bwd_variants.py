#!/usr/bin/env python3
"""Time versions of kernel 8 (``csrc/teacher_decoder_bwd.cu``) in turns, in one process.

    python3 tools/teacher_bwd_variants.py SPEC.json [B ...]

SPEC.json maps a version name to its changes to copies of ``csrc/``:
``{"file.cu": [[old, new], ...]}`` replaces text (each ``old`` must occur
once), ``{"file.cu": "path/to/file"}`` replaces the whole file; ``{}`` is
the checkout's own source.  Every version is built with the port's nvcc
flags, then each is timed at L=192 S=200 H=A=256 D=320 bf16 and each batch
size given (B=32 without one) on ``chip_smoke.py``'s inputs (the backward's two launches, CUDA events over 3
calls after one, and the device time of each launch from the profiler), in
the order given and then in reverse.  ``d`` is the largest difference of
``dpng`` and ``dh0d`` from the first version's, relative to their peak.
Needs a CUDA device.
"""

import concurrent.futures
import ctypes
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
LIB = "teacher_decoder_bwd"

from variant_build import build  # noqa: E402

p = ctypes.c_void_p
SYMBOLS = {f"{LIB}{sfx}_{fn}": ([p] * n, rt) for sfx in ("", "_remat")
           for fn, n, rt in (("launch", 3, ctypes.c_int), ("smem_bytes", 1, ctypes.c_size_t))}


def main() -> int:
    import torch
    import chip_smoke as c
    from tacotron_multispeaker_torch.ops import teacher_decoder as td
    if not torch.cuda.is_available():
        print("teacher_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    spec = json.load(open(sys.argv[1]))
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        built = list(pool.map(lambda kv: build(*kv, LIB, SYMBOLS), spec.items()))
    for name, _, regs in built:
        print(f"{name}: {regs}")
    L, S = 192, 200
    cases = {}
    for B in [int(b) for b in sys.argv[2:]] or [32]:
        w, args = c._teacher_case(B, L, S, torch.bfloat16, seed=24)
        states = td.teacher_decoder_fwd_reference(*args[:4], w, *args[4:])
        cases[B] = c._teacher_bwd_args(args, w, states, seed=25)
    ref = {}
    stems = ("teacher_bwd_remat", "teacher_bwd_scan")
    for order in (built, built[::-1]):
        for name, lib, _ in order:
            td._lib = lambda _name, lib=lib: lib
            for B, bargs in cases.items():
                outs, _ = td._bwd_kernel(*bargs)
                got = (outs[0], outs[5])
                ref.setdefault(B, got)
                err = max(c._rel_err(a, b) for a, b in zip(got, ref[B]))
                run = lambda: td._bwd_kernel(*bargs)  # noqa: E731
                ms = c.cuda_time_ms(run, reps=3)
                split, _ = c._device_split_ms(run, stems)
                print(f"{name:16s} B={B:<3d} {ms:.3f} ms (remat {split[stems[0]]:.3f}, scan "
                      f"{split[stems[1]]:.3f}; d {err:.1e})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
