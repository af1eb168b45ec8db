#!/usr/bin/env python3
"""Time versions of kernel 12 (``csrc/overlap_add.cu``) in turns, in one process.

    python3 tools/ola_variants.py SPEC.json

SPEC.json maps a version name to its changes to copies of ``csrc/`` (the
format of ``tools/variant_build.py``; ``{}`` is the checkout's own source).
Every version is built with the port's nvcc flags, then each is timed at
the shapes of ``chip_smoke.py``'s ``phase_overlap_add`` (F=1000, hop 275,
f32): prewindowed 1102-sample support frames and windowed 2048-sample
frames, each at B=32 and B=1, by a launch's device time (profiler) and,
at B=1, a call's time back to back (CUDA events), in the order given and
then in reverse.  ``d`` is the largest difference of the output from the
first version's.  Needs a CUDA device.
"""

import concurrent.futures
import ctypes
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
LIB = "overlap_add"

from variant_build import build  # noqa: E402

p = ctypes.c_void_p
SYMBOLS = {"overlap_add_launch": ([p] * 3 + [ctypes.c_int] * 6 + [p], ctypes.c_int)}


def main() -> int:
    import torch
    import chip_smoke as c
    from tacotron_multispeaker_torch.ops import overlap_add as ola
    if not torch.cuda.is_available():
        print("ola_variants: no CUDA device", file=sys.stderr)
        return 1
    spec = json.load(open(sys.argv[1]))
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        built = list(pool.map(lambda kv: build(*kv, LIB, SYMBOLS), spec.items()))
    for name, _, regs in built:
        print(f"{name}: {sorted(set(regs))}")
    cases = {}
    for mode, (Wn, pre) in c.OLA_MODES.items():
        for B in (32, 1):
            cases[f"{mode} B={B}"] = (c._ola_case(B, 1000, Wn, pre, torch.float32, seed=43 + B),
                                      pre)
    ref = {}
    for order in (built, built[::-1]):
        for name, lib, _ in order:
            ola._launch = lib.overlap_add_launch
            for label, ((frames, win), pre) in cases.items():
                run = lambda: ola.overlap_add(frames, win, 275, prewindowed=pre)  # noqa: E731
                out = run()
                torch.cuda.synchronize()
                err = (out - ref.setdefault(label, out)).abs().max().item()
                dev = c._launch_device_ms(run, "overlap_add", reps=20 if "B=1" in label else 5)
                call = c.cuda_time_ms(run, reps=50) if "B=1" in label else float("nan")
                print(f"{name:14s} {label:12s} device {dev:.4f} ms, call {call:.4f} ms "
                      f"(d {err:.1e})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
