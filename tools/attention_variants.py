#!/usr/bin/env python3
"""Time versions of kernels 9 and 10 (``csrc/attention_step.cu``) in turns, in one process.

    python3 tools/attention_variants.py SPEC.json [C ...]

SPEC.json maps a version name to its changes to copies of ``csrc/`` (the
format of ``tools/variant_build.py``; ``{}`` is the checkout's own source).
Every version is built with the port's nvcc flags, then each is timed at
the shapes of ``chip_smoke.py``'s attention phases: kernel 9 at B=32
L=192 and B=1 L=96 (A=256 D=320 bf16, location term) and kernel 10 at B=8
L=48 (A=256 D=384 f32), at the plan's cluster size and at each C given,
by the launch's device time (profiler), in the order given and then in
reverse.  ``d`` is the largest difference of the outputs from the first
version's.  Needs a CUDA device.
"""

import concurrent.futures
import ctypes
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
LIB = "attention_step"

from variant_build import build  # noqa: E402

p = ctypes.c_void_p
SYMBOLS = {"attention_step_launch": ([p, p, p], ctypes.c_int),
           "attention_step_max_clusters": ([p, p], ctypes.c_int),
           "attention_step_smem_bytes": ([p], ctypes.c_longlong)}


def main() -> int:
    import torch
    import chip_smoke as c
    from tacotron_multispeaker_torch.ops import attention_step as ast
    if not torch.cuda.is_available():
        print("attention_variants: no CUDA device", file=sys.stderr)
        return 1
    spec = json.load(open(sys.argv[1]))
    sizes = [None] + [int(x) for x in sys.argv[2:]]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        built = list(pool.map(lambda kv: build(*kv, LIB, SYMBOLS), spec.items()))
    for name, _, regs in built:
        print(f"{name}: {regs}")
    cases = {"k9 B=32 L=192": (ast.attention_step,
                               c._attention_case(32, 192, 256, 320, torch.bfloat16, seed=33)),
             "k9 B=1 L=96": (ast.attention_step,
                             c._attention_case(1, 96, 256, 320, torch.bfloat16, seed=34)),
             "k10 B=8 L=48": (ast.attention_step_partial,
                              c._partial_case(8, 48, 256, 384, torch.float32, seed=42))}
    ref = {}
    for order in (built, built[::-1]):
        for name, lib, _ in order:
            ast._lib = lambda lib=lib: lib
            ast._cluster_counts.clear()
            ast._plans.clear()
            for label, (fn, args) in cases.items():
                for C in sizes:
                    run = lambda: fn(*args, cluster=C)  # noqa: E731
                    out = run()
                    torch.cuda.synchronize()
                    ref.setdefault(label, out)
                    err = max((a - b).abs().max().item() for a, b in zip(out, ref[label]))
                    dev = c._launch_device_ms(run, "attention_step", reps=20)
                    print(f"{name:14s} {label:14s} C={ast.last_plan[0]:<2d} device {dev:.4f} ms "
                          f"(d {err:.1e})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
