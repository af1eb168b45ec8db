#!/usr/bin/env python3
"""Time versions of the weight-gradient reduction (``csrc/wgrad.cu``) in turns, in one process.

    python3 tools/wgrad_variants.py SPEC.json [SPLITS ...]

SPEC.json maps a version name to its changes to copies of ``csrc/`` (the
format of ``tools/variant_build.py``; ``{}`` is the checkout's own source).
Every version is built with the port's nvcc flags, then each is timed on
its tensor-core route at the main path's three bf16 launches
(``chip_smoke._wgrad_problems``: the teacher backward's 11 products over
6400 rows, the BiGRU's 4 and the GRU's 2 over 32000), by the device time
of a call's kernels (profiler: the tile kernel + the partials' pass) and
a call's time back to back (CUDA events), in the order given and then in
reverse; with SPLITS, at each of those row-range counts as well as the
wrapper's own.  ``d`` is the largest difference of the outputs from the
first version's, relative to each output's peak.  Needs a CUDA device.
"""

import concurrent.futures
import ctypes
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
LIB = "wgrad"

from variant_build import build  # noqa: E402

p, i = ctypes.c_void_p, ctypes.c_int
SYMBOLS = {"wgrad_launch": ([p, i, i, p, i, p], i),
           "wgrad_tc_launch": ([p, i, i, p, p], i),
           "wgrad_tc_smem_bytes": ([], ctypes.c_longlong),
           "wgrad_tc_blocks_per_sm": ([], i)}


def main() -> int:
    import torch
    import chip_smoke as c
    from tacotron_multispeaker_torch.ops import wgrad as wg
    if not torch.cuda.is_available():
        print("wgrad_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = json.load(open(sys.argv[1]))
    sweep = [None] + [int(a) for a in sys.argv[2:]]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        built = list(pool.map(lambda kv: build(*kv, LIB, SYMBOLS), spec.items()))
    for name, lib, regs in built:
        print(f"{name}: {sorted(set(regs))}; blocks an SM {lib.wgrad_tc_blocks_per_sm()}")
    cases = {kind: c._wgrad_problems(kind, seed=71 + n)
             for n, kind in enumerate(("teacher", "bigru", "gru"))}
    ref = {}
    for order in (built, built[::-1]):
        for name, lib, _ in order:
            wg._lib = lambda lib=lib: lib
            for kind, probs in cases.items():
                assert wg.route(probs, torch.bfloat16) == "mma", kind
                for s in sweep:
                    run = lambda: wg.wgrad(probs, torch.bfloat16, splits=s)  # noqa: E731
                    out = run()
                    torch.cuda.synchronize()
                    base = ref.setdefault(kind, out)
                    d = max(c._rel_err(x, y) for (x, _), (y, _) in zip(out, base))
                    used = s or wg.plan(probs, torch.bfloat16, wg._sm_count(0)).splits
                    stems = ("wgrad_tc",) + (("wgrad_reduce",) if used > 1 else ())
                    split, _ = c._device_split_ms(run, stems, reps=3,
                                                  per_call=dict.fromkeys(stems, 1))
                    call = c.cuda_time_ms(run, reps=10)
                    print(f"{name:14s} {kind:8s} S={used:<3d} device "
                          f"{sum(split.values()):.4f} ms ("
                          + " + ".join(f"{v:.4f}" for v in split.values())
                          + f"), call {call:.4f} ms (d {d:.1e})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
