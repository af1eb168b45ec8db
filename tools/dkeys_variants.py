#!/usr/bin/env python3
"""Time versions of kernel 7 (``csrc/dkeys.cu``) in turns, in one process.

    python3 tools/dkeys_variants.py SPEC.json

SPEC.json maps a version name to its changes to copies of ``csrc/`` (the
format of ``tools/variant_build.py``; ``{}`` is the checkout's own source).
Every version is built with the port's nvcc flags, then each is timed at
the train step's shape (S=200 B=32 L=192 A=256, bf16 keys and v, the
inputs of ``gl_ab.py --mode wgrad``) by the device time of a call's two
kernels (profiler) and a call's time back to back (CUDA events), in the
order given and then in reverse.  ``err`` is the largest difference of
dkeys and dv from ``dkeys_reference``, relative to each one's peak, on
those inputs and on keys and q uniform in [-40, 40] (the guarded
elements).  Needs a CUDA device.
"""

import concurrent.futures
import ctypes
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from variant_build import build  # noqa: E402

p, i = ctypes.c_void_p, ctypes.c_int
SYMBOLS = {"dkeys_launch": ([p] * 7 + [i] * 5 + [p], i), "dkeys_l_blocks": ([i], i)}


def main() -> int:
    import torch
    import chip_smoke as c
    from tacotron_multispeaker_torch.ops import teacher_decoder as td
    if not torch.cuda.is_available():
        print("dkeys_variants: no CUDA device", file=sys.stderr)
        return 1
    spec = json.load(open(sys.argv[1]))
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        built = list(pool.map(lambda kv: build(*kv, "dkeys", SYMBOLS), spec.items()))
    for name, _, regs in built:
        print(f"{name}: {sorted(set(regs))}")
    B, L, A, S = 32, 192, 256, 200
    g = torch.Generator(device="cuda").manual_seed(23)
    bf = torch.bfloat16
    u = lambda *sh: (torch.rand(*sh, generator=g, device="cuda") * 2 - 1) * 40  # noqa: E731
    cases = {"normal": ((torch.randn(B, L, A, generator=g, device="cuda") * 0.3).to(bf),
                        torch.randn(S, B, A, generator=g, device="cuda")),
             "guard": (u(B, L, A).to(bf), u(S, B, A))}
    de = torch.randn(S, B, L, generator=g, device="cuda") * 1e-2
    v = (torch.randn(A, generator=g, device="cuda") * 0.2).to(bf)
    refs = {k: td.dkeys_reference(keys, q, de, v) for k, (keys, q) in cases.items()}
    lib0 = td._lib
    for order in (built, built[::-1]):
        for name, lib, _ in order:
            td._lib = lambda n, lib=lib: lib if n == "dkeys" else lib0(n)
            errs = []
            for kind, (keys, q) in cases.items():
                dk, dv = td.dkeys(keys, q, de, v)
                torch.cuda.synchronize()
                errs.append(max(c._rel_err(dk, refs[kind][0]), c._rel_err(dv, refs[kind][1])))
            keys, q = cases["normal"]
            run = lambda: td.dkeys(keys, q, de, v)  # noqa: E731
            split, _ = c._device_split_ms(run, ("dkeys", "dv_reduce"), reps=3,
                                          per_call={"dkeys": 1, "dv_reduce": 1})
            call = c.cuda_time_ms(run, reps=10)
            print(f"{name:14s} device {sum(split.values()):.4f} ms ({split['dkeys']:.4f} + "
                  f"{split['dv_reduce']:.4f}), call {call:.4f} ms (err normal {errs[0]:.1e}, "
                  f"guard {errs[1]:.1e})", flush=True)
    td._lib = lib0
    return 0


if __name__ == "__main__":
    sys.exit(main())
