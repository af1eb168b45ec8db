#!/usr/bin/env python3
"""Sweep the cluster size of kernels 9 and 10 (``csrc/attention_step.cu``) over short rows.

    python3 tools/attention_plan_sweep.py [OUT.json]

For kernel 9 (A=256 D=320 bf16, location term) and kernel 10 (A=256
D=384 f32) at B in 1, 3, 8, 32 and L in 8, 13, 16, 24, 32, 40, 48, times
the launch's device time (profiler, as ``chip_smoke.py``'s attention
phases do) at every cluster size C the card takes, and prints each shape's
times, the fastest C and the C that ``ops.cluster_plan.attention_plan``
picks, with the loss of the plan's C against the fastest.  The table
(also written to OUT.json when given) is what the plan's rule for short
rows rests on.  Needs a CUDA device.
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

BATCHES = (1, 3, 8, 32)
LENGTHS = (8, 13, 16, 24, 32, 40, 48)


def main() -> int:
    import torch
    import chip_smoke as c
    from tacotron_multispeaker_torch.ops import attention_step as ast
    if not torch.cuda.is_available():
        print("attention_plan_sweep: no CUDA device", file=sys.stderr)
        return 1
    rows = []
    for name, fn, partial in (("k9", ast.attention_step, False),
                              ("k10", ast.attention_step_partial, True)):
        for B in BATCHES:
            for L in LENGTHS:
                if partial:
                    args = c._partial_case(B, L, 256, 384, torch.float32, seed=B + L,
                                           ended=(1,) if B > 1 else ())
                else:
                    args = c._attention_case(B, L, 256, 320, torch.bfloat16, seed=B + L)
                fn(*args)
                plan = ast.last_plan[0]
                times = {}
                for C in c._attention_sizes(c._attention_counts(args, partial), L)[1:]:
                    times[C] = c._launch_device_ms(lambda C=C: fn(*args, cluster=C),
                                                   "attention_step", reps=20)
                best = min(times, key=times.get)
                rows.append({"kernel": name, "B": B, "L": L, "plan": plan, "best": best,
                             "ms": {str(C): round(t, 5) for C, t in times.items()}})
                print(f"{name:3s} B={B:<2d} L={L:<2d} plan C={plan:<2d} "
                      f"({times[plan]:.4f} ms) fastest C={best:<2d} ({times[best]:.4f} ms, "
                      f"plan {100 * (times[plan] / times[best] - 1):+.1f} %) | "
                      + " ".join(f"C={C}: {t:.4f}" for C, t in times.items()), flush=True)
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
