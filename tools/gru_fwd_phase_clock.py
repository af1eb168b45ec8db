#!/usr/bin/env python3
"""SM cycles of each phase of a step of kernel 3's tensor-core route (``csrc/bigru_scan.cu``).

    python3 tools/gru_fwd_phase_clock.py [B ...]

Builds a copy of ``csrc/bigru_scan.cu`` whose tensor-core kernel reads
``clock64()`` at the phase boundaries of every step in thread 0 of block
(0, 0) (lane 0 of warp 0: column tile 0, batch rows 0 and 1), sums each
phase's cycles over the steps and writes the sums as floats over the first
elements of ``ys`` (so that copy's outputs are not the scan's).  Runs it at
T=1000 F=128 bf16, two directions, for each B given (32 and 1 without any)
on ``chip_smoke.py``'s inputs and prints each phase's cycles a step:
``pre`` the start of the copies of the step two ahead, ``P1`` phase 1 (the
round(h) fragments, the r and u products, the sigmoids and round(r*h)),
``bar1`` the barrier after it, ``P2`` phase 2 (the round(r*h) fragments,
the candidate's product, tanh, the new state and its stores), ``cpwait``
the wait for the next step's copies, ``bar2`` the barrier.  Needs a CUDA
device.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from gru_fwd_variants import LIB, SYMBOLS  # noqa: E402
from variant_build import build  # noqa: E402

TICK = "c1 = clock64(); ck[{i}] += c1 - c0; c0 = c1;\n"
CHANGES = {f"{LIB}.cu": [
    ["  uint32_t bf[NK][2], bfr[NK][2];\n",
     "  uint32_t bf[NK][2], bfr[NK][2];\n  long long ck[6] = {0, 0, 0, 0, 0, 0}, c0 = 0, c1;\n"],
    ["    const bf16* sxg = ring + s * SLOT;\n",
     "    c0 = clock64();\n    const bf16* sxg = ring + s * SLOT;\n"],
    ["    // ---- phase 1: r = sigmoid",
     "    " + TICK.format(i=0) + "    // ---- phase 1: r = sigmoid"],
    ["rhs[o_b[v]] = from_f<bf16>(gr[v] * h[v]);\n    __syncthreads();\n",
     "rhs[o_b[v]] = from_f<bf16>(gr[v] * h[v]);\n    "
     + TICK.format(i=1) + "    __syncthreads();\n    " + TICK.format(i=2)],
    ["    cp_async_wait<1>();\n    __syncthreads();\n  }\n}\n",
     "    " + TICK.format(i=3) + "    cp_async_wait<1>();\n    " + TICK.format(i=4)
     + "    __syncthreads();\n    " + TICK.format(i=5) + "  }\n"
     "  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {\n"
     "#pragma unroll\n    for (int i = 0; i < 6; ++i) reinterpret_cast<float*>(ys)[i] = "
     "float(ck[i]);\n  }\n}\n"]]}
PHASES = ("pre", "P1", "bar1", "P2", "cpwait", "bar2")


def main() -> int:
    import torch
    import chip_smoke as c
    from tacotron_multispeaker_torch.ops import gru_scan as gs
    if not torch.cuda.is_available():
        print("gru_fwd_phase_clock: no CUDA device", file=sys.stderr)
        return 1
    _, lib, regs = build("clock", CHANGES, LIB, SYMBOLS)
    print(f"clock build: {regs}")
    gs._lib = lambda: lib
    T = 1000
    for B in [int(b) for b in sys.argv[1:]] or [32, 1]:
        args = c._bigru_inputs(T, B, 128, torch.bfloat16, seed=7)
        gs._fwd_kernel(*args, route="mma")
        ys = gs._fwd_kernel(*args, route="mma")
        torch.cuda.synchronize()
        ck = [v / T for v in ys.flatten()[:2 * len(PHASES)].view(torch.float32).tolist()]
        print(f"T={T} B={B} F=128 bf16, SM cycles a step (block (0, 0), thread 0): "
              + " ".join(f"{n} {v:.0f}" for n, v in zip(PHASES, ck))
              + f"; total {sum(ck):.0f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
