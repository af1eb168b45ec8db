#!/usr/bin/env python3
"""SM cycles of each phase of a step of kernel 4's scan (``csrc/bigru_scan_bwd.cu``).

    python3 tools/gru_bwd_phase_clock.py [T ...]

Builds a copy of ``csrc/bigru_scan_bwd.cu`` whose scan reads ``clock64()``
at the phase boundaries of every step in thread 0 of block (0, 0) (a lane
that owns element 0 of the per-step vectors and sums phase-1 row 0), sums
each phase's cycles over the steps and writes the sums over the first
outputs of ``dxc`` (so that copy's outputs are not the backward's).  Runs
it at B=32 F=128 bf16, two directions, at each T given (T=1000 without one)
on ``chip_smoke.py``'s inputs and prints each phase's cycles a step:
``E`` the elementwise part (dac, dgu), ``bar1`` the barrier after it,
``P1`` the start of the step two ahead's copies and this thread's share of
phase 1's dot products, ``P1tail`` their shuffle and dgr, ``cpwait`` the
wait for the next step's copies, ``bar2`` the barrier, ``P2`` phase 2 and
the new dh.  Needs a CUDA device.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from gru_bwd_variants import LIB, SYMBOLS  # noqa: E402
from variant_build import build  # noqa: E402

TICK = "c1 = clock64(); ck[{i}] += c1 - c0; c0 = c1;\n"
CHANGES = {f"{LIB}.cu": [
    ["  float dh = 0.f;\n",
     "  float dh = 0.f;\n  long long ck[7] = {0, 0, 0, 0, 0, 0, 0}, c0 = 0, c1;\n"],
    ["    const float* sb = ring + (t % SC_RING) * SF;\n",
     "    c0 = clock64();\n    const float* sb = ring + (t % SC_RING) * SF;\n"],
    ["      dhs[j] = dht;\n    }\n    __syncthreads();\n",
     "      dhs[j] = dht;\n    }\n    " + TICK.format(i=0) + "    __syncthreads();\n    "
     + TICK.format(i=1)],
    ["    s1 += __shfl_xor_sync(0xffffffffu, s1, 16);\n",
     "    " + TICK.format(i=2) + "    s1 += __shfl_xor_sync(0xffffffffu, s1, 16);\n"],
    ["    cp_async_wait<1>();\n    __syncthreads();\n",
     "    " + TICK.format(i=3) + "    cp_async_wait<1>();\n    " + TICK.format(i=4)
     + "    __syncthreads();\n    " + TICK.format(i=5)],
    ["    if (own) dh = pt[k2] + su[k2] + s2;\n  }\n",
     "    if (own) dh = pt[k2] + su[k2] + s2;\n    " + TICK.format(i=6) + "  }\n"
     "  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) {\n"
     "#pragma unroll\n    for (int i = 0; i < 7; ++i) dxc[i] = float(ck[i]);\n  }\n"]]}
PHASES = ("E", "bar1", "P1", "P1tail", "cpwait", "bar2", "P2")


def main() -> int:
    import torch
    import chip_smoke as c
    from tacotron_multispeaker_torch.ops import gru_scan as gs
    if not torch.cuda.is_available():
        print("gru_bwd_phase_clock: no CUDA device", file=sys.stderr)
        return 1
    _, lib, regs = build("clock", CHANGES, LIB, SYMBOLS)
    gs._bwd_lib = lambda: lib
    for T in [int(t) for t in sys.argv[1:]] or [1000]:
        args = c._gru_bwd_case(2, T, 32, 128, torch.bfloat16, seed=11)
        gs._bwd_kernel(*args)
        dxc = gs._bwd_kernel(*args)[1]
        torch.cuda.synchronize()
        ck = [v / T for v in dxc.flatten()[:len(PHASES)].tolist()]
        print(f"T={T} B=32 F=128 bf16, SM cycles a step (block (0, 0), thread 0): "
              + " ".join(f"{n} {v:.0f}" for n, v in zip(PHASES, ck))
              + f"; total {sum(ck):.0f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
