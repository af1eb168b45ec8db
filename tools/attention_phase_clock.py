#!/usr/bin/env python3
"""SM cycles of each phase of a launch of kernels 9 and 10 (``csrc/attention_step.cu``).

    python3 tools/attention_phase_clock.py [SPEC.json]

Builds a copy of the kernel with ``clock64()`` read at the end of each
phase (the first keys: when thread 0's first position has landed) by thread
0 of CTA 0 of batch row 0 (``tools/variant_build.py``), which
writes the cycles since its start over the first outputs of that row's
context (the clocked version's context is not checked).  Runs it at the
shapes of ``chip_smoke.py``'s attention phases (kernel 9 at B=32 L=192 and
B=1 L=96 and 192, A=256 D=320 bf16 with the location term; kernel 10 at B=8
L=48 A=256 D=384 f32) at the plan's cluster size, three launches each, and
prints the last launch's cycles a phase.  With SPEC.json (a version name
to ``[[old, new], ...]`` changes of ``csrc/attention_step.cu``, ``[]`` for
the checkout's own) each version is clocked in turn.  Needs a CUDA device.
"""

import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from attention_variants import LIB, SYMBOLS  # noqa: E402
from variant_build import build  # noqa: E402

# the end of the prologue (q, v and the mask loaded, the copies issued)
_ISSUED = "  __syncthreads();\n\n  // 2. energies of this CTA's positions, a warp a position\n"
# the first read of the exchanged (m_k, s_k), after the wait for them
_SLOTS_READ = "  const float mr = lane < int(C) ? slots[2 * lane] : -INFINITY;\n"
# (phase, text the clock read goes after, or before where _clocked says so);
# each text occurs once
MARKS = [
    ("copies issued (thread 0)", _ISSUED),
    ("q, v loaded", _ISSUED),
    ("first keys landed", "      sm90::mbar_wait(bars + chunk_of(j, nl, nch), 0);\n"),
    ("energies", "    if (lane == 0) e[j] = s;\n  }\n  __syncthreads();\n"),
    ("local (m_k, s_k)", "    s = kern::warp_sum(s);\n    if (C > 1) {\n"),
    ("start barrier", "      cluster_wait();                     // every peer has started\n"),
    ("exchange", _SLOTS_READ),
    ("p, slabs waited", "  // 4. the context: this CTA's positions for every column, each column's\n"),
    ("own context rows", "    __syncthreads();\n    for (int d = tid; d < D; d += NT) {\n      float c = 0.f;\n      for (int r = 0; r < R; ++r)"),
    ("context partials sent", "  if (C > 1) {\n    // every partial of this CTA's columns has arrived"),
    ("partials received", "    sm90::mbar_wait(xbars + 1, 0);\n"),
    ("columns summed", "      crow[i] = c;\n    }\n  }\n"),
]


def _clocked(src):
    start = "  const int nch = nl < NCHUNK ? nl : NCHUNK;\n"
    changes = [[start, start + f"  long long TS[{len(MARKS) + 1}] = {{}};\n  TS[0] = clock64();\n"]]
    for i, (_, text) in enumerate(MARKS, 1):
        if src.count(text) != 1:
            raise ValueError(f"mark {i}: {text!r} occurs {src.count(text)} times")
        if i == 1 or text == _SLOTS_READ or text.startswith(("  if (C > 1) {\n    // every partial",
                                      "    __syncthreads();\n    for (int d")):
            changes.append([text, f"  TS[{i}] = clock64();\n" + text])
        elif "chunk_of" in text:                 # the warp's first position only
            changes.append([text, text + f"      if (j == warp) TS[{i}] = clock64();\n"])
        else:
            changes.append([text, text + f"  TS[{i}] = clock64();\n"])
    end = "      crow[i] = c;\n    }\n  }\n"
    n = len(MARKS)
    changes[-1][1] += (f"  __syncthreads();\n  if (k == 0 && tid == 0 && b == 0)\n"
                       f"    for (int i = 1; i <= {n}; ++i) a.ctx[i - 1] = float(TS[i] - TS[0]);\n")
    assert changes[-1][0] == end
    return changes


def main() -> int:
    import torch
    import chip_smoke as c
    from tacotron_multispeaker_torch.ops import attention_step as ast
    from tacotron_multispeaker_torch.ops import cuda_build
    if not torch.cuda.is_available():
        print("attention_phase_clock: no CUDA device", file=sys.stderr)
        return 1
    base = open(cuda_build.CSRC / f"{LIB}.cu").read()
    spec = json.load(open(sys.argv[1])) if len(sys.argv) > 1 else {"checkout": []}
    versions = []
    for name, changes in spec.items():
        src = base
        for old, new in changes:
            if src.count(old) != 1:
                raise ValueError(f"{name}: {old!r} occurs {src.count(old)} times")
            src = src.replace(old, new)
        for old, new in _clocked(src):
            src = src.replace(old, new)
        with tempfile.NamedTemporaryFile("w", suffix=".cu", delete=False) as f:
            f.write(src)
        versions.append(build(name, {f"{LIB}.cu": f.name}, LIB, SYMBOLS)[:2])
    cases = [("kernel 9 B=32 L=192", ast.attention_step,
              c._attention_case(32, 192, 256, 320, torch.bfloat16, seed=33)),
             ("kernel 9 B=1 L=96", ast.attention_step,
              c._attention_case(1, 96, 256, 320, torch.bfloat16, seed=34)),
             ("kernel 9 B=1 L=192", ast.attention_step,
              c._attention_case(1, 192, 256, 320, torch.bfloat16, seed=35)),
             ("kernel 10 B=8 L=48", ast.attention_step_partial,
              c._partial_case(8, 48, 256, 384, torch.float32, seed=42))]
    for version, lib in versions:
        ast._lib = lambda lib=lib: lib
        ast._cluster_counts.clear()
        ast._plans.clear()
        for label, fn, args in cases:
            for _ in range(3):
                out = fn(*args)
            torch.cuda.synchronize()
            C, route, _ = ast.last_plan
            cyc = [int(x) for x in out[0][0, :len(MARKS)].tolist()]
            steps = [b - a for a, b in zip([0] + cyc, cyc)]
            print(f"{version}: {label} C={C} ({route}): {cyc[-1]} cycles; "
                  + ", ".join(f"{name} {n}" for (name, _), n in zip(MARKS, steps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
