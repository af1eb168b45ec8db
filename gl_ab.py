#!/usr/bin/env python3
"""Time the fused Griffin-Lim call (kernel 13) of one checkout of the port.

    python3 gl_ab.py DIR [build]

Runs the port of the checkout in DIR (any commit of it: only its
``ops.gl_iteration.gl_fast_iterations`` is called) at B=32 and B=1
(F=1000, n_fft 2048, hop 275, 12 bf16 iterations, the serving window, the
inputs of this checkout's ``chip_smoke.py phase_gl_iteration``) and prints
one line: the call's time (CUDA events) and the device time of each of its
three kernels (profiler).  ``build`` builds every kernel library first.  To compare two
versions on one card, run it in turns in one command: parent, change,
change, parent.  Needs a CUDA device.
"""

import os
import sys


def main() -> int:
    import torch
    import chip_smoke as c          # this checkout's; it imports the port lazily
    root = os.path.abspath(sys.argv[1])
    os.chdir(root)
    sys.path.insert(0, root)
    from tacotron_multispeaker_torch.ops import gl_iteration as gl
    if not torch.cuda.is_available():
        print("gl_ab: no CUDA device", file=sys.stderr)
        return 1
    if len(sys.argv) > 2:
        c.phase_build()
    times = []
    for B, reps in ((32, 5), (1, 10)):
        wf0, mag, win = c._gl_case(B, 1000, seed=51 if B > 1 else 52)
        w0 = wf0.to(torch.bfloat16)
        run = lambda: gl.gl_fast_iterations(w0, mag, win, 275, 12, 0.99 / 1.99)  # noqa: E731
        ms = c.cuda_time_ms(run, reps=reps)
        split, _ = c._device_split_ms(run, c.GL_KERNELS)
        times.append(f"B={B} {ms:.3f} ms " + str({k: round(v, 3) for k, v in split.items()}))
    print(f"AB {sys.argv[1]}: " + " ".join(times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
