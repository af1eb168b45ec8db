"""Kernel 13 (the fused fast Griffin-Lim iterations: forward, inverse and
overlap-add kernels): its bound over the window's nonzero samples at each
traced call's shapes over their traced device time, in %.  Its traced
launches are held against the port's wrapper counter (one forward a fast
iteration, one inverse and one overlap-add for each but the last)."""

import sys

from benchmark import counts


def read(ctx):
    t = ctx["trace"]
    s, n = t.seconds(lambda name: "gl_fwd_" in name or "gl_inv_" in name or "gl_ola_" in name)
    if not n:
        return None
    k = ctx["gl_fast_iters"]
    want = ctx["counters"].get("gl_iteration", 0) * (3 * k - 2)
    if want != n:
        print(f"roofline.gl_iteration: {n} launches traced, the port's counter gives {want}",
              file=sys.stderr)
    frames = ctx["steps"] * ctx["dims"]["model"]["outputs_per_step"]
    bound = sum(counts.gl_iteration_bound_s(len(lengths), frames, ctx["dims"], k)
                for _, lengths in ctx["calls"])
    return 100.0 * bound / s
