"""Kernel 6 (the teacher-forced decoder scan): its bound at each traced
step's shapes over its traced device time, in %; launches held against the
port's counter."""

import sys

from benchmark import counts


def read(ctx):
    t = ctx["trace"]
    s, n = t.seconds(lambda name: "teacher_fwd_kernel" in name)
    if not n:
        return None
    want = ctx["counters"].get("teacher_fwd")
    if want != n:
        print(f"roofline.teacher_decoder_fwd: {n} launches traced, the port counted {want}",
              file=sys.stderr)
    bound = sum(counts.teacher_fwd_bound_s(st["B"], st["L"], st["S"], ctx["dims"])
                for st in ctx["steps"])
    return 100.0 * bound / s
