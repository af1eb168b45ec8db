"""Kernel 8 (the teacher decoder's backward: the prologue and the scan):
its bound at each traced step's shapes over the two launches' traced
device time, in %; launches held against the port's counters."""

import sys

from benchmark import counts


def read(ctx):
    t = ctx["trace"]
    s, n = t.seconds(lambda name: "teacher_bwd_remat" in name or "teacher_bwd_scan" in name)
    if not n:
        return None
    want = ctx["counters"].get("teacher_bwd", 0) + ctx["counters"].get("teacher_bwd_remat", 0)
    if want != n:
        print(f"roofline.teacher_decoder_bwd: {n} launches traced, the port counted {want}",
              file=sys.stderr)
    bound = sum(counts.teacher_bwd_bound_s(st["B"], st["L"], st["S"], ctx["dims"])
                for st in ctx["steps"])
    return 100.0 * bound / s
