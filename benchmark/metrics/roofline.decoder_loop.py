"""Kernel 5 (the fused decoder loop): its bound at each traced call's
shapes over its traced device time, in %.  Its traced launches are held
against the port's launch counter."""

import sys

from benchmark import counts


def read(ctx):
    t = ctx["trace"]
    s, n = t.seconds(lambda name: "decoder_loop_kernel" in name)
    if not n:
        return None
    want = ctx["counters"].get("decoder_loop")
    if want != n:
        print(f"roofline.decoder_loop: {n} launches traced, the port counted {want}",
              file=sys.stderr)
    bound = sum(counts.decoder_loop_bound_s(len(lengths), bucket, ctx["steps"], ctx["dims"])
                for bucket, lengths in ctx["calls"])
    return 100.0 * bound / s
