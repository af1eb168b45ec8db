"""Model FLOPs of the traced Tacotron 2 synthesis calls (encoder at the true
text lengths, the decode's 1,000 steps of products, the post-net, the mel
basis's pseudo-inverse, Griffin-Lim at the FFT count; counts/tacotron2.py)
over the traced window and the card's bf16 peak, in %."""

from benchmark import counts
from benchmark.counts import tacotron2


def read(ctx):
    t = ctx["trace"]
    flops = sum(tacotron2.synth_flops(ctx["dims"], lengths, ctx["steps"])
                for _, lengths in ctx["calls"])
    return 100.0 * flops / (t.window_s * counts.BF16_FLOPS) if flops and t.window_s else None
