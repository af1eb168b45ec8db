"""Model FLOPs of the traced synthesis calls (encoder, decoder, post-net at
the true text lengths, Griffin-Lim at the FFT count) over the traced
window and the card's bf16 peak, in %."""

from benchmark import counts


def read(ctx):
    t = ctx["trace"]
    flops = sum(counts.synth_flops(ctx["dims"], lengths, ctx["steps"])
                for _, lengths in ctx["calls"])
    return 100.0 * flops / (t.window_s * counts.BF16_FLOPS) if flops and t.window_s else None
