"""Forward and backward model FLOPs of the traced steps' true lengths over
the traced window and the card's bf16 peak, in %."""

from benchmark import counts


def read(ctx):
    t = ctx["trace"]
    flops = sum(counts.train_flops(ctx["dims"], st["text_lengths"], st["frame_lengths"])
                for st in ctx["steps"])
    return 100.0 * flops / (t.window_s * counts.BF16_FLOPS) if flops and t.window_s else None
