"""Share of the traced training window in which no operation ran on the
device, in %."""


def read(ctx):
    t = ctx["trace"]
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.busy_s > 0 else None
