"""Device-to-host copy time per ``synthesize_batch`` call (the waveform and
alignments copied to the host), from the traced calls."""


def read(ctx):
    t, calls = ctx["trace"], len(ctx["calls"])
    s, n = t.seconds(lambda name: name.startswith("Memcpy DtoH"))
    return s * 1e3 / calls if n and calls else None
