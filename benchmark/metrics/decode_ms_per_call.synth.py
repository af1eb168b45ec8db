"""Device-stream ms of the port's ``synth.decode`` span a traced call: the
prenet dropout masks and the decode (the fused decoder loop, kernel 5)."""

from benchmark import spans


def read(ctx):
    return spans.per_call_ms(ctx, "decode_ms_per_call.synth", "synth.decode", "device")
