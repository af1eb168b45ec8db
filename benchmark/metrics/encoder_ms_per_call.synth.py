"""Device-stream ms of the port's ``synth.encoder`` span a traced call: the
speaker lookup, the encoder and the attention keys."""

from benchmark import spans


def read(ctx):
    return spans.per_call_ms(ctx, "encoder_ms_per_call.synth", "synth.encoder", "device")
