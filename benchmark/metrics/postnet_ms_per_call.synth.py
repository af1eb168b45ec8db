"""Device-stream ms of the port's ``synth.postnet`` span a traced call: the
post-net CBHG and the linear projection."""

from benchmark import spans


def read(ctx):
    return spans.per_call_ms(ctx, "postnet_ms_per_call.synth", "synth.postnet", "device")
