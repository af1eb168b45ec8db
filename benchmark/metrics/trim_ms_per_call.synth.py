"""Host ms of the port's ``synth.trim`` span a traced call: the endpoint
search over each row of the waveform copied to the host (the device idles
through it)."""

from benchmark import spans


def read(ctx):
    return spans.per_call_ms(ctx, "trim_ms_per_call.synth", "synth.trim", "host")
