"""Host ms of the port's ``synth.prepare`` span a traced call: the texts made
into padded id arrays and copied to the device with the lengths and speakers."""

from benchmark import spans


def read(ctx):
    return spans.per_call_ms(ctx, "prepare_ms_per_call.synth", "synth.prepare", "host")
