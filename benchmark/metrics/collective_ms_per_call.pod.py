"""Device-stream ms of the port's ``synth.gather`` span a traced call of pod
synthesis on rank 0: the all-gathers of every rank's waveforms, alignments
and mel into the global result."""

from benchmark import spans


def read(ctx):
    return spans.per_call_ms(ctx, "collective_ms_per_call.pod", "synth.gather", "device")
