"""Device-stream ms of the port's ``synth.griffin_lim`` span a traced call:
the spectrogram back to amplitudes, Griffin-Lim (the fast iterations and the
float32 polish iterations) and the inverse pre-emphasis."""

from benchmark import spans


def read(ctx):
    return spans.per_call_ms(ctx, "griffin_lim_ms_per_call.synth", "synth.griffin_lim", "device")
