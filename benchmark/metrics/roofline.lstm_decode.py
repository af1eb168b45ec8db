"""Tacotron 2's decode (the LSTM step loop, replayed as CUDA graphs): its
bound (counts/tacotron2.py, the weights once a call) at each traced call's
shapes over the device-stream ms of the port's ``synth.decode`` spans, in %.
The ``steps`` each span notes are held against the cell's; a mismatch is
printed on stderr.  A port without the spans gives None."""

import sys

from benchmark.counts import tacotron2


def read(ctx):
    try:
        from tacotron_multispeaker_torch import tracing
    except ImportError:
        return None
    records = tracing.spans()
    roots = {r.id for r in records if r.name == "synth.call" and r.parent is None}
    decodes = [r for r in records if r.name == "synth.decode" and r.root in roots]
    if not decodes or any(r.device_ms is None for r in decodes):
        return None
    steps = [r.attrs.get("steps") for r in decodes]
    if any(s != ctx["steps"] for s in steps):
        print(f"roofline.lstm_decode: spans noted steps {sorted(set(map(str, steps)))}, "
              f"the cell decodes {ctx['steps']}", file=sys.stderr)
    bound = sum(tacotron2.lstm_decode_bound_s(len(lengths), bucket, ctx["steps"], ctx["dims"])
                for bucket, lengths in ctx["calls"])
    return 100.0 * bound * 1e3 / sum(r.device_ms for r in decodes)
