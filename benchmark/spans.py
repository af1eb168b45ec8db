"""The port's own synthesis spans (``tacotron_multispeaker_torch.tracing``)
read as per-call stage times.  The spans are recorded only while a profiler
runs, so the records present after a ``--trace 1`` window are those of the
traced calls.  A port without the tracing module, or without spans, gives
None."""

import sys


def per_call_ms(ctx, metric: str, stage: str, clock: str):
    """Mean ms of ``stage`` a traced ``synth.call``: its host time
    (``clock="host"``) or its device stream's time (``"device"``, None off
    a CUDA device).  The ``synth.call`` roots, with their ``rows`` and
    ``bucket``, are held against the traced calls of ``ctx["calls"]``; a
    mismatch is printed on stderr."""
    try:
        from tacotron_multispeaker_torch import tracing
    except ImportError:
        return None
    records = tracing.spans()
    roots = [r for r in records if r.name == "synth.call" and r.parent is None]
    if not roots:
        return None
    seen = [(r.attrs.get("rows"), r.attrs.get("bucket")) for r in roots]
    traced = [(len(lengths), bucket) for bucket, lengths in ctx["calls"]]
    if seen != traced:
        print(f"{metric}: {len(roots)} synth.call spans (rows, bucket) {seen[:4]}..., "
              f"the window traced {len(traced)} calls {traced[:4]}...", file=sys.stderr)
    ids = {r.id for r in roots}
    ms = [r.host_ms if clock == "host" else r.device_ms
          for r in records if r.name == stage and r.root in ids]
    if not ms or None in ms:
        return None
    return sum(ms) / len(roots)
