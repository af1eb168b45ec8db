"""How long a synthesis cell's card waits with no profiler running, from the
port's spans on their CUDA events alone (``tracing.record()``):

    python3 -m benchmark.tools.untraced_idle --workload <cell> --seed S [--calls 40]

After the cell's set-up, ``--calls`` calls of its traffic with nothing on
(the call's host ms), then as many with the spans recording events.  Of the
second set: each stage's device-stream ms (the time between its two events
on the stream) and ``idle_at_least``, 1 − the summed stream ms of the call's
device stages over the calls' wall time, first call's start to the last
call's end.  A stage's stream ms counts any idle inside it as busy (a
host-paced stage reads its pacing), so that share is a lower bound on the
card's idle.  ``synth.prepare`` is host work before the call's device work
and is not counted.  One JSON line."""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

STAGES = ("synth.encoder", "synth.decode", "synth.stop", "synth.postnet", "synth.griffin_lim",
          "synth.trim", "synth.copy")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--calls", type=int, default=40)
    a = p.parse_args(argv)
    import importlib

    import torch
    from benchmark import core
    from tacotron_multispeaker_torch import tracing
    cell = core.load_cell(a.workload)
    core.require_devices(cell.chips)
    core.set_cache_dirs()
    driver = importlib.import_module(f"benchmark.drivers.{cell.traffic['driver']}")
    d = driver.Driver(cell, a.seed)
    d.setup()

    def run(n):
        times = []
        t0 = time.perf_counter()
        for _ in range(n):
            call = next(d.calls)
            t = time.perf_counter()
            d.synth.synthesize_batch(call.texts, call.speaker_ids, seed=call.seed,
                                     pad_to=call.bucket)
            times.append(time.perf_counter() - t)
        return times, time.perf_counter() - t0

    bare, bare_s = run(a.calls)
    tracing.clear()
    with tracing.record():
        rec, rec_s = run(a.calls)
    recs = tracing.spans()
    tracing.clear()
    roots = {r.id for r in recs if r.name == "synth.call"}
    by_stage = {name: [r.device_ms for r in recs if r.name == name and r.parent in roots]
                for name in STAGES}
    busy_ms = sum(sum(v) for v in by_stage.values())
    d.release()
    print(json.dumps({
        "workload": a.workload, "seed": a.seed, "calls": a.calls,
        "device": torch.cuda.get_device_name(0),
        "call_ms_median": statistics.median(bare) * 1e3,
        "window_s": bare_s,
        "recorded_call_ms_median": statistics.median(rec) * 1e3,
        "recorded_window_s": rec_s,
        "stage_stream_ms_median": {k: statistics.median(v) for k, v in by_stage.items() if v},
        "idle_at_least": 1.0 - busy_ms / (rec_s * 1e3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
