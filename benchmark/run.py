"""Run one cell of ``BENCHMARK.json`` and print its result line:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the CUDA context, the weights drawn on the device from the
seed, the kernel libraries loaded from the port's build directory, the warm-up
of the cell's shapes) is timed from the process's start to the first timed
call.  The window then runs for ``--seconds``.  With ``--trace 1`` a part of
the window is traced and the line holds the cell's per-layer metrics;
otherwise its end-to-end metrics.  Once the window has closed, the peak
memory is read, the program's state freed, and a sample of what the window
produced is held against the float32 reference.  Without the CUDA devices
the cell asks for, with JAX loaded, or where the port's preset no longer
gives the configuration file's settings, it exits non-zero and prints no
result."""

from __future__ import annotations

import argparse
import importlib
import os
import sys
import time


def process_start() -> float:
    """Wall-clock time at which this process started (from /proc)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return time.time()


T_START = process_start()


def execute(cell, seed: int, seconds: float, trace: bool, device="cuda",
            check_devices: bool = True, fault: str | None = None):
    """→ (the result line, or None, and the exit code).  ``cell`` is a
    workload's name, or a loaded ``core.Cell``; the tests pass one with
    ``check_devices`` off, and a ``fault`` of ``tools/faults.py`` planted
    under the timed path."""
    from benchmark import core
    if isinstance(cell, str):
        cell = core.load_cell(cell)
    if check_devices:
        core.require_devices(cell.chips)
    core.set_cache_dirs()
    import torch
    from benchmark.tools.faults import planted
    driver = importlib.import_module(f"benchmark.drivers.{cell.traffic['driver']}")
    with planted(cell.traffic["driver"], fault):
        d = driver.Driver(cell, seed, device)
        d.setup()
        setup_s = time.time() - T_START
        res = d.window(seconds, trace)
    peak = (max(torch.cuda.max_memory_allocated(i) for i in range(cell.chips))
            if torch.cuda.is_available() else 0)
    d.release()
    try:
        checks = d.check()
    finally:
        d.close()
    bad = core.forbidden_loaded()
    if bad:
        print(f"modules that the benchmark may not load are loaded: {bad}", file=sys.stderr)
        return None, 3
    metrics, breakdown = {}, None
    if trace:
        ctx = d.layer_context()
        ctx["window"] = res
        for m in cell.per_layer:
            reader = core.load_by_path(core.HERE / "metrics" / f"{m['name']}.py",
                                       "metric_" + m["name"].replace(".", "_"))
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        t = ctx["trace"]
        breakdown = {"device_ops": t.device_ops, "idle_gaps": t.idle_gaps}
    else:
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else res[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    info = {k: v for k, v in res.items() if k not in metrics}
    print(f"window: {info}", file=sys.stderr)
    dev = core.device_info(cell.chips, peak) if torch.cuda.is_available() else {
        "platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    if trace:
        dev.update(busy_s=ctx["trace"].busy_s, window_s=ctx["trace"].window_s)
    correct = all(v <= lim for _, v, lim in checks)
    core.print_checks(checks)
    return core.result_line(correct, res["attempted"], res["failed"], metrics, dev, checks,
                            breakdown), 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    from benchmark import core
    try:
        line, code = execute(a.workload, a.seed, a.seconds, bool(a.trace))
    except core.NoDevice as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    except core.ConfigMismatch as e:
        print(f"no result: {e}", file=sys.stderr)
        return 4
    if line is not None:
        sys.stdout.flush()
        print(line, flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
