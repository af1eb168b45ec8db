"""The readings a cell's correctness limits are set from, on the chip, at
the cell's own size, in one process:

    python3 -m benchmark.tools.readings --workload <cell> --seeds S1,S2,...
        [--control S,...] [--fault NAME:S,...] [--seconds 3]

For each program seed: set-up, a short window at the cell's load, and the
numbers its check compares (the lower readings).  For each control seed the
same, with the float32 reference computed in fp8 put in the program's place
(the upper readings).  ``--fault`` plants one of the driver's faults in the
program (``tools/faults.py``).  One JSON line per reading."""

from __future__ import annotations

import argparse
import importlib
import json
import sys


def _seeds(s: str) -> list[int]:
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control", default="")
    p.add_argument("--fault", action="append", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    a = p.parse_args(argv)
    from benchmark import core
    from benchmark.tools.faults import planted
    cell = core.load_cell(a.workload)
    core.require_devices(cell.chips)
    core.set_cache_dirs()
    driver = importlib.import_module(f"benchmark.drivers.{cell.traffic['driver']}")
    runs = [("program", s, None) for s in _seeds(a.seeds)]
    runs += [("control", s, None) for s in _seeds(a.control)]
    for f in a.fault:
        name, _, seeds = f.partition(":")
        runs += [(f"fault:{name}", s, name) for s in _seeds(seeds)]
    for mode, seed, fault in runs:
        with planted(cell.traffic["driver"], fault):
            d = driver.Driver(cell, seed)
            d.setup()
            w = d.window(a.seconds)
        d.release()
        checks = d.check("fp8" if mode == "control" else None)
        d.close()
        print(json.dumps({"mode": mode, "seed": seed, "window": w,
                          "readings": {k: v for k, v, _ in checks}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
