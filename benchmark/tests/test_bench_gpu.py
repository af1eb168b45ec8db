"""One cell on the card: ``vctk_synth_b32`` for 10 s with ``--trace 1``,
the last line's keys.  Run on a card with
``python3 -m pytest -m gpu benchmark/tests/test_bench_gpu.py``."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import core


@pytest.mark.gpu
def test_traced_synth_run():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "vctk_synth_b32",
                        "--seed", str(2**31 + 41), "--seconds", "10", "--trace", "1"],
                       cwd=core.ROOT, capture_output=True, text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    dev = out["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["kind"] == torch.cuda.get_device_name(0)
    assert 0 < dev["busy_s"] <= dev["window_s"] and dev["memory_peak_bytes"] > 0
    cell = core.load_cell("vctk_synth_b32")
    assert set(out["metrics"]) == {m["name"] for m in cell.per_layer}
    for v in out["metrics"].values():
        assert v["value"] > 0
    assert len(out["breakdown"]["device_ops"]) <= 10
