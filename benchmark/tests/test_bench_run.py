"""``python3 -m benchmark.run`` without a card, and in a directory that
holds only the benchmark: non-zero exit, no result line."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import core


def run_in(cwd):
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "vctk_synth_b32", "--seed", str(2**31 + 5), "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def no_result(p):
    for line in p.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
    return p.returncode != 0


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    p = run_in(core.ROOT)
    assert no_result(p), p.stdout
    assert "CUDA" in p.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copytree(core.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path)
    p = run_in(tmp_path)
    assert no_result(p), p.stdout
