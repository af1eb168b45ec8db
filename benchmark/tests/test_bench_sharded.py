"""The ``sharded_synth`` driver on four gloo ranks on the CPU at the ``tiny``
preset (float32): rank 0's global result against the float32 reference,
shard by shard with each shard's seed, within ``pod_synth_b256_4chip``'s
limits; the fp8 control put in the program's place fails them."""

import dataclasses
import json

import pytest

from benchmark import core
from benchmark.drivers import sharded_synth
from benchmark.run import execute
from tacotron_multispeaker_torch.config import get_config

OVERRIDES = ("model.num_speakers=8,parallel.model_parallel_size=4,"
             "parallel.shard_speaker_table_min=4,model.max_iters=4,audio.gl_method=dft_f32")
TINY = {"name": "tiny", "preset": "tiny", "overrides": OVERRIDES,
        "serve_weights": {"linear_proj.bias": 0.6},
        "resolved": json.loads(json.dumps(dataclasses.asdict(get_config("tiny", OVERRIDES))))}
SEED = 2**31 + 4093


def cell():
    c = core.load_cell("pod_synth_b256_4chip")
    mix = dict(c.traffic)
    mix.update(batch=8, min_chars=10, max_chars=30, median_chars=20, buckets=[32], block=4,
               sample=1, trace_calls=2, reference_rows=2)
    c.config, c.traffic = TINY, mix
    return c


def test_cell_is_found_by_name():
    c = core.load_cell("pod_synth_b256_4chip")
    assert c.chips == 4 and c.traffic["driver"] == "sharded_synth"
    assert c.traffic["batch"] == 256 and c.traffic["mesh"] == [1, 4]
    assert {m["name"] for m in c.per_layer} >= {"collective_ms_per_call.pod",
                                                 "device_idle_share.synth"}
    assert [m["name"] for m in c.end_to_end] == ["audio_s_per_s", "setup_s"]


def test_shard_rows_and_seeds():
    d = sharded_synth.Driver(cell(), SEED, "cpu")
    call = sharded_synth.generate.Call(["ab.", "abcdef.", "a.", "abc.", "x.", "y.", "zzzz.",
                                        "w."], [0] * 8, 32, 7)
    assert d._sampled(call).rows == [1, 0, 3, 2, 4, 5, 6, 7]
    assert sharded_synth.fold_in(7, 3) == 7 * 1_000_003 + 3


@pytest.fixture(scope="module")
def ran():
    d = sharded_synth.Driver(cell(), SEED, "cpu")
    d.setup()
    w = d.window(1.0, trace=False)
    d.release()
    return d, w


def test_program_passes_control_fails(ran):
    d, w = ran
    assert w["calls"] >= 1 and w["attempted"] == 8 * w["calls"] and w["failed"] == 0
    checks = d.check()
    assert all(v <= lim for _, v, lim in checks), checks
    control = d.check("fp8")
    assert not all(v <= lim for _, v, lim in control), control


def test_whole_run_on_cpu():
    line, code = execute(cell(), SEED + 1, 0.5, False, device="cpu", check_devices=False)
    out = json.loads(line)
    assert code == 0 and out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"audio_s_per_s", "setup_s"}
