"""Each driver run on the CPU at the ``tiny`` preset (float32, so the
program and the reference agree to rounding): the program passes its cell's
limits; the fp8 control put in its place fails them, and so does each fault
planted in the timed path of a whole run (``benchmark.run.execute`` without
its look for a card)."""

import dataclasses
import json
import os

import pytest

from benchmark import core
from benchmark.drivers import synth_batch, train_steps
from benchmark.run import execute
from tacotron_multispeaker_torch.config import get_config

OVERRIDES = "model.num_speakers=4,model.max_iters=6,audio.gl_method=dft_f32"
TINY = {"name": "tiny", "preset": "tiny", "overrides": OVERRIDES,
        "serve_weights": {"linear_proj.bias": 0.6},
        "resolved": json.loads(json.dumps(dataclasses.asdict(get_config("tiny", OVERRIDES))))}
SEED = 2**31 + 977


def synth_cell():
    mix = core.load_json(core.HERE / "traffic/mixes/synth_b32.json")
    mix.update(batch=2, min_chars=10, max_chars=60, median_chars=25, buckets=[32, 64],
               block=10, sample=1, trace_calls=2, reference_rows=2)
    return tiny(core.load_cell("vctk_synth_b32"), mix)


def train_cell():
    mix = core.load_json(core.HERE / "traffic/mixes/train_b32.json")
    mix.update(utterances=32, min_chars=10, max_chars=60, median_chars=30, warm_steps=1,
               trace_steps=2, sync_every=2)
    # the train cell is kept out of BENCHMARK.json for now; its files stay
    limits = core.load_json(core.HERE / "limits/vctk_train_b32.json")
    e2e = [{"name": "train_examples_per_s", "unit": "examples/s"}, {"name": "setup_s", "unit": "s"}]
    return tiny(core.Cell("vctk_train_b32", 1, {}, {}, limits, [], e2e), mix)


def tiny(cell, mix):
    """The cell with its limits and metrics, at the tiny preset and sizes."""
    cell.config, cell.traffic = TINY, mix
    return cell


def run(driver, cell):
    d = driver.Driver(cell, SEED, "cpu")
    d.setup()
    w = d.window(0.5)
    d.release()
    return d, w


def passes(checks):
    return all(v <= lim for _, v, lim in checks)


@pytest.fixture(autouse=True)
def tmpdir_env(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)


@pytest.mark.parametrize("driver,cell", [(synth_batch, synth_cell), (train_steps, train_cell)],
                         ids=["synth_batch", "train_steps"])
def test_program_passes_control_fails(driver, cell):
    d, w = run(driver, cell())
    assert w["attempted"] > 0 and w["failed"] == 0
    assert passes(d.check()), d.check()
    control = d.check("fp8")
    assert not passes(control), control


@pytest.mark.parametrize("driver,cell,fault", [
    (synth_batch, synth_cell, "half_batch"), (synth_batch, synth_cell, "answer"),
    (train_steps, train_cell, "unchanged"), (train_steps, train_cell, "half_batch"),
    (train_steps, train_cell, "answer")])
def test_fault_fails(driver, cell, fault):
    line, code = execute(cell(), SEED, 0.5, False, device="cpu", check_devices=False,
                         fault=fault)
    out = json.loads(line)
    assert code == 0 and out["correct"] is False, (fault, out["checks"])


@pytest.mark.parametrize("cell", [synth_cell, train_cell], ids=["synth_batch", "train_steps"])
def test_whole_run_on_cpu(cell):
    line, code = execute(cell(), SEED, 0.5, False, device="cpu", check_devices=False)
    out = json.loads(line)
    assert code == 0 and out["correct"] is True
    assert list(out)[-1] == "checks" and out["attempted"] > 0 and out["failed"] == 0
    assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2


def test_train_corpus_removed():
    d, _ = run(train_steps, train_cell())
    tmp = d.tmp
    assert os.path.isdir(tmp)
    d.close()
    assert not os.path.exists(tmp)


def test_preset_that_moved_fails_the_run():
    # a later edit of the port's preset (fewer Griffin-Lim iterations) that the
    # configuration file does not state: the run ends with no result line
    cell = synth_cell()
    cell.config = json.loads(json.dumps(TINY))
    cell.config["resolved"]["audio"]["griffin_lim_iters"] = 8
    with pytest.raises(core.ConfigMismatch, match="griffin_lim_iters"):
        execute(cell, SEED, 0.5, False, device="cpu", check_devices=False)
