"""The ``synth_tacotron2`` driver on the CPU at the ``tacotron2_tiny`` preset
(float32, so the program and the reference agree to rounding): the program
passes ``sv2tts_synth_b32``'s limits; the fp8 control put in its place fails
them, and so does each of the synthesis faults of ``tools/faults.py``
planted under a whole run.  ``counts/tacotron2.py`` against a count by hand."""

import dataclasses
import json

import pytest

from benchmark import core
from benchmark.counts import griffin_lim_flops, tacotron2
from benchmark.drivers import synth_tacotron2
from benchmark.run import execute
from benchmark.tools import faults
from tacotron_multispeaker_torch.config import get_config

OVERRIDES = "model.max_iters=8,audio.gl_method=dft_f32"
TINY = {"name": "tacotron2_tiny", "preset": "tacotron2_tiny", "overrides": OVERRIDES,
        "serve_weights": {"frame_proj.bias": 0.6, "stop_proj.bias": -10.0},
        "resolved": json.loads(json.dumps(dataclasses.asdict(
            get_config("tacotron2_tiny", OVERRIDES))))}
SEED = 2**31 + 1213


def cell():
    c = core.load_cell("sv2tts_synth_b32")
    mix = dict(c.traffic)
    mix.update(batch=4, min_chars=10, max_chars=60, median_chars=25, buckets=[32, 64],
               block=10, sample=1, trace_calls=2, reference_rows=2)
    c.config, c.traffic = TINY, mix
    return c


@pytest.fixture(autouse=True)
def tmpdir_env(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))


def test_cell_is_found_by_name():
    c = core.load_cell("sv2tts_synth_b32")
    assert c.traffic["driver"] == "synth_tacotron2" and c.chips == 1
    names = {m["name"] for m in c.per_layer}
    assert {"mfu.tacotron2_synth", "roofline.lstm_decode"} <= names
    assert not names & {"mfu.synth", "roofline.decoder_loop"}
    cfg = core.port_config(c.config)
    assert cfg.model.architecture == "tacotron2" and cfg.model.max_iters == 1000


def test_program_passes_control_fails():
    d = synth_tacotron2.Driver(cell(), SEED, "cpu")
    d.setup()
    w = d.window(0.5)
    d.release()
    assert w["attempted"] > 0 and w["failed"] == 0
    checks = d.check()
    assert all(v <= lim for _, v, lim in checks), checks
    assert [k for k, _, _ in checks] == ["align", "wav_convergence"]  # frames: printed only
    control = d.check("fp8")
    assert not all(v <= lim for _, v, lim in control), control


@pytest.mark.parametrize("fault", faults.FAULTS["synth_batch"])
def test_fault_fails(fault):
    # the faults wrap Synthesizer.synthesize_batch, which this driver calls too
    with faults._synth_patch(fault):
        line, code = execute(cell(), SEED, 0.5, False, device="cpu", check_devices=False)
    out = json.loads(line)
    assert code == 0 and out["correct"] is False, (fault, out["checks"])


def test_whole_run_on_cpu():
    line, code = execute(cell(), SEED, 0.5, False, device="cpu", check_devices=False)
    out = json.loads(line)
    assert code == 0 and out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"audio_s_per_s", "synth_call_p95_ms", "setup_s"}


def test_counts_against_a_hand_count():
    dims = {"model": {"prenet_depths": [3, 5], "decoder_lstm_units": 4, "attention_depth": 2,
                      "encoder_lstm_units": 3, "num_speakers": 2, "speaker_embed_depth": 1,
                      "speaker_condition": ["encoder_output"], "attention_location_kernel": 5,
                      "attention_location_filters": 2, "embed_depth": 6,
                      "encoder_conv_channels": 7, "encoder_conv_layers": 2,
                      "encoder_conv_width": 3, "postnet_conv_channels": 8,
                      "postnet_conv_layers": 3, "postnet_conv_width": 5},
            "audio": {"num_mels": 2, "num_freq": 9, "griffin_lim_iters": 1}}
    # D = 2*3 + 1 = 7; a step at L = 10:
    # prenet 2*3 + 3*5, att LSTM (5+7+4)*16, query 4*2, location 10*5*2,
    # context 10*7, dec LSTM (4+7+4)*16, projections (4+7)*3
    macs = 6 + 15 + 256 + 8 + 100 + 70 + 240 + 33
    assert tacotron2.decode_macs(dims, 10) == macs
    # convs 2*3*(6*7 + 7*7), BiLSTM 2*2*(7+3)*12, keys 2*7*2, a character
    assert tacotron2.encoder_flops(dims, 4) == 4 * (546 + 480 + 28)
    # post-net 2*5*(2*8 + 8*8 + 8*2), mel to linear 2*2*9, a frame
    assert tacotron2.postnet_flops(dims, 3) == 3 * (960 + 36)
    assert tacotron2.synth_flops(dims, [4, 10], 3) == pytest.approx(
        4 * 1054 + 10 * 1054 + 2 * 3 * (tacotron2.decode_macs(dims, 4) + macs)
        + 2 * 3 * 996 + 2 * griffin_lim_flops(dims, 3))
    # bytes: weights (prenet, LSTMs, query, location, v, projections, biases)
    weights = (6 + 15 + 256 + 8 + 10 + 2 + 240 + 33) + (3 + 5 + 32 + 2 + 1)
    nbytes = (weights * 2 + 2 * 10 * (2 + 7) * 2 + 2 * 10 + 6 * 2 * 8 * 4
              + 6 * 2 * (2 + 10 + 1) * 4 + 2 * (16 + 7 + 10) * 4)
    f32 = 6 * 2 * (3 * 10 * 2 + 5 * 10 + 20 * 4)
    want = max(nbytes / 3.35e12, 2 * 6 * 2 * macs / 989e12 + f32 / 67e12)
    assert tacotron2.lstm_decode_bound_s(2, 10, 6, dims) == pytest.approx(want)
