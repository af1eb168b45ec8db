"""The port's train loop and entry points on the CPU, ``tiny`` preset.

The loop's first three losses against the JAX package's ``make_train_step``
over the JAX Feeder's batches from the same initial weights (carried over by
``convert.py`` in a step-0 checkpoint, which the loop resumes from);
checkpoints, resume and the final save; a divergence abort that writes no
checkpoint; the eval artifacts; the entry points ``python -m
tacotron_multispeaker_torch.preprocess`` / ``.train``.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the JAX package's models need flax
pytest.importorskip("flax")

from scipy.io import wavfile  # noqa: E402

from tacotron_multispeaker_tpu import config as jconfig  # noqa: E402
from tacotron_multispeaker_tpu import training as jtraining  # noqa: E402
from tacotron_multispeaker_tpu.data import feeder as jfeeder  # noqa: E402
from tacotron_multispeaker_tpu.models import create_model as jcreate_model  # noqa: E402
from tacotron_multispeaker_torch import config as tconfig  # noqa: E402
from tacotron_multispeaker_torch import convert, train_loop, training  # noqa: E402
from tacotron_multispeaker_torch import preprocess as preprocess_main  # noqa: E402
from tacotron_multispeaker_torch import train as train_main  # noqa: E402
from tacotron_multispeaker_torch.synthesizer import Synthesizer  # noqa: E402
from tacotron_multispeaker_torch.utils.checkpoint import CheckpointManager  # noqa: E402
from test_torch_model import _fill  # noqa: E402

# one input and one output bucket: the JAX step compiles once
OV = ("model.num_speakers=3,model.prenet_dropout=0.0,model.max_iters=8,"
      "train.batch_size=4,train.batches_per_group=2,train.summary_interval=1,"
      "train.input_bucket_boundaries=(64),train.bucket_boundaries=(200)")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 12-utterance, 3-speaker synthetic corpus preprocessed by the port's
    entry point on the CPU: the data dir."""
    base = str(tmp_path_factory.mktemp("loop"))
    path = preprocess_main.main(["--dataset", "synthetic", "--base_dir", base, "--preset",
                                 "tiny", "--n_utts", "12", "--n_speakers", "3",
                                 "--device", "cpu"])
    return os.path.dirname(path)


def _metrics(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_loop_losses_match_jax_make_train_step(corpus, tmp_path):
    # same initial weights (numpy-filled flax tree, converted), dropout off,
    # f32, the same batches: the JAX step over the JAX Feeder's first three
    # batches against the loop's summaries at steps 1-3 -> 1e-4 relative
    jcfg, tcfg = jconfig.get_config("tiny", OV), tconfig.get_config("tiny", OV)
    jm = jcreate_model("tacotron", jcfg)
    st = jax.eval_shape(lambda r: jtraining.create_train_state(jcfg, r, model=jm)[1],
                        jax.random.PRNGKey(0))
    variables = _fill({"params": st.params, "batch_stats": st.batch_stats},
                      np.random.RandomState(4))
    tx = jtraining.make_optimizer(jcfg)
    jstate = jtraining.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]),
        rng=jax.random.PRNGKey(0))
    jstep = jax.jit(jtraining.make_train_step(jcfg, jm, tx))
    jf = jfeeder.Feeder(corpus, jcfg, use_native=False, process_index=0, process_count=1)
    losses_j = []
    for entry in jf.epoch_plan(0)[:3]:
        b = jf.materialize(entry)
        jstate, m = jstep(jstate, b.inputs, b.input_lengths, b.mel_targets, b.linear_targets,
                          b.target_lengths, b.speaker_ids)
        losses_j.append(float(m["loss"]))

    log_dir = str(tmp_path / "logs")
    model, state = training.create_train_state(tcfg, device="cpu")
    model.load_state_dict(convert.flax_to_state_dict(variables, model), strict=True)
    CheckpointManager(os.path.join(log_dir, "checkpoints")).save(0, state)
    out = train_loop.train(log_dir, corpus, tcfg, max_steps=3, device="cpu")
    rows = _metrics(log_dir)
    assert out["step"] == 3 and [r["step"] for r in rows] == [1, 2, 3]
    np.testing.assert_allclose([r["loss"] for r in rows], losses_j, rtol=1e-4)
    assert all(np.isfinite(r["grad_norm"]) and r["sec_per_step"] > 0 for r in rows)


def test_checkpoints_resume_and_eval_artifacts(corpus, tmp_path):
    cfg = tconfig.get_config("tiny", OV + ",train.checkpoint_interval=2")
    log_dir = str(tmp_path / "logs")
    out = train_loop.train(log_dir, corpus, cfg, max_steps=5, device="cpu")
    ckpts = CheckpointManager(os.path.join(log_dir, "checkpoints"))
    assert out["step"] == 5 and ckpts.steps() == [2, 4, 5]    # the final save at 5
    for step in (2, 4):
        rate, pcm = wavfile.read(os.path.join(log_dir, f"step-{step}-audio.wav"))
        assert rate == cfg.audio.sample_rate and pcm.dtype == np.int16 and pcm.size > 0
        assert os.path.getsize(os.path.join(log_dir, f"step-{step}-align.png")) > 0
    # resume: continues from step 5, appends steps 6-7, saves at 6 and 7
    out = train_loop.train(log_dir, corpus, cfg, max_steps=7, device="cpu")
    assert out["step"] == 7 and ckpts.steps() == [2, 4, 5, 6, 7]
    assert [r["step"] for r in _metrics(log_dir)] == [1, 2, 3, 4, 5, 6, 7]
    assert "resumed from checkpoint at step 5" in open(os.path.join(log_dir, "train.log")).read()
    # restore loads the model, the Adam state, the step and the seed
    model, state = training.create_train_state(cfg, seed=9, device="cpu")
    ckpts.restore(state)
    assert (state.step, state.seed) == (7, cfg.train.seed)
    adam = state.optimizer.adam.state_dict()["state"]
    assert adam and all(int(s["step"]) == 7 for s in adam.values())
    saved = torch.load(ckpts.path(7), weights_only=True)["model"]
    assert all(torch.equal(v, saved[k]) for k, v in model.state_dict().items())
    # the same file loads into a Synthesizer (file or directory)
    syn = Synthesizer(cfg, device="cpu", seed=3).load(os.path.join(log_dir, "checkpoints"))
    assert all(torch.equal(v, saved[k]) for k, v in syn.model.state_dict().items())


def test_eval_artifacts_without_matplotlib(corpus, tmp_path, monkeypatch):
    # matplotlib is optional: the WAV and the alignments are written, the
    # plot is left out with a log line, and the eval counts as written
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    cfg = tconfig.get_config("tiny", OV + ",train.checkpoint_interval=2")
    log_dir = str(tmp_path / "logs")
    train_loop.train(log_dir, corpus, cfg, max_steps=2, device="cpu")
    assert sorted(f for f in os.listdir(log_dir) if f.startswith("step-")) == [
        "step-2-align.npy", "step-2-audio.wav"]
    align = np.load(os.path.join(log_dir, "step-2-align.npy"))
    assert align.shape == (cfg.model.max_iters, 64)
    np.testing.assert_allclose(align.sum(-1), 1.0, atol=1e-5)
    text = open(os.path.join(log_dir, "train.log")).read()
    assert "alignment plot not drawn" in text and "wrote eval artifacts for step 2" in text


def _event_accumulator(tb_dir):
    from tensorboard.backend.event_processing import event_accumulator
    acc = event_accumulator.EventAccumulator(tb_dir, size_guidance={"scalars": 0, "images": 0})
    acc.Reload()
    return acc


def _png(width, height):
    """A tiny RGB PNG (a gradient), written with zlib alone."""
    import struct
    import zlib

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))
    rows = b"".join(b"\0" + bytes(v for x in range(width) for v in (40 * x, 60 * y, 128))
                    for y in range(height))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


def test_metrics_writer_tensorboard_events(tmp_path, monkeypatch):
    # scalars and a PNG image read back with tensorboard's event reader;
    # metrics.jsonl beside them; where tensorboard does not import, one log
    # line says so and only metrics.jsonl is written
    from tacotron_multispeaker_torch.utils import metrics
    png = tmp_path / "align.png"
    png.write_bytes(_png(5, 3))
    w = metrics.MetricsWriter(str(tmp_path / "run"), use_tensorboard=True)
    w.scalars(1, {"loss": 2.5, "lr": 1e-3})
    w.scalars(2, {"loss": 1.25, "lr": 1e-3})
    w.image(2, "alignment", str(png))
    w.image(3, "alignment", str(tmp_path / "missing.png"))       # no file: nothing
    w.close()
    acc = _event_accumulator(str(tmp_path / "run" / "tb"))
    assert [(e.step, e.value) for e in acc.Scalars("loss")] == [(1, 2.5), (2, 1.25)]
    (img,) = acc.Images("alignment")
    assert (img.step, img.width, img.height) == (2, 5, 3)
    assert img.encoded_image_string == png.read_bytes()
    assert [r["loss"] for r in _metrics(str(tmp_path / "run"))] == [2.5, 1.25]

    import builtins
    real_import = builtins.__import__

    def no_tensorboard(name, *args, **kwargs):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError("No module named 'tensorboard'")
        return real_import(name, *args, **kwargs)

    logged = []
    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    monkeypatch.setattr(metrics.infolog, "log", logged.append)
    w = metrics.MetricsWriter(str(tmp_path / "bare"), use_tensorboard=True)
    w.scalars(1, {"loss": 3.0})
    w.image(1, "alignment", str(png))
    w.close()
    assert len(logged) == 1 and "TensorBoard" in logged[0]
    assert os.listdir(tmp_path / "bare") == ["metrics.jsonl"]


def test_checkpoint_manager_keeps_the_newest_five(tmp_path):
    cfg = tconfig.get_config("tiny")
    _, state = training.create_train_state(cfg, device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() is None
    for step in range(1, 8):
        mgr.save(step, state)
    assert mgr.steps() == [3, 4, 5, 6, 7] and mgr.latest_step() == 7
    assert sorted(os.listdir(tmp_path)) == [f"ckpt-{s:08d}.pt" for s in range(3, 8)]


def test_divergence_abort_writes_no_checkpoint(corpus, tmp_path, monkeypatch):
    real = train_loop.make_sharded_train_step

    def diverging(cfg, model, mesh):
        step = real(cfg, model, mesh)

        def run(state, *batch):
            state, m = step(state, *batch)
            if state.step >= 3:
                m = dict(m, loss=torch.tensor(float("nan")))
            return state, m
        return run

    monkeypatch.setattr(train_loop, "make_sharded_train_step", diverging)
    cfg = tconfig.get_config("tiny", OV + ",train.checkpoint_interval=2,train.summary_interval=50")
    log_dir = str(tmp_path / "logs")
    with pytest.raises(FloatingPointError, match="step 3"):
        train_loop.train(log_dir, corpus, cfg, max_steps=6, device="cpu")
    assert CheckpointManager(os.path.join(log_dir, "checkpoints")).steps() == [2]
    assert "NOT checkpointed" in open(os.path.join(log_dir, "train.log")).read()


def test_train_entry_point_and_unported_options(corpus, tmp_path, monkeypatch):
    base = os.path.dirname(corpus)
    out = train_main.main(["--base_dir", base, "--preset", "tiny", "--name", "entry",
                           "--max_steps", "2", "--profile", "1:2", "--device", "cpu",
                           "--hparams", OV])
    assert out["step"] == 2 and np.isfinite(out["loss"])
    assert out["profile"]["steps"] == [1, 2] and out["profile"]["wall_ms"] > 0
    logs = os.path.join(base, "logs-entry")
    assert CheckpointManager(os.path.join(logs, "checkpoints")).steps() == [2]
    assert os.listdir(os.path.join(logs, "profile")) == ["steps-1-2.json"]
    # the loop's own spans label the written trace
    with open(os.path.join(logs, "profile", "steps-1-2.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "train.step" in names
    cfg = tconfig.get_config("tiny", OV)
    # TACOTRON_TB=1: the loop's summaries also go to TensorBoard event files
    monkeypatch.setenv("TACOTRON_TB", "1")
    train_loop.train(str(tmp_path / "tb"), corpus, cfg, max_steps=1, device="cpu")
    monkeypatch.delenv("TACOTRON_TB")
    acc = _event_accumulator(str(tmp_path / "tb" / "tb"))
    assert [e.step for e in acc.Scalars("loss")] == [1]
    assert _metrics(str(tmp_path / "tb"))[0]["loss"] == pytest.approx(
        acc.Scalars("loss")[0].value, rel=1e-6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_main.main(["--base_dir", base, "--preset", "tiny", "--max_steps", "1"])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            preprocess_main.main(["--dataset", "synthetic", "--base_dir", str(tmp_path),
                                  "--preset", "tiny", "--n_utts", "2"])
