"""The port's trainer input pipeline against the JAX package's, on the CPU.

The loader over the Feeder's global plan (``--pipeline grain``, worker
processes) against the JAX ``grain_global_batches``; the native batch
assembler against the numpy path and the JAX bindings; bfloat16 and PCM
targets against the JAX Feeder's; ``spectrogram_targets`` against the JAX
one and the offline features; one ``targets_from_wav`` (and one bfloat16
targets) train step against the JAX ``make_train_step``; two loop steps fed
by two worker processes.  ``tiny`` preset; the worker tests run under the
loader's own ``timeout``, so a stuck worker fails them.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the JAX package's models and its grain pipeline
pytest.importorskip("flax")
pytest.importorskip("grain")

from tacotron_multispeaker_tpu import config as jconfig  # noqa: E402
from tacotron_multispeaker_tpu import training as jtraining  # noqa: E402
from tacotron_multispeaker_tpu.audio import dsp as jdsp  # noqa: E402
from tacotron_multispeaker_tpu.data import feeder as jfeeder  # noqa: E402
from tacotron_multispeaker_tpu.data import grain_pipeline as jgrain  # noqa: E402
from tacotron_multispeaker_tpu.data import native_batcher as jnative  # noqa: E402
from tacotron_multispeaker_tpu.models import create_model as jcreate_model  # noqa: E402
from tacotron_multispeaker_torch import config as tconfig  # noqa: E402
from tacotron_multispeaker_torch import convert, train_loop, training  # noqa: E402
from tacotron_multispeaker_torch import train as train_main  # noqa: E402
from tacotron_multispeaker_torch.audio import dsp  # noqa: E402
from tacotron_multispeaker_torch.data import feeder, grain_pipeline  # noqa: E402
from tacotron_multispeaker_torch.data import native_batcher, preprocess, synthetic  # noqa: E402
from tacotron_multispeaker_torch.utils.checkpoint import CheckpointManager  # noqa: E402
from test_torch_model import _fill  # noqa: E402

# 10 utterances, batches of 2 in groups of 2: five batches an epoch over
# both output buckets
OV = ("model.num_speakers=3,train.batch_size=2,train.batches_per_group=2,"
      "train.summary_interval=1")
FIELDS = ("inputs", "input_lengths", "mel_targets", "linear_targets", "target_lengths",
          "speaker_ids")
TIMEOUT = 120           # the loader's limit on one batch, seconds


def _cfgs(extra=""):
    ov = OV + ("," + extra if extra else "")
    return tconfig.get_config("tiny", ov), jconfig.get_config("tiny", ov)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 10-utterance, 3-speaker synthetic corpus preprocessed by the port
    on the CPU with the int16 PCM kept: the data dir."""
    base = tmp_path_factory.mktemp("pipeline")
    cfg, _ = _cfgs()
    raw = synthetic.make_corpus(str(base / "raw"), n_utts=10, n_speakers=3,
                                sample_rate=cfg.audio.sample_rate, seed=7)
    out = str(base / "training")
    preprocess.write_metadata(preprocess.CORPORA["generic"](
        raw, out, cfg.audio, keep_wavs=True, device="cpu"), out, cfg.audio)
    return out


def _host(a):
    """A batch field as numpy: bfloat16 tensors as their bits (uint16)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16) if a.dtype == torch.bfloat16 \
            else a.numpy()
    return a


def _assert_batches_equal(got, want):
    for name in FIELDS:
        a, b = _host(getattr(got, name)), np.asarray(_host(getattr(want, name)))
        if b.dtype.name == "bfloat16":
            b = b.view(np.uint16)
        assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype, b.dtype, a.shape)
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("workers", [0, 2])
def test_grain_global_batches_match_jax(corpus, workers):
    # one epoch in plan order, array-equal to the JAX stream in process;
    # with workers the targets arrive as shared-memory tensors
    tcfg, jcfg = _cfgs()
    want = list(jgrain.grain_global_batches(corpus, jcfg, num_epochs=1, process_index=0,
                                            process_count=1))
    stream = grain_pipeline.grain_global_batches(corpus, tcfg, num_epochs=1,
                                                 worker_count=workers, timeout=TIMEOUT)
    try:
        got = list(stream)
    finally:
        stream.close()
    assert len(got) == len(want) == 5
    assert {b.mel_targets.shape[1] for b in got} == {100, 200}
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)
        assert isinstance(g.mel_targets, torch.Tensor if workers else np.ndarray)


def test_grain_workers_fill_the_ring_this_process_maps(corpus):
    # a worker's batch arrives as places in a ring slot this process made
    # (no data, no file descriptor), and the slot is busy until the batch
    # is copied out; a bf16 stream and a PCM stream come out equal to the
    # Feeder's
    for extra, dtype in (("train.targets_dtype=bfloat16", torch.bfloat16),
                         ("train.targets_from_wav=true", torch.int16)):
        tcfg, _ = _cfgs(extra)
        stream = grain_pipeline.grain_global_batches(corpus, tcfg, num_epochs=1,
                                                     worker_count=2, timeout=TIMEOUT)
        try:
            ring = stream._dataset.ring
            slot, batch = next(stream._workers)
            start, shape, got_dtype = batch.mel_targets
            assert start == 0 and got_dtype == dtype and len(shape) in (2, 3)
            assert int(ring.busy[slot]) == 1
            first = stream._copy_out((slot, batch))
            assert int(ring.busy[slot]) == 0
            got = [first] + list(stream)
        finally:
            stream.close()
        want = list(feeder.Feeder(corpus, tcfg).epoch_batches(0))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_batches_equal(g, w)


def test_grain_ring_with_more_workers_than_cores(corpus):
    # the ring's slot flags under contention: more worker processes than
    # cores, six epochs (each worker fills each of its slots more than
    # once); a slot overwritten before it was copied out would put another
    # batch's targets in this one
    tcfg, _ = _cfgs()
    workers = min((os.cpu_count() or 1) + 1, 12)
    stream = grain_pipeline.grain_global_batches(corpus, tcfg, num_epochs=6,
                                                 worker_count=workers, timeout=TIMEOUT)
    try:
        got = list(stream)
    finally:
        stream.close()
    f = feeder.Feeder(corpus, tcfg)
    want = [b for e in range(6) for b in f.epoch_batches(e)]
    assert len(got) == len(want) == 30
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)


def test_grain_global_batches_two_processes_and_endless_bound(corpus, monkeypatch):
    # two processes each take their contiguous half of every global batch,
    # with the same shapes; the halves concatenate to the Feeder's batches
    tcfg, _ = _cfgs()
    whole = list(feeder.Feeder(corpus, tcfg).epoch_batches(0))
    halves = [list(grain_pipeline.grain_global_batches(corpus, tcfg, num_epochs=1,
                                                       process_index=i, process_count=2))
              for i in (0, 1)]
    assert len(halves[0]) == len(halves[1]) == len(whole) == 5
    for w, h0, h1 in zip(whole, *halves):
        for name in FIELDS:
            a, b = getattr(h0, name), getattr(h1, name)
            assert a.shape == b.shape and a.shape[0] == 1
            np.testing.assert_array_equal(np.concatenate([a, b]), getattr(w, name))
    # the endless stream: epoch after epoch in plan order, then a diagnostic
    monkeypatch.setattr(grain_pipeline, "ENDLESS_EPOCHS", 2)
    stream = grain_pipeline.grain_global_batches(corpus, tcfg)
    got = [next(stream) for _ in range(10)]
    for g, w in zip(got, whole + list(feeder.Feeder(corpus, tcfg).epoch_batches(1))):
        _assert_batches_equal(g, w)
    with pytest.raises(RuntimeError, match="epoch bound exhausted after 10 batches"):
        next(stream)


def test_native_batcher_matches_numpy_and_jax(corpus):
    assert native_batcher.available(), native_batcher.build_error()
    assert native_batcher.SRC.is_relative_to(os.path.dirname(os.path.dirname(
        os.path.abspath(native_batcher.__file__))))
    tcfg, _ = _cfgs()
    f_cc = feeder.Feeder(corpus, tcfg)
    f_py = feeder.Feeder(corpus, tcfg, use_native=False)
    assert f_cc.use_native and not f_py.use_native
    for entry in f_cc.epoch_plan(0) + f_cc.epoch_plan(1):
        _assert_batches_equal(f_cc.materialize(entry), f_py.materialize(entry))
    # the bindings against the JAX package's, over the same files
    rows = preprocess.load_metadata(os.path.join(corpus, "train.txt"))
    mels = [os.path.join(corpus, r["mel_file"]) for r in rows]
    for path, r in zip(mels, rows):
        assert native_batcher.npy_rows(path, 80) == jnative.npy_rows(path, 80) == r["n_frames"]
        assert native_batcher.npy_rows(path, 13) == jnative.npy_rows(path, 13) == -1
    assert native_batcher.npy_rows(mels[0] + ".missing", 80) == -1
    for t_cap in (50, 200):          # cut and padded
        got, n_got = native_batcher.assemble_batch(mels, t_cap, 80)
        want, n_want = jnative.assemble_batch(mels, t_cap, 80)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(n_got, n_want)
    # into a tensor's memory; a wrong buffer or a bad file raises
    out = torch.full((2, 64, 80), 7.0)
    lengths = native_batcher.assemble_into(mels[:2], out.numpy())
    np.testing.assert_array_equal(out.numpy(), native_batcher.assemble_batch(mels[:2], 64, 80)[0])
    assert list(lengths) == [min(r["n_frames"], 64) for r in rows[:2]]
    with pytest.raises(ValueError, match="float32"):
        native_batcher.assemble_into(mels[:2], np.empty((2, 64, 80), np.float64))
    with pytest.raises(IOError, match="failed on 1 files"):
        native_batcher.assemble_into([mels[0], mels[1] + ".missing"], out.numpy())


def _torch_empty(shape, dtype):
    return torch.empty(shape, dtype=dtype)


@pytest.mark.parametrize("empty", [None, _torch_empty])
def test_bfloat16_targets_match_jax_feeder(corpus, empty):
    # rounded on the host to nearest even: bit-equal to ml_dtypes
    tcfg, jcfg = _cfgs("train.targets_dtype=bfloat16")
    tf = feeder.Feeder(corpus, tcfg, empty=empty)
    jf = jfeeder.Feeder(corpus, jcfg, use_native=False, process_index=0, process_count=1)
    for entry in tf.epoch_plan(0):
        bt, bj = tf.materialize(entry), jf.materialize(entry)
        assert bt.mel_targets.dtype == bt.linear_targets.dtype == torch.bfloat16
        _assert_batches_equal(bt, bj)


@pytest.mark.parametrize("empty", [None, _torch_empty])
def test_pcm_batch_matches_jax_feeder(corpus, tmp_path, empty):
    tcfg, jcfg = _cfgs("train.targets_from_wav=true")
    tf = feeder.Feeder(corpus, tcfg, empty=empty)
    jf = jfeeder.Feeder(corpus, jcfg, process_index=0, process_count=1)
    hop = tcfg.audio.hop_length
    for entry in tf.epoch_plan(0):
        bt, bj = tf.materialize(entry), jf.materialize(entry)
        _assert_batches_equal(bt, bj)
        assert _host(bt.mel_targets).dtype == np.int16
        assert bt.mel_targets.shape == (2, entry[4] * hop)
        assert bt.linear_targets.shape == (2, 0, 0)
    # without the kept PCM: the JAX message, pointing to --keep_wavs
    bare = tmp_path / "bare"
    bare.mkdir()
    (bare / "train.txt").write_text(open(os.path.join(corpus, "train.txt")).read())
    with pytest.raises(FileNotFoundError, match="--keep_wavs"):
        next(iter(feeder.Feeder(str(bare), tcfg)))


def _targets_f64(wav, audio, n_frames):
    """(mel, linear) targets in float64 from numpy's rfft of the windowed
    full frames: the function both f32 versions round."""
    n_fft, hop = audio.n_fft, audio.hop_length
    y = wav.astype(np.float64)
    y = np.r_[y[:1], y[1:] - audio.preemphasis * y[:-1]]
    y = np.pad(y, n_fft // 2, mode="reflect")
    frames = np.stack([y[k * hop: k * hop + n_fft] for k in range(n_frames)])
    mag = np.abs(np.fft.rfft(frames * dsp.hann_window(audio.win_length, n_fft), axis=-1))
    norm = lambda m: np.clip((20 * np.log10(np.maximum(m, 1e-5)) - audio.ref_level_db
                              - audio.min_level_db) / -audio.min_level_db, 0, 1)
    basis = dsp.mel_basis(audio.sample_rate, n_fft, audio.num_mels).astype(np.float64)
    return norm(mag @ basis.T), norm(mag)


@pytest.mark.parametrize("preset", ["tiny", "multispeaker_vctk"])
def test_spectrogram_targets_match_jax_and_offline(corpus, preset):
    # the same PCM through both, f32 products on both sides (the JAX side at
    # Precision.HIGHEST) in other sum orders.  Near-floor bins turn that
    # rounding into dB differences: each side lies 4.7e-5 to 5.7e-5 from the
    # float64 function at the 90th percentile on this corpus, so the two
    # agree to 1e-4 there and 1e-2 at most, and the port is held to be no
    # farther from float64 than the JAX version (x1.25, plus 1e-6 for the
    # mel features, whose 90th percentiles are f32 round-off, ~1e-7)
    rows = preprocess.load_metadata(os.path.join(corpus, "train.txt"))
    pcm = np.load(os.path.join(corpus, preprocess.wav_file_for(rows[0])))
    wav = pcm.astype(np.float32) / 32768.0
    audio = tconfig.get_config(preset).audio
    n = rows[0]["n_frames"]
    kw = dict(sample_rate=audio.sample_rate, num_mels=audio.num_mels,
              preemph=audio.preemphasis, ref_level_db=audio.ref_level_db,
              min_level_db=audio.min_level_db, n_frames=n)
    mel_t, lin_t = dsp.spectrogram_targets(torch.from_numpy(wav),
                                           dsp.STFTParams.from_config(audio), **kw)
    mel_j, lin_j = jdsp.spectrogram_targets(jnp.asarray(wav), jdsp.STFTParams(
        audio.n_fft, audio.hop_length, audio.win_length), **kw)
    p90 = lambda a, b: float(np.percentile(np.abs(a - b), 90))
    for t, j, r in zip((mel_t, lin_t), (mel_j, lin_j), _targets_f64(wav, audio, n)):
        t, j = t.numpy(), np.asarray(j)
        assert t.shape == j.shape == r.shape and t.shape[0] == n
        assert np.abs(t - j).max() < 0.01 and p90(t, j) < 1e-4, (np.abs(t - j).max(), p90(t, j))
        assert np.abs(t - r).max() < 0.01 and p90(t, r) <= 1.25 * p90(j, r) + 1e-6, (
            p90(t, r), p90(j, r))
    if preset == "tiny":
        # against the offline features of the same utterance (the JAX
        # gate, tests/test_data.py): max < 0.01, 90th percentile < 2e-4
        for t, f in ((mel_t, rows[0]["mel_file"]), (lin_t, rows[0]["linear_file"])):
            d = np.abs(t.numpy() - np.load(os.path.join(corpus, f)))
            assert d.max() < 0.01 and np.percentile(d, 90) < 2e-4


@pytest.mark.parametrize("variant", ["train.targets_from_wav=true",
                                     "train.targets_dtype=bfloat16"])
def test_train_step_on_pipeline_targets_matches_jax(corpus, variant):
    # one step from the same weights on the same host batch (the JAX
    # Feeder's: int16 PCM, or ml_dtypes bfloat16 targets), f32, dropout 0:
    # the loop parity's tolerance, 1e-4 relative
    ov = variant + ",model.prenet_dropout=0.0,model.compute_dtype=float32"
    tcfg, jcfg = _cfgs(ov)
    jf = jfeeder.Feeder(corpus, jcfg, use_native=False, process_index=0, process_count=1)
    batch = jf.materialize(jf.epoch_plan(0)[0])
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
    _, mj = jax.jit(jtraining.make_train_step(jcfg, jm, tx))(
        jstate, *(getattr(batch, f) for f in FIELDS))

    model, state = training.create_train_state(tcfg, device="cpu")
    model.load_state_dict(convert.flax_to_state_dict(variables, model), strict=True)
    host = feeder.Feeder(corpus, tcfg).materialize(jf.epoch_plan(0)[0])
    args = train_loop.batch_to_device(host, torch.device("cpu"))
    assert args[2].dtype == (torch.int16 if "wav" in variant else torch.bfloat16)
    assert [a.dtype for a in args[:2] + args[4:]] == [torch.int64] * 4
    _, mt = training.make_train_step(tcfg, model)(state, *args)
    for k in ("loss", "mel_loss", "linear_loss", "grad_norm"):
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-4, err_msg=k)


def test_train_loop_with_grain_workers(corpus):
    # two loop steps fed by two worker processes through the entry point:
    # the same losses as the Feeder's in-process run (same batches, same
    # weights), a checkpoint at 2
    base = os.path.dirname(corpus)
    ov = OV + ",model.max_iters=8,train.checkpoint_interval=100"
    cfg, _ = _cfgs("model.max_iters=8,train.checkpoint_interval=100")
    train_loop.train(os.path.join(base, "logs-feeder"), corpus, cfg, max_steps=2,
                     device="cpu")
    out = train_main.main(["--base_dir", base, "--preset", "tiny", "--name", "grain",
                           "--max_steps", "2", "--device", "cpu", "--hparams", ov,
                           "--pipeline", "grain", "--pipeline_workers", "2"])
    assert out["step"] == 2
    losses = {}
    for name in ("feeder", "grain"):
        log_dir = os.path.join(base, f"logs-{name}")
        assert CheckpointManager(os.path.join(log_dir, "checkpoints")).steps() == [2]
        with open(os.path.join(log_dir, "metrics.jsonl")) as f:
            losses[name] = [json.loads(line)["loss"] for line in f]
    assert len(losses["grain"]) == 2 and all(np.isfinite(losses["grain"]))
    np.testing.assert_allclose(losses["grain"], losses["feeder"], rtol=1e-6)
    with pytest.raises(ValueError, match="feeder"):
        train_loop.train(os.path.join(base, "logs-x"), corpus, cfg, pipeline="tf",
                         device="cpu")


def test_prefetch_close_stops_the_thread_and_closes_the_source():
    class Source:
        closed = False

        def __init__(self):
            self.n = 0

        def __iter__(self):
            return self

        def __next__(self):
            self.n += 1
            return self.n

        def close(self):
            Source.closed = True

    it = feeder.PrefetchIterator(Source(), prefetch=1)
    assert [next(it) for _ in range(3)] == [1, 2, 3]
    it.close(timeout=10)
    assert not it._thread.is_alive() and Source.closed
