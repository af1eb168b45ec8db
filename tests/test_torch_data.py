"""The port's data path against the JAX package's, on the CPU: the STFT
analysis side of the DSP, the AudioProcessor's features, preprocessing of a
synthetic corpus (both packages write it; the same ``train.txt``, features
within tolerance) and the bucketed Feeder (the same batch plan, array-equal
batches, cmudict substitutions included)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron_multispeaker_tpu import config as jconfig
from tacotron_multispeaker_tpu.audio import AudioProcessor as JAudioProcessor
from tacotron_multispeaker_tpu.audio import dsp as jdsp
from tacotron_multispeaker_tpu.data import feeder as jfeeder
from tacotron_multispeaker_tpu.data import preprocess as jprep
from tacotron_multispeaker_tpu.data import synthetic as jsynth
from tacotron_multispeaker_torch import config as tconfig
from tacotron_multispeaker_torch.audio import AudioProcessor, dsp
from tacotron_multispeaker_torch.data import feeder, preprocess, synthetic

DSP_KW = dict(preemph=0.97, ref_level_db=20.0, min_level_db=-100.0)
WORDS = ["THE", "QUICK", "BROWN", "FOX", "JUMPS", "OVER", "LAZY", "DOG", "PACK", "MY",
         "BOX", "WITH", "FIVE", "DOZEN", "LIQUOR", "JUGS", "HOW", "VEXINGLY", "DAFT",
         "ZEBRAS"]


@pytest.mark.parametrize("n_fft,hop,win", [(1024, 275, 1024), (2048, 275, 1102)])
def test_spectrograms_match_jax(n_fft, hop, win):
    # a seeded waveform (noise with a chirp): both sides compute f32 FFTs of
    # the same frames (pocketfft in another order), every bin well above the
    # -100 dB floor -> 1e-4 on the normalised features
    rs = np.random.RandomState(0)
    t = np.arange(6000) / 22050.0
    y = (0.3 * rs.randn(6000) + 0.5 * np.sin(2 * np.pi * (200 + 2000 * t) * t)).astype(np.float32)
    jp = jdsp.STFTParams(n_fft, hop, win)
    tp = dsp.STFTParams(n_fft, hop, win)
    lin_j = np.asarray(jdsp.linear_spectrogram(jnp.asarray(y), jp, **DSP_KW))
    lin_t = dsp.linear_spectrogram(torch.from_numpy(y), tp, **DSP_KW).numpy()
    mel_j = np.asarray(jdsp.mel_spectrogram(jnp.asarray(y), jp, sample_rate=22050,
                                            num_mels=80, **DSP_KW))
    mel_t = dsp.mel_spectrogram(torch.from_numpy(y), tp, sample_rate=22050, num_mels=80,
                                **DSP_KW).numpy()
    assert lin_t.shape == lin_j.shape == (n_fft // 2 + 1, 1 + 6000 // hop)
    assert mel_t.shape == mel_j.shape == (80, 1 + 6000 // hop)
    np.testing.assert_allclose(lin_t, lin_j, atol=1e-4)
    np.testing.assert_allclose(mel_t, mel_j, atol=1e-4)
    # framing and the complex STFT itself: 1e-6 of the peak magnitude
    spec_j = np.asarray(jdsp.stft(jnp.asarray(y), jp))
    spec_t = dsp.stft(torch.from_numpy(y), tp).numpy()
    np.testing.assert_allclose(spec_t, spec_j, atol=1e-6 * np.abs(spec_j).max())
    np.testing.assert_array_equal(dsp.preemphasis(torch.from_numpy(y), 0.97).numpy(),
                                  np.asarray(jdsp.preemphasis(jnp.asarray(y), 0.97)))


def test_audio_processor_analysis_matches_jax(tmp_path):
    cfg = "multispeaker_vctk"
    jap = JAudioProcessor(jconfig.get_config(cfg).audio)
    ap = AudioProcessor(tconfig.get_config(cfg).audio, device="cpu")
    wav = synthetic.synth_utterance("pack my box", 5, 22050)
    path = str(tmp_path / "u.wav")
    jap.save_wav(wav, path)
    y_t, y_j = ap.load_wav(path), jap.load_wav(path)
    np.testing.assert_array_equal(y_t, y_j)
    _check_features(ap.melspectrogram(y_t), jap.melspectrogram(y_j), quiet_atol=1e-4)
    _check_features(ap.spectrogram(y_t), jap.spectrogram(y_j), quiet_atol=5e-3)
    with pytest.raises(ValueError, match="sample rate"):
        AudioProcessor(tconfig.get_config("single_speaker").audio, device="cpu").load_wav(path)


def _check_features(a, b, quiet_atol):
    """Features of a tone signal with silent stretches: 1e-4 where they lie
    above -70 dB (normalised >= 0.3); below, the dB scale turns the FFTs'
    f32 rounding (~1e-7 of the peak magnitude on both sides, in other sum
    orders) into larger differences near the floor -> ``quiet_atol``.  The
    largest differences on the quiet bins of this file's inputs (CPU, both
    tests): linear 2.94e-3 -> 5e-3; mel 2.06e-5 (the mel filters average
    the quiet bins), so mel holds 1e-4 everywhere."""
    assert a.shape == b.shape
    loud = b >= 0.3
    assert loud.mean() > 0.05
    np.testing.assert_allclose(a[loud], b[loud], atol=1e-4)
    np.testing.assert_allclose(a, b, atol=quiet_atol)


TINY = "model.num_speakers=3,train.batch_size=2,train.batches_per_group=2"


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """A 6-utterance synthetic corpus (3 speakers) preprocessed by both
    packages, with the int16 PCM kept: (port cfg, JAX cfg, port dir, JAX dir)."""
    base = tmp_path_factory.mktemp("corpora")
    tcfg, jcfg = tconfig.get_config("tiny", TINY), jconfig.get_config("tiny", TINY)
    raw_t = synthetic.make_corpus(str(base / "raw_t"), n_utts=6, n_speakers=3,
                                  sample_rate=22050, seed=3)
    raw_j = jsynth.make_corpus(str(base / "raw_j"), n_utts=6, n_speakers=3,
                               sample_rate=22050, seed=3)
    for name in ["metadata.csv"] + [f"wavs/utt{i:04d}.wav" for i in range(6)]:
        assert open(os.path.join(raw_t, name), "rb").read() == \
            open(os.path.join(raw_j, name), "rb").read(), name
    out_t, out_j = str(base / "port"), str(base / "jax")
    preprocess.write_metadata(preprocess.CORPORA["generic"](
        raw_t, out_t, tcfg.audio, keep_wavs=True, device="cpu"), out_t, tcfg.audio)
    jprep.write_metadata(jprep.CORPORA["generic"](
        raw_j, out_j, jcfg.audio, num_workers=1, keep_wavs=True), out_j, jcfg.audio)
    return tcfg, jcfg, out_t, out_j


def test_preprocess_matches_jax(corpora):
    _, _, out_t, out_j = corpora
    txt = lambda d: open(os.path.join(d, "train.txt"), "rb").read()
    assert txt(out_t) == txt(out_j)
    rows = preprocess.load_metadata(os.path.join(out_t, "train.txt"))
    assert rows == jprep.load_metadata(os.path.join(out_j, "train.txt"))
    assert len(rows) == 6 and {r["speaker_id"] for r in rows} == {0, 1, 2}
    for r in rows:
        load = lambda d, f: np.load(os.path.join(d, f))
        mel_t, mel_j = load(out_t, r["mel_file"]), load(out_j, r["mel_file"])
        assert mel_t.dtype == np.float32 and mel_t.flags.c_contiguous
        assert mel_t.shape == (r["n_frames"], 80)
        _check_features(mel_t, mel_j, quiet_atol=1e-4)
        _check_features(load(out_t, r["linear_file"]), load(out_j, r["linear_file"]),
                        quiet_atol=5e-3)
        wav = preprocess.wav_file_for(r)
        np.testing.assert_array_equal(load(out_t, wav), load(out_j, wav))


def test_preprocess_workers_need_the_cpu_asked_for(corpora, tmp_path):
    tcfg, _, _, _ = corpora
    raw = synthetic.make_corpus(str(tmp_path / "raw"), n_utts=2, sample_rate=22050)
    with pytest.raises(ValueError, match="device='cpu'"):
        preprocess.CORPORA["generic"](raw, str(tmp_path / "out"), tcfg.audio, num_workers=2,
                                      device="meta")
    # spawned CPU workers write what one process writes
    rows = preprocess.CORPORA["generic"](raw, str(tmp_path / "w2"), tcfg.audio, num_workers=2,
                                         device="cpu")
    rows1 = preprocess.CORPORA["generic"](raw, str(tmp_path / "w1"), tcfg.audio, device="cpu")
    assert rows == rows1
    for r in rows:
        np.testing.assert_array_equal(np.load(str(tmp_path / "w2" / r[1])),
                                      np.load(str(tmp_path / "w1" / r[1])))


@pytest.mark.parametrize("cmudict", [False, True])
def test_feeder_matches_jax(corpora, tmp_path, cmudict):
    # the same corpus read by both feeders: the epoch plans are identical
    # and the batches array-equal (cmudict substitutions drawn alike)
    tcfg, jcfg, _, out_j = corpora
    path = None
    if cmudict:
        path = str(tmp_path / "cmudict")
        open(path, "w").write("".join(f"{w}  HH AH0 L OW1\n" for w in WORDS))
        tcfg = dataclasses.replace(tcfg, train=dataclasses.replace(tcfg.train, cmudict_prob=0.5))
        jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, cmudict_prob=0.5))
    tf = feeder.Feeder(out_j, tcfg, cmudict_path=path)
    jf = jfeeder.Feeder(out_j, jcfg, cmudict_path=path, use_native=False,
                        process_index=0, process_count=1)
    assert tf.boundaries == jf.boundaries and len(tf) == len(jf) == 6
    fired = False
    for epoch in (0, 1):
        plan = tf.epoch_plan(epoch)
        assert plan == jf.epoch_plan(epoch) and len(plan) == 3
        for entry in plan:
            bt, bj = tf.materialize(entry), jf.materialize(entry)
            for name in ("inputs", "input_lengths", "mel_targets", "linear_targets",
                         "target_lengths", "speaker_ids"):
                a, b = getattr(bt, name), getattr(bj, name)
                assert a.dtype == b.dtype, name
                np.testing.assert_array_equal(a, b, err_msg=name)
            plain = tf._make_batch([tf.meta[i] for i in entry[2]], [None] * 2,
                                   L=entry[3], T=entry[4])
            fired |= not np.array_equal(plain.inputs, bt.inputs)
    assert fired == cmudict
    # two processes each take their half of every global batch
    halves = [feeder.Feeder(out_j, tcfg, cmudict_path=path, process_index=i,
                            process_count=2).materialize(tf.epoch_plan(0)[0]) for i in (0, 1)]
    np.testing.assert_array_equal(np.concatenate([h.inputs for h in halves]),
                                  tf.materialize(tf.epoch_plan(0)[0]).inputs)


def test_feeder_helpers_and_unported_options(corpora):
    tcfg, _, out_t, _ = corpora
    x = np.arange(6).reshape(3, 2)
    for length in (2, 3, 5):
        np.testing.assert_array_equal(feeder.pad_axis(x, length), jfeeder.pad_axis(x, length))
    for n in (1, 100, 101, 250):
        assert feeder.pick_bucket(n, (100, 200)) == jfeeder.pick_bucket(n, (100, 200))
    with pytest.raises(ValueError, match="targets_dtype"):
        feeder.Feeder(out_t, tconfig.get_config("tiny", f"{TINY},train.targets_dtype=float16"))
    with pytest.raises(ValueError, match="process_count"):
        feeder.Feeder(out_t, tcfg, process_index=0, process_count=3)
    # the prefetch thread hands batches over in order and re-raises its error
    f = feeder.Feeder(out_t, tcfg)
    got = list(feeder.PrefetchIterator(f.epoch_batches(0), prefetch=2))
    want = list(f.epoch_batches(0))
    assert len(got) == len(want) == 3
    assert all(np.array_equal(a.mel_targets, b.mel_targets) for a, b in zip(got, want))

    def broken():
        yield want[0]
        raise OSError("disk gone")
    it = feeder.PrefetchIterator(broken(), prefetch=1)
    assert next(it) is want[0]
    with pytest.raises(OSError, match="disk gone"):
        next(it)
