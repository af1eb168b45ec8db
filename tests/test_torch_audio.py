"""The port's synthesis DSP against the JAX package's (audio/dsp.py,
AudioProcessor), on the same numpy inputs, float32, CPU.

Griffin-Lim draws random initial phases; the JAX package draws them as
``jax.random.uniform(key, [B, frames, bins], -pi, pi)`` (dsp.py:667-668), so
the tests draw exactly that and hand it to the port.
"""

import io
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron_multispeaker_tpu.audio import AudioProcessor as JAudioProcessor
from tacotron_multispeaker_tpu.audio import dsp as jdsp
from tacotron_multispeaker_tpu.config import AudioConfig as JAudioConfig
from tacotron_multispeaker_torch.audio import AudioProcessor
from tacotron_multispeaker_torch.audio import dsp as tdsp
from tacotron_multispeaker_torch.config import AudioConfig


@pytest.fixture(scope="module", autouse=True)
def _warm_cpu_math():
    # a fresh process's first f32 transcendentals on several threads can
    # come back at ~1e-4 relative error (device.warm_cpu_math)
    from tacotron_multispeaker_torch.device import warm_cpu_math
    warm_cpu_math()


def _angles(key, B, F, bins):
    return np.array(jax.random.uniform(key, (B, F, bins), minval=-math.pi,
                                       maxval=math.pi))


@pytest.mark.parametrize("n_fft,win", [
    (1024, 1024),   # full-frame layout (the tiny preset: win_length == n_fft)
    (2048, 1102),   # window-support layout (multispeaker_vctk at 22.05 kHz)
])
def test_griffin_lim_matches_with_the_same_initial_angles(n_fft, win):
    # f32 DFT matmuls (n_fft-term sums) on both sides; the magnitude
    # projection divides by |spectrum|, which amplifies round-off in quiet
    # bins a little -> 1e-4 of the signal's peak
    rs = np.random.RandomState(n_fft)
    B, F, hop = 2, 12, 275
    bins = n_fft // 2 + 1
    mag = rs.uniform(0.0, 2.0, (B, bins, F)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jp = jdsp.STFTParams(n_fft, hop, win)
    y_j = np.asarray(jax.jit(lambda m, k: jdsp.griffin_lim(
        m, jp, 4, k, method="dft_f32", momentum=0.99))(jnp.asarray(mag), key))
    y_t = tdsp.griffin_lim(torch.from_numpy(mag), tdsp.STFTParams(n_fft, hop, win), 4,
                           method="dft_f32", momentum=0.99,
                           angles=torch.from_numpy(_angles(key, B, F, bins))).numpy()
    assert y_t.shape == y_j.shape == (B, hop * (F - 1))
    np.testing.assert_allclose(y_t, y_j, atol=1e-4 * np.abs(y_j).max())


def test_inv_preemphasis_doubling_scan():
    # log-depth doubling vs JAX's associative scan: both are exact in real
    # arithmetic; f32 partial sums of up to ~1/(1-0.97) = 33x the input
    y = np.random.RandomState(0).randn(2, 5003).astype(np.float32)
    x_j = np.asarray(jax.jit(lambda v: jdsp.inv_preemphasis(v, 0.97))(y))
    x_t = tdsp.inv_preemphasis(torch.from_numpy(y), 0.97).numpy()
    np.testing.assert_allclose(x_t, x_j, atol=5e-5 * np.abs(x_j).max())
    # the recurrence itself: x[t] = y[t] + c x[t-1]
    np.testing.assert_allclose(x_t[:, 1:] - 0.97 * x_t[:, :-1], y[:, 1:], atol=1e-4)


def test_inv_linear_spectrogram():
    rs = np.random.RandomState(1)
    cfg = JAudioConfig(num_freq=513, sample_rate=22050)
    jp = jdsp.STFTParams.from_config(cfg)
    B, F, bins = 2, 10, 513
    spec = rs.uniform(0.0, 1.0, (B, bins, F)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    kw = dict(preemph=0.97, ref_level_db=20.0, min_level_db=-100.0, power=1.5,
              gl_iters=3, gl_method="dft_f32", gl_momentum=0.99)
    y_j = np.asarray(jax.jit(lambda s, k: jdsp.inv_linear_spectrogram(
        s, jp, key=k, **kw))(jnp.asarray(spec), key))
    y_t = tdsp.inv_linear_spectrogram(
        torch.from_numpy(spec), tdsp.STFTParams(*jp), **kw,
        angles=torch.from_numpy(_angles(key, B, F, bins))).numpy()
    np.testing.assert_allclose(y_t, y_j, atol=1e-4 * np.abs(y_j).max())


def test_find_endpoint_and_wav_bytes():
    rs = np.random.RandomState(2)
    sr = 22050
    wav = np.concatenate([rs.randn(sr) * 0.3, rs.randn(2 * sr) * 1e-4,
                          rs.randn(sr // 2) * 0.3]).astype(np.float32)
    jap = JAudioProcessor(JAudioConfig(sample_rate=sr))
    tap = AudioProcessor(AudioConfig(sample_rate=sr), device="cpu")
    end = tap.find_endpoint(wav)
    assert end == jap.find_endpoint(wav)
    assert sr <= end < 3 * sr
    assert tap.find_endpoint(wav[:sr]) == jap.find_endpoint(wav[:sr]) == sr
    assert tap.wav_bytes(wav) == jap.wav_bytes(wav)
    from scipy.io import wavfile
    rate, pcm = wavfile.read(io.BytesIO(tap.wav_bytes(wav)))
    assert rate == sr and pcm.dtype == np.int16 and pcm.shape == wav.shape


def test_audio_processor_inv_spectrogram_and_helpers():
    cfg_kw = dict(num_freq=513, sample_rate=22050, griffin_lim_iters=3,
                  gl_method="dft_f32")
    jap = JAudioProcessor(JAudioConfig(**cfg_kw))
    tap = AudioProcessor(AudioConfig(**cfg_kw), device="cpu")
    spec = np.random.RandomState(4).uniform(0, 1, (513, 9)).astype(np.float32)
    y_j = jap.inv_spectrogram(spec, seed=5)
    angles = _angles(jax.random.PRNGKey(5), 1, 9, 513)[0]
    y_t = tap.inv_spectrogram(spec, seed=5, angles=angles)
    np.testing.assert_allclose(y_t, y_j, atol=1e-4 * np.abs(y_j).max())
    np.testing.assert_array_equal(tdsp.mel_basis(22050, 2048, 80),
                                  jdsp.mel_basis(22050, 2048, 80))
    x = np.linspace(-120, 10, 50).astype(np.float32)
    np.testing.assert_allclose(tdsp.db_to_amp(torch.from_numpy(x)).numpy(),
                               np.asarray(jdsp.db_to_amp(jnp.asarray(x))), rtol=1e-6)
    np.testing.assert_allclose(
        tdsp.normalize_db(tdsp.amp_to_db(torch.from_numpy(np.abs(x))), -100.0).numpy(),
        np.asarray(jdsp.normalize_db(jdsp.amp_to_db(jnp.abs(jnp.asarray(x))), -100.0)),
        atol=1e-6)
    np.testing.assert_allclose(
        tdsp.denormalize_db(torch.from_numpy(x / 100), -100.0).numpy(),
        np.asarray(jdsp.denormalize_db(jnp.asarray(x / 100), -100.0)), atol=1e-5)


def test_unported_griffin_lim_methods_raise():
    # every method of the JAX package is ported; a name outside them raises
    mag = torch.ones(1, 513, 4)
    for method in ("wavelet_f32", "dft_f16", "ct", "fft_f32"):
        with pytest.raises(ValueError, match="Griffin-Lim method"):
            tdsp.griffin_lim(mag, tdsp.STFTParams(1024, 275, 1024), 2, method=method)


@pytest.mark.parametrize("method", ["dft_mix", "dft_bf16", "dft_f32", "dft_hi"])
def test_griffin_lim_use_pallas_matches_jax(method):
    # parallel.use_pallas, win_length < n_fft: the JAX package's kernels in
    # interpret mode (the fused fast-iteration kernel for mix/bf16, the OLA
    # kernel for f32/hi) against the port's plain versions, with the same
    # initial angles.  mix/bf16 take the full-frame layout on both sides.
    # f32/hi: JAX takes the full-frame layout, the port the window support
    # (the synthesis window folded into the inverse matrices, the OLA
    # prewindowed): the same sums up to their order, since the dropped
    # columns multiply zeros; f32 products on both sides (JAX's HIGH is f32
    # on the CPU) -> 1e-4 of the peak, as above.  mix/bf16:
    # both round at the same points, but a sum-order difference flips bf16
    # roundings that the phase estimate carries chaotically where |S| ~ 0:
    # mean error 1e-2 of the peak, worst sample 5e-2 (measured 3e-3 and
    # 1.7e-2; the JAX kernel and the JAX plain bf16 loop differ by 1.7e-2
    # in the mean at this geometry)
    rs = np.random.RandomState(11)
    B, F, n_fft, hop, win = 2, 10, 256, 64, 200
    bins = n_fft // 2 + 1
    mag = rs.uniform(0.0, 2.0, (B, bins, F)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    jp = jdsp.STFTParams(n_fft, hop, win)
    y_j = np.asarray(jdsp.griffin_lim(jnp.asarray(mag), jp, 6, key, use_pallas=True,
                                      method=method, momentum=0.99))
    y_t = tdsp.griffin_lim(torch.from_numpy(mag), tdsp.STFTParams(n_fft, hop, win), 6,
                           method=method, momentum=0.99, use_pallas=True,
                           angles=torch.from_numpy(_angles(key, B, F, bins))).numpy()
    assert y_t.shape == y_j.shape == (B, hop * (F - 1))
    peak = np.abs(y_j).max()
    err = np.abs(y_t - y_j)
    if method in ("dft_f32", "dft_hi"):
        assert err.max() <= 1e-4 * peak
    else:
        assert err.mean() <= 1e-2 * peak and err.max() <= 5e-2 * peak, err.max() / peak


@pytest.mark.parametrize("method", ["dft_f32", "dft_hi"])
def test_griffin_lim_use_pallas_matches_jax_window_support(method):
    # the port under use_pallas keeps the window-support layout that the
    # JAX package takes without it: the same products and the same
    # static-shift overlap-add (the OLA kernel's plain version, prewindowed,
    # against JAX's prewindowed reference), both f32; only the matmuls' sum
    # orders differ (measured 1.5e-6 of the peak) -> 1e-5 of the peak
    rs = np.random.RandomState(11)
    B, F, n_fft, hop, win = 2, 10, 256, 64, 200
    bins = n_fft // 2 + 1
    mag = rs.uniform(0.0, 2.0, (B, bins, F)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    jp = jdsp.STFTParams(n_fft, hop, win)
    y_j = np.asarray(jdsp.griffin_lim(jnp.asarray(mag), jp, 6, key, use_pallas=False,
                                      method=method, momentum=0.99))
    y_t = tdsp.griffin_lim(torch.from_numpy(mag), tdsp.STFTParams(n_fft, hop, win), 6,
                           method=method, momentum=0.99, use_pallas=True,
                           angles=torch.from_numpy(_angles(key, B, F, bins))).numpy()
    assert y_t.shape == y_j.shape == (B, hop * (F - 1))
    assert np.abs(y_t - y_j).max() <= 1e-5 * np.abs(y_j).max()


@pytest.mark.parametrize("method,win,ola,gl", [
    # window support: every overlap-add (5 iterations + the initial one)
    # through the OLA kernel, win_length wide and prewindowed
    ("dft_f32", 200, [(200, True)] * 6, []),
    ("dft_hi", 200, [(200, True)] * 6, []),
    # win_length == n_fft: the full frame, windowed in the kernel
    ("dft_f32", 256, [(256, False)] * 6, []),
    # the fused fast iterations take n_fft frames; their overlap-adds and
    # the mix polish stay plain
    ("dft_mix", 200, [], [256]),
    ("dft_bf16", 200, [], [256]),
])
def test_griffin_lim_use_pallas_routes_its_layouts(monkeypatch, method, win, ola, gl):
    calls = {"ola": [], "gl": []}
    real_ola, real_gl = tdsp.ola_ops.overlap_add, tdsp.gl_ops.gl_fast_iterations

    def spy_ola(frames, window, hop, prewindowed=False):
        assert window.shape == (frames.shape[-1],)
        calls["ola"].append((frames.shape[-1], prewindowed))
        return real_ola(frames, window, hop, prewindowed=prewindowed)

    def spy_gl(wf0, *args):
        calls["gl"].append(wf0.shape[-1])
        return real_gl(wf0, *args)

    monkeypatch.setattr(tdsp.ola_ops, "overlap_add", spy_ola)
    monkeypatch.setattr(tdsp.gl_ops, "gl_fast_iterations", spy_gl)
    mag = torch.from_numpy(np.random.RandomState(2).uniform(0.0, 2.0, (1, 129, 6))
                           .astype(np.float32))
    y = tdsp.griffin_lim(mag, tdsp.STFTParams(256, 64, win), 5, method=method,
                         momentum=0.99, use_pallas=True, generator=torch.Generator().manual_seed(0))
    assert y.shape == (1, 64 * 5) and torch.isfinite(y).all()
    assert calls == {"ola": ola, "gl": gl}


@pytest.mark.parametrize("use_pallas", [False, True])
def test_istft_matches_jax(use_pallas):
    # irfft frames and the windowed overlap-add (the JAX OLA kernel in
    # interpret mode under use_pallas, the port's plain version of kernel 12
    # on the CPU), f32 -> 1e-6 of the peak; with and without ``length``
    rs = np.random.RandomState(12)
    B, F, n_fft, hop, win = 2, 10, 256, 64, 200
    spec = (rs.randn(B, n_fft // 2 + 1, F) + 1j * rs.randn(B, n_fft // 2 + 1, F)
            ).astype(np.complex64)
    jp, tp = jdsp.STFTParams(n_fft, hop, win), tdsp.STFTParams(n_fft, hop, win)
    for length in (None, 300):
        y_j = np.asarray(jdsp.istft(jnp.asarray(spec), jp, length=length,
                                    use_pallas=use_pallas))
        y_t = tdsp.istft(torch.from_numpy(spec), tp, length=length,
                         use_pallas=use_pallas).numpy()
        assert y_t.shape == y_j.shape == (B, length or hop * (F - 1))
        assert np.abs(y_t - y_j).max() <= 1e-6 * np.abs(y_j).max()


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("method", ["fft", "ct_f32", "ct_hi", "ct_bf16", "ct_mix"])
def test_griffin_lim_fft_and_ct_match_jax(method, use_pallas):
    # the same initial angles on both sides (``fft`` draws them in the
    # magnitude's [B, bins, frames] layout, the port takes [B, frames, bins]),
    # 6 fast-GL iterations at n_fft=256 (N1=16, N2=16) with win < n_fft: ct_*
    # keeps the full frame on both sides, its overlap-adds in the OLA kernel
    # under use_pallas.  fft (FFTs, f32): 3e-5 of the peak (measured 7.6e-6);
    # ct_f32 / ct_hi (f32 products both sides; JAX's HIGH is f32 on the CPU):
    # 1e-5 (measured 7.5e-7); ct_bf16 / ct_mix: bf16 rounding at the same
    # points, flipped where a sum order differs and carried chaotically where
    # |S| ~ 0, as for dft_bf16: mean 1e-2 and worst sample 5e-2 of the peak
    # (measured 2.4e-3 / 2.8e-2 at most)
    rs = np.random.RandomState(1)
    B, F, n_fft, hop, win = 2, 10, 256, 64, 200
    bins = n_fft // 2 + 1
    mag = rs.uniform(0.0, 2.0, (B, bins, F)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jp = jdsp.STFTParams(n_fft, hop, win)
    y_j = np.asarray(jdsp.griffin_lim(jnp.asarray(mag), jp, 6, key, use_pallas=use_pallas,
                                      method=method, momentum=0.99))
    if method == "fft":
        angles = _angles(key, B, bins, F).transpose(0, 2, 1).copy()
    else:
        angles = _angles(key, B, F, bins)
    y_t = tdsp.griffin_lim(torch.from_numpy(mag), tdsp.STFTParams(n_fft, hop, win), 6,
                           method=method, momentum=0.99, use_pallas=use_pallas,
                           angles=torch.from_numpy(angles)).numpy()
    assert y_t.shape == y_j.shape == (B, hop * (F - 1))
    peak, err = np.abs(y_j).max(), np.abs(y_t - y_j)
    if method in ("ct_bf16", "ct_mix"):
        assert err.mean() <= 1e-2 * peak and err.max() <= 5e-2 * peak, err.max() / peak
    else:
        assert err.max() <= (3e-5 if method == "fft" else 1e-5) * peak, err.max() / peak


def test_ct_transforms_and_non_power_of_two_fallback():
    # the factorised rfft/irfft against torch.fft in f32 (1e-5 of the peak),
    # and ct_* on a non-power-of-two n_fft is dft_* exactly, as in JAX
    rs = np.random.RandomState(4)
    frames = torch.from_numpy(rs.randn(3, 5, 512).astype(np.float32))
    re, im = tdsp._dft_ct(frames, 512, torch.float32)
    ref = torch.fft.rfft(frames, dim=-1)
    assert (torch.stack([re, im]) - torch.stack([ref.real, ref.imag])).abs().max() \
        <= 1e-5 * ref.abs().max()
    back = tdsp._idft_ct(ref.real, ref.imag, 512, torch.float32)
    assert (back - frames).abs().max() <= 1e-5 * frames.abs().max()
    mag = torch.from_numpy(rs.uniform(0.0, 2.0, (1, 121, 6)).astype(np.float32))
    p = tdsp.STFTParams(240, 60, 200)
    a = torch.from_numpy(rs.uniform(-math.pi, math.pi, (1, 6, 121)).astype(np.float32))
    for prec in ("f32", "bf16"):
        assert torch.equal(tdsp.griffin_lim(mag, p, 3, method=f"ct_{prec}", angles=a),
                           tdsp.griffin_lim(mag, p, 3, method=f"dft_{prec}", angles=a))


@pytest.mark.parametrize("windowed", [True, False])
@pytest.mark.parametrize("n_fft,win", [(256, 200), (1024, 800), (2048, 1102)])
def test_griffin_lim_constants_carry_zero_bins_to_an_aligned_width(n_fft, win, windowed):
    # the dft_* products run at gl_bins: bins rounded up to 8 (16-byte bf16
    # rows); C and S gain zero columns and iC and iS zero rows, in both
    # layouts and both dtypes, and the bins they had are the DFT's unchanged
    bins = n_fft // 2 + 1
    width = tdsp.gl_bins(n_fft)
    assert width % 8 == 0 and bins <= width < bins + 8
    assert tdsp.gl_bins(n_fft, "dft_mix") == width
    assert tdsp.gl_bins(n_fft, "ct_f32") == tdsp.gl_bins(n_fft, "fft") == bins
    ref = (tdsp._dft_win_matrices(n_fft, win) if windowed else tdsp._dft_matrices(n_fft))
    for dtype in (torch.float32, torch.bfloat16):
        _, mats = tdsp._gl_constants(n_fft, win, torch.device("cpu"), dtype, windowed)
        C, S, iC, iS = mats
        rows = win if windowed else n_fft
        assert C.shape == S.shape == (rows, width) and iC.shape == iS.shape == (width, rows)
        for m, r in zip((C, S), ref[:2]):
            assert torch.equal(m[:, :bins], torch.from_numpy(r).to(dtype))
            assert not m[:, bins:].any()
        for m, r in zip((iC, iS), ref[2:]):
            assert torch.equal(m[:bins], torch.from_numpy(r).to(dtype))
            assert not m[bins:].any()
    # ct on a non-power-of-two n_fft runs dft_*, so it pads too
    assert tdsp.gl_bins(240, "ct_bf16") == tdsp.gl_bins(240) == 128


@pytest.mark.parametrize("method,use_pallas", [("dft_f32", False), ("dft_mix", False),
                                               ("dft_mix", True), ("ct_bf16", False)])
def test_griffin_lim_draws_its_initial_phases_at_frames_by_bins(method, use_pallas):
    # the padding comes after the draw: a generator gives the waveform of
    # the angles drawn from it at [B, frames, bins], bit for bit
    mag = torch.from_numpy(np.random.RandomState(5).uniform(0.0, 2.0, (2, 129, 7))
                           .astype(np.float32))
    p = tdsp.STFTParams(256, 64, 200)
    kw = dict(method=method, momentum=0.99, use_pallas=use_pallas)
    y_gen = tdsp.griffin_lim(mag, p, 4, torch.Generator().manual_seed(9), **kw)
    angles = (torch.rand((2, 7, 129), generator=torch.Generator().manual_seed(9))
              * (2.0 * math.pi) - math.pi)
    assert torch.equal(y_gen, tdsp.griffin_lim(mag, p, 4, angles=angles, **kw))


def test_spectrogram_targets_read_the_unpadded_window_support_dft():
    # the training targets keep n_fft//2 + 1 bins and the unpadded DFT
    # pair, bit for bit, with Griffin-Lim's padded constants built beside them
    rs = np.random.RandomState(6)
    p = tdsp.STFTParams(2048, 275, 1102)
    tdsp.griffin_lim(torch.ones(1, 1025, 3), p, 1, method="dft_bf16",
                     generator=torch.Generator().manual_seed(0))
    y = torch.from_numpy(rs.uniform(-0.5, 0.5, (2, 4000)).astype(np.float32))
    kw = dict(sample_rate=22050, num_mels=80, preemph=0.97, ref_level_db=20.0,
              min_level_db=-100.0)
    mel, lin = tdsp.spectrogram_targets(y, p, **kw)
    yp = torch.nn.functional.pad(tdsp.preemphasis(y, 0.97).reshape(1, 2, -1), (1024, 1024),
                                 mode="reflect").reshape(2, -1)
    frames = yp[:, 473:].unfold(-1, 1102, 275)[:, :1 + (yp.shape[-1] - 2048) // 275]
    Cw, Sw, _, _ = (torch.from_numpy(m) for m in tdsp._dft_win_matrices(2048, 1102))
    re, im = frames @ Cw, frames @ Sw
    mag = torch.sqrt(re * re + im * im)
    basis = torch.from_numpy(tdsp.mel_basis(22050, 2048, 80).T.copy())
    assert lin.shape == (2, frames.shape[1], 1025)
    assert torch.equal(lin, tdsp.normalize_db(tdsp.amp_to_db(mag) - 20.0, -100.0))
    assert torch.equal(mel, tdsp.normalize_db(tdsp.amp_to_db(mag @ basis) - 20.0, -100.0))
