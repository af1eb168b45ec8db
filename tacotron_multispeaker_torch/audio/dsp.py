"""Audio DSP: STFT analysis (spectrogram features), dB helpers, inverse
preemphasis, Griffin-Lim.

Port of ``tacotron_multispeaker_tpu/audio/dsp.py`` (librosa conventions:
centered frames with reflect padding, periodic Hann window zero-padded to
``n_fft``, Slaney mel).  The analysis side (``preemphasis``,
``frame_signal``, ``stft``, ``linear_spectrogram``, ``mel_spectrogram``)
featurises corpora for training; its FFT is ``torch.fft.rfft``, where the
JAX package calls ``jnp.fft.rfft``.  ``spectrogram_targets`` derives the
same targets inside the train step (``train.targets_from_wav``) from the
window-support DFT as two f32 products.  Griffin-Lim
runs as DFT matrix products (methods
``dft_{f32,hi,bf16,mix}``) in either layout the JAX package uses:

* full-frame (``win_length == n_fft``, e.g. the ``tiny`` preset): frames
  of n_fft samples, windowed on both sides of the transform;
* window-support (``win_length < n_fft``, e.g. 2048/1102): only the window
  support is carried, the analysis window is folded into the forward DFT
  matrices and the synthesis window into the inverse ones (exact: the
  dropped columns multiply zeros).

The ``dft_*`` library products carry the spectrum at :func:`gl_bins`, the
n_fft//2 + 1 bins rounded up to a multiple of 8 (1,032 for n_fft 2048): at
1,025 bins no bf16 row of the spectra or the DFT matrices is a multiple of
16 bytes, and cuBLAS then runs its slow kernels for misaligned operands.
The padded bins are exact zeros throughout (zero magnitude, so a zero
scale), so every product computes the same sums.  The initial phases, the
fused kernel's input and outputs, ``ct_*``, ``fft`` and
``spectrogram_targets`` keep n_fft//2 + 1 bins.

``use_pallas`` (the JAX package's ``parallel.use_pallas``) routes as the
JAX package does: ``dft_bf16`` and ``dft_mix`` run their fast bf16
iterations through the Griffin-Lim kernel (ops/gl_iteration.py), which takes
n_fft-sample frames, so they keep the full-frame layout and the plain
overlap-adds; ``dft_f32`` and ``dft_hi`` run every overlap-add through the
OLA kernel (ops/overlap_add.py).  Unlike the JAX package, which takes the
full-frame layout for all four, they keep the window-support layout, and the
kernel takes the frames prewindowed: the same sums up to their order.

The ``ct_{f32,hi,bf16,mix}`` methods factor the DFT as n_fft = N1·N2
two-stage products (Cooley-Tukey, the JAX package's TPU factorisation),
always in the full-frame layout, their overlap-adds through the OLA kernel
under ``use_pallas``; a non-power-of-two n_fft falls back to ``dft_*``, as
in the JAX package.  ``fft`` is the classic formulation over
:func:`stft` / :func:`istft` (``torch.fft``), whose overlap-add takes the
OLA kernel under ``use_pallas``.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops import gl_iteration as gl_ops
from ..ops import overlap_add as ola_ops
from ..ops.overlap_add import overlap_add_reference


class STFTParams(NamedTuple):
    n_fft: int
    hop_length: int
    win_length: int

    @classmethod
    def from_config(cls, audio_cfg) -> "STFTParams":
        return cls(audio_cfg.n_fft, audio_cfg.hop_length, audio_cfg.win_length)


def hann_window(win_length: int, n_fft: int) -> np.ndarray:
    """Periodic Hann window of ``win_length``, centered in ``n_fft`` zeros."""
    n = np.arange(win_length)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    pad = n_fft - win_length
    lpad = pad // 2
    return np.pad(w, (lpad, pad - lpad)).astype(np.float32)


# ----------------------------------------------------------------------------
# Mel filterbank (librosa-compatible Slaney mel, Slaney norm)
# ----------------------------------------------------------------------------

def _hz_to_mel(freq: np.ndarray) -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = freq >= min_log_hz
    return np.where(log_t, min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz)
                    / logstep, mels)


def _mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = mels >= min_log_mel
    return np.where(log_t, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


@functools.lru_cache(maxsize=8)
def mel_basis(sample_rate: int, n_fft: int, num_mels: int,
              fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """[num_mels, n_fft//2+1] Slaney-normalized triangular mel filterbank."""
    if fmax is None:
        fmax = sample_rate / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_pts = np.linspace(_hz_to_mel(np.array(fmin)), _hz_to_mel(np.array(fmax)),
                          num_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2: num_mels + 2] - hz_pts[:num_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


# ----------------------------------------------------------------------------
# Preemphasis and dB / normalization helpers
# ----------------------------------------------------------------------------

def preemphasis(x: torch.Tensor, coef: float) -> torch.Tensor:
    """y[t] = x[t] - coef * x[t-1] (reference: lfilter([1, -coef], [1], x))."""
    return torch.cat([x[..., :1], x[..., 1:] - coef * x[..., :-1]], dim=-1)


def inv_preemphasis(y: torch.Tensor, coef: float) -> torch.Tensor:
    """Inverse IIR x[t] = y[t] + coef·x[t−1] as a log-depth doubling scan:
    after the step with shift s, x[t] = Σ_{j<2s} coef^j·y[t−j]; each step
    adds coef^s·x[t−s] and squares the coefficient (~log2(T) elementwise
    passes instead of a loop over samples)."""
    if coef == 0.0:
        return y
    x = y
    shift, c = 1, float(coef)
    while shift < x.shape[-1] and np.float32(c) != 0.0:
        x = torch.cat([x[..., :shift], x[..., shift:] + c * x[..., :-shift]], dim=-1)
        shift, c = 2 * shift, c * c
    return x


def amp_to_db(x: torch.Tensor) -> torch.Tensor:
    return 20.0 * torch.log10(torch.clamp(x, min=1e-5))


def db_to_amp(x: torch.Tensor) -> torch.Tensor:
    return torch.pow(10.0, x * 0.05)


def normalize_db(s: torch.Tensor, min_level_db: float) -> torch.Tensor:
    return torch.clamp((s - min_level_db) / -min_level_db, 0.0, 1.0)


def denormalize_db(s: torch.Tensor, min_level_db: float) -> torch.Tensor:
    return (torch.clamp(s, 0.0, 1.0) * -min_level_db) + min_level_db


_inv_mel_bases: dict = {}


def inv_mel_basis(sample_rate: int, n_fft: int, num_mels: int, device) -> torch.Tensor:
    """[num_mels, n_fft//2+1] f32 on ``device``: the transpose of the mel
    basis's pseudo-inverse (numpy's ``pinv`` in float64), built once a
    device."""
    key = (sample_rate, n_fft, num_mels, torch.device(device))
    if key not in _inv_mel_bases:
        pinv = np.linalg.pinv(mel_basis(sample_rate, n_fft, num_mels).astype(np.float64))
        _inv_mel_bases[key] = torch.as_tensor(pinv.T.astype(np.float32), device=device)
    return _inv_mel_bases[key]


def mel_to_linear(mel: torch.Tensor, *, sample_rate: int, n_fft: int,
                  ref_level_db: float, min_level_db: float) -> torch.Tensor:
    """Normalised mel [..., frames, num_mels] → the normalised linear
    spectrogram [..., frames, bins] that :func:`inv_linear_spectrogram`
    reads: denormalised, dB to amplitude, through the mel basis's
    pseudo-inverse, clamped at 1e-10, and back to the normalised dB domain
    (Real-Time-Voice-Cloning's ``inv_mel_spectrogram``, before its
    Griffin-Lim).  f32 products."""
    amp = db_to_amp(denormalize_db(mel.float(), min_level_db) + ref_level_db)
    basis = inv_mel_basis(sample_rate, n_fft, mel.shape[-1], mel.device)
    linear = torch.clamp(amp @ basis, min=1e-10)
    return normalize_db(amp_to_db(linear) - ref_level_db, min_level_db)


# ----------------------------------------------------------------------------
# STFT analysis and spectrogram features
# ----------------------------------------------------------------------------

def _frame_rows(z: torch.Tensor, width: int, hop: int, n_frames: int) -> torch.Tensor:
    """[..., S] -> [..., n_frames, width] where frame k = z[k·hop : k·hop+width]:
    z viewed as hop-sized rows, each frame the concat of ⌈width/hop⌉
    consecutive rows."""
    m = -(-width // hop)
    Q = n_frames + m                       # rows covering the last frame (with slack)
    tail = Q * hop - z.shape[-1]
    if tail > 0:
        z = torch.nn.functional.pad(z, (0, tail))
    rows = z[..., : Q * hop].reshape(*z.shape[:-1], Q, hop)
    frames = torch.cat([rows[..., i: i + n_frames, :] for i in range(m)], dim=-1)
    return frames[..., :width]


def frame_signal(y: torch.Tensor, params: STFTParams) -> torch.Tensor:
    """Centered framing with reflect padding: [..., T] -> [..., frames, n_fft]."""
    n_fft, hop = params.n_fft, params.hop_length
    pad = n_fft // 2
    lead = y.shape[:-1]
    y = torch.nn.functional.pad(y.reshape(1, -1, y.shape[-1]), (pad, pad), mode="reflect")
    y = y.reshape(*lead, y.shape[-1])
    n_frames = 1 + (y.shape[-1] - n_fft) // hop
    return _frame_rows(y, n_fft, hop, n_frames)


def stft(y: torch.Tensor, params: STFTParams) -> torch.Tensor:
    """Complex STFT: [..., T] -> [..., n_fft//2+1, frames] (librosa layout)."""
    window = torch.from_numpy(hann_window(params.win_length, params.n_fft)).to(y.device)
    frames = frame_signal(y, params) * window
    return torch.fft.rfft(frames, n=params.n_fft, dim=-1).transpose(-1, -2)


def istft(spec: torch.Tensor, params: STFTParams, length: int | None = None,
          use_pallas: bool = False) -> torch.Tensor:
    """Inverse STFT by windowed overlap-add: complex [..., bins, frames] ->
    [..., T] float32 (T = hop·(frames−1) unless ``length`` cuts it).
    ``use_pallas`` runs the overlap-add in the OLA kernel
    (ops/overlap_add.py) on a CUDA tensor; otherwise its plain version."""
    n_fft, hop = params.n_fft, params.hop_length
    window = torch.from_numpy(hann_window(params.win_length, n_fft)).to(spec.device)
    bins = spec.transpose(-1, -2).clone()
    # a real signal's DC and Nyquist bins are real; irfft libraries differ on
    # an imaginary part there (MKL and pocketfft drop it, cuFFT does not), so
    # it is dropped here: the same frames on every device
    bins[..., 0] = bins[..., 0].real
    if n_fft % 2 == 0:
        bins[..., -1] = bins[..., -1].real
    frames = torch.fft.irfft(bins, n=n_fft, dim=-1)
    n_frames = frames.shape[-2]
    out_len = n_fft + hop * (n_frames - 1)
    fb = frames.reshape(-1, n_frames, n_fft)
    if use_pallas:
        sig = ola_ops.overlap_add(fb, window, hop)
    else:
        sig = overlap_add_reference(fb, window, hop)
    sig = sig.reshape(*frames.shape[:-2], out_len)
    pad = n_fft // 2
    sig = sig[..., pad:]
    return sig[..., :length] if length is not None else sig[..., : out_len - 2 * pad]


def linear_spectrogram(y: torch.Tensor, params: STFTParams, *, preemph: float,
                       ref_level_db: float, min_level_db: float) -> torch.Tensor:
    """Waveform -> normalized linear spectrogram [..., bins, frames]."""
    d = stft(preemphasis(y, preemph), params)
    return normalize_db(amp_to_db(d.abs()) - ref_level_db, min_level_db)


def mel_spectrogram(y: torch.Tensor, params: STFTParams, *, sample_rate: int,
                    num_mels: int, preemph: float, ref_level_db: float,
                    min_level_db: float) -> torch.Tensor:
    """Waveform -> normalized mel spectrogram [..., num_mels, frames]."""
    d = stft(preemphasis(y, preemph), params)
    basis = torch.from_numpy(mel_basis(sample_rate, params.n_fft, num_mels)).to(y.device)
    mel = torch.einsum("mf,...ft->...mt", basis, d.abs())
    return normalize_db(amp_to_db(mel) - ref_level_db, min_level_db)


# ----------------------------------------------------------------------------
# DFT matrices
# ----------------------------------------------------------------------------

def _dft_matrices(n_fft: int):
    """(C, S, iC, iS) float32: ops/gl_iteration.py's ``dft_matrices``."""
    return tuple(a.astype(np.float32) for a in gl_ops.dft_matrices(n_fft))


@functools.lru_cache(maxsize=4)
def _dft_win_matrices(n_fft: int, win_length: int):
    """(Cw [win, bins], Sw [win, bins], iCw [bins, win], iSw [bins, win]):
    the forward pair has the analysis window folded into its rows, the
    inverse pair is the irfft sliced to the window support and multiplied
    by the synthesis window."""
    C, S, iC, iS = _dft_matrices(n_fft)
    lpad = (n_fft - win_length) // 2
    sl = slice(lpad, lpad + win_length)
    w = hann_window(win_length, n_fft)[sl]
    return ((w[:, None] * C[sl]).astype(np.float32),
            (w[:, None] * S[sl]).astype(np.float32),
            (iC[:, sl] * w[None, :]).astype(np.float32),
            (iS[:, sl] * w[None, :]).astype(np.float32))



@functools.lru_cache(maxsize=8)
def _targets_constants(n_fft: int, win_length: int, sample_rate: int, num_mels: int,
                       device: torch.device):
    """(Cw, Sw, mel basis transposed [bins, num_mels]) float32 on
    ``device``, built once."""
    Cw, Sw, _, _ = _dft_win_matrices(n_fft, win_length)
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return to_dev(Cw), to_dev(Sw), to_dev(mel_basis(sample_rate, n_fft, num_mels).T)


def spectrogram_targets(y: torch.Tensor, params: STFTParams, *, sample_rate: int,
                        num_mels: int, preemph: float, ref_level_db: float,
                        min_level_db: float, n_frames: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Waveform [..., S] -> (mel [..., F, num_mels], linear [..., F, bins])
    normalized training targets in one pass, frame-major (the [B, T, bins]
    layout the model trains on; preprocess computes the same features
    offline with an FFT and transposes them).

    Frames only the window's support (win_length of the n_fft samples:
    frame k's support starts at k*hop + lpad of the centered, reflect-padded
    signal), transforms it with the window-support DFT pair (the analysis
    window folded into the matrices) as two float32 products (TF32 stays
    off, PyTorch's default), and projects the same magnitude onto the mel
    basis.  ``n_frames`` keeps the first frames only."""
    n_fft, hop, win = params.n_fft, params.hop_length, params.win_length
    yp = preemphasis(y.float(), preemph)
    pad = n_fft // 2
    lpad = (n_fft - win) // 2
    lead = yp.shape[:-1]
    y_pad = torch.nn.functional.pad(yp.reshape(1, -1, yp.shape[-1]), (pad, pad),
                                    mode="reflect").reshape(*lead, -1)
    total = 1 + (y_pad.shape[-1] - n_fft) // hop
    n_keep = total if n_frames is None else min(n_frames, total)
    sup = _frame_rows(y_pad[..., lpad:], win, hop, n_keep)
    Cw, Sw, basis_t = _targets_constants(n_fft, win, sample_rate, num_mels, y.device)
    re, im = sup @ Cw, sup @ Sw
    mag = torch.sqrt(re * re + im * im)                     # [..., F, bins]
    linear = normalize_db(amp_to_db(mag) - ref_level_db, min_level_db)
    mel = normalize_db(amp_to_db(mag @ basis_t) - ref_level_db, min_level_db)
    return mel, linear


# ----------------------------------------------------------------------------
# Cooley-Tukey factorised DFT (n_fft = N1·N2 two-stage products)
# ----------------------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def _ct_factors(n_fft: int) -> tuple[int, int]:
    """Split n_fft = N1 * N2 with N1 ≥ N2, both powers of two."""
    log2 = n_fft.bit_length() - 1
    if 1 << log2 != n_fft:
        raise ValueError(f"n_fft {n_fft} must be a power of two for CT")
    n1 = 1 << ((log2 + 1) // 2)
    return n1, n_fft // n1


@functools.lru_cache(maxsize=4)
def _ct_matrices(n_fft: int):
    """The factorised rfft/irfft's constants, float32 numpy: (C1, S1 [N1,
    N1] stage 1; Wre, Wim [N2, N1] forward twiddles; C2, S2 [N2, N2h] stage
    2; w [N2h, N1] the inverse's bin weights (1/N, the Hermitian doubling,
    zero past the last bin); F2re, F2im [N2h, N2]; Tre, Tim [N1, N2] inverse
    twiddles; E1re, E1im [N1, N1])."""
    N1, N2 = _ct_factors(n_fft)
    N2h = N2 // 2 + 1
    a = k1 = np.arange(N1)
    ang1 = 2.0 * np.pi * np.outer(a, k1) / N1
    b = np.arange(N2)
    angw = 2.0 * np.pi * np.outer(b, k1) / n_fft
    k2 = np.arange(N2h)
    ang2 = 2.0 * np.pi * np.outer(b, k2) / N2
    kflat = k2[:, None] * N1 + k1[None, :]                  # flat bin k = k2·N1 + k1
    w = np.where((kflat == 0) | (kflat == n_fft // 2), 1.0, 2.0)
    w = np.where(kflat > n_fft // 2, 0.0, w) / n_fft
    s = np.arange(N2)
    angi2 = 2.0 * np.pi * np.outer(k2, s) / N2
    angit = 2.0 * np.pi * np.outer(k1, s) / n_fft
    angi1 = 2.0 * np.pi * np.outer(a, k1) / N1
    mats = (np.cos(ang1), -np.sin(ang1), np.cos(angw), -np.sin(angw), np.cos(ang2),
            -np.sin(ang2), w, np.cos(angi2), np.sin(angi2), np.cos(angit), np.sin(angit),
            np.cos(angi1), np.sin(angi1))
    return tuple(m.astype(np.float32) for m in mats)


@functools.lru_cache(maxsize=8)
def _ct_constants(n_fft: int, device: torch.device, dtype: torch.dtype):
    """:func:`_ct_matrices` on ``device`` as the JAX package takes them:
    every matrix in ``dtype`` but w, and the twiddles (rounded to
    ``dtype``) then widened to float32 for their f32 products."""
    mats = [torch.from_numpy(m).to(device) for m in _ct_matrices(n_fft)]
    low = [m.to(dtype) for m in mats]
    for i in (2, 3, 9, 10):                                 # Wre, Wim, Tre, Tim
        low[i] = low[i].float()
    low[6] = mats[6]
    return tuple(low)


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with a float32 result: the products of the operands (bf16 or
    f32 values) summed in f32, as ``preferred_element_type=float32``."""
    return a.float() @ b.float()


def _dft_ct(frames: torch.Tensor, n_fft: int, dtype: torch.dtype):
    """Factorised rfft: [..., F, n_fft] -> (re, im) each [..., F, bins] f32."""
    N1, N2 = _ct_factors(n_fft)
    N2h, bins, lead = N2 // 2 + 1, n_fft // 2 + 1, frames.shape[:-1]
    C1, S1, Wre, Wim, C2, S2 = _ct_constants(n_fft, frames.device, dtype)[:6]
    x = frames.to(dtype).reshape(*lead, N1, N2).transpose(-1, -2)    # [..., b, a]
    yre, yim = _mm32(x, C1), _mm32(x, S1)                            # [..., b, k1]
    zre = (yre * Wre - yim * Wim).transpose(-1, -2).to(dtype)        # [..., k1, b]
    zim = (yre * Wim + yim * Wre).transpose(-1, -2).to(dtype)
    xre = _mm32(zre, C2) - _mm32(zim, S2)                            # [..., k1, k2]
    xim = _mm32(zre, S2) + _mm32(zim, C2)
    xre = xre.transpose(-1, -2).reshape(*lead, N2h * N1)             # bin k2·N1 + k1
    xim = xim.transpose(-1, -2).reshape(*lead, N2h * N1)
    return xre[..., :bins], xim[..., :bins]


def _idft_ct(re: torch.Tensor, im: torch.Tensor, n_fft: int, dtype: torch.dtype):
    """Factorised irfft: (re, im) [..., F, bins] -> frames [..., F, n_fft] f32."""
    N1, N2 = _ct_factors(n_fft)
    N2h, bins, lead = N2 // 2 + 1, n_fft // 2 + 1, re.shape[:-1]
    _, _, _, _, _, _, w, F2re, F2im, Tre, Tim, E1re, E1im = _ct_constants(
        n_fft, re.device, dtype)
    pad = N2h * N1 - bins
    grid = lambda t: torch.nn.functional.pad(t, (0, pad)).reshape(*lead, N2h, N1) * w
    xre = grid(re).transpose(-1, -2).to(dtype)                       # [..., k1, k2]
    xim = grid(im).transpose(-1, -2).to(dtype)
    ure = _mm32(xre, F2re) - _mm32(xim, F2im)                        # [..., k1, s]
    uim = _mm32(xre, F2im) + _mm32(xim, F2re)
    vre = (ure * Tre - uim * Tim).to(dtype)
    vim = (ure * Tim + uim * Tre).to(dtype)
    out = _mm32(E1re, vre) - _mm32(E1im, vim)                        # [..., q, s]
    return out.reshape(*lead, n_fft)


# ----------------------------------------------------------------------------
# Griffin-Lim
# ----------------------------------------------------------------------------

POLISH_ITERS = 3  # "mix": the last iterations run at the polish precision


def gl_bins(n_fft: int, method: str = "dft_f32") -> int:
    """The spectrum width Griffin-Lim's products run at for ``method``: for
    ``dft_*``, the n_fft//2 + 1 bins rounded up to a multiple of 8 (1032 for
    n_fft 2048), so that every row of the spectra and of the DFT matrices is
    a multiple of 16 bytes in bf16 and of 32 in float32 (at 1025 bins the
    library's products fall back to kernels for misaligned operands, several
    times slower); the bins of ``ct_*`` (on a power-of-two n_fft) and
    ``fft``, which pad nothing."""
    bins = n_fft // 2 + 1
    algo = method.partition("_")[0]
    if algo == "fft" or (algo == "ct" and not n_fft & (n_fft - 1)):
        return bins
    return -(-bins // 8) * 8


@functools.lru_cache(maxsize=16)
def _gl_constants(n_fft: int, win_length: int, device: torch.device,
                  dtype: torch.dtype = torch.float32, windowed: bool = True):
    """(window, (C, S, iC, iS)) on ``device``, built once: the window-support
    matrices and window when ``windowed`` and win_length < n_fft, else the
    full-frame ones; C and S with zero columns and iC and iS with zero rows
    up to :func:`gl_bins` (the products' sums are the same)."""
    if windowed and win_length < n_fft:
        mats = _dft_win_matrices(n_fft, win_length)
        window = hann_window(win_length, win_length)
    else:
        mats = _dft_matrices(n_fft)
        window = hann_window(win_length, n_fft)
    pad = gl_bins(n_fft) - (n_fft // 2 + 1)
    C, S, iC, iS = mats
    mats = (np.pad(C, ((0, 0), (0, pad))), np.pad(S, ((0, 0), (0, pad))),
            np.pad(iC, ((0, pad), (0, 0))), np.pad(iS, ((0, pad), (0, 0))))
    to_dev = lambda a: torch.from_numpy(a).to(device=device, dtype=dtype)
    return to_dev(window), tuple(to_dev(m) for m in mats)


def griffin_lim(magnitude: torch.Tensor, params: STFTParams, n_iters: int,
                generator: torch.Generator | None = None,
                method: str = "dft_f32", momentum: float = 0.0,
                angles: torch.Tensor | None = None,
                use_pallas: bool = False) -> torch.Tensor:
    """Phase reconstruction: magnitude [..., bins, frames] -> waveform.

    ``angles`` [..., frames, bins]: the initial phases; drawn uniformly in
    [−π, π) from ``generator`` when not given.  ``momentum`` > 0 is fast
    Griffin-Lim (the projected spectrum extrapolated by momentum/(1+momentum)
    of the previous one); 0 is the classic algorithm.

    Precisions: ``f32`` full float32 products; ``bf16`` bf16 products and
    spectra; ``mix`` bf16 iterations then POLISH_ITERS float32 ones.  ``hi``
    (bf16×3 products on the TPU) and the ``mix`` polish run as full-float32
    matmuls here: PyTorch has no bf16×3 mode, and float32 is the more
    accurate of the two.

    ``use_pallas``: the kernels and their layouts (module docstring).
    ``ct_*`` runs the factorised transforms, ``fft`` the classic
    formulation (:func:`_griffin_lim_fft`).  ``dft_*`` pads the magnitude
    with zero bins to :func:`gl_bins` once the initial phases are drawn, and
    the fused kernel's spectra once they are back, so that the library
    products read 16-byte rows (module docstring); the waveform differs from
    the unpadded formulation's only by the products' sum order.
    """
    if method == "fft":
        return _griffin_lim_fft(magnitude, params, n_iters, generator, momentum, angles,
                                use_pallas)
    algo, _, prec = method.partition("_")
    if algo not in ("dft", "ct") or prec not in ("f32", "hi", "bf16", "mix"):
        raise ValueError(f"Griffin-Lim method {method!r}: fft, or dft_* / ct_* with "
                         "f32|hi|bf16|mix")
    n_fft, hop = params.n_fft, params.hop_length
    if algo == "ct" and n_fft & (n_fft - 1):
        algo = "dft"                         # CT needs a power-of-two n_fft, as in JAX
    ct = algo == "ct"
    dev = magnitude.device
    mom = momentum / (1.0 + momentum) if momentum > 0.0 else 0.0
    dtype = torch.bfloat16 if prec in ("bf16", "mix") else torch.float32
    fuse_fast = use_pallas and prec in ("bf16", "mix") and not ct
    windowed = params.win_length < n_fft and not fuse_fast and not ct
    ola_kernel = use_pallas and not fuse_fast
    Wn = params.win_length if windowed else n_fft
    lpad = (n_fft - Wn) // 2
    rpad = n_fft - Wn - lpad
    window, mats32 = _gl_constants(n_fft, params.win_length, dev, windowed=windowed)
    by_dtype = {torch.float32: mats32,
                torch.bfloat16: _gl_constants(n_fft, params.win_length, dev,
                                              torch.bfloat16, windowed)[1]}

    magT = magnitude.transpose(-1, -2).float()              # [..., F, bins]
    batch_shape = magT.shape[:-2]
    nF, bins = magT.shape[-2:]
    out_len = Wn + hop * (nF - 1)
    magT_flat = magT.reshape(-1, nF, bins)
    # the products' spectra carry zero columns up to their aligned width:
    # |S| is 0 there, so the scale is 0 and they stay exact zeros
    width = gl_bins(n_fft, method)
    pad = lambda t: torch.nn.functional.pad(t, (0, width - bins)) if width > bins else t

    def fwd(frames, dt):
        if ct:
            return _dft_ct(frames, n_fft, dt)
        C, S, _, _ = by_dtype[dt]
        f = frames.to(dt)
        return f @ C, f @ S

    def ola(re, im, dt):
        if ct:
            frames = _idft_ct(re, im, n_fft, dt).to(dt).reshape(-1, nF, Wn)
        else:
            _, _, iC, iS = by_dtype[dt]
            frames = (re.to(dt) @ iC + im.to(dt) @ iS).to(dt).reshape(-1, nF, Wn)
        if ola_kernel:
            return ola_ops.overlap_add(frames, window, hop, prewindowed=windowed)
        sig = overlap_add_reference(frames, window.to(dt), hop, prewindowed=windowed)
        return sig.float()                               # [prod(batch), out_len]

    def frame(sig, dt):
        """Un-centered framing of the padded signal: m static slices."""
        m = -(-Wn // hop)
        Q = nF + m
        s = torch.nn.functional.pad(sig, (0, Q * hop - out_len)).to(dt)
        rows = s.reshape(s.shape[0], Q, hop)
        frames = torch.cat([rows[:, i: i + nF, :] for i in range(m)], dim=-1)[..., :Wn]
        return frames if windowed else frames * window.to(dt)

    def iterate(carry, n, dt):
        sig, pre, pim = carry
        mag_s = mag_p.to(dt)
        mom_s = torch.tensor(mom, dtype=dt, device=dev)
        for _ in range(n):
            re, im = fwd(frame(sig, dt), dt)
            re, im = re.to(dt), im.to(dt)
            are = re - mom_s * pre
            aim = im - mom_s * pim
            scale = mag_s / torch.clamp(torch.sqrt(are * are + aim * aim), min=1e-8)
            sig, pre, pim = ola(are * scale, aim * scale, dt), re, im
        return sig, pre, pim

    if angles is None:
        angles = (torch.rand(magT.shape, generator=generator, device=dev)
                  * (2.0 * math.pi) - math.pi)
    a = angles.to(dev).float().reshape(magT_flat.shape)
    sig = ola(pad(magT_flat * torch.cos(a)), pad(magT_flat * torch.sin(a)), dtype)
    mag_p = pad(magT_flat)
    z = torch.zeros_like(mag_p)

    # the kernel's n fast bf16 iterations from the initial frames → (sre,
    # sim, pre, pim); the overlap-add of (sre, sim) stays plain, as in JAX
    fast_kernel = lambda n: gl_ops.gl_fast_iterations(
        frame(sig, torch.bfloat16), magT_flat, window, hop, n, mom)

    if prec == "mix":
        n_fast = max(n_iters - POLISH_ITERS, 0)
        if fuse_fast and n_fast > 0:
            sre, sim, pre, pim = map(pad, fast_kernel(n_fast))
            carry = (ola(sre, sim, torch.float32), pre, pim)
        else:
            sig, pre, pim = iterate((sig, z.to(dtype), z.to(dtype)), n_fast, dtype)
            carry = (sig, pre.float(), pim.float())
        sig, _, _ = iterate(carry, n_iters - n_fast, torch.float32)
    elif fuse_fast:
        sre, sim, _, _ = fast_kernel(n_iters)
        sig = ola(pad(sre), pad(sim), dtype)
    else:
        sig, _, _ = iterate((sig, z.to(dtype), z.to(dtype)), n_iters, dtype)
    # crop the centered-analysis padding; in the window-support layout the
    # OLA signal starts lpad samples into the full-frame coordinates
    y = sig[..., n_fft // 2 - lpad: out_len - (n_fft // 2 - rpad)]
    return y.reshape(*batch_shape, y.shape[-1])


def _griffin_lim_fft(magnitude: torch.Tensor, params: STFTParams, n_iters: int,
                     generator: torch.Generator | None, momentum: float,
                     angles: torch.Tensor | None, use_pallas: bool) -> torch.Tensor:
    """Griffin-Lim method ``fft`` (the JAX ``griffin_lim`` ``:560-577``):
    :func:`istft` of the magnitude with the initial phases, then per
    iteration the :func:`stft` of the signal, extrapolated by the momentum
    term, its phase on the magnitude, :func:`istft` again.  ``angles`` as
    in :func:`griffin_lim` ([..., frames, bins])."""
    mom = momentum / (1.0 + momentum) if momentum > 0.0 else 0.0
    dev = magnitude.device
    mag = magnitude.float().to(torch.complex64)              # [..., bins, F]
    if angles is None:
        angles = (torch.rand(magnitude.transpose(-1, -2).shape, generator=generator,
                             device=dev) * (2.0 * math.pi) - math.pi)
    a = angles.to(dev).float().transpose(-1, -2)
    y = istft(mag * torch.polar(torch.ones_like(a), a), params, use_pallas=use_pallas)
    prev = torch.zeros_like(mag)
    for _ in range(n_iters):
        est = stft(y, params)
        acc = est - mom * prev                               # fast-GL extrapolation
        y = istft(mag * (acc / torch.clamp(acc.abs(), min=1e-8)), params,
                  use_pallas=use_pallas)
        prev = est
    return y


def inv_linear_spectrogram(spec: torch.Tensor, params: STFTParams, *,
                           preemph: float, ref_level_db: float,
                           min_level_db: float, power: float, gl_iters: int,
                           generator: torch.Generator | None = None,
                           gl_method: str = "dft_f32", gl_momentum: float = 0.0,
                           angles: torch.Tensor | None = None,
                           use_pallas: bool = False) -> torch.Tensor:
    """Normalized linear spectrogram [..., bins, frames] -> waveform."""
    s = db_to_amp(denormalize_db(spec.float(), min_level_db) + ref_level_db)
    y = griffin_lim(torch.pow(s, power), params, gl_iters, generator,
                    method=gl_method, momentum=gl_momentum, angles=angles,
                    use_pallas=use_pallas)
    return inv_preemphasis(y, preemph)
