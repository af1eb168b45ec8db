"""Spectrogram features and Griffin-Lim in plain float32 PyTorch (librosa
conventions: centred frames with reflect padding, a periodic Hann window
zero-padded to n_fft, Slaney mel), for ``dims["audio"]``."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .precision import f32


def stft_params(audio: dict) -> tuple[int, int, int]:
    n_fft = (audio["num_freq"] - 1) * 2
    hop = int(audio["frame_shift_ms"] / 1000.0 * audio["sample_rate"])
    win = min(int(audio["frame_length_ms"] / 1000.0 * audio["sample_rate"]), n_fft)
    return n_fft, hop, win


def hann(win: int, n_fft: int, device) -> torch.Tensor:
    n = torch.arange(win, dtype=torch.float64)
    w = 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / win)
    lpad = (n_fft - win) // 2
    return F.pad(w, (lpad, n_fft - win - lpad)).float().to(device)


def mel_basis(sample_rate: int, n_fft: int, num_mels: int) -> np.ndarray:
    """[num_mels, bins] Slaney mel filterbank with Slaney normalisation."""
    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        lin = f / (200.0 / 3)
        return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0)
                        / (np.log(6.4) / 27.0), lin)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)),
                        m * 200.0 / 3)

    bins = n_fft // 2 + 1
    fft_f = np.linspace(0.0, sample_rate / 2.0, bins)
    hz = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sample_rate / 2.0), num_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - fft_f[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    w *= (2.0 / (hz[2:num_mels + 2] - hz[:num_mels]))[:, None]
    return w.astype(np.float32)


def features(wav: torch.Tensor, audio: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """A waveform [S] → normalised (mel [T, M], linear [T, bins])."""
    n_fft, hop, win = stft_params(audio)
    c = audio["preemphasis"]
    y = torch.cat([wav[:1], wav[1:] - c * wav[:-1]])
    y = F.pad(y[None, None], (n_fft // 2, n_fft // 2), mode="reflect")[0, 0]
    frames = y.unfold(0, n_fft, hop) * hann(win, n_fft, y.device)
    mag = torch.fft.rfft(frames, dim=-1).abs()
    basis = torch.from_numpy(mel_basis(audio["sample_rate"], n_fft, audio["num_mels"]))
    mel = mag @ basis.to(mag.device).t()
    norm = lambda x: torch.clamp(
        (20.0 * torch.log10(torch.clamp(x, min=1e-5)) - audio["ref_level_db"]
         - audio["min_level_db"]) / -audio["min_level_db"], 0.0, 1.0)
    return norm(mel), norm(mag)


def dft_matrices(n_fft: int, device):
    """(C, S, iC, iS): re = x@C, im = x@S, x = re@iC + im@iS (the inverse
    drops the imaginary part of the DC and Nyquist bins)."""
    bins = n_fft // 2 + 1
    ang = 2.0 * np.pi * np.arange(n_fft)[:, None] * np.arange(bins)[None, :] / n_fft
    C, S = np.cos(ang), -np.sin(ang)
    w = np.full((bins,), 2.0)
    w[0] = w[-1] = 1.0
    mats = (C, S, (w[:, None] * C.T) / n_fft, (w[:, None] * S.T) / n_fft)
    return tuple(torch.from_numpy(m.astype(np.float32)).to(device) for m in mats)


def _overlap_add(frames, window, hop):
    """Windowed frames [B, F, n] → [B, n + hop·(F−1)], divided by the sum of
    the squared windows (floored at 1e-10)."""
    B, nF, n = frames.shape
    out_len = n + hop * (nF - 1)
    fold = lambda x: F.fold(x.transpose(1, 2), (1, out_len), (1, n), stride=(1, hop))
    sig = fold(frames * window)[:, 0, 0]
    norm = fold((window * window).expand(1, nF, n))[0, 0, 0]
    return sig / torch.clamp(norm, min=1e-10)


def griffin_lim(magT, audio: dict, angles, q=f32):
    """Fast Griffin-Lim (momentum m/(1+m)) from the initial phases ``angles``
    on magnitude ``magT`` [B, F, bins] → waveform (centred-analysis padding
    cropped).  Every DFT is a product of ``q``-rounded operands."""
    n_fft, hop, win = stft_params(audio)
    n_iters, momentum = audio["griffin_lim_iters"], audio["gl_momentum"]
    mom = momentum / (1.0 + momentum) if momentum > 0.0 else 0.0
    dev = magT.device
    window = hann(win, n_fft, dev)
    C, S, iC, iS = (q(m) for m in dft_matrices(n_fft, dev))
    B, nF, _ = magT.shape
    out_len = n_fft + hop * (nF - 1)

    def inverse(re, im):
        return _overlap_add(q(re) @ iC + q(im) @ iS, window, hop)

    def frame(sig):
        m = -(-n_fft // hop)
        s = F.pad(sig, (0, (nF + m) * hop - out_len))
        return s.unfold(-1, n_fft, hop)[:, :nF] * window

    sig = inverse(magT * torch.cos(angles), magT * torch.sin(angles))
    pre = pim = torch.zeros_like(magT)
    for _ in range(n_iters):
        fr = q(frame(sig))
        re, im = fr @ C, fr @ S
        are, aim = re - mom * pre, im - mom * pim
        scale = magT / torch.clamp(torch.sqrt(are * are + aim * aim), min=1e-8)
        sig, pre, pim = inverse(are * scale, aim * scale), re, im
    return sig[:, n_fft // 2: out_len - n_fft // 2]


def magnitude(linear, audio: dict):
    """Normalised linear spectrogram → the magnitude Griffin-Lim is asked for:
    dB to amplitude, raised to ``power``."""
    s = torch.clamp(linear, 0.0, 1.0) * -audio["min_level_db"] + audio["min_level_db"]
    return torch.pow(10.0, (s + audio["ref_level_db"]) * 0.05) ** audio["power"]


def waveform(linear, audio: dict, angles, q=f32):
    """Normalised linear spectrogram [B, F, bins] → waveform [B, samples]:
    :func:`magnitude`, Griffin-Lim, inverse preemphasis."""
    y = griffin_lim(magnitude(linear, audio), audio, angles, q)
    shift, c = 1, float(audio["preemphasis"])     # x[t] = y[t] + c·x[t−1], by doubling
    while shift < y.shape[-1] and np.float32(c) != 0.0:
        y = torch.cat([y[..., :shift], y[..., shift:] + c * y[..., :-shift]], -1)
        shift, c = 2 * shift, c * c
    return y


def find_endpoint(wav: np.ndarray, audio: dict) -> int:
    """Index of the first 0.8 s window below the silence threshold."""
    window = int(audio["sample_rate"] * audio["min_silence_sec"])
    hop = window // 4
    threshold = float(np.float32(10.0 ** (audio["silence_threshold_db"] * 0.05)))
    for x in range(hop, len(wav) - window, hop):
        if np.max(np.abs(wav[x: x + window])) < threshold:
            return x + hop
    return len(wav)
