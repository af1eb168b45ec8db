"""Audio API bound to an :class:`AudioConfig`.

Port of ``tacotron_multispeaker_tpu/audio/__init__.py``: ``spectrogram``,
``melspectrogram`` (analysis) and ``inv_spectrogram`` (Griffin-Lim) run on
the processor's device; WAV reading and encoding run on the host, and
``find_endpoint`` on a host array; ``find_endpoints``, the same over a batch,
runs on the batch's device.
"""

from __future__ import annotations

import io

import numpy as np
import torch
from scipy.io import wavfile

from . import dsp
from .dsp import STFTParams
from ..device import resolve_device

__all__ = ["AudioProcessor", "dsp", "STFTParams"]


class AudioProcessor:
    """Config-bound audio backend.  ``device=None`` means the CUDA device."""

    def __init__(self, audio_cfg, device=None):
        self.cfg = audio_cfg
        self.params = STFTParams.from_config(audio_cfg)
        self.device = resolve_device(device)

    def load_wav(self, path: str) -> np.ndarray:
        """A WAV file at the configured rate → mono float32 in [-1, 1)."""
        sr, data = wavfile.read(path)
        if sr != self.cfg.sample_rate:
            raise ValueError(
                f"{path}: sample rate {sr} != configured {self.cfg.sample_rate}")
        if data.dtype == np.int16:
            data = data.astype(np.float32) / 32768.0
        elif data.dtype == np.int32:
            data = data.astype(np.float32) / 2147483648.0
        elif data.dtype == np.uint8:
            data = (data.astype(np.float32) - 128.0) / 128.0
        else:
            data = data.astype(np.float32)
        if data.ndim > 1:
            data = data.mean(axis=1)
        return data

    def save_wav(self, wav: np.ndarray, path_or_buf) -> None:
        wav = np.asarray(wav, dtype=np.float32)
        peak = max(0.01, float(np.abs(wav).max()))
        scaled = (wav * (32767 / peak)).astype(np.int16)
        wavfile.write(path_or_buf, self.cfg.sample_rate, scaled)

    def wav_bytes(self, wav: np.ndarray) -> bytes:
        buf = io.BytesIO()
        self.save_wav(wav, buf)
        return buf.getvalue()

    def _analyse(self, y, features) -> np.ndarray:
        y = torch.as_tensor(np.asarray(y, np.float32), device=self.device)
        with torch.inference_mode():
            return features(y).cpu().numpy()

    def spectrogram(self, y) -> np.ndarray:
        """Waveform [T] -> normalized linear spectrogram [num_freq, frames]."""
        return self._analyse(y, lambda t: dsp.linear_spectrogram(
            t, self.params, preemph=self.cfg.preemphasis,
            ref_level_db=self.cfg.ref_level_db, min_level_db=self.cfg.min_level_db))

    def melspectrogram(self, y) -> np.ndarray:
        """Waveform [T] -> normalized mel spectrogram [num_mels, frames]."""
        return self._analyse(y, lambda t: dsp.mel_spectrogram(
            t, self.params, sample_rate=self.cfg.sample_rate, num_mels=self.cfg.num_mels,
            preemph=self.cfg.preemphasis, ref_level_db=self.cfg.ref_level_db,
            min_level_db=self.cfg.min_level_db))

    def inv_spectrogram(self, spec, seed: int = 0, angles=None) -> np.ndarray:
        """Normalized linear spectrogram [num_freq, frames] -> waveform."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        spec = torch.as_tensor(np.array(spec, np.float32), device=self.device)
        if angles is not None:
            angles = torch.as_tensor(np.array(angles, np.float32), device=self.device)
        with torch.inference_mode():
            wav = dsp.inv_linear_spectrogram(
                spec, self.params,
                preemph=self.cfg.preemphasis, ref_level_db=self.cfg.ref_level_db,
                min_level_db=self.cfg.min_level_db, power=self.cfg.power,
                gl_iters=self.cfg.griffin_lim_iters, generator=gen,
                gl_method=self.cfg.gl_method, gl_momentum=self.cfg.gl_momentum,
                angles=angles)
        return wav.cpu().numpy()

    def silence(self) -> tuple[int, float]:
        """The endpoint's silence: (window in samples, the f32 amplitude
        that every sample of a window stays below)."""
        window = int(self.cfg.sample_rate * self.cfg.min_silence_sec)
        threshold = float(dsp.db_to_amp(
            torch.tensor(self.cfg.silence_threshold_db, dtype=torch.float32)))
        return window, threshold

    def find_endpoint(self, wav: np.ndarray) -> int:
        """Index of the first long trailing silence."""
        window_length, threshold = self.silence()
        hop = window_length // 4
        wav = np.asarray(wav)
        for x in range(hop, len(wav) - window_length, hop):
            if np.max(np.abs(wav[x: x + window_length])) < threshold:
                return x + hop
        return len(wav)

    def find_endpoints(self, wavs: torch.Tensor) -> torch.Tensor:
        """:meth:`find_endpoint` of each row of f32 [B, N], bit for bit, on
        the waveform's device with no host sync → int64 [B].  The window
        that starts at ``j·hop`` is chunks j..j+3 of ``hop`` samples and the
        first ``window - 4·hop`` (< 4) samples of chunk j+4, so one pass of
        per-chunk maxima of |w| decides every window (a NaN is never quiet)."""
        if wavs.dim() != 2 or wavs.dtype != torch.float32:
            raise ValueError(f"find_endpoints takes float32 [B, N]; got {wavs.dtype} "
                             f"{tuple(wavs.shape)}")
        window, threshold = self.silence()
        B, N = wavs.shape
        hop = window // 4
        if hop < 1:
            raise ValueError(f"find_endpoints: a window of {window} samples has no hop")
        n = len(range(hop, N - window, hop))           # window starts hop·1 .. hop·n
        if B == 0 or n == 0:
            return torch.full((B,), N, dtype=torch.long, device=wavs.device)
        quiet = wavs[:, :(n + 4) * hop].abs().view(B, n + 4, hop).amax(2) < threshold
        silent = quiet[:, 1:n + 1] & quiet[:, 2:n + 2] & quiet[:, 3:n + 3] & quiet[:, 4:n + 4]
        rest = window - 4 * hop
        if rest:
            at = torch.arange(5, n + 5, device=wavs.device)[:, None] * hop + torch.arange(
                rest, device=wavs.device)
            silent &= wavs[:, at].abs().amax(2) < threshold
        first = (silent.int().argmax(1) + 2) * hop
        return torch.where(silent.any(1), first, N)
