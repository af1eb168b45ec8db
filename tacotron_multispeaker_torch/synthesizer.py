"""Inference stack: text → WAV.

Port of ``tacotron_multispeaker_tpu/synthesizer.py``.  ``synthesize(text[,
speaker_id])`` returns WAV bytes; ``synthesize_batch`` decodes a padded
batch: encoder → decoder (the fused loop, or the per-step decode; see
``Tacotron.generate``) → post-net → Griffin-Lim, all on the device, then
endpoint trimming on the host.  ``parallel.use_pallas`` routes the conv
banks, the per-step attention and Griffin-Lim through their kernels, as it
does in the JAX package.  Requests pad to the smallest
input bucket that fits, as in the JAX package.

Checkpoints: ``load_variables`` takes a flax ``{"params", "batch_stats"}``
tree of numpy arrays (convert.py); ``save``/``load`` use the port's own
``state_dict`` file.  Restoring an orbax checkpoint directory stands in
ROADMAP.md.
"""

from __future__ import annotations

import numpy as np
import torch

from . import convert
from .audio import AudioProcessor
from .audio import dsp
from .config import Config
from .data.feeder import pad_axis
from .device import resolve_device
from .models import create_model
from .text import text_to_sequence


class Synthesizer:
    """``device=None`` means the CUDA device (and raises without one);
    ``device="cpu"`` runs the plain PyTorch path.  Weights start random,
    drawn with flax's initialisers from ``seed``."""

    def __init__(self, cfg: Config, device=None, seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        model = create_model("tacotron", cfg).reset_parameters(gen)
        self.model = model.to(self.device).eval()
        self.ap = AudioProcessor(cfg.audio, self.device)

    # -- loading -------------------------------------------------------------

    def load_variables(self, variables) -> "Synthesizer":
        """Weights from a flax ``{"params", "batch_stats"}`` tree (nested
        dicts of numpy arrays)."""
        state = convert.flax_to_state_dict(variables, self.model)
        self.model.load_state_dict(
            {k: v.to(self.device) for k, v in state.items()}, strict=True)
        return self

    def save(self, path: str) -> None:
        torch.save(self.model.state_dict(), path)

    def load(self, path: str) -> "Synthesizer":
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(state, strict=True)
        return self

    # -- public API ----------------------------------------------------------

    def synthesize_batch(self, texts: list[str],
                         speaker_ids: list[int] | None = None,
                         max_iters: int | None = None, seed: int = 0,
                         pad_to: int | None = None, gl_angles=None):
        """Returns (list of trimmed np wavs, alignments [B, steps, L]).

        ``seed`` seeds the prenet dropout masks and the Griffin-Lim initial
        phases; ``gl_angles`` ([B, frames, bins]) replaces the latter."""
        cfg = self.cfg
        seqs = [np.asarray(text_to_sequence(t, cfg.cleaners), np.int64)
                for t in texts]
        maxlen = pad_to or max(len(s) for s in seqs)
        dev = self.device
        inputs = torch.as_tensor(np.stack([pad_axis(s, maxlen) for s in seqs]),
                                 device=dev)
        # a text longer than the pad length is cut to it (the JAX package
        # keeps the uncut length, which its clamped gathers then misread)
        lengths = torch.as_tensor([min(len(s), maxlen) for s in seqs],
                                  dtype=torch.long, device=dev)
        sids = torch.as_tensor(speaker_ids if speaker_ids is not None
                               else [0] * len(texts), dtype=torch.long, device=dev)
        iters = max_iters or self._iters_for(int(lengths.max()))
        gen = torch.Generator(device=dev).manual_seed(seed)
        with torch.inference_mode():
            out = self.model.generate(
                inputs, lengths, sids if cfg.model.num_speakers > 1 else None,
                max_iters=iters, generator=gen)
            spec = out.linear_outputs.transpose(1, 2)             # [B, bins, T]
            wavs = dsp.inv_linear_spectrogram(
                spec, self.ap.params, preemph=cfg.audio.preemphasis,
                ref_level_db=cfg.audio.ref_level_db,
                min_level_db=cfg.audio.min_level_db, power=cfg.audio.power,
                gl_iters=cfg.audio.griffin_lim_iters, generator=gen,
                gl_method=cfg.audio.gl_method, gl_momentum=cfg.audio.gl_momentum,
                use_pallas=cfg.parallel.use_pallas,
                angles=None if gl_angles is None else torch.as_tensor(
                    np.array(gl_angles, np.float32), device=dev))
            wavs = wavs.cpu().numpy()
            aligns = out.alignments.cpu().numpy()
        trimmed = [w[: self.ap.find_endpoint(w)] for w in wavs]
        return trimmed, aligns

    def _serve_bucket(self, length: int) -> int:
        """Smallest input bucket that fits ``length``."""
        bounds = [b for b in self.cfg.train.input_bucket_boundaries
                  if b <= self.cfg.train.max_input_length]
        for b in sorted(bounds):
            if length <= b:
                return b
        return self.cfg.train.max_input_length

    def _iters_for(self, text_len: int) -> int:
        """Decoder iteration count for a true (unpadded) text length: the
        full ``max_iters`` unless ``model.serve_frames_per_char`` scales it,
        quantized to max_iters/8 multiples."""
        m = self.cfg.model
        if m.serve_frames_per_char <= 0:
            return m.max_iters
        need = -(-int(text_len * m.serve_frames_per_char) // m.outputs_per_step)
        q = max(1, m.max_iters // 8)
        return max(q, min(m.max_iters, -(-need // q) * q))

    def serve_bucket_for(self, texts: list[str]) -> int:
        """Serving input bucket for a batch of raw texts."""
        n = max(len(text_to_sequence(t, self.cfg.cleaners)) for t in texts)
        return self._serve_bucket(n)

    def warmup(self, seed: int = 0) -> None:
        """Run one B=1 request per input bucket, so that the kernels are
        built and loaded and the library handles are warm before the first
        live request."""
        for b in sorted(set(
                self._serve_bucket(b)
                for b in (*self.cfg.train.input_bucket_boundaries,
                          self.cfg.train.max_input_length))):
            self.synthesize_batch(["warm up."], [0], seed=seed, pad_to=b)
            if self.cfg.model.serve_frames_per_char > 0:
                self.synthesize_batch(["warm up."], [0], seed=seed, pad_to=b,
                                      max_iters=self._iters_for(b))

    def synthesize(self, text: str, speaker_id: int | None = None,
                   seed: int = 0) -> bytes:
        """Text → WAV bytes."""
        wavs, _ = self.synthesize_batch(
            [text], [speaker_id or 0], seed=seed,
            pad_to=self.serve_bucket_for([text]))
        return self.ap.wav_bytes(wavs[0])
