"""Batch synthesis with Tacotron 2 + SV2TTS, closed loop, one client: the
``synth_batch`` driver's loop, sample and comparisons, with Tacotron 2's
float32 reference (``reference/tacotron2.py``) in Tacotron-1's place.

Over 1,000 free-running steps the bf16 decode and the f32 reference drift
apart in their alignments as far as the fp8 control does (``align`` up to
0.107 on sound seeds against 0.079 for the control; PERF.md §2), through
the attention's own feedback.  So the reference is teacher-forced with the
served decode's frames and alignments (the TTS form of "prefill then
decode agrees with the full forward"), and each step is compared with what
the reference computes from the same history.  The driver keeps the
decoder frames of the calls its sample may keep, by call seed, from
``Synthesizer.last_mel``.

The port cuts each served row at the smaller of its stop frame × hop and
its silence endpoint; the reference's rows are cut the same way (its stop
frames from its own stop logits), so the comparison runs over the frames
the reference keeps.  The weights: those of ``synth_batch``, with the
attention's scalar energy offset (a 0-d leaf, which the softmax ignores)
set to zero."""

from __future__ import annotations

import math
import sys

import numpy as np

from . import synth_batch


class Driver(synth_batch.Driver):
    def setup(self) -> None:
        super().setup()
        self._frames = {}             # call seed -> its decoder frames, on the device
        serve = self.synth.synthesize_batch

        def keeping(texts, speaker_ids, **kw):
            out = serve(texts, speaker_ids, **kw)
            self._prune()
            self._frames[kw["seed"]] = self.synth.last_mel
            return out
        self.synth.synthesize_batch = keeping

    def _prune(self) -> None:
        keep = {call.seed for _, call, *_ in self.sampled}
        if self.longest is not None:
            keep.add(self.longest[1].seed)
        self._frames = {s: f for s, f in self._frames.items() if s in keep}

    def draw(self) -> dict:
        import torch
        from ..core import draw_weights, shapes_of
        shapes = shapes_of(self.synth.model)
        w = draw_weights({k: v for k, v in shapes.items() if v}, self.seed, self.dev,
                         fixed=self.cell.config.get("serve_weights"))
        w.update({k: torch.zeros(v, device=self.dev) for k, v in shapes.items() if not v})
        return w

    def sample(self) -> list:
        self._prune()
        picked = {i: (call, wavs, aligns) for i, call, wavs, aligns in self.sampled}
        if self.longest is not None:
            i, call, wavs, aligns = self.longest
            picked[i] = (call, wavs, aligns)
        return [(*picked[i], self._frames[picked[i][0].seed].cpu().numpy())
                for i in sorted(picked)]

    def reference(self, call, rounding: str = "f32", feed=None):
        """The reference's (waveforms, each cut at min(stop frame × hop, its
        endpoint), alignments [B, S, L], the magnitude [B, frames, bins] its
        Griffin-Lim was asked for, its decoder frames [B, S, M]) of a call;
        ``feed`` = (frames, alignments) of another decode teacher-forces its
        decoder (``reference/tacotron2.py``)."""
        import torch
        from ..reference import dsp as rdsp
        from ..reference.precision import ROUNDING, no_tf32
        from ..reference.tacotron2 import Tacotron2, stop_frames
        from ..reference.text import encode
        no_tf32()
        dev = self.dev
        ids = [encode(t) for t in call.texts]
        L = call.bucket
        inputs = torch.as_tensor(np.stack([np.pad(x[:L], (0, L - len(x[:L]))) for x in ids]),
                                 device=dev)
        lengths = torch.as_tensor([min(len(x), L) for x in ids], device=dev)
        sids = torch.as_tensor(call.speaker_ids, device=dev)
        gen = torch.Generator(device=dev).manual_seed(call.seed)
        draw = lambda shape: torch.rand(shape, generator=gen, device=dev)
        q = ROUNDING[rounding]
        ref = Tacotron2(self.weights, self.dims, q)
        audio = self.dims["audio"]
        hop = rdsp.stft_params(audio)[1]
        if feed is not None:
            feed = tuple(torch.as_tensor(f, device=dev) for f in feed)
        wavs, mags = [], []
        with torch.no_grad():
            _, linear, align, logits, frames = ref.generate(inputs, lengths, sids, self.steps,
                                                            draw, feed)
            stops = stop_frames(logits, self.dims["model"]["stop_threshold"])
            angles = draw(tuple(linear.shape)) * (2.0 * math.pi) - math.pi
            block = self.mix["reference_rows"]
            for r0 in range(0, linear.shape[0], block):
                sl = slice(r0, r0 + block)
                wavs += list(rdsp.waveform(linear[sl], audio, angles[sl], q).cpu().numpy())
                mags.append(rdsp.magnitude(linear[sl], audio).cpu().numpy())
        wavs = [w[: min(self._endpoint(w), int(s) * hop)] for w, s in zip(wavs, stops)]
        return wavs, align.cpu().numpy(), np.concatenate(mags), frames.cpu().numpy()

    def check(self, rounding: str | None = None) -> list:
        """[(number, value, limit)] over the sample; ``rounding`` puts the
        reference at that precision in the program's place (the control).
        The reference is teacher-forced with the served decode's frames and
        alignments, so each step is held to what the reference computes
        from the same history: ``align`` and ``wav_convergence`` as
        ``synth_batch`` has them.  ``frames``, the worst row's gap between
        the decoder's frames and the reference's relative to the
        reference's norm, is printed on stderr with no limit: its sound and
        control readings lie too close together to set one (PERF.md §2)."""
        worst = {}
        for call, wavs, aligns, frames in self.sample():
            if rounding is not None:
                wavs, aligns, _, frames = self.reference(call, rounding)
                wavs = [w[: self._endpoint(w)] for w in wavs]
            if not len(wavs) == len(aligns) == len(frames) == len(call.texts):
                for k in self.cell.limits:          # rows missing: nothing to compare
                    worst[k] = float("inf")
                continue
            ref_w, ref_a, ref_m, ref_f = self.reference(call, feed=(frames, aligns))
            numbers = self.compare(wavs, aligns, ref_w, ref_a, ref_m)
            numbers["frames"] = max(
                float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
                for a, b in zip(frames, ref_f))
            for k, v in numbers.items():
                worst[k] = max(worst.get(k, 0.0), v)
        if "frames" in worst:
            print(f"reading frames = {worst['frames']!r} (no limit)", file=sys.stderr)
        return [(k, worst[k], self.cell.limits[k]) for k in sorted(worst)
                if k in self.cell.limits]
