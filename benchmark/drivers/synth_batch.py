"""Batch synthesis, closed loop, one client: ``Synthesizer.synthesize_batch``
calls back to back (encoder, fused decoder loop, post-net, Griffin-Lim, the
waveform's copy to the host and its endpoint trim).

Correctness: once the window has closed, a sample of its calls drawn from
the seed (a reservoir of ``sample`` calls, and the call with the longest
text) is recomputed by the float32 reference from the same texts, speakers,
weights and random streams: the prenet dropout masks and the Griffin-Lim
phases come from a generator seeded with the call's seed, drawn by the same
calls in the same order as the program draws them.  Compared (the worst
row of the sample): the alignments of every step, and the served waveform by
what Griffin-Lim minimises, its spectral convergence to the magnitude asked
for (two precisions' phase retrieval from the same start drift apart in
phase, not in that)."""

from __future__ import annotations

import math
import time

import numpy as np

from .. import core
from ..traffic import generate


class Driver:
    def __init__(self, cell: core.Cell, seed: int, device="cuda"):
        self.cell, self.seed, self.device = cell, seed, device
        self.mix = cell.traffic
        self.calls_done = []           # (bucket, text lengths) of every timed call
        self.sampled = []              # (index, Call, wavs, aligns)
        self.longest = None
        self.trace = None
        self.traced = []               # (bucket, text lengths) of the traced calls
        self.counters = {}

    # -- set-up -----------------------------------------------------------
    def setup(self) -> None:
        import torch
        from tacotron_multispeaker_torch.synthesizer import Synthesizer
        self.dims = core.resolve(self.cell.config)
        self.cfg = core.port_config(self.cell.config)
        self.steps = self.dims["model"]["max_iters"]
        self.synth = Synthesizer(self.cfg, device=self.device, seed=0)
        self.dev = self.synth.device
        self.weights = self.draw()
        self.synth.model.load_state_dict(self.weights)
        self.calls = generate.synth_calls(self.mix, self.dims["model"]["num_speakers"], self.seed)
        # warm every bucket the mix uses, at the cell's batch, twice
        rng = generate.rng_for(self.seed, 3)
        for b in self.mix["buckets"]:
            for _ in range(2):
                texts = [generate.text_of(rng, b - 1) for _ in range(self.mix["batch"])]
                self.synth.synthesize_batch(texts, [0] * len(texts), seed=int(
                    rng.integers(0, 2**62)), pad_to=b)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)

    def draw(self) -> dict:
        from ..core import draw_weights, shapes_of
        return draw_weights(shapes_of(self.synth.model), self.seed, self.dev,
                            fixed=self.cell.config.get("serve_weights"))

    # -- the window -------------------------------------------------------
    def window(self, seconds: float, trace: bool = False) -> dict:
        from torch.autograd.profiler import record_function
        from .. import trace as tracing
        rng = generate.rng_for(self.seed, 4)
        k = self.mix["sample"]
        tracer = traced = tracing.Tracer(self.dev) if trace else None
        times = []
        n_trace = self.mix["trace_calls"]
        start = self._counters()
        t0 = time.perf_counter()
        if tracer:
            tracer.start()
        while True:
            call = next(self.calls)
            t = time.perf_counter()
            with record_function("bench.synthesize_batch"):
                wavs, aligns = self.synth.synthesize_batch(call.texts, call.speaker_ids,
                                                           seed=call.seed, pad_to=call.bucket)
            done = time.perf_counter()
            times.append(done - t)
            i = len(times) - 1
            lengths = [len(x) + 1 for x in call.texts]
            self.calls_done.append((call.bucket, lengths))
            # the sample: a reservoir of k calls drawn from the seed, and the longest
            if i < k:
                self.sampled.append((i, call, wavs, aligns))
            else:
                j = int(rng.integers(0, i + 1))
                if j < k:
                    self.sampled[j] = (i, call, wavs, aligns)
            if self.longest is None or max(lengths) > max(len(x) for x in self.longest[1].texts):
                self.longest = (i, call, wavs, aligns)
            if tracer and len(times) == n_trace:
                tracer.stop()
                traced = tracer
                self.traced = list(self.calls_done)
                self.counters = {n: v - start[n] for n, v in self._counters().items()}
                tracer = None
            if done - t0 >= seconds and tracer is None:
                break
        span = done - t0
        if traced:
            self.trace = traced.summary()
        from ..reference.dsp import stft_params
        a = self.dims["audio"]
        audio_s = (len(times) * self.mix["batch"] * self.steps
                   * self.dims["model"]["outputs_per_step"] * stft_params(a)[1] / a["sample_rate"])
        return {"attempted": len(times) * self.mix["batch"], "failed": 0,
                "calls": len(times), "window_s": span, "audio_s_per_s": audio_s / span,
                "synth_call_p95_ms": float(np.percentile(np.asarray(times) * 1e3, 95)),
                "call_ms_median": float(np.median(times) * 1e3)}

    @staticmethod
    def _counters() -> dict:
        from tacotron_multispeaker_torch.ops import decoder_loop, gl_iteration
        return {"decoder_loop": decoder_loop.launches, "gl_iteration": gl_iteration.launches}

    def release(self) -> None:
        import torch
        del self.synth
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # -- correctness --------------------------------------------------------
    def sample(self) -> list:
        picked = {i: (call, wavs, aligns) for i, call, wavs, aligns in self.sampled}
        if self.longest is not None:
            i, call, wavs, aligns = self.longest
            picked[i] = (call, wavs, aligns)
        return [picked[i] for i in sorted(picked)]

    def reference(self, call, rounding: str = "f32"):
        """The reference's (waveforms [B, samples], alignments [B, S, L], the
        magnitude [B, frames, bins] its Griffin-Lim was asked for) of a call."""
        import torch
        from ..reference import dsp as rdsp
        from ..reference.model import Tacotron
        from ..reference.precision import ROUNDING, no_tf32
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
        ref = Tacotron(self.weights, self.dims, ROUNDING[rounding])
        wavs, mags = [], []
        with torch.no_grad():
            mel, linear, align = ref.generate(inputs, lengths, sids, self.steps, draw)
            angles = draw(tuple(linear.shape)) * (2.0 * math.pi) - math.pi
            block = self.mix["reference_rows"]
            for r0 in range(0, linear.shape[0], block):
                sl = slice(r0, r0 + block)
                wavs.append(rdsp.waveform(linear[sl], self.dims["audio"], angles[sl],
                                          ROUNDING[rounding]).cpu().numpy())
                mags.append(rdsp.magnitude(linear[sl], self.dims["audio"]).cpu().numpy())
        return np.concatenate(wavs), align.cpu().numpy(), np.concatenate(mags)

    def compare(self, served_wavs, served_aligns, ref_wavs, ref_aligns, ref_mags) -> dict:
        """The numbers compared, for one call: ``align``, the worst row's
        alignment gap relative to the reference's norm; ``wav_convergence``,
        the worst row's gap between the spectral convergence of the served
        waveform and of the reference's, each against the magnitude the
        reference's Griffin-Lim was asked for, the served waveform cut or
        padded with silence to the reference's endpoint (so a cut answer
        counts)."""
        align = max(float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
                    for a, b in zip(served_aligns, ref_aligns))
        conv = 0.0
        for w, r, mag in zip(served_wavs, ref_wavs, ref_mags):
            n = self._endpoint(r)
            w = np.pad(w[:n], (0, n - min(len(w), n)))
            conv = max(conv, abs(self._convergence(w, mag) - self._convergence(r[:n], mag)))
        return {"align": align, "wav_convergence": conv}

    def _convergence(self, wav, mag) -> float:
        """Spectral convergence of a served waveform against the magnitude
        Griffin-Lim was asked for: ‖|STFT(preemphasis(wav))| − mag‖ / ‖mag‖
        over the frames the waveform covers (what Griffin-Lim minimises)."""
        import torch
        from ..reference import dsp as rdsp
        n_fft, hop, win = rdsp.stft_params(self.dims["audio"])
        y = torch.as_tensor(wav, dtype=torch.float32)
        c = self.dims["audio"]["preemphasis"]
        y = torch.cat([y[:1], y[1:] - c * y[:-1]])
        s = torch.stft(y, n_fft, hop, window=rdsp.hann(win, n_fft, "cpu"), center=True,
                       pad_mode="constant", return_complex=True).abs().t()
        f = min(s.shape[0], mag.shape[0])
        m = torch.as_tensor(mag[:f])
        return float((s[:f] - m).norm() / max(float(m.norm()), 1e-30))

    def check(self, rounding: str | None = None) -> list:
        """[(number, value, limit)] over the sample; ``rounding`` puts the
        reference at that precision in the program's place (the control)."""
        worst = {}
        for call, wavs, aligns in self.sample():
            ref_w, ref_a, ref_m = self.reference(call)
            if rounding is not None:
                wavs, aligns, _ = self.reference(call, rounding)
                wavs = [w[: self._endpoint(w)] for w in wavs]
            for k, v in self.compare(wavs, aligns, ref_w, ref_a, ref_m).items():
                worst[k] = max(worst.get(k, 0.0), v)
        return [(k, worst[k], self.cell.limits[k]) for k in sorted(worst)]

    def close(self) -> None:
        self.sampled, self.longest = [], None

    def _endpoint(self, w) -> int:
        from ..reference import dsp as rdsp
        return rdsp.find_endpoint(w, self.dims["audio"])

    # -- per-layer readings -------------------------------------------------
    def layer_context(self) -> dict:
        return {"trace": self.trace, "dims": self.dims, "counters": self.counters,
                "calls": self.traced, "steps": self.steps,
                "gl_fast_iters": max(self.dims["audio"]["griffin_lim_iters"] - 3, 0)}
