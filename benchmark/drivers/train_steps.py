"""Training steps through the port's own input pipeline: a corpus made from
the seed is featurised by the port's preprocessing, then ``Feeder`` (the
native assembler into pinned buffers) → ``PrefetchIterator`` →
``train_loop.DeviceBatches`` (side-stream copies) →
``make_sharded_train_step(cfg, model, None)``, with a host sync every
``sync_every`` steps, as ``train_loop.train`` does.

Correctness: set-up drives the same step object and feed through its first
three steps, on three distinct batches, and keeps each step's loss, the
first clipped gradient (Adam's first moment after one step / (1 − β1)) and
the parameters' change over the three.  Once the window has closed the
float32 reference takes the same batches (their features worked out again
from the corpus's waveforms), the same initial weights and the same dropout
streams, and makes the same three updates.  Compared: the worst step's
relative loss gap, and by the worst leaf the gap between the norms of the
first gradient and of the change, relative to the larger of that leaf's
reference norm and the median leaf's; leaves whose reference gradient is
under a thousandth of the median leaf's are left out of the change."""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time

import numpy as np

from .. import core
from ..traffic import generate

FIRST_STEPS = 3


def fold_in(seed: int, index: int) -> int:
    """The seed of train step ``index``'s dropout generator, as the port
    derives it (``training.fold_in``)."""
    return (seed * 1_000_003 + index) % (2 ** 63 - 1)


class Clock:
    """Seconds of each part of the set-up, for its line on stderr."""

    def __init__(self):
        self.t, self.parts = time.perf_counter(), []

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.parts.append(f"{name} {now - self.t:.2f} s")
        self.t = now

    def __str__(self) -> str:
        return ", ".join(self.parts)


class Driver:
    def __init__(self, cell: core.Cell, seed: int, device="cuda"):
        self.cell, self.seed, self.device = cell, seed, device
        self.mix = cell.traffic
        self.trace = None
        self.traced = []
        self.counters = {}
        self.tmp = None

    # -- set-up -----------------------------------------------------------
    def setup(self) -> None:
        import torch
        from tacotron_multispeaker_torch.data.feeder import (Feeder, PrefetchIterator,
                                                             pinned_empty)
        from tacotron_multispeaker_torch.data.preprocess import build_generic, write_metadata
        from tacotron_multispeaker_torch.train_loop import DeviceBatches
        from tacotron_multispeaker_torch.training import (create_train_state,
                                                          make_sharded_train_step)
        self.dims = core.resolve(self.cell.config, self.mix["overrides"])
        self.cfg = core.port_config(self.cell.config, self.mix["overrides"])
        self.tmp = tempfile.mkdtemp(prefix="bench_train_")
        corpus_dir = os.path.join(self.tmp, "corpus")
        data_dir = os.path.join(self.tmp, "training")
        clock = Clock()
        self.rows = generate.corpus(self.mix, self.dims["model"]["num_speakers"], self.seed)
        generate.write_corpus(corpus_dir, self.rows, self.dims["audio"]["sample_rate"],
                              self.mix["char_seconds"])
        self.corpus_dir = corpus_dir
        clock.lap("corpus")
        meta = build_generic(corpus_dir, data_dir, self.cfg.audio, num_workers=1,
                             device=self.device)
        write_metadata(meta, data_dir, self.cfg.audio)
        clock.lap("preprocess")
        self.model, self.state = create_train_state(self.cfg, seed=self.seed, device=self.device)
        self.dev = next(self.model.parameters()).device
        self.weights = core.draw_weights(core.shapes_of(self.model), self.seed, self.dev)
        self.model.load_state_dict(self.weights)
        self.step_fn = make_sharded_train_step(self.cfg, self.model, None)
        pin = self.dev.type == "cuda"
        feeder = Feeder(data_dir, self.cfg, empty=pinned_empty if pin else None)
        self.batches = PrefetchIterator(iter(feeder), prefetch=self.mix["prefetch"])
        self.feed = DeviceBatches(self.batches, self.dev)
        names = [n for n, _ in self.model.named_parameters()]
        p0 = {n: p.detach().clone() for n, p in self.model.named_parameters()}
        self.first = []
        self.first_losses = []
        opt = self.state.optimizer
        for i in range(FIRST_STEPS):
            host, metrics = self._step()
            self.first.append({"inputs": np.asarray(host.inputs).copy(),
                               "input_lengths": np.asarray(host.input_lengths).copy(),
                               "target_lengths": np.asarray(host.target_lengths).copy(),
                               "speaker_ids": np.asarray(host.speaker_ids).copy(),
                               "T": int(host.mel_targets.shape[1]), "step": i})
            self.first_losses.append(float(metrics["loss"]))
            if i == 0:
                b1 = self.dims["train"]["adam_beta1"]
                st = {id(p): opt.adam.state.get(p, {}) for p in opt.params}
                self.first_grad = {
                    n: (st[id(p)]["exp_avg"].float() / (1 - b1)).cpu() if st[id(p)]
                    else torch.zeros_like(p).cpu()
                    for n, p in zip(names, opt.params)}
        self.change = {n: (p.detach() - p0[n]).cpu() for n, p in self.model.named_parameters()}
        del p0
        clock.lap("state and first steps")
        for _ in range(self.mix["warm_steps"]):
            self._step()
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)
        clock.lap("warm-up")
        print(f"set-up: {clock}", file=sys.stderr)

    def _step(self):
        host, args = self.feed.take()
        self.state, metrics = self.step_fn(self.state, *args)
        self.feed.prefetch()
        return host, metrics

    # -- the window -------------------------------------------------------
    def window(self, seconds: float, trace: bool = False) -> dict:
        import torch
        from torch.autograd.profiler import record_function
        from tacotron_multispeaker_torch.ops import teacher_decoder as td
        from .. import trace as tracing
        tracer = traced = tracing.Tracer(self.dev) if trace else None
        sync_every = self.mix["sync_every"]
        n_trace = self.mix["trace_steps"]
        r = self.dims["model"]["outputs_per_step"]
        start = self._counters(td)
        steps, wait = 0, 0.0
        t0 = time.perf_counter()
        if tracer:
            tracer.start()
        while True:
            t = time.perf_counter()
            with record_function("bench.take"):
                host, args = self.feed.take()
            wait += time.perf_counter() - t
            with record_function("bench.step"):
                self.state, metrics = self.step_fn(self.state, *args)
            self.feed.prefetch()
            steps += 1
            if tracer:
                self.traced.append({"B": int(args[0].shape[0]), "L": int(args[0].shape[1]),
                                    "S": int(args[2].shape[1]) // r,
                                    "text_lengths": np.asarray(host.input_lengths).tolist(),
                                    "frame_lengths": np.asarray(host.target_lengths).tolist()})
            if steps % sync_every == 0:
                with record_function("bench.sync"):
                    loss = float(metrics["loss"])
                if not np.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at window step {steps}")
            if tracer and steps == n_trace:
                tracer.stop()
                traced = tracer
                self.counters = {n: v - start[n] for n, v in self._counters(td).items()}
                tracer = None
            if time.perf_counter() - t0 >= seconds and tracer is None:
                break
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        span = time.perf_counter() - t0
        if traced:
            self.trace = traced.summary()
        B = self.dims["train"]["batch_size"]
        return {"attempted": steps * B, "failed": 0, "steps": steps, "window_s": span,
                "train_examples_per_s": steps * B / span, "batch_wait_ms": wait * 1e3 / steps,
                "step_ms_mean": span * 1e3 / steps}

    @staticmethod
    def _counters(td) -> dict:
        return {"teacher_fwd": td.fwd_launches, "teacher_bwd": td.bwd_launches,
                "teacher_bwd_remat": td.bwd_remat_launches}

    def release(self) -> None:
        import torch
        self.batches.close()
        del self.feed, self.batches, self.step_fn, self.state, self.model
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # -- correctness --------------------------------------------------------
    def reference(self, rounding: str = "f32"):
        """The reference's (losses, first clipped gradients, change after the
        first steps) from the initial weights on the same batches."""
        import torch
        from scipy.io import wavfile
        from ..reference import dsp as rdsp
        from ..reference.precision import ROUNDING, no_tf32
        from ..reference.text import encode
        from ..reference.train import Trainer
        no_tf32()
        dev, a = self.dev, self.dims["audio"]
        utt = {tuple(encode(t)): (i, sid) for i, (t, sid) in enumerate(self.rows)}
        names = list(self.change)
        params = {n: self.weights[n].clone() for n in names}
        buffers = {n: w for n, w in self.weights.items() if n not in params}
        trainer = Trainer(params, buffers, self.dims, ROUNDING[rounding])
        losses, first_grad = [], None
        for b in self.first:
            L, T = b["inputs"].shape[1], b["T"]
            mels, lins, frames = [], [], []
            for row, n in zip(b["inputs"], b["input_lengths"]):
                i, sid = utt[tuple(int(x) for x in row[:n])]
                sr, pcm = wavfile.read(os.path.join(self.corpus_dir, f"wavs/utt{i:05d}.wav"))
                wav = torch.as_tensor(pcm.astype(np.float32) / 32768.0, device=dev)
                mel, lin = rdsp.features(wav, a)
                frames.append(min(mel.shape[0], T))
                pad = lambda x: torch.nn.functional.pad(x[:T], (0, 0, 0, T - min(len(x), T)))
                mels.append(pad(mel))
                lins.append(pad(lin))
            gen = torch.Generator(device=dev).manual_seed(fold_in(self.seed, b["step"]))
            draw = lambda shape: torch.rand(shape, generator=gen, device=dev)
            to = lambda x: torch.as_tensor(np.asarray(x), device=dev).long()
            loss, grads = trainer.step(to(b["inputs"]), to(b["input_lengths"]),
                                       torch.stack(mels), torch.stack(lins),
                                       torch.as_tensor(frames, device=dev),
                                       to(b["speaker_ids"]), draw)
            losses.append(loss)
            if first_grad is None:
                first_grad = {n: g.detach().cpu() for n, g in grads.items()}
        change = {n: (trainer.params[n] - self.weights[n]).detach().cpu() for n in names}
        return losses, first_grad, change

    def check(self, rounding: str | None = None) -> list:
        ref_l, ref_g, ref_d = self.reference()
        if rounding is None:
            got_l, got_g, got_d = self.first_losses, self.first_grad, self.change
        else:
            got_l, got_g, got_d = self.reference(rounding)
        loss = max(abs(a - b) / abs(b) for a, b in zip(got_l, ref_l))
        gnorm = {n: float(ref_g[n].norm()) for n in ref_g}
        median_g = float(np.median(list(gnorm.values())))
        grad = max(abs(float(got_g[n].norm()) - gnorm[n]) / max(gnorm[n], median_g)
                   for n in ref_g)
        moved = [n for n in ref_d if gnorm[n] >= 1e-3 * median_g]
        dnorm = {n: float(ref_d[n].norm()) for n in moved}
        median_d = float(np.median(list(dnorm.values())))
        change = max(abs(float(got_d[n].norm()) - dnorm[n]) / max(dnorm[n], median_d)
                     for n in moved)
        out = {"loss": loss, "grad": grad, "change": change}
        return [(k, out[k], self.cell.limits[k]) for k in sorted(out)]

    def close(self) -> None:
        """Remove the corpus and its features (the checks read the waveforms)."""
        if self.tmp:
            shutil.rmtree(self.tmp, ignore_errors=True)
            self.tmp = None

    # -- per-layer readings -------------------------------------------------
    def layer_context(self) -> dict:
        return {"trace": self.trace, "dims": self.dims, "counters": self.counters,
                "steps": self.traced}
