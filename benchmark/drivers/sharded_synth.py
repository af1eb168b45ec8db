"""Pod-scale batch synthesis over ranks, one card each (``mix["ranks"]``):
``Synthesizer.make_sharded_synth`` on a (data, model) mesh (``mix["mesh"]``),
one function built at set-up, called closed loop by one client with the
global batch.  This process is rank 0; it starts the other ranks as spawned
processes, which join one process group (NCCL, or gloo on the CPU) over
``tcp://localhost``, build the same Synthesizer for their mesh position
(weights drawn from the seed on each card; each keeps its rows of the
speaker table), warm up, and run the same calls in the same order (every
rank makes the calls from the seed).

The window runs on the slowest rank's clock: after each call the ranks
agree (one all-reduce) whether every one of them is past ``--seconds``,
and the window's length is the longest rank's.  With ``--trace 1`` rank 0
is traced over its first ``trace_calls`` calls; its spans feed the readers.

Correctness: rank 0's global result.  For a sample of the window's calls
(a reservoir of ``sample`` calls drawn from the seed, and the call with the
longest text), two rows of every rank's shard (its longest text and its
first row) are recomputed by the float32 reference, with each shard's
random streams: a generator seeded with ``fold_in(seed, shard)``, as
``make_sharded_synth`` seeds each batch shard, drawing the whole shard's
prenet masks and Griffin-Lim phases in the program's order.  The numbers
compared are ``synth_batch``'s."""

from __future__ import annotations

import math
import socket
import time
from dataclasses import dataclass

import numpy as np

from .. import core
from ..traffic import generate
from . import synth_batch


def fold_in(seed: int, index: int) -> int:
    """The seed of batch shard ``index`` of a call seeded ``seed``."""
    return (seed * 1_000_003 + index) % (2 ** 63 - 1)


@dataclass
class Sampled:
    """A sampled call and the rows of its global batch kept for the check."""
    call: generate.Call
    rows: list


class _Rank:
    """One rank: its process group, its Synthesizer and the sharded function."""

    def __init__(self, cell: core.Cell, seed: int, rank: int, port: int, device: str):
        import torch
        from tacotron_multispeaker_torch.parallel import distributed, make_mesh
        from tacotron_multispeaker_torch.synthesizer import Synthesizer
        self.mix, self.seed, self.rank = cell.traffic, seed, rank
        ranks = self.mix["ranks"]
        dev = torch.device(device if device == "cpu" else f"cuda:{rank}")
        distributed.initialize_distributed(
            init_method=f"tcp://localhost:{port}", world_size=ranks, rank=rank,
            local_rank=rank, device=dev, timeout=300.0)
        self.dims = core.resolve(cell.config)
        self.cfg = core.port_config(cell.config)
        self.steps = self.dims["model"]["max_iters"]
        data, model = self.mix["mesh"]
        self.mesh = make_mesh(data=data, model=model, device=dev)
        self.synth = Synthesizer(self.cfg, mesh=self.mesh, seed=0)
        self.dev = dev
        shapes = core.shapes_of(self.synth.model)
        rows = self.synth.shards.get("speaker_table.weight")
        if rows is not None:
            shapes["speaker_table.weight"] = (self.dims["model"]["num_speakers"],
                                              self.dims["model"]["speaker_embed_depth"])
        self.weights = core.draw_weights(shapes, seed, dev,
                                         fixed=cell.config.get("serve_weights"))
        mine = dict(self.weights)
        if rows is not None:
            mine["speaker_table.weight"] = mine["speaker_table.weight"][rows]
        self.synth.model.load_state_dict(mine)
        B, L = self.mix["batch"], self.mix["buckets"][0]
        self.fn = self.synth.make_sharded_synth(self.mesh, B, L, self.steps)
        self.flag = torch.zeros(1, device=dev)
        rng = generate.rng_for(seed, 3)
        for _ in range(2):
            texts = [generate.text_of(rng, L - 1) for _ in range(B)]
            self.call(generate.Call(texts, [0] * B, L, int(rng.integers(0, 2**62))))
        torch.distributed.barrier()

    def arrays(self, call):
        from tacotron_multispeaker_torch.text import text_to_sequence
        L = call.bucket
        seqs = [np.asarray(text_to_sequence(t, self.cfg.cleaners), np.int64)[:L]
                for t in call.texts]
        return (np.stack([np.pad(s, (0, L - len(s))) for s in seqs]),
                np.asarray([len(s) for s in seqs]), np.asarray(call.speaker_ids))

    def call(self, call):
        """One global call: the id arrays made, the sharded function, the wait."""
        import torch
        out = self.fn(*self.arrays(call), seed=call.seed)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        return out

    def loop(self, seconds: float, trace: int = 0, tracer=None, on_call=None):
        """Calls until every rank is past ``seconds`` and rank 0's trace has
        closed → (call times, the window on the slowest rank's clock)."""
        import torch
        import torch.distributed as dist
        from torch.autograd.profiler import record_function
        calls = generate.synth_calls(self.mix, self.dims["model"]["num_speakers"], self.seed)
        times = []
        dist.barrier()
        t0 = time.perf_counter()
        if tracer:
            tracer.start()
        while True:
            call = next(calls)
            t = time.perf_counter()
            with record_function("bench.synthesize_batch"):
                wav, align, _ = self.call(call)
            done = time.perf_counter()
            times.append(done - t)
            if on_call:
                on_call(len(times) - 1, call, wav, align)
            if tracer and len(times) == trace:
                tracer.stop()
                tracer = None
            self.flag.fill_(float(done - t0 >= seconds and tracer is None))
            dist.all_reduce(self.flag, op=dist.ReduceOp.MIN)
            if self.flag.item() > 0:
                break
        self.flag.fill_(done - t0)
        dist.all_reduce(self.flag, op=dist.ReduceOp.MAX)
        dist.barrier()
        return times, float(self.flag.item())


def _worker(cell, seed: int, rank: int, port: int, device: str) -> None:
    import torch.distributed as dist
    from tacotron_multispeaker_torch.parallel import distributed
    core.set_cache_dirs()
    r = _Rank(cell, seed, rank, port, device)
    try:
        box = [None]
        dist.broadcast_object_list(box, src=0)
        r.loop(*box[0])
    finally:
        distributed.destroy()


class Driver(synth_batch.Driver):
    def setup(self) -> None:
        import torch
        import torch.multiprocessing as mp
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        ctx = mp.get_context("spawn")
        dev = "cpu" if str(self.device) == "cpu" else "cuda"
        self.procs = [ctx.Process(target=_worker, args=(self.cell, self.seed, r, port, dev),
                                  daemon=True) for r in range(1, self.mix["ranks"])]
        for p in self.procs:
            p.start()
        self.r = _Rank(self.cell, self.seed, 0, port, dev)
        self.dims, self.cfg, self.steps = self.r.dims, self.r.cfg, self.r.steps
        self.synth, self.dev, self.weights = self.r.synth, self.r.dev, self.r.weights
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)

    def window(self, seconds: float, trace: bool = False) -> dict:
        import torch.distributed as dist
        from .. import trace as tracing
        rng = generate.rng_for(self.seed, 4)
        k, n_trace = self.mix["sample"], self.mix["trace_calls"]
        tracer = tracing.Tracer(self.dev) if trace else None
        dist.broadcast_object_list([(seconds,)], src=0)
        start = self._counters()
        lengths_of = lambda call: [len(x) + 1 for x in call.texts]

        def on_call(i, call, wav, align):
            self.calls_done.append((call.bucket, lengths_of(call)))
            if tracer is not None and i + 1 == n_trace:
                self.traced = list(self.calls_done)
                self.counters = {n: v - start[n] for n, v in self._counters().items()}
            keep = None
            if i < k:
                keep = len(self.sampled)
                self.sampled.append(None)
            else:
                j = int(rng.integers(0, i + 1))
                keep = j if j < k else None
            longest = self.longest is None or max(lengths_of(call)) > max(
                lengths_of(self.longest[1].call))
            if keep is None and not longest:
                return
            s = self._sampled(call)
            entry = (i, s, wav[s.rows], align[s.rows])      # copies on the device
            if keep is not None:
                self.sampled[keep] = entry
            if longest:
                self.longest = entry

        times, span = self.r.loop(seconds, n_trace if trace else 0, tracer, on_call)
        if tracer:
            self.trace = tracer.summary()
        from ..reference.dsp import stft_params
        a = self.dims["audio"]
        B = self.mix["batch"]
        audio_s = (len(times) * B * self.steps * self.dims["model"]["outputs_per_step"]
                   * stft_params(a)[1] / a["sample_rate"])
        return {"attempted": len(times) * B, "failed": 0, "calls": len(times),
                "window_s": span, "audio_s_per_s": audio_s / span,
                "synth_call_p95_ms": float(np.percentile(np.asarray(times) * 1e3, 95)),
                "call_ms_median": float(np.median(times) * 1e3)}

    def _sampled(self, call) -> Sampled:
        """Two rows of each rank's shard: its longest text and its first row
        (its second, where the first is the longest)."""
        part = self.mix["batch"] // (self.mix["mesh"][0] * self.mix["mesh"][1])
        rows = []
        for s in range(0, self.mix["batch"], part):
            n = [len(t) for t in call.texts[s: s + part]]
            top = s + int(np.argmax(n))
            rows += [top, s + 1 if top == s else s]
        return Sampled(call, rows)

    def release(self) -> None:
        import torch
        from tacotron_multispeaker_torch.parallel import distributed
        distributed.destroy()
        for p in self.procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
        bad = [p.exitcode for p in self.procs if p.exitcode]
        del self.synth, self.r
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        if bad:
            raise RuntimeError(f"a rank ended with exit code {bad[0]}")

    def sample(self) -> list:
        picked = {i: (s, wav, align) for i, s, wav, align in self.sampled}
        if self.longest is not None:
            i, s, wav, align = self.longest
            picked[i] = (s, wav, align)
        return [(s, wav.cpu().numpy(), align.cpu().numpy())
                for s, wav, align in (picked[i] for i in sorted(picked))]

    def reference(self, sampled: Sampled, rounding: str = "f32"):
        """The reference's (waveforms, alignments, magnitudes) of the sampled
        rows: each shard that holds one decoded whole with its own seed."""
        import torch
        from ..reference import dsp as rdsp
        from ..reference.model import Tacotron
        from ..reference.precision import ROUNDING, no_tf32
        from ..reference.text import encode
        no_tf32()
        dev, call = self.dev, sampled.call
        L = call.bucket
        part = self.mix["batch"] // (self.mix["mesh"][0] * self.mix["mesh"][1])
        ref = Tacotron(self.weights, self.dims, ROUNDING[rounding])
        wavs, aligns, mags = {}, {}, {}
        for shard in sorted({r // part for r in sampled.rows}):
            sl = slice(shard * part, (shard + 1) * part)
            ids = [encode(t)[:L] for t in call.texts[sl]]
            inputs = torch.as_tensor(np.stack([np.pad(x, (0, L - len(x))) for x in ids]),
                                     device=dev)
            lengths = torch.as_tensor([len(x) for x in ids], device=dev)
            sids = torch.as_tensor(call.speaker_ids[sl], device=dev)
            gen = torch.Generator(device=dev).manual_seed(fold_in(call.seed, shard))
            draw = lambda shape: torch.rand(shape, generator=gen, device=dev)
            with torch.no_grad():
                _, linear, align = ref.generate(inputs, lengths, sids, self.steps, draw)
                angles = draw(tuple(linear.shape)) * (2.0 * math.pi) - math.pi
                mine = [r - shard * part for r in sampled.rows if r // part == shard]
                w = rdsp.waveform(linear[mine], self.dims["audio"], angles[mine],
                                  ROUNDING[rounding]).cpu().numpy()
                m = rdsp.magnitude(linear[mine], self.dims["audio"]).cpu().numpy()
            for j, r in enumerate(mine):
                wavs[r + shard * part] = w[j]
                aligns[r + shard * part] = align[r].cpu().numpy()
                mags[r + shard * part] = m[j]
        rows = sampled.rows
        return (np.stack([wavs[r] for r in rows]), np.stack([aligns[r] for r in rows]),
                np.stack([mags[r] for r in rows]))
