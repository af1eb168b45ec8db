"""Inference stack: text → WAV.

Port of ``tacotron_multispeaker_tpu/synthesizer.py``.  ``synthesize(text[,
speaker_id])`` returns WAV bytes; ``synthesize_batch`` decodes a padded
batch: encoder → decoder (the fused loop, or the per-step decode; see
``Tacotron.generate``) → post-net → Griffin-Lim → each row's endpoint
(``AudioProcessor.find_endpoints``), all on the device; one pinned copy
then brings the waveform home and the host cuts each row at its endpoint by
slicing.  ``parallel.use_pallas`` routes the conv banks, the per-step
attention and Griffin-Lim through their kernels, as it does in the JAX
package.  Requests pad to the smallest input bucket that fits, as in the
JAX package.

The model is the one ``model.architecture`` names (models.create_model):
Tacotron-1, or Tacotron 2, which also gives each row's stop frame; a row is
then cut at the smaller of its stop frame and its endpoint.

``make_sharded_synth`` is pod-scale batch synthesis over a (data, model)
mesh of ranks (parallel/), one process per mesh position: each rank
decodes its shard of a global batch and every rank gets the global result.

Checkpoints: ``load_variables`` takes a flax ``{"params", "batch_stats"}``
tree of numpy arrays (convert.py); ``save`` writes the port's own
``state_dict`` file, and ``load`` reads it or a training checkpoint of the
port's train loop (utils/checkpoint.py).  Restoring an orbax checkpoint
directory stands in ROADMAP.md.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import convert, tracing
from .audio import AudioProcessor
from .audio import dsp
from .config import Config
from .data.feeder import pad_axis
from .device import resolve_device
from .models import create_model
from .parallel.distributed import all_gather
from .parallel.mesh import keep_shards, param_shards
from .text import text_to_sequence
from .training import _fold_generator, _shard_table, sharded_speaker_embed
from .utils import checkpoint


class Synthesizer:
    """``device=None`` means the CUDA device (and raises without one);
    ``device="cpu"`` runs the plain PyTorch path.  Weights start random,
    drawn with flax's initialisers from ``seed``.

    ``mesh`` (parallel.make_mesh): this Synthesizer is one rank of the mesh,
    on the mesh's device, and keeps only its part of the parameters that
    shard (``param_shards``: the speaker table's rows over ``model``), so it
    serves ``make_sharded_synth`` and not the single-card calls."""

    def __init__(self, cfg: Config, device=None, seed: int = 0, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None and device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's {mesh.device}")
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.shards = param_shards(cfg, mesh) if mesh is not None else {}
        gen = torch.Generator().manual_seed(seed)
        model = keep_shards(create_model(cfg.model.architecture, cfg).reset_parameters(gen),
                            self.shards)
        self.model = model.to(self.device).eval()
        self.ap = AudioProcessor(cfg.audio, self.device)
        self.last_mel = None            # synthesize_batch's last decoder frames

    # -- loading -------------------------------------------------------------

    def load_variables(self, variables) -> "Synthesizer":
        """Weights from a flax ``{"params", "batch_stats"}`` tree (nested
        dicts of numpy arrays)."""
        state = convert.flax_to_state_dict(variables, self.model, self.shards)
        self.model.load_state_dict(
            {k: v.to(self.device) for k, v in state.items()}, strict=True)
        return self

    def save(self, path: str) -> None:
        torch.save(self.model.state_dict(), path)

    def load(self, path: str) -> "Synthesizer":
        """Weights from a ``save`` file, a training checkpoint file, or a
        checkpoint directory (its latest; utils/checkpoint.py)."""
        self.model.load_state_dict(checkpoint.load_model_state(path, self.device), strict=True)
        return self

    # -- public API ----------------------------------------------------------

    def synthesize_batch(self, texts: list[str],
                         speaker_ids: list[int] | None = None,
                         max_iters: int | None = None, seed: int = 0,
                         pad_to: int | None = None, gl_angles=None):
        """Returns (list of trimmed np wavs, alignments [B, steps, L]).

        Each row's endpoint (``AudioProcessor.find_endpoint``'s, bit for bit,
        or a model's stop frame × hop where that is smaller) is found on the
        device; the whole waveform, the endpoints and the alignments come
        home in one copy (pinned memory on a CUDA device),
        and each returned wav is a view of its row up to the endpoint.  The
        arrays of a call never share memory with another call's: on a CUDA
        device they hold the call's page-locked block (PyTorch's caching host
        allocator rounds it up to a power of two, 64 MiB for a [32, 275000]
        waveform) until the last of them is dropped.  So a call made while
        earlier results are held takes another block, and pins a new one
        (tens of ms) where the allocator has none of that size free.

        ``seed`` seeds the prenet dropout masks and the Griffin-Lim initial
        phases; ``gl_angles`` ([B, frames, bins]) replaces the latter.  The
        call's decoder frames (mel [B, T, M] before the post-net, on the
        device) stay in ``last_mel`` until the next call."""
        if self.shards:
            raise ValueError("this Synthesizer keeps only its rows of the speaker table "
                             "(mesh=): serve through make_sharded_synth")
        cfg = self.cfg
        dev = self.device
        with tracing.span("synth.call", device=dev, rows=len(texts)) as call:
            with tracing.span("synth.prepare"):
                seqs = [np.asarray(text_to_sequence(t, cfg.cleaners), np.int64)
                        for t in texts]
                maxlen = pad_to or max(len(s) for s in seqs)
                call.note(bucket=maxlen)
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
                angles = None if gl_angles is None else torch.as_tensor(
                    np.array(gl_angles, np.float32), device=dev)
            wavs, aligns, self.last_mel, stops = self._make_fn(iters)(inputs, lengths, sids,
                                                                      gen, angles)
            with tracing.span("synth.trim") as trim:
                ends = self.ap.find_endpoints(wavs)
                if stops is not None:
                    ends = torch.minimum(ends, stops * cfg.audio.hop_length)
            with tracing.span("synth.copy"):
                wavs, ends, aligns = _to_host(dev, wavs, ends, aligns)
            trim.note(rows_cut=int((ends < wavs.shape[1]).sum()),
                      kept=float(ends.sum()) / max(wavs.size, 1))
        return [w[:e] for w, e in zip(wavs, ends)], aligns

    # -- the decode+vocode function -------------------------------------------

    def _make_fn(self, max_iters: int, model=None, speaker_embed_fn=None, cfg=None):
        """``fn(inputs, lengths, speaker_ids, generator, gl_angles) -> (wav
        [B, samples], alignments [B, steps, L], mel [B, T, M], stop frames
        [B] or None)``: generate, post-net and Griffin-Lim; the stop frames
        where the model gives them (Tacotron 2), else None.
        ``speaker_embed_fn(speaker_ids) -> [B, E]`` replaces the model's
        table lookup (the sharded table's gather); ``model`` and ``cfg``
        override the Synthesizer's for the mesh-routed builds."""
        cfg = cfg or self.cfg
        model = model or self.model
        audio = cfg.audio

        def fn(inputs, lengths, speaker_ids, generator, gl_angles=None):
            with torch.inference_mode():
                if speaker_embed_fn is not None:
                    spk = dict(speaker_embed=speaker_embed_fn(speaker_ids))
                else:
                    spk = dict(speaker_ids=speaker_ids if cfg.model.num_speakers > 1 else None)
                out = model.generate(inputs, lengths, **spk, max_iters=max_iters,
                                     generator=generator)
                with tracing.span("synth.griffin_lim", device=out.mel_outputs.device) as gl:
                    gl.note(gl_bins=dsp.gl_bins(self.ap.params.n_fft, audio.gl_method))
                    spec = out.linear_outputs.transpose(1, 2)         # [B, bins, T]
                    wav = dsp.inv_linear_spectrogram(
                        spec, self.ap.params, preemph=audio.preemphasis,
                        ref_level_db=audio.ref_level_db, min_level_db=audio.min_level_db,
                        power=audio.power, gl_iters=audio.griffin_lim_iters,
                        generator=generator, gl_method=audio.gl_method,
                        gl_momentum=audio.gl_momentum, use_pallas=cfg.parallel.use_pallas,
                        angles=gl_angles)
            return wav, out.alignments, out.mel_outputs, getattr(out, "stop_frames", None)

        return fn

    def make_sharded_synth(self, mesh, batch: int, length: int,
                           max_iters: int | None = None):
        """Pod-scale batch synthesis (BASELINE.json config 5) over a (data,
        model) mesh of ranks: port of the JAX ``make_sharded_synth``.

        Every rank calls it, on a Synthesizer built for ``mesh``, and then
        calls the returned ``fn(inputs, lengths, speaker_ids, seed=0,
        gl_angles=None) -> (wav, alignments, mel)`` with the global batch
        (inputs [batch, length]; ``gl_angles`` the global Griffin-Lim initial
        phases [batch, frames, bins]); each rank decodes its shard, and every
        rank gets the global result back (tensors on its device).  Three
        branches, as in the JAX package:

        * pure data parallelism (a model axis of 1): each rank runs the
          single-card path (fused decoder loop and all) on its batch shard;
        * hybrid (``parallel.hybrid_model_axis`` and a batch that divides by
          the mesh size): the batch shards over data × model, and the
          speaker vectors come from the row-sharded table
          (``sharded_speaker_embed``);
        * sequence-sharded (otherwise): the batch shards over ``data`` and
          the encoder length over ``model``; the decode runs per step with
          the distributed-softmax attention (kernel 10), the kernels of
          ``use_pallas``, ``use_pallas_decode`` and ``use_pallas_gru`` off.

        Prenet dropout and the drawn Griffin-Lim phases are seeded per batch
        shard from (seed, shard index): the data index (the ranks of one
        mesh row draw alike in the sequence-sharded branch), or the rank in
        the hybrid branch.  ``batch`` must divide by the data axis and, with
        a model axis above 1, ``length`` by the model axis."""
        if mesh is not self.mesh:
            raise ValueError("make_sharded_synth needs the Synthesizer built for this "
                             "mesh: Synthesizer(cfg, mesh=mesh)")
        cfg = self.cfg
        iters = max_iters or cfg.model.max_iters
        n_data, n_model = mesh.data, mesh.model
        if batch % n_data != 0:
            raise ValueError(f"batch {batch} not divisible by data axis {n_data}")
        if n_model > 1 and length % n_model != 0:
            raise ValueError(f"padded length {length} not divisible by model axis {n_model}")
        shard_table = _shard_table(cfg)
        rows = self.shards.get("speaker_table.weight")
        seq = False
        if n_model == 1:
            # pure data parallelism: no collectives in the decode
            run = self._make_fn(iters)
            part, index, group = n_data, mesh.data_index, mesh.data_group
        elif (cfg.parallel.hybrid_model_axis
              and (not shard_table or cfg.model.num_speakers % n_model == 0)
              and batch % mesh.size == 0):
            embed = None
            if shard_table:
                embed = lambda sids: sharded_speaker_embed(
                    self.model.speaker_table.weight, rows.start, sids, mesh)
            run = self._make_fn(iters, speaker_embed_fn=embed)
            part, index, group = mesh.size, mesh.rank, mesh.world_group
        else:
            seq_cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(
                cfg.parallel, use_pallas=False, use_pallas_decode=False,
                use_pallas_gru=False))
            model = keep_shards(create_model("tacotron", seq_cfg, seq_mesh=mesh), self.shards)
            model.load_state_dict(self.model.state_dict(), assign=True)   # shares tensors
            model.to(self.device).eval()
            embed = None
            if shard_table:
                embed = lambda sids: sharded_speaker_embed(
                    model.speaker_table.weight, rows.start, sids, mesh, batch_sharded=False)
            run = self._make_fn(iters, model=model, speaker_embed_fn=embed, cfg=seq_cfg)
            part, index, group, seq = n_data, mesh.data_index, mesh.data_group, True
        b_local = batch // part
        dev = self.device

        def fn(inputs, lengths, speaker_ids, seed: int = 0, gl_angles=None):
            with tracing.span("synth.call", device=dev, rows=batch, bucket=length):
                inputs = torch.as_tensor(inputs, device=dev).long()
                if tuple(inputs.shape) != (batch, length):
                    raise ValueError(f"inputs {tuple(inputs.shape)}, built for "
                                     f"{(batch, length)}")
                mine = slice(index * b_local, (index + 1) * b_local)
                lengths = torch.as_tensor(lengths, device=dev).long()[mine]
                sids = (None if speaker_ids is None
                        else torch.as_tensor(speaker_ids, device=dev).long()[mine])
                angles = None if gl_angles is None else torch.as_tensor(
                    gl_angles[mine], dtype=torch.float32, device=dev)
                gen = _fold_generator(seed, index, dev)
                wav, align, mel, _ = run(inputs[mine], lengths, sids, gen, angles)
                with torch.inference_mode(), tracing.span("synth.gather"):
                    if seq:                       # alignments: this rank's slice of L
                        align = all_gather(align, 2, mesh.model_group)
                    return tuple(all_gather(t, 0, group) for t in (wav, align, mel))

        return fn

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


def _to_host(dev, *tensors) -> list[np.ndarray]:
    """The tensors as numpy arrays on the host.  On a CUDA device: a
    non-blocking copy of each into page-locked memory from PyTorch's caching
    host allocator, then one wait.  Each call takes blocks of its own, held
    while any array of them lives, so a later call never writes into arrays
    returned earlier."""
    if dev.type != "cuda":
        return [t.numpy() for t in tensors]
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(dev).synchronize()
    return [h.numpy() for h in host]
