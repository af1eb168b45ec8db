"""Multispeaker Tacotron-1, inference path.

Port of ``tacotron_multispeaker_tpu/models/tacotron.py``: char embedding →
[speaker conditioning] → prenet → encoder CBHG → attention GRU decoder
emitting r mel frames per step → post-net CBHG → linear spectrogram
projection.  ``forward`` is the teacher-forced training path: the decoder
runs as one fused differentiable scan (ops/teacher_decoder.py) for Bahdanau
attention, and as a per-step loop under autograd for location attention
(the JAX package's XLA scan; no kernel of its own).  ``generate``
runs the whole autoregressive decode as one fused decoder loop
(ops/decoder_loop.py) for Bahdanau attention with a two-layer prenet and
``parallel.use_pallas_decode``, and otherwise as a per-step decode of
:meth:`DecoderCell.step` (the JAX package's scan), whose attention runs in
the attention-step kernel under ``parallel.use_pallas``.  Both CBHG BiGRUs
are fused differentiable scans (ops/gru_scan.py); ``parallel.use_pallas``
also routes both conv banks through their kernel (ops/conv_bank.py).
Module and parameter names mirror the flax tree, so convert.py maps one
onto the other by name.

With ``seq_mesh`` (``Synthesizer.make_sharded_synth``'s sequence-sharded
branch) ``generate`` cuts the encoder memory, keys and mask to this rank's
slice of the encoder length, and the per-step decode's attention combines
the slices across the mesh's model axis (models/attention.py).

``self.training`` plays the part of flax's ``train`` flag for the
BatchNorms (batch statistics and running-statistic updates in training
mode); ``generate`` always uses the running statistics, as the JAX
package's ``generate(train=False)`` default does.  Prenet dropout is on in
both modes.  ``bn_group`` (a process group: the JAX ``bn_axis``) gives every
BatchNorm cross-replica statistics in training mode.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch
from torch import nn

from .. import tracing
from ..config import Config
from ..ops import decoder_loop as dl_ops
from ..ops import teacher_decoder as td_ops
from ..text import vocab_size
from .attention import AttentionState, init_state, make_attention
from .helpers import feedback_frame, teacher_inputs
from .modules import CBHG, BatchNorm, ConvBank, Dense, GRUCellParams, Prenet


class TacotronOutput(NamedTuple):
    mel_outputs: torch.Tensor      # [B, T, num_mels] float32
    linear_outputs: torch.Tensor   # [B, T, num_freq] float32
    alignments: torch.Tensor       # [B, T/r, L] float32


class DecoderCarry(NamedTuple):
    """The per-step decode's carry (flax ``DecoderCarry``)."""
    attn_h: torch.Tensor           # [B, H] compute dtype
    dec_hs: tuple                  # N × [B, H] compute dtype
    context: torch.Tensor          # [B, D] compute dtype
    attn_state: AttentionState
    prev_frame: torch.Tensor       # [B, num_mels] f32, the fed-back frame


def _compute_dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.model.compute_dtype == "bfloat16" else torch.float32


def _speaker_dim(cfg: Config, point: str) -> int:
    m = cfg.model
    return (m.speaker_embed_depth
            if m.num_speakers > 1 and point in m.speaker_condition else 0)


class Encoder(nn.Module):
    """Char embedding (+speaker concat) → prenet → CBHG memory."""

    def __init__(self, cfg: Config, dtype: torch.dtype, bn_group=None):
        super().__init__()
        m = cfg.model
        self.cfg = cfg
        self.compute_dtype = dtype
        self.embedding = nn.Embedding(vocab_size(), m.embed_depth)
        self.prenet = Prenet(m.embed_depth + _speaker_dim(cfg, "encoder_prenet"),
                             m.prenet_depths, m.prenet_dropout, dtype)
        half = m.encoder_depth // 2
        self.cbhg = CBHG(m.prenet_depths[-1], m.encoder_bank_k,
                         m.encoder_bank_channels, m.encoder_proj_channels,
                         m.encoder_highway_layers, highway_depth=half,
                         gru_units=half, dtype=dtype, use_pallas=cfg.parallel.use_pallas,
                         bn_group=bn_group)

    def forward(self, inputs: torch.Tensor, input_lengths: torch.Tensor,
                speaker_embed: torch.Tensor | None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        cond = self.cfg.model.speaker_condition
        x = self.embedding(inputs).to(self.compute_dtype)             # [B, L, E]
        if speaker_embed is not None and "encoder_prenet" in cond:
            s = speaker_embed[:, None, :].to(x.dtype).expand(*x.shape[:2], -1)
            x = torch.cat([x, s], dim=-1)
        x = self.prenet(x, generator)
        memory = self.cbhg(x, input_lengths)                          # [B, L, 2*half]
        if speaker_embed is not None and "memory" in cond:
            s = speaker_embed[:, None, :].to(memory.dtype).expand(*memory.shape[:2], -1)
            memory = torch.cat([memory, s], dim=-1)
        return memory


class DecoderCell(nn.Module):
    """The decoder step's parameters (flax ``decoder_cell``): attention GRU
    over [prenet, context], dec_in Dense over [attn_h, context], the
    residual GRU stack and the r×num_mels projection.  :meth:`step` is one
    step of the per-step decode; the fused decode runs the same step in
    ops/decoder_loop.py."""

    def __init__(self, cfg: Config, memory_depth: int, dtype: torch.dtype):
        super().__init__()
        m = cfg.model
        H = m.decoder_depth
        self.r, self.num_mels = m.outputs_per_step, cfg.audio.num_mels
        self.n_layers = m.decoder_layers
        self.attn_rnn = GRUCellParams(m.prenet_depths[-1] + memory_depth, H, dtype)
        self.dec_in = Dense(H + memory_depth, H, dtype=dtype)
        for i in range(m.decoder_layers):
            setattr(self, f"dec_rnn_{i}", GRUCellParams(H, H, dtype))
        self.frame_proj = Dense(H, m.outputs_per_step * cfg.audio.num_mels,
                                dtype=dtype)

    @property
    def dec_rnns(self) -> list[GRUCellParams]:
        return [getattr(self, f"dec_rnn_{i}") for i in range(self.n_layers)]

    def step(self, attention: nn.Module, carry: DecoderCarry, prenet_out: torch.Tensor,
             keys: torch.Tensor, memory: torch.Tensor, mask: torch.Tensor):
        """One step (flax ``DecoderCell.__call__``) → (carry, (frames
        [B, r·M] f32, alignments [B, L] f32))."""
        cell_in = torch.cat([prenet_out, carry.context.to(prenet_out.dtype)], dim=-1)
        attn_h = self.attn_rnn.step(carry.attn_h, cell_in)
        context, align, attn_state = attention(attn_h, keys, memory, mask, carry.attn_state)
        x = self.dec_in(torch.cat([attn_h, context.to(attn_h.dtype)], dim=-1))
        new_hs = []
        for cell, h in zip(self.dec_rnns, carry.dec_hs):
            h_new = cell.step(h, x)
            x = x + h_new                                  # residual stack
            new_hs.append(h_new)
        frames = self.frame_proj(x)                        # [B, r*M]
        last = feedback_frame(frames, self.r, self.num_mels).float()
        return (DecoderCarry(attn_h, tuple(new_hs), context, attn_state, last),
                (frames.float(), align))


class Tacotron(nn.Module):
    """The full model; ``forward`` is the teacher-forced training path,
    ``generate`` the autoregressive inference path."""

    def __init__(self, cfg: Config, seq_mesh=None, bn_group=None):
        super().__init__()
        c, m = cfg, cfg.model
        self.cfg = cfg
        self.seq_mesh = seq_mesh
        self.dtype = _compute_dtype(cfg)
        memory_depth = m.encoder_depth + _speaker_dim(cfg, "memory")
        self.encoder = Encoder(c, self.dtype, bn_group)
        self.dec_prenet = Prenet(c.audio.num_mels, m.prenet_depths,
                                 m.prenet_dropout, self.dtype)
        self.attention = make_attention(m, memory_depth, self.dtype,
                                        use_pallas=c.parallel.use_pallas, seq_mesh=seq_mesh,
                                        seq_kernel=c.parallel.use_pallas_seq_attention)
        self.decoder_cell = DecoderCell(c, memory_depth, self.dtype)
        half = m.postnet_depth // 2
        self.post_cbhg = CBHG(c.audio.num_mels, m.postnet_bank_k,
                              m.postnet_bank_channels, m.postnet_proj_channels,
                              m.postnet_highway_layers, highway_depth=half,
                              gru_units=m.postnet_gru_units, dtype=self.dtype,
                              use_pallas=c.parallel.use_pallas, bn_group=bn_group)
        self.linear_proj = Dense(2 * m.postnet_gru_units, c.audio.num_freq,
                                 dtype=self.dtype)
        if m.num_speakers > 1:
            self.speaker_table = nn.Embedding(m.num_speakers, m.speaker_embed_depth)
            if "decoder_init" in m.speaker_condition:
                self.state_init_proj = Dense(
                    m.speaker_embed_depth, (m.decoder_layers + 1) * m.decoder_depth,
                    dtype=self.dtype)
        # (key, DecoderWeights) of the last _fused_decoder_weights build
        self._dec_weights_cache = None

    def _apply(self, fn, *args, **kwargs):
        self._dec_weights_cache = None
        return super()._apply(fn, *args, **kwargs)

    # -- initialisation ------------------------------------------------------

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> "Tacotron":
        """Random weights with flax's initialisers, drawn from ``generator``
        (a CPU generator): lecun-normal (truncated) kernels, zero biases
        unless a layer sets ``bias_init`` (GRU gates 1.0, highway T −1.0),
        embeddings normal with std 1/sqrt(features), BatchNorm identity."""
        def lecun(w: torch.Tensor, fan_in: int):
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)

        for mod in self.modules():
            if isinstance(mod, Dense):
                lecun(mod.weight, mod.in_features)
                if mod.bias is not None:
                    mod.bias.fill_(mod.bias_init)
            elif isinstance(mod, (nn.Conv1d, ConvBank)):
                lecun(mod.weight, mod.weight.shape[1] * mod.weight.shape[2])
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                nn.init.normal_(mod.weight, 0.0, 1.0 / math.sqrt(mod.embedding_dim),
                                generator=generator)
            elif isinstance(mod, BatchNorm):
                mod.scale.fill_(1.0)
                mod.bias.zero_()
                mod.mean.zero_()
                mod.var.fill_(1.0)
        lecun(self.attention.v, self.attention.v.shape[0])
        return self

    # -- shared pieces -------------------------------------------------------

    def _speaker_embed(self, speaker_ids):
        if self.cfg.model.num_speakers <= 1 or speaker_ids is None:
            return None
        return self.speaker_table(speaker_ids).to(self.dtype)

    def _init_carry(self, batch: int, speaker_embed, device):
        """(attn_h0 [B, H], dec_h0 [N, B, H]), both f32."""
        m = self.cfg.model
        H, N = m.decoder_depth, m.decoder_layers
        if speaker_embed is not None and "decoder_init" in m.speaker_condition:
            init = torch.tanh(self.state_init_proj(speaker_embed))
            parts = torch.split(init, H, dim=-1)
            return (parts[0].float().contiguous(),
                    torch.stack(parts[1:]).float().contiguous())
        return (torch.zeros((batch, H), dtype=torch.float32, device=device),
                torch.zeros((N, batch, H), dtype=torch.float32, device=device))

    def _postnet(self, mel: torch.Tensor, target_lengths: torch.Tensor) -> torch.Tensor:
        post = self.post_cbhg(mel.to(self.dtype), target_lengths)
        return self.linear_proj(post).float()

    def _fused_decoder_weights(self) -> dl_ops.DecoderWeights:
        """The decoder parameters as ops.decoder_loop.DecoderWeights ([in,
        out] matrices in the compute dtype, f32 biases), pre-split at the
        concat boundaries (prenet|context, attn_h|context).

        Without grad the build is cached, keyed by each source parameter's
        storage and version counter, so a ``load_state_dict`` or any
        in-place update rebuilds it; a move or cast (``_apply``) drops it."""
        params = [*self.dec_prenet.parameters(), *self.decoder_cell.parameters(),
                  *self.attention.parameters()]
        if torch.is_grad_enabled():
            return self._build_decoder_weights()
        key = tuple((p.data_ptr(), p._version, p.dtype) for p in params)
        if self._dec_weights_cache is None or self._dec_weights_cache[0] != key:
            self._dec_weights_cache = (key, self._build_decoder_weights())
        return self._dec_weights_cache[1]

    def _build_decoder_weights(self) -> dl_ops.DecoderWeights:
        m = self.cfg.model
        P2, H = m.prenet_depths[-1], m.decoder_depth
        pn, cell = self.dec_prenet, self.decoder_cell
        k = lambda lin: lin.weight.t()
        xg, xc, di = k(cell.attn_rnn.xg), k(cell.attn_rnn.xc), k(cell.dec_in)
        rnns = cell.dec_rnns
        return dl_ops.DecoderWeights(
            w1=k(pn.dense_0), b1=pn.dense_0.bias,
            w2=k(pn.dense_1), b2=pn.dense_1.bias,
            a_xg_pn=xg[:P2], a_xg_ctx=xg[P2:], a_bg=cell.attn_rnn.xg.bias,
            a_xc_pn=xc[:P2], a_xc_ctx=xc[P2:], a_bc=cell.attn_rnn.xc.bias,
            a_hg=k(cell.attn_rnn.hg), a_hc=k(cell.attn_rnn.hc),
            wq=k(self.attention.query), v=self.attention.v,
            d_h=di[:H], d_ctx=di[H:], d_b=cell.dec_in.bias,
            l_xg=tuple(k(c.xg) for c in rnns), l_bg=tuple(c.xg.bias for c in rnns),
            l_xc=tuple(k(c.xc) for c in rnns), l_bc=tuple(c.xc.bias for c in rnns),
            l_hg=tuple(k(c.hg) for c in rnns), l_hc=tuple(k(c.hc) for c in rnns),
            wf=k(cell.frame_proj), bf=cell.frame_proj.bias).cast(self.dtype)

    # -- teacher-forced training path ---------------------------------------

    def _teacher_weights(self):
        """(TeacherDecoderWeights, w_pn [P2, 3H], b_pn [3H]) built as the
        JAX package's ``teacher_mel`` builds them: the prenet halves of the
        attention-GRU input projections merged for one batched matmul, the
        three context-consuming projections merged into ``w_ctx`` [D, 4H]
        ([dec_in ctx | attn xg ctx | attn xc ctx]), each residual GRU's two
        input projections merged into ``w_r`` [H, 3H].  Differentiable: the
        gradients flow back to the module parameters."""
        m, dt = self.cfg.model, self.dtype
        P2, H = m.prenet_depths[-1], m.decoder_depth
        cell = self.decoder_cell
        k = lambda lin: lin.weight.t().to(dt)
        bias = lambda lin: lin.bias.to(dt)
        wxg, wxc, wd = k(cell.attn_rnn.xg), k(cell.attn_rnn.xc), k(cell.dec_in)
        w_pn = torch.cat([wxg[:P2], wxc[:P2]], dim=1)
        b_pn = torch.cat([bias(cell.attn_rnn.xg), bias(cell.attn_rnn.xc)])
        rnns = cell.dec_rnns
        weights = td_ops.TeacherDecoderWeights(
            a_hg=k(cell.attn_rnn.hg), a_hc=k(cell.attn_rnn.hc),
            wq=k(self.attention.query), v=self.attention.v,
            w_ctx=torch.cat([wd[H:], wxg[P2:], wxc[P2:]], dim=1),
            wd_h=wd[:H], d_b=bias(cell.dec_in),
            w_r=tuple(torch.cat([k(c.xg), k(c.xc)], dim=1) for c in rnns),
            b_r=tuple(torch.cat([bias(c.xg), bias(c.xc)]) for c in rnns),
            hg=tuple(k(c.hg) for c in rnns), hc=tuple(k(c.hc) for c in rnns))
        return weights.cast(dt), w_pn, b_pn

    def teacher_mel(self, inputs: torch.Tensor, input_lengths: torch.Tensor,
                    mel_targets: torch.Tensor, speaker_ids: torch.Tensor | None = None,
                    generator: torch.Generator | None = None,
                    speaker_embed: torch.Tensor | None = None):
        """Encoder + teacher-forced decoder to mel (no post-net) →
        (mel [B, T, M] f32, alignments [B, T/r, L] f32).  ``speaker_embed``
        [B, E] stands in for the table lookup of ``speaker_ids``, as in
        :meth:`generate`."""
        m = self.cfg.model
        bahdanau = m.attention_type == "bahdanau"
        if not bahdanau and self.attention.use_pallas and torch.is_grad_enabled() and any(
                p.requires_grad for p in self.parameters()):
            raise RuntimeError(
                "location-attention training under parallel.use_pallas: the attention-step "
                "kernel has no backward, as the JAX package's attention_step_pallas has no "
                "VJP (jax.grad raises there too); train with parallel.use_pallas off, or run "
                "the forward under torch.no_grad()")
        B, L = inputs.shape
        T, M = mel_targets.shape[1], self.cfg.audio.num_mels
        H = m.decoder_depth
        dev = inputs.device
        spk = (speaker_embed.to(self.dtype) if speaker_embed is not None
               else self._speaker_embed(speaker_ids))
        memory = self.encoder(inputs, input_lengths, spk, generator).contiguous()
        keys = self.attention.precompute_keys(memory).contiguous()
        mask = (torch.arange(L, device=dev)[None, :]
                < input_lengths.to(dev)[:, None]).contiguous()
        dec_in = teacher_inputs(mel_targets, m.outputs_per_step)         # [B, S, M]
        prenet_out = self.dec_prenet(dec_in.to(self.dtype), generator)
        attn_h0, dec_h0 = self._init_carry(B, spk, dev)
        weights, w_pn, b_pn = self._teacher_weights()
        pn_proj = prenet_out @ w_pn + b_pn                               # [B, S, 3H]
        png = pn_proj[..., :2 * H].transpose(0, 1).contiguous()
        pnc = pn_proj[..., 2 * H:].transpose(0, 1).contiguous()
        if bahdanau:
            xs, aligns = td_ops.teacher_decoder(png, pnc, attn_h0, dec_h0, weights, keys,
                                                memory, mask)
        else:
            xs, aligns = self._teacher_scan(pn_proj, attn_h0, dec_h0, weights, keys, memory,
                                            mask)
        frames = self.decoder_cell.frame_proj(xs.transpose(0, 1)).float()  # [B, S, r*M]
        return frames.reshape(B, T, M), aligns.transpose(0, 1)

    def _teacher_scan(self, pn_proj, attn_h0, dec_h0, weights, keys, memory, mask):
        """The teacher-forced decoder as a per-step loop under autograd (the
        JAX ``teacher_mel`` scan, ``models/tacotron.py:376-400``), for the
        attention the fused teacher decoder does not run (location): the
        merged projections of :meth:`_teacher_weights`, the step of
        :meth:`DecoderCell.step` with the teacher-forced prenet projections
        ``pn_proj`` [B, S, 3H] in place of the fed-back frames, and the
        module's own attention step (the location conv and projection in
        plain PyTorch; its energies in the attention-step kernel under
        ``parallel.use_pallas``, inference only).  → (xs [S, B, H], aligns
        [S, B, L] f32), the fused decoder's layout."""
        dt, H = self.dtype, self.cfg.model.decoder_depth
        cell = self.decoder_cell
        B, L = keys.shape[:2]
        attn_h = attn_h0.to(dt)
        hs = [h.to(dt) for h in dec_h0]
        state = init_state(B, L, keys.device)
        ctx_blk = torch.zeros((B, 4 * H), dtype=dt, device=keys.device)   # zero context @ w_ctx
        d_b = weights.d_b.to(dt)                           # the biases in the compute dtype
        b_rs = [b.to(dt) for b in weights.b_r]
        xs, aligns = [], []
        for pn_t in pn_proj.unbind(1):
            attn_h = cell.attn_rnn.step_from_proj(attn_h, pn_t[:, :2 * H] + ctx_blk[:, H:3 * H],
                                                  pn_t[:, 2 * H:] + ctx_blk[:, 3 * H:])
            context, align, state = self.attention(attn_h, keys, memory, mask, state)
            ctx_blk = context.to(dt) @ weights.w_ctx
            x = attn_h @ weights.wd_h + ctx_blk[:, :H] + d_b
            for i, (rnn, w_r, b_r) in enumerate(zip(cell.dec_rnns, weights.w_r, b_rs)):
                xgc = x @ w_r + b_r
                hs[i] = rnn.step_from_proj(hs[i], xgc[:, :2 * H], xgc[:, 2 * H:])
                x = x + hs[i]                              # residual stack
            xs.append(x)
            aligns.append(align)
        return torch.stack(xs), torch.stack(aligns)

    def forward(self, inputs: torch.Tensor, input_lengths: torch.Tensor,
                mel_targets: torch.Tensor, speaker_ids: torch.Tensor | None = None,
                generator: torch.Generator | None = None,
                speaker_embed: torch.Tensor | None = None) -> TacotronOutput:
        """Teacher-forced pass (flax ``Tacotron.__call__``).  The post-net
        sees every one of the T frames of every row (target_lengths = T),
        not the batch's lengths, as in the JAX package."""
        mel_out, aligns = self.teacher_mel(inputs, input_lengths, mel_targets,
                                           speaker_ids, generator, speaker_embed)
        B, T = mel_out.shape[:2]
        target_lengths = torch.full((B,), T, dtype=torch.long, device=mel_out.device)
        linear_out = self._postnet(mel_out, target_lengths)
        return TacotronOutput(mel_out, linear_out, aligns)

    def batch_norms(self) -> list[BatchNorm]:
        return [mod for mod in self.modules() if isinstance(mod, BatchNorm)]

    def set_bn_group(self, group) -> "Tacotron":
        """Point every BatchNorm at ``group`` (cross-replica statistics; None
        is per-rank), as the JAX step builders re-create the model with
        ``bn_axis``."""
        for mod in self.batch_norms():
            mod.group = group
        return self

    # -- autoregressive inference path --------------------------------------

    @contextlib.contextmanager
    def _running_statistics(self):
        """BatchNorms on their running statistics whatever ``self.training``
        says; their modes come back afterwards."""
        norms = [(mod, mod.training) for mod in self.batch_norms()]
        for mod, _ in norms:
            mod.training = False
        try:
            yield
        finally:
            for mod, was in norms:
                mod.training = was

    def generate(self, inputs: torch.Tensor, input_lengths: torch.Tensor,
                 speaker_ids: torch.Tensor | None = None,
                 max_iters: int | None = None,
                 generator: torch.Generator | None = None,
                 speaker_embed: torch.Tensor | None = None) -> TacotronOutput:
        """Encoder → decode of ``max_iters`` steps (prenet dropout on, its
        masks drawn up front from ``generator``, one [steps, B, width] draw
        per prenet layer in order) → post-net.  ``speaker_embed`` [B, E]
        stands in for the table lookup of ``speaker_ids`` (the sharded
        table's gather, training.sharded_speaker_embed).

        The fused decoder loop runs iff attention is Bahdanau, the prenet
        has two layers, ``parallel.use_pallas_decode`` is set and the decode
        is not sequence-sharded; otherwise the per-step decode runs
        :meth:`DecoderCell.step` once per step (the JAX package's scan).
        Both draw the same masks from the same generator.  Under
        ``seq_mesh`` the alignments are this rank's slice [B, steps, L/M]."""
        m = self.cfg.model
        B, L = inputs.shape
        r, M = m.outputs_per_step, self.cfg.audio.num_mels
        n_steps = max_iters if max_iters is not None else m.max_iters
        dev = inputs.device

        with self._running_statistics(), tracing.span("synth.encoder", device=dev):
            spk = (speaker_embed.to(self.dtype) if speaker_embed is not None
                   else self._speaker_embed(speaker_ids))
            memory = self.encoder(inputs, input_lengths, spk, generator).contiguous()
            keys = self.attention.precompute_keys(memory).contiguous()
        with tracing.span("synth.decode", device=dev):
            mask = (torch.arange(L, device=dev)[None, :]
                    < input_lengths.to(dev)[:, None]).contiguous()
            if self.seq_mesh is not None:
                # this rank's slice of the encoder length (the JAX tacotron.py:473-483)
                n, j = self.seq_mesh.model, self.seq_mesh.model_index
                if L % n:
                    raise ValueError(f"input length {L} not divisible by model axis {n}")
                sl = slice(j * (L // n), (j + 1) * (L // n))
                memory, keys, mask = (t[:, sl].contiguous() for t in (memory, keys, mask))
            attn_h0, dec_h0 = self._init_carry(B, spk, dev)
            keep = 1.0 - m.prenet_dropout
            masks = None
            if keep < 1.0:
                masks = [(torch.rand((n_steps, B, n), generator=generator, device=dev)
                          < keep).float() / keep for n in m.prenet_depths]
            fused = (self.seq_mesh is None and m.attention_type == "bahdanau"
                     and len(m.prenet_depths) == 2 and self.cfg.parallel.use_pallas_decode)
            if fused:
                if masks is None:
                    masks = [torch.ones((n_steps, B, n), device=dev) for n in m.prenet_depths]
                frames, aligns = dl_ops.decoder_loop(
                    self._fused_decoder_weights(), keys, memory, mask, masks[0], masks[1],
                    attn_h0, dec_h0, n_steps, M)
                mel_out = frames.transpose(0, 1).reshape(B, n_steps * r, M)
                aligns = aligns.transpose(0, 1)
            else:
                mel_out, aligns = self._per_step_decode(keys, memory, mask, attn_h0, dec_h0,
                                                        masks, n_steps)
        target_lengths = torch.full((B,), n_steps * r, dtype=torch.long, device=dev)
        with self._running_statistics(), tracing.span("synth.postnet", device=dev):
            linear_out = self._postnet(mel_out, target_lengths)
        return TacotronOutput(mel_out, linear_out, aligns)

    def _per_step_decode(self, keys, memory, mask, attn_h0, dec_h0, masks, n_steps):
        """The decode as a Python loop over :meth:`DecoderCell.step` →
        (mel [B, S·r, M] f32, alignments [B, S, L] f32).  The carry starts
        as the JAX package's: states in the compute dtype, zero context,
        zero attention state, zero fed-back frame."""
        B, L = keys.shape[:2]
        dt, M = self.dtype, self.cfg.audio.num_mels
        carry = DecoderCarry(
            attn_h=attn_h0.to(dt), dec_hs=tuple(h.to(dt) for h in dec_h0),
            context=torch.zeros((B, memory.shape[-1]), dtype=dt, device=keys.device),
            attn_state=init_state(B, L, keys.device),
            prev_frame=torch.zeros((B, M), dtype=torch.float32, device=keys.device))
        frames, aligns = [], []
        for t in range(n_steps):
            pn = self.dec_prenet.forward_masked(
                carry.prev_frame.to(dt), None if masks is None else [mk[t] for mk in masks])
            carry, (fr, al) = self.decoder_cell.step(self.attention, carry, pn, keys,
                                                     memory, mask)
            frames.append(fr)
            aligns.append(al)
        mel_out = torch.stack(frames, dim=1).reshape(B, n_steps * self.cfg.model.outputs_per_step, M)
        return mel_out, torch.stack(aligns, dim=1)
