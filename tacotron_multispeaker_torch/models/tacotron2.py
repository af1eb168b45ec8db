"""Tacotron 2 with SV2TTS speaker conditioning, inference path.

Shen et al., arXiv:1712.05884 §2.2-2.3, in the step order of
NVIDIA/tacotron2's ``Decoder.decode``, with the speaker vectors of SV2TTS
(Jia et al., arXiv:1806.04558 §2.2): char embedding → 3 × (conv → BatchNorm
→ ReLU) → a BiLSTM, each output concatenated with the row's unit-length
speaker vector (the memory) → the decode, r = 1 frame a step → the post-net
(5 convs with BatchNorm, tanh on the first four, added as a residual) → the
linear spectrogram through the mel basis's pseudo-inverse
(``audio/dsp.py mel_to_linear``).  The port's own model: the JAX package
has no Tacotron 2.

One decoder step t, from zero states, zero context and y_0 = 0::

    p      = prenet(y_{t-1}; masks_t)
    h1, c1 = Z(LSTM_att([p, ctx_{t-1}], h1, c1))
    a_t    = masked softmax of v·tanh(W_q h1 + keys + W_loc * acc_{t-1})
    ctx_t  = sum_l a_t,l memory_l;   acc_t = acc_{t-1} + a_t
    h2, c2 = Z(LSTM_dec([h1, ctx_t], h2, c2))
    [y_t, s_t] = W [h2, ctx_t] + b

The LSTM cells are ``torch.nn.LSTMCell``'s (gates i, f, g, o, the two
biases summed); Z is zoneout at test time, ``c = z·c_prev + (1 − z)·c'``
and the same for h (``model.zoneout``).  The location term is the attention
module's width-31 convolution of the cumulative alignments and its
projection, folded into one [31, A] product.  Products run in the compute
dtype (bf16 with f32 sums); the LSTM states, cell states, context and
alignments are f32.  Each LSTM's input and recurrent matrices are
concatenated and cast once, when the weights change, not once a step.

The attention step is ``LocationSensitiveAttention``'s parameters with
kernel 9 (ops/attention_step.py) under ``parallel.use_pallas`` and its
plain version otherwise.  On the CPU the decode is a loop of steps.  On a
CUDA device the same step is captured as a CUDA graph of K steps
(``GRAPH_STEPS``, cut to a divisor of the step count) at the first call of
each (batch, input length), and a call replays it S/K times:
no Python runs per step (each replay adds the attention kernel's captured
launches to its counters).  The state, the chunk's prenet masks and its
outputs live in static buffers; the masks are drawn up front from the
call's generator, outside the graph, as in Tacotron-1.  Nothing in the
graph waits for the host.

A row stops at its first step whose σ(stop logit) exceeds
``model.stop_threshold``: ``stop_frames`` gives the 1-based step (the
frames a row keeps), or the step count where it never stops, found on the
device with no host sync.  The batch always runs every step.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import tracing
from ..audio import dsp
from ..config import Config
from ..ops import attention_step as as_ops
from ..text import vocab_size
from .attention import LocationSensitiveAttention
from .modules import BatchNorm, Dense, Prenet, reverse_sequences

# the launch counters of ops/attention_step.py that a step moves.  Its
# wrapper counts when Python calls it, so the capture, which launches
# nothing, is taken off them, and each replay adds what the capture recorded
_COUNTERS = ("launches", "direct_launches")


def _count(launches: dict, times: int = 1) -> None:
    for k, n in launches.items():
        setattr(as_ops, k, getattr(as_ops, k) + n * times)


# decoder steps a captured CUDA graph holds: at 1,000 steps and B=32 on an
# H100, K from 10 to 250 gave the same untraced call time (PERF.md §6)
GRAPH_STEPS = 50


class Tacotron2Output:
    """``generate``'s result: the fields of ``TacotronOutput`` and the stop.
    ``linear_outputs`` is computed from the post-net mel when first read
    (the ``synth.mel_to_linear`` span), so the Synthesizer's Griffin-Lim
    span covers it, as it covers Tacotron-1's spectrogram to amplitudes."""

    def __init__(self, mel_outputs, postnet_outputs, alignments, stop_frames, stop_logits,
                 audio):
        self.mel_outputs = mel_outputs          # [B, T, num_mels] f32, the decoder's frames
        self.postnet_outputs = postnet_outputs  # [B, T, num_mels] f32, after the post-net
        self.alignments = alignments            # [B, T, L] f32
        self.stop_frames = stop_frames          # [B] int64, frames each row keeps
        self.stop_logits = stop_logits          # [B, T] f32
        self._audio = audio

    @functools.cached_property
    def linear_outputs(self) -> torch.Tensor:
        """[B, T, num_freq] f32, the normalised linear spectrogram of the
        post-net's mel."""
        a = self._audio
        with tracing.span("synth.mel_to_linear", device=self.postnet_outputs.device):
            return dsp.mel_to_linear(self.postnet_outputs, sample_rate=a.sample_rate,
                                     n_fft=a.n_fft, ref_level_db=a.ref_level_db,
                                     min_level_db=a.min_level_db)


class DecodeWeights(NamedTuple):
    """The decoder's parameters as the step reads them: [in, out] matrices
    and biases in the compute dtype, the rows in the order of the step's
    input buffer ([p | h1 | ctx | h2], :class:`DecodeState`)."""
    p0: torch.Tensor               # prenet
    pb0: torch.Tensor
    p1: torch.Tensor
    pb1: torch.Tensor
    w1: torch.Tensor               # attention LSTM [P + H + D, 4H], rows p | h1 | ctx
    b1: torch.Tensor
    wq: torch.Tensor               # [H, A]
    wloc: torch.Tensor             # [width, A]: the location conv and projection
    v: torch.Tensor                # [A]
    w2: torch.Tensor               # decoder LSTM [H + D + H, 4H], rows h1 | ctx | h2
    b2: torch.Tensor
    wp: torch.Tensor               # [D + H, M + 1], rows ctx | h2: the frame and stop
    bp: torch.Tensor


class DecodeState(NamedTuple):
    """The decode's carry, updated in place each step.  ``x`` holds the
    products' inputs side by side in the compute dtype, [p | h1 | ctx |
    h2], so that each LSTM and the projections read one slice of it:
    the attention LSTM [p, h1, ctx_{t-1}], the decoder LSTM [h1, ctx, h2]
    and the projections [ctx, h2]."""
    h1: torch.Tensor               # [B, H] f32
    c1: torch.Tensor
    h2: torch.Tensor
    c2: torch.Tensor
    acc: torch.Tensor              # [B, L] f32, the cumulative alignments
    acc_pad: torch.Tensor          # [B, L + width - 1] compute dtype, acc with SAME padding
    x: torch.Tensor                # [B, P + H + D + H] compute dtype

    @classmethod
    def zeros(cls, B, L, P, H, D, width, dtype, device) -> "DecodeState":
        f32 = dict(dtype=torch.float32, device=device)
        return cls(*(torch.zeros((B, H), **f32) for _ in range(4)), torch.zeros((B, L), **f32),
                   torch.zeros((B, L + width - 1), dtype=dtype, device=device),
                   torch.zeros((B, P + H + D + H), dtype=dtype, device=device))

    def reset(self) -> None:
        for t in self:
            t.zero_()


def lstm_update(gates: torch.Tensor, h: torch.Tensor, c: torch.Tensor, zoneout: float,
                h_out: torch.Tensor | None = None) -> None:
    """One ``torch.nn.LSTMCell`` update from its summed gate pre-activations
    [B, 4H] (i, f, g, o), then zoneout's test-time rule, into the f32 states
    ``h`` and ``c`` in place; ``h_out`` takes h in its dtype."""
    H = h.shape[1]
    g = gates.float()
    sig = torch.sigmoid(g)
    c_new = sig[:, H:2 * H] * c
    c_new.addcmul_(sig[:, :H], torch.tanh(g[:, 2 * H:3 * H]))
    h_new = torch.tanh(c_new).mul_(sig[:, 3 * H:])
    c.lerp_(c_new, 1.0 - zoneout)
    h.lerp_(h_new, 1.0 - zoneout)
    if h_out is not None:
        h_out.copy_(h)


def stop_frames(stop_logits: torch.Tensor, threshold: float) -> torch.Tensor:
    """[B, S] → int64 [B]: the 1-based first step whose σ(logit) exceeds
    ``threshold``, or S; on the logits' device, no host sync."""
    hit = torch.sigmoid(stop_logits) > threshold
    return torch.where(hit.any(1), hit.int().argmax(1) + 1, stop_logits.shape[1])


class ConvNorm(nn.Module):
    """SAME conv1d → BatchNorm (eps 1e-5, as ``torch.nn.BatchNorm1d``) on
    [B, T, C] in the compute dtype; the activation is the caller's."""

    def __init__(self, in_channels: int, channels: int, width: int, dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = dtype
        self.conv = nn.Conv1d(in_channels, channels, width)
        self.bn = BatchNorm(channels, dtype, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, w = self.compute_dtype, self.conv.kernel_size[0]
        xp = F.pad(x.to(dt).transpose(1, 2), ((w - 1) // 2, w // 2))
        y = F.conv1d(xp, self.conv.weight.to(dt), self.conv.bias.to(dt)).transpose(1, 2)
        return self.bn(y)


class _Captured:
    """The decode of one (B, L) as a CUDA graph of K steps, over static
    buffers: the inputs, the state, the chunk's masks and its outputs (each
    step's frame and stop logit in the compute dtype, the next step's
    input; the chunk's first step reads the previous chunk's last).
    ``launches``: the attention kernel's launches the graph holds, by
    counter (``_COUNTERS``)."""

    def __init__(self, model: "Tacotron2", B: int, L: int, K: int, device):
        m, dt = model.cfg.model, model.dtype
        D, M = model.memory_depth, model.cfg.audio.num_mels
        with torch.inference_mode(False), torch.no_grad():
            z = lambda *shape, dtype=dt: torch.zeros(shape, dtype=dtype, device=device)
            self.keys, self.memory = z(B, L, m.attention_depth), z(B, L, D)
            self.mask = z(B, L, dtype=torch.bool)
            self.state = model.decode_state(B, L, device)
            self.masks = [z(K, B, n) for n in m.prenet_depths]
            self.proj, self.aligns = z(K, B, M + 1), z(K, B, L, dtype=torch.float32)
        self.model, self.K = model, K
        self.graph = None

    def reset(self) -> None:
        self.state.reset()
        self.proj.zero_()

    def _chunk(self, w: DecodeWeights) -> None:
        M = self.proj.shape[-1] - 1
        for k in range(self.K):
            self.model._step(w, self.state, self.keys, self.memory, self.mask,
                             [mk[k] for mk in self.masks], self.proj[k - 1][:, :M],
                             self.proj[k], self.aligns[k])

    def capture(self, w: DecodeWeights, pool) -> None:
        """One eager chunk on a side stream (the libraries' handles, the
        attention kernel's plan), then the capture."""
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream(device=cur.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._chunk(w)
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = {k: getattr(as_ops, k) for k in _COUNTERS}
        with torch.cuda.graph(graph, pool=pool):
            self._chunk(w)
        self.launches = {k: getattr(as_ops, k) - n for k, n in before.items()}
        _count(self.launches, -1)
        self.graph = graph


class Tacotron2(nn.Module):
    """Tacotron 2 + SV2TTS; ``generate`` is the inference path (the port has
    no Tacotron 2 training)."""

    def __init__(self, cfg: Config, seq_mesh=None, bn_group=None):
        super().__init__()
        if seq_mesh is not None:
            raise NotImplementedError("Tacotron 2 has no sequence-sharded decode")
        m, a = cfg.model, cfg.audio
        self.cfg = cfg
        self.dtype = torch.bfloat16 if m.compute_dtype == "bfloat16" else torch.float32
        dt = self.dtype
        if m.outputs_per_step != 1 or m.attention_type != "location":
            raise ValueError("Tacotron 2 decodes one frame a step with location attention")
        if tuple(m.speaker_condition) not in ((), ("encoder_output",)):
            raise ValueError(f"Tacotron 2 conditions on the encoder output only, not "
                             f"{m.speaker_condition}")
        spk = m.speaker_embed_depth if m.num_speakers > 1 and m.speaker_condition else 0
        self.memory_depth = D = 2 * m.encoder_lstm_units + spk
        H, C = m.decoder_lstm_units, m.encoder_conv_channels
        self.embedding = nn.Embedding(vocab_size(), m.embed_depth)
        self.encoder_convs = nn.ModuleList(
            ConvNorm(m.embed_depth if i == 0 else C, C, m.encoder_conv_width, dt)
            for i in range(m.encoder_conv_layers))
        self.encoder_lstm_fw = nn.LSTM(C, m.encoder_lstm_units, batch_first=True)
        self.encoder_lstm_bw = nn.LSTM(C, m.encoder_lstm_units, batch_first=True)
        if spk:
            self.speaker_table = nn.Embedding(m.num_speakers, m.speaker_embed_depth)
        self.attention = LocationSensitiveAttention(
            m.attention_depth, H, D, m.attention_location_filters,
            m.attention_location_kernel, dt, use_pallas=cfg.parallel.use_pallas)
        self.dec_prenet = Prenet(a.num_mels, m.prenet_depths, m.prenet_dropout, dt)
        self.attention_rnn = nn.LSTMCell(m.prenet_depths[-1] + D, H)
        self.decoder_rnn = nn.LSTMCell(H + D, H)
        self.frame_proj = Dense(H + D, a.num_mels, dtype=dt)
        self.stop_proj = Dense(H + D, 1, dtype=dt)
        P = m.postnet_conv_channels
        n = m.postnet_conv_layers
        self.postnet = nn.ModuleList(
            ConvNorm(a.num_mels if i == 0 else P, a.num_mels if i == n - 1 else P,
                     m.postnet_conv_width, dt) for i in range(n))
        self._weights_cache = None          # (key, DecodeWeights)
        self._graphs = {}                   # (B, L, K) → _Captured
        self._pool = None

    def _apply(self, fn, *args, **kwargs):
        self._weights_cache, self._graphs, self._pool = None, {}, None
        return super()._apply(fn, *args, **kwargs)

    # -- initialisation ------------------------------------------------------

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> "Tacotron2":
        """Random weights drawn from ``generator`` (a CPU generator):
        lecun-normal (truncated) matrices and convolution kernels, zero
        biases, embeddings normal with std 1/sqrt(features), BatchNorm
        identity."""
        def lecun(w: torch.Tensor):
            std = math.sqrt(1.0 / (w[0].numel())) / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)

        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if isinstance(self.get_submodule(name.rpartition(".")[0]), BatchNorm):
                continue
            if isinstance(self.get_submodule(name.rpartition(".")[0]), nn.Embedding):
                nn.init.normal_(p, 0.0, 1.0 / math.sqrt(p.shape[-1]), generator=generator)
            elif p.dim() >= 2 or leaf == "v":
                lecun(p if p.dim() >= 2 else p[None])
            else:
                p.zero_()
        for mod in self.modules():
            if isinstance(mod, BatchNorm):
                mod.scale.fill_(1.0)
                mod.bias.zero_()
                mod.mean.zero_()
                mod.var.fill_(1.0)
        return self

    # -- pieces ----------------------------------------------------------------

    def train(self, mode: bool = True) -> "Tacotron2":
        """Inference only: every module stays in eval mode, the BatchNorms
        on their running statistics."""
        return super().train(False)

    def speaker_vectors(self, speaker_ids: torch.Tensor) -> torch.Tensor:
        """The table's rows scaled to unit length (as d-vectors are), f32."""
        e = self.speaker_table(speaker_ids).float()
        return e / torch.clamp(e.norm(dim=-1, keepdim=True), min=1e-12)

    def encode(self, inputs: torch.Tensor, lengths: torch.Tensor,
               speaker: torch.Tensor | None) -> torch.Tensor:
        """→ memory [B, L, D] in the compute dtype: the convs and the BiLSTM
        over each row's first ``lengths`` positions (the padding zeroed
        before every conv; the backward LSTM runs over each row reversed
        inside its length), then the speaker vector [B, E] at every position."""
        B, L = inputs.shape
        keep = (torch.arange(L, device=inputs.device)[None, :]
                < lengths.to(inputs.device)[:, None])[..., None]
        x = self.embedding(inputs).to(self.dtype)
        for conv in self.encoder_convs:
            x = torch.relu(conv(torch.where(keep, x, 0.0)))
        x = torch.where(keep, x, 0.0).float()
        fw, _ = self.encoder_lstm_fw(x)
        bw, _ = self.encoder_lstm_bw(reverse_sequences(x, lengths))
        memory = torch.cat([fw, reverse_sequences(bw, lengths)], dim=-1).to(self.dtype)
        if speaker is not None:
            memory = torch.cat([memory, speaker.to(self.dtype)[:, None, :].expand(B, L, -1)],
                               dim=-1)
        return memory

    def decode_weights(self) -> DecodeWeights:
        """The step's matrices, built once for each version of the
        parameters (keyed by each one's storage and version counter, so a
        ``load_state_dict`` or any in-place update rebuilds them and drops
        the captured graphs, which read the old ones)."""
        params = [*self.dec_prenet.parameters(), *self.attention_rnn.parameters(),
                  *self.decoder_rnn.parameters(), *self.attention.parameters(),
                  *self.frame_proj.parameters(), *self.stop_proj.parameters()]
        key = tuple((p.data_ptr(), p._version, p.dtype) for p in params)
        if self._weights_cache is None or self._weights_cache[0] != key:
            self._graphs = {}
            with torch.no_grad():
                self._weights_cache = (key, self._build_weights())
        return self._weights_cache[1]

    def _build_weights(self) -> DecodeWeights:
        dt, att = self.dtype, self.attention
        pn, P = self.dec_prenet, self.cfg.model.prenet_depths[-1]
        mat = lambda t: t.t().to(dt).contiguous()
        a_ih, a_hh = self.attention_rnn.weight_ih, self.attention_rnn.weight_hh
        d_rnn = self.decoder_rnn
        wloc = (att.loc_proj.weight @ att.loc_conv.weight[:, 0, :]).t()
        proj = torch.cat([self.frame_proj.weight, self.stop_proj.weight])    # [M + 1, H + D]
        H = a_hh.shape[1]
        return DecodeWeights(
            p0=mat(pn.dense_0.weight), pb0=pn.dense_0.bias.to(dt),
            p1=mat(pn.dense_1.weight), pb1=pn.dense_1.bias.to(dt),
            w1=mat(torch.cat([a_ih[:, :P], a_hh, a_ih[:, P:]], dim=1)),
            b1=(self.attention_rnn.bias_ih + self.attention_rnn.bias_hh).to(dt),
            wq=mat(att.query.weight), wloc=wloc.to(dt).contiguous(), v=att.v.to(dt),
            w2=mat(torch.cat([d_rnn.weight_ih, d_rnn.weight_hh], dim=1)),
            b2=(d_rnn.bias_ih + d_rnn.bias_hh).to(dt),
            wp=mat(torch.cat([proj[:, H:], proj[:, :H]], dim=1)),
            bp=torch.cat([self.frame_proj.bias, self.stop_proj.bias]).to(dt))

    def decode_state(self, B: int, L: int, device) -> DecodeState:
        m = self.cfg.model
        return DecodeState.zeros(B, L, m.prenet_depths[-1], m.decoder_lstm_units,
                                 self.memory_depth, m.attention_location_kernel, self.dtype,
                                 device)

    def _step(self, w: DecodeWeights, s: DecodeState, keys, memory, mask, masks, prev,
              out_proj, out_align) -> None:
        """One decoder step (the module docstring's) from the previous step's
        frame ``prev`` [B, M]: the state updated in place, the frame and
        stop logit written to ``out_proj`` [B, M + 1] (compute dtype) and
        the alignments to ``out_align`` [B, L] (f32).  The same launches
        run eagerly and in a graph."""
        z = self.cfg.model.zoneout
        P, H = w.p1.shape[1], s.h1.shape[1]
        x, L = s.x, s.acc.shape[1]
        D = x.shape[1] - P - 2 * H
        p = torch.relu_(torch.addmm(w.pb0, prev, w.p0)).mul_(masks[0])
        torch.mul(torch.relu_(torch.addmm(w.pb1, p, w.p1)), masks[1], out=x[:, :P])
        lstm_update(torch.addmm(w.b1, x[:, :P + H + D], w.w1), s.h1, s.c1, z, x[:, P:P + H])
        width = w.wloc.shape[0]
        loc = s.acc_pad.unfold(1, width, 1) @ w.wloc                   # [B, L, A]
        attend = (as_ops.attention_step if self.attention.use_pallas
                  else as_ops.attention_step_reference)
        ctx, align = attend(keys, x[:, P:P + H] @ w.wq, w.v, memory, mask, loc)
        x[:, P + H:P + H + D].copy_(ctx)
        out_align.copy_(align)
        s.acc.add_(align)
        s.acc_pad[:, (width - 1) // 2:(width - 1) // 2 + L].copy_(s.acc)
        lstm_update(torch.addmm(w.b2, x[:, P:], w.w2), s.h2, s.c2, z, x[:, P + H + D:])
        torch.addmm(w.bp, x[:, P + H:], w.wp, out=out_proj)

    def _graph_steps(self, S: int) -> int:
        """K: the largest divisor of S up to ``GRAPH_STEPS``."""
        cap = max(1, min(S, GRAPH_STEPS))
        return next(k for k in range(cap, 0, -1) if S % k == 0)

    def decode(self, keys, memory, mask, masks, S: int):
        """S steps → (frames [S, B, M] f32, alignments [S, B, L] f32, stop
        logits [S, B] f32, graph replays).  ``masks``: one [S, B, width]
        prenet mask a layer (0 or 1/keep), or None for no dropout."""
        B, L = keys.shape[:2]
        dev = keys.device
        if masks is None:
            masks = [torch.ones((S, B, n), device=dev) for n in self.cfg.model.prenet_depths]
        if dev.type != "cuda":
            return (*self.decode_eager(keys, memory, mask, masks, S), 0)
        w = self.decode_weights()
        M = self.cfg.audio.num_mels
        K = self._graph_steps(S)
        cap = self._graphs.get((B, L, K))
        if cap is None:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            cap = self._graphs[(B, L, K)] = _Captured(self, B, L, K, dev)
            cap.capture(w, self._pool)
        cap.keys.copy_(keys)
        cap.memory.copy_(memory)
        cap.mask.copy_(mask)
        cap.reset()
        proj = torch.empty((S, B, M + 1), dtype=self.dtype, device=dev)
        aligns = torch.empty((S, B, L), dtype=torch.float32, device=dev)
        for j in range(S // K):
            sl = slice(j * K, (j + 1) * K)
            for buf, mk in zip(cap.masks, masks):
                buf.copy_(mk[sl])
            cap.graph.replay()
            proj[sl].copy_(cap.proj)
            aligns[sl].copy_(cap.aligns)
        _count(cap.launches, S // K)
        return proj[..., :M].float(), aligns, proj[..., M].float(), S // K

    def decode_eager(self, keys, memory, mask, masks, S: int):
        """:meth:`decode` as a loop of steps on any device, ``masks`` given
        (the card's graphs are held against it) → (frames, alignments, stop
        logits)."""
        B, L = keys.shape[:2]
        M, dev, dt = self.cfg.audio.num_mels, keys.device, self.dtype
        w = self.decode_weights()
        s = self.decode_state(B, L, dev)
        proj = torch.zeros((S + 1, B, M + 1), dtype=dt, device=dev)     # row 0: y_0 = 0
        aligns = torch.empty((S, B, L), dtype=torch.float32, device=dev)
        for t in range(S):
            self._step(w, s, keys, memory, mask, [mk[t].to(dt) for mk in masks],
                       proj[t][:, :M], proj[t + 1], aligns[t])
        return proj[1:, :, :M].float(), aligns, proj[1:, :, M].float()

    def postnet_mel(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, T, M] f32 → mel + post-net(mel), f32."""
        x = mel
        for i, conv in enumerate(self.postnet):
            x = conv(x)
            if i < len(self.postnet) - 1:
                x = torch.tanh(x)
        return mel + x.float()

    # -- inference -------------------------------------------------------------

    def generate(self, inputs: torch.Tensor, input_lengths: torch.Tensor,
                 speaker_ids: torch.Tensor | None = None,
                 max_iters: int | None = None,
                 generator: torch.Generator | None = None,
                 speaker_embed: torch.Tensor | None = None) -> Tacotron2Output:
        """Encoder → ``max_iters`` decoder steps (prenet dropout on, its masks
        drawn up front from ``generator``, one [steps, B, width] draw a
        prenet layer in order) → stop frames → post-net.  ``speaker_embed``
        [B, E] stands in for the table lookup of ``speaker_ids``; either is
        scaled to unit length."""
        m = self.cfg.model
        B, L = inputs.shape
        S = max_iters if max_iters is not None else m.max_iters
        dev = inputs.device
        with tracing.span("synth.encoder", device=dev):
            spk = None
            if speaker_embed is not None:
                spk = speaker_embed.float() / torch.clamp(
                    speaker_embed.float().norm(dim=-1, keepdim=True), min=1e-12)
            elif speaker_ids is not None and hasattr(self, "speaker_table"):
                spk = self.speaker_vectors(speaker_ids)
            memory = self.encode(inputs, input_lengths, spk).contiguous()
            keys = self.attention.precompute_keys(memory).contiguous()
        with tracing.span("synth.decode", device=dev, steps=S) as span:
            mask = (torch.arange(L, device=dev)[None, :]
                    < input_lengths.to(dev)[:, None]).contiguous()
            keep = 1.0 - m.prenet_dropout
            masks = None
            if keep < 1.0:
                masks = [(torch.rand((S, B, n), generator=generator, device=dev)
                          < keep).float() / keep for n in m.prenet_depths]
            frames, aligns, logits, replays = self.decode(keys, memory, mask, masks, S)
            span.note(replays=replays)
        logits = logits.t()                                               # [B, S]
        with tracing.span("synth.stop", device=dev) as span:
            stops = stop_frames(logits, m.stop_threshold)
            if span is not tracing.OFF:
                span.note(rows_stopped=(stops < S).sum())
        mel = frames.transpose(0, 1)                                      # [B, S, M]
        with tracing.span("synth.postnet", device=dev):
            post = self.postnet_mel(mel)
        return Tacotron2Output(mel, post, aligns.transpose(0, 1), stops, logits,
                               self.cfg.audio)
