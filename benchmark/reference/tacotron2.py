"""Tacotron 2 with SV2TTS speaker conditioning in plain float32 PyTorch
(Shen et al., arXiv:1712.05884 §2.2-2.3, the step order of
NVIDIA/tacotron2's ``Decoder.decode``; Jia et al., arXiv:1806.04558 §2.2),
inference only, one loop iteration a decoder step, no graphs:

    encoder: embedding → 3 × (SAME conv → BatchNorm eps 1e-5 → ReLU), the
             padding zeroed before each conv → BiLSTM over each row's length
             → [outputs, unit-length speaker vector] (the memory)
    step t:  p = prenet(y_{t-1}; masks_t)                       (y_0 = 0)
             h1, c1 = Z(LSTM_att([p, ctx], h1, c1))
             a = masked softmax(v·tanh(W_q h1 + keys + W_loc conv(acc)) + b)
             ctx = a @ memory;  acc += a
             h2, c2 = Z(LSTM_dec([h1, ctx], h2, c2))
             y_t = W_f [h2, ctx] + b_f;  s_t = W_s [h2, ctx] + b_s
    post-net: 5 × (SAME conv → BatchNorm), tanh on the first four, a residual
    linear: the mel through the mel basis's pseudo-inverse, clamped at 1e-10

LSTM cells as ``torch.nn.LSTMCell`` (gates i, f, g, o); Z is zoneout at test
time, z·prev + (1 − z)·new for both states.  ``W`` maps the port's
``state_dict`` names to float32 tensors; ``dims`` is the configuration as a
plain dict; ``q`` rounds every product's operands (``precision.py``).  It
imports nothing of the port."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .dsp import mel_basis
from .model import reverse_within, time_mask
from .precision import f32


class Tacotron2:
    def __init__(self, W: dict, dims: dict, q=f32):
        self.W, self.q = W, q
        self.m, self.a = dims["model"], dims["audio"]

    def dense(self, x, name, bias=True):
        y = self.q(x) @ self.q(self.W[name + ".weight"]).t()
        return y + self.W[name + ".bias"] if bias else y

    def conv_bn(self, x, name):
        """SAME conv over [B, T, C], then BatchNorm on its running statistics."""
        w = self.W[name + ".conv.weight"]
        xp = F.pad(self.q(x).transpose(1, 2), ((w.shape[-1] - 1) // 2, w.shape[-1] // 2))
        y = F.conv1d(xp, self.q(w), self.W[name + ".conv.bias"]).transpose(1, 2)
        bn = name + ".bn."
        return ((y - self.W[bn + "mean"]) * torch.rsqrt(self.W[bn + "var"] + 1e-5)
                * self.W[bn + "scale"] + self.W[bn + "bias"])

    def cell(self, x, h, c, w_ih, w_hh, b):
        """One LSTM cell: → (h', c') before zoneout."""
        g = self.q(x) @ self.q(w_ih).t() + self.q(h) @ self.q(w_hh).t() + b
        i, f, gg, o = g.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        return torch.sigmoid(o) * torch.tanh(c), c

    def lstm(self, x, name):
        """One direction of ``torch.nn.LSTM`` over x [B, T, C] from zero states."""
        W = self.W
        w_ih, w_hh = W[name + ".weight_ih_l0"], W[name + ".weight_hh_l0"]
        b = W[name + ".bias_ih_l0"] + W[name + ".bias_hh_l0"]
        h = x.new_zeros((x.shape[0], w_hh.shape[1]))
        c = torch.zeros_like(h)
        out = []
        for t in range(x.shape[1]):
            h, c = self.cell(x[:, t], h, c, w_ih, w_hh, b)
            out.append(h)
        return torch.stack(out, 1)

    def encoder(self, inputs, lengths, speaker_ids):
        m = self.m
        tm = time_mask(lengths, inputs.shape[1])[..., None]
        x = self.W["embedding.weight"][inputs]
        for i in range(m["encoder_conv_layers"]):
            x = torch.relu(self.conv_bn(torch.where(tm, x, 0.0), f"encoder_convs.{i}"))
        x = torch.where(tm, x, 0.0)
        fw = self.lstm(x, "encoder_lstm_fw")
        bw = reverse_within(self.lstm(reverse_within(x, lengths), "encoder_lstm_bw"), lengths)
        mem = torch.cat([fw, bw], -1)
        if m["num_speakers"] > 1 and m["speaker_condition"]:
            s = self.W["speaker_table.weight"][speaker_ids]
            s = s / torch.clamp(s.norm(dim=-1, keepdim=True), min=1e-12)
            mem = torch.cat([mem, s[:, None].expand(*mem.shape[:2], -1)], -1)
        return mem

    def decoder(self, memory, mask, masks, S, feed=None):
        """S steps → (frames [B, S, M], alignments [B, S, L], stop logits [B, S]).
        ``feed`` = (frames [B, S, M], alignments [B, S, L]) of another decode:
        teacher forcing, step t's prenet takes that decode's frame t − 1 and
        its location term that decode's cumulative alignments to t − 1, in
        place of its own."""
        W, m, z = self.W, self.m, self.m["zoneout"]
        B, L, D = memory.shape
        H, M = m["decoder_lstm_units"], self.a["num_mels"]
        keys = self.dense(memory, "attention.memory", bias=False)
        v = self.q(W["attention.v"])
        conv_w = W["attention.loc_conv.weight"]
        width = conv_w.shape[-1]
        rnn = lambda n: (W[n + ".weight_ih"], W[n + ".weight_hh"],
                         W[n + ".bias_ih"] + W[n + ".bias_hh"])
        att, dec = rnn("attention_rnn"), rnn("decoder_rnn")
        h1, c1, h2, c2 = (memory.new_zeros((B, H)) for _ in range(4))
        ctx, acc, y = memory.new_zeros((B, D)), memory.new_zeros((B, L)), memory.new_zeros((B, M))
        qmem = self.q(memory)
        frames, aligns, stops = [], [], []
        for t in range(S):
            p = y
            for i in range(len(m["prenet_depths"])):
                p = torch.relu(self.dense(p, f"dec_prenet.dense_{i}")) * masks[i][t]
            h, c = self.cell(torch.cat([p, ctx], -1), h1, c1, *att)
            h1, c1 = z * h1 + (1.0 - z) * h, z * c1 + (1.0 - z) * c
            query = self.dense(h1, "attention.query", bias=False)
            pad = F.pad(self.q(acc)[:, None], ((width - 1) // 2, width // 2))
            loc = self.dense(F.conv1d(pad, self.q(conv_w)).transpose(1, 2),
                             "attention.loc_proj", bias=False)
            e = self.q(torch.tanh(keys + query[:, None] + loc)) @ v + W["attention.b"]
            e = torch.where(mask, e, torch.full_like(e, -1e9))
            a = torch.exp(e - e.max(-1, keepdim=True).values) * mask
            a = a / torch.clamp(a.sum(-1, keepdim=True), min=1e-9)
            ctx = torch.bmm(self.q(a)[:, None], qmem)[:, 0]
            acc = acc + (a if feed is None else feed[1][:, t])
            h, c = self.cell(torch.cat([h1, ctx], -1), h2, c2, *dec)
            h2, c2 = z * h2 + (1.0 - z) * h, z * c2 + (1.0 - z) * c
            out = torch.cat([h2, ctx], -1)
            y = self.dense(out, "frame_proj")
            frames.append(y)
            if feed is not None:
                y = feed[0][:, t]
            stops.append(self.dense(out, "stop_proj")[:, 0])
            aligns.append(a)
        return torch.stack(frames, 1), torch.stack(aligns, 1), torch.stack(stops, 1)

    def postnet(self, mel):
        x = mel
        n = self.m["postnet_conv_layers"]
        for i in range(n):
            x = self.conv_bn(x, f"postnet.{i}")
            if i < n - 1:
                x = torch.tanh(x)
        return mel + x

    def mel_to_linear(self, mel):
        """Normalised mel → normalised linear spectrogram (Real-Time-Voice-
        Cloning's ``inv_mel_spectrogram`` before Griffin-Lim)."""
        a = self.a
        lo, ref = a["min_level_db"], a["ref_level_db"]
        n_fft = (a["num_freq"] - 1) * 2
        basis = mel_basis(a["sample_rate"], n_fft, a["num_mels"]).astype(np.float64)
        inv = torch.as_tensor(np.linalg.pinv(basis).T.astype(np.float32), device=mel.device)
        amp = torch.pow(10.0, (torch.clamp(mel, 0.0, 1.0) * -lo + lo + ref) * 0.05)
        lin = torch.clamp(self.q(amp) @ self.q(inv), min=1e-10)
        db = 20.0 * torch.log10(torch.clamp(lin, min=1e-5)) - ref
        return torch.clamp((db - lo) / -lo, 0.0, 1.0)

    def generate(self, inputs, lengths, speaker_ids, S, draw, feed=None):
        """→ (post-net mel [B, S, M], linear [B, S, bins], alignments [B, S, L],
        stop logits [B, S], decoder mel [B, S, M]).  ``draw(shape)`` gives
        the uniform draws: one [S, B, width] a prenet layer, in order;
        ``feed``: the decoder's teacher forcing (:meth:`decoder`)."""
        m = self.m
        B, L = inputs.shape
        memory = self.encoder(inputs, lengths, speaker_ids)
        keep = 1.0 - m["prenet_dropout"]
        masks = [(draw((S, B, n)) < keep).float() / keep for n in m["prenet_depths"]]
        frames, aligns, stops = self.decoder(memory, time_mask(lengths, L), masks, S, feed)
        post = self.postnet(frames)
        return post, self.mel_to_linear(post), aligns, stops, frames


def stop_frames(stop_logits: torch.Tensor, threshold: float) -> torch.Tensor:
    """[B, S] → the 1-based first step whose σ(logit) exceeds ``threshold``, or S."""
    S = stop_logits.shape[1]
    out = []
    for row in torch.sigmoid(stop_logits):
        hits = (row > threshold).nonzero()
        out.append(int(hits[0]) + 1 if len(hits) else S)
    return torch.as_tensor(out)
