"""The plain float32 reference of the port's Tacotron 2 + SV2TTS for the
tests: the equations of Shen et al. (arXiv:1712.05884 §2.2-2.3) in the
step order of NVIDIA/tacotron2's ``Decoder.decode``, with SV2TTS's
unit-length speaker vectors (Jia et al., arXiv:1806.04558 §2.2) concatenated
to the encoder outputs.  Inference only, one loop iteration a decoder step,
no graphs; LSTM cells as ``torch.nn.LSTMCell`` (gates i, f, g, o); zoneout
at test time, z·prev + (1 − z)·new.  ``W`` maps the port's ``state_dict``
names to float32 tensors, ``dims`` is ``dataclasses.asdict`` of the
configuration.  It imports no JAX, nothing of the JAX package and nothing
of the port."""


from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F



def mel_basis(sample_rate: int, n_fft: int, num_mels: int) -> np.ndarray:
    """[num_mels, bins] Slaney mel filterbank with Slaney normalisation."""
    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0)
                        / (np.log(6.4) / 27.0), f / (200.0 / 3))

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)),
                        m * 200.0 / 3)

    fft_f = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    hz = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sample_rate / 2.0), num_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - fft_f[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    w *= (2.0 / (hz[2:num_mels + 2] - hz[:num_mels]))[:, None]
    return w.astype(np.float32)


def time_mask(lengths: torch.Tensor, T: int) -> torch.Tensor:
    return torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]


def reverse_within(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Each [B, T, C] row reversed inside its length, the padding in place."""
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    n = lengths[:, None]
    idx = torch.where(t < n, n - 1 - t, t)
    return torch.gather(x, 1, idx[..., None].expand_as(x))


class Tacotron2:
    def __init__(self, W: dict, dims: dict):
        self.W = W
        self.m, self.a = dims["model"], dims["audio"]

    def dense(self, x, name, bias=True):
        y = x @ self.W[name + ".weight"].t()
        return y + self.W[name + ".bias"] if bias else y

    def conv_bn(self, x, name):
        """SAME conv over [B, T, C], then BatchNorm on its running statistics."""
        w = self.W[name + ".conv.weight"]
        xp = F.pad(x.transpose(1, 2), ((w.shape[-1] - 1) // 2, w.shape[-1] // 2))
        y = F.conv1d(xp, w, self.W[name + ".conv.bias"]).transpose(1, 2)
        bn = name + ".bn."
        return ((y - self.W[bn + "mean"]) * torch.rsqrt(self.W[bn + "var"] + 1e-5)
                * self.W[bn + "scale"] + self.W[bn + "bias"])

    def cell(self, x, h, c, w_ih, w_hh, b):
        """One LSTM cell: → (h', c') before zoneout."""
        g = x @ w_ih.t() + h @ w_hh.t() + b
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

    def decoder(self, memory, mask, masks, S):
        """S steps → (frames [B, S, M], alignments [B, S, L], stop logits [B, S])."""
        W, m, z = self.W, self.m, self.m["zoneout"]
        B, L, D = memory.shape
        H, M = m["decoder_lstm_units"], self.a["num_mels"]
        keys = self.dense(memory, "attention.memory", bias=False)
        v = W["attention.v"]
        conv_w = W["attention.loc_conv.weight"]
        width = conv_w.shape[-1]
        rnn = lambda n: (W[n + ".weight_ih"], W[n + ".weight_hh"],
                         W[n + ".bias_ih"] + W[n + ".bias_hh"])
        att, dec = rnn("attention_rnn"), rnn("decoder_rnn")
        h1, c1, h2, c2 = (memory.new_zeros((B, H)) for _ in range(4))
        ctx, acc, y = memory.new_zeros((B, D)), memory.new_zeros((B, L)), memory.new_zeros((B, M))
        qmem = memory
        frames, aligns, stops = [], [], []
        for t in range(S):
            p = y
            for i in range(len(m["prenet_depths"])):
                p = torch.relu(self.dense(p, f"dec_prenet.dense_{i}")) * masks[i][t]
            h, c = self.cell(torch.cat([p, ctx], -1), h1, c1, *att)
            h1, c1 = z * h1 + (1.0 - z) * h, z * c1 + (1.0 - z) * c
            query = self.dense(h1, "attention.query", bias=False)
            pad = F.pad(acc[:, None], ((width - 1) // 2, width // 2))
            loc = self.dense(F.conv1d(pad, conv_w).transpose(1, 2),
                             "attention.loc_proj", bias=False)
            e = torch.tanh(keys + query[:, None] + loc) @ v + W["attention.b"]
            e = torch.where(mask, e, torch.full_like(e, -1e9))
            a = torch.exp(e - e.max(-1, keepdim=True).values) * mask
            a = a / torch.clamp(a.sum(-1, keepdim=True), min=1e-9)
            ctx = torch.bmm(a[:, None], qmem)[:, 0]
            acc = acc + a
            h, c = self.cell(torch.cat([h1, ctx], -1), h2, c2, *dec)
            h2, c2 = z * h2 + (1.0 - z) * h, z * c2 + (1.0 - z) * c
            out = torch.cat([h2, ctx], -1)
            y = self.dense(out, "frame_proj")
            frames.append(y)
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
        lin = torch.clamp(amp @ inv, min=1e-10)
        db = 20.0 * torch.log10(torch.clamp(lin, min=1e-5)) - ref
        return torch.clamp((db - lo) / -lo, 0.0, 1.0)

    def generate(self, inputs, lengths, speaker_ids, S, draw):
        """→ (post-net mel [B, S, M], linear [B, S, bins], alignments [B, S, L],
        stop logits [B, S], decoder mel [B, S, M]).  ``draw(shape)`` gives
        the uniform draws: one [S, B, width] a prenet layer, in order."""
        m = self.m
        B, L = inputs.shape
        memory = self.encoder(inputs, lengths, speaker_ids)
        keep = 1.0 - m["prenet_dropout"]
        masks = [(draw((S, B, n)) < keep).float() / keep for n in m["prenet_depths"]]
        frames, aligns, stops = self.decoder(memory, time_mask(lengths, L), masks, S)
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
