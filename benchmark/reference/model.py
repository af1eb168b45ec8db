"""Multispeaker Tacotron-1 in plain float32 PyTorch (Wang et al.,
arXiv:1703.10135, with the speaker table of the multispeaker variant): char
embedding [+ speaker vector] → prenet (dropout always on) → CBHG encoder
[+ speaker vector] → attention GRU with Bahdanau attention → residual GRU
stack → r frames a step → post-net CBHG → linear spectrogram.  The legacy
TF GRU cell (reset gate before the candidate product); BatchNorm after the
activation, eps 1e-3; masked softmax filled with -1e9.

``W`` maps the port's ``state_dict`` names to float32 tensors; ``dims`` is
the configuration as a plain dict (``dataclasses.asdict`` of the port's
Config: sections ``model``, ``audio``, ``train``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .precision import f32


def bank_mask(K: int, C: int, device) -> torch.Tensor:
    """[K*C, 1, K]: width group g (taps g + 1) keeps its own SAME centring
    inside the fused width-K kernel."""
    j = torch.arange(K, device=device)[None, :]
    g = torch.arange(K * C, device=device)[:, None] // C
    lo = (K - 1) // 2 - g // 2
    return ((j >= lo) & (j < lo + g + 1)).float()[:, None, :]


def reverse_within(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Each [B, T, ...] row reversed inside its length, padding in place."""
    B, T = x.shape[:2]
    t = torch.arange(T, device=x.device)[None, :]
    n = lengths[:, None]
    idx = torch.where(t < n, n - 1 - t, t)
    return torch.gather(x, 1, idx.reshape(B, T, *([1] * (x.dim() - 2))).expand_as(x))


def time_mask(lengths: torch.Tensor, T: int) -> torch.Tensor:
    return torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]


class Tacotron:
    def __init__(self, W: dict, dims: dict, q=f32):
        self.W, self.q = W, q
        self.m, self.a = dims["model"], dims["audio"]

    # -- layers -----------------------------------------------------------
    def dense(self, x, name, bias=True):
        y = self.q(x) @ self.q(self.W[name + ".weight"]).t()
        return y + self.W[name + ".bias"] if bias else y

    def batch_norm(self, x, name, train):
        if train:
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(axes)
            var = torch.clamp((x * x).mean(axes) - mean * mean, min=0.0)
        else:
            mean, var = self.W[name + ".mean"], self.W[name + ".var"]
        return ((x - mean) * torch.rsqrt(var + 1e-3) * self.W[name + ".scale"]
                + self.W[name + ".bias"])

    def conv(self, x, weight, bias=None):
        """SAME conv over [B, T, C]."""
        w = weight.shape[-1]
        xp = F.pad(self.q(x).transpose(1, 2), ((w - 1) // 2, w // 2))
        y = F.conv1d(xp, self.q(weight), bias)
        return y.transpose(1, 2)

    def prenet(self, x, name, depths, draw):
        """``draw(shape)`` gives each layer's uniform draws (dropout kept
        where draw < keep, scaled by 1/keep)."""
        keep = 1.0 - self.m["prenet_dropout"]
        for i in range(len(depths)):
            x = torch.relu(self.dense(x, f"{name}.dense_{i}"))
            if keep < 1.0:
                x = torch.where(draw(x.shape) < keep, x / keep, torch.zeros_like(x))
        return x

    def gru(self, x, name, lengths=None):
        """Legacy GRU over x [B, T, D] from h = 0; steps past ``lengths`` zeroed."""
        B, T, _ = x.shape
        xg, xc = self.dense(x, f"{name}.xg"), self.dense(x, f"{name}.xc")
        whg = self.q(self.W[f"{name}.hg.weight"]).t()
        whc = self.q(self.W[f"{name}.hc.weight"]).t()
        h = x.new_zeros((B, whc.shape[0]))
        out = []
        for t in range(T):
            h = self.gru_step(h, xg[:, t], xc[:, t], whg, whc)
            out.append(h)
        ys = torch.stack(out, 1)
        if lengths is not None:
            ys = torch.where(time_mask(lengths, T)[..., None], ys, 0.0)
        return ys

    def gru_step(self, h, xg, xc, whg, whc):
        g = torch.sigmoid(xg + self.q(h) @ whg)
        r, u = g.chunk(2, dim=-1)
        c = torch.tanh(xc + self.q(r * h) @ whc)
        return u * h + (1.0 - u) * c

    def cbhg(self, x, lengths, name, bank_k, bank_c, highway_layers, train):
        T = x.shape[1]
        tm = time_mask(lengths, T)[..., None]
        x = torch.where(tm, x, 0.0)
        residual = x
        w = self.W[f"{name}.bank.weight"] * bank_mask(bank_k, bank_c, x.device)
        y = torch.relu(self.conv(x, w) + self.W[f"{name}.bank.bias"])
        y = torch.where(tm, self.batch_norm(y, f"{name}.bank.bn", train), 0.0)
        y = torch.maximum(y, F.pad(y[:, 1:], (0, 0, 0, 1), value=float("-inf")))
        y = torch.relu(self.conv(y, self.W[f"{name}.proj_0.conv.weight"],
                                 self.W[f"{name}.proj_0.conv.bias"]))
        y = torch.where(tm, self.batch_norm(y, f"{name}.proj_0.bn", train), 0.0)
        y = self.conv(y, self.W[f"{name}.proj_1.conv.weight"], self.W[f"{name}.proj_1.conv.bias"])
        y = torch.where(tm, self.batch_norm(y, f"{name}.proj_1.bn", train) + residual, 0.0)
        if f"{name}.highway_in.weight" in self.W:
            y = self.dense(y, f"{name}.highway_in")
        for i in range(highway_layers):
            h = torch.relu(self.dense(y, f"{name}.highway_{i}.H"))
            t = torch.sigmoid(self.dense(y, f"{name}.highway_{i}.T"))
            y = h * t + y * (1.0 - t)
        fwd = self.gru(y, f"{name}.bigru.fwd.cell", lengths)
        bwd = reverse_within(self.gru(reverse_within(y, lengths), f"{name}.bigru.bwd.cell",
                                      lengths), lengths)
        return torch.cat([fwd, bwd], -1)

    # -- the model --------------------------------------------------------
    def speaker(self, speaker_ids):
        if self.m["num_speakers"] <= 1:
            return None
        return self.W["speaker_table.weight"][speaker_ids]

    def encoder(self, inputs, lengths, spk, draw, train):
        m, cond = self.m, self.m["speaker_condition"]
        x = self.W["encoder.embedding.weight"][inputs]
        if spk is not None and "encoder_prenet" in cond:
            x = torch.cat([x, spk[:, None].expand(*x.shape[:2], -1)], -1)
        x = self.prenet(x, "encoder.prenet", m["prenet_depths"], draw)
        mem = self.cbhg(x, lengths, "encoder.cbhg", m["encoder_bank_k"],
                        m["encoder_bank_channels"], m["encoder_highway_layers"], train)
        if spk is not None and "memory" in cond:
            mem = torch.cat([mem, spk[:, None].expand(*mem.shape[:2], -1)], -1)
        return mem

    def initial_states(self, spk, B, device):
        m = self.m
        H, N = m["decoder_depth"], m["decoder_layers"]
        if spk is not None and "decoder_init" in m["speaker_condition"]:
            parts = torch.tanh(self.dense(spk, "state_init_proj")).split(H, -1)
            return parts[0], list(parts[1:])
        zero = lambda: torch.zeros((B, H), device=device)
        return zero(), [zero() for _ in range(N)]

    def decoder(self, memory, mask, spk, prenet_at, S):
        """S steps; ``prenet_at(t, prev_frame)`` gives step t's prenet output.
        → (frames [B, S, r·M], alignments [B, S, L])."""
        m, M = self.m, self.a["num_mels"]
        r, H = m["outputs_per_step"], m["decoder_depth"]
        B, L, D = memory.shape
        keys = self.dense(memory, "attention.memory", bias=False)
        v = self.q(self.W["attention.v"])
        attn_h, hs = self.initial_states(spk, B, memory.device)
        ctx = memory.new_zeros((B, D))
        prev = memory.new_zeros((B, M))
        a_hg = self.q(self.W["decoder_cell.attn_rnn.hg.weight"]).t()
        a_hc = self.q(self.W["decoder_cell.attn_rnn.hc.weight"]).t()
        l_hg = [self.q(self.W[f"decoder_cell.dec_rnn_{i}.hg.weight"]).t()
                for i in range(m["decoder_layers"])]
        l_hc = [self.q(self.W[f"decoder_cell.dec_rnn_{i}.hc.weight"]).t()
                for i in range(m["decoder_layers"])]
        qmem = self.q(memory)
        frames, aligns = [], []
        for t in range(S):
            cell_in = torch.cat([prenet_at(t, prev), ctx], -1)
            attn_h = self.gru_step(attn_h, self.dense(cell_in, "decoder_cell.attn_rnn.xg"),
                                   self.dense(cell_in, "decoder_cell.attn_rnn.xc"), a_hg, a_hc)
            query = self.dense(attn_h, "attention.query", bias=False)
            e = self.q(torch.tanh(keys + query[:, None])) @ v
            e = torch.where(mask, e, torch.full_like(e, -1e9))
            p = torch.exp(e - e.max(-1, keepdim=True).values) * mask
            p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-9)
            ctx = torch.bmm(self.q(p)[:, None], qmem)[:, 0]
            x = self.dense(torch.cat([attn_h, ctx], -1), "decoder_cell.dec_in")
            for i in range(m["decoder_layers"]):
                name = f"decoder_cell.dec_rnn_{i}"
                hs[i] = self.gru_step(hs[i], self.dense(x, f"{name}.xg"),
                                      self.dense(x, f"{name}.xc"), l_hg[i], l_hc[i])
                x = x + hs[i]
            fr = self.dense(x, "decoder_cell.frame_proj")
            prev = fr[:, (r - 1) * M:]
            frames.append(fr)
            aligns.append(p)
        return torch.stack(frames, 1), torch.stack(aligns, 1)

    def postnet(self, mel, train):
        m = self.m
        B, T = mel.shape[:2]
        lengths = torch.full((B,), T, device=mel.device)
        post = self.cbhg(mel, lengths, "post_cbhg", m["postnet_bank_k"],
                         m["postnet_bank_channels"], m["postnet_highway_layers"], train)
        return self.dense(post, "linear_proj")

    def generate(self, inputs, lengths, speaker_ids, S, draw):
        """Inference: → (mel [B, S·r, M], linear [B, S·r, bins], alignments
        [B, S, L]); BatchNorm on its running statistics."""
        m, M = self.m, self.a["num_mels"]
        B, L = inputs.shape
        spk = self.speaker(speaker_ids)
        memory = self.encoder(inputs, lengths, spk, draw, train=False)
        mask = time_mask(lengths, L)
        keep = 1.0 - m["prenet_dropout"]
        masks = [(draw((S, B, n)) < keep).float() / keep for n in m["prenet_depths"]]

        def prenet_at(t, prev):
            x = prev
            for i in range(len(m["prenet_depths"])):
                x = torch.relu(self.dense(x, f"dec_prenet.dense_{i}")) * masks[i][t]
            return x

        frames, aligns = self.decoder(memory, mask, spk, prenet_at, S)
        mel = frames.reshape(B, S * m["outputs_per_step"], M)
        return mel, self.postnet(mel, train=False), aligns

    def forward(self, inputs, lengths, mel_targets, speaker_ids, draw):
        """Teacher-forced training pass (BatchNorm on batch statistics): →
        (mel [B, T, M], linear [B, T, bins]); the post-net sees all T frames."""
        m, M = self.m, self.a["num_mels"]
        r = m["outputs_per_step"]
        B, L = inputs.shape
        T = mel_targets.shape[1]
        spk = self.speaker(speaker_ids)
        memory = self.encoder(inputs, lengths, spk, draw, train=True)
        mask = time_mask(lengths, L)
        go = mel_targets.new_zeros((B, 1, M))
        dec_in = torch.cat([go, mel_targets[:, r - 1::r][:, :-1]], 1)
        pn = self.prenet(dec_in, "dec_prenet", m["prenet_depths"], draw)
        frames, _ = self.decoder(memory, mask, spk, lambda t, prev: pn[:, t], T // r)
        mel = frames.reshape(B, T, M)
        return mel, self.postnet(mel, train=True)


def loss(mel, linear, mel_t, linear_t, target_lengths, dims):
    """L1(mel) + priority-weighted L1(linear) over the valid frames."""
    a, tr = dims["audio"], dims["train"]
    nf = a["num_freq"]
    n_prio = int(tr["prioritize_freq_hz"] / (a["sample_rate"] * 0.5) * nf)
    w = torch.full((nf,), 0.5 / nf, device=mel.device)
    w[:n_prio] += 0.5 / n_prio
    tm = time_mask(target_lengths, mel_t.shape[1])[..., None]
    denom = torch.clamp(tm.sum(), min=1)
    mel_loss = torch.where(tm, (mel_t - mel).abs(), 0.0).sum() / (denom * mel.shape[-1])
    lin_loss = (torch.where(tm, (linear_t - linear).abs(), 0.0) * w).sum() / denom
    return mel_loss + lin_loss
