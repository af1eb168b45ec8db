"""Operations, bytes and peaks behind the benchmark's rooflines and MFU.

The per-kernel bounds are the arithmetic of the port's on-chip smoke test
(``_bound_ms``, ``_decoder_bound_ms`` and the teacher and Griffin-Lim
bounds), frozen here and computed from a call's shapes: bound = max(bytes
read and written once / HBM bandwidth, operations / peak of their type).
Model FLOPs count every matrix product and convolution of the true lengths
(no padding, no recomputation), and Griffin-Lim's transforms at the
operation count of a real n_fft-point FFT, the least any implementation of
the same mathematics needs.

Peaks: NVIDIA H100 SXM data sheet, dense, at its 700 W limit.
"""

from __future__ import annotations

import math

HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def bound_s(nbytes: float, bf16_flops: float = 0.0, f32_flops: float = 0.0) -> float:
    return max(nbytes / HBM_BYTES_S, bf16_flops / BF16_FLOPS + f32_flops / F32_FLOPS)


def _widths(dims: dict) -> dict:
    m, a = dims["model"], dims["audio"]
    spk = m["speaker_embed_depth"] if m["num_speakers"] > 1 else 0
    cond = m["speaker_condition"]
    return dict(M=a["num_mels"], P1=m["prenet_depths"][0], P2=m["prenet_depths"][-1],
                H=m["decoder_depth"], A=m["attention_depth"], N=m["decoder_layers"],
                D=m["encoder_depth"] + (spk if "memory" in cond else 0),
                RM=m["outputs_per_step"] * a["num_mels"], r=m["outputs_per_step"],
                E=m["embed_depth"] + (spk if "encoder_prenet" in cond else 0), spk=spk,
                bins=a["num_freq"])


def decoder_loop_bound_s(B: int, L: int, S: int, dims: dict, esize: int = 2) -> float:
    """Kernel 5 (the fused decode) at B rows, L encoder positions, S steps."""
    w = _widths(dims)
    M, P1, P2, H, A, D, RM, N = (w[k] for k in ("M", "P1", "P2", "H", "A", "D", "RM", "N"))
    mats = (M * P1 + P1 * P2 + P2 * 2 * H + D * 2 * H + P2 * H + D * H + H * 2 * H + H * H
            + H * A + H * H + D * H + N * (H * 2 * H + H * H + H * 2 * H + H * H) + H * RM)
    biases = P1 + P2 + 2 * H + H + H + N * (2 * H + H) + RM
    nbytes = ((mats + A) * esize + biases * 4 + B * L * (A + D) * esize + B * L
              + S * B * (P1 + P2) * 4 + B * H * 4 + N * B * H * 4 + S * B * (RM + L) * 4)
    return bound_s(nbytes, bf16_flops=S * B * 2 * (mats + L * D),
                   f32_flops=S * B * (3 * L * A + 4 * L))


def _teacher_weight_bytes(w: dict, esize: int) -> int:
    H, A, D, N = w["H"], w["A"], w["D"], w["N"]
    mats = H * 2 * H + H * H + H * A + A + D * 4 * H + H * H + N * (H * 3 * H + H * 2 * H + H * H)
    return mats * esize + (H + N * 3 * H) * 4


def teacher_fwd_bound_s(B: int, L: int, S: int, dims: dict, esize: int = 2) -> float:
    """Kernel 6 (the teacher-forced decoder scan)."""
    w = _widths(dims)
    H, A, D, N = w["H"], w["A"], w["D"], w["N"]
    nbytes = (_teacher_weight_bytes(w, esize) + S * B * 3 * H * esize + (1 + N) * B * H * 4
              + B * L * (A + D) * esize + B * L + S * B * (H + L + H + N * H) * 4)
    macs = (H * 2 * H + H * H + H * A + D * 4 * H + H * H + L * D
            + N * (3 * H * H + 2 * H * H + H * H))
    return bound_s(nbytes, bf16_flops=2 * S * B * macs, f32_flops=S * B * (3 * L * A + 4 * L))


def teacher_bwd_bound_s(B: int, L: int, S: int, dims: dict, esize: int = 2) -> float:
    """Kernel 8 (the teacher decoder's backward: prologue and scan)."""
    w = _widths(dims)
    H, A, D, N = w["H"], w["A"], w["D"], w["N"]
    f4 = 4
    ins = (S * B * 3 * H * esize                       # png, pnc
           + S * B * H * f4 * 2                        # ha, hap
           + 2 * N * S * B * H * f4                    # hds, hdps
           + S * B * H * f4 + 2 * S * B * L * f4       # xs, align, pp
           + S * B * H * f4 + S * B * L * f4           # dxs, dalign
           + B * L * (A + D) * esize + B * L + _teacher_weight_bytes(w, esize))
    outs = S * B * (2 * H + H + L + D) * f4 + (1 + N) * B * H * f4
    streams = S * B * (H + 4 * H + D + A) * f4 + N * S * B * (H + H + 3 * H) * f4
    macs = (N * 12 * H * H + H * H + L * D + 4 * H * D + L * D + 2 * H * A + L * D
            + D * 4 * H + 6 * H * H)
    return bound_s(ins + outs + streams, bf16_flops=2 * S * B * macs,
                   f32_flops=S * B * 5 * L * A)


def gl_iteration_bound_s(B: int, F: int, dims: dict, n_iters: int) -> float:
    """Kernel 13: ``n_iters`` fast bf16 iterations, the products counted over
    the window's nonzero samples (its periodic Hann window has one zero)."""
    a = dims["audio"]
    n_fft = (a["num_freq"] - 1) * 2
    win = min(int(a["frame_length_ms"] / 1000.0 * a["sample_rate"]), n_fft)
    nnz, bins = win - 1, n_fft // 2 + 1
    nbytes = B * F * n_fft * 2 + B * F * bins * 4 + n_fft * 4 + 4 * B * F * bins * 4
    return bound_s(nbytes, bf16_flops=(2 * n_iters - 1) * 4 * B * F * nnz * bins)


# -- model FLOPs ----------------------------------------------------------------

def _gru(x: int, f: int) -> int:
    """FLOPs of one legacy GRU step: input and recurrent products."""
    return 2 * x * 3 * f + 2 * f * 3 * f


def _cbhg(din: int, K: int, C: int, proj: list, hw_layers: int, hw: int, G: int) -> int:
    """FLOPs of one CBHG frame (bank, projections, highway, BiGRU)."""
    bank = sum(2 * k * din * C for k in range(1, K + 1))
    f = bank + 2 * 3 * K * C * proj[0] + 2 * 3 * proj[0] * proj[1]
    if proj[1] != hw:
        f += 2 * proj[1] * hw
    return f + hw_layers * 2 * (2 * hw * hw) + 2 * _gru(hw, G)


def encoder_flops(dims: dict, L: int) -> int:
    m, w = dims["model"], _widths(dims)
    half = m["encoder_depth"] // 2
    per_char = (2 * w["E"] * w["P1"] + 2 * w["P1"] * w["P2"]
                + _cbhg(w["P2"], m["encoder_bank_k"], m["encoder_bank_channels"],
                        list(m["encoder_proj_channels"]), m["encoder_highway_layers"], half,
                        half)
                + 2 * w["D"] * w["A"])
    return L * per_char


def decoder_step_flops(dims: dict, L: int) -> int:
    w = _widths(dims)
    M, P1, P2, H, A, D, N, RM = (w[k] for k in ("M", "P1", "P2", "H", "A", "D", "N", "RM"))
    return (2 * M * P1 + 2 * P1 * P2 + _gru(P2 + D, H) + 2 * H * A + 2 * L * A + 2 * L * D
            + 2 * (H + D) * H + N * _gru(H, H) + 2 * H * RM)


def postnet_flops(dims: dict, T: int) -> int:
    m, w = dims["model"], _widths(dims)
    half = m["postnet_depth"] // 2
    G = m["postnet_gru_units"]
    return T * (_cbhg(w["M"], m["postnet_bank_k"], m["postnet_bank_channels"],
                      list(m["postnet_proj_channels"]), m["postnet_highway_layers"], half, G)
                + 2 * 2 * G * w["bins"])


def forward_flops(dims: dict, L: int, S: int) -> int:
    """One utterance: L characters, S decoder steps (S·r frames)."""
    w = _widths(dims)
    init = 2 * w["spk"] * (w["N"] + 1) * w["H"]
    return (encoder_flops(dims, L) + init + S * decoder_step_flops(dims, L)
            + postnet_flops(dims, S * w["r"]))


def griffin_lim_flops(dims: dict, frames: int) -> float:
    """(2·iterations + 1) real n_fft-point transforms a frame, 2.5·n·log2(n) each."""
    a = dims["audio"]
    n = (a["num_freq"] - 1) * 2
    return frames * (2 * a["griffin_lim_iters"] + 1) * 2.5 * n * math.log2(n)


def synth_flops(dims: dict, text_lengths, S: int) -> float:
    r = dims["model"]["outputs_per_step"]
    return sum(forward_flops(dims, L, S) + griffin_lim_flops(dims, S * r) for L in text_lengths)


def train_flops(dims: dict, text_lengths, frame_lengths) -> float:
    """Forward and backward (twice the forward's products) of the true
    lengths; the decoder runs ceil(T/r) steps."""
    r = dims["model"]["outputs_per_step"]
    return 3 * sum(forward_flops(dims, L, -(-T // r)) for L, T in zip(text_lengths,
                                                                      frame_lengths))
