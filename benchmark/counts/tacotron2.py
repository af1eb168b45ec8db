"""Operations and bytes of Tacotron 2 + SV2TTS (``configs/tacotron2_sv2tts.json``)
behind ``mfu.tacotron2_synth`` and ``roofline.lstm_decode``, from a call's
shapes and the configuration as run (``dims``), by the frozen rule of this
package: bound = max(bytes read and written once / HBM bandwidth, bf16
products / the bf16 peak + f32 element work / the f32 peak).  Model FLOPs
count every matrix product and convolution at the true text lengths, and
Griffin-Lim at the FFT count (``counts.griffin_lim_flops``)."""

from __future__ import annotations

from . import bound_s, griffin_lim_flops


def _widths(dims: dict) -> dict:
    m, a = dims["model"], dims["audio"]
    spk = (m["speaker_embed_depth"]
           if m["num_speakers"] > 1 and "encoder_output" in m["speaker_condition"] else 0)
    return dict(M=a["num_mels"], P0=m["prenet_depths"][0], P1=m["prenet_depths"][-1],
                H=m["decoder_lstm_units"], A=m["attention_depth"], U=m["encoder_lstm_units"],
                D=2 * m["encoder_lstm_units"] + spk, K=m["attention_location_kernel"],
                F=m["attention_location_filters"], E=m["embed_depth"],
                C=m["encoder_conv_channels"], bins=a["num_freq"])


def decode_macs(dims: dict, L: int) -> int:
    """Multiply-adds of one decoder step's products at L encoder positions:
    prenet, the attention LSTM, the query, the location term (its
    convolution and projection folded into K·A a position), the context,
    the decoder LSTM, the frame and stop projections."""
    w = _widths(dims)
    M, P0, P1, H, A, D, K = (w[k] for k in ("M", "P0", "P1", "H", "A", "D", "K"))
    return (M * P0 + P0 * P1 + (P1 + D + H) * 4 * H + H * A + L * K * A + L * D
            + (H + D + H) * 4 * H + (H + D) * (M + 1))


def _weights(dims: dict) -> int:
    """Elements of the decode's weights and biases."""
    w = _widths(dims)
    M, P0, P1, H, A, D, K = (w[k] for k in ("M", "P0", "P1", "H", "A", "D", "K"))
    mats = (M * P0 + P0 * P1 + (P1 + D + H) * 4 * H + H * A + K * A + A
            + (H + D + H) * 4 * H + (H + D) * (M + 1))
    return mats + P0 + P1 + 8 * H + M + 1


def lstm_decode_bound_s(B: int, L: int, S: int, dims: dict, esize: int = 2) -> float:
    """The decode of S steps for B rows at L encoder positions: the weights
    once a call; keys, memory and mask once; the prenet masks (f32) and the
    per-step outputs (frame, alignments, stop logit, f32) once; the states."""
    w = _widths(dims)
    M, P0, P1, H, A, D = (w[k] for k in ("M", "P0", "P1", "H", "A", "D"))
    nbytes = (_weights(dims) * esize + B * L * (A + D) * esize + B * L
              + S * B * (P0 + P1) * 4 + S * B * (M + L + 1) * 4
              + B * (4 * H + D + L) * 4)
    # per step and row: the energies' adds, tanh and weighting (3 L·A), the
    # softmax (4 L), the cumulative add (L) and the LSTMs' gates (2 × 10 H)
    return bound_s(nbytes, bf16_flops=2 * S * B * decode_macs(dims, L),
                   f32_flops=S * B * (3 * L * A + 5 * L + 20 * H))


def encoder_flops(dims: dict, L: int) -> int:
    """One utterance of L characters: the convs, the BiLSTM, the attention keys."""
    m, w = dims["model"], _widths(dims)
    C, U, k = w["C"], w["U"], m["encoder_conv_width"]
    convs = sum(2 * k * (w["E"] if i == 0 else C) * C for i in range(m["encoder_conv_layers"]))
    return L * (convs + 2 * 2 * (C + U) * 4 * U + 2 * w["D"] * w["A"])


def postnet_flops(dims: dict, T: int) -> int:
    """T frames: the post-net's convs and the mel basis's pseudo-inverse."""
    m, w = dims["model"], _widths(dims)
    P, k, n = m["postnet_conv_channels"], m["postnet_conv_width"], m["postnet_conv_layers"]
    chans = [w["M"]] + [P] * (n - 1) + [w["M"]]
    return T * (sum(2 * k * a * b for a, b in zip(chans, chans[1:])) + 2 * w["M"] * w["bins"])


def synth_flops(dims: dict, text_lengths, S: int) -> float:
    """A synthesis call: each row's encoder at its true length, S decoder
    steps over it, the post-net and Griffin-Lim over S frames (r = 1)."""
    return sum(encoder_flops(dims, L) + 2 * S * decode_macs(dims, L) + postnet_flops(dims, S)
               + griffin_lim_flops(dims, S) for L in text_lengths)
