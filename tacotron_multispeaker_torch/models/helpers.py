"""Decoding helpers (port of ``tacotron_multispeaker_tpu/models/helpers.py``).

Teacher forcing feeds the last ground-truth frame of each r-frame group as
the next decoder input; at inference the last predicted frame is fed back.
Both start from a zero GO frame, and inference runs a fixed number of steps
(Tacotron-1 has no stop token; outputs are endpoint-trimmed).
"""

from __future__ import annotations

import torch


def go_frame(batch: int, num_mels: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """The zero GO frame [B, 1, M]."""
    return torch.zeros((batch, 1, num_mels), dtype=dtype, device=device)


def teacher_inputs(mel_targets: torch.Tensor, r: int) -> torch.Tensor:
    """[B, T, M] ground truth -> [B, T/r, M] decoder inputs: the GO frame,
    then the last frame of each r-group but the final one."""
    B, T, M = mel_targets.shape
    if T % r:
        raise ValueError(f"target length {T} not a multiple of r={r}")
    go = go_frame(B, M, mel_targets.dtype, mel_targets.device)
    return torch.cat([go, mel_targets[:, r - 1::r, :][:, :-1]], dim=1)


def feedback_frame(frames: torch.Tensor, r: int, num_mels: int) -> torch.Tensor:
    """[B, r*M] predicted group -> [B, M] last frame, the next decoder input."""
    return frames[:, (r - 1) * num_mels:]
