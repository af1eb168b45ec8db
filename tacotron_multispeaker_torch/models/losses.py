"""Loss functions (port of ``tacotron_multispeaker_tpu/models/losses.py``).

``loss = L1(mel) + 0.5·mean(L1(linear)) + 0.5·mean(L1(linear)[..., :n_prio])``
where the priority band is the linear bins below ``prioritize_hz`` (low
frequencies get double weight).  With ``target_lengths`` the means run over
the valid frames only (config ``train.loss_masking``, the default); without
them over every frame, padding included, as the reference did.
"""

from __future__ import annotations

import torch


def priority_bins(num_freq: int, sample_rate: int, prioritize_hz: float = 3000.0) -> int:
    """Number of linear bins below the prioritized frequency."""
    return int(prioritize_hz / (sample_rate * 0.5) * num_freq)


def tacotron_loss(mel_out: torch.Tensor, linear_out: torch.Tensor,
                  mel_targets: torch.Tensor, linear_targets: torch.Tensor,
                  target_lengths: torch.Tensor | None, *, num_freq: int, sample_rate: int,
                  prioritize_hz: float = 3000.0, axis_name: str | None = None,
                  fused_linear: bool = False) -> dict:
    """{"mel_loss", "linear_loss", "loss"}, scalar f32 tensors.

    ``fused_linear``: the priority-weighted linear loss as one weighted sum
    over [B, T, bins] (per-bin weights 0.5/num_freq, plus 0.5/n_prio below
    the priority frequency) instead of two means; the same function up to
    f32 summation order.  ``axis_name`` (the data-parallel loss share) is
    not ported yet."""
    if axis_name is not None:
        raise NotImplementedError("tacotron_loss(axis_name=...) is the data-parallel "
                                  "step's; not ported yet (ROADMAP.md, 'Parallel')")
    mel_l1 = (mel_targets - mel_out).abs()
    lin_l1 = (linear_targets - linear_out).abs()
    n_prio = priority_bins(num_freq, sample_rate, prioritize_hz)
    if fused_linear:
        w = torch.full((num_freq,), 0.5 / num_freq, dtype=torch.float32, device=lin_l1.device)
        w[:n_prio] += 0.5 / n_prio

    if target_lengths is not None:
        T = mel_targets.shape[1]
        mask = (torch.arange(T, device=mel_l1.device)[None, :]
                < target_lengths.to(mel_l1.device)[:, None])[..., None]
        denom = torch.clamp(mask.sum(), min=1)

        def masked_mean(x):
            return torch.where(mask, x, 0.0).sum() / (denom * x.shape[-1])

        mel_loss = masked_mean(mel_l1)
        if fused_linear:
            linear_loss = (torch.where(mask, lin_l1, 0.0) * w).sum() / denom
        else:
            linear_loss = 0.5 * masked_mean(lin_l1) + 0.5 * masked_mean(lin_l1[:, :, :n_prio])
    else:
        mel_loss = mel_l1.mean()
        if fused_linear:
            linear_loss = (lin_l1 * w).sum() / (lin_l1.shape[0] * lin_l1.shape[1])
        else:
            linear_loss = 0.5 * lin_l1.mean() + 0.5 * lin_l1[:, :, :n_prio].mean()
    return {"mel_loss": mel_loss, "linear_loss": linear_loss, "loss": mel_loss + linear_loss}
