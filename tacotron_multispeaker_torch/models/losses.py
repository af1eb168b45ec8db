"""Loss functions (port of ``tacotron_multispeaker_tpu/models/losses.py``).

``loss = L1(mel) + 0.5·mean(L1(linear)) + 0.5·mean(L1(linear)[..., :n_prio])``
where the priority band is the linear bins below ``prioritize_hz`` (low
frequencies get double weight).  With ``target_lengths`` the means run over
the valid frames only (config ``train.loss_masking``, the default); without
them over every frame, padding included, as the reference did.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..parallel.distributed import all_reduce


def priority_bins(num_freq: int, sample_rate: int, prioritize_hz: float = 3000.0) -> int:
    """Number of linear bins below the prioritized frequency."""
    return int(prioritize_hz / (sample_rate * 0.5) * num_freq)


def tacotron_loss(mel_out: torch.Tensor, linear_out: torch.Tensor,
                  mel_targets: torch.Tensor, linear_targets: torch.Tensor,
                  target_lengths: torch.Tensor | None, *, num_freq: int, sample_rate: int,
                  prioritize_hz: float = 3000.0, group=None,
                  fused_linear: bool = False) -> dict:
    """{"mel_loss", "linear_loss", "loss"}, scalar f32 tensors.

    ``fused_linear``: the priority-weighted linear loss as one weighted sum
    over [B, T, bins] (per-bin weights 0.5/num_freq, plus 0.5/n_prio below
    the priority frequency) instead of two means; the same function up to
    f32 summation order.

    ``group`` (a process group: the JAX package's ``axis_name``): the
    values are this rank's share of the loss of the batch of every rank of
    the group.  Masked, the local sums run over the group's count of valid
    frames, summed across the group without a gradient; unmasked (equal
    shards), the local means are scaled by 1/group size.  The SUM of the
    ranks' gradients is then the gradient of the whole batch's loss."""
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
        count = all_reduce(mask.sum(), "sum", group)
        denom = torch.clamp(count, min=1)

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
        if group is not None:
            scale = 1.0 / dist.get_world_size(group)
            mel_loss, linear_loss = mel_loss * scale, linear_loss * scale
    return {"mel_loss": mel_loss, "linear_loss": linear_loss, "loss": mel_loss + linear_loss}
