"""Operand rounding of the reference's products.

``f32`` leaves them alone.  ``fp8`` is the control: each operand scaled by
its own absolute maximum onto float8 e4m3's range (448), rounded, and
scaled back, the straight-through gradient passing unchanged, so that every
product of the forward and of the backward takes fp8 inputs."""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def f32(x: torch.Tensor) -> torch.Tensor:
    return x


class _RoundFP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _RoundFP8.apply(x)


ROUNDING = {"f32": f32, "fp8": fp8}


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
