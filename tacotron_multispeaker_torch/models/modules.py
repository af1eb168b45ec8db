"""Neural building blocks: prenet, conv bank, highway, GRU, CBHG.

Port of ``tacotron_multispeaker_tpu/models/modules.py``.  In training mode
(``module.train()``) the BatchNorms use batch statistics and update their
running statistics, as flax's ``BatchNorm(use_running_average=not train)``
does; in eval mode they use the running statistics.  Tensors are batch-major
[B, T, C] as in the JAX package; convolutions transpose to PyTorch's
[B, C, T] internally.  Semantics follow the TF1 lineage: conv1d is
conv → activation → batch-norm (eps 1e-3), highway gates have bias init −1,
and the GRU is the legacy ``tf.nn.rnn_cell.GRUCell`` (single bias on the
gate projection, init 1.0; the reset gate multiplies h BEFORE the candidate
matmul, which ``torch.nn.GRU`` does not do, hence the hand cell).

Parameters are f32; each layer casts its input and parameters to its
compute ``dtype`` (bf16 or f32), as flax's ``dtype=`` does.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import gru_scan


class Dense(nn.Linear):
    """``nn.Linear`` with flax ``Dense`` dtype semantics.

    ``bias_init``: constant the bias starts from (flax ``bias_init``).
    """

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32, bias_init: float = 0.0):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype
        self.bias_init = bias_init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)

    @property
    def kernel(self) -> torch.Tensor:
        """The weight in the JAX layout [in, out], compute dtype."""
        return self.weight.t().to(self.compute_dtype)


class BatchNorm(nn.Module):
    """BatchNorm over the last axis with flax's parameter names
    (``scale``/``bias`` parameters, ``mean``/``var`` running statistics)
    and its arithmetic (flax 0.12 ``_compute_stats`` with
    ``use_fast_variance``).  Training mode: mean and E[x²] reduced in f32
    over every axis but the last, pad frames included; var = E[x²] − mean²
    clipped at 0; running statistics ``0.99·old + 0.01·batch`` with the
    biased var (``F.batch_norm`` would store the unbiased one, hence the
    update written out)."""

    momentum = 0.99   # flax BatchNorm(momentum=0.99) in every layer of the model

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32,
                 eps: float = 1e-3):
        super().__init__()
        self.compute_dtype = dtype
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean = xf.mean(axes)
            var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        y = xf - mean
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (y * mul + self.bias).to(self.compute_dtype)


def _same_pad(width: int) -> tuple[int, int]:
    """flax/XLA SAME padding for a stride-1 conv of ``width`` taps."""
    return (width - 1) // 2, width // 2


class Prenet(nn.Module):
    """FC stack with ReLU + dropout that is ALWAYS on (at inference too):
    the persistent dropout drives autoregressive output diversity."""

    def __init__(self, in_dim: int, layer_sizes: Sequence[int],
                 dropout_rate: float = 0.5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.n_layers = len(layer_sizes)
        for i, size in enumerate(layer_sizes):
            setattr(self, f"dense_{i}", Dense(in_dim, size, dtype=dtype))
            in_dim = size

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        keep = 1.0 - self.dropout_rate
        for i in range(self.n_layers):
            x = torch.relu(getattr(self, f"dense_{i}")(x))
            if keep < 1.0:
                draw = torch.rand(x.shape, generator=generator, device=x.device)
                x = torch.where(draw < keep, x / keep, torch.zeros_like(x))
        return x


class HighwayNet(nn.Module):
    """y = H(x)·T(x) + x·(1−T(x)); transform-gate bias init −1."""

    def __init__(self, depth: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.H = Dense(depth, depth, dtype=dtype)
        self.T = Dense(depth, depth, dtype=dtype, bias_init=-1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.H(x))
        t = torch.sigmoid(self.T(x))
        return h * t + x * (1.0 - t)


class ConvBN(nn.Module):
    """conv1d (SAME) → activation → batch-norm, on [B, T, C]."""

    def __init__(self, in_channels: int, width: int, channels: int,
                 activation: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.activation = activation
        self.conv = nn.Conv1d(in_channels, channels, width)
        self.bn = BatchNorm(channels, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        xp = F.pad(x.to(dt).transpose(1, 2), _same_pad(self.conv.kernel_size[0]))
        y = F.conv1d(xp, self.conv.weight.to(dt), self.conv.bias.to(dt)).transpose(1, 2)
        if self.activation:
            y = torch.relu(y)
        return self.bn(y)


def _bank_mask(bank_k: int, channels: int) -> np.ndarray:
    """[K, 1, K*C] binary mask fusing sub-widths 1..K into one width-K conv:
    sub-conv of width k, tap i, sits at fused tap i + (K-1)//2 - (k-1)//2,
    so each channel group keeps its own SAME centering."""
    K, C = bank_k, channels
    mask = np.zeros((K, 1, K * C), dtype=np.float32)
    center = (K - 1) // 2
    for k in range(1, K + 1):
        off = center - (k - 1) // 2
        mask[off: off + k, :, (k - 1) * C: k * C] = 1.0
    return mask


class ConvBank(nn.Module):
    """Conv bank widths 1..K, C channels each → [B, T, K*C], as ONE masked
    width-K convolution.  The weight is stored unmasked (PyTorch layout
    [K*C, in, K]); the mask is applied at run time."""

    def __init__(self, in_channels: int, bank_k: int, channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.bank_k = bank_k
        self.weight = nn.Parameter(torch.empty(bank_k * channels, in_channels, bank_k))
        self.bias = nn.Parameter(torch.zeros(bank_k * channels))
        mask = torch.from_numpy(_bank_mask(bank_k, channels)).permute(2, 1, 0)
        self.register_buffer("mask", mask.contiguous(), persistent=False)
        self.bn = BatchNorm(bank_k * channels, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        kernel = (self.weight * self.mask).to(dt)
        xp = F.pad(x.to(dt).transpose(1, 2), _same_pad(self.bank_k))
        y = F.conv1d(xp, kernel).transpose(1, 2)
        y = torch.relu(y.float() + self.bias).to(dt)
        return self.bn(y)


class GRUCellParams(nn.Module):
    """Parameters of a legacy-TF GRU cell as separate x/h projections:
      r,u = sigmoid(x @ Wxg + bg + h @ Whg)   (bg init 1.0)
      c   = tanh(x @ Wxc + bc + (r*h) @ Whc)
      h'  = u*h + (1-u)*c
    """

    def __init__(self, in_dim: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        F_ = features
        self.features = features
        self.xg = Dense(in_dim, 2 * F_, dtype=dtype, bias_init=1.0)
        self.hg = Dense(F_, 2 * F_, bias=False, dtype=dtype)
        self.xc = Dense(in_dim, F_, dtype=dtype)
        self.hc = Dense(F_, F_, bias=False, dtype=dtype)

    def x_proj(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Input projections for a whole sequence ([..., 2F], [..., F])."""
        return self.xg(x), self.xc(x)


def reverse_sequences(xs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse each [B, T, ...] sequence within its valid length (padding
    stays put)."""
    B, T = xs.shape[0], xs.shape[1]
    t = torch.arange(T, device=xs.device)[None, :]
    lens = lengths.to(xs.device)[:, None]
    idx = torch.where(t < lens, lens - 1 - t, t)
    idx = idx.reshape(B, T, *([1] * (xs.ndim - 2))).expand_as(xs)
    return torch.gather(xs, 1, idx)


class GRU(nn.Module):
    """One direction of a BiGRU: holds the cell (flax name ``cell``).  The
    stand-alone unidirectional scan (kernel ``gru_scan``) is off the serving
    path and comes with a later slice."""

    def __init__(self, in_dim: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features = features
        self.compute_dtype = dtype
        self.cell = GRUCellParams(in_dim, features, dtype)

    def proj_and_weights(self, xs: torch.Tensor):
        """Input projections of the whole sequence and the recurrent weights
        ([F, 2F], [F, F]) in the compute dtype."""
        xg, xc = self.cell.x_proj(xs)
        return xg, xc, self.cell.hg.kernel, self.cell.hc.kernel


class BiGRU(nn.Module):
    """Bidirectional GRU, outputs concatenated: [B, T, 2F].  Both
    directions run in ONE fused scan, differentiable
    (ops/gru_scan.BiGRUScan)."""

    def __init__(self, in_dim: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features = features
        self.fwd = GRU(in_dim, features, dtype)
        self.bwd = GRU(in_dim, features, dtype)

    def forward(self, xs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        B, T, _ = xs.shape
        xg_f, xc_f, whg_f, whc_f = self.fwd.proj_and_weights(xs)
        xg_b, xc_b, whg_b, whc_b = self.bwd.proj_and_weights(
            reverse_sequences(xs, lengths))
        # time-major with a direction dim: [T, 2, B, .]
        stack = lambda a, b: torch.stack(
            [a.transpose(0, 1), b.transpose(0, 1)], dim=1).contiguous()
        h0 = torch.zeros((2, B, self.features), dtype=torch.float32,
                         device=xs.device)
        ys = gru_scan.BiGRUScan.apply(stack(xg_f, xg_b), stack(xc_f, xc_b),
                                      torch.stack([whg_f, whg_b]).contiguous(),
                                      torch.stack([whc_f, whc_b]).contiguous(), h0)
        mask = (torch.arange(T, device=xs.device)[None, :]
                < lengths.to(xs.device)[:, None])[..., None]
        ys_f = torch.where(mask, ys[:, 0].transpose(0, 1), 0.0)
        ys_b = torch.where(mask, ys[:, 1].transpose(0, 1), 0.0)
        ys_b = reverse_sequences(ys_b, lengths)
        return torch.cat([ys_f, ys_b], dim=-1)


class CBHG(nn.Module):
    """Conv Bank + Highway + BiGRU: bank (widths 1..K) → maxpool(2, 1,
    SAME) → two width-3 conv projections + residual → [dim-match Dense] →
    N× highway → BiGRU.  Padded positions are zeroed before every conv."""

    def __init__(self, in_dim: int, bank_k: int, bank_channels: int,
                 proj_channels: Sequence[int], highway_layers: int,
                 highway_depth: int, gru_units: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.highway_layers = highway_layers
        self.bank = ConvBank(in_dim, bank_k, bank_channels, dtype)
        self.proj_0 = ConvBN(bank_k * bank_channels, 3, proj_channels[0], True, dtype)
        self.proj_1 = ConvBN(proj_channels[0], 3, proj_channels[1], False, dtype)
        if proj_channels[1] != highway_depth:
            self.highway_in = Dense(proj_channels[1], highway_depth, dtype=dtype)
        else:
            self.highway_in = None
        for i in range(highway_layers):
            setattr(self, f"highway_{i}", HighwayNet(highway_depth, dtype))
        self.bigru = BiGRU(highway_depth, gru_units, dtype)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        tmask = (torch.arange(x.shape[1], device=x.device)[None, :]
                 < lengths.to(x.device)[:, None])[..., None]
        x = torch.where(tmask, x, 0.0)
        residual = x
        y = torch.where(tmask, self.bank(x), 0.0)
        # maxpool width 2, stride 1, SAME (pad right with -inf)
        y = torch.maximum(y, F.pad(y.transpose(1, 2), (0, 1),
                                   value=float("-inf"))[:, :, 1:].transpose(1, 2))
        y = torch.where(tmask, self.proj_0(y), 0.0)
        y = self.proj_1(y) + residual
        y = torch.where(tmask, y, 0.0)
        if self.highway_in is not None:
            y = self.highway_in(y)
        for i in range(self.highway_layers):
            y = getattr(self, f"highway_{i}")(y)
        return self.bigru(y, lengths)
