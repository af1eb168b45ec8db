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
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops import conv_bank as cb_ops
from ..ops import gru_scan
from ..parallel.distributed import psum


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
    update written out).

    ``group`` (a process group: flax's ``axis_name``): cross-replica
    statistics, the mean and E[x²] of every rank of the group, through ONE
    differentiable all-reduce of the two concatenated (flax's one ``pmean``),
    so the gradient reaches each rank's share of the statistics."""

    momentum = 0.99   # flax BatchNorm(momentum=0.99) in every layer of the model

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32,
                 eps: float = 1e-3, group=None):
        super().__init__()
        self.compute_dtype = dtype
        self.eps = eps
        self.group = group
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean, mean2 = xf.mean(axes), (xf * xf).mean(axes)
            if self.group is not None:
                stats = psum(torch.cat([mean, mean2]), self.group) / dist.get_world_size(
                    self.group)
                mean, mean2 = stats.chunk(2)
            var = torch.clamp(mean2 - mean * mean, min=0.0)
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

    def forward_masked(self, x: torch.Tensor, masks) -> torch.Tensor:
        """The prenet with given dropout masks (one per layer, 0 or 1/keep,
        f32) in place of drawn ones; ``masks`` None is no dropout."""
        for i in range(self.n_layers):
            x = torch.relu(getattr(self, f"dense_{i}")(x))
            if masks is not None:
                x = x * masks[i].to(x.dtype)
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
                 activation: bool = True, dtype: torch.dtype = torch.float32, bn_group=None):
        super().__init__()
        self.compute_dtype = dtype
        self.activation = activation
        self.conv = nn.Conv1d(in_channels, channels, width)
        self.bn = BatchNorm(channels, dtype, group=bn_group)

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
    so each channel group keeps its own SAME centering
    (ops/conv_bank.bank_mask, which the kernel's tap ranges follow)."""
    return cb_ops.bank_mask(bank_k, channels, bank_k * channels).numpy()


class ConvBank(nn.Module):
    """Conv bank widths 1..K, C channels each → [B, T, K*C], as ONE masked
    width-K convolution.  The weight is stored unmasked (PyTorch layout
    [K*C, in, K]); the mask is applied at run time.

    ``use_pallas`` (the JAX package's switch) routes the product through the
    conv-bank kernel (ops/conv_bank.py, inference only; told the group width,
    so it skips the taps the mask zeroes) with its rounding:
    f32 sums, the bias rounded to the compute dtype and added in f32, ReLU,
    one rounding.  Without it ``F.conv1d`` rounds the conv output to the
    compute dtype before the f32 bias and ReLU, as the JAX XLA path does."""

    def __init__(self, in_channels: int, bank_k: int, channels: int,
                 dtype: torch.dtype = torch.float32, use_pallas: bool = False,
                 bn_group=None):
        super().__init__()
        self.compute_dtype = dtype
        self.use_pallas = use_pallas
        self.bank_k = bank_k
        self.channels = channels
        self.weight = nn.Parameter(torch.empty(bank_k * channels, in_channels, bank_k))
        self.bias = nn.Parameter(torch.zeros(bank_k * channels))
        mask = torch.from_numpy(_bank_mask(bank_k, channels)).permute(2, 1, 0)
        self.register_buffer("mask", mask.contiguous(), persistent=False)
        self.bn = BatchNorm(bank_k * channels, dtype, group=bn_group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        kernel = (self.weight * self.mask).to(dt)
        if self.use_pallas:
            y = cb_ops.conv_bank(x.to(dt).contiguous(), kernel.permute(2, 1, 0).contiguous(),
                                 self.bias.to(dt), bank_channels=self.channels)
            return self.bn(y)
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

    def step(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """One step in the compute dtype (flax ``GRUCellParams.__call__``)."""
        return self.step_from_proj(h, self.xg(x), self.xc(x))

    def step_from_proj(self, h: torch.Tensor, xg: torch.Tensor,
                       xc: torch.Tensor) -> torch.Tensor:
        """One step from precomputed input projections (flax
        ``GRUCellParams.step_from_proj``)."""
        gates = torch.sigmoid(xg + self.hg(h))
        r, u = gates.chunk(2, dim=-1)
        c = torch.tanh(xc + self.hc(r * h))
        return u * h + (1.0 - u) * c


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
    """Unidirectional GRU over [B, T, D] with precomputed input projections
    (flax ``GRU``; the cell's flax name is ``cell``).  Also one direction of
    a :class:`BiGRU`, which reads its projections and weights
    (:meth:`proj_and_weights`) and runs its own fused scan.

    ``use_pallas`` runs the scan through ``ops/gru_scan.GRUScan`` (the
    one-direction kernel and its backward on CUDA tensors, their plain
    versions on CPU tensors); without it the scan is the per-step loop over
    :meth:`GRUCellParams.step_from_proj`, as the JAX package's ``nn.scan``.
    The JAX package's ``F % 128`` gate is the TPU's tiling: here the kernel
    runs for any F within its H100 limits and raises outside them."""

    def __init__(self, in_dim: int, features: int,
                 dtype: torch.dtype = torch.float32, use_pallas: bool = False):
        super().__init__()
        self.features = features
        self.compute_dtype = dtype
        self.use_pallas = use_pallas
        self.cell = GRUCellParams(in_dim, features, dtype)

    def forward(self, xs: torch.Tensor, lengths: torch.Tensor | None = None,
                reverse: bool = False) -> torch.Tensor:
        """xs [B, T, D] → ys [B, T, F]; with ``lengths`` the steps past each
        length are zeroed, and ``reverse`` scans each sequence backwards
        within its length."""
        B, T, _ = xs.shape
        if reverse:
            if lengths is None:
                raise ValueError("reverse=True needs lengths")
            xs = reverse_sequences(xs, lengths)
        xg, xc = self.cell.x_proj(xs)                    # one [B*T, D] product each
        h0 = torch.zeros((B, self.features), dtype=xs.dtype, device=xs.device)
        if self.use_pallas:
            tm = lambda a: a.transpose(0, 1).contiguous()  # time-major [T, B, .]
            ys = gru_scan.GRUScan.apply(tm(xg), tm(xc), self.cell.hg.kernel.contiguous(),
                                        self.cell.hc.kernel.contiguous(), h0).transpose(0, 1)
        else:
            h, steps = h0, []
            for t in range(T):
                h = self.cell.step_from_proj(h, xg[:, t], xc[:, t])
                steps.append(h)
            ys = torch.stack(steps, dim=1)
        if lengths is not None:
            mask = (torch.arange(T, device=xs.device)[None, :]
                    < lengths.to(xs.device)[:, None])[..., None]
            ys = torch.where(mask, ys, 0.0)
        if reverse:
            ys = reverse_sequences(ys, lengths)
        return ys

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
    N× highway → BiGRU.  Padded positions are zeroed before every conv.
    ``use_pallas`` routes the bank through its kernel (:class:`ConvBank`);
    ``bn_group`` gives its three BatchNorms cross-replica statistics."""

    def __init__(self, in_dim: int, bank_k: int, bank_channels: int,
                 proj_channels: Sequence[int], highway_layers: int,
                 highway_depth: int, gru_units: int,
                 dtype: torch.dtype = torch.float32, use_pallas: bool = False,
                 bn_group=None):
        super().__init__()
        self.highway_layers = highway_layers
        self.bank = ConvBank(in_dim, bank_k, bank_channels, dtype, use_pallas, bn_group)
        self.proj_0 = ConvBN(bank_k * bank_channels, 3, proj_channels[0], True, dtype,
                             bn_group)
        self.proj_1 = ConvBN(proj_channels[0], 3, proj_channels[1], False, dtype, bn_group)
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
