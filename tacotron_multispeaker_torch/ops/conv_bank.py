"""The CBHG conv bank as one product kernel: CUDA kernel and its plain PyTorch
version.

Port of ``tacotron_multispeaker_tpu/ops/conv_bank.py`` ``conv_bank_pallas``:
``y[b, t, o] = relu(Σ_j Σ_d xpad[b, t + j, d] · w[j, d, o] + bias[o])``, the
width-1..K bank folded into one masked width-K convolution (the mask is in
``w``; models/modules.ConvBank applies it), SAME padding with (K−1)//2 zeros
on the left.  x [B, T, D] and w [K, D, O] in the compute dtype (bf16 or
f32), bias [O] in the compute dtype.  The K shifted products sum in f32, the
bias is added in f32, then ReLU and one rounding to the compute dtype — the
Pallas kernel's rounding (``ops/conv_bank.py:28-33``).

Inference only, as in the JAX package (the Pallas kernel has no VJP):
:func:`conv_bank` raises when a gradient is asked of it.  It runs the plain
version for CPU tensors and the CUDA kernel (``csrc/conv_bank.cu``) for CUDA
tensors; anything else raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build

# launches of the CUDA kernel (the plain version does not count)
launches = 0

_INT_MAX = 2**31 - 1


def conv_bank_reference(x: torch.Tensor, w: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """Plain version: K shifted float32 products of the rounded operands."""
    K, T = w.shape[0], x.shape[1]
    xp = F.pad(x.float(), (0, 0, (K - 1) // 2, K // 2))
    wf = w.float()
    acc = sum(xp[:, j: j + T, :] @ wf[j] for j in range(K))
    return torch.relu(acc + bias.float()).to(x.dtype)


def _check(x, w, bias):
    if x.dim() != 3 or w.dim() != 3 or bias.dim() != 1:
        raise ValueError(f"conv_bank takes x [B, T, D], w [K, D, O], bias [O]; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(bias.shape)}")
    B, T, D = x.shape
    K, Dw, O = w.shape
    if Dw != D or bias.shape[0] != O or K < 1:
        raise ValueError(f"conv_bank: w {tuple(w.shape)} / bias {tuple(bias.shape)} do "
                         f"not fit x {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute dtype must be float32 or bfloat16, got {x.dtype}")
    for name, a in (("w", w), ("bias", bias)):
        if a.dtype != x.dtype:
            raise TypeError(f"{name} is {a.dtype}, x is {x.dtype}")
        if a.device != x.device:
            raise ValueError(f"{name} is on {a.device}, x on {x.device}")
    return B, T, D, K, O


def conv_bank(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """relu(conv_K(x, w) + bias) in x's dtype (see the module docstring)."""
    B, T, D, K, O = _check(x, w, bias)
    if torch.is_grad_enabled() and any(a.requires_grad for a in (x, w, bias)):
        raise RuntimeError("conv_bank is inference-only (the JAX package's "
                           "conv_bank_pallas has no VJP): run it under "
                           "torch.no_grad() / inference_mode, or turn "
                           "parallel.use_pallas off for training")
    if x.device.type == "cpu":
        return conv_bank_reference(x, w, bias)
    if x.device.type != "cuda":
        raise ValueError(f"conv_bank runs on cpu or cuda, not {x.device}")
    if max(B * T * max(D, O), K * D * O) > _INT_MAX:
        raise ValueError(f"conv_bank kernel: sizes B*T*max(D,O)={B * T * max(D, O)} / "
                         f"K*D*O={K * D * O} must stay below 2^31")
    x, w, bias = x.contiguous(), w.contiguous(), bias.contiguous()
    if x.dtype == torch.bfloat16 and (D % 8 or O % 8 or x.data_ptr() % 16
                                      or w.data_ptr() % 16):
        raise ValueError(f"conv_bank kernel: bf16 needs D={D} and O={O} multiples of 8 "
                         "and 16-byte aligned x and w (16-byte loads)")
    y = torch.empty((B, T, O), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.conv_bank_launch(x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                                   y.data_ptr(), B, T, D, K, O,
                                   int(x.dtype == torch.bfloat16), stream)
    cuda_build.check(err, "conv_bank kernel launch")
    global launches
    launches += 1
    return y


def _lib() -> ctypes.CDLL:
    lib = cuda_build.library("conv_bank")
    if not getattr(lib, "_typed", False):
        lib.conv_bank_launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                                         + [ctypes.c_void_p])
        lib.conv_bank_launch.restype = ctypes.c_int
        lib._typed = True
    return lib
