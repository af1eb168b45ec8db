"""The CBHG conv bank as one product kernel: CUDA kernel and its plain PyTorch
version.

Port of ``tacotron_multispeaker_tpu/ops/conv_bank.py`` ``conv_bank_pallas``:
``y[b, t, o] = relu(Σ_j Σ_d xpad[b, t + j, d] · w[j, d, o] + bias[o])``, the
width-1..K bank folded into one masked width-K convolution, SAME padding
with (K−1)//2 zeros on the left.  x [B, T, D] and w [K, D, O] in the
compute dtype (bf16 or f32), bias [O] in the compute dtype.  The K shifted
products sum in f32, the bias is added in f32, then ReLU and one rounding
to the compute dtype — the Pallas kernel's rounding
(``ops/conv_bank.py:28-33``).

``bank_channels=None`` computes exactly that, for any ``w`` (the JAX
function).  ``bank_channels=C`` computes the bank's function,
``relu(conv(x, w ⊙ mask) + bias)``: output column o belongs to width group
``g = o // C`` of width ``g + 1``, whose taps are ``[c0 − g//2, c0 − g//2 +
g + 1)`` with ``c0 = (K−1)//2`` (:func:`bank_mask`).  For the
masked ``w`` that ``ConvBank`` passes the two agree; the kernel uses the
mask to skip the taps it zeroes (about half of them).

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


def bank_mask(K: int, C: int, O: int, device=None) -> torch.Tensor:
    """[K, 1, O] float32: 1 where tap j is one of column o's width group's
    taps (group ``o // C``, each group keeping its own SAME centring, as the
    JAX package's ``models/modules.py _bank_mask``)."""
    j = torch.arange(K, device=device)[:, None]
    g = torch.arange(O, device=device)[None, :] // C
    lo = (K - 1) // 2 - g // 2
    return ((j >= lo) & (j < lo + g + 1)).float()[:, None, :]


def conv_bank_reference(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                        bank_channels: int | None = None) -> torch.Tensor:
    """Plain version: K shifted float32 products of the rounded operands
    (of ``w ⊙ mask`` with ``bank_channels``)."""
    K, T, O = w.shape[0], x.shape[1], w.shape[2]
    xp = F.pad(x.float(), (0, 0, (K - 1) // 2, K // 2))
    wf = w.float()
    if bank_channels is not None:
        wf = wf * bank_mask(K, bank_channels, O, w.device)
    acc = sum(xp[:, j: j + T, :] @ wf[j] for j in range(K))
    return torch.relu(acc + bias.float()).to(x.dtype)


def _check(x, w, bias, bank_channels):
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
    if bank_channels is not None and (bank_channels < 1 or O % bank_channels
                                      or O // bank_channels > K):
        raise ValueError(f"conv_bank: bank_channels={bank_channels} must divide O={O} "
                         f"into at most K={K} width groups")
    return B, T, D, K, O


def conv_bank(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
              bank_channels: int | None = None) -> torch.Tensor:
    """relu(conv_K(x, w [⊙ mask]) + bias) in x's dtype (see the module
    docstring)."""
    B, T, D, K, O = _check(x, w, bias, bank_channels)
    if torch.is_grad_enabled() and any(a.requires_grad for a in (x, w, bias)):
        raise RuntimeError("conv_bank is inference-only (the JAX package's "
                           "conv_bank_pallas has no VJP): run it under "
                           "torch.no_grad() / inference_mode, or turn "
                           "parallel.use_pallas off for training")
    if x.device.type == "cpu":
        return conv_bank_reference(x, w, bias, bank_channels)
    if x.device.type != "cuda":
        raise ValueError(f"conv_bank runs on cpu or cuda, not {x.device}")
    if max(B * T * max(D, O), K * D * O) > _INT_MAX:
        raise ValueError(f"conv_bank kernel: sizes B*T*max(D,O)={B * T * max(D, O)} / "
                         f"K*D*O={K * D * O} must stay below 2^31")
    x, w, bias = x.contiguous(), w.contiguous(), bias.contiguous()
    if x.dtype == torch.bfloat16 and (D % 8 or O % 8 or x.data_ptr() % 16
                                      or w.data_ptr() % 16):
        raise ValueError(f"conv_bank kernel: bf16 needs D={D} and O={O} multiples of 8 "
                         "and 16-byte aligned x and w (TMA tiles)")
    if x.dtype == torch.bfloat16 and bank_channels is not None and bank_channels % BN_BF16:
        # a bf16 tile of BN columns then spans several width groups and runs
        # the widest one's taps for all of them: the narrower groups' extra
        # taps must hold zeros
        w = w * bank_mask(K, bank_channels, O, w.device).to(w.dtype)
    return _launch(x, w, bias, bank_channels or 0)


# columns of one bf16 output tile (csrc/conv_bank.cu)
BN_BF16 = 128
# A-operand layouts of the bf16 kernel (x's channels in shared memory):
# "wide", 64-channel boxes with 128-byte swizzle, D zero-filled to a
# multiple of 64; "narrow", 16-channel boxes with 32-byte swizzle, D to a
# multiple of 16
LAYOUTS = {"wide": 64, "narrow": 16}


def a_layout(D: int) -> str:
    """The launcher's A layout: narrow where wide would zero-fill D (and a
    narrow stage still fits: D ≤ 128)."""
    return "wide" if D % 64 == 0 or D > 128 else "narrow"


def _launch(x, w, bias, C: int, layout: str | None = None) -> torch.Tensor:
    """Launch the kernel on checked, contiguous CUDA tensors; ``C`` is the
    bank's group width (0: no mask), ``layout`` the bf16 A layout
    (:func:`a_layout` by default)."""
    B, T, D = x.shape
    K, _, O = w.shape
    y = torch.empty((B, T, O), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.conv_bank_launch(x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                                   y.data_ptr(), B, T, D, K, O, C,
                                   int(x.dtype == torch.bfloat16), LAYOUTS[layout or a_layout(D)],
                                   stream)
    cuda_build.check(err, "conv_bank kernel launch")
    global launches
    launches += 1
    return y


def bf16_plan(B: int, T: int, D: int, K: int, O: int, layout: str | None = None) -> dict:
    """The bf16 launch the kernel makes at these sizes: consumer warpgroups
    (a tile's rows / 64), ring stages and dynamic shared memory bytes."""
    out = (ctypes.c_int * 3)()
    err = _lib().conv_bank_plan(B, T, D, K, O, LAYOUTS[layout or a_layout(D)], out)
    cuda_build.check(err, "conv_bank plan")
    return {"warpgroups": out[0], "stages": out[1], "smem_bytes": out[2]}


def _lib() -> ctypes.CDLL:
    lib = cuda_build.library("conv_bank")
    if not getattr(lib, "_typed", False):
        lib.conv_bank_launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                                         + [ctypes.c_void_p])
        lib.conv_bank_launch.restype = ctypes.c_int
        lib.conv_bank_plan.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
        lib.conv_bank_plan.restype = ctypes.c_int
        lib._typed = True
    return lib
