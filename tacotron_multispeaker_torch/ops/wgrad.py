"""Weight-gradient reduction of the backward kernels: CUDA kernel and its
plain PyTorch version.

Part of the port of ``tacotron_multispeaker_tpu/ops/gru_scan.py``
``_bigru_scan_bwd_pallas`` and ``ops/teacher_decoder.py``
``_teacher_decoder_bwd_pallas``.  Those Pallas kernels add each step's
weight gradient ``dot_tn(a_t, g_t)`` (both factors rounded to the compute
dtype, f32 sums) and bias gradient ``sum(g_t, 0)`` into VMEM accumulators.
On the card the sequential backward kernels stream the per-step factors out
instead, and this op reduces them over every step and batch row at once:

    C = sum_m round(A[m])^T round(G[m])        (f32)
    bias = sum_m G[m]                          (f32, unrounded)

Each problem is a pair of 3-D views ``a`` [Mo, Mi, K] and ``g`` [Mo, Mi, N]
(rows m = (o, i); any strides, unit stride in the last dim), so a direction
or a column slice of a stream needs no copy.  :func:`wgrad` takes a list of
problems and reduces them all in ONE launch (a grouped product: the grid
walks the output tiles of every problem).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import cuda_build

# launches of the CUDA kernel (the plain version does not count)
launches = 0

_MAX_PROBLEMS = 24    # csrc/wgrad.cu MAX_PROBLEMS
_TILE = 64            # csrc/wgrad.cu TILE (output tile edge)
_TARGET_BLOCKS = 528  # four blocks per SM of an H100 (132 SMs)
_MIN_ROWS = 256       # fewest rows a split takes (8 stages of 32)


def wgrad_reference(problems: Sequence[tuple], cdt: torch.dtype) -> list:
    """Plain version: ``problems`` is a sequence of (a, g, with_bias);
    returns [(C [K, N] f32, bias [N] f32 or None)]."""
    rnd = lambda x: x.to(cdt).float()
    out = []
    for a, g, with_bias in problems:
        a2 = rnd(a.reshape(-1, a.shape[-1]))
        g2 = g.reshape(-1, g.shape[-1]).float()
        c = a2.t() @ rnd(g2)
        out.append((c, g2.sum(0) if with_bias else None))
    return out


class _Problem(ctypes.Structure):
    _fields_ = [("a", ctypes.c_void_p), ("g", ctypes.c_void_p),
                ("c", ctypes.c_void_p), ("bias", ctypes.c_void_p),
                ("a_so", ctypes.c_longlong), ("a_si", ctypes.c_longlong),
                ("g_so", ctypes.c_longlong), ("g_si", ctypes.c_longlong),
                ("m_outer", ctypes.c_int), ("m_inner", ctypes.c_int),
                ("K", ctypes.c_int), ("N", ctypes.c_int),
                ("a_bf16", ctypes.c_int), ("g_bf16", ctypes.c_int)]


def _check(problems, cdt):
    if cdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute dtype must be float32 or bfloat16, got {cdt}")
    dev = problems[0][0].device if problems else None
    for n, (a, g, _) in enumerate(problems):
        if a.dim() != 3 or g.dim() != 3 or a.shape[:2] != g.shape[:2]:
            raise ValueError(f"problem {n}: a [Mo, Mi, K] and g [Mo, Mi, N] must share "
                             f"their rows, got {tuple(a.shape)} and {tuple(g.shape)}")
        for name, t in (("a", a), ("g", g)):
            if t.device != dev:
                raise ValueError(f"problem {n}: {name} is on {t.device}, not {dev}")
            if t.dtype not in (torch.float32, torch.bfloat16):
                raise TypeError(f"problem {n}: {name} must be float32 or bfloat16, "
                                f"got {t.dtype}")
    return dev


def wgrad(problems: Sequence[tuple], cdt: torch.dtype) -> list:
    """All weight (and bias) gradients of ``problems`` (see the module
    docstring); CPU tensors take the plain version, CUDA tensors one launch
    of ``csrc/wgrad.cu``."""
    problems = list(problems)
    dev = _check(problems, cdt)
    if not problems:
        return []
    if dev.type == "cpu":
        return wgrad_reference(problems, cdt)
    if dev.type != "cuda":
        raise ValueError(f"wgrad runs on cpu or cuda, not {dev}")
    if len(problems) > _MAX_PROBLEMS:
        raise ValueError(f"wgrad kernel: {len(problems)} problems > {_MAX_PROBLEMS}")
    out, descs = [], []
    for n, (a, g, with_bias) in enumerate(problems):
        if a.stride(-1) != 1 or g.stride(-1) != 1:
            raise ValueError(f"problem {n}: the last dim of a and g must be contiguous")
        Mo, Mi, K = a.shape
        N = g.shape[-1]
        if Mo * Mi >= 2 ** 31 or K >= 2 ** 31 or N >= 2 ** 31:
            raise ValueError(f"problem {n}: sizes must fit in 32 bits")
        c = torch.empty((K, N), dtype=torch.float32, device=dev)
        bias = torch.empty((N,), dtype=torch.float32, device=dev) if with_bias else None
        out.append((c, bias))
        descs.append(_Problem(a.data_ptr(), g.data_ptr(), c.data_ptr(),
                              bias.data_ptr() if bias is not None else None,
                              a.stride(0), a.stride(1), g.stride(0), g.stride(1),
                              Mo, Mi, K, N, int(a.dtype == torch.bfloat16),
                              int(g.dtype == torch.bfloat16)))
    arr = ctypes.cast((_Problem * len(descs))(*descs), ctypes.c_void_p)
    lib = _lib()
    splits = _splits(problems)
    scratch = torch.empty((lib.wgrad_scratch_floats(arr, len(descs), splits),),
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.wgrad_launch(arr, len(descs), splits, scratch.data_ptr(),
                               int(cdt == torch.bfloat16), stream)
    cuda_build.check(err, "wgrad kernel launch")
    global launches
    launches += 1
    return out


def _splits(problems) -> int:
    """Row ranges per problem: enough blocks to fill the card, each range at
    least _MIN_ROWS rows of the smallest problem."""
    tiles = sum(-(-a.shape[-1] // _TILE) * -(-g.shape[-1] // _TILE) for a, g, _ in problems)
    rows = min(a.shape[0] * a.shape[1] for a, _, _ in problems)
    return int(max(1, min(-(-_TARGET_BLOCKS // max(tiles, 1)), rows // _MIN_ROWS, 65535)))


def _lib() -> ctypes.CDLL:
    lib = cuda_build.library("wgrad")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.wgrad_launch.argtypes = [p, i, i, p, i, p]
        lib.wgrad_launch.restype = i
        lib.wgrad_scratch_floats.argtypes = [p, i, i]
        lib.wgrad_scratch_floats.restype = ctypes.c_longlong
        lib._typed = True
    return lib
