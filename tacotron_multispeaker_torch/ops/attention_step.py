"""One additive-attention step: CUDA kernels and their plain PyTorch versions.

Port of ``tacotron_multispeaker_tpu/ops/attention_step.py``
``attention_step_pallas`` (:func:`attention_step`), with its rounding (``:26-49``): in the compute
dtype of ``keys``, ``act = tanh((keys + q) + location_term)`` (each add and
the tanh rounded to that dtype); energies ``e = Σ_a act·v`` summed in f32;
the masked softmax in f32 (−1e9 at masked positions, ``exp(e − max)·mask``,
the sum floored at 1e-9); the context ``p @ memory`` with p rounded to
memory's dtype and f32 sums.

keys [B, L, A], q [B, A], v [A], memory [B, L, D] all in the compute dtype
(bf16 or f32), mask [B, L] bool, optional location_term [B, L, A] (compute
dtype) → (context [B, D] f32, alignments [B, L] f32).

:func:`attention_step_partial` ports ``attention_step_partial``, the
per-shard half of the sequence-sharded distributed softmax
(ops/sharded_attention.py): the same energies without a location term, and
no normalisation → (ctx_u [B, D], p_u [B, L], m [B, 1], s [B, 1]), all f32:
``p_u = exp(e − m)·mask`` with m the local max of the masked energies (−1e9
for a fully masked shard), s = Σ p_u, ``ctx_u = p_u @ memory`` with p_u
rounded to memory's dtype.

Both run their plain version for CPU tensors and their CUDA kernel
(``csrc/attention_step.cu``) for CUDA tensors; anything else raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

# launches of the CUDA kernels (the plain versions do not count)
launches = 0            # attention_step
partial_launches = 0    # attention_step_partial

_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
_INT_MAX = 2**31 - 1


def attention_step_reference(keys, q, v, memory, mask, location_term=None):
    """Plain version with the kernel's rounding."""
    act = keys + q[:, None, :]
    if location_term is not None:
        act = act + location_term
    e = (torch.tanh(act).float() * v.float()).sum(dim=-1)            # [B, L]
    e = torch.where(mask, e, torch.full_like(e, -1e9))
    p = torch.exp(e - e.max(dim=-1, keepdim=True).values) * mask.float()
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-9)
    ctx = torch.bmm(p.to(memory.dtype).float()[:, None, :], memory.float())[:, 0]
    return ctx, p


def _check(keys, q, v, memory, mask, loc):
    if keys.dim() != 3:
        raise ValueError(f"keys must be [B, L, A], got {tuple(keys.shape)}")
    B, L, A = keys.shape
    if memory.dim() != 3 or memory.shape[:2] != (B, L):
        raise ValueError(f"memory must be [{B}, {L}, D], got {tuple(memory.shape)}")
    D = memory.shape[-1]
    want = {"q": (q, (B, A)), "v": (v, (A,)), "mask": (mask, (B, L))}
    if loc is not None:
        want["location_term"] = (loc, (B, L, A))
    for name, (a, shape) in want.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(a.shape)}")
    if keys.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute dtype must be float32 or bfloat16, got {keys.dtype}")
    typed = [("q", q, keys.dtype), ("v", v, keys.dtype), ("memory", memory, keys.dtype),
             ("mask", mask, torch.bool)]
    if loc is not None:
        typed.append(("location_term", loc, keys.dtype))
    for name, a, dt in typed:
        if a.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {a.dtype}")
        if a.device != keys.device:
            raise ValueError(f"{name} is on {a.device}, keys on {keys.device}")
    return B, L, A, D


def attention_step_partial_reference(keys, q, v, memory, mask):
    """Plain version of the per-shard partial with the kernel's rounding."""
    e = (torch.tanh(keys + q[:, None, :]).float() * v.float()).sum(dim=-1)   # [B, L]
    e = torch.where(mask, e, torch.full_like(e, -1e9))
    m = e.max(dim=-1, keepdim=True).values
    p = torch.exp(e - m) * mask.float()
    s = p.sum(dim=-1, keepdim=True)
    ctx = torch.bmm(p.to(memory.dtype).float()[:, None, :], memory.float())[:, 0]
    return ctx, p, m, s


def _check_kernel_limits(name, B, L, A, D, device):
    if device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {device}")
    smem = 4 * (2 * A + L)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{name} kernel: A={A}, L={L} need {smem} bytes of "
                         f"shared memory (> {_SMEM_LIMIT})")
    if B * L * max(A, D) > _INT_MAX:
        raise ValueError(f"{name} kernel: B*L*max(A, D) must stay below 2^31")


def attention_step(keys, q, v, memory, mask, location_term=None):
    """(context [B, D] f32, alignments [B, L] f32); see the module docstring."""
    B, L, A, D = _check(keys, q, v, memory, mask, location_term)
    if keys.device.type == "cpu":
        return attention_step_reference(keys, q, v, memory, mask, location_term)
    _check_kernel_limits("attention_step", B, L, A, D, keys.device)
    tensors = [t.contiguous() for t in (keys, q, v, memory, mask)]
    loc = None if location_term is None else location_term.contiguous()
    ctx = torch.empty((B, D), dtype=torch.float32, device=keys.device)
    align = torch.empty((B, L), dtype=torch.float32, device=keys.device)
    if B == 0 or L == 0:
        return ctx.zero_(), align
    lib = _lib()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.attention_step_launch(
            *(t.data_ptr() for t in tensors), None if loc is None else loc.data_ptr(),
            ctx.data_ptr(), align.data_ptr(), B, L, A, D,
            int(keys.dtype == torch.bfloat16), stream)
    cuda_build.check(err, "attention_step kernel launch")
    global launches
    launches += 1
    return ctx, align


def attention_step_partial(keys, q, v, memory, mask):
    """(ctx_u [B, D], p_u [B, L], m [B, 1], s [B, 1]), all f32; see the
    module docstring.  L = 0 is a fully masked shard."""
    B, L, A, D = _check(keys, q, v, memory, mask, None)
    if L == 0:
        f32 = dict(dtype=torch.float32, device=keys.device)
        return (torch.zeros((B, D), **f32), torch.zeros((B, 0), **f32),
                torch.full((B, 1), -1e9, **f32), torch.zeros((B, 1), **f32))
    if keys.device.type == "cpu":
        return attention_step_partial_reference(keys, q, v, memory, mask)
    _check_kernel_limits("attention_step_partial", B, L, A, D, keys.device)
    tensors = [t.contiguous() for t in (keys, q, v, memory, mask)]
    f32 = dict(dtype=torch.float32, device=keys.device)
    ctx, p = torch.empty((B, D), **f32), torch.empty((B, L), **f32)
    m, s = torch.empty((B, 1), **f32), torch.empty((B, 1), **f32)
    if B == 0:
        return ctx, p, m, s
    lib = _lib()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.attention_step_partial_launch(
            *(t.data_ptr() for t in tensors), ctx.data_ptr(), p.data_ptr(), m.data_ptr(),
            s.data_ptr(), B, L, A, D, int(keys.dtype == torch.bfloat16), stream)
    cuda_build.check(err, "attention_step_partial kernel launch")
    global partial_launches
    partial_launches += 1
    return ctx, p, m, s


def _lib() -> ctypes.CDLL:
    lib = cuda_build.library("attention_step")
    if not getattr(lib, "_typed", False):
        lib.attention_step_launch.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                                              + [ctypes.c_void_p])
        lib.attention_step_launch.restype = ctypes.c_int
        lib.attention_step_partial_launch.argtypes = ([ctypes.c_void_p] * 9
                                                      + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.attention_step_partial_launch.restype = ctypes.c_int
        lib._typed = True
    return lib
