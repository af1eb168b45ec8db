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
(``csrc/attention_step.cu``, one cluster kernel for both) for CUDA tensors;
anything else raises.  The kernel runs a batch row on a thread-block
cluster of C CTAs split along L; C comes from :func:`.cluster_plan.attention_plan`
over the card's co-resident cluster counts (:func:`cluster_counts`, cached),
and the route from the shape (:func:`staged_route`): ``staged`` (the CTA's
slabs by bulk copy into shared memory) or ``direct`` (element loads from
device memory, for rows that are not 16-byte multiples or slabs past shared
memory), each counted.  :func:`attention_step_split_reference` and
:func:`attention_step_partial_split_reference` render the kernel's combine
over C chunks in plain PyTorch, for the tests.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .cluster_plan import CLUSTER_SIZES, attention_plan

# launches of the CUDA kernel (the plain versions do not count): every
# launch of each use, and of those the ones on the direct route
launches = 0                  # attention_step
partial_launches = 0          # attention_step_partial
direct_launches = 0
partial_direct_launches = 0
# the last launch's (C, route, co-resident clusters of C)
last_plan = None

_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
_INT_MAX = 2**31 - 1
# csrc/attention_step.cu: threads of a CTA, the exchange slots, the pieces
# of each slab (one mbarrier each)
_NT, _MAX_C, _NCHUNK = 256, 16, 4


def attention_step_reference(keys, q, v, memory, mask, location_term=None):
    """Plain version with the kernel's rounding."""
    e = _energies(keys, q, v, location_term)
    e = torch.where(mask, e, torch.full_like(e, -1e9))
    p = torch.exp(e - e.max(dim=-1, keepdim=True).values) * mask.float()
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-9)
    ctx = torch.bmm(p.to(memory.dtype).float()[:, None, :], memory.float())[:, 0]
    return ctx, p


def attention_step_partial_reference(keys, q, v, memory, mask):
    """Plain version of the per-shard partial with the kernel's rounding."""
    e = _energies(keys, q, v, None)
    e = torch.where(mask, e, torch.full_like(e, -1e9))
    m = e.max(dim=-1, keepdim=True).values
    p = torch.exp(e - m) * mask.float()
    s = p.sum(dim=-1, keepdim=True)
    ctx = torch.bmm(p.to(memory.dtype).float()[:, None, :], memory.float())[:, 0]
    return ctx, p, m, s


def _energies(keys, q, v, location_term):
    act = keys + q[:, None, :]
    if location_term is not None:
        act = act + location_term
    return (torch.tanh(act).float() * v.float()).sum(dim=-1)            # [B, L]


def _split_combine(e, mask, memory, C, normalise):
    """The kernel's softmax and context over C chunks of the L positions
    (``clu::split``): each chunk's (m_k, s_k = Σ exp(e − m_k)·mask), the
    row's m = max_k m_k and s = Σ_k s_k·exp(m_k − m) in the kernel's order
    (a butterfly over 32 lanes, rank k in lane k), p from the row's m (and
    s), each chunk's context partial summed in rank order."""
    L = e.shape[-1]
    e = torch.where(mask, e, torch.full_like(e, -1e9))
    cuts = [(k * L // C, (k + 1) * L // C) for k in range(C)]
    parts = []
    for l0, l1 in cuts:
        ek, mk = e[:, l0:l1], mask[:, l0:l1]
        m_k = ek.max(dim=-1, keepdim=True).values
        parts.append((m_k, (torch.exp(ek - m_k) * mk.float()).sum(dim=-1, keepdim=True)))
    m = parts[0][0]
    for m_k, _ in parts[1:]:
        m = torch.maximum(m, m_k)
    lanes = [s_k * torch.exp(m_k - m) for m_k, s_k in parts]
    lanes += [torch.zeros_like(m)] * (32 - C)
    for off in (16, 8, 4, 2, 1):
        lanes = [lanes[i] + lanes[i ^ off] for i in range(32)]
    s = lanes[0]
    p = torch.exp(e - m) * mask.float()
    if normalise:
        p = p / torch.clamp(s, min=1e-9)
    pr = p.to(memory.dtype).float()
    ctx = torch.zeros(memory.shape[0], memory.shape[-1], dtype=torch.float32)
    for l0, l1 in cuts:
        ctx = ctx + torch.bmm(pr[:, None, l0:l1], memory[:, l0:l1].float())[:, 0]
    return ctx, p, m, s


def attention_step_split_reference(keys, q, v, memory, mask, location_term=None, C=1):
    """:func:`attention_step_reference` combined as the kernel combines it
    over a cluster of C CTAs (test-only rendering; CPU tensors)."""
    ctx, p, _, _ = _split_combine(_energies(keys, q, v, location_term), mask, memory, C,
                                  normalise=True)
    return ctx, p


def attention_step_partial_split_reference(keys, q, v, memory, mask, C=1):
    """:func:`attention_step_partial_reference` combined as the kernel
    combines it over a cluster of C CTAs (test-only rendering; CPU tensors)."""
    return _split_combine(_energies(keys, q, v, None), mask, memory, C, normalise=False)


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


def smem_bytes(L, A, D, C, esize, loc, staged) -> int:
    """Shared memory one CTA of the kernel takes (``csrc/attention_step.cu``
    ``layout``): mbarriers (the slabs' when staged, the exchanges' when
    C > 1), q and v, the energies of ceil(L/C) positions, the exchange
    slots and the context's receive buffer (C > 1; at C = 1 the kernel's
    one slot is q's place), then (staged) the
    context's per-slice rows and the slabs of keys, location term and
    memory."""
    nl = -(-L // C)
    o = _align16((8 * 2 * _NCHUNK if staged else 0) + (16 if C > 1 else 0))
    o += 8 * A + 4 * nl
    if C > 1:
        o += 8 * _MAX_C + 4 * C * -(-D // C)
    if staged:
        G = D * esize // 16
        R = 1 if G >= _NT else _NT // G
        o = _align16(o) + 4 * R * D
        o = _align16(o) + nl * (A * (2 if loc else 1) + D) * esize
    return o


def _align16(n: int) -> int:
    return (n + 15) & ~15


def rows_aligned(A, D, esize) -> bool:
    """Rows of keys (and location term) and memory are 16-byte multiples."""
    return (A * esize) % 16 == 0 and (D * esize) % 16 == 0


def staged_route(L, A, D, C, esize, loc, aligned) -> bool:
    """The route of a launch at cluster size C: staged (the slabs by bulk
    copy into shared memory) where the tensors are 16-byte aligned with
    rows of 16-byte multiples (``aligned``) and a CTA's slabs fit in shared
    memory; else direct."""
    return aligned and smem_bytes(L, A, D, C, esize, loc, True) <= _SMEM_LIMIT


def kernel_takes(L, A, D, esize, loc) -> bool:
    """Whether some cluster size (C <= L) fits the direct route, and so the
    kernel, in shared memory: at C = 1 that is (2A + L) floats, within the
    first design's limit; a larger C holds ceil(L/C) energies and D."""
    return any(C <= L and smem_bytes(L, A, D, C, esize, loc, False) <= _SMEM_LIMIT
               for C in CLUSTER_SIZES)


def _check_kernel_limits(name, B, L, A, D, esize, loc):
    if not kernel_takes(L, A, D, esize, loc):
        need = smem_bytes(L, A, D, min(16, L), esize, loc, False)
        raise ValueError(f"{name} kernel: A={A}, L={L}, D={D} need {need} bytes of "
                         f"shared memory a CTA even at C={min(16, L)} (> {_SMEM_LIMIT})")
    if B * L * max(A, D) > _INT_MAX:
        raise ValueError(f"{name} kernel: B*L*max(A, D) must stay below 2^31")


_cluster_counts: dict = {}
_plans: dict = {}


def cluster_counts(L, A, D, is_bf16, loc, partial, aligned, device) -> dict:
    """{C: clusters of C CTAs the card holds at once} for the kernel on the
    route :func:`staged_route` gives at each C (cudaOccupancyMaxActiveClusters;
    0 where C > L or a CTA's shared memory would not fit, and 0 for the
    direct route where some C stages: the direct route is for shapes that
    cannot stage at all).  Cached by widths, dtype, use, alignment and
    device."""
    key = (L, A, D, is_bf16, loc, partial, aligned, device)
    if key not in _cluster_counts:
        lib, counts = _lib(), {}
        esize = 2 if is_bf16 else 4
        stages = any(C <= L and staged_route(L, A, D, C, esize, loc, aligned)
                     for C in CLUSTER_SIZES)
        for C in CLUSTER_SIZES:
            staged = staged_route(L, A, D, C, esize, loc, aligned)
            if (C > L or smem_bytes(L, A, D, C, esize, loc, staged) > _SMEM_LIMIT
                    or (stages and not staged)):
                counts[C] = 0
                continue
            dims = (ctypes.c_int * 9)(1, L, A, D, C, is_bf16, loc, partial, staged)
            n = ctypes.c_int(0)
            with torch.cuda.device(device):
                err = lib.attention_step_max_clusters(dims, ctypes.byref(n))
            cuda_build.check(err, f"attention_step cluster occupancy query (C={C})")
            counts[C] = n.value
        _cluster_counts[key] = counts
    return _cluster_counts[key]


def _plan(name, B, L, A, D, is_bf16, loc, aligned, device, cluster):
    """(C, staged, co-resident clusters of C) of a launch, checked against
    the kernel's limits once per shape (cached with it)."""
    key = (name, B, L, A, D, is_bf16, loc, aligned, device, cluster)
    plan = _plans.get(key)
    if plan is None:
        esize = 2 if is_bf16 else 4
        _check_kernel_limits(name, B, L, A, D, esize, loc)
        counts = cluster_counts(L, A, D, is_bf16, loc, int(name == "attention_step_partial"),
                                aligned, device)
        C = attention_plan(B, L, counts) if cluster is None else cluster
        if C not in CLUSTER_SIZES or C > L or counts[C] == 0:
            raise ValueError(f"{name} kernel: the card holds no cluster of {C} CTAs at "
                             f"L={L} (co-resident clusters {counts})")
        plan = _plans[key] = (C, staged_route(L, A, D, C, esize, loc, aligned), counts[C])
    return plan


def _launch(name, keys, q, v, memory, mask, loc, outs, cluster=None):
    """Launch the kernel for ``name`` (attention_step or
    attention_step_partial) at the plan's cluster size, or at ``cluster``
    (kernel checks only).  Returns whether it ran on the direct route."""
    global last_plan
    B, L, A = keys.shape
    D = memory.shape[-1]
    is_bf16 = int(keys.dtype == torch.bfloat16)
    aligned = (rows_aligned(A, D, keys.element_size())
               and keys.data_ptr() % 16 == 0 and memory.data_ptr() % 16 == 0
               and (loc is None or loc.data_ptr() % 16 == 0))
    C, staged, coresident = _plan(name, B, L, A, D, is_bf16, loc is not None, aligned,
                                  keys.device, cluster)
    ptrs = (ctypes.c_void_p * 10)(
        keys.data_ptr(), q.data_ptr(), v.data_ptr(), memory.data_ptr(), mask.data_ptr(),
        None if loc is None else loc.data_ptr(), *(t.data_ptr() for t in outs),
        *([None, None] if len(outs) == 2 else []))
    dims = (ctypes.c_int * 9)(B, L, A, D, C, is_bf16, int(loc is not None),
                              int(name == "attention_step_partial"), int(staged))
    if keys.device.index == torch.cuda.current_device():
        err = _lib().attention_step_launch(ptrs, dims, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(keys.device):
            err = _lib().attention_step_launch(ptrs, dims,
                                               torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, f"{name} kernel launch (C={C}, {'staged' if staged else 'direct'})")
    last_plan = (C, "staged" if staged else "direct", coresident)
    return not staged


def attention_step(keys, q, v, memory, mask, location_term=None, *, cluster=None):
    """(context [B, D] f32, alignments [B, L] f32); see the module docstring.
    ``cluster`` forces the kernel's cluster size (kernel checks only)."""
    B, L, A, D = _check(keys, q, v, memory, mask, location_term)
    if keys.device.type == "cpu":
        return attention_step_reference(keys, q, v, memory, mask, location_term)
    if keys.device.type != "cuda":
        raise ValueError(f"attention_step runs on cpu or cuda, not {keys.device}")
    keys, q, v, memory, mask = (t.contiguous() for t in (keys, q, v, memory, mask))
    loc = None if location_term is None else location_term.contiguous()
    ctx = torch.empty((B, D), dtype=torch.float32, device=keys.device)
    align = torch.empty((B, L), dtype=torch.float32, device=keys.device)
    if B == 0 or L == 0:
        return ctx.zero_(), align
    direct = _launch("attention_step", keys, q, v, memory, mask, loc, (ctx, align), cluster)
    global launches, direct_launches
    launches += 1
    direct_launches += direct
    return ctx, align


def attention_step_partial(keys, q, v, memory, mask, *, cluster=None):
    """(ctx_u [B, D], p_u [B, L], m [B, 1], s [B, 1]), all f32; see the
    module docstring.  L = 0 is a fully masked shard.  ``cluster`` forces
    the kernel's cluster size (kernel checks only)."""
    B, L, A, D = _check(keys, q, v, memory, mask, None)
    if L == 0:
        f32 = dict(dtype=torch.float32, device=keys.device)
        return (torch.zeros((B, D), **f32), torch.zeros((B, 0), **f32),
                torch.full((B, 1), -1e9, **f32), torch.zeros((B, 1), **f32))
    if keys.device.type == "cpu":
        return attention_step_partial_reference(keys, q, v, memory, mask)
    if keys.device.type != "cuda":
        raise ValueError(f"attention_step_partial runs on cpu or cuda, not {keys.device}")
    keys, q, v, memory, mask = (t.contiguous() for t in (keys, q, v, memory, mask))
    f32 = dict(dtype=torch.float32, device=keys.device)
    ctx, p = torch.empty((B, D), **f32), torch.empty((B, L), **f32)
    m, s = torch.empty((B, 1), **f32), torch.empty((B, 1), **f32)
    if B == 0:
        return ctx, p, m, s
    direct = _launch("attention_step_partial", keys, q, v, memory, mask, None,
                     (ctx, p, m, s), cluster)
    global partial_launches, partial_direct_launches
    partial_launches += 1
    partial_direct_launches += direct
    return ctx, p, m, s


def kernel_smem_bytes(L, A, D, C, esize, loc, staged) -> int:
    """The kernel's own count of a CTA's shared memory (the card tests hold
    :func:`smem_bytes` to it)."""
    dims = (ctypes.c_int * 9)(1, L, A, D, C, int(esize == 2), int(loc), 0, int(staged))
    return _lib().attention_step_smem_bytes(dims)


def _lib() -> ctypes.CDLL:
    lib = cuda_build.library("attention_step")
    if not getattr(lib, "_typed", False):
        lib.attention_step_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                              ctypes.c_void_p]
        lib.attention_step_launch.restype = ctypes.c_int
        lib.attention_step_max_clusters.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.attention_step_max_clusters.restype = ctypes.c_int
        lib.attention_step_smem_bytes.argtypes = [ctypes.c_void_p]
        lib.attention_step_smem_bytes.restype = ctypes.c_longlong
        lib._typed = True
    return lib
