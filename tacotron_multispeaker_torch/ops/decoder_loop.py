"""The whole autoregressive decode in one launch: CUDA kernel and its plain
PyTorch version.

Port of ``tacotron_multispeaker_tpu/ops/decoder_loop.py``
``decoder_loop_pallas``.  Per step: prenet on the fed-back frame (dropout
masks streamed in) → attention GRU over [prenet, context] → Bahdanau
attention (f32 energies, masked softmax, context) → dec_in Dense →
residual GRU stack → r·M frame projection, the last frame fed back.

Layouts follow the JAX package: keys [B, L, A] and memory [B, L, D] in the
compute dtype, mask [B, L] bool, dm1 [S, B, P1] / dm2 [S, B, P2] f32
(0 or 1/keep), attn_h0 [B, H] f32, dec_h0 [N, B, H] f32 → frames
[S, B, r·M] f32 and alignments [S, B, L] f32.  Every matmul rounds its
input vector and its weights to the compute dtype and sums in f32.

:func:`decoder_loop` runs the plain version for CPU tensors and the CUDA
kernel (``csrc/decoder_loop.cu``) for CUDA tensors; anything else raises.
The kernel needs no padding: a thread-block cluster of C CTAs decodes one
batch row, so ragged lengths and any L are handled by the mask alone.
:func:`launch_plan` picks C from the batch, the hidden width and the
number of clusters of each size the card can hold at once.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import cuda_build
from .cluster_plan import CLUSTER_SIZES, launch_plan
from ..models.helpers import feedback_frame

# launches of the CUDA kernel (the plain version does not count)
launches = 0
# (C, co-resident clusters of C) of the last launch
last_plan: tuple[int, int] | None = None

_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
_NTHREADS = 384       # csrc/cluster_common.cuh CTHREADS (threads of a CTA)
_MAX_LAYERS = 4
_HEAD_BYTES = 2256         # csrc/decoder_loop.cu HEAD_FLOATS * 4: 21 jobs, 16 plans
_cluster_counts: dict[tuple, dict[int, int]] = {}


class DecoderWeights(NamedTuple):
    """Decoder parameters, pre-split so the kernel never concatenates.

    Matrices are [in, out] in the compute dtype, biases f32.  M = num_mels,
    P1/P2 = prenet widths, H = decoder_depth, A = attention_depth, D =
    memory depth, r = outputs_per_step, N = decoder_layers.
    """
    w1: torch.Tensor          # [M, P1] prenet dense 0
    b1: torch.Tensor          # [P1]
    w2: torch.Tensor          # [P1, P2] prenet dense 1
    b2: torch.Tensor          # [P2]
    a_xg_pn: torch.Tensor     # [P2, 2H] attn-GRU gate x-proj (prenet part)
    a_xg_ctx: torch.Tensor    # [D, 2H]  attn-GRU gate x-proj (context part)
    a_bg: torch.Tensor        # [2H]
    a_xc_pn: torch.Tensor     # [P2, H]  attn-GRU candidate x-proj
    a_xc_ctx: torch.Tensor    # [D, H]
    a_bc: torch.Tensor        # [H]
    a_hg: torch.Tensor        # [H, 2H]  attn-GRU recurrent
    a_hc: torch.Tensor        # [H, H]
    wq: torch.Tensor          # [H, A] attention query projection
    v: torch.Tensor           # [A] attention energy vector
    d_h: torch.Tensor         # [H, H] dec_in Dense (attn_h part)
    d_ctx: torch.Tensor       # [D, H] dec_in Dense (context part)
    d_b: torch.Tensor         # [H]
    l_xg: tuple               # N × [H, 2H] residual-GRU gate x-projs
    l_bg: tuple               # N × [2H]
    l_xc: tuple               # N × [H, H]
    l_bc: tuple               # N × [H]
    l_hg: tuple               # N × [H, 2H]
    l_hc: tuple               # N × [H, H]
    wf: torch.Tensor          # [H, r*M] frame projection
    bf: torch.Tensor          # [r*M]

    def cast(self, dtype: torch.dtype) -> "DecoderWeights":
        """Matrices (and v) to ``dtype``, biases to f32, all contiguous."""
        out = {}
        for name, val in self._asdict().items():
            want = torch.float32 if _is_bias(name) else dtype
            conv = lambda t: t.to(want).contiguous()
            out[name] = tuple(map(conv, val)) if isinstance(val, tuple) else conv(val)
        return DecoderWeights(**out)


def _is_bias(name: str) -> bool:
    return name in ("b1", "b2", "a_bg", "a_bc", "d_b", "l_bg", "l_bc", "bf")


def decoder_loop_reference(weights: DecoderWeights, keys, memory, mask,
                           dropout1, dropout2, attn_h0, dec_h0,
                           n_steps: int, num_mels: int):
    """Plain PyTorch loop with the kernel's math."""
    B = keys.shape[0]
    H = weights.a_hc.shape[0]
    M = num_mels
    cdt = keys.dtype
    n_layers = len(weights.l_xg)
    f32 = torch.float32
    w = {k: (tuple(t.to(cdt).float() for t in v) if isinstance(v, tuple)
             else (v.float() if _is_bias(k) else v.to(cdt).float()))
         for k, v in weights._asdict().items()}
    rnd = lambda x: x.to(cdt).float()
    keys_f = keys.float()
    mem_f = memory.float()
    maskf = mask.to(f32)

    def gru(h, xg, xc, whg, whc):
        g = torch.sigmoid(xg + rnd(h) @ whg)
        r, u = g[:, :H], g[:, H:]
        c = torch.tanh(xc + rnd(r * h) @ whc)
        return u * h + (1.0 - u) * c

    attn_h = attn_h0.to(f32)
    dec_hs = [dec_h0[i].to(f32) for i in range(n_layers)]
    ctx = torch.zeros((B, memory.shape[-1]), dtype=f32, device=keys.device)
    prev = torch.zeros((B, M), dtype=f32, device=keys.device)
    frames_out, align_out = [], []
    for t in range(n_steps):
        x = torch.relu(rnd(prev) @ w["w1"] + w["b1"]) * dropout1[t]
        pn = rnd(torch.relu(rnd(x) @ w["w2"] + w["b2"]) * dropout2[t])
        xg = pn @ w["a_xg_pn"] + rnd(ctx) @ w["a_xg_ctx"] + w["a_bg"]
        xc = pn @ w["a_xc_pn"] + rnd(ctx) @ w["a_xc_ctx"] + w["a_bc"]
        attn_h = gru(attn_h, xg, xc, w["a_hg"], w["a_hc"])
        q = rnd(attn_h) @ w["wq"]                                    # [B, A]
        e = torch.tanh(keys_f + q[:, None, :]) @ w["v"]              # [B, L]
        e = torch.where(mask, e, torch.full_like(e, -1e9))
        p = torch.exp(e - e.max(dim=-1, keepdim=True).values) * maskf
        p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-9)
        ctx = torch.bmm(rnd(p)[:, None, :], mem_f)[:, 0, :]         # [B, D]
        x = rnd(attn_h) @ w["d_h"] + rnd(ctx) @ w["d_ctx"] + w["d_b"]
        for i in range(n_layers):
            xi = rnd(x)
            xg = xi @ w["l_xg"][i] + w["l_bg"][i]
            xc = xi @ w["l_xc"][i] + w["l_bc"][i]
            dec_hs[i] = gru(dec_hs[i], xg, xc, w["l_hg"][i], w["l_hc"][i])
            x = x + dec_hs[i]
        frames = rnd(x) @ w["wf"] + w["bf"]
        prev = feedback_frame(frames, frames.shape[-1] // M, M)
        frames_out.append(frames)
        align_out.append(p)
    return torch.stack(frames_out), torch.stack(align_out)


def decoder_loop(weights: DecoderWeights, keys, memory, mask, dropout1,
                 dropout2, attn_h0, dec_h0, n_steps: int, num_mels: int):
    """Fused autoregressive decode (see the module docstring)."""
    B, L, A = keys.shape
    D = memory.shape[-1]
    H = weights.a_hc.shape[0]
    n_layers = len(weights.l_xg)
    P1, P2 = weights.w1.shape[1], weights.w2.shape[1]
    RM = weights.wf.shape[1]
    want = {"memory": (memory, (B, L, D)), "mask": (mask, (B, L)),
            "dropout1": (dropout1, (n_steps, B, P1)),
            "dropout2": (dropout2, (n_steps, B, P2)),
            "attn_h0": (attn_h0, (B, H)), "dec_h0": (dec_h0, (n_layers, B, H))}
    for name, (a, shape) in want.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(a.shape)}")
    if keys.device.type == "cpu":
        return decoder_loop_reference(weights, keys, memory, mask, dropout1,
                                      dropout2, attn_h0, dec_h0, n_steps, num_mels)
    if keys.device.type != "cuda":
        raise ValueError(f"decoder_loop runs on cpu or cuda, not {keys.device}")
    return _decoder_loop_cuda(weights, keys, memory, mask, dropout1, dropout2,
                              attn_h0, dec_h0, n_steps, num_mels)


def smem_bytes(L, A, D, H, M, P1, P2, RM, n_layers, C, vec) -> int:
    """Shared memory one CTA of the kernel takes (csrc/decoder_loop.cu
    ``smem_floats``: the job and plan tables, the biases and the vectors)."""
    wmax = max(P1, P2, 2 * H, A, D, RM)
    biases = P1 + P2 + 4 * H + 3 * n_layers * H + RM
    floats = (_NTHREADS * (vec + 32) + 64 + biases + M + P1 + P2 + D + H * (n_layers + 7)
              + 2 * A + (C + 2) * L + 2 * wmax)
    return 4 * floats + _HEAD_BYTES


def check_limits(*, L, A, D, H, M, P1, P2, RM, n_layers, vec) -> None:
    """Raise ValueError where the kernel cannot take these widths (the
    limits of csrc/decoder_loop.cu's source note, at C = 1, which every
    batch can fall back to; a larger C only narrows each CTA's share)."""
    if n_layers > _MAX_LAYERS:
        raise ValueError(f"decoder_loop kernel: {n_layers} layers > {_MAX_LAYERS}")
    for name, n in (("P1", P1), ("P2", P2), ("H", H), ("A", A), ("D", D), ("r*M", RM)):
        if n % vec or n > vec * _NTHREADS:
            raise ValueError(f"decoder_loop kernel: width {name}={n} must be a "
                             f"multiple of {vec} and at most {vec * _NTHREADS}")
    if 3 * H > vec * _NTHREADS:
        raise ValueError(f"decoder_loop kernel: 3H={3 * H} (a GRU phase's gate and "
                         f"candidate columns) must be at most {vec * _NTHREADS}")
    if RM < M:
        raise ValueError(f"decoder_loop kernel: frame width {RM} < num_mels={M}")
    smem = smem_bytes(L, A, D, H, M, P1, P2, RM, n_layers, 1, vec)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"decoder_loop kernel: L={L} needs {smem} bytes of "
                         f"shared memory (> {_SMEM_LIMIT})")


def cluster_counts(dims: tuple, is_bf16: int, device) -> dict:
    """{C: clusters of C CTAs the card can hold at once} for the kernel at
    ``dims`` (B, L, A, D, H, M, P1, P2, RM, n_layers, n_steps) on ``device``
    (cudaOccupancyMaxActiveClusters; 0 where a CTA's shared memory would not
    fit).  Cached by widths, dtype and device."""
    _, L, A, D, H, M, P1, P2, RM, n_layers = dims[:10]
    key = (tuple(dims[1:10]), is_bf16, device)
    if key not in _cluster_counts:
        lib, counts = _lib(), {}
        for C in CLUSTER_SIZES:
            if smem_bytes(L, A, D, H, M, P1, P2, RM, n_layers, C,
                          8 if is_bf16 else 4) > _SMEM_LIMIT:
                counts[C] = 0
                continue
            d = (ctypes.c_int * 13)(*dims[:11], C, is_bf16)
            n = ctypes.c_int(0)
            with torch.cuda.device(device):
                err = lib.decoder_loop_max_clusters(ctypes.cast(d, ctypes.c_void_p),
                                                    ctypes.byref(n))
            cuda_build.check(err, f"decoder_loop cluster occupancy query (C={C})")
            counts[C] = n.value
        _cluster_counts[key] = counts
    return _cluster_counts[key]


def _decoder_loop_cuda(weights, keys, memory, mask, dm1, dm2, attn_h0, dec_h0,
                       n_steps, M, cluster: int | None = None):
    """The kernel launch.  ``cluster`` forces the cluster size (kernel checks
    only; the model's path leaves it to :func:`launch_plan`)."""
    B, L, A = keys.shape
    D = memory.shape[-1]
    H = weights.a_hc.shape[0]
    n_layers = len(weights.l_xg)
    P1, P2 = weights.w1.shape[1], weights.w2.shape[1]
    RM = weights.wf.shape[1]
    cdt = keys.dtype
    if cdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute dtype must be float32 or bfloat16, got {cdt}")
    vec = 16 // keys.element_size()
    check_limits(L=L, A=A, D=D, H=H, M=M, P1=P1, P2=P2, RM=RM, n_layers=n_layers, vec=vec)
    if weights.w1.shape[0] != M:
        raise ValueError(f"decoder_loop kernel: prenet input {weights.w1.shape[0]} "
                         f"does not match num_mels={M}")
    typed = [("keys", keys, cdt), ("memory", memory, cdt), ("mask", mask, torch.bool),
             ("dropout1", dm1, torch.float32), ("dropout2", dm2, torch.float32),
             ("attn_h0", attn_h0, torch.float32), ("dec_h0", dec_h0, torch.float32)]
    for name, val in weights._asdict().items():
        want = torch.float32 if _is_bias(name) else cdt
        vals = val if isinstance(val, tuple) else (val,)
        typed += [(name, t, want) for t in vals]
    for name, t, want in typed:
        if t.device != keys.device:
            raise ValueError(f"{name} is on {t.device}, keys on {keys.device}")
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype} "
                            "(DecoderWeights.cast gives the kernel's dtypes)")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    frames = torch.empty((n_steps, B, RM), dtype=torch.float32, device=keys.device)
    align = torch.empty((n_steps, B, L), dtype=torch.float32, device=keys.device)
    if n_steps == 0 or B == 0:
        return frames, align
    w = weights
    flat = [keys, memory, mask, dm1, dm2, attn_h0, dec_h0, w.w1, w.b1, w.w2, w.b2,
            w.a_xg_pn, w.a_xg_ctx, w.a_bg, w.a_xc_pn, w.a_xc_ctx, w.a_bc,
            w.a_hg, w.a_hc, w.wq, w.v, w.d_h, w.d_ctx, w.d_b, w.wf, w.bf,
            frames, align]
    for i in range(n_layers):
        flat += [w.l_xg[i], w.l_bg[i], w.l_xc[i], w.l_bc[i], w.l_hg[i], w.l_hc[i]]
    is_bf16 = int(cdt == torch.bfloat16)
    dims = (B, L, A, D, H, M, P1, P2, RM, n_layers, n_steps)
    counts = cluster_counts(dims, is_bf16, keys.device)
    C = launch_plan(B, H, vec, counts) if cluster is None else cluster
    if C not in CLUSTER_SIZES or counts[C] == 0:
        raise ValueError(f"decoder_loop kernel: the card holds no cluster of {C} "
                         f"CTAs at these widths (co-resident clusters {counts})")
    ptrs = (ctypes.c_void_p * len(flat))(*[t.data_ptr() for t in flat])
    cdims = (ctypes.c_int * 13)(*dims, C, is_bf16)
    ptrs_p, dims_p = (ctypes.cast(a, ctypes.c_void_p) for a in (ptrs, cdims))
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().decoder_loop_launch(ptrs_p, dims_p, stream)
    cuda_build.check(err, "decoder_loop kernel launch")
    global launches, last_plan
    launches += 1
    last_plan = (C, counts[C])
    return frames, align


def _lib() -> ctypes.CDLL:
    lib = cuda_build.library("decoder_loop")
    if not getattr(lib, "_typed", False):
        lib.decoder_loop_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.c_void_p]
        lib.decoder_loop_launch.restype = ctypes.c_int
        lib.decoder_loop_smem_bytes.argtypes = [ctypes.c_void_p]
        lib.decoder_loop_smem_bytes.restype = ctypes.c_size_t
        lib.decoder_loop_max_clusters.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.decoder_loop_max_clusters.restype = ctypes.c_int
        lib._typed = True
    return lib
