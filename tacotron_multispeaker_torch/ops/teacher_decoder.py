"""The teacher-forced decoder scan, fused and differentiable: CUDA kernels
and their plain PyTorch versions.

Port of ``tacotron_multispeaker_tpu/ops/teacher_decoder.py``:

* forward ``_teacher_decoder_fwd_pallas`` → ``csrc/teacher_decoder_fwd.cu``
  (:func:`teacher_decoder_fwd`, plain :func:`teacher_decoder_fwd_reference`):
  a thread-block cluster of C CTAs runs one batch row, C from
  :func:`launch_plan` over the card's co-resident cluster counts
  (:func:`fwd_cluster_counts`), as the fused decoder loop picks it;
* backward ``_teacher_decoder_bwd_pallas`` → ``csrc/teacher_decoder_bwd.cu``
  (:func:`teacher_decoder_bwd`, plain :func:`teacher_decoder_bwd_reference`):
  two launches, the carry-free prologue over all S·B rows
  (:func:`teacher_bwd_remat`, plain :func:`teacher_bwd_remat_reference`:
  the forward's gate values, context and query, rebuilt from the saved
  states), then the reverse-time scan of the gradient chain alone; the
  weight gradients ``csrc/wgrad.cu`` reduces from the per-step factors both
  launches stream out;
* ``_dkeys_pallas`` → ``csrc/dkeys.cu`` (:func:`dkeys`, plain
  :func:`dkeys_reference`), which also sums ``dv``;
* the ``teacher_decoder`` custom VJP → :class:`TeacherDecoder`, a
  ``torch.autograd.Function`` (:func:`teacher_decoder` applies it).

Per step (the math of the restructured ``Tacotron.teacher_mel`` scan):
attention GRU over the prenet projections plus the previous step's context
block → Bahdanau attention (f32 energies, masked softmax) → context → the
merged context block ``ctx @ w_ctx`` ([dec_in ctx | attn xg ctx | attn xc
ctx]) → dec_in → residual GRU stack → ``xs`` (pre-frame-projection).

Layouts follow the JAX package, time-major: png [S, B, 2H] and pnc [S, B, H]
(prenet halves of the attention-GRU input projections, biases included) in
the compute dtype, h0a [B, H] and h0d [N, B, H] f32, keys [B, L, A] and
memory [B, L, D] in the compute dtype, mask [B, L] bool → xs [S, B, H] and
align [S, B, L] f32.  Every matmul rounds its input vector to the compute
dtype and sums in f32; the weights are read in the compute dtype
(:meth:`TeacherDecoderWeights.cast`).

CPU tensors take the plain versions, CUDA tensors the kernels; anything else
raises.  No kernel needs padding: a cluster (forward) or a block (backward)
runs one batch row, so ragged lengths and any L are handled by the mask
alone.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import cuda_build, wgrad
from .cluster_plan import CLUSTER_SIZES, launch_plan

# launches of the CUDA kernels (the plain versions do not count)
fwd_launches = 0          # csrc/teacher_decoder_fwd.cu
bwd_launches = 0          # csrc/teacher_decoder_bwd.cu, the reverse-time scan
bwd_remat_launches = 0    # csrc/teacher_decoder_bwd.cu, the prologue before it
dkeys_launches = 0    # csrc/dkeys.cu

# (C, co-resident clusters of C) of the forward kernel's last launch
fwd_last_plan: tuple[int, int] | None = None

_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
_NTHREADS = 512       # csrc/decoder_common.cuh NTHREADS (the backward's blocks)
_CTHREADS = 384       # csrc/cluster_common.cuh CTHREADS (the forward's CTAs)
_FWD_HEAD_BYTES = 2000    # csrc/teacher_decoder_fwd.cu HEAD_FLOATS * 4: 19 jobs, 13 plans
_MAX_LAYERS = 4
_fwd_cluster_counts: dict[tuple, dict[int, int]] = {}
_F32_FIELDS = ("d_b", "b_r")   # the biases: f32 in every version


class TeacherDecoderWeights(NamedTuple):
    """Decoder-scan parameters (H = decoder_depth, A = attention_depth,
    D = memory depth, N = decoder_layers).  Matrices are [in, out]."""
    a_hg: torch.Tensor    # [H, 2H] attention-GRU recurrent gate weights
    a_hc: torch.Tensor    # [H, H]  attention-GRU recurrent candidate weights
    wq: torch.Tensor      # [H, A]  attention query projection
    v: torch.Tensor       # [A]     attention energy vector
    w_ctx: torch.Tensor   # [D, 4H] merged context projection
    wd_h: torch.Tensor    # [H, H]  dec_in Dense (attn_h half)
    d_b: torch.Tensor     # [H]
    w_r: tuple            # N × [H, 3H] residual-GRU merged input projections
    b_r: tuple            # N × [3H]
    hg: tuple             # N × [H, 2H] residual-GRU recurrent gate weights
    hc: tuple             # N × [H, H]  residual-GRU recurrent candidate

    def cast(self, dtype: torch.dtype) -> "TeacherDecoderWeights":
        """Matrices (and v) to ``dtype``, biases to f32, all contiguous."""
        out = {}
        for name, val in self._asdict().items():
            want = torch.float32 if name in _F32_FIELDS else dtype
            conv = lambda t: t.to(want).contiguous()
            out[name] = tuple(map(conv, val)) if isinstance(val, tuple) else conv(val)
        return TeacherDecoderWeights(**out)

    def flat(self) -> list:
        return [t for v in self for t in (v if isinstance(v, tuple) else (v,))]

    @staticmethod
    def unflat(flat, n_layers: int) -> "TeacherDecoderWeights":
        head, rest = list(flat[:7]), flat[7:]
        groups = [tuple(rest[i * n_layers:(i + 1) * n_layers]) for i in range(4)]
        return TeacherDecoderWeights(*head, *groups)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _plain_weights(w: TeacherDecoderWeights, cdt: torch.dtype) -> TeacherDecoderWeights:
    """Matrices rounded to the compute dtype and widened to f32, biases f32."""
    out = {}
    for name, val in w._asdict().items():
        conv = (lambda t: t.float()) if name in _F32_FIELDS else (lambda t: t.to(cdt).float())
        out[name] = tuple(map(conv, val)) if isinstance(val, tuple) else conv(val)
    return TeacherDecoderWeights(**out)


def _gru(h, xg, xc, whg, whc, H, rnd):
    g = torch.sigmoid(xg + rnd(h) @ whg)
    r, u = g[:, :H], g[:, H:]
    c = torch.tanh(xc + rnd(r * h) @ whc)
    return u * h + (1.0 - u) * c


def teacher_decoder_fwd_reference(png, pnc, h0a, h0d, weights: TeacherDecoderWeights,
                                  keys, memory, mask):
    """Plain forward with the Pallas ``_fwd_kernel``'s math (the initial
    states rounded to the compute dtype, as that kernel receives them).
    Returns (xs, align, ha, hds): ha [S, B, H] and hds N × [S, B, H] are the
    f32 states the backward rematerialises from.  Differentiable by
    ``torch.autograd``."""
    S, B, H2 = png.shape
    H = H2 // 2
    cdt = keys.dtype
    rnd = lambda x: x.to(cdt).float()
    w = _plain_weights(weights, cdt)
    n_layers = len(w.w_r)
    keys_f, mem_f = keys.float(), memory.float()
    maskf = mask.float()
    h_a = rnd(h0a.float())
    h_ds = [rnd(h0d[i].float()) for i in range(n_layers)]
    cb = torch.zeros((B, 4 * H), dtype=torch.float32, device=png.device)
    xs, align, has, hds = [], [], [], [[] for _ in range(n_layers)]
    for t in range(S):
        xg = png[t].float() + cb[:, H:3 * H]
        xc = pnc[t].float() + cb[:, 3 * H:]
        h_a = _gru(h_a, xg, xc, w.a_hg, w.a_hc, H, rnd)
        has.append(h_a)
        q = rnd(h_a) @ w.wq                                          # [B, A]
        e = torch.tanh(keys_f + q[:, None, :]) @ w.v                 # [B, L]
        e = torch.where(mask, e, torch.full_like(e, -1e9))
        p = torch.exp(e - e.max(dim=-1, keepdim=True).values) * maskf
        p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-9)
        align.append(p)
        ctx = torch.bmm(rnd(p)[:, None, :], mem_f)[:, 0, :]          # [B, D]
        cb = rnd(ctx) @ w.w_ctx                                      # [B, 4H]
        x = rnd(h_a) @ w.wd_h + cb[:, :H] + w.d_b
        for i in range(n_layers):
            xgc = rnd(x) @ w.w_r[i] + w.b_r[i]
            h_ds[i] = _gru(h_ds[i], xgc[:, :2 * H], xgc[:, 2 * H:], w.hg[i], w.hc[i], H, rnd)
            hds[i].append(h_ds[i])
            x = x + h_ds[i]
        xs.append(x)
    return (torch.stack(xs), torch.stack(align), torch.stack(has),
            tuple(torch.stack(h) for h in hds))


def teacher_decoder_reference(png, pnc, h0a, h0d, weights, keys, memory, mask):
    """Plain differentiable forward → (xs, align) (the JAX package's
    ``teacher_decoder_reference``)."""
    return teacher_decoder_fwd_reference(png, pnc, h0a, h0d, weights, keys, memory, mask)[:2]


def _gru_remat(xg, xc, hp, whg, whc, H, rnd):
    """A legacy-GRU step's forward values from its input sums and h_prev:
    ([r | u | c], rh = r*h_prev)."""
    g = torch.sigmoid(xg + rnd(hp) @ whg)
    r, u = g[..., :H], g[..., H:]
    rh = r * hp
    c = torch.tanh(xc + rnd(rh) @ whc)
    return torch.cat([r, u, c], dim=-1), rh


def teacher_bwd_remat_reference(png, pnc, ha, hap, hds, hdps, xs, p, pp, dxs, dalign,
                                weights: TeacherDecoderWeights, keys, memory, mask):
    """Plain carry-free prologue of the backward, batched over all S·B rows
    (the values the Pallas ``_bwd_kernel`` rematerialises inside its scan;
    none of them depends on a reverse-time carry).  Takes the arguments of
    :func:`teacher_decoder_bwd` and returns (xin, rh, ruc, rh_a, ctx, q):
    xin N × [S, B, H] each layer's input x_{i-1} = x_i − h_i, rh N × [S, B,
    H] its r·h_prev, ruc N+1 × [S, B, 3H] each GRU's [r | u | c] (the
    attention GRU's last), rh_a [S, B, H], ctx = p_t @ memory [S, B, D] and
    q = ha @ wq [S, B, A], all f32."""
    H = png.shape[-1] // 2
    cdt = keys.dtype
    rnd = lambda x: x.to(cdt).float()
    w = _plain_weights(weights, cdt)
    n_layers = len(w.w_r)
    mem_f = memory.float()
    xin, rh, ruc = [None] * n_layers, [None] * n_layers, [None] * (n_layers + 1)
    x = xs.float()
    for i in range(n_layers - 1, -1, -1):
        x = x - hds[i].float()
        xin[i] = x
        xgc = rnd(x) @ w.w_r[i] + w.b_r[i]
        ruc[i], rh[i] = _gru_remat(xgc[..., :2 * H], xgc[..., 2 * H:], hdps[i].float(),
                                   w.hg[i], w.hc[i], H, rnd)
    per_row = lambda a: (rnd(a.float()).transpose(0, 1) @ mem_f).transpose(0, 1)
    ctx = per_row(p).contiguous()                                   # [S, B, D]
    cb_prev = rnd(per_row(pp)) @ w.w_ctx                            # [S, B, 4H]
    ruc[n_layers], rh_a = _gru_remat(png.float() + cb_prev[..., H:3 * H],
                                     pnc.float() + cb_prev[..., 3 * H:], hap.float(),
                                     w.a_hg, w.a_hc, H, rnd)
    q = rnd(ha.float()) @ w.wq
    return tuple(xin), tuple(rh), tuple(ruc), rh_a, ctx, q


def _gru_bwd(dht, ruc, hp, whg, whc, H, rnd):
    """Back-propagate through a legacy-GRU step given its forward values
    ruc = [r | u | c]: (dg_pre [B, 2H], da_c [B, H], dh_prev)."""
    r, u, c = ruc[:, :H], ruc[:, H:2 * H], ruc[:, 2 * H:]
    dc = dht * (1.0 - u)
    du = dht * (hp - c)
    dac = dc * (1.0 - c * c)
    drh = rnd(dac) @ whc.t()
    dr = drh * hp
    dg = torch.cat([dr * r * (1.0 - r), du * u * (1.0 - u)], dim=-1)
    dh_prev = dht * u + drh * r + rnd(dg) @ whg.t()
    return dg, dac, dh_prev


def teacher_decoder_bwd_reference(png, pnc, ha, hap, hds, hdps, xs, p, pp, dxs, dalign,
                                  weights: TeacherDecoderWeights, keys, memory, mask):
    """Plain reverse-time backward with the Pallas ``_bwd_kernel``'s math, in
    the kernel pair's two parts: :func:`teacher_bwd_remat_reference`, then
    the scan of the carries.

    ``hap``/``hdps``/``pp`` are ``ha``/``hds``/``align`` shifted one step
    later (initial states and zeros in front).  Returns (dpng, dpnc, de,
    dctx, dh0a, dh0d, dweights) with every gradient f32; ``dweights.v`` is
    None (:func:`dkeys_reference` sums it, as csrc/dkeys.cu does)."""
    S, B, H2 = png.shape
    H = H2 // 2
    cdt = keys.dtype
    rnd = lambda x: x.to(cdt).float()
    w = _plain_weights(weights, cdt)
    n_layers = len(w.w_r)
    xin, rh, ruc, rh_a, ctx, q = teacher_bwd_remat_reference(
        png, pnc, ha, hap, hds, hdps, xs, p, pp, dxs, dalign, weights, keys, memory, mask)
    mem_f = memory.float()
    keys_f = keys.float()
    f32 = dict(dtype=torch.float32, device=png.device)
    tn = lambda x, y: rnd(x).t() @ rnd(y)
    zeros = lambda t: torch.zeros_like(t, dtype=torch.float32)
    acc = {k: zeros(getattr(w, k)) for k in ("a_hg", "a_hc", "wq", "w_ctx", "wd_h", "d_b")}
    d_w_r = [zeros(t) for t in w.w_r]
    d_b_r = [zeros(t) for t in w.b_r]
    d_hg = [zeros(t) for t in w.hg]
    d_hc = [zeros(t) for t in w.hc]
    dha = torch.zeros((B, H), **f32)
    dhds = [torch.zeros((B, H), **f32) for _ in range(n_layers)]
    dcbg = torch.zeros((B, 2 * H), **f32)
    dcbc = torch.zeros((B, H), **f32)
    dpng, dpnc, de_out, dctx_out = [None] * S, [None] * S, [None] * S, [None] * S
    for t in range(S - 1, -1, -1):
        dx = dxs[t].float()
        for i in range(n_layers - 1, -1, -1):
            x_im1, hp = xin[i][t], hdps[i][t].float()
            dg, dac, dhds[i] = _gru_bwd(dx + dhds[i], ruc[i][t], hp, w.hg[i], w.hc[i], H, rnd)
            d_hg[i] = d_hg[i] + tn(hp, dg)
            d_hc[i] = d_hc[i] + tn(rh[i][t], dac)
            d_w_r[i] = d_w_r[i] + torch.cat([tn(x_im1, dg), tn(x_im1, dac)], dim=1)
            d_b_r[i] = d_b_r[i] + torch.cat([dg.sum(0), dac.sum(0)])
            dx = dx + rnd(dg) @ w.w_r[i][:, :2 * H].t() + rnd(dac) @ w.w_r[i][:, 2 * H:].t()
        h_a = ha[t].float()
        dha_loc = rnd(dx) @ w.wd_h.t()
        acc["wd_h"] = acc["wd_h"] + tn(h_a, dx)
        acc["d_b"] = acc["d_b"] + dx.sum(0)
        pt = p[t].float()
        dcb = torch.cat([dx, dcbg, dcbc], dim=-1)                      # [B, 4H]
        acc["w_ctx"] = acc["w_ctx"] + tn(ctx[t], dcb)
        dctx = rnd(dcb) @ w.w_ctx.t()                                  # [B, D]
        dctx_out[t] = dctx
        dp = torch.bmm(rnd(dctx)[:, None, :], mem_f.transpose(1, 2))[:, 0, :] \
            + dalign[t].float()
        de = pt * (dp - (dp * pt).sum(-1, keepdim=True))
        de_out[t] = de
        act = torch.tanh(keys_f + q[t][:, None, :])
        dq = (de[:, :, None] * w.v * (1.0 - act * act)).sum(1)         # [B, A]
        dha_loc = dha_loc + rnd(dq) @ w.wq.t()
        acc["wq"] = acc["wq"] + tn(h_a, dq)
        hp_a = hap[t].float()
        dg_a, dac_a, dha = _gru_bwd(dha_loc + dha, ruc[n_layers][t], hp_a, w.a_hg, w.a_hc, H,
                                    rnd)
        acc["a_hg"] = acc["a_hg"] + tn(hp_a, dg_a)
        acc["a_hc"] = acc["a_hc"] + tn(rh_a[t], dac_a)
        dpng[t], dpnc[t] = dg_a, dac_a
        dcbg, dcbc = dg_a, dac_a
    dweights = TeacherDecoderWeights(
        a_hg=acc["a_hg"], a_hc=acc["a_hc"], wq=acc["wq"], v=None, w_ctx=acc["w_ctx"],
        wd_h=acc["wd_h"], d_b=acc["d_b"], w_r=tuple(d_w_r), b_r=tuple(d_b_r),
        hg=tuple(d_hg), hc=tuple(d_hc))
    return (torch.stack(dpng), torch.stack(dpnc), torch.stack(de_out),
            torch.stack(dctx_out), dha, torch.stack(dhds), dweights)


def dkeys_reference(keys, q, de, v):
    """Plain version of ``_dkeys_kernel`` plus the ``dv`` sum of
    ``_bwd_kernel``: keys [B, L, A] (compute dtype), q [S, B, A] f32, de
    [S, B, L] f32, v [A] (compute dtype) → (dkeys [B, L, A], dv [A]) f32:
    dkeys[b,l,a] = Σ_t de[t,b,l]·v[a]·(1 − tanh²(keys[b,l,a] + q[t,b,a])),
    dv[a] = Σ_{t,b,l} de[t,b,l]·tanh(keys[b,l,a] + q[t,b,a])."""
    keys_f = keys.float()
    vf = v.float()
    dk = torch.zeros(keys.shape, dtype=torch.float32, device=keys.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=keys.device)
    for t in range(q.shape[0]):
        act = torch.tanh(keys_f + q[t][:, None, :])
        dk = dk + de[t][:, :, None] * vf * (1.0 - act * act)
        dv = dv + (de[t][:, :, None] * act).sum((0, 1))
    return dk, dv


# --------------------------------------------------------------------------
# wrappers: plain version for CPU tensors, kernel for CUDA tensors
# --------------------------------------------------------------------------

def _check_common(png, pnc, weights, keys, memory, mask, extra=None):
    """Shapes and devices of the scan's arguments (``extra``: more name →
    (tensor, shape)); returns S, B, H, L, A, D, N."""
    if png.dim() != 3 or png.shape[-1] % 2:
        raise ValueError(f"png must be [S, B, 2H], got {tuple(png.shape)}")
    S, B, H2 = png.shape
    H = H2 // 2
    if keys.dim() != 3:
        raise ValueError(f"keys must be [B, L, A], got {tuple(keys.shape)}")
    L, A = keys.shape[1:]
    D = memory.shape[-1]
    N = len(weights.w_r)
    want = {"pnc": (pnc, (S, B, H)), "keys": (keys, (B, L, A)),
            "memory": (memory, (B, L, D)), "mask": (mask, (B, L)),
            "a_hg": (weights.a_hg, (H, 2 * H)), "a_hc": (weights.a_hc, (H, H)),
            "wq": (weights.wq, (H, A)), "w_ctx": (weights.w_ctx, (D, 4 * H)),
            "wd_h": (weights.wd_h, (H, H)), "d_b": (weights.d_b, (H,))}
    if weights.v is not None:
        want["v"] = (weights.v, (A,))
    for i in range(N):
        want.update({f"w_r[{i}]": (weights.w_r[i], (H, 3 * H)),
                     f"b_r[{i}]": (weights.b_r[i], (3 * H,)),
                     f"hg[{i}]": (weights.hg[i], (H, 2 * H)),
                     f"hc[{i}]": (weights.hc[i], (H, H))})
    want.update(extra or {})
    for name, (a, shape) in want.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(a.shape)}")
        if a.device != png.device:
            raise ValueError(f"{name} is on {a.device}, png on {png.device}")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    return S, B, H, L, A, D, N


def _kernel_checks(what, cdt, H, A, D, N, typed, widths=()):
    """Dtype, width, alignment and contiguity limits of the CUDA kernels
    (``widths``: more (name, width) pairs that a matvec takes)."""
    if cdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute dtype must be float32 or bfloat16, got {cdt}")
    vec = 16 // torch.empty((), dtype=cdt).element_size()
    if N > _MAX_LAYERS:
        raise ValueError(f"{what} kernel: {N} layers > {_MAX_LAYERS}")
    for name, n in (("H", H), ("2H", 2 * H), ("3H", 3 * H), ("4H", 4 * H), ("A", A),
                    ("D", D), *widths):
        if n % vec or n > vec * _NTHREADS:
            raise ValueError(f"{what} kernel: width {name}={n} must be a multiple of "
                             f"{vec} and at most {vec * _NTHREADS}")
    for name, t, want in typed:
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype} "
                            "(TeacherDecoderWeights.cast gives the kernel's dtypes)")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _weights_typed(weights, cdt):
    typed = []
    for name, val in weights._asdict().items():
        if val is None:
            continue
        want = torch.float32 if name in _F32_FIELDS else cdt
        vals = val if isinstance(val, tuple) else (val,)
        typed += [(name, t, want) for t in vals]
    return typed


def _smem_check(lib_fn, what, dims):
    smem = lib_fn(dims)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{what} kernel: needs {smem} bytes of shared memory "
                         f"(> {_SMEM_LIMIT})")


def _launch(name, fn, flat, dims):
    """One launch through ``fn`` of the library ``name`` on the current
    stream; raises on its CUDA error."""
    ptrs = (ctypes.c_void_p * len(flat))(*[t.data_ptr() for t in flat])
    with torch.cuda.device(flat[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ctypes.cast(ptrs, ctypes.c_void_p), dims, stream)
    cuda_build.check(err, f"{name} kernel launch")


def _dims(S, B, L, A, D, H, N, cdt):
    dims = (ctypes.c_int * 8)(S, B, L, A, D, H, N, int(cdt == torch.bfloat16))
    return dims, ctypes.cast(dims, ctypes.c_void_p)


def teacher_decoder_fwd(png, pnc, h0a, h0d, weights: TeacherDecoderWeights, keys,
                        memory, mask):
    """Fused teacher-forced forward → (xs, align, ha, hds) (see
    :func:`teacher_decoder_fwd_reference`)."""
    B, H, N = png.shape[1], png.shape[2] // 2, len(weights.w_r)
    _check_common(png, pnc, weights, keys, memory, mask, extra={
        "h0a": (h0a, (B, H)), "h0d": (h0d, (N, B, H))})
    if png.device.type == "cpu":
        return teacher_decoder_fwd_reference(png, pnc, h0a, h0d, weights, keys, memory, mask)
    if png.device.type != "cuda":
        raise ValueError(f"teacher_decoder_fwd runs on cpu or cuda, not {png.device}")
    return _teacher_fwd_cuda(png, pnc, h0a, h0d, weights, keys, memory, mask)


def fwd_smem_bytes(L, A, D, H, N, C, vec) -> int:
    """Shared memory one CTA of the forward kernel takes (csrc/
    teacher_decoder_fwd.cu ``smem_floats``: the job and plan tables, the
    png/pnc staging, the biases and the vectors)."""
    stage = 3 * H * (16 // vec) // 4
    floats = (stage + _CTHREADS * (vec + 32) + 64 + 15 * H + 4 * N * H + 2 * A + D
              + max(H, D) + (C + 2) * L)
    return 4 * floats + _FWD_HEAD_BYTES


def fwd_check_limits(*, L, A, D, H, N, vec) -> None:
    """Raise ValueError where the forward kernel cannot take these widths
    (the limits of csrc/teacher_decoder_fwd.cu's source note, at C = 1,
    which every batch can fall back to; a larger C only narrows each CTA's
    share, and :func:`fwd_cluster_counts` gives 0 for a C whose shared
    memory does not fit)."""
    if N > _MAX_LAYERS:
        raise ValueError(f"teacher_decoder_fwd kernel: {N} layers > {_MAX_LAYERS}")
    top = vec * _CTHREADS
    for name, n in (("H", H), ("A", A), ("D", D)):
        if n % vec:
            raise ValueError(f"teacher_decoder_fwd kernel: width {name}={n} must be a "
                             f"multiple of {vec}")
    for name, n in (("4H", 4 * H), ("A+H", A + H), ("D", D)):
        if n > top:
            raise ValueError(f"teacher_decoder_fwd kernel: {name}={n} (one phase's "
                             f"columns) must be at most {top}")
    smem = fwd_smem_bytes(L, A, D, H, N, 1, vec)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"teacher_decoder_fwd kernel: L={L} needs {smem} bytes of "
                         f"shared memory (> {_SMEM_LIMIT})")


def fwd_cluster_counts(dims: tuple, is_bf16: int, device) -> dict:
    """{C: clusters of C CTAs the card can hold at once} for the forward
    kernel at ``dims`` (S, B, L, A, D, H, N) on ``device``
    (cudaOccupancyMaxActiveClusters; 0 where a CTA's shared memory would not
    fit).  Cached by widths, dtype and device."""
    _, _, L, A, D, H, N = dims
    key = (tuple(dims[2:]), is_bf16, device)
    if key not in _fwd_cluster_counts:
        lib, counts = _lib("teacher_decoder_fwd"), {}
        for C in CLUSTER_SIZES:
            if fwd_smem_bytes(L, A, D, H, N, C, 8 if is_bf16 else 4) > _SMEM_LIMIT:
                counts[C] = 0
                continue
            d = (ctypes.c_int * 9)(*dims, is_bf16, C)
            n = ctypes.c_int(0)
            with torch.cuda.device(device):
                err = lib.teacher_decoder_fwd_max_clusters(ctypes.cast(d, ctypes.c_void_p),
                                                           ctypes.byref(n))
            cuda_build.check(err, f"teacher_decoder_fwd cluster occupancy query (C={C})")
            counts[C] = n.value
        _fwd_cluster_counts[key] = counts
    return _fwd_cluster_counts[key]


def _teacher_fwd_cuda(png, pnc, h0a, h0d, weights, keys, memory, mask,
                      cluster: int | None = None):
    """The forward kernel's launch (shapes already checked).  ``cluster``
    forces the cluster size (kernel checks only; the train path leaves it to
    :func:`launch_plan` over :func:`fwd_cluster_counts`)."""
    S, B, H2 = png.shape
    H, N = H2 // 2, len(weights.w_r)
    L, A, D = keys.shape[1], keys.shape[2], memory.shape[-1]
    cdt = keys.dtype
    typed = [("png", png, cdt), ("pnc", pnc, cdt), ("keys", keys, cdt),
             ("memory", memory, cdt), ("mask", mask, torch.bool),
             ("h0a", h0a, torch.float32), ("h0d", h0d, torch.float32)]
    _kernel_checks("teacher_decoder_fwd", cdt, H, A, D, N,
                   typed + _weights_typed(weights, cdt))
    vec = 16 // keys.element_size()
    fwd_check_limits(L=L, A=A, D=D, H=H, N=N, vec=vec)
    f32 = dict(dtype=torch.float32, device=png.device)
    xs = torch.empty((S, B, H), **f32)
    align = torch.empty((S, B, L), **f32)
    ha = torch.empty((S, B, H), **f32)
    hds = torch.empty((N, S, B, H), **f32)
    if S == 0 or B == 0:
        return xs, align, ha, tuple(hds)
    w = weights
    flat = [png, pnc, keys, memory, mask, h0a, h0d, w.a_hg, w.a_hc, w.wq, w.v, w.w_ctx,
            w.wd_h, w.d_b, xs, align, ha]
    for i in range(N):
        # w_r's gate and candidate columns as their own matrices: a phase's
        # products read their weights at one row stride
        flat += [w.w_r[i][:, :2 * H].contiguous(), w.w_r[i][:, 2 * H:].contiguous(),
                 w.b_r[i], w.hg[i], w.hc[i], hds[i]]
    is_bf16 = int(cdt == torch.bfloat16)
    dims = (S, B, L, A, D, H, N)
    counts = fwd_cluster_counts(dims, is_bf16, png.device)
    C = launch_plan(B, H, vec, counts) if cluster is None else cluster
    if C not in CLUSTER_SIZES or counts[C] == 0:
        raise ValueError(f"teacher_decoder_fwd kernel: the card holds no cluster of {C} "
                         f"CTAs at these widths (co-resident clusters {counts})")
    cdims = (ctypes.c_int * 9)(*dims, is_bf16, C)
    _launch("teacher_decoder_fwd", _lib("teacher_decoder_fwd").teacher_decoder_fwd_launch,
            flat, ctypes.cast(cdims, ctypes.c_void_p))
    global fwd_launches, fwd_last_plan
    fwd_launches += 1
    fwd_last_plan = (C, counts[C])
    return xs, align, ha, tuple(hds)


def _check_bwd(png, pnc, ha, hap, hds, hdps, xs, p, pp, dxs, dalign, weights, keys, memory,
               mask):
    """Shapes and devices of the backward's arguments, and the kernels'
    limits for CUDA tensors; returns S, B, H, L, A, D, N."""
    S, B, H = ha.shape
    N, L = len(weights.w_r), keys.shape[1]
    if len(hds) != N or len(hdps) != N:
        raise ValueError(f"hds and hdps need {N} layers, got {len(hds)} and {len(hdps)}")
    streams = {"ha": (ha, (S, B, H)), "hap": (hap, (S, B, H)), "xs": (xs, (S, B, H)),
               "p": (p, (S, B, L)), "pp": (pp, (S, B, L)), "dxs": (dxs, (S, B, H)),
               "dalign": (dalign, (S, B, L))}
    streams.update({f"hds[{i}]": (hds[i], (S, B, H)) for i in range(N)})
    streams.update({f"hdps[{i}]": (hdps[i], (S, B, H)) for i in range(N)})
    S, B, H, L, A, D, N = _check_common(png, pnc, weights, keys, memory, mask, streams)
    if png.device.type == "cuda":
        cdt = keys.dtype
        typed = [("png", png, cdt), ("pnc", pnc, cdt), ("keys", keys, cdt),
                 ("memory", memory, cdt), ("mask", mask, torch.bool)]
        typed += [(name, t, torch.float32) for name, (t, _) in streams.items()]
        _kernel_checks("teacher_decoder_bwd", cdt, H, A, D, N,
                       typed + _weights_typed(weights, cdt), widths=(("H+D", H + D),))
        if S == 0 or B == 0:
            raise ValueError("teacher_decoder_bwd kernel: S and B must be positive")
    elif png.device.type != "cpu":
        raise ValueError(f"teacher_decoder_bwd runs on cpu or cuda, not {png.device}")
    return S, B, H, L, A, D, N


def teacher_bwd_remat(png, pnc, ha, hap, hds, hdps, xs, p, pp, dxs, dalign,
                      weights: TeacherDecoderWeights, keys, memory, mask):
    """The backward's carry-free prologue alone → (xin, rh, ruc, rh_a, ctx,
    q) (see :func:`teacher_bwd_remat_reference`; the arguments of
    :func:`teacher_decoder_bwd`)."""
    args = (png, pnc, ha, hap, hds, hdps, xs, p, pp, dxs, dalign, weights, keys, memory, mask)
    _check_bwd(*args)
    if png.device.type == "cpu":
        return teacher_bwd_remat_reference(*args)
    return _remat_kernel(*args)


def teacher_decoder_bwd(png, pnc, ha, hap, hds, hdps, xs, p, pp, dxs, dalign,
                        weights: TeacherDecoderWeights, keys, memory, mask):
    """Reverse-time backward → (dpng, dpnc, de, dctx, dh0a, dh0d, dweights)
    (see :func:`teacher_decoder_bwd_reference`; ``dweights.v`` is None)."""
    args = (png, pnc, ha, hap, hds, hdps, xs, p, pp, dxs, dalign, weights, keys, memory, mask)
    _check_bwd(*args)
    if png.device.type == "cpu":
        return teacher_decoder_bwd_reference(*args)
    outs, streams = _bwd_kernel(*args)
    dweights = _reduce_weight_grads(ha, hap, hdps, outs, streams, keys.dtype)
    return (*outs, dweights)


def _weight_grad_problems(ha, hap, hdps, outs, streams):
    """The wgrad problems (a, g, with_bias) of every weight gradient, in the
    order a_hg, a_hc, wq, w_ctx, wd_h (+ d_b), then per layer w_r (+ b_r),
    hg, hc."""
    dpng, dpnc = outs[0], outs[1]
    rh_a, dcb, ctx, dq, xin, rh, dgc = streams
    H = ha.shape[-1]
    problems = [(hap, dpng, False), (rh_a, dpnc, False), (ha, dq, False),
                (ctx, dcb, False), (ha, dcb[..., :H], True)]
    for i in range(len(hdps)):
        problems += [(xin[i], dgc[i], True), (hdps[i], dgc[i][..., :2 * H], False),
                     (rh[i], dgc[i][..., 2 * H:], False)]
    return problems


def _reduce_weight_grads(ha, hap, hdps, outs, streams, cdt):
    """Every weight gradient of the backward in one grouped wgrad launch."""
    N = len(hdps)
    g = wgrad.wgrad(_weight_grad_problems(ha, hap, hdps, outs, streams), cdt)
    return TeacherDecoderWeights(
        a_hg=g[0][0], a_hc=g[1][0], wq=g[2][0], v=None, w_ctx=g[3][0], wd_h=g[4][0],
        d_b=g[4][1], w_r=tuple(g[5 + 3 * i][0] for i in range(N)),
        b_r=tuple(g[5 + 3 * i][1] for i in range(N)),
        hg=tuple(g[6 + 3 * i][0] for i in range(N)),
        hc=tuple(g[7 + 3 * i][0] for i in range(N)))


def _remat_kernel(png, pnc, ha, hap, hds, hdps, xs, p, pp, dxs, dalign, weights, keys,
                  memory, mask):
    """The prologue launch of csrc/teacher_decoder_bwd.cu (arguments already
    checked) → (xin, rh, ruc, rh_a, ctx, q) as
    :func:`teacher_bwd_remat_reference` returns them (stacked over layers)."""
    S, B, H = ha.shape
    L, A, D, N = keys.shape[1], keys.shape[2], memory.shape[-1], len(weights.w_r)
    w = weights
    f32 = dict(dtype=torch.float32, device=png.device)
    xin = torch.empty((N, S, B, H), **f32)
    rh = torch.empty((N, S, B, H), **f32)
    ruc = torch.empty((N + 1, S, B, 3 * H), **f32)
    rh_a = torch.empty((S, B, H), **f32)
    ctx = torch.empty((S, B, D), **f32)
    ctxp = torch.empty((S, B, D), **f32)       # ctx_prev, the prologue's scratch
    q = torch.empty((S, B, A), **f32)
    flat = [png, pnc, ha, hap, xs, p, pp, memory, w.a_hg, w.a_hc, w.wq, w.w_ctx,
            rh_a, ctx, ctxp, q, ruc[N]]
    for i in range(N):
        flat += [hds[i], hdps[i], w.w_r[i], w.b_r[i], w.hg[i], w.hc[i], xin[i], rh[i], ruc[i]]
    lib = _lib("teacher_decoder_bwd")
    dims, dims_p = _dims(S, B, L, A, D, H, N, keys.dtype)
    _smem_check(lib.teacher_decoder_bwd_remat_smem_bytes, "teacher_decoder_bwd remat", dims_p)
    _launch("teacher_decoder_bwd remat", lib.teacher_decoder_bwd_remat_launch, flat, dims_p)
    global bwd_remat_launches
    bwd_remat_launches += 1
    return xin, rh, ruc, rh_a, ctx, q


def _scan_weights(w, H):
    """The scan's transposed and concatenated weight copies: per layer hc^T
    and [w_r^T | (hg^T; 0)], then [wd_h^T | w_ctx^T[0:H]], wq^T, a_hc^T and
    [(a_hg^T; 0) | w_ctx^T[H:4H]]."""
    zero = torch.zeros((H, H), dtype=w.hc[0].dtype, device=w.hc[0].device)
    cat = lambda *ts, dim: torch.cat(ts, dim=dim).contiguous()
    w_ctx_t = w.w_ctx.t()
    layers = [(w.hc[i].t().contiguous(), cat(w.w_r[i].t(), cat(w.hg[i].t(), zero, dim=0),
                                             dim=1)) for i in range(len(w.w_r))]
    return (layers, cat(w.wd_h.t(), w_ctx_t[:H], dim=1), w.wq.t().contiguous(),
            w.a_hc.t().contiguous(), cat(cat(w.a_hg.t(), zero, dim=0), w_ctx_t[H:], dim=1))


def _bwd_kernel(png, pnc, ha, hap, hds, hdps, xs, p, pp, dxs, dalign, weights, keys,
                memory, mask):
    """The two launches of csrc/teacher_decoder_bwd.cu, prologue then scan
    (arguments already checked) → ((dpng, dpnc, de, dctx, dh0a, dh0d),
    (rh_a, dcb, ctx, dq, xin, rh, dgc)): the outputs and the per-step
    factors of the weight gradients."""
    args = (png, pnc, ha, hap, hds, hdps, xs, p, pp, dxs, dalign, weights, keys, memory, mask)
    xin, rh, ruc, rh_a, ctx, q = _remat_kernel(*args)
    S, B, H = ha.shape
    L, A, D, N = keys.shape[1], keys.shape[2], memory.shape[-1], len(weights.w_r)
    f32 = dict(dtype=torch.float32, device=png.device)
    dpng = torch.empty((S, B, 2 * H), **f32)
    dpnc = torch.empty((S, B, H), **f32)
    de = torch.empty((S, B, L), **f32)
    dctx = torch.empty((S, B, D), **f32)
    dh0a = torch.empty((B, H), **f32)
    dh0d = torch.empty((N, B, H), **f32)
    # per-step factors of the weight gradients (_reduce_weight_grads)
    dcb = torch.empty((S, B, 4 * H), **f32)
    dq = torch.empty((S, B, A), **f32)
    dgc = torch.empty((N, S, B, 3 * H), **f32)
    layers, w1, wq_t, a_hc_t, w2 = _scan_weights(weights, H)
    flat = [dxs, dalign, p, hap, q, keys, memory, weights.v, w1, wq_t, a_hc_t, w2, ruc[N],
            dpng, dpnc, de, dctx, dh0a, dh0d, dcb, dq]
    for i in range(N):
        flat += [ruc[i], hdps[i], layers[i][0], layers[i][1], dgc[i]]
    lib = _lib("teacher_decoder_bwd")
    dims, dims_p = _dims(S, B, L, A, D, H, N, keys.dtype)
    _smem_check(lib.teacher_decoder_bwd_smem_bytes, "teacher_decoder_bwd", dims_p)
    _launch("teacher_decoder_bwd", lib.teacher_decoder_bwd_launch, flat, dims_p)
    global bwd_launches
    bwd_launches += 1
    return (dpng, dpnc, de, dctx, dh0a, dh0d), (rh_a, dcb, ctx, dq, xin, rh, dgc)


def dkeys(keys, q, de, v):
    """dkeys and dv (see :func:`dkeys_reference`)."""
    B, L, A = keys.shape
    S = q.shape[0]
    for name, a, shape in (("q", q, (S, B, A)), ("de", de, (S, B, L)), ("v", v, (A,))):
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(a.shape)}")
        if a.device != keys.device:
            raise ValueError(f"{name} is on {a.device}, keys on {keys.device}")
    if keys.device.type == "cpu":
        return dkeys_reference(keys, q, de, v)
    if keys.device.type != "cuda":
        raise ValueError(f"dkeys runs on cpu or cuda, not {keys.device}")
    cdt = keys.dtype
    if cdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute dtype must be float32 or bfloat16, got {cdt}")
    for name, t, want in (("keys", keys, cdt), ("v", v, cdt), ("q", q, torch.float32),
                          ("de", de, torch.float32)):
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = _lib("dkeys")
    if A > 1024:
        raise ValueError(f"dkeys kernel: A = {A} > 1024 threads (one per column)")
    if B > 65535:
        raise ValueError(f"dkeys kernel: B = {B} > 65535")
    n_lb = lib.dkeys_l_blocks(L)
    dk = torch.empty((B, L, A), dtype=torch.float32, device=keys.device)
    dv = torch.zeros((A,), dtype=torch.float32, device=keys.device)
    part = torch.empty((B * n_lb, A), dtype=torch.float32, device=keys.device)
    if B == 0 or L == 0:
        dk.zero_()
        return dk, dv
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dkeys_launch(keys.data_ptr(), q.data_ptr(), de.data_ptr(), v.data_ptr(),
                               dk.data_ptr(), dv.data_ptr(), part.data_ptr(),
                               S, B, L, A, int(cdt == torch.bfloat16), stream)
    cuda_build.check(err, "dkeys kernel launch")
    global dkeys_launches
    dkeys_launches += 1
    return dk, dv


# --------------------------------------------------------------------------
# the differentiable scan
# --------------------------------------------------------------------------

def teacher_decoder_backward(png, pnc, h0a, h0d, weights, keys, memory, mask,
                             xs, align, ha, hds, dxs, dalign):
    """The whole backward of the scan (the JAX package's
    ``_teacher_decoder_bwd_pallas`` after its shifts) → (dpng, dpnc, dh0a,
    dh0d, dweights, dkeys, dmemory, de, dctx), all f32."""
    shift = lambda a, a0: torch.cat([a0[None].to(a.dtype), a[:-1]], dim=0)
    hap = shift(ha, h0a)
    hdps = tuple(shift(hds[i], h0d[i]) for i in range(len(hds)))
    pp = torch.cat([torch.zeros_like(align[:1]), align[:-1]], dim=0)
    dpng, dpnc, de, dctx, dh0a, dh0d, dw = teacher_decoder_bwd(
        png, pnc, ha, hap, hds, hdps, xs, align, pp, dxs.float().contiguous(),
        dalign.float().contiguous(), weights, keys, memory, mask)
    # dmemory = Σ_t p_t ⊗ dctx_t and q = ha·wq: plain products, as the JAX
    # package leaves them to XLA outside its kernels
    dmem = torch.bmm(align.permute(1, 2, 0), dctx.transpose(0, 1))     # [B, L, D]
    q = ha.to(keys.dtype).float() @ weights.wq.to(keys.dtype).float()  # [S, B, A]
    dk, dv = dkeys(keys, q.contiguous(), de, weights.v.to(keys.dtype))
    return dpng, dpnc, dh0a, dh0d, dw._replace(v=dv), dk, dmem, de, dctx


class TeacherDecoder(torch.autograd.Function):
    """Differentiable fused teacher-forced decoder scan (the JAX package's
    ``teacher_decoder`` custom VJP).  Arguments: n_layers, png, pnc, h0a,
    h0d, keys, memory, mask, then the flat weights
    (:meth:`TeacherDecoderWeights.flat`).  Gradients come back in the dtype
    of their inputs; the mask gets none."""

    @staticmethod
    def forward(ctx, n_layers, png, pnc, h0a, h0d, keys, memory, mask, *flat):
        w = TeacherDecoderWeights.unflat(flat, n_layers)
        xs, align, ha, hds = teacher_decoder_fwd(png, pnc, h0a, h0d, w, keys, memory, mask)
        ctx.n_layers = n_layers
        ctx.save_for_backward(png, pnc, h0a, h0d, keys, memory, mask, xs, align, ha,
                              *hds, *flat)
        return xs, align

    @staticmethod
    def backward(ctx, dxs, dalign):
        n = ctx.n_layers
        saved = ctx.saved_tensors
        png, pnc, h0a, h0d, keys, memory, mask, xs, align, ha = saved[:10]
        hds = saved[10:10 + n]
        flat = saved[10 + n:]
        w = TeacherDecoderWeights.unflat(flat, n)
        if dxs is None:
            dxs = torch.zeros_like(xs)
        if dalign is None:
            dalign = torch.zeros_like(align)
        dpng, dpnc, dh0a, dh0d, dw, dk, dmem, _, _ = teacher_decoder_backward(
            png, pnc, h0a, h0d, w, keys, memory, mask, xs, align, ha, hds, dxs, dalign)
        cast = lambda g, x: g.to(x.dtype)
        dflat = [cast(g, x) for g, x in zip(dw.flat(), flat)]
        return (None, cast(dpng, png), cast(dpnc, pnc), cast(dh0a, h0a), cast(dh0d, h0d),
                cast(dk, keys), cast(dmem, memory), None, *dflat)


def teacher_decoder(png, pnc, h0a, h0d, weights: TeacherDecoderWeights, keys, memory, mask):
    """Differentiable fused teacher-forced scan → (xs [S, B, H], align
    [S, B, L]), both f32."""
    return TeacherDecoder.apply(len(weights.w_r), png, pnc, h0a, h0d, keys, memory, mask,
                                *weights.flat())


def _lib(name: str) -> ctypes.CDLL:
    lib = cuda_build.library(name)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        if name == "dkeys":
            lib.dkeys_launch.argtypes = [p] * 7 + [i] * 5 + [p]
            lib.dkeys_launch.restype = i
            lib.dkeys_l_blocks.argtypes = [i]
            lib.dkeys_l_blocks.restype = i
        else:
            if name == "teacher_decoder_fwd":
                lib.teacher_decoder_fwd_max_clusters.argtypes = [p, p]
                lib.teacher_decoder_fwd_max_clusters.restype = i
            stems = [name] + ([f"{name}_remat"] if name == "teacher_decoder_bwd" else [])
            for stem in stems:
                launch = getattr(lib, f"{stem}_launch")
                launch.argtypes = [p, p, p]
                launch.restype = i
                smem = getattr(lib, f"{stem}_smem_bytes")
                smem.argtypes = [p]
                smem.restype = ctypes.c_size_t
        lib._typed = True
    return lib
