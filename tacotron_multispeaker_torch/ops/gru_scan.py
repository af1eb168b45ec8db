"""GRU scans, fused over directions: CUDA kernels and their plain PyTorch versions.

Port of ``tacotron_multispeaker_tpu/ops/gru_scan.py``:

* two directions: ``bigru_scan_pallas`` (the forward, ``csrc/bigru_scan.cu``:
  bf16 on the tensor cores with the weights resident in registers, f32 and
  wider bf16 on the first design's FMA kernel, the route chosen by
  :func:`fwd_route` before the launch) and ``_bigru_scan_bwd_pallas`` (the
  backward, ``csrc/bigru_scan_bwd.cu``:
  a carry-free prologue over all T·B rows, :func:`bwd_remat`, plain
  :func:`bigru_bwd_remat_reference`, then the gradient-only reverse scan,
  plain :func:`bigru_bwd_scan_reference`; the weight gradients reduced by
  ``csrc/wgrad.cu``), joined by
  :class:`BiGRUScan`, the ``torch.autograd.Function`` that mirrors the JAX
  package's ``bigru_scan`` custom VJP: the forward saves ``ys`` in the
  compute dtype and the backward rebuilds ``hprev`` from it;
* one direction: ``gru_scan_pallas`` and ``_gru_scan_bwd_pallas`` (the same
  two kernels through their one-direction launchers, time-major [T, B, .]
  with no direction dim), joined by :class:`GRUScan` (``gru_scan``'s custom
  VJP); ``models.modules.GRU`` with ``use_pallas`` calls it.

Contract, identical to the Pallas kernel's: xg [T, 2, B, 2F], xc [T, 2, B, F]
(direction 1's input projections already time-reversed by the caller), whg
[2, F, 2F], whc [2, F, F], all in the compute dtype (bf16 or f32), and h0
[2, B, F] f32 → ys [T, 2, B, F] in the dtype of xg (one direction: the
same without the direction dims).  The cell is the
legacy-TF GRU: the reset gate multiplies h BEFORE the candidate matmul.
Matmul inputs are rounded to the compute dtype, sums and the carry are f32.

:func:`bigru_scan`, :func:`bigru_scan_bwd`, :func:`gru_scan` and
:func:`gru_scan_bwd` run their plain versions for CPU tensors and their CUDA
kernels for CUDA tensors; anything else raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build, wgrad

# launches of the CUDA kernels (the plain versions do not count)
launches = 0                # two-direction forward on the tensor cores, csrc/bigru_scan.cu
fma_launches = 0            # two-direction forward on the FMA route, csrc/bigru_scan.cu
bwd_launches = 0            # two-direction backward's scan, csrc/bigru_scan_bwd.cu
bwd_remat_launches = 0      # two-direction backward's prologue before it
gru_launches = 0            # one-direction forward on the tensor cores, csrc/bigru_scan.cu
gru_fma_launches = 0        # one-direction forward on the FMA route, csrc/bigru_scan.cu
gru_bwd_launches = 0        # one-direction backward's scan, csrc/bigru_scan_bwd.cu
gru_bwd_remat_launches = 0  # one-direction backward's prologue before it

_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90


def bigru_scan_reference(xg: torch.Tensor, xc: torch.Tensor, whg: torch.Tensor,
                         whc: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch scan with the kernel's math (both directions batched)."""
    F = xc.shape[-1]
    cdt = whg.dtype
    wg, wc = whg.float(), whc.float()
    h = h0.float()
    ys = []
    for t in range(xg.shape[0]):
        g = torch.sigmoid(xg[t].float() + torch.bmm(h.to(cdt).float(), wg))
        r, u = g[..., :F], g[..., F:]
        c = torch.tanh(xc[t].float() + torch.bmm((r * h).to(cdt).float(), wc))
        h = u * h + (1.0 - u) * c
        ys.append(h.to(xg.dtype))
    return torch.stack(ys)


def bigru_scan_bwd_reference(xg, xc, hprev, dys, whg, whc):
    """Plain reverse-time backward with the math of the Pallas
    ``_bi_bwd_kernel``: gates rematerialised from ``hprev`` [T, 2, B, F]
    (the forward's states shifted by one, in the compute dtype), dot_nt /
    dot_tn products on inputs rounded to the compute dtype, f32 sums.
    Returns f32 (dxg, dxc, dwhg, dwhc, dh0)."""
    F = xc.shape[-1]
    cdt = whg.dtype
    rnd = lambda x: x.to(cdt).float()
    wg, wc = whg.float(), whc.float()
    wgT, wcT = wg.transpose(1, 2), wc.transpose(1, 2)
    dh = torch.zeros(hprev.shape[1:], dtype=torch.float32, device=xg.device)
    dwhg, dwhc = torch.zeros_like(wg), torch.zeros_like(wc)
    dxg, dxc = [], []
    for t in range(xg.shape[0] - 1, -1, -1):
        hp = hprev[t].float()
        g = torch.sigmoid(xg[t].float() + torch.bmm(rnd(hp), wg))
        r, u = g[..., :F], g[..., F:]
        rh = r * hp
        c = torch.tanh(xc[t].float() + torch.bmm(rnd(rh), wc))
        dht = dh + dys[t].float()
        dc = dht * (1.0 - u)
        du = dht * (hp - c)
        dac = dc * (1.0 - c * c)
        drh = torch.bmm(rnd(dac), wcT)
        dr = drh * hp
        dg = torch.cat([dr * r * (1.0 - r), du * u * (1.0 - u)], dim=-1)
        dh = dht * u + drh * r + torch.bmm(rnd(dg), wgT)
        dxg.append(dg)
        dxc.append(dac)
        dwhg = dwhg + torch.bmm(rnd(hp).transpose(1, 2), rnd(dg))
        dwhc = dwhc + torch.bmm(rnd(rh).transpose(1, 2), rnd(dac))
    return (torch.stack(dxg[::-1]), torch.stack(dxc[::-1]), dwhg, dwhc, dh)


def gru_scan_reference(xg: torch.Tensor, xc: torch.Tensor, whg: torch.Tensor,
                       whc: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """Plain one-direction scan (the JAX ``gru_scan_reference``): xg [T, B,
    2F], xc [T, B, F], whg [F, 2F], whc [F, F], h0 [B, F] → ys [T, B, F]."""
    return bigru_scan_reference(xg[:, None], xc[:, None], whg[None], whc[None],
                                h0[None])[:, 0]


def gru_scan_bwd_reference(xg, xc, hprev, dys, whg, whc):
    """Plain one-direction backward (the math of the Pallas ``_bwd_kernel``,
    as :func:`bigru_scan_bwd_reference`); [T, B, .] streams, [F, .] weights
    → f32 (dxg, dxc, dwhg, dwhc, dh0)."""
    out = bigru_scan_bwd_reference(xg[:, None], xc[:, None], hprev[:, None], dys[:, None],
                                   whg[None], whc[None])
    return tuple(a[:, 0] if a.dim() == 4 else a[0] for a in out)


def bigru_bwd_remat_reference(xg, xc, hprev, whg, whc):
    """Plain carry-free prologue of the backward, batched over all T·B rows
    (the gates the Pallas ``_bi_bwd_kernel`` rematerialises inside its
    scan; none of them depends on the reverse-time carry): streams [T, D, B,
    .] and weights [D, F, .] with D = 2 or 1 directions → (ruc [T, D, B, 3F]
    f32 = [r | u | c], rh [T, D, B, F] = r·hprev in the compute dtype)."""
    F = xc.shape[-1]
    cdt = whg.dtype
    hp = hprev.float()
    g = torch.sigmoid(xg.float() + hp.to(cdt).float() @ whg.float())
    rh = g[..., :F] * hp
    c = torch.tanh(xc.float() + rh.to(cdt).float() @ whc.float())
    return torch.cat([g, c], dim=-1), rh.to(cdt)


def bigru_bwd_scan_reference(ruc, hprev, dys, whg, whc):
    """Plain gradient-only reverse scan from the prologue's ``ruc`` (the
    rest of :func:`bigru_scan_bwd_reference`'s step, in its order, with
    ``round(dg) @ whg^T`` split into its dgu and dgr halves): streams [T, D,
    B, .], weights [D, F, .] → f32 (dxg, dxc, dh0)."""
    F = hprev.shape[-1]
    rnd = lambda x: x.to(whg.dtype).float()
    wcT, wgT = whc.float().transpose(1, 2), whg.float().transpose(1, 2)
    dh = torch.zeros(hprev.shape[1:], dtype=torch.float32, device=hprev.device)
    dxg, dxc = [], []
    for t in range(hprev.shape[0] - 1, -1, -1):
        r, u, c = ruc[t, ..., :F], ruc[t, ..., F:2 * F], ruc[t, ..., 2 * F:]
        hp = hprev[t].float()
        dht = dh + dys[t].float()
        dc = dht * (1.0 - u)
        du = dht * (hp - c)
        dac = dc * (1.0 - c * c)
        dgu = du * u * (1.0 - u)
        drh = torch.bmm(rnd(dac), wcT)
        s_u = torch.bmm(rnd(dgu), wgT[:, F:])
        dr = drh * hp
        dgr = dr * r * (1.0 - r)
        dh = dht * u + drh * r + s_u + torch.bmm(rnd(dgr), wgT[:, :F])
        dxg.append(torch.cat([dgr, dgu], dim=-1))
        dxc.append(dac)
    return torch.stack(dxg[::-1]), torch.stack(dxc[::-1]), dh


def _check(xg, xc, whg, whc, h0=None, *, dirs=2, **streams):
    """Shapes, devices and dtypes of the forward's arguments (h0 f32) and of
    the backward's ``streams`` (like ys, compute dtype), with ``dirs``
    directions (1: no direction dims); returns T, B, F."""
    d = (dirs,) if dirs == 2 else ()
    if xg.dim() != 3 + len(d) or tuple(xg.shape[1:1 + len(d)]) != d or xg.shape[-1] % 2:
        want = "[T, 2, B, 2F]" if d else "[T, B, 2F]"
        raise ValueError(f"xg must be {want}, got {tuple(xg.shape)}")
    T, B, F = xg.shape[0], xg.shape[-2], xg.shape[-1] // 2
    shapes = {"xc": (xc, (T, *d, B, F)), "whg": (whg, (*d, F, 2 * F)),
              "whc": (whc, (*d, F, F))}
    shapes.update({name: (a, (T, *d, B, F)) for name, a in streams.items()})
    if h0 is not None:
        shapes["h0"] = (h0, (*d, B, F))
    for name, (a, want) in shapes.items():
        if tuple(a.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(a.shape)}")
        if a.device != xg.device:
            raise ValueError(f"{name} is on {a.device}, xg on {xg.device}")
    if xg.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute dtype must be float32 or bfloat16, got {xg.dtype}")
    for name, a in (("xc", xc), ("whg", whg), ("whc", whc), *streams.items()):
        if a.dtype != xg.dtype:
            raise TypeError(f"{name} is {a.dtype}, xg is {xg.dtype}")
    if h0 is not None and h0.dtype != torch.float32:
        raise TypeError(f"h0 must be float32, got {h0.dtype}")
    return T, B, F


def bigru_scan(xg: torch.Tensor, xc: torch.Tensor, whg: torch.Tensor,
               whc: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """Both BiGRU directions in one scan (see the module docstring)."""
    _check(xg, xc, whg, whc, h0)
    if xg.device.type == "cpu":
        return bigru_scan_reference(xg, xc, whg, whc, h0)
    return _fwd_kernel(xg, xc, whg, whc, h0)


def gru_scan(xg: torch.Tensor, xc: torch.Tensor, whg: torch.Tensor,
             whc: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """One direction: xg [T, B, 2F], xc [T, B, F], whg [F, 2F], whc [F, F]
    in the compute dtype, h0 [B, F] f32 → ys [T, B, F] (``gru_scan_pallas``)."""
    _check(xg, xc, whg, whc, h0, dirs=1)
    if xg.device.type == "cpu":
        return gru_scan_reference(xg, xc, whg, whc, h0)
    return _fwd_kernel(xg, xc, whg, whc, h0)


# the forward's routes (csrc/bigru_scan.cu), by the launcher's route code
ROUTES = ("fma", "mma")
_MMA_MAX_F = 128        # 8 k-steps of 16: 12 * ceil(F/16) weight registers a lane
_MMA_ROWS = 4           # batch rows a tensor-core block (every other column of the product's N)


def fwd_route(F: int, dtype: torch.dtype) -> str:
    """The forward's route for width F in the compute dtype, decided here
    alone (csrc/bigru_scan.cu's launcher only refuses a route outside its
    limits): ``"mma"`` (the tensor cores, weights resident in registers) for
    bf16 with F a multiple of 8 up to 128, else ``"fma"`` (the first
    design's kernel: f32, whose product on the tensor cores would be TF32,
    and wider bf16)."""
    ok = dtype == torch.bfloat16 and 0 < F <= _MMA_MAX_F and F % 8 == 0
    return "mma" if ok else "fma"


def fwd_smem_bytes(F: int, esize: int, route: str) -> int:
    """Shared memory of a forward block on ``route`` (``bigru_scan_smem_bytes``):
    mma: round(h) and round(r*h) in the product's 8 columns, [8][16 ceil(F/16)
    + 8] bf16 each, and three step slots of the block's rows of xg and xc, 8
    elements of padding a row; fma: the weights and four vectors of F
    floats."""
    if route == "mma":
        return (2 * 8 * (16 * -(-F // 16) + 8) + 3 * _MMA_ROWS * (3 * F + 16)) * 2
    return -(-3 * F * F * esize // 16) * 16 + 4 * F * 4


def fwd_check_limits(*, B: int, F: int, esize: int, route: str, name: str = "bigru_scan"):
    """Raise ValueError where the forward's kernel on ``route`` does not take
    these dims (the limits of csrc/bigru_scan.cu's note)."""
    if route == "mma":
        if esize != 2 or F % 8 or not 0 < F <= _MMA_MAX_F:
            raise ValueError(f"{name} tensor-core route: bf16 with F a multiple of 8 up to "
                             f"{_MMA_MAX_F}, got F={F} with {esize}-byte elements")
        if -(-B // _MMA_ROWS) > 65535:
            raise ValueError(f"{name} kernel: B = {B} > {65535 * _MMA_ROWS} rows "
                             f"({_MMA_ROWS} a block)")
    elif route == "fma":
        if 2 * F > 1024:
            raise ValueError(f"{name} kernel: 2F = {2 * F} > 1024 threads")
        if B > 65535:
            raise ValueError(f"{name} kernel: B = {B} > 65535 rows (one block each)")
    else:
        raise ValueError(f"{name}: route must be one of {ROUTES}, got {route!r}")
    smem = fwd_smem_bytes(F, esize, route)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{name} kernel: F={F} needs {smem} bytes of shared "
                         f"memory (> {_SMEM_LIMIT})")


def _fwd_kernel(xg, xc, whg, whc, h0, route=None):
    """One launch of csrc/bigru_scan.cu, two directions ([T, 2, B, .]
    streams) or one ([T, B, .]), on checked arguments → ys (xc's shape).
    ``route`` defaults to :func:`fwd_route`'s; ``"fma"`` may be asked for
    any width (the first design, for comparison), ``"mma"`` only where
    :func:`fwd_route` gives it."""
    global launches, fma_launches, gru_launches, gru_fma_launches
    bi = xg.dim() == 4
    name = "bigru_scan" if bi else "gru_scan"
    if xg.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {xg.device}")
    for arg, a in (("xg", xg), ("xc", xc), ("whg", whg), ("whc", whc), ("h0", h0)):
        if not a.is_contiguous():
            raise ValueError(f"{arg} must be contiguous")
    T, B, F = xg.shape[0], xg.shape[-2], xc.shape[-1]
    if route is None:
        route = fwd_route(F, xg.dtype)
    elif route == "mma" and fwd_route(F, xg.dtype) != "mma":
        raise ValueError(f"{name}: the tensor-core route takes bf16 with F a multiple of 8 "
                         f"up to {_MMA_MAX_F}, got F={F} {xg.dtype}")
    fwd_check_limits(B=B, F=F, esize=xg.element_size(), route=route, name=name)
    if route == "mma" and (xg.data_ptr() | xc.data_ptr()) % 16:
        raise ValueError(f"{name} tensor-core route: xg and xc must be 16-byte aligned")
    ys = torch.empty(xc.shape, dtype=xg.dtype, device=xg.device)
    if ys.numel() == 0:
        return ys
    with torch.cuda.device(xg.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().gru_scan_launch(xg.data_ptr(), xc.data_ptr(), whg.data_ptr(),
                                     whc.data_ptr(), h0.data_ptr(), ys.data_ptr(), T,
                                     2 if bi else 1, B, F, int(xg.dtype == torch.bfloat16),
                                     ROUTES.index(route), stream)
    cuda_build.check(err, f"{name} kernel launch ({route} route)")
    if route == "mma":
        if bi:
            launches += 1
        else:
            gru_launches += 1
    elif bi:
        fma_launches += 1
    else:
        gru_fma_launches += 1
    return ys


def bigru_scan_bwd(xg, xc, hprev, dys, whg, whc):
    """Backward of :func:`bigru_scan` (see :func:`bigru_scan_bwd_reference`):
    xg, xc, hprev, dys, whg, whc in the compute dtype, shapes as the
    forward's (hprev and dys like ys) → f32 (dxg, dxc, dwhg, dwhc, dh0)."""
    _check(xg, xc, whg, whc, hprev=hprev, dys=dys)
    if xg.device.type == "cpu":
        return bigru_scan_bwd_reference(xg, xc, hprev, dys, whg, whc)
    dxg, dxc, rh, dh0 = _bwd_kernel(xg, xc, hprev, dys, whg, whc)
    # dwhg[d] = sum_{t,b} round(hprev)^T round(dxg), dwhc[d] = round(r*hprev)^T round(dxc)
    grads = wgrad.wgrad([(hprev[:, d], dxg[:, d], False) for d in range(2)]
                        + [(rh[:, d], dxc[:, d], False) for d in range(2)], xg.dtype)
    dwhg = torch.stack([grads[0][0], grads[1][0]])
    dwhc = torch.stack([grads[2][0], grads[3][0]])
    return dxg, dxc, dwhg, dwhc, dh0


def gru_scan_bwd(xg, xc, hprev, dys, whg, whc):
    """Backward of :func:`gru_scan` (``_gru_scan_bwd_pallas``; see
    :func:`gru_scan_bwd_reference`): [T, B, .] streams and [F, .] weights in
    the compute dtype → f32 (dxg, dxc, dwhg, dwhc, dh0).  On the card: one
    prologue and one scan launch, then both weight gradients in one
    ``wgrad`` launch."""
    _check(xg, xc, whg, whc, dirs=1, hprev=hprev, dys=dys)
    if xg.device.type == "cpu":
        return gru_scan_bwd_reference(xg, xc, hprev, dys, whg, whc)
    dxg, dxc, rh, dh0 = _bwd_kernel(xg, xc, hprev, dys, whg, whc)
    # dwhg = sum_{t,b} round(hprev)^T round(dxg), dwhc = round(r*hprev)^T round(dxc)
    (dwhg, _), (dwhc, _) = wgrad.wgrad([(hprev, dxg, False), (rh, dxc, False)], xg.dtype)
    return dxg, dxc, dwhg, dwhc, dh0


# shared-memory bytes of the prologue's bf16 block (csrc/bigru_scan_bwd.cu):
# 1024 of alignment, an 8 KB A k-block per 64 columns of F, a ring of three
# 16 KB weight k-blocks, 64 x 132 staged f32 sums, six mbarriers; its f32
# block holds mma_common.cuh's TileF32 (64 x 36 + 32 x 68 + 64 x 68 floats)
_REMAT_F32_SMEM = (64 * 36 + 32 * 68 + 64 * 68) * 4
_SCAN_MAX_THREADS = 768   # 4F threads a scan block


def bwd_smem_bytes(F: int, esize: int) -> tuple[int, int]:
    """Shared memory of a block of the backward's two launches (prologue,
    scan) at width F with ``esize``-byte weights, as the kernels count it
    (``bigru_scan_bwd_remat_smem_bytes`` / ``bigru_scan_bwd_smem_bytes``):
    the scan's padded weight rows, six vectors of F floats and three step
    buffers (r | u | c, hprev, dys)."""
    up16 = lambda n: -(-n // 16) * 16
    remat = (1024 + -(-F // 64) * 8192 + 3 * 16384 + 64 * 132 * 4 + 2 * 3 * 8
             if esize == 2 else _REMAT_F32_SMEM)
    pad = 16 // esize
    step = 3 * F + up16(2 * F * esize) // 4
    scan = up16(F * (3 * F + 2 * pad) * esize) + (6 * F + 3 * step) * 4
    return remat, scan


def bwd_check_limits(*, T: int, B: int, F: int, esize: int, name: str = "bigru_scan_bwd"):
    """Raise ValueError where the backward's launches do not take these
    dims (the limits of csrc/bigru_scan_bwd.cu's note)."""
    if F % 8:
        raise ValueError(f"{name} kernel: F={F} is not a multiple of 8 (16-byte rows)")
    if 4 * F > _SCAN_MAX_THREADS:
        raise ValueError(f"{name} kernel: the scan's 4F = {4 * F} threads > "
                         f"{_SCAN_MAX_THREADS} (a block takes at most 1024 threads)")
    if B > 65535:
        raise ValueError(f"{name} kernel: B = {B} > 65535 rows (one scan block each)")
    if T * B >= 2 ** 31 - 64:
        raise ValueError(f"{name} kernel: T*B = {T * B} rows a direction (>= 2^31 - 64)")
    for what, smem in zip(("prologue", "scan"), bwd_smem_bytes(F, esize)):
        if smem > _SMEM_LIMIT:
            raise ValueError(f"{name} kernel: F={F} needs {smem} bytes of shared memory "
                             f"in its {what} (> {_SMEM_LIMIT})")


def bwd_remat(xg, xc, hprev, whg, whc):
    """The backward's carry-free prologue alone, two directions ([T, 2, B,
    .] streams) or one ([T, B, .]): the arguments of :func:`bigru_scan_bwd`
    but dys → (ruc f32 [.., 3F] = [r | u | c], rh = r·hprev in the compute
    dtype) (see :func:`bigru_bwd_remat_reference`)."""
    bi = xg.dim() == 4
    _check(xg, xc, whg, whc, dirs=2 if bi else 1, hprev=hprev)
    if xg.device.type == "cpu":
        if bi:
            return bigru_bwd_remat_reference(xg, xc, hprev, whg, whc)
        ruc, rh = bigru_bwd_remat_reference(xg[:, None], xc[:, None], hprev[:, None],
                                            whg[None], whc[None])
        return ruc[:, 0], rh[:, 0]
    _kernel_checks(xg, xc, hprev, whg, whc)
    return _remat_kernel(xg, xc, hprev, whg, whc)


def _kernel_checks(xg, xc, hprev, whg, whc, dys=None):
    """Device, contiguity and the kernels' limits; returns T, B, F."""
    name = "bigru_scan_bwd" if xg.dim() == 4 else "gru_scan_bwd"
    if xg.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {xg.device}")
    for arg, a in (("xg", xg), ("xc", xc), ("hprev", hprev), ("dys", dys),
                   ("whg", whg), ("whc", whc)):
        if a is not None and not a.is_contiguous():
            raise ValueError(f"{arg} must be contiguous")
    T, B, F = xg.shape[0], xg.shape[-2], xc.shape[-1]
    bwd_check_limits(T=T, B=B, F=F, esize=xg.element_size(), name=name)
    return T, B, F


def _launch_args(xg):
    T, B, F = xg.shape[0], xg.shape[-2], xg.shape[-1] // 2
    return T, 2 if xg.dim() == 4 else 1, B, F, int(xg.dtype == torch.bfloat16)


def _remat_kernel(xg, xc, hprev, whg, whc):
    """The prologue launch of csrc/bigru_scan_bwd.cu (arguments checked) →
    (ruc, rh)."""
    global bwd_remat_launches, gru_bwd_remat_launches
    F = xc.shape[-1]
    ruc = torch.empty((*xc.shape[:-1], 3 * F), dtype=torch.float32, device=xg.device)
    rh = torch.empty(xc.shape, dtype=xg.dtype, device=xg.device)
    if xg.shape[0] == 0 or xg.shape[-2] == 0:
        return ruc, rh
    with torch.cuda.device(xg.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_lib().gru_scan_bwd_remat_launch(
            xg.data_ptr(), xc.data_ptr(), hprev.data_ptr(), whg.data_ptr(), whc.data_ptr(),
            ruc.data_ptr(), rh.data_ptr(), *_launch_args(xg), stream)
    bi = xg.dim() == 4
    cuda_build.check(err, f"{'bigru' if bi else 'gru'}_scan_bwd prologue launch")
    if bi:
        bwd_remat_launches += 1
    else:
        gru_bwd_remat_launches += 1
    return ruc, rh


def _bwd_kernel(xg, xc, hprev, dys, whg, whc):
    """The two launches of csrc/bigru_scan_bwd.cu, two directions or one,
    prologue then scan (shapes checked) → (dxg, dxc, rh, dh0): the per-step
    outputs and the r*h_prev stream the weight gradients are reduced from."""
    global bwd_launches, gru_bwd_launches
    T, B, F = _kernel_checks(xg, xc, hprev, whg, whc, dys)
    f32 = dict(dtype=torch.float32, device=xg.device)
    dxg = torch.empty(xg.shape, **f32)
    dxc = torch.empty(xc.shape, **f32)
    dh0 = torch.zeros(hprev.shape[1:], **f32)   # stays zero when T == 0
    ruc, rh = _remat_kernel(xg, xc, hprev, whg, whc)
    if T == 0 or B == 0:
        return dxg, dxc, rh, dh0
    with torch.cuda.device(xg.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_lib().gru_scan_bwd_launch(
            ruc.data_ptr(), hprev.data_ptr(), dys.data_ptr(), whg.data_ptr(), whc.data_ptr(),
            dxg.data_ptr(), dxc.data_ptr(), dh0.data_ptr(), *_launch_args(xg), stream)
    bi = xg.dim() == 4
    cuda_build.check(err, f"{'bigru' if bi else 'gru'}_scan_bwd kernel launch")
    if bi:
        bwd_launches += 1
    else:
        gru_bwd_launches += 1
    return dxg, dxc, rh, dh0


class BiGRUScan(torch.autograd.Function):
    """Differentiable :func:`bigru_scan` (the JAX package's ``bigru_scan``
    custom VJP): gradients come back in the dtype of their inputs."""

    @staticmethod
    def forward(ctx, xg, xc, whg, whc, h0):
        ys = bigru_scan(xg, xc, whg, whc, h0)
        ctx.save_for_backward(xg, xc, whg, whc, h0, ys)
        return ys

    @staticmethod
    def backward(ctx, dys):
        xg, xc, whg, whc, h0, ys = ctx.saved_tensors
        hprev = torch.cat([h0[None].to(ys.dtype), ys[:-1]], dim=0)
        dxg, dxc, dwhg, dwhc, dh0 = bigru_scan_bwd(
            xg, xc, hprev, dys.to(ys.dtype).contiguous(), whg, whc)
        return (dxg.to(xg.dtype), dxc.to(xc.dtype), dwhg.to(whg.dtype),
                dwhc.to(whc.dtype), dh0.to(h0.dtype))


class GRUScan(torch.autograd.Function):
    """Differentiable :func:`gru_scan` (the JAX package's ``gru_scan``
    custom VJP, ``ops/gru_scan.py:281-312``): the forward saves ``ys``; the
    backward builds ``hprev = [h0, ys[:-1]]`` in the compute dtype and casts
    each gradient back to its input's dtype.  ``h0`` may be of any float
    dtype (the JAX ``GRU`` passes zeros in the input's dtype); the kernel
    reads it as f32."""

    @staticmethod
    def forward(ctx, xg, xc, whg, whc, h0):
        ys = gru_scan(xg, xc, whg, whc, h0.float().contiguous())
        ctx.save_for_backward(xg, xc, whg, whc, h0, ys)
        return ys

    @staticmethod
    def backward(ctx, dys):
        xg, xc, whg, whc, h0, ys = ctx.saved_tensors
        hprev = torch.cat([h0[None].to(ys.dtype), ys[:-1]], dim=0)
        dxg, dxc, dwhg, dwhc, dh0 = gru_scan_bwd(
            xg, xc, hprev, dys.to(ys.dtype).contiguous(), whg, whc)
        return (dxg.to(xg.dtype), dxc.to(xc.dtype), dwhg.to(whg.dtype),
                dwhc.to(whc.dtype), dh0.to(h0.dtype))


def _bwd_lib() -> ctypes.CDLL:
    lib = cuda_build.library("bigru_scan_bwd")
    if not getattr(lib, "_typed", False):
        p = ctypes.c_void_p
        lib.gru_scan_bwd_remat_launch.argtypes = [p] * 7 + [ctypes.c_int] * 5 + [p]
        lib.gru_scan_bwd_remat_launch.restype = ctypes.c_int
        lib.gru_scan_bwd_launch.argtypes = [p] * 8 + [ctypes.c_int] * 5 + [p]
        lib.gru_scan_bwd_launch.restype = ctypes.c_int
        for fn in (lib.bigru_scan_bwd_smem_bytes, lib.bigru_scan_bwd_remat_smem_bytes):
            fn.argtypes = [ctypes.c_int, ctypes.c_int]
            fn.restype = ctypes.c_size_t
        lib._typed = True
    return lib


def _lib() -> ctypes.CDLL:
    lib = cuda_build.library("bigru_scan")
    if not getattr(lib, "_typed", False):
        p = ctypes.c_void_p
        lib.gru_scan_launch.argtypes = [p] * 6 + [ctypes.c_int] * 6 + [p]
        lib.gru_scan_launch.restype = ctypes.c_int
        lib.bigru_scan_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.bigru_scan_smem_bytes.restype = ctypes.c_size_t
        lib._typed = True
    return lib
