"""GRU scans, fused over directions: CUDA kernels and their plain PyTorch versions.

Port of ``tacotron_multispeaker_tpu/ops/gru_scan.py``:

* two directions: ``bigru_scan_pallas`` (the forward, ``csrc/bigru_scan.cu``)
  and ``_bigru_scan_bwd_pallas`` (the backward, ``csrc/bigru_scan_bwd.cu``
  with the weight gradients reduced by ``csrc/wgrad.cu``), joined by
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
launches = 0          # two-direction forward, csrc/bigru_scan.cu
bwd_launches = 0      # two-direction backward, csrc/bigru_scan_bwd.cu
gru_launches = 0      # one-direction forward, csrc/bigru_scan.cu
gru_bwd_launches = 0  # one-direction backward, csrc/bigru_scan_bwd.cu

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


def _fwd_kernel(xg, xc, whg, whc, h0):
    """One launch of csrc/bigru_scan.cu, two directions ([T, 2, B, .]
    streams) or one ([T, B, .]), on checked arguments → ys (xc's shape)."""
    global launches, gru_launches
    bi = xg.dim() == 4
    name = "bigru_scan" if bi else "gru_scan"
    if xg.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {xg.device}")
    for arg, a in (("xg", xg), ("xc", xc), ("whg", whg), ("whc", whc), ("h0", h0)):
        if not a.is_contiguous():
            raise ValueError(f"{arg} must be contiguous")
    T, B, F = xg.shape[0], xg.shape[-2], xc.shape[-1]
    lib = _lib()
    is_bf16 = int(xg.dtype == torch.bfloat16)
    if 2 * F > 1024:
        raise ValueError(f"{name} kernel: 2F = {2 * F} > 1024 threads")
    if B > 65535:
        raise ValueError(f"{name} kernel: B = {B} > 65535 rows (one block each)")
    smem = lib.bigru_scan_smem_bytes(F, is_bf16)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{name} kernel: F={F} needs {smem} bytes of shared "
                         f"memory (> {_SMEM_LIMIT})")
    ys = torch.empty(xc.shape, dtype=xg.dtype, device=xg.device)
    if T == 0 or B == 0:
        return ys
    with torch.cuda.device(xg.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gru_scan_launch(xg.data_ptr(), xc.data_ptr(), whg.data_ptr(),
                                  whc.data_ptr(), h0.data_ptr(), ys.data_ptr(), T,
                                  2 if bi else 1, B, F, is_bf16, stream)
    cuda_build.check(err, f"{name} kernel launch")
    if bi:
        launches += 1
    else:
        gru_launches += 1
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
    kernel launch, then both weight gradients in one ``wgrad`` launch."""
    _check(xg, xc, whg, whc, dirs=1, hprev=hprev, dys=dys)
    if xg.device.type == "cpu":
        return gru_scan_bwd_reference(xg, xc, hprev, dys, whg, whc)
    dxg, dxc, rh, dh0 = _bwd_kernel(xg, xc, hprev, dys, whg, whc)
    # dwhg = sum_{t,b} round(hprev)^T round(dxg), dwhc = round(r*hprev)^T round(dxc)
    (dwhg, _), (dwhc, _) = wgrad.wgrad([(hprev, dxg, False), (rh, dxc, False)], xg.dtype)
    return dxg, dxc, dwhg, dwhc, dh0


def _bwd_kernel(xg, xc, hprev, dys, whg, whc):
    """One launch of csrc/bigru_scan_bwd.cu, two directions or one, on
    checked arguments → (dxg, dxc, rh, dh0): the per-step outputs and the
    r*h_prev stream the weight gradients are reduced from."""
    global bwd_launches, gru_bwd_launches
    bi = xg.dim() == 4
    name = "bigru_scan_bwd" if bi else "gru_scan_bwd"
    if xg.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {xg.device}")
    for arg, a in (("xg", xg), ("xc", xc), ("hprev", hprev), ("dys", dys),
                   ("whg", whg), ("whc", whc)):
        if not a.is_contiguous():
            raise ValueError(f"{arg} must be contiguous")
    T, B, F = xg.shape[0], xg.shape[-2], xc.shape[-1]
    lib = _bwd_lib()
    is_bf16 = int(xg.dtype == torch.bfloat16)
    if 2 * F > 1024:
        raise ValueError(f"{name} kernel: 2F = {2 * F} > 1024 threads")
    if B > 65535:
        raise ValueError(f"{name} kernel: B = {B} > 65535 rows (one block each)")
    smem = lib.bigru_scan_bwd_smem_bytes(F, is_bf16)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{name} kernel: F={F} needs {smem} bytes of shared "
                         f"memory (> {_SMEM_LIMIT})")
    f32 = dict(dtype=torch.float32, device=xg.device)
    dxg = torch.empty(xg.shape, **f32)
    dxc = torch.empty(xc.shape, **f32)
    rh = torch.empty(xc.shape, dtype=xg.dtype, device=xg.device)
    dh0 = torch.zeros(hprev.shape[1:], **f32)   # stays zero when T == 0
    if T == 0 or B == 0:
        return dxg, dxc, rh, dh0
    with torch.cuda.device(xg.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gru_scan_bwd_launch(xg.data_ptr(), xc.data_ptr(), hprev.data_ptr(),
                                      dys.data_ptr(), whg.data_ptr(), whc.data_ptr(),
                                      dxg.data_ptr(), dxc.data_ptr(), rh.data_ptr(),
                                      dh0.data_ptr(), T, 2 if bi else 1, B, F, is_bf16,
                                      stream)
    cuda_build.check(err, f"{name} kernel launch")
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
        lib.gru_scan_bwd_launch.argtypes = [p] * 10 + [ctypes.c_int] * 5 + [p]
        lib.gru_scan_bwd_launch.restype = ctypes.c_int
        lib.bigru_scan_bwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.bigru_scan_bwd_smem_bytes.restype = ctypes.c_size_t
        lib._typed = True
    return lib


def _lib() -> ctypes.CDLL:
    lib = cuda_build.library("bigru_scan")
    if not getattr(lib, "_typed", False):
        p = ctypes.c_void_p
        lib.gru_scan_launch.argtypes = [p] * 6 + [ctypes.c_int] * 5 + [p]
        lib.gru_scan_launch.restype = ctypes.c_int
        lib.bigru_scan_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.bigru_scan_smem_bytes.restype = ctypes.c_size_t
        lib._typed = True
    return lib
