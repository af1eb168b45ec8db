"""Fused two-direction GRU scan: CUDA kernel and its plain PyTorch version.

Port of ``tacotron_multispeaker_tpu/ops/gru_scan.py`` ``bigru_scan_pallas``
(the forward, ``csrc/bigru_scan.cu``) and ``_bigru_scan_bwd_pallas`` (the
backward, ``csrc/bigru_scan_bwd.cu`` with the weight gradients reduced by
``csrc/wgrad.cu``), joined by :class:`BiGRUScan`, the
``torch.autograd.Function`` that mirrors the JAX package's ``bigru_scan``
custom VJP: the forward saves ``ys`` in the compute dtype and the backward
rebuilds ``hprev`` from it.

Contract, identical to the Pallas kernel's: xg [T, 2, B, 2F], xc [T, 2, B, F]
(direction 1's input projections already time-reversed by the caller), whg
[2, F, 2F], whc [2, F, F], all in the compute dtype (bf16 or f32), and h0
[2, B, F] f32 → ys [T, 2, B, F] in the dtype of xg.  The cell is the
legacy-TF GRU: the reset gate multiplies h BEFORE the candidate matmul.
Matmul inputs are rounded to the compute dtype, sums and the carry are f32.

:func:`bigru_scan` and :func:`bigru_scan_bwd` run their plain versions
for CPU tensors and their CUDA kernels for CUDA tensors; anything else
raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build, wgrad

# launches of the CUDA kernels (the plain versions do not count)
launches = 0          # forward, csrc/bigru_scan.cu
bwd_launches = 0      # backward, csrc/bigru_scan_bwd.cu

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


def _check(xg, xc, whg, whc, h0=None, **streams):
    """Shapes, devices and dtypes of the forward's arguments (h0 f32) and of
    the backward's ``streams`` (like ys, compute dtype); returns T, B, F."""
    T, two, B, F2 = xg.shape
    F = F2 // 2
    if two != 2 or F2 != 2 * F:
        raise ValueError(f"xg must be [T, 2, B, 2F], got {tuple(xg.shape)}")
    shapes = {"xc": (xc, (T, 2, B, F)), "whg": (whg, (2, F, 2 * F)),
              "whc": (whc, (2, F, F))}
    shapes.update({name: (a, (T, 2, B, F)) for name, a in streams.items()})
    if h0 is not None:
        shapes["h0"] = (h0, (2, B, F))
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
    T, B, F = _check(xg, xc, whg, whc, h0)
    if xg.device.type == "cpu":
        return bigru_scan_reference(xg, xc, whg, whc, h0)
    if xg.device.type != "cuda":
        raise ValueError(f"bigru_scan runs on cpu or cuda, not {xg.device}")
    for name, a in (("xg", xg), ("xc", xc), ("whg", whg), ("whc", whc), ("h0", h0)):
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = _lib()
    is_bf16 = int(xg.dtype == torch.bfloat16)
    if 2 * F > 1024:
        raise ValueError(f"bigru_scan kernel: 2F = {2 * F} > 1024 threads")
    if B > 65535:
        raise ValueError(f"bigru_scan kernel: B = {B} > 65535 rows (one block each)")
    smem = lib.bigru_scan_smem_bytes(F, is_bf16)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"bigru_scan kernel: F={F} needs {smem} bytes of shared "
                         f"memory (> {_SMEM_LIMIT})")
    ys = torch.empty((T, 2, B, F), dtype=xg.dtype, device=xg.device)
    if T == 0 or B == 0:
        return ys
    with torch.cuda.device(xg.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bigru_scan_launch(xg.data_ptr(), xc.data_ptr(), whg.data_ptr(),
                                    whc.data_ptr(), h0.data_ptr(), ys.data_ptr(),
                                    T, B, F, is_bf16, stream)
    cuda_build.check(err, "bigru_scan kernel launch")
    global launches
    launches += 1
    return ys


def bigru_scan_bwd(xg, xc, hprev, dys, whg, whc):
    """Backward of :func:`bigru_scan` (see :func:`bigru_scan_bwd_reference`):
    xg, xc, hprev, dys, whg, whc in the compute dtype, shapes as the
    forward's (hprev and dys like ys) → f32 (dxg, dxc, dwhg, dwhc, dh0)."""
    T, B, F = _check(xg, xc, whg, whc, hprev=hprev, dys=dys)
    if xg.device.type == "cpu":
        return bigru_scan_bwd_reference(xg, xc, hprev, dys, whg, whc)
    if xg.device.type != "cuda":
        raise ValueError(f"bigru_scan_bwd runs on cpu or cuda, not {xg.device}")
    dxg, dxc, rh, dh0 = _bwd_kernel(xg, xc, hprev, dys, whg, whc)
    # dwhg[d] = sum_{t,b} round(hprev)^T round(dxg), dwhc[d] = round(r*hprev)^T round(dxc)
    grads = wgrad.wgrad([(hprev[:, d], dxg[:, d], False) for d in range(2)]
                        + [(rh[:, d], dxc[:, d], False) for d in range(2)], xg.dtype)
    dwhg = torch.stack([grads[0][0], grads[1][0]])
    dwhc = torch.stack([grads[2][0], grads[3][0]])
    return dxg, dxc, dwhg, dwhc, dh0


def _bwd_kernel(xg, xc, hprev, dys, whg, whc):
    """One launch of csrc/bigru_scan_bwd.cu (checked CUDA arguments) →
    (dxg, dxc, rh, dh0): the per-step outputs and the r*h_prev stream the
    weight gradients are reduced from."""
    T, _, B, F2 = xg.shape
    F = F2 // 2
    for name, a in (("xg", xg), ("xc", xc), ("hprev", hprev), ("dys", dys),
                    ("whg", whg), ("whc", whc)):
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = _bwd_lib()
    is_bf16 = int(xg.dtype == torch.bfloat16)
    if 2 * F > 1024:
        raise ValueError(f"bigru_scan_bwd kernel: 2F = {2 * F} > 1024 threads")
    if B > 65535:
        raise ValueError(f"bigru_scan_bwd kernel: B = {B} > 65535 rows (one block each)")
    smem = lib.bigru_scan_bwd_smem_bytes(F, is_bf16)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"bigru_scan_bwd kernel: F={F} needs {smem} bytes of shared "
                         f"memory (> {_SMEM_LIMIT})")
    f32 = dict(dtype=torch.float32, device=xg.device)
    dxg = torch.empty((T, 2, B, 2 * F), **f32)
    dxc = torch.empty((T, 2, B, F), **f32)
    rh = torch.empty((T, 2, B, F), dtype=xg.dtype, device=xg.device)
    dh0 = torch.zeros((2, B, F), **f32)   # stays zero when T == 0
    if T == 0 or B == 0:
        return dxg, dxc, rh, dh0
    with torch.cuda.device(xg.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bigru_scan_bwd_launch(xg.data_ptr(), xc.data_ptr(), hprev.data_ptr(),
                                        dys.data_ptr(), whg.data_ptr(), whc.data_ptr(),
                                        dxg.data_ptr(), dxc.data_ptr(), rh.data_ptr(),
                                        dh0.data_ptr(), T, B, F, is_bf16, stream)
    cuda_build.check(err, "bigru_scan_bwd kernel launch")
    global bwd_launches
    bwd_launches += 1
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


def _bwd_lib() -> ctypes.CDLL:
    lib = cuda_build.library("bigru_scan_bwd")
    if not getattr(lib, "_typed", False):
        p = ctypes.c_void_p
        lib.bigru_scan_bwd_launch.argtypes = [p] * 10 + [ctypes.c_int] * 4 + [p]
        lib.bigru_scan_bwd_launch.restype = ctypes.c_int
        lib.bigru_scan_bwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.bigru_scan_bwd_smem_bytes.restype = ctypes.c_size_t
        lib._typed = True
    return lib


def _lib() -> ctypes.CDLL:
    lib = cuda_build.library("bigru_scan")
    if not getattr(lib, "_typed", False):
        p = ctypes.c_void_p
        lib.bigru_scan_launch.argtypes = [p, p, p, p, p, p, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int, p]
        lib.bigru_scan_launch.restype = ctypes.c_int
        lib.bigru_scan_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.bigru_scan_smem_bytes.restype = ctypes.c_size_t
        lib._typed = True
    return lib
