"""All fast Griffin-Lim iterations in one wrapper call: CUDA kernels and their
plain PyTorch version.

Port of ``tacotron_multispeaker_tpu/ops/gl_iteration.py``
``gl_fast_iterations_pallas``.  Per iteration, on frames ``wf`` [B, F, n_fft]
carried in the compute dtype (bf16 on the serving path, or f32):

1. forward DFT ``re = wf @ C``, ``im = wf @ S`` (compute-dtype operands, f32
   sums); momentum extrapolation ``a = (re, im) − mom·(pre, pim)``; the
   magnitude projection ``s = a · mag / max(|a|, 1e-8)``; ``(pre, pim) =
   (re, im)``;
2. inverse DFT ``fr = s_re @ iC + s_im @ iS`` (s rounded to the compute
   dtype, f32 sums), kept in f32;
3. the overlap-add and re-framing collapsed into one banded operator,
   ``wf[g, i] = N[g, i] · Σ_d S_d[i] · fr[g − d, i + d·hop]`` with
   ``N[g, i] = win[i] / norm[g·hop + i]``, ``S_d[i] = win[i + d·hop]`` (zero
   outside the frame) and d ∈ [−(m−1), m−1], m = ceil(n_fft / hop); summed
   in f32 over increasing d, rounded to the compute dtype.

Returns (sre, sim, pre, pim), each [B, F, bins] f32: the projected spectrum
of the last iteration and the last raw estimate (the momentum state).

:func:`gl_fast_iterations` runs the plain version for CPU tensors and the
CUDA kernels (``csrc/gl_iteration.cu``: one launch of each of the three
steps per iteration, all from one wrapper call) for CUDA tensors; anything
else raises.  The DFT matrices are built once per (n_fft, dtype, device),
the banded OLA coefficients once per (window, F, hop, device).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import cuda_build
from .overlap_add import _wsq_norm

# wrapper calls that launched the CUDA kernels (the plain version does not count)
launches = 0

_INT_MAX = 2**31 - 1
_BIN_TILE = 32        # csrc/gl_iteration.cu: bins per forward output tile


@functools.lru_cache(maxsize=4)
def dft_matrices(n_fft: int):
    """(C [n_fft, bins], S [n_fft, bins], iC [bins, n_fft], iS [bins, n_fft])
    float64 numpy such that re = x@C, im = x@S and x = re@iC + im@iS
    (== rfft/irfft), as the Pallas wrapper builds them."""
    bins = n_fft // 2 + 1
    ang = 2.0 * np.pi * np.arange(n_fft)[:, None] * np.arange(bins)[None, :] / n_fft
    C, S = np.cos(ang), -np.sin(ang)
    w = np.full((bins,), 2.0)
    w[0] = 1.0
    if n_fft % 2 == 0:
        w[-1] = 1.0
    return C, S, (w[:, None] * C.T) / n_fft, (w[:, None] * S.T) / n_fft


def shift_coeffs(window: torch.Tensor, nF: int, hop: int):
    """N [F, n_fft] and S [2m−1, n_fft] of the banded OLA∘reframe, f32."""
    n_fft = window.shape[0]
    m = -(-n_fft // hop)
    win = window.float()
    norm = _wsq_norm(win, nF, hop)
    g = torch.arange(nF, device=win.device)[:, None]
    i = torch.arange(n_fft, device=win.device)[None, :]
    N = win[None, :] / norm[g * hop + i]
    rows = []
    for d in range(-(m - 1), m):
        idx = torch.arange(n_fft, device=win.device) + d * hop
        ok = (idx >= 0) & (idx < n_fft)
        rows.append(torch.where(ok, win[idx.clamp(0, n_fft - 1)], torch.zeros_like(win)))
    return N, torch.stack(rows)


@functools.lru_cache(maxsize=8)
def _device_shift_coeffs(win_bytes: bytes, nF: int, hop: int, device: torch.device):
    """:func:`shift_coeffs` on ``device``, built once per (window, F, hop)."""
    win = torch.from_numpy(np.frombuffer(win_bytes, np.float32).copy()).to(device)
    return tuple(t.contiguous() for t in shift_coeffs(win, nF, hop))


def gl_fast_iterations_reference(wf0, magT, window, hop: int, n_iters: int, mom: float):
    """Plain version with the kernel's rounding points: ``wf`` carried in
    wf0's dtype, matmul operands rounded to it, f32 sums."""
    dt = wf0.dtype
    B, nF, n_fft = wf0.shape
    m = -(-n_fft // hop)
    C, S, iC, iS = (torch.from_numpy(a).to(device=wf0.device, dtype=dt).float()
                    for a in dft_matrices(n_fft))
    N, Sd = shift_coeffs(window, nF, hop)
    mag = magT.float()
    pre = torch.zeros_like(mag)
    pim = torch.zeros_like(mag)
    wf = wf0
    sre = sim = None
    rows = torch.arange(nF, device=wf0.device)
    for _ in range(n_iters):
        f = wf.float()
        re, im = f @ C, f @ S
        are = re - mom * pre
        aim = im - mom * pim
        pre, pim = re, im
        scale = mag / torch.clamp(torch.sqrt(are * are + aim * aim), min=1e-8)
        sre, sim = are * scale, aim * scale
        fr = sre.to(dt).float() @ iC + sim.to(dt).float() @ iS
        acc = torch.zeros_like(fr)
        for di, d in enumerate(range(-(m - 1), m)):
            shifted = torch.roll(torch.roll(fr, d, dims=1), -d * hop, dims=2)
            row_ok = ((rows >= d) & (rows < nF + d)).float()[None, :, None]
            acc = acc + shifted * Sd[di] * row_ok
        wf = (acc * N[None]).to(dt)
    return sre, sim, pre, pim


def _padded_bins(n_fft: int) -> int:
    return -(-(n_fft // 2 + 1) // 8) * 8


@functools.lru_cache(maxsize=8)
def _device_matrices(n_fft: int, dtype: torch.dtype, device: torch.device):
    """The kernels' DFT operands on ``device`` in ``dtype``: the forward
    matrix [n_fft, tiles·64] with each 64-column tile holding the cosine
    columns of 32 bins then their sine columns (so that one output tile has
    re and im of the same bins), and the inverse [iC; 0; iS; 0] [2·bp, n_fft]
    with bins padded to bp, a multiple of 8 (16-byte rows)."""
    C, S, iC, iS = dft_matrices(n_fft)
    bins = C.shape[1]
    tiles = -(-bins // _BIN_TILE)
    pad = tiles * _BIN_TILE - bins
    Cp = np.pad(C, ((0, 0), (0, pad))).reshape(n_fft, tiles, 1, _BIN_TILE)
    Sp = np.pad(S, ((0, 0), (0, pad))).reshape(n_fft, tiles, 1, _BIN_TILE)
    fwd = np.concatenate([Cp, Sp], axis=2).reshape(n_fft, tiles * 2 * _BIN_TILE)
    rows = ((0, _padded_bins(n_fft) - bins), (0, 0))
    inv = np.concatenate([np.pad(iC, rows), np.pad(iS, rows)], axis=0)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)
    return to(fwd), to(inv)


def gl_fast_iterations(wf0, magT, window, hop: int, n_iters: int, mom: float):
    """``n_iters`` fast Griffin-Lim iterations (see the module docstring).

    wf0 [B, F, n_fft] (bf16 or f32) the initial windowed frames, magT
    [B, F, bins] the target magnitude, window [n_fft], ``mom`` the converted
    momentum (momentum/(1+momentum); 0 is plain Griffin-Lim)."""
    if wf0.dim() != 3:
        raise ValueError(f"wf0 must be [B, F, n_fft], got {tuple(wf0.shape)}")
    B, nF, n_fft = wf0.shape
    bins = n_fft // 2 + 1
    if tuple(magT.shape) != (B, nF, bins) or tuple(window.shape) != (n_fft,):
        raise ValueError(f"magT must be {(B, nF, bins)} and window ({n_fft},); got "
                         f"{tuple(magT.shape)}, {tuple(window.shape)}")
    if wf0.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"wf0 must be float32 or bfloat16, got {wf0.dtype}")
    for name, a in (("magT", magT), ("window", window)):
        if a.device != wf0.device:
            raise ValueError(f"{name} is on {a.device}, wf0 on {wf0.device}")
    if n_iters < 1 or hop < 1 or nF < 1:
        raise ValueError(f"gl_fast_iterations: n_iters={n_iters}, hop={hop}, F={nF} "
                         "must be at least 1")
    if wf0.device.type == "cpu":
        return gl_fast_iterations_reference(wf0, magT, window, hop, n_iters, mom)
    if wf0.device.type != "cuda":
        raise ValueError(f"gl_fast_iterations runs on cpu or cuda, not {wf0.device}")
    G, bp = B * nF, _padded_bins(n_fft)
    if n_fft % 8 or G * max(n_fft, 2 * bp) > _INT_MAX:
        raise ValueError(f"gl_fast_iterations kernel: n_fft={n_fft} must be a multiple of "
                         f"8 (16-byte rows) and B*F*n_fft={G * n_fft} below 2^31")
    dev = wf0.device
    fwd_mat, inv_mat = _device_matrices(n_fft, wf0.dtype, dev)
    win_bytes = window.detach().float().cpu().numpy().tobytes()
    N, Sd = _device_shift_coeffs(win_bytes, nF, hop, dev)
    wf = wf0.contiguous().clone()                       # updated in place
    mag = magT.float().contiguous()
    out = torch.empty((4, B, nF, bins), dtype=torch.float32, device=dev)
    out[2:].zero_()                                     # pre, pim start at 0
    fr = torch.empty((B, nF, n_fft), dtype=torch.float32, device=dev)
    st = torch.zeros((B, nF, 2 * bp), dtype=wf0.dtype, device=dev)   # pads stay 0
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gl_iterations_launch(
            wf.data_ptr(), mag.data_ptr(), fwd_mat.data_ptr(), inv_mat.data_ptr(),
            N.data_ptr(), Sd.data_ptr(), fr.data_ptr(), st.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), out[3].data_ptr(),
            B, nF, n_fft, hop, n_iters, ctypes.c_float(mom),
            int(wf0.dtype == torch.bfloat16), stream)
    cuda_build.check(err, "gl_iteration kernel launch")
    global launches
    launches += 1
    return out[0], out[1], out[2], out[3]


def _lib() -> ctypes.CDLL:
    lib = cuda_build.library("gl_iteration")
    if not getattr(lib, "_typed", False):
        lib.gl_iterations_launch.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                                             + [ctypes.c_float, ctypes.c_int,
                                                ctypes.c_void_p])
        lib.gl_iterations_launch.restype = ctypes.c_int
        lib._typed = True
    return lib
