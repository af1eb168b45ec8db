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
else raises.  From the second iteration on the kernels compute only inside
the window's support (:func:`window_support`), which drops only products
with exact zeros.  The DFT matrices are built once per (n_fft, dtype,
device), the banded OLA coefficients and the support once per (window, F,
hop, device); :func:`bf16_plan` reports the bf16 launch.
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
K_STEP = 64           # csrc/gl_iteration.cu: frame samples per k-block of a product
_COL_TILE = 128       # csrc/gl_iteration.cu: forward columns (64 bins) per bf16 tile


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


def window_support(window, step: int = K_STEP) -> tuple[int, int]:
    """[lo, hi): the hull of the window's nonzero samples, rounded out to
    multiples of ``step`` (hi clipped to n_fft).  From the second iteration
    on the kernels compute only inside it: outside it N = win/norm makes the
    frames 0 and S_d = win makes every OLA term 0, so each dropped term is a
    product with an exact zero.  Raises for a window with no nonzero sample."""
    win = np.asarray(window, dtype=np.float32)
    nz = np.flatnonzero(win)
    if nz.size == 0:
        raise ValueError("gl_fast_iterations: the window has no nonzero sample")
    lo = int(nz[0]) // step * step
    hi = min(-(-(int(nz[-1]) + 1) // step) * step, win.shape[0])
    return lo, hi


@functools.lru_cache(maxsize=8)
def _device_shift_coeffs(win_bytes: bytes, nF: int, hop: int, device: torch.device):
    """:func:`shift_coeffs` on ``device`` and the window's support
    (:func:`window_support`), built once per (window, F, hop)."""
    win = np.frombuffer(win_bytes, np.float32).copy()
    N, Sd = shift_coeffs(torch.from_numpy(win).to(device), nF, hop)
    return N.contiguous(), Sd.contiguous(), window_support(win)


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


def _spectrum_width(n_fft: int) -> int:
    """KI: the interleaved (re, im) spectrum's row length, 2·bins rounded up
    to 8 (16-byte rows)."""
    return -(-2 * (n_fft // 2 + 1) // 8) * 8


def _kernel_matrices(n_fft: int):
    """The kernels' DFT operands, float64 numpy: the forward matrix [n_fft,
    ncol] with the cosine of bin j in column 2j and its sine in 2j+1 (ncol =
    2·bins rounded up to 128, zero columns past them), and the inverse [KI,
    n_fft] with iC[j] in row 2j and iS[j] in row 2j+1 (zero rows at the
    pads)."""
    C, S, iC, iS = dft_matrices(n_fft)
    bins = C.shape[1]
    ncol = -(-2 * bins // _COL_TILE) * _COL_TILE
    fwd = np.zeros((n_fft, ncol))
    fwd[:, 0:2 * bins:2], fwd[:, 1:2 * bins:2] = C, S
    inv = np.zeros((_spectrum_width(n_fft), n_fft))
    inv[0:2 * bins:2], inv[1:2 * bins:2] = iC, iS
    return fwd, inv


@functools.lru_cache(maxsize=8)
def _device_matrices(n_fft: int, dtype: torch.dtype, device: torch.device):
    """:func:`_kernel_matrices` on ``device`` in ``dtype``, built once."""
    return tuple(torch.from_numpy(a).to(device=device, dtype=dtype)
                 for a in _kernel_matrices(n_fft))


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
    G, KI = B * nF, _spectrum_width(n_fft)
    if n_fft % 8 or G * max(n_fft, KI) > _INT_MAX:
        raise ValueError(f"gl_fast_iterations kernel: n_fft={n_fft} must be a multiple of "
                         f"8 (16-byte rows) and B*F*n_fft={G * n_fft} below 2^31")
    dev = wf0.device
    fwd_mat, inv_mat = _device_matrices(n_fft, wf0.dtype, dev)
    win_bytes = window.detach().float().cpu().numpy().tobytes()
    N, Sd, (lo, hi) = _device_shift_coeffs(win_bytes, nF, hop, dev)
    wf = wf0.contiguous().clone()                       # updated in place
    mag = magT.float().contiguous()
    if wf.data_ptr() % 16:
        raise ValueError("gl_fast_iterations kernel: the frames must be 16-byte aligned")
    out = torch.empty((4, B, nF, bins), dtype=torch.float32, device=dev)
    fr = torch.empty((B, nF, n_fft), dtype=torch.float32, device=dev)
    state = torch.empty((B, nF, bins, 2), dtype=torch.float32, device=dev)
    st = torch.empty((B, nF, KI), dtype=wf0.dtype, device=dev)
    st[..., 2 * bins:].zero_()                          # pads: zero rows of inv
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gl_iterations_launch(
            wf.data_ptr(), mag.data_ptr(), fwd_mat.data_ptr(), inv_mat.data_ptr(),
            N.data_ptr(), Sd.data_ptr(), fr.data_ptr(), st.data_ptr(), state.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), out[3].data_ptr(),
            B, nF, n_fft, hop, lo, hi, n_iters, ctypes.c_float(mom),
            int(wf0.dtype == torch.bfloat16), stream)
    cuda_build.check(err, "gl_iteration kernel launch")
    global launches
    launches += 1
    return out[0], out[1], out[2], out[3]


def bf16_plan(window) -> dict:
    """The bf16 launch: for the forward and the inverse product, the tile
    (rows x 128 columns x 64-deep k-blocks on wgmma), consumer warpgroups,
    ring stages and dynamic shared memory bytes a block; and the window's
    support [lo, hi) (:func:`window_support`)."""
    out = (ctypes.c_int * 8)()
    _lib().gl_iterations_plan(out)
    win = window.detach().float().cpu().numpy() if torch.is_tensor(window) else window
    plan = {name: {"tile": f"wgmma m64n128k16, {out[i]} x 128 x 64", "warpgroups": out[i + 1],
                   "stages": out[i + 2], "smem_bytes": out[i + 3]}
            for name, i in (("forward", 0), ("inverse", 4))}
    return {**plan, "support": window_support(win)}


def _lib() -> ctypes.CDLL:
    lib = cuda_build.library("gl_iteration")
    if not getattr(lib, "_typed", False):
        lib.gl_iterations_launch.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 7
                                             + [ctypes.c_float, ctypes.c_int,
                                                ctypes.c_void_p])
        lib.gl_iterations_launch.restype = ctypes.c_int
        lib.gl_iterations_plan.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.gl_iterations_plan.restype = None
        lib._typed = True
    return lib
