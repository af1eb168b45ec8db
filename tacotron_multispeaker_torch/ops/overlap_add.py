"""Windowed overlap-add for the iSTFT: the plain static-shift formulation, and
the OLA kernel with its plain version.

Port of ``tacotron_multispeaker_tpu/ops/overlap_add.py``:

* :func:`overlap_add_reference` and :func:`_wsq_norm` — the static hop-shift
  decomposition (pad each frame to m·hop; chunk i of frame f lands at output
  row f+i, so the OLA is m shifted adds, no scatter).  The Griffin-Lim loop
  runs it by default, as the JAX package does.
* :func:`overlap_add` — ``overlap_add_pallas``: window × frames, overlap-add
  at ``hop``, ÷ the window-square norm, always in f32 whatever the frames'
  dtype (f32 or bf16); with ``prewindowed`` the frames already carry the
  window (any width Wn, e.g. Griffin-Lim's window support) and only the
  norm reads it.  Griffin-Lim takes it for every overlap-add of ``dft_f32``
  and ``dft_hi`` under ``parallel.use_pallas``, prewindowed in the
  window-support layout.  It runs the plain version
  (:func:`overlap_add_plain`) for CPU tensors and the CUDA kernel
  (``csrc/overlap_add.cu``) for CUDA tensors; anything else, or a CUDA
  shape outside the kernel's limits, raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build

# launches of the CUDA kernel (the plain versions do not count)
launches = 0

_INT_MAX = 2**31 - 1
# the kernel stages the window in shared memory: 227 KB of f32
MAX_WINDOW = 232448 // 4


def overlap_add_reference(frames: torch.Tensor, window: torch.Tensor, hop: int,
                          prewindowed: bool = False) -> torch.Tensor:
    """frames [B, F, n_fft], window [n_fft] → normalized OLA [B, out_len]
    (n_fft is any frame width: Griffin-Lim's window support too).

    ``prewindowed``: the synthesis window is already in ``frames``; skip the
    multiply but keep the window-square normalization.
    """
    B, nF, n_fft = frames.shape
    out_len = n_fft + hop * (nF - 1)
    m = -(-n_fft // hop)
    n_pad = m * hop
    wf = frames if prewindowed else frames * window
    wf = F.pad(wf, (0, n_pad - n_fft))
    fr = wf.reshape(B, nF, m, hop)
    Q = nF + m - 1
    out = torch.zeros((B, Q, hop), dtype=frames.dtype, device=frames.device)
    for i in range(m):
        out = out + F.pad(fr[:, :, i, :], (0, 0, i, m - 1 - i))
    sig = out.reshape(B, Q * hop)[:, :out_len]
    return sig / _wsq_norm(window, nF, hop)[None, :out_len]


def _wsq_norm(window: torch.Tensor, nF: int, hop: int) -> torch.Tensor:
    """Window-square normalization via the same static-shift scheme."""
    n_fft = window.shape[0]
    m = -(-n_fft // hop)
    n_pad = m * hop
    w2 = F.pad(window ** 2, (0, n_pad - n_fft))
    w2 = w2.expand(nF, n_pad).reshape(nF, m, hop)
    Q = nF + m - 1
    out = torch.zeros((Q, hop), dtype=window.dtype, device=window.device)
    for i in range(m):
        out = out + F.pad(w2[:, i, :], (0, 0, i, m - 1 - i))
    return torch.clamp(out.reshape(Q * hop), min=1e-10)


def overlap_add_plain(frames: torch.Tensor, window: torch.Tensor, hop: int,
                      prewindowed: bool = False) -> torch.Tensor:
    """Plain version of the kernel: f32 window, sums and norm."""
    return overlap_add_reference(frames.float(), window.float(), hop, prewindowed)


def overlap_add(frames: torch.Tensor, window: torch.Tensor, hop: int,
                prewindowed: bool = False) -> torch.Tensor:
    """frames [B, F, Wn] f32|bf16, window [Wn] → [B, Wn + hop·(F−1)] f32
    (see the module docstring); ``prewindowed``: the window is already in
    ``frames`` and only divides (its square's overlap-add)."""
    if frames.dim() != 3 or window.shape != (frames.shape[-1],):
        raise ValueError(f"overlap_add takes frames [B, F, Wn] and window [Wn]; "
                         f"got {tuple(frames.shape)}, {tuple(window.shape)}")
    B, nF, Wn = frames.shape
    if frames.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"frames must be float32 or bfloat16, got {frames.dtype}")
    if window.device != frames.device:
        raise ValueError(f"window is on {window.device}, frames on {frames.device}")
    if hop < 1 or nF < 1:
        raise ValueError(f"overlap_add: hop={hop}, F={nF} must be at least 1")
    if frames.device.type == "cpu":
        return overlap_add_plain(frames, window, hop, prewindowed)
    if frames.device.type != "cuda":
        raise ValueError(f"overlap_add runs on cpu or cuda, not {frames.device}")
    out_len = Wn + hop * (nF - 1)
    if max(B * nF * Wn, B * out_len) > _INT_MAX:
        raise ValueError("overlap_add kernel: sizes must stay below 2^31 elements")
    if Wn > MAX_WINDOW:
        raise ValueError(f"overlap_add kernel: a window of {Wn} samples does not fit in "
                         f"shared memory (at most {MAX_WINDOW})")
    if not frames.is_contiguous():
        frames = frames.contiguous()
    if window.dtype != torch.float32 or not window.is_contiguous():
        window = window.float().contiguous()
    out = torch.empty((B, out_len), dtype=torch.float32, device=frames.device)
    if B == 0:
        return out
    args = (frames.data_ptr(), window.data_ptr(), out.data_ptr(), B, nF, Wn, hop,
            int(frames.dtype == torch.bfloat16), int(prewindowed))
    launch = _launcher()
    if frames.device.index == torch.cuda.current_device():
        err = launch(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(frames.device):
            err = launch(*args, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "overlap_add kernel launch")
    global launches
    launches += 1
    return out


_launch = None


def _launcher():
    """The library's typed ``overlap_add_launch``, built and looked up once."""
    global _launch
    if _launch is None:
        fn = cuda_build.library("overlap_add").overlap_add_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch
