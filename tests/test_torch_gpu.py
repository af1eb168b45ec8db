"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA device
(the ``cuda`` fixture decides).  This file imports neither JAX nor the JAX
package, so it runs where only PyTorch is installed:

    python -m pytest -m gpu tests/test_torch_*.py

The numpy input cases are shared with the CPU tests of
``test_torch_ops.py``.
"""

import ctypes
import math
from unittest import mock

import numpy as np
import pytest
import torch

from tacotron_multispeaker_torch import config as tconfig
from tacotron_multispeaker_torch.audio.dsp import hann_window
from tacotron_multispeaker_torch.models.modules import _bank_mask
from tacotron_multispeaker_torch.ops import attention_step as tas
from tacotron_multispeaker_torch.ops import conv_bank as tcb
from tacotron_multispeaker_torch.ops import decoder_loop as tdl
from tacotron_multispeaker_torch.ops import gl_iteration as tgl
from tacotron_multispeaker_torch.ops import overlap_add as tola
from tacotron_multispeaker_torch.ops import gru_scan as tgs
from tacotron_multispeaker_torch.ops import teacher_decoder as ttd
from tacotron_multispeaker_torch.ops import wgrad as twg
from tacotron_multispeaker_torch.parallel import make_mesh, run_ranks
from tacotron_multispeaker_torch.synthesizer import Synthesizer


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: python -m pytest -m gpu tests/test_torch_*.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def bigru_inputs(rs, T, B, F, scale=0.3):
    """xg, xc, whg, whc, h0 of ``bigru_scan`` as float32 numpy arrays."""
    f = lambda *s, sc=1.0: (rs.randn(*s) * sc).astype(np.float32)
    return (f(T, 2, B, 2 * F), f(T, 2, B, F), f(2, F, 2 * F, sc=scale),
            f(2, F, F, sc=scale), f(2, B, F, sc=0.1))


def gru_inputs(rs, T, B, F, scale=0.1):
    """xg, xc, whg, whc, h0 of the one-direction ``gru_scan`` as float32
    numpy arrays (time-major, no direction dim)."""
    f = lambda *s, sc=1.0: (rs.randn(*s) * sc).astype(np.float32)
    return (f(T, B, 2 * F, sc=0.5), f(T, B, F, sc=0.5), f(F, 2 * F, sc=scale),
            f(F, F, sc=scale), f(B, F, sc=0.1))


def decoder_case(rs, B, L, n_steps, M=80, P1=64, P2=32, H=128, A=128, D=96,
                 r=2, n_layers=2, scale=0.1):
    """(weights dict, (keys, memory, mask, dm1, dm2, attn_h0, dec_h0),
    n_steps, M) of ``decoder_loop`` as numpy; batch row 0 has the full
    length, the others random lengths; dropout masks keep half at 2.0."""
    f = lambda *s: (rs.randn(*s) * scale).astype(np.float32)
    w = dict(
        w1=f(M, P1), b1=f(P1), w2=f(P1, P2), b2=f(P2),
        a_xg_pn=f(P2, 2 * H), a_xg_ctx=f(D, 2 * H), a_bg=f(2 * H) + 1.0,
        a_xc_pn=f(P2, H), a_xc_ctx=f(D, H), a_bc=f(H),
        a_hg=f(H, 2 * H), a_hc=f(H, H), wq=f(H, A), v=f(A),
        d_h=f(H, H), d_ctx=f(D, H), d_b=f(H),
        l_xg=tuple(f(H, 2 * H) for _ in range(n_layers)),
        l_bg=tuple(f(2 * H) + 1.0 for _ in range(n_layers)),
        l_xc=tuple(f(H, H) for _ in range(n_layers)),
        l_bc=tuple(f(H) for _ in range(n_layers)),
        l_hg=tuple(f(H, 2 * H) for _ in range(n_layers)),
        l_hc=tuple(f(H, H) for _ in range(n_layers)),
        wf=f(H, r * M), bf=f(r * M))
    keys = (rs.randn(B, L, A) * 0.3).astype(np.float32)
    memory = rs.randn(B, L, D).astype(np.float32)
    lengths = np.r_[L, rs.randint(1, L + 1, B - 1)]
    mask = np.arange(L)[None, :] < lengths[:, None]
    dm1 = (rs.binomial(1, 0.5, (n_steps, B, P1)) * 2.0).astype(np.float32)
    dm2 = (rs.binomial(1, 0.5, (n_steps, B, P2)) * 2.0).astype(np.float32)
    attn_h0 = (rs.randn(B, H) * 0.1).astype(np.float32)
    dec_h0 = (rs.randn(n_layers, B, H) * 0.1).astype(np.float32)
    return w, (keys, memory, mask, dm1, dm2, attn_h0, dec_h0), n_steps, M


def teacher_case(rs, S, B, L, H=128, A=128, D=96, n_layers=2, scale=0.1):
    """(weights dict, (png, pnc, h0a, h0d, keys, memory, mask)) of
    ``teacher_decoder`` as float32 numpy (mask bool); batch row 0 has the
    full length, the others random lengths."""
    f = lambda *s, sc=scale: (rs.randn(*s) * sc).astype(np.float32)
    w = dict(a_hg=f(H, 2 * H), a_hc=f(H, H), wq=f(H, A), v=f(A, sc=4 * scale),
             w_ctx=f(D, 4 * H), wd_h=f(H, H), d_b=f(H),
             w_r=tuple(f(H, 3 * H) for _ in range(n_layers)),
             b_r=tuple(f(3 * H) for _ in range(n_layers)),
             hg=tuple(f(H, 2 * H) for _ in range(n_layers)),
             hc=tuple(f(H, H) for _ in range(n_layers)))
    lengths = np.r_[L, rs.randint(1, L + 1, B - 1)]
    mask = np.arange(L)[None, :] < lengths[:, None]
    arrays = (f(S, B, 2 * H, sc=0.5), f(S, B, H, sc=0.5), f(B, H, sc=0.3),
              f(n_layers, B, H, sc=0.3), f(B, L, A, sc=0.3), f(B, L, D, sc=1.0), mask)
    return w, arrays


def conv_bank_case(rs, B, T, D, K, C):
    """x [B, T, D], the masked bank weight [K, D, K*C] and bias [K*C] of
    ``conv_bank`` as float32 numpy (lecun-scaled weight, small bias)."""
    w = rs.randn(K, D, K * C) / np.sqrt(K * D) * _bank_mask(K, C)
    return (rs.randn(B, T, D).astype(np.float32), w.astype(np.float32),
            (rs.randn(K * C) * 0.1).astype(np.float32))


def attention_case(rs, B, L, A, D, loc=True):
    """keys, q, v, memory, mask, location term (or None) of
    ``attention_step`` as numpy (mask bool; row 0 full length)."""
    lengths = np.r_[L, rs.randint(1, L + 1, B - 1)]
    f = lambda *s, sc=1.0: (rs.randn(*s) * sc).astype(np.float32)
    return (f(B, L, A, sc=0.5), f(B, A, sc=0.5), f(A, sc=A ** -0.5), f(B, L, D),
            np.arange(L)[None, :] < lengths[:, None], f(B, L, A, sc=0.3) if loc else None)


def gl_case(rs, B, F, n_fft):
    """wf0 [B, F, n_fft], magT [B, F, bins] and a window [n_fft] of
    ``gl_fast_iterations`` as float32 numpy (the window kept off zero so
    that the window-square norm stays away from its floor)."""
    return (rs.randn(B, F, n_fft).astype(np.float32),
            np.abs(rs.randn(B, F, n_fft // 2 + 1)).astype(np.float32),
            (np.hanning(n_fft) + 0.05).astype(np.float32))


def teacher_weights(w, device="cpu", dtype=torch.float32):
    conv = lambda v: (tuple(torch.from_numpy(t).to(device) for t in v)
                      if isinstance(v, tuple) else torch.from_numpy(v).to(device))
    return ttd.TeacherDecoderWeights(**{k: conv(v) for k, v in w.items()}).cast(dtype)


def teacher_args(arrays, device="cpu", dtype=torch.float32):
    """png, pnc, h0a, h0d, keys, memory, mask as tensors: png/pnc/keys/memory
    in ``dtype``, the initial states f32."""
    png, pnc, h0a, h0d, keys, memory, mask = (torch.from_numpy(a).to(device) for a in arrays)
    return (png.to(dtype), pnc.to(dtype), h0a, h0d, keys.to(dtype), memory.to(dtype), mask)


def split_bwd_reference(xg, xc, hprev, dys, whg, whc):
    """The GRU scan backward's plain parts composed, as the card runs its
    launches: the prologue (``bigru_bwd_remat_reference``), the gradient
    scan (``bigru_bwd_scan_reference``), then the weight gradients from
    their factors (``wgrad_reference``).  Streams [T, D, B, .], weights [D,
    F, .] → f32 (dxg, dxc, dwhg, dwhc, dh0) as ``bigru_scan_bwd_reference``."""
    ruc, rh = tgs.bigru_bwd_remat_reference(xg, xc, hprev, whg, whc)
    dxg, dxc, dh0 = tgs.bigru_bwd_scan_reference(ruc, hprev, dys, whg, whc)
    D = xg.shape[1]
    grads = twg.wgrad_reference([(hprev[:, d], dxg[:, d], False) for d in range(D)]
                                + [(rh[:, d], dxc[:, d], False) for d in range(D)], whg.dtype)
    return (dxg, dxc, torch.stack([c for c, _ in grads[:D]]),
            torch.stack([c for c, _ in grads[D:]]), dh0)


def torch_weights(w, device="cpu"):
    conv = lambda v: (tuple(torch.from_numpy(t).to(device) for t in v)
                      if isinstance(v, tuple) else torch.from_numpy(v).to(device))
    return tdl.DecoderWeights(**{k: conv(v) for k, v in w.items()})


# the forward's routes on the card: the one ``fwd_route`` picks for each
# dtype, and the FMA kernel forced where bf16 takes the tensor cores
FWD_ROUTES = [(torch.float32, "fma", 1e-5), (torch.bfloat16, "mma", 3e-2),
              (torch.bfloat16, "fma", 3e-2)]


def _fwd_on_card(fwd, args, route, dirs):
    """``fwd`` (the public wrapper) when it takes ``route``, else the kernel
    with ``route`` forced; asserts one launch on that route's counter."""
    names = {"mma": "launches" if dirs == 2 else "gru_launches",
             "fma": "fma_launches" if dirs == 2 else "gru_fma_launches"}
    before = {r: getattr(tgs, n) for r, n in names.items()}
    F = args[1].shape[-1]
    ys = (fwd(*args) if tgs.fwd_route(F, args[0].dtype) == route
          else tgs._fwd_kernel(*args, route=route))
    assert {r: getattr(tgs, n) - before[r] for r, n in names.items()} == {
        r: int(r == route) for r in names}
    return ys


@pytest.mark.gpu
@pytest.mark.parametrize("F", [128, 32])
@pytest.mark.parametrize("B", [1, 3, 8, 9, 32])
@pytest.mark.parametrize("dtype,route,tol", FWD_ROUTES)
def test_bigru_kernel_matches_plain_on_card(cuda, dtype, route, tol, B, F):
    # f32: same casts, sums in another order -> 1e-5; bf16: one flipped
    # rounding of a matmul input (ulp 2^-8 near 1), carried by the
    # recurrence -> 3e-2.  B: one row, a partial block of the tensor-core
    # route's 4 rows, two full blocks, one past them, eight blocks
    rs = np.random.RandomState(4)
    args = [torch.from_numpy(a).to(cuda) for a in bigru_inputs(rs, T=33, B=B, F=F,
                                                                scale=0.08)]
    args = [a.to(dtype) for a in args[:4]] + [args[4]]
    ys = _fwd_on_card(tgs.bigru_scan, args, route, dirs=2)
    ref = tgs.bigru_scan_reference(*args)
    torch.cuda.synchronize()
    assert ys.dtype == dtype and ys.shape == ref.shape
    assert (ys.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("D", [96, 384])
@pytest.mark.parametrize("cluster", [None, 1, 2, 4, 8, 16])
@pytest.mark.parametrize("dtype,ftol,atol", [(torch.float32, 1e-4, 1e-5),
                                            (torch.bfloat16, 5e-2, 1e-3)])
def test_decoder_loop_kernel_matches_plain_on_card(cuda, dtype, ftol, atol, cluster, D):
    # L=13 is not a multiple of anything the kernel tiles by, and at C=16
    # some CTAs hold no position, no prenet or context columns; f32 differs
    # only in sum order over 5 contractive steps; bf16 flips roundings of
    # matmul inputs -> frames 5e-2; energies and softmax stay f32 on both
    # sides, so alignments 1e-3 (about 1/75 of a weight at L=13).  cluster
    # None: the launch plan's C; else C forced through the launcher.
    rs = np.random.RandomState(5)
    w, arrays, n_steps, M = decoder_case(rs, B=3, L=13, n_steps=5, D=D)
    tw = torch_weights(w, cuda).cast(dtype)
    targs = [torch.from_numpy(a).to(cuda) for a in arrays]
    targs[0], targs[1] = targs[0].to(dtype), targs[1].to(dtype)
    before = tdl.launches
    if cluster is None:
        f_k, a_k = tdl.decoder_loop(tw, *targs, n_steps, M)
    else:
        f_k, a_k = tdl._decoder_loop_cuda(tw, *targs, n_steps, M, cluster=cluster)
    f_r, a_r = tdl.decoder_loop_reference(tw, *targs, n_steps, M)
    torch.cuda.synchronize()
    assert tdl.launches == before + 1
    if cluster is not None:
        assert tdl.last_plan[0] == cluster
    assert (f_k - f_r).abs().max().item() <= ftol
    assert (a_k - a_r).abs().max().item() <= atol


@pytest.mark.gpu
def test_kernels_raise_outside_their_limits_on_card(cuda):
    rs = np.random.RandomState(6)
    args = [torch.from_numpy(a).to(cuda) for a in bigru_inputs(rs, T=3, B=2, F=520)]
    before = (tgs.launches, tgs.fma_launches, tgs.gru_launches, tgs.gru_fma_launches,
              tgs.gru_bwd_launches)
    with pytest.raises(ValueError, match="1024 threads"):
        tgs.bigru_scan(*args)                                  # 2F > 1024
    uni = [torch.from_numpy(a).to(cuda) for a in gru_inputs(rs, T=3, B=2, F=520)]
    with pytest.raises(ValueError, match="1024 threads"):
        tgs.gru_scan(*uni)
    ys = torch.zeros((3, 2, 520), device=cuda)
    with pytest.raises(ValueError, match="1024 threads"):
        tgs.gru_scan_bwd(*uni[:2], ys, ys, *uni[2:4])
    with pytest.raises(ValueError, match="shared memory"):     # f32 F=200: 480 KB of weights
        tgs.gru_scan(*(torch.from_numpy(a).to(cuda) for a in gru_inputs(rs, 3, 2, 200)))
    with pytest.raises(ValueError, match="contiguous"):
        tgs.gru_scan(uni[0].transpose(0, 1).contiguous().transpose(0, 1), *uni[1:])
    w, arrays, n_steps, M = decoder_case(rs, B=2, L=7, n_steps=3, H=30, A=16, D=24)
    targs = [torch.from_numpy(a).to(cuda) for a in arrays]
    with pytest.raises(ValueError, match="multiple of 4"):
        tdl.decoder_loop(torch_weights(w, cuda), *targs, n_steps, M)   # H=30
    # f32 H=684: 2H fits a width, but a GRU phase's 3H = 2052 columns (513
    # groups of 4) exceed one group a thread at C = 1
    w, arrays, n_steps, M = decoder_case(rs, B=2, L=7, n_steps=3, H=684, A=16, D=24)
    targs = [torch.from_numpy(a).to(cuda) for a in arrays]
    dl_before = tdl.launches
    with pytest.raises(ValueError, match="3H=2052"):
        tdl.decoder_loop(torch_weights(w, cuda), *targs, n_steps, M)
    assert tdl.launches == dl_before
    assert (tgs.launches, tgs.fma_launches, tgs.gru_launches, tgs.gru_fma_launches,
            tgs.gru_bwd_launches) == before
    # the wrapper's shared-memory count is the kernel's own
    for C in tdl.CLUSTER_SIZES:
        for is_bf16, vec in ((0, 4), (1, 8)):
            dims = (ctypes.c_int * 13)(32, 192, 256, 384, 256, 80, 256, 128, 400, 2, 400, C,
                                     is_bf16)
            got = tdl._lib().decoder_loop_smem_bytes(ctypes.cast(dims, ctypes.c_void_p))
            assert got == tdl.smem_bytes(192, 256, 384, 256, 80, 256, 128, 400, 2, C, vec)


@pytest.mark.gpu
def test_synthesizer_on_card_matches_cpu(cuda):
    # f32 tiny model, dropout off, the same Griffin-Lim phases on both
    # devices: the kernels and cuBLAS sum in other orders than the CPU ->
    # alignments 1e-4, waveform 1e-3 of its peak
    cfg = tconfig.get_config("tiny", "model.prenet_dropout=0.0,model.num_speakers=3,"
                             "audio.gl_method=dft_f32,model.max_iters=10")
    cpu = Synthesizer(cfg, device="cpu", seed=4)
    gpu = Synthesizer(cfg, device=cuda, seed=4)
    angles = np.random.RandomState(0).uniform(-math.pi, math.pi, (2, 50, 513))
    before = (tgs.fma_launches, tgs.launches, tdl.launches)
    w_g, a_g = gpu.synthesize_batch(["Hello there.", "Hi."], [1, 2], gl_angles=angles)
    # f32: both BiGRUs on the forward's FMA route
    assert (tgs.fma_launches - before[0], tgs.launches - before[1],
            tdl.launches - before[2]) == (2, 0, 1)
    w_c, a_c = cpu.synthesize_batch(["Hello there.", "Hi."], [1, 2], gl_angles=angles)
    np.testing.assert_allclose(a_g, a_c, atol=1e-4)
    for x, y in zip(w_g, w_c):
        assert x.shape == y.shape
        np.testing.assert_allclose(x, y, atol=1e-3 * np.abs(y).max())


def _err(a, b):
    """max |a - b| relative to max(|b|, 1)."""
    return (a.float() - b.float()).abs().max().item() / max(b.float().abs().max().item(), 1.0)


def _wgrad_launches():
    """The weight-gradient launches so far on each route (tensor cores, FMA)."""
    return twg.launches, twg.fma_launches


def _wgrad_delta(before):
    return tuple(n - b for n, b in zip(_wgrad_launches(), before))


def _wgrad_route(dtype):
    """One backward's weight-gradient launch by route: bf16 takes the tensor
    cores (the backward kernels' factors keep its 16-byte rule), f32 the FMA
    kernel."""
    return (1, 0) if dtype == torch.bfloat16 else (0, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_bigru_backward_kernel_matches_plain_on_card(cuda, dtype, tol):
    # every output of the backward (dxg, dxc, dwhg, dwhc, dh0), relative to
    # its peak: f32 differs in sum order only (the weight gradients sum
    # T*B = 165 rows); bf16 flips roundings of matmul inputs, carried back
    # through the recurrence -> 3e-2
    rs = np.random.RandomState(7)
    args = [torch.from_numpy(a).to(cuda) for a in bigru_inputs(rs, T=33, B=5, F=128,
                                                                scale=0.08)]
    xg, xc, whg, whc = (a.to(dtype) for a in args[:4])
    ys = tgs.bigru_scan(xg, xc, whg, whc, args[4])
    hprev = torch.cat([args[4][None].to(dtype), ys[:-1]]).contiguous()
    dys = torch.from_numpy(rs.randn(*ys.shape).astype(np.float32)).to(cuda).to(dtype)
    before = (tgs.bwd_remat_launches, tgs.bwd_launches, *_wgrad_launches())
    out = tgs.bigru_scan_bwd(xg, xc, hprev, dys, whg, whc)
    ref = tgs.bigru_scan_bwd_reference(xg, xc, hprev, dys, whg, whc)
    torch.cuda.synchronize()
    assert (tgs.bwd_remat_launches - before[0], tgs.bwd_launches - before[1]) == (1, 1)
    assert _wgrad_delta(before[2:]) == _wgrad_route(dtype)
    for name, a, b in zip(("dxg", "dxc", "dwhg", "dwhc", "dh0"), out, ref):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert _err(a, b) <= tol, (name, _err(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("F", [128, 96, 32])
@pytest.mark.parametrize("B", [1, 3, 8, 9, 32])
@pytest.mark.parametrize("dtype,route,tol", FWD_ROUTES)
def test_gru_scan_kernels_match_plain_on_card(cuda, dtype, route, tol, B, F):
    # the one-direction launchers: the forward on ``route`` (f32 1e-5
    # absolute, bf16 one flipped rounding carried -> 3e-2) and the backward
    # with its wgrad launch, every output relative to max(peak, 1) as the
    # bigru backward's (f32 1e-4, bf16 3e-2)
    btol = 1e-4 if dtype == torch.float32 else tol
    rs = np.random.RandomState(12)
    xg, xc, whg, whc, h0 = (torch.from_numpy(a).to(cuda)
                            for a in gru_inputs(rs, T=33, B=B, F=F, scale=0.08))
    xg, xc, whg, whc = (a.to(dtype) for a in (xg, xc, whg, whc))
    before = (tgs.gru_bwd_launches, tgs.launches, tgs.fma_launches,
              tgs.gru_bwd_remat_launches, *_wgrad_launches())
    ys = _fwd_on_card(tgs.gru_scan, (xg, xc, whg, whc, h0), route, dirs=1)
    ref = tgs.gru_scan_reference(xg, xc, whg, whc, h0)
    hprev = torch.cat([h0[None].to(dtype), ys[:-1]]).contiguous()
    dys = torch.from_numpy(rs.randn(*ys.shape).astype(np.float32)).to(cuda).to(dtype)
    out = tgs.gru_scan_bwd(xg, xc, hprev, dys, whg, whc)
    out_r = tgs.gru_scan_bwd_reference(xg, xc, hprev, dys, whg, whc)
    torch.cuda.synchronize()
    assert (tgs.gru_bwd_launches - before[0], tgs.launches - before[1],
            tgs.fma_launches - before[2], tgs.gru_bwd_remat_launches - before[3]) == (1, 0, 0, 1)
    assert _wgrad_delta(before[4:]) == _wgrad_route(dtype)
    assert ys.dtype == dtype and ys.shape == (33, B, F)
    assert (ys.float() - ref.float()).abs().max().item() <= (1e-5 if dtype == torch.float32
                                                             else tol)
    for name, a, b in zip(("dxg", "dxc", "dwhg", "dwhc", "dh0"), out, out_r):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert _err(a, b) <= btol, (name, _err(a, b))


@pytest.mark.gpu
def test_gru_fwd_limits_match_the_kernels_on_card(cuda):
    # the wrapper's shared-memory counts are the library's own, the launcher
    # refuses the tensor-core route wherever ``fwd_route`` does not give it
    # (before touching any pointer), and a forced tensor-core route outside
    # its limits or a misaligned stream raises in the wrapper before any launch
    lib = tgs._lib()
    for F in range(1, 260):
        for dtype, is_bf16, esize in ((torch.float32, 0, 4), (torch.bfloat16, 1, 2)):
            route = tgs.fwd_route(F, dtype)
            if route == "fma":
                assert lib.gru_scan_launch(*[None] * 6, 1, 2, 1, F, is_bf16,
                                           tgs.ROUTES.index("mma"), None) != 0, (F, dtype)
            assert tgs.fwd_smem_bytes(F, esize, "fma") == lib.bigru_scan_smem_bytes(
                F, is_bf16, 0), (F, dtype)
            if route == "mma":
                assert tgs.fwd_smem_bytes(F, esize, "mma") == lib.bigru_scan_smem_bytes(
                    F, is_bf16, 1), F
    rs = np.random.RandomState(15)
    before = (tgs.launches, tgs.fma_launches)
    args = [torch.from_numpy(a).to(cuda) for a in bigru_inputs(rs, T=3, B=2, F=136)]
    bf = [a.to(torch.bfloat16) for a in args[:4]] + [args[4]]
    with pytest.raises(ValueError, match="tensor-core route"):
        tgs._fwd_kernel(*bf, route="mma")                    # F past the register budget
    args = [torch.from_numpy(a).to(cuda) for a in bigru_inputs(rs, T=3, B=2, F=32)]
    with pytest.raises(ValueError, match="tensor-core route"):
        tgs._fwd_kernel(*args, route="mma")                  # f32
    bf = [a.to(torch.bfloat16) for a in args[:4]] + [args[4]]
    xg = torch.empty(bf[0].numel() + 1, dtype=torch.bfloat16, device=cuda)[1:]
    xg = xg.view(bf[0].shape).copy_(bf[0])
    with pytest.raises(ValueError, match="16-byte aligned"):
        tgs.bigru_scan(xg, *bf[1:])
    assert (tgs.launches, tgs.fma_launches) == before


@pytest.mark.gpu
@pytest.mark.parametrize("dirs", [2, 1])
@pytest.mark.parametrize("T,B,F", [(33, 5, 128), (192, 32, 128), (33, 5, 32)])
@pytest.mark.parametrize("dtype,rtol,btol", [(torch.float32, 1e-5, 1e-4),
                                             (torch.bfloat16, 1e-2, 5e-2)])
def test_gru_bwd_prologue_and_both_launches_on_card(cuda, dirs, T, B, F, dtype, rtol, btol):
    # the backward's prologue launch alone, then both launches through
    # bigru_scan_bwd / gru_scan_bwd, against their plain versions.  Shapes:
    # 165 rows a direction (two full 64-row tiles and a partial one), the
    # encoder's T=192 B=32 (96 full tiles), tiny's F=32 (a partial
    # 128-column chunk).  Prologue, each of r, u, c and rh relative to its
    # peak: f32 sum order only -> 1e-5; bf16 both sides round the same
    # inputs, but an order difference can flip the bf16 rounding of r*h_prev
    # (one ulp, 2^-8 of rh) which the candidate's product rounds again ->
    # 1e-2.  The whole backward relative to max(peak, 1): f32 1e-4; bf16
    # flipped roundings carried back through the recurrence -> 5e-2
    rs = np.random.RandomState(T + F + dirs)
    args = [torch.from_numpy(a).to(cuda) for a in bigru_inputs(rs, T=T, B=B, F=F, scale=0.08)]
    if dirs == 1:
        args = [(a[:, 0] if a.dim() == 4 else a[0]).contiguous() for a in args]
    xg, xc, whg, whc = (a.to(dtype) for a in args[:4])
    h0 = args[4]
    ys = (tgs.bigru_scan if dirs == 2 else tgs.gru_scan)(xg, xc, whg, whc, h0)
    hprev = torch.cat([h0[None].to(dtype), ys[:-1]]).contiguous()
    dys = torch.from_numpy(rs.randn(*ys.shape).astype(np.float32)).to(cuda).to(dtype)
    counters = (("bwd_remat_launches", "bwd_launches") if dirs == 2
                else ("gru_bwd_remat_launches", "gru_bwd_launches"))
    count = lambda: tuple(getattr(tgs, c) for c in counters)
    rel = lambda a, b: ((a.float() - b.float()).abs().max()
                        / b.float().abs().max().clamp(min=1e-6)).item()
    before = count()
    ruc, rh = tgs.bwd_remat(xg, xc, hprev, whg, whc)
    plain = (tgs.bigru_bwd_remat_reference(xg, xc, hprev, whg, whc) if dirs == 2 else
             [a[:, 0] for a in tgs.bigru_bwd_remat_reference(
                 xg[:, None], xc[:, None], hprev[:, None], whg[None], whc[None])])
    torch.cuda.synchronize()
    assert tuple(n - b for n, b in zip(count(), before)) == (1, 0)
    assert ruc.dtype == torch.float32 and rh.dtype == dtype and ruc.shape == plain[0].shape
    for k, part in enumerate("ruc"):
        sl = slice(k * F, (k + 1) * F)
        assert rel(ruc[..., sl], plain[0][..., sl]) <= rtol, (part, rel(ruc[..., sl],
                                                                        plain[0][..., sl]))
    assert rel(rh, plain[1]) <= rtol, ("rh", rel(rh, plain[1]))
    bwd, bwd_ref = ((tgs.bigru_scan_bwd, tgs.bigru_scan_bwd_reference) if dirs == 2
                    else (tgs.gru_scan_bwd, tgs.gru_scan_bwd_reference))
    out = bwd(xg, xc, hprev, dys, whg, whc)
    ref = bwd_ref(xg, xc, hprev, dys, whg, whc)
    torch.cuda.synchronize()
    assert tuple(n - b for n, b in zip(count(), before)) == (2, 1)
    for name, a, b in zip(("dxg", "dxc", "dwhg", "dwhc", "dh0"), out, ref):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert _err(a, b) <= btol, (name, _err(a, b))


@pytest.mark.gpu
def test_gru_bwd_limits_match_the_kernels_on_card(cuda):
    # the wrapper's shared-memory counts are the two launches' own, and a
    # width outside the limits raises before any launch
    lib = tgs._bwd_lib()
    for F in (32, 96, 128, 136, 192):
        for is_bf16, esize in ((0, 4), (1, 2)):
            assert tgs.bwd_smem_bytes(F, esize) == (
                lib.bigru_scan_bwd_remat_smem_bytes(F, is_bf16),
                lib.bigru_scan_bwd_smem_bytes(F, is_bf16)), (F, esize)
    rs = np.random.RandomState(14)
    args = [torch.from_numpy(a).to(cuda) for a in bigru_inputs(rs, T=3, B=2, F=100)]
    before = (tgs.bwd_remat_launches, tgs.bwd_launches)
    with pytest.raises(ValueError, match="multiple of 8"):
        tgs.bigru_scan_bwd(args[0], args[1], args[1], args[1], args[2], args[3])
    args = [torch.from_numpy(a).to(cuda) for a in bigru_inputs(rs, T=3, B=2, F=144)]
    with pytest.raises(ValueError, match="shared memory"):
        tgs.bwd_remat(args[0], args[1], args[1], args[2], args[3])   # f32 scan: F > 136
    assert (tgs.bwd_remat_launches, tgs.bwd_launches) == before


@pytest.mark.gpu
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_module_on_card_matches_plain(cuda, reverse):
    # GRU(use_pallas=True) forward and parameter gradients through autograd,
    # f32, ragged lengths: kernel route on the card against the same module
    # on the CPU (plain versions): sums in other orders -> 1e-4 of max(peak, 1)
    from tacotron_multispeaker_torch.models.modules import GRU
    rs = np.random.RandomState(13)
    xs = torch.from_numpy(rs.randn(3, 25, 64).astype(np.float32))
    lengths = torch.tensor([25, 11, 17])
    w = torch.from_numpy(rs.randn(3, 25, 128).astype(np.float32))
    cpu = GRU(64, 128, use_pallas=True)
    gpu = GRU(64, 128, use_pallas=True).to(cuda)
    gpu.load_state_dict(cpu.state_dict())
    before = (tgs.gru_fma_launches, tgs.gru_bwd_launches, twg.fma_launches, twg.launches)
    ys_g = gpu(xs.to(cuda), lengths.to(cuda), reverse=reverse)
    (ys_g * w.to(cuda)).sum().backward()
    torch.cuda.synchronize()
    assert (tgs.gru_fma_launches - before[0], tgs.gru_bwd_launches - before[1],
            twg.fma_launches - before[2], twg.launches - before[3]) == (1, 1, 1, 0)  # f32: FMA
    ys_c = cpu(xs, lengths, reverse=reverse)
    (ys_c * w).sum().backward()
    assert _err(ys_g.cpu(), ys_c) <= 1e-4
    for (n, a), (_, b) in zip(gpu.named_parameters(), cpu.named_parameters()):
        assert _err(a.grad.cpu(), b.grad) <= 1e-4, n


def _teacher_on_card(cuda, dtype, S=6, B=3, L=13, H=128, A=128, D=96, seed=8):
    rs = np.random.RandomState(seed)
    w, arrays = teacher_case(rs, S, B, L, H, A, D)
    return (rs, teacher_weights(w, cuda, dtype), teacher_args(arrays, cuda, dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("S", [6, 150])
@pytest.mark.parametrize("cluster", [None, 1, 2, 4, 8, 16])
@pytest.mark.parametrize("dtype,xtol,atol", [(torch.float32, 1e-4, 1e-5),
                                            (torch.bfloat16, 5e-2, 1e-3)])
def test_teacher_forward_kernel_matches_plain_on_card(cuda, dtype, xtol, atol, cluster, S):
    # L=13 and D=96 are no multiple of the TPU's tiles, and at C=16 some
    # CTAs hold no position and no context column; f32 differs in sum order
    # only; bf16 flips roundings of matmul inputs (xs, states 5e-2),
    # energies and softmax stay f32 on both sides (alignments 1e-3).
    # cluster None: the launch plan's C; else C forced through the launcher
    _, w, args = _teacher_on_card(cuda, dtype, S=S)
    before = ttd.fwd_launches
    if cluster is None:
        out = ttd.teacher_decoder_fwd(*args[:4], w, *args[4:])
    else:
        out = ttd._teacher_fwd_cuda(*args[:4], w, *args[4:], cluster=cluster)
    ref = ttd.teacher_decoder_fwd_reference(*args[:4], w, *args[4:])
    torch.cuda.synchronize()
    assert ttd.fwd_launches == before + 1
    if cluster is not None:
        assert ttd.fwd_last_plan[0] == cluster
    for name, a, b in zip(("xs", "align", "ha"), out[:3], ref[:3]):
        assert _err(a, b) <= (atol if name == "align" else xtol), (name, _err(a, b))
    for a, b in zip(out[3], ref[3]):
        assert _err(a, b) <= xtol
    assert torch.all(out[1][:, ~args[6]] == 0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 5e-2)])
def test_teacher_backward_and_dkeys_kernels_match_plain_on_card(cuda, dtype, tol):
    # the same forward states and cotangents into both backward paths; every
    # gradient by name relative to its peak (f32: sum order over S*B rows;
    # bf16: flipped roundings carried back through the recurrences)
    rs, w, args = _teacher_on_card(cuda, dtype, seed=9)
    png, pnc, h0a, h0d, keys, memory, mask = args
    xs, align, ha, hds = ttd.teacher_decoder_fwd_reference(png, pnc, h0a, h0d, w, keys,
                                                           memory, mask)
    dxs = torch.from_numpy(rs.randn(*xs.shape).astype(np.float32)).to(cuda)
    dal = torch.from_numpy(rs.randn(*align.shape).astype(np.float32)).to(cuda) * 0.1
    before = (ttd.bwd_launches, ttd.dkeys_launches, ttd.bwd_remat_launches,
              *_wgrad_launches())
    out = ttd.teacher_decoder_backward(png, pnc, h0a, h0d, w, keys, memory, mask,
                                       xs, align, ha, hds, dxs, dal)
    with mock.patch.object(ttd, "teacher_decoder_bwd", ttd.teacher_decoder_bwd_reference), \
            mock.patch.object(ttd, "dkeys", ttd.dkeys_reference):
        ref = ttd.teacher_decoder_backward(png, pnc, h0a, h0d, w, keys, memory, mask,
                                           xs, align, ha, hds, dxs, dal)
    torch.cuda.synchronize()
    assert (ttd.bwd_launches - before[0], ttd.dkeys_launches - before[1],
            ttd.bwd_remat_launches - before[2]) == (1, 1, 1)
    assert _wgrad_delta(before[3:]) == _wgrad_route(dtype)
    names = ("dpng", "dpnc", "dh0a", "dh0d")
    for name, a, b in zip(names, out[:4], ref[:4]):
        assert _err(a, b) <= tol, (name, _err(a, b))
    for name, a, b in zip(ttd.TeacherDecoderWeights._fields, out[4], ref[4]):
        for x, y in zip(*((a, b) if isinstance(a, tuple) else ((a,), (b,)))):
            assert _err(x, y) <= tol, (name, _err(x, y))
    for name, a, b in zip(("dkeys", "dmemory", "de", "dctx"), out[5:], ref[5:]):
        assert _err(a, b) <= tol, (name, _err(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
def test_teacher_bwd_remat_kernel_matches_plain_on_card(cuda, dtype, tol):
    # the backward's prologue launch alone, from the plain forward's states,
    # every output relative to max(its peak, 1).  f32: sum order only.  bf16: both
    # sides round the same inputs, but an order difference can flip the
    # bf16 rounding of ctx_prev or r*h_prev, which the next product rounds
    # again (one ulp times a weight, ~1e-3 of the gates)
    rs, w, args = _teacher_on_card(cuda, dtype, seed=11)
    png, pnc, h0a, h0d, keys, memory, mask = args
    xs, align, ha, hds = ttd.teacher_decoder_fwd_reference(png, pnc, h0a, h0d, w, keys,
                                                           memory, mask)
    shift = lambda a, a0: torch.cat([a0[None].to(a.dtype), a[:-1]]).contiguous()
    bargs = (png, pnc, ha, shift(ha, h0a), tuple(hds),
             tuple(shift(hds[i], h0d[i]) for i in range(len(hds))), xs, align,
             shift(align, torch.zeros_like(align[0])), torch.zeros_like(xs),
             torch.zeros_like(align), w, keys, memory, mask)
    before = (ttd.bwd_remat_launches, ttd.bwd_launches)
    out = ttd.teacher_bwd_remat(*bargs)
    ref = ttd.teacher_bwd_remat_reference(*bargs)
    torch.cuda.synchronize()
    assert (ttd.bwd_remat_launches - before[0], ttd.bwd_launches - before[1]) == (1, 0)
    for name, a, b in zip(("xin", "rh", "ruc", "rh_a", "ctx", "q"), out, ref):
        for x, y in zip(*((a, b) if isinstance(b, tuple) else ((a,), (b,)))):
            assert _err(x, y) <= tol, (name, _err(x, y))


@pytest.mark.gpu
@pytest.mark.parametrize("pp_kind", ["shifted", "random"])
@pytest.mark.parametrize("dtype,rtol,btol", [(torch.float32, 1e-5, 2e-4),
                                             (torch.bfloat16, 1e-2, 5e-2)])
def test_teacher_bwd_kernels_over_several_tiles_and_a_given_pp_on_card(cuda, dtype, rtol,
                                                                         btol, pp_kind):
    # S=150: the prologue's blocks take 64 steps of a batch row, so two full
    # tiles (t0 = 0, 64) and a partial one (t0 = 128, 22 steps).  pp is an
    # argument: "random" is not the alignments shifted but random and
    # normalised over each row's keys.  The prologue at its tolerances
    # (see the test above), then both launches, every output of
    # teacher_decoder_bwd at the whole backward's
    rs, w, args = _teacher_on_card(cuda, dtype, S=150, seed=12)
    png, pnc, h0a, h0d, keys, memory, mask = args
    xs, align, ha, hds = ttd.teacher_decoder_fwd_reference(png, pnc, h0a, h0d, w, keys,
                                                           memory, mask)
    shift = lambda a, a0: torch.cat([a0[None].to(a.dtype), a[:-1]]).contiguous()
    if pp_kind == "random":
        r = torch.from_numpy(rs.rand(*align.shape).astype(np.float32)).to(cuda) * mask[None]
        pp = (r / r.sum(-1, keepdim=True)).contiguous()
    else:
        pp = shift(align, torch.zeros_like(align[0]))
    bargs = (png, pnc, ha, shift(ha, h0a), tuple(hds),
             tuple(shift(hds[i], h0d[i]) for i in range(len(hds))), xs, align, pp,
             torch.from_numpy(rs.randn(*xs.shape).astype(np.float32)).to(cuda),
             torch.from_numpy(rs.randn(*align.shape).astype(np.float32)).to(cuda) * 0.1,
             w, keys, memory, mask)
    out = ttd.teacher_bwd_remat(*bargs)
    ref = ttd.teacher_bwd_remat_reference(*bargs)
    torch.cuda.synchronize()
    for name, a, b in zip(("xin", "rh", "ruc", "rh_a", "ctx", "q"), out, ref):
        for x, y in zip(*((a, b) if isinstance(b, tuple) else ((a,), (b,)))):
            assert _err(x, y) <= rtol, (name, _err(x, y))
    before = (ttd.bwd_remat_launches, ttd.bwd_launches)
    out = ttd.teacher_decoder_bwd(*bargs)
    ref = ttd.teacher_decoder_bwd_reference(*bargs)
    torch.cuda.synchronize()
    assert (ttd.bwd_remat_launches - before[0], ttd.bwd_launches - before[1]) == (1, 1)
    for name, a, b in zip(("dpng", "dpnc", "de", "dctx", "dh0a", "dh0d"), out[:6], ref[:6]):
        assert _err(a, b) <= btol, (name, _err(a, b))
    for name, a, b in zip(ttd.TeacherDecoderWeights._fields, out[6], ref[6]):
        if b is not None:
            for x, y in zip(*((a, b) if isinstance(a, tuple) else ((a,), (b,)))):
                assert _err(x, y) <= btol, (name, _err(x, y))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-5)])
def test_wgrad_kernel_matches_plain_on_card(cuda, dtype, tol):
    # the FMA route: strided views (a direction of [T, 2, B, F], a column
    # slice) whose rows are no whole 16-byte vectors (70 and 130 columns),
    # bias sums, 700 rows (split over blocks) and 6 rows (one split); both
    # sides round the factors to the compute dtype and sum in f32, so only
    # the summation order differs (relative 1e-4 for the products, 1e-5 for
    # the sums)
    rs = np.random.RandomState(10)
    big = torch.from_numpy(rs.randn(35, 2, 20, 200).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rs.randn(35, 2, 20, 130).astype(np.float32)).to(cuda)
    problems = [(big[:, 1, :, :70].to(dtype), g[:, 0], True),
                (big[:, 0], g[:, 1, :, 3:67], False)]
    few = (big[:3, 0, :2, :70].to(dtype), g[:3, 1, :2], True)     # 6 rows: one split
    assert twg.route(problems, dtype) == twg.route([few], dtype) == "fma"
    before = _wgrad_launches()
    out = twg.wgrad(problems, dtype) + twg.wgrad([few], dtype)
    ref = twg.wgrad_reference(problems, dtype) + twg.wgrad_reference([few], dtype)
    torch.cuda.synchronize()
    assert _wgrad_delta(before) == (0, 2)
    for (c, bias), (c_r, bias_r) in zip(out, ref):
        assert _err(c, c_r) <= 10 * tol and (bias is None) == (bias_r is None)
        if bias is not None:
            assert _err(bias, bias_r) <= tol


def _rel(a, b):
    """max |a - b| relative to max |b|."""
    return (a.float() - b.float()).abs().max().item() / b.float().abs().max().item()


def _wgrad_tc_problems(rs, cuda):
    """Problems that keep the tensor-core route's 16-byte rule, in one
    launch: ragged K (40, 200, 264, 16) and N (72, 136, 8), rows 700, 33, 1
    and 2100, strided views of [T, 2, B, F] with 16-byte-aligned column
    slices, f32 and bf16 factors mixed, biases."""
    f = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32)).to(cuda)
    big, gbig = f(35, 2, 20, 200), f(35, 2, 20, 140)
    return [(big[:, 1, :, 8:48], gbig[:, 0, :, 4:76], True),
            (big[:, 0].to(torch.bfloat16), gbig[:, 1, :, :136], False),
            (f(3, 11, 264).to(torch.bfloat16), f(3, 11, 8), True),
            (f(1, 1, 16), f(1, 1, 8).to(torch.bfloat16), True),
            (f(300, 7, 128).to(torch.bfloat16), f(300, 7, 256), False)]


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [None, 1, 5])
def test_wgrad_tensor_core_route_matches_plain_on_card(cuda, splits):
    # bf16 rounding on the tensor cores: both sides multiply the same
    # rounded factors exactly in f32 and differ in summation order only
    # (1e-4 of each product's peak, 1e-5 of each bias's); one row range,
    # the plan's and five; a second launch equal bit for bit (no atomics)
    problems = _wgrad_tc_problems(np.random.RandomState(14), cuda)
    assert twg.route(problems, torch.bfloat16) == "mma"
    before = _wgrad_launches()
    out = twg.wgrad(problems, torch.bfloat16, splits=splits)
    again = twg.wgrad(problems, torch.bfloat16, splits=splits)
    ref = twg.wgrad_reference(problems, torch.bfloat16)
    torch.cuda.synchronize()
    assert _wgrad_delta(before) == (2, 0)
    for (c, bias), (c2, bias2), (c_r, bias_r) in zip(out, again, ref):
        assert torch.equal(c, c2) and (bias is None or torch.equal(bias, bias2))
        assert _rel(c, c_r) <= 1e-4 and (bias is None) == (bias_r is None)
        if bias is not None:
            assert _rel(bias, bias_r) <= 1e-5


@pytest.mark.gpu
def test_wgrad_routes_refuse_what_their_rule_excludes_on_card(cuda):
    rs = np.random.RandomState(15)
    problems = _wgrad_tc_problems(rs, cuda)
    # a misaligned view (a row starting 4 bytes into a 16-byte vector) turns
    # the launch to the FMA route; the launcher itself refuses such a factor
    bad = problems[:1] + [(problems[1][0], problems[1][1][..., 1:133], False)]
    assert twg.route(bad, torch.bfloat16) == "fma"
    before = _wgrad_launches()
    out = twg.wgrad(bad, torch.bfloat16)
    ref = twg.wgrad_reference(bad, torch.bfloat16)
    torch.cuda.synchronize()
    assert _wgrad_delta(before) == (0, 1)
    assert all(_rel(c, c_r) <= 1e-4 for (c, _), (c_r, _) in zip(out, ref))
    a, g = bad[1][0], bad[1][1]
    c = torch.empty((a.shape[-1], g.shape[-1]), device=cuda)
    desc = twg._Problem(a.data_ptr(), g.data_ptr(), c.data_ptr(), None, a.stride(0),
                        a.stride(1), g.stride(0), g.stride(1), a.shape[0], a.shape[1],
                        a.shape[-1], g.shape[-1], 1, 0)
    arr = ctypes.cast((twg._Problem * 1)(desc), ctypes.c_void_p)
    lib = twg._lib()
    assert lib.wgrad_tc_launch(arr, 1, 1, None, torch.cuda.current_stream().cuda_stream) != 0
    # the wrapper's shared-memory count and the one block an SM its plan
    # assumes are the kernel's own
    assert lib.wgrad_tc_smem_bytes() == twg.tc_smem_bytes()
    assert lib.wgrad_tc_blocks_per_sm() == 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,A,scale", [(1, 7, 256, None), (3, 37, 256, 40.0),
                                         (2, 13, 100, 40.0), (2, 21, 300, None)])
def test_dkeys_kernel_matches_plain_on_card(cuda, dtype, B, L, A, scale):
    # B=1; L=37 and 13, no multiple of the block's 16 positions; A=100 (a
    # partial warp) and 300 (more than 256 threads: the 1024-thread
    # instance); scale 40: keys and q uniform in [-40, 40], so most
    # elements take the guarded tanhf and the rest reach k + q = +-40.
    # Relative to the peak: sum order and a few ulp of tanh -> 1e-4; a
    # second launch equal bit for bit
    rs = np.random.RandomState(16)
    S = 50
    if scale is None:
        keys, q = rs.randn(B, L, A) * 0.3, rs.randn(S, B, A)
    else:
        keys, q = rs.uniform(-scale, scale, (B, L, A)), rs.uniform(-scale, scale, (S, B, A))
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(cuda)
    keys, q = t(keys).to(dtype), t(q)
    de, v = t(rs.randn(S, B, L) * 1e-2), t(rs.randn(A) * 0.2).to(dtype)
    before = ttd.dkeys_launches
    dk, dv = ttd.dkeys(keys, q, de, v)
    dk2, dv2 = ttd.dkeys(keys, q, de, v)
    dk_r, dv_r = ttd.dkeys_reference(keys, q, de, v)
    torch.cuda.synchronize()
    assert ttd.dkeys_launches == before + 2
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert _rel(dk, dk_r) <= 1e-4 and _rel(dv, dv_r) <= 1e-4


@pytest.mark.gpu
def test_training_kernels_raise_outside_their_limits_on_card(cuda):
    rs = np.random.RandomState(11)
    args = [torch.from_numpy(a).to(cuda) for a in bigru_inputs(rs, T=3, B=2, F=520)]
    ys = torch.zeros((3, 2, 2, 520), device=cuda)
    with pytest.raises(ValueError, match="1024 threads"):
        tgs.bigru_scan_bwd(*args[:2], ys, ys, *args[2:4])             # 2F > 1024
    w, arrays = teacher_case(rs, S=3, B=2, L=5, H=30, A=16, D=24)
    with pytest.raises(ValueError, match="multiple of 4"):             # H=30
        ttd.teacher_decoder_fwd(*teacher_args(arrays, cuda)[:4], teacher_weights(w, cuda),
                                *teacher_args(arrays, cuda)[4:])
    # f32 H=400: every width fits a block, but the context block's 4H = 1600
    # columns exceed one 16-byte group a thread of a CTA at C = 1
    w, arrays = teacher_case(rs, S=3, B=2, L=5, H=400, A=16, D=24)
    fwd_before = ttd.fwd_launches
    with pytest.raises(ValueError, match="4H=1600"):
        ttd.teacher_decoder_fwd(*teacher_args(arrays, cuda)[:4], teacher_weights(w, cuda),
                                *teacher_args(arrays, cuda)[4:])
    assert ttd.fwd_launches == fwd_before
    # the wrapper's shared-memory count is the forward kernel's own
    lib = ttd._lib("teacher_decoder_fwd")
    for C in ttd.CLUSTER_SIZES:
        for is_bf16, vec in ((0, 4), (1, 8)):
            dims = (ctypes.c_int * 9)(200, 32, 192, 256, 384, 256, 2, is_bf16, C)
            got = lib.teacher_decoder_fwd_smem_bytes(ctypes.cast(dims, ctypes.c_void_p))
            assert got == ttd.fwd_smem_bytes(192, 256, 384, 256, 2, C, vec)
    keys = torch.zeros((2, 5, 1040), device=cuda)
    with pytest.raises(ValueError, match="1024 threads"):
        ttd.dkeys(keys, torch.zeros((3, 2, 1040), device=cuda),
                  torch.zeros((3, 2, 5), device=cuda), torch.zeros(1040, device=cuda))
    with pytest.raises(ValueError, match="problems"):
        a = torch.zeros((2, 2, 4), device=cuda)
        twg.wgrad([(a, a, False)] * 25, torch.float32)


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu(cuda):
    # f32 tiny model, dropout off, one step on each device from the same
    # weights and batch: the kernels and cuBLAS sum in other orders than the
    # CPU -> loss and grad norm 1e-4 relative; parameters after the update
    # 1e-5 absolute (Adam's first step moves each by lr = 2e-5 times
    # g/(|g| + 1e-6), which the two devices' gradients agree on)
    from tacotron_multispeaker_torch import training
    cfg = tconfig.get_config("tiny", "model.prenet_dropout=0.0,model.num_speakers=3")
    rs = np.random.RandomState(0)
    batch = train_batch(rs, cfg, B=2, L=11, T=20)
    results = []
    for dev in ("cpu", cuda):
        model, state = training.create_train_state(cfg, seed=3, device=dev)
        step = training.make_train_step(cfg, model)
        state, metrics = step(state, *(torch.from_numpy(a).to(dev) for a in batch))
        results.append((metrics, {k: v.detach().cpu() for k, v in model.state_dict().items()}))
    (m_c, p_c), (m_g, p_g) = results
    for k in ("loss", "grad_norm"):
        assert abs(m_g[k].item() - m_c[k].item()) <= 1e-4 * abs(m_c[k].item()), k
    for k in p_c:
        assert (p_g[k] - p_c[k]).abs().max().item() <= 1e-5, k


def train_batch(rs, cfg, B, L, T, vocab=60):
    """A batch in the Feeder's layout (numpy): inputs [B, L], input_lengths,
    mel_targets [B, T, M], linear_targets [B, T, num_freq], target_lengths,
    speaker_ids; row 0 full length, the others shorter; targets in [0, 1]."""
    r = cfg.model.outputs_per_step
    in_len = np.r_[L, rs.randint(1, L + 1, B - 1)]
    tg_len = np.r_[T, r * rs.randint(1, T // r + 1, B - 1)]
    inputs = rs.randint(2, vocab, (B, L)) * (np.arange(L)[None] < in_len[:, None])
    mel = rs.uniform(0, 1, (B, T, cfg.audio.num_mels)).astype(np.float32)
    lin = rs.uniform(0, 1, (B, T, cfg.audio.num_freq)).astype(np.float32)
    spk = rs.randint(0, max(cfg.model.num_speakers, 1), B)
    return (inputs.astype(np.int64), in_len.astype(np.int64), mel, lin,
            tg_len.astype(np.int64), spk.astype(np.int64))


def _card(arrays, cuda, dtype=None):
    """numpy arrays → card tensors (float arrays in ``dtype`` when given)."""
    out = []
    for a in arrays:
        t = None if a is None else torch.from_numpy(a).to(cuda)
        if t is not None and dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out.append(t)
    return out


def _conv_bank_close(y, ref, dtype):
    # f32: the same products summed in another order -> 1e-5 of the peak;
    # bf16: exact products, and that sum-order difference may move the final
    # rounding by one ulp
    if dtype == torch.float32:
        assert _err(y, ref) <= 1e-5
    else:
        peak = ref.float().abs().max().item()
        torch.testing.assert_close(y.float(), ref.float(), rtol=2 ** -7, atol=1e-5 * peak)


CONV_BANK_CARD_CASES = {
    # (B, T, D, K, C, masked w); no T is a multiple of the 128- or 192-row tile
    "encoder": (4, 37, 128, 16, 128, True),     # the encoder bank's widths
    "post-net": (2, 200, 80, 8, 128, True),     # the post-net's: D = 80, narrow A
    "odd-K": (3, 50, 64, 5, 128, True),
    "B=1": (1, 96, 128, 16, 128, True),
    # groups narrower than a bf16 tile, an unmasked w, D zero-filled to 32
    "narrow-groups": (2, 45, 24, 4, 32, False),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("case", list(CONV_BANK_CARD_CASES))
def test_conv_bank_kernel_matches_plain_on_card(cuda, case, with_mask, dtype):
    B, T, D, K, C, masked = CONV_BANK_CARD_CASES[case]
    rs = np.random.RandomState(12)
    x, w, b = _card(conv_bank_case(rs, B, T, D, K, C), cuda, dtype)
    if not masked:
        w = torch.from_numpy(rs.randn(K, D, K * C).astype(np.float32) / np.sqrt(K * D)).to(
            cuda, dtype)
    bc = C if with_mask else None
    before = tcb.launches
    with torch.inference_mode():
        y = tcb.conv_bank(x, w, b, bank_channels=bc)
        ref = tcb.conv_bank_reference(x, w, b, bank_channels=bc)
    torch.cuda.synchronize()
    assert tcb.launches == before + 1 and y.dtype == dtype and y.shape == (B, T, K * C)
    _conv_bank_close(y, ref, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [80, 128])
@pytest.mark.parametrize("layout", list(tcb.LAYOUTS))
def test_conv_bank_bf16_layouts_match_plain_on_card(cuda, D, layout):
    # both A-operand layouts of the bf16 kernel, whichever the launcher takes
    rs = np.random.RandomState(13)
    x, w, b = _card(conv_bank_case(rs, 2, 130, D, 8, 128), cuda, torch.bfloat16)
    with torch.inference_mode():
        y = tcb._launch(x, w, b, 128, layout=layout)
        ref = tcb.conv_bank_reference(x, w, b, bank_channels=128)
    torch.cuda.synchronize()
    _conv_bank_close(y, ref, torch.bfloat16)


@pytest.mark.gpu
def test_conv_bank_raises_outside_its_limits_on_card(cuda):
    # bf16 TMA tiles need D and O multiples of 8; no fallback, no launch
    rs = np.random.RandomState(14)
    x, w, b = _card(conv_bank_case(rs, 2, 9, 12, 4, 8), cuda, torch.bfloat16)
    before = tcb.launches
    with pytest.raises(ValueError, match="multiples of 8"):
        tcb.conv_bank(x, w, b, bank_channels=8)
    assert tcb.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol_al,tol_ctx", [(torch.float32, 1e-6, 1e-5),
                                                  (torch.bfloat16, 1e-3, 1e-2)])
@pytest.mark.parametrize("loc", [False, True])
def test_attention_step_kernel_matches_plain_on_card(cuda, dtype, tol_al, tol_ctx, loc):
    # full width (L=192, A=256, D=320), ragged lengths.  f32: sum order only.
    # bf16: the act roundings are the same on both sides unless tanhf and
    # torch's tanh differ by an f32 ulp at a bf16 rounding boundary
    rs = np.random.RandomState(13)
    args = _card(attention_case(rs, 8, 192, 256, 320, loc), cuda, dtype)
    args[4] = args[4].bool()
    before = tas.launches
    ctx, al = tas.attention_step(*args)
    ctx_r, al_r = tas.attention_step_reference(*args)
    torch.cuda.synchronize()
    assert tas.launches == before + 1
    assert torch.all(al[~args[4]] == 0.0)
    assert (al - al_r).abs().max().item() <= tol_al
    assert (ctx - ctx_r).abs().max().item() <= tol_ctx


def _attention_sizes(counts, L):
    """None (the plan's C) and every C the card holds at these widths."""
    return [None] + [C for C in tas.CLUSTER_SIZES if C <= L and counts[C] > 0]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol_al,tol_ctx", [(torch.float32, 1e-6, 1e-5),
                                                  (torch.bfloat16, 1e-3, 1e-2)])
@pytest.mark.parametrize("loc", [False, True])
@pytest.mark.parametrize("B,L,A,D", [(1, 1, 256, 320), (1, 96, 256, 320), (3, 13, 256, 320),
                                     (32, 192, 256, 320), (1, 192, 256, 320),
                                     (3, 13, 100, 72), (3, 96, 100, 72)])
def test_attention_step_kernel_matches_plain_at_every_cluster_size_on_card(
        cuda, dtype, tol_al, tol_ctx, loc, B, L, A, D):
    # each batch row over a cluster of C CTAs split along L, at the plan's C
    # and at every C the card takes; ragged rows and (B > 1) a fully masked
    # one.  A=100, D=72 bf16 rows are not 16-byte multiples: the direct
    # route.  Tolerances as above
    rs = np.random.RandomState(19 + B + L)
    args = _card(attention_case(rs, B, L, A, D, loc), cuda, dtype)
    if B > 1:
        args[4][1] = False
    args[4] = args[4].bool()
    ref = tas.attention_step_reference(*args)
    esize = args[0].element_size()
    aligned = tas.rows_aligned(A, D, esize)
    counts = tas.cluster_counts(L, A, D, int(dtype == torch.bfloat16), loc, 0, aligned,
                                args[0].device)
    for C in _attention_sizes(counts, L):
        before = (tas.launches, tas.direct_launches)
        ctx, al = tas.attention_step(*args, cluster=C)
        torch.cuda.synchronize()
        ran, route, _ = tas.last_plan
        staged = tas.staged_route(L, A, D, ran, esize, loc, aligned)
        assert route == ("staged" if staged else "direct") and (C is None or ran == C)
        assert (tas.launches, tas.direct_launches) == (before[0] + 1, before[1] + (not staged))
        assert torch.all(al[~args[4]] == 0.0), C
        assert (al - ref[1]).abs().max().item() <= tol_al, C
        assert (ctx - ref[0]).abs().max().item() <= tol_ctx, C
        if B > 1:
            assert torch.all(ctx[1] == 0.0) and torch.all(al[1] == 0.0), C
        _assert_repeatable(tas.attention_step, args, ran, (ctx, al))


def _assert_repeatable(fn, args, C, first, n=10):
    """n more launches at cluster C give the first one's outputs bit for
    bit: the kernel's sums run in a fixed order, so a launch that differs
    shows a race between its warps or CTAs."""
    for i in range(n):
        got = fn(*args, cluster=C)
        assert all(torch.equal(a, b) for a, b in zip(got, first)), (C, i)


@pytest.mark.gpu
def test_attention_step_smem_mirror_and_cluster_checks_on_card(cuda):
    # the Python mirror of a CTA's shared memory is the kernel's own count,
    # on both routes at every C; a C the kernel does not take raises
    for L, A, D, esize, loc in ((192, 256, 320, 2, True), (48, 256, 384, 4, False),
                                (13, 100, 72, 2, True), (1, 8, 4, 4, False)):
        for C in tas.CLUSTER_SIZES:
            for staged in (False, True):
                assert tas.smem_bytes(L, A, D, C, esize, loc, staged) == tas.kernel_smem_bytes(
                    L, A, D, C, esize, loc, staged), (L, A, D, C, staged)
    rs = np.random.RandomState(20)
    args = _card(attention_case(rs, 2, 13, 256, 320, True), cuda, torch.bfloat16)
    args[4] = args[4].bool()
    before = tas.launches
    for C in (3, 32, 16):                   # not a cluster size; past L=13
        with pytest.raises(ValueError, match="no cluster"):
            tas.attention_step(*args, cluster=C)
    assert tas.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_overlap_add_kernel_matches_plain_on_card(cuda, dtype):
    # n_fft 2048, hop 275 (m = 8 frames per sample, hop not dividing
    # n_fft); f32 window, sums and norm on both sides -> 1e-5 of the peak
    rs = np.random.RandomState(14)
    frames = torch.from_numpy(rs.randn(3, 41, 2048).astype(np.float32)).to(cuda).to(dtype)
    win = torch.from_numpy((np.hanning(2048) + 0.05).astype(np.float32)).to(cuda)
    before = tola.launches
    out = tola.overlap_add(frames, win, 275)
    ref = tola.overlap_add_plain(frames, win, 275)
    torch.cuda.synchronize()
    assert tola.launches == before + 1 and out.shape == (3, 2048 + 275 * 40)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def ola_case(rs, B, F, Wn, prewindowed, dtype, device, win_length=1102):
    """(frames [B, F, Wn] in ``dtype``, window [Wn] f32) on ``device``: the
    serving window (Hann of ``win_length``, centred in Wn zeros when Wn is
    larger); prewindowed frames are randn × window, as the inverse DFT
    product gives them (bare randn would put ~1e10 at the norm's clamp)."""
    win = hann_window(min(win_length, Wn), Wn)
    frames = rs.randn(B, F, Wn).astype(np.float32) * (win if prewindowed else 1.0)
    return (torch.from_numpy(frames).to(device).to(dtype), torch.from_numpy(win).to(device))


def _ola_close(out, ref):
    # window, sums and norm f32 on both sides, the same sums in the same
    # order (decreasing f, unfused products): 1e-5 a sample, relative, and
    # absolute for the O(1) interior; the edges divide by a norm near the
    # clamp and reach ~1e5, so a peak-relative bound alone would be loose
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    assert ((out - ref).abs() <= 1e-5 + 1e-5 * ref.abs()).all(), (out - ref).abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 3, 32])
@pytest.mark.parametrize("F", [1, 2, 1000])
@pytest.mark.parametrize("Wn", [1102, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("prewindowed", [False, True])
def test_overlap_add_kernel_both_modes_match_plain_on_card(cuda, prewindowed, dtype, Wn, F, B):
    # Griffin-Lim's geometries: the 1102-sample window support and the
    # 2048-sample frame, hop 275 dividing neither (m = 5 and 8 frames a
    # sample); one launch a call
    rs = np.random.RandomState(Wn + F + B)
    frames, win = ola_case(rs, B, F, Wn, prewindowed, dtype, cuda)
    before = tola.launches
    out = tola.overlap_add(frames, win, 275, prewindowed=prewindowed)
    assert tola.launches == before + 1
    ref = tola.overlap_add_plain(frames, win, 275, prewindowed=prewindowed)
    torch.cuda.synchronize()
    assert out.shape == (B, Wn + 275 * (F - 1))
    _ola_close(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("Wn,hop,F", [
    (2048, 200, 9),       # m = 11: past the unrolled builds, the loop
    (2048, 64, 40),       # m = 32
    (16384, 4000, 6),     # a 64 KB window: dynamic shared memory past 48 KB
    (100, 300, 7),        # hop past the frame: gaps where the norm clamps
    (7, 3, 5),            # narrower than a warp
    (1102, 5000, 1),      # one frame: hop unused
])
@pytest.mark.parametrize("prewindowed", [False, True])
def test_overlap_add_kernel_other_geometries_on_card(cuda, prewindowed, Wn, hop, F):
    rs = np.random.RandomState(Wn + F)
    frames, win = ola_case(rs, 3, F, Wn, prewindowed, torch.float32, cuda, win_length=Wn - 1)
    out = tola.overlap_add(frames, win, hop, prewindowed=prewindowed)
    _ola_close(out, tola.overlap_add_plain(frames, win, hop, prewindowed=prewindowed))


@pytest.mark.gpu
def test_overlap_add_kernel_raises_outside_its_limits_on_card(cuda):
    frames = torch.zeros(1, 1, 2048, device=cuda)
    win = torch.ones(2048, device=cuda)
    lib = tola.cuda_build.library("overlap_add")
    assert lib.overlap_add_max_window() == tola.MAX_WINDOW
    before = tola.launches
    with pytest.raises(ValueError, match="2\\^31"):    # B*F*Wn = 2^31 (a stride-0 view)
        tola.overlap_add(frames.expand(2**10, 2**10, 2048), win, 2048)
    with pytest.raises(ValueError, match="2\\^31"):    # out_len past 2^31
        tola.overlap_add(frames.expand(1, 3, 2048), win, 2**30, prewindowed=True)
    big = tola.MAX_WINDOW + 1
    with pytest.raises(ValueError, match="shared memory"):
        tola.overlap_add(torch.zeros(1, 2, big, device=cuda), torch.ones(big, device=cuda), 4)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tola.overlap_add(frames.half(), win, 275)
    assert tola.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("window,B,F,n_iters", [
    ("no_zero", 2, 45, 3),
    ("no_zero", 2, 45, 2), ("serving", 2, 45, 2),
    ("no_zero", 1, 1000, 2), ("serving", 1, 1000, 2)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.bfloat16, 3e-2)])
def test_gl_iteration_kernel_matches_plain_on_card(cuda, dtype, tol, window, B, F, n_iters):
    # n_fft 2048, hop 275, iterations with momentum; each output relative to
    # its peak.  Windows: one with no zero (the whole frame) and the serving
    # one (zero outside [474, 1575): the kernels work inside its support
    # from iteration 2 on, while wf0 is random on the whole frame).  Frames:
    # B*F not a multiple of the 128-row tile (B=2, F=45), and a B=1
    # request's 1000.  f32: sum order only, lightly amplified where |S| ~ 0;
    # bf16: flipped roundings carried by the chaotic phase estimate (the JAX
    # test's 3e-2).  The first case is this test's original one; the others
    # take 2 iterations, as chip_smoke.py's elementwise checks do: at 3, 1-4
    # bf16 elements of the serving-window and F=1000 cases pass 3e-2 of the
    # peak in the kernel of before the support restriction and in this one
    # alike (norm-wise errors 1e-3), while at 2 the worst is 1.7e-3
    rs = np.random.RandomState(15)
    wf0, mag, win = _card(gl_case(rs, B, F, 2048), cuda)
    if window == "serving":
        win = torch.from_numpy(hann_window(1102, 2048)).to(cuda)
    wf0 = wf0.to(dtype)
    before = tgl.launches
    out = tgl.gl_fast_iterations(wf0, mag, win, 275, n_iters, 0.99 / 1.99)
    ref = tgl.gl_fast_iterations_reference(wf0, mag, win, 275, n_iters, 0.99 / 1.99)
    torch.cuda.synchronize()
    assert tgl.launches == before + 1
    for name, a, b in zip(("sre", "sim", "pre", "pim"), out, ref):
        assert (a - b).abs().max().item() <= tol * b.abs().max().item(), name


@pytest.mark.gpu
def test_gl_iteration_bf16_plan(cuda):
    # the launch chip_smoke.py logs: each product's wgmma tile, its consumer
    # warpgroups (64 rows each), a ring of at least two stages that holds
    # the staged f32 tile, and the serving window's support rounded
    # out to the 64-sample k-block
    win = hann_window(1102, 2048)
    plan = tgl.bf16_plan(torch.from_numpy(win).to(cuda))
    for name in ("forward", "inverse"):
        p = plan[name]
        rows = 64 * p["warpgroups"]
        assert p["tile"] == f"wgmma m64n128k16, {rows} x 128 x 64", name
        stage = (rows + 128) * 64 * 2                     # A and B boxes, bf16
        assert p["stages"] >= 2 and p["stages"] * stage >= rows * 136 * 4, name
        assert p["stages"] * stage < p["smem_bytes"] <= 232448, name
    assert plan["support"] == tgl.window_support(win) == (448, 1600)


def _attention_limit_L(A, D):
    """The longest L the attention kernel takes at f32 widths A, D: a CTA of
    16 holds 4 + 2A + ceil(L/16) + 32 + 16 * ceil(D/16) floats (the first
    4: the exchanges' two mbarriers)."""
    last = 16 * (232448 // 4 - (4 + 2 * A + 2 * 16 + 16 * -(-D // 16)))
    assert tas.kernel_takes(last, A, D, 4, False) and not tas.kernel_takes(last + 1, A, D, 4,
                                                                           False)
    return last


@pytest.mark.gpu
def test_attention_step_runs_at_its_limit_on_card(cuda):
    # the longest L (one row, A=8, D=4 f32, C=16 on the direct route: its
    # slab does not fit) matches its plain version, and the first design's
    # refused L=60000 runs (C=16, staged)
    for L in (60000, _attention_limit_L(8, 4)):
        rs = np.random.RandomState(21)
        args = _card(attention_case(rs, 1, L, 8, 4, False), cuda)
        args[4] = args[4].bool()
        ctx, al = tas.attention_step(*args)
        ctx_r, al_r = tas.attention_step_reference(*args)
        torch.cuda.synchronize()
        assert tas.last_plan[0] == 16, L
        assert (al - al_r).abs().max().item() <= 1e-6
        assert (ctx - ctx_r).abs().max().item() <= 1e-4      # sums of ~1e6 weights


@pytest.mark.gpu
def test_serve_kernels_raise_outside_their_limits_on_card(cuda):
    rs = np.random.RandomState(16)
    # the attention step's limit: even at C = 16 a CTA's energies (ceil(L/16)
    # floats) with q, v and the exchange do not fit (L=60000, which the first
    # design refused, now runs at C >= 2)
    L = _attention_limit_L(8, 4) + 1
    keys, q, v, mem, mask, _ = _card(attention_case(rs, 1, L, 8, 4, False), cuda)
    before = (tas.launches, tcb.launches, tgl.launches)
    with pytest.raises(ValueError, match="shared memory"):
        tas.attention_step(keys, q, v, mem, mask.bool())
    x, w, b = _card(conv_bank_case(rs, 1, 8, 4, 3, 2), cuda)
    with pytest.raises(RuntimeError, match="inference-only"):
        tcb.conv_bank(x, w.requires_grad_(True), b)
    wf0, mag, win = _card(gl_case(rs, 1, 4, 64), cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tgl.gl_fast_iterations(wf0.half(), mag, win, 16, 2, 0.0)
    assert (tas.launches, tcb.launches, tgl.launches) == before


@pytest.mark.gpu
@pytest.mark.parametrize("overrides,launches", [
    # kernel-gated Bahdanau: both conv banks, the fused decode, one fused
    # Griffin-Lim call (dft_mix)
    ("", {"conv_bank": 2, "decoder_loop": 1, "gl_iteration": 1,
          "attention_step": 0, "overlap_add": 0}),
    # location attention, exact Griffin-Lim: one attention step a decoder
    # step, one OLA per iteration and the initial one
    ("model.attention_type=location,audio.gl_method=dft_f32,audio.griffin_lim_iters=4,"
     "audio.gl_momentum=0.0", {"conv_bank": 2, "decoder_loop": 0, "gl_iteration": 0,
                               "attention_step": 10, "overlap_add": 5}),
])
def test_synthesizer_with_use_pallas_on_card(cuda, overrides, launches):
    # f32 tiny model, dropout off, the same phases on both devices.  The
    # location path (all f32) is held to the CPU as the default path is
    # above; the dft_mix path runs bf16 Griffin-Lim iterations, whose
    # chaotic phase estimate lets the two devices' sum orders drift, so its
    # waveform is held by energy (within 5%) and finiteness
    cfg = tconfig.get_config("tiny", "model.prenet_dropout=0.0,model.num_speakers=3,"
                             "model.max_iters=10,parallel.use_pallas=true"
                             + ("," + overrides if overrides else ""))
    mods = {"conv_bank": tcb, "decoder_loop": tdl, "gl_iteration": tgl,
            "attention_step": tas, "overlap_add": tola}
    cpu = Synthesizer(cfg, device="cpu", seed=4)
    gpu = Synthesizer(cfg, device=cuda, seed=4)
    angles = np.random.RandomState(1).uniform(-math.pi, math.pi, (2, 50, 513))
    before = {k: m.launches for k, m in mods.items()}
    w_g, a_g = gpu.synthesize_batch(["Hello there.", "Hi."], [1, 2], gl_angles=angles)
    assert {k: m.launches - before[k] for k, m in mods.items()} == launches
    w_c, a_c = cpu.synthesize_batch(["Hello there.", "Hi."], [1, 2], gl_angles=angles)
    np.testing.assert_allclose(a_g, a_c, atol=1e-4)
    for x, y in zip(w_g, w_c):
        assert x.shape == y.shape and np.isfinite(x).all()
        if "dft_f32" in overrides:
            np.testing.assert_allclose(x, y, atol=1e-3 * np.abs(y).max())
        else:
            assert abs(np.square(x).sum() / np.square(y).sum() - 1.0) <= 0.05


def partial_case(rs, B, L, A, D, ended=(1, 3)):
    """keys, q, v, memory, mask of ``attention_step_partial`` as numpy: one
    L-shard of a longer text; the rows in ``ended`` end in an earlier shard
    (fully masked here), the others end at random inside it or past it."""
    lengths = rs.randint(1, 2 * L, B)
    lengths[list(ended)] = 0
    f = lambda *s, sc=1.0: (rs.randn(*s) * sc).astype(np.float32)
    return (f(B, L, A, sc=0.5), f(B, A, sc=0.5), f(A, sc=A ** -0.5), f(B, L, D),
            np.arange(L)[None, :] < lengths[:, None])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [
    # f32: the same arithmetic in another sum order (s sums 48 weights, ctx
    # 48 weighted rows of |memory| ~ 3)
    (torch.float32, {"ctx": 1e-4, "p": 1e-5, "m": 1e-5, "s": 1e-4}),
    # bf16: both sides round act after the add and after tanh; CUDA's tanhf
    # and torch's tanh may differ by an f32 ulp at a bf16 rounding boundary,
    # moving an energy by ~|v_a|·2^-8 (p, m 1e-3; s over 48 weights 1e-2);
    # the context then rounds that weight to bf16 (2^-8 · |memory| ~ 1e-2)
    (torch.bfloat16, {"ctx": 2e-2, "p": 1e-3, "m": 1e-3, "s": 1e-2})])
def test_attention_step_partial_kernel_matches_plain_on_card(cuda, dtype, tol):
    # the full-width shard of the sequence-sharded decode: B=8, L/M = 192/4,
    # A=256, D=384; rows 1 and 3 fully masked
    rs = np.random.RandomState(17)
    args = _card(partial_case(rs, 8, 48, 256, 384), cuda, dtype)
    args[4] = args[4].bool()
    before = tas.partial_launches
    got = tas.attention_step_partial(*args)
    ref = tas.attention_step_partial_reference(*args)
    torch.cuda.synchronize()
    assert tas.partial_launches == before + 1
    for name, a, b in zip(("ctx", "p", "m", "s"), got, ref):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert (a - b).abs().max().item() <= tol[name], name
    ctx, p, m, s = got
    dead = torch.tensor([1, 3], device=cuda)
    assert torch.all(m[dead] == -1e9) and torch.all(s[dead] == 0)
    assert torch.all(p[dead] == 0) and torch.all(ctx[dead] == 0)
    assert torch.all(p[~args[4]] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, {"ctx": 1e-4, "p": 1e-5, "m": 1e-5, "s": 1e-4}),
    (torch.bfloat16, {"ctx": 2e-2, "p": 1e-3, "m": 1e-3, "s": 1e-2})])
@pytest.mark.parametrize("B,L,A,D", [(8, 48, 256, 384), (3, 13, 256, 384), (8, 1, 256, 384),
                                     (32, 192, 256, 384), (8, 48, 100, 72)])
def test_attention_step_partial_kernel_matches_plain_at_every_cluster_size_on_card(
        cuda, dtype, tol, B, L, A, D):
    # kernel 10 at the plan's C and every C the card takes (tolerances as
    # above); the fully masked rows (1 and, where B > 3, 3) stay bit-exact
    rs = np.random.RandomState(23 + B + L)
    ended = (1, 3) if B > 3 else (1,)
    args = _card(partial_case(rs, B, L, A, D, ended=ended), cuda, dtype)
    args[4] = args[4].bool()
    ref = tas.attention_step_partial_reference(*args)
    aligned = tas.rows_aligned(A, D, args[0].element_size())
    counts = tas.cluster_counts(L, A, D, int(dtype == torch.bfloat16), False, 1, aligned,
                                args[0].device)
    dead = torch.tensor(ended, device=cuda)
    for C in _attention_sizes(counts, L):
        got = tas.attention_step_partial(*args, cluster=C)
        torch.cuda.synchronize()
        assert C is None or tas.last_plan[0] == C
        for name, a, b in zip(("ctx", "p", "m", "s"), got, ref):
            assert (a - b).abs().max().item() <= tol[name], (name, C)
        ctx, p, m, s = got
        assert torch.all(m[dead] == -1e9) and torch.all(s[dead] == 0), C
        assert torch.all(p[dead] == 0) and torch.all(ctx[dead] == 0), C
        assert torch.all(p[~args[4]] == 0), C
        _assert_repeatable(tas.attention_step_partial, args, tas.last_plan[0], got)


@pytest.mark.gpu
def test_attention_step_partial_raises_outside_its_limits_on_card(cuda):
    rs = np.random.RandomState(18)
    # past the longest L a cluster of 16 takes (L=60000 now runs)
    L = _attention_limit_L(8, 4) + 1
    keys, q, v, mem, mask = _card(partial_case(rs, 1, L, 8, 4, ended=()), cuda)
    before = tas.partial_launches
    with pytest.raises(ValueError, match="shared memory"):
        tas.attention_step_partial(keys, q, v, mem, mask.bool())
    with pytest.raises(ValueError, match="on cpu"):
        tas.attention_step_partial(keys[:, :4], q, v, mem[:, :4].cpu(), mask[:, :4].bool())
    assert tas.partial_launches == before


def _card_seq_rank(rank, cfg, B, L, iters, inputs, lengths, sids, angles):
    mesh = make_mesh(cfg.parallel, data=1, model=2)
    syn = Synthesizer(cfg, mesh=mesh, seed=4)
    fn = syn.make_sharded_synth(mesh, B, L, max_iters=iters)
    counts = (tas.partial_launches, tdl.launches)
    wav, align, mel = fn(inputs, lengths, sids, gl_angles=angles)
    torch.cuda.synchronize()
    return ([t.cpu().numpy() for t in (wav, align, mel)],
            (tas.partial_launches - counts[0], tdl.launches - counts[1]))


@pytest.mark.gpu
def test_sequence_sharded_synth_on_card_matches_unsharded(cuda):
    # two gloo ranks sharing the card, (data=1, model=2), f32 tiny model with
    # a row-sharded 16-speaker table: kernel 10 once a step on each rank and
    # the fused decoder loop never; the result against the unsharded port on
    # the card (test_parallel.py's tolerances for the sharded decode)
    cfg = tconfig.get_config("tiny", "model.prenet_dropout=0.0,model.num_speakers=16,"
                             "model.speaker_embed_depth=8,parallel.model_parallel_size=2,"
                             "parallel.shard_speaker_table_min=8,audio.gl_method=dft_f32,"
                             "parallel.hybrid_model_axis=false")
    rs = np.random.RandomState(19)
    B, L, iters = 3, 32, 8
    inputs, lengths, sids = rs.randint(2, 40, (B, L)), np.array([32, 9, 20]), np.array([1, 9, 15])
    angles = rs.uniform(-math.pi, math.pi, (B, iters * 5, 513)).astype(np.float32)
    outs = run_ranks(_card_seq_rank, 2, cfg, B, L, iters, inputs, lengths, sids, angles,
                     timeout=300)
    ref = Synthesizer(cfg, device=cuda, seed=4)._make_fn(iters)(
        torch.as_tensor(inputs, device=cuda), torch.as_tensor(lengths, device=cuda),
        torch.as_tensor(sids, device=cuda), torch.Generator(device=cuda),
        torch.as_tensor(angles, device=cuda))
    wav_r, al_r, mel_r = (t.cpu().numpy() for t in ref[:3])
    for (wav, al, mel), launches in outs:
        assert launches == (iters, 0)
        np.testing.assert_allclose(mel, mel_r, atol=2e-3)
        np.testing.assert_allclose(al, al_r, atol=1e-4)
        np.testing.assert_allclose(wav, wav_r, atol=1e-3 * np.abs(wav_r).max())


def _card_dp_rank(rank, cfg, batch):
    """One rank of a (2, 1) mesh on the card: one data-parallel step on its
    half of the batch; its metrics, gradients (all-reduced, clipped),
    parameters and running statistics, and its teacher-forward and BiGRU
    backward launches."""
    from tacotron_multispeaker_torch import training
    torch.backends.cuda.matmul.allow_tf32 = False    # as the cuda fixture sets them
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(cfg.parallel, data=2, model=1)
    model, state = training.create_train_state(cfg, seed=2, mesh=mesh)
    step = training.make_sharded_train_step(cfg, model, mesh)
    n = batch[0].shape[0] // 2
    before = (ttd.fwd_launches, tgs.bwd_launches)
    state, m = step(state, *(torch.from_numpy(a[rank * n:(rank + 1) * n]).to(mesh.device)
                             for a in batch))
    torch.cuda.synchronize()
    return _train_result(model, m), (ttd.fwd_launches - before[0], tgs.bwd_launches - before[1])


def _train_result(model, m):
    return ({k: float(m[k]) for k in ("loss", "grad_norm")},
            {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            {n: p.detach().cpu() for n, p in model.named_parameters()},
            {n: b.detach().cpu() for n, b in model.named_buffers() if n.endswith((".mean", ".var"))})


@pytest.mark.gpu
def test_data_parallel_step_on_card_matches_one_process(cuda):
    # two gloo ranks sharing the card, f32 tiny model, dropout off,
    # cross-replica BatchNorm: the data-parallel step (kernels on each
    # rank's half) against the single-process step on the card.  Loss 1e-5
    # and grad norm 1e-4 relative; each all-reduced gradient leaf 1e-3 of its
    # peak (floored at 1e-3 of the largest: other f32 sum orders); running
    # statistics 1e-5 relative; parameters 2.5·lr absolute (Adam's first step
    # is about lr·sign(g): a near-zero gradient may flip sign)
    from tacotron_multispeaker_torch import training
    cfg = tconfig.get_config("tiny", "model.compute_dtype=float32,model.prenet_dropout=0.0,"
                             "model.num_speakers=3,train.batch_size=4,"
                             "parallel.bn_cross_replica=true")
    batch = train_batch(np.random.RandomState(21), cfg, B=4, L=11, T=20)
    outs = run_ranks(_card_dp_rank, 2, cfg, batch, timeout=300)
    model, state = training.create_train_state(cfg, seed=2, device=cuda)
    state, m = training.make_train_step(cfg, model)(
        state, *(torch.from_numpy(a).to(cuda) for a in batch))
    (m_r, g_r, p_r, b_r) = _train_result(model, m)
    peak = max(g.abs().max().item() for g in g_r.values())
    lr = training.learning_rate_schedule(cfg)(0)
    for (m_d, g_d, p_d, b_d), launches in outs:
        assert launches == (1, 2)          # per step: kernel 6 once, kernel 4 twice
        assert abs(m_d["loss"] - m_r["loss"]) <= 1e-5 * abs(m_r["loss"])
        assert abs(m_d["grad_norm"] - m_r["grad_norm"]) <= 1e-4 * m_r["grad_norm"]
        for k, g in g_r.items():
            assert (g_d[k] - g).abs().max().item() <= 1e-3 * max(g.abs().max().item(),
                                                                  1e-3 * peak), k
        for k, b in b_r.items():
            assert (b_d[k] - b).abs().max().item() <= 1e-5 * b.abs().max().item(), k
        for k, p in p_r.items():
            assert (p_d[k] - p).abs().max().item() <= 2.5 * lr, k


@pytest.mark.gpu
def test_pinned_batches_copy_on_a_side_stream_on_card(cuda):
    # DeviceBatches: the step's inputs equal the host batch (ids as int64,
    # f32 / bf16 / int16 targets in their dtype), and a second batch's copy,
    # issued while the step still reads the first (a sleep on the compute
    # stream, the first batch's tensors already dropped by Python), does not
    # land in the first batch's memory
    from tacotron_multispeaker_torch.data.feeder import Batch, pinned_empty
    from tacotron_multispeaker_torch.train_loop import DeviceBatches

    def host(seed, dtype):
        rs = np.random.RandomState(seed)
        tgt = lambda *s: pinned_empty(s, dtype).copy_(
            torch.from_numpy(rs.uniform(-1, 1, s).astype(np.float32) * 1000))
        ints = lambda *s: rs.randint(0, 60, s).astype(np.int32)
        return Batch(ints(4, 32), ints(4), tgt(4, 200, 80), tgt(4, 200, 513), ints(4),
                     ints(4))

    for dtype in (torch.float32, torch.bfloat16, torch.int16):
        hosts = [host(s, dtype) for s in range(3)]
        feed = DeviceBatches(iter(hosts), cuda)
        sums = []
        for n in range(3):
            h, args = feed.take()
            assert h is hosts[n]
            assert [a.dtype for a in args] == [torch.int64] * 2 + [dtype] * 2 + [torch.int64] * 2
            torch.cuda._sleep(50_000_000)               # ~25 ms of the compute stream
            sums.append([a.double().sum() for a in args])
            del args
            if n < 2:
                feed.prefetch()
        torch.cuda.synchronize()
        for h, got in zip(hosts, sums):
            want = [torch.as_tensor(getattr(h, f)).double().sum() for f in (
                "inputs", "input_lengths", "mel_targets", "linear_targets", "target_lengths",
                "speaker_ids")]
            # double sums in two orders: 1e-12 relative (another batch's
            # values, uniform in +-1000, would be off by thousands)
            np.testing.assert_allclose([float(g) for g in got], [float(w) for w in want],
                                       rtol=1e-12, err_msg=str(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["fft", "ct_f32", "ct_hi", "ct_bf16", "ct_mix"])
def test_griffin_lim_fft_and_ct_kernel_route_matches_plain_on_card(cuda, method):
    # use_pallas: every overlap-add of fft / ct_* in kernel 12 (iterations +
    # 1 launches), the full frame; against the plain route on the card with
    # the same angles.  f32: kernel 12 repeats its plain version's f32 sums
    # -> 1e-5 of the peak.  bf16 / mix: the plain route's overlap-add runs
    # in bf16, the kernel's in f32, and the phase estimate carries the
    # roundings -> mean 2e-2, worst sample 0.2 of the peak
    from tacotron_multispeaker_torch.audio import dsp
    B, F, n_iters = 2, 60, 4
    p = dsp.STFTParams(2048, 275, 1102)
    g = torch.Generator(device=cuda).manual_seed(3)
    mag = torch.rand((B, 1025, F), generator=g, device=cuda) * 2.0
    angles = torch.rand((B, F, 1025), generator=g, device=cuda) * (2 * math.pi) - math.pi
    before = tola.launches
    y_k = dsp.griffin_lim(mag, p, n_iters, method=method, momentum=0.99, angles=angles,
                          use_pallas=True)
    torch.cuda.synchronize()
    assert tola.launches - before == n_iters + 1
    y_p = dsp.griffin_lim(mag, p, n_iters, method=method, momentum=0.99, angles=angles)
    assert tola.launches - before == n_iters + 1
    assert y_k.shape == y_p.shape == (B, 275 * (F - 1)) and torch.isfinite(y_k).all()
    err, peak = (y_k - y_p).abs(), y_p.abs().max()
    if method in ("ct_bf16", "ct_mix"):
        assert err.mean() <= 2e-2 * peak and err.max() <= 0.2 * peak
    else:
        assert err.max() <= 1e-5 * peak


@pytest.mark.gpu
def test_griffin_lim_products_run_at_the_aligned_width_on_card(cuda, monkeypatch):
    # pod_synth_b64's Griffin-Lim: B=64 x 2,000 frames, n_fft 2048, the
    # window support (1000 samples, hop 250), 15 fast iterations on the
    # library products (use_pallas=False).  At gl_bins = 1,032 no product
    # runs on cuBLAS's kernels for misaligned rows (cutlass_75 ... s1688, the
    # Turing mma.sync tiles that 1,025 bins took).  The zero bins add exact
    # zeros: dft_f32 gives the unpadded formulation's waveform to 1e-5 of its
    # peak (measured equal).  dft_mix's twelve bf16 iterations carry another
    # kernel's sum order chaotically where |S| ~ 0 (measured mean 1.1e-2 of
    # the peak), so it is held by its spectral convergence to the magnitude
    # instead: within 1 % of the unpadded formulation's
    from torch.profiler import ProfilerActivity, profile
    from tacotron_multispeaker_torch.audio import dsp
    p = dsp.STFTParams(2048, 250, 1000)
    g = torch.Generator(device=cuda).manual_seed(5)
    mag = torch.rand((64, 1025, 2000), generator=g, device=cuda) * 2.0
    angles = torch.rand((64, 2000, 1025), generator=g, device=cuda) * (2 * math.pi) - math.pi
    run = lambda method: dsp.griffin_lim(mag, p, 15, method=method, momentum=0.99,
                                         angles=angles)
    convergence = lambda y: float(torch.linalg.vector_norm(dsp.stft(y, p).abs() - mag)
                                  / torch.linalg.vector_norm(mag))
    run("dft_mix")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        y_mix = run("dft_mix")
        torch.cuda.synchronize()
    names = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}
    assert any("gemm" in n or "nvjet" in n for n in names), sorted(names)
    assert not [n for n in names if "cutlass_75" in n or "s1688" in n]
    y_f32 = run("dft_f32")
    monkeypatch.setattr(dsp, "gl_bins", lambda n_fft, method="dft_f32": n_fft // 2 + 1)
    dsp._gl_constants.cache_clear()
    try:
        y0_mix, y0_f32 = run("dft_mix"), run("dft_f32")
    finally:
        dsp._gl_constants.cache_clear()
    assert y_mix.shape == y0_mix.shape == (64, 250 * 1999) and torch.isfinite(y_mix).all()
    assert (y_f32 - y0_f32).abs().max() <= 1e-5 * y0_f32.abs().max()
    sc, sc0 = convergence(y_mix), convergence(y0_mix)
    assert abs(sc - sc0) <= 0.01 * sc0, (sc, sc0)


@pytest.mark.gpu
def test_location_attention_train_step_launches_on_card(cuda):
    # location attention trains through the per-step loop: per step the two
    # BiGRU forwards (kernel 3) and backwards (kernel 4, prologue and scan)
    # and their two weight-gradient launches; no teacher-decoder kernel
    # (6, 7, 8), no attention-step kernel (no use_pallas); a finite loss
    from tacotron_multispeaker_torch import training
    from tacotron_multispeaker_torch.ops import wgrad as twgrad
    cfg = tconfig.get_config("multispeaker_vctk", "model.attention_type=location")
    model, state = training.create_train_state(cfg, seed=0, device=cuda)
    step = training.make_train_step(cfg, model)
    batch = [torch.from_numpy(a).to(cuda) for a in train_batch(
        np.random.RandomState(8), cfg, B=4, L=24, T=40, vocab=60)]
    count = lambda: (tgs.launches + tgs.fma_launches, tgs.bwd_launches, tgs.bwd_remat_launches,
                     twgrad.launches + twgrad.fma_launches, ttd.fwd_launches, ttd.dkeys_launches,
                     ttd.bwd_launches, ttd.bwd_remat_launches, tas.launches)
    for _ in range(2):
        before = count()
        state, m = step(state, *batch)
        torch.cuda.synchronize()
        assert [a - b for a, b in zip(count(), before)] == [2, 2, 2, 2, 0, 0, 0, 0, 0]
        assert math.isfinite(float(m["loss"])) and math.isfinite(float(m["grad_norm"]))


@pytest.mark.gpu
def test_bf16_adam_step_on_card_matches_cpu(cuda):
    # train.adam_mu_dtype=bfloat16, f32 tiny model, dropout off: one step on
    # the card against the CPU's.  The first moments are bf16 on both and one
    # bf16 ulp apart at most (2^-7 of each leaf's peak; f32 gradients in
    # other sum orders; floored as below), the second moments f32; parameters
    # 2.5·lr absolute (Adam's first step is about lr·sign(g))
    from tacotron_multispeaker_torch import training
    cfg = tconfig.get_config("tiny", "model.compute_dtype=float32,model.prenet_dropout=0.0,"
                             "model.num_speakers=3,train.adam_mu_dtype=bfloat16")
    batch = train_batch(np.random.RandomState(22), cfg, B=3, L=11, T=20)
    out = {}
    for dev in ("cpu", cuda):
        model, state = training.create_train_state(cfg, seed=4, device=dev)
        state, _ = training.make_train_step(cfg, model)(
            state, *(torch.from_numpy(a).to(dev) for a in batch))
        opt = state.optimizer
        out[str(dev)] = ([(opt.adam.state[p]["exp_avg"].cpu(), opt.adam.state[p]["exp_avg_sq"])
                          for p in opt.params], [p.detach().cpu() for p in opt.params])
    lr = training.learning_rate_schedule(cfg)(0)
    (mc, pc), (mg, pg) = out["cpu"], out["cuda"]
    # floored at 1e-3 of the largest moment: leaves whose gradient is zero in
    # exact arithmetic (a conv bias before a training-mode BatchNorm) hold noise
    floor = 1e-3 * max(mu.float().abs().max().item() for mu, _ in mc)
    for (mu_c, nu_c), (mu_g, nu_g), p_c, p_g in zip(mc, mg, pc, pg):
        assert mu_c.dtype == mu_g.dtype == torch.bfloat16
        assert nu_c.dtype == nu_g.dtype == torch.float32
        assert (mu_g.float() - mu_c.float()).abs().max() <= 2.0 ** -7 * max(
            mu_c.float().abs().max().item(), floor)
        assert (p_g - p_c).abs().max() <= 2.5 * lr
