"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA device
(the ``cuda`` fixture decides).  This file imports neither JAX nor the JAX
package, so it runs where only PyTorch is installed:

    python -m pytest -m gpu tests/test_torch_*.py

The numpy input cases are shared with the CPU tests of
``test_torch_ops.py``.
"""

import math
from unittest import mock

import numpy as np
import pytest
import torch

from tacotron_multispeaker_torch import config as tconfig
from tacotron_multispeaker_torch.ops import decoder_loop as tdl
from tacotron_multispeaker_torch.ops import gru_scan as tgs
from tacotron_multispeaker_torch.ops import teacher_decoder as ttd
from tacotron_multispeaker_torch.ops import wgrad as twg
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


def teacher_weights(w, device="cpu", dtype=torch.float32):
    conv = lambda v: (tuple(torch.from_numpy(t).to(device) for t in v)
                      if isinstance(v, tuple) else torch.from_numpy(v).to(device))
    return ttd.TeacherDecoderWeights(**{k: conv(v) for k, v in w.items()}).cast(dtype)


def teacher_args(arrays, device="cpu", dtype=torch.float32):
    """png, pnc, h0a, h0d, keys, memory, mask as tensors: png/pnc/keys/memory
    in ``dtype``, the initial states f32."""
    png, pnc, h0a, h0d, keys, memory, mask = (torch.from_numpy(a).to(device) for a in arrays)
    return (png.to(dtype), pnc.to(dtype), h0a, h0d, keys.to(dtype), memory.to(dtype), mask)


def torch_weights(w, device="cpu"):
    conv = lambda v: (tuple(torch.from_numpy(t).to(device) for t in v)
                      if isinstance(v, tuple) else torch.from_numpy(v).to(device))
    return tdl.DecoderWeights(**{k: conv(v) for k, v in w.items()})


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 3e-2)])
def test_bigru_kernel_matches_plain_on_card(cuda, dtype, tol):
    # f32: same casts, sums in another order -> 1e-5; bf16: one flipped
    # rounding of a matmul input (ulp 2^-8 near 1), carried by the
    # recurrence -> 3e-2
    rs = np.random.RandomState(4)
    args = [torch.from_numpy(a).to(cuda) for a in bigru_inputs(rs, T=33, B=5, F=128,
                                                                scale=0.08)]
    args = [a.to(dtype) for a in args[:4]] + [args[4]]
    before = tgs.launches
    ys = tgs.bigru_scan(*args)
    ref = tgs.bigru_scan_reference(*args)
    torch.cuda.synchronize()
    assert tgs.launches == before + 1
    assert (ys.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,ftol,atol", [(torch.float32, 1e-4, 1e-5),
                                            (torch.bfloat16, 5e-2, 1e-3)])
def test_decoder_loop_kernel_matches_plain_on_card(cuda, dtype, ftol, atol):
    # L=13 is not a multiple of anything the kernel tiles by; f32 differs
    # only in sum order over 5 contractive steps; bf16 flips roundings of
    # matmul inputs -> frames 5e-2; energies and softmax stay f32 on both
    # sides, so alignments 1e-3 (about 1/75 of a weight at L=13)
    rs = np.random.RandomState(5)
    w, arrays, n_steps, M = decoder_case(rs, B=3, L=13, n_steps=5)
    tw = torch_weights(w, cuda).cast(dtype)
    targs = [torch.from_numpy(a).to(cuda) for a in arrays]
    targs[0], targs[1] = targs[0].to(dtype), targs[1].to(dtype)
    before = tdl.launches
    f_k, a_k = tdl.decoder_loop(tw, *targs, n_steps, M)
    f_r, a_r = tdl.decoder_loop_reference(tw, *targs, n_steps, M)
    torch.cuda.synchronize()
    assert tdl.launches == before + 1
    assert (f_k - f_r).abs().max().item() <= ftol
    assert (a_k - a_r).abs().max().item() <= atol


@pytest.mark.gpu
def test_kernels_raise_outside_their_limits_on_card(cuda):
    rs = np.random.RandomState(6)
    args = [torch.from_numpy(a).to(cuda) for a in bigru_inputs(rs, T=3, B=2, F=520)]
    before = tgs.launches
    with pytest.raises(ValueError, match="1024 threads"):
        tgs.bigru_scan(*args)                                  # 2F > 1024
    w, arrays, n_steps, M = decoder_case(rs, B=2, L=7, n_steps=3, H=30, A=16, D=24)
    targs = [torch.from_numpy(a).to(cuda) for a in arrays]
    with pytest.raises(ValueError, match="multiple of 4"):
        tdl.decoder_loop(torch_weights(w, cuda), *targs, n_steps, M)   # H=30
    assert tgs.launches == before


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
    before = (tgs.launches, tdl.launches)
    w_g, a_g = gpu.synthesize_batch(["Hello there.", "Hi."], [1, 2], gl_angles=angles)
    assert (tgs.launches - before[0], tdl.launches - before[1]) == (2, 1)
    w_c, a_c = cpu.synthesize_batch(["Hello there.", "Hi."], [1, 2], gl_angles=angles)
    np.testing.assert_allclose(a_g, a_c, atol=1e-4)
    for x, y in zip(w_g, w_c):
        assert x.shape == y.shape
        np.testing.assert_allclose(x, y, atol=1e-3 * np.abs(y).max())


def _err(a, b):
    """max |a - b| relative to max(|b|, 1)."""
    return (a.float() - b.float()).abs().max().item() / max(b.float().abs().max().item(), 1.0)


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
    before = (tgs.bwd_launches, twg.launches)
    out = tgs.bigru_scan_bwd(xg, xc, hprev, dys, whg, whc)
    ref = tgs.bigru_scan_bwd_reference(xg, xc, hprev, dys, whg, whc)
    torch.cuda.synchronize()
    assert (tgs.bwd_launches - before[0], twg.launches - before[1]) == (1, 1)
    for name, a, b in zip(("dxg", "dxc", "dwhg", "dwhc", "dh0"), out, ref):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert _err(a, b) <= tol, (name, _err(a, b))


def _teacher_on_card(cuda, dtype, S=6, B=3, L=13, H=128, A=128, D=96, seed=8):
    rs = np.random.RandomState(seed)
    w, arrays = teacher_case(rs, S, B, L, H, A, D)
    return (rs, teacher_weights(w, cuda, dtype), teacher_args(arrays, cuda, dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,xtol,atol", [(torch.float32, 1e-4, 1e-5),
                                            (torch.bfloat16, 5e-2, 1e-3)])
def test_teacher_forward_kernel_matches_plain_on_card(cuda, dtype, xtol, atol):
    # L=13 and D=96 are no multiple of the TPU's tiles; f32 differs in sum
    # order only; bf16 flips roundings of matmul inputs (xs, states 5e-2),
    # energies and softmax stay f32 on both sides (alignments 1e-3)
    _, w, args = _teacher_on_card(cuda, dtype)
    before = ttd.fwd_launches
    out = ttd.teacher_decoder_fwd(*args[:4], w, *args[4:])
    ref = ttd.teacher_decoder_fwd_reference(*args[:4], w, *args[4:])
    torch.cuda.synchronize()
    assert ttd.fwd_launches == before + 1
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
    before = (ttd.bwd_launches, ttd.dkeys_launches, twg.launches)
    out = ttd.teacher_decoder_backward(png, pnc, h0a, h0d, w, keys, memory, mask,
                                       xs, align, ha, hds, dxs, dal)
    with mock.patch.object(ttd, "teacher_decoder_bwd", ttd.teacher_decoder_bwd_reference), \
            mock.patch.object(ttd, "dkeys", ttd.dkeys_reference):
        ref = ttd.teacher_decoder_backward(png, pnc, h0a, h0d, w, keys, memory, mask,
                                           xs, align, ha, hds, dxs, dal)
    torch.cuda.synchronize()
    assert (ttd.bwd_launches - before[0], ttd.dkeys_launches - before[1],
            twg.launches - before[2]) == (1, 1, 1)
    names = ("dpng", "dpnc", "dh0a", "dh0d")
    for name, a, b in zip(names, out[:4], ref[:4]):
        assert _err(a, b) <= tol, (name, _err(a, b))
    for name, a, b in zip(ttd.TeacherDecoderWeights._fields, out[4], ref[4]):
        for x, y in zip(*((a, b) if isinstance(a, tuple) else ((a,), (b,)))):
            assert _err(x, y) <= tol, (name, _err(x, y))
    for name, a, b in zip(("dkeys", "dmemory", "de", "dctx"), out[5:], ref[5:]):
        assert _err(a, b) <= tol, (name, _err(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-5)])
def test_wgrad_kernel_matches_plain_on_card(cuda, dtype, tol):
    # strided views (a direction of [T, 2, B, F], a column slice), bias sums,
    # 700 rows (split over blocks) and 6 rows (one split); both sides round
    # the factors to the compute dtype and sum in f32, so only the summation
    # order differs (relative 1e-4 for the products, 1e-5 for the sums)
    rs = np.random.RandomState(10)
    big = torch.from_numpy(rs.randn(35, 2, 20, 200).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rs.randn(35, 2, 20, 130).astype(np.float32)).to(cuda)
    problems = [(big[:, 1, :, :70].to(dtype), g[:, 0], True),
                (big[:, 0], g[:, 1, :, 3:67], False)]
    few = (big[:3, 0, :2, :70].to(dtype), g[:3, 1, :2], True)     # 6 rows: one split
    before = twg.launches
    out = twg.wgrad(problems, dtype) + twg.wgrad([few], dtype)
    ref = twg.wgrad_reference(problems, dtype) + twg.wgrad_reference([few], dtype)
    torch.cuda.synchronize()
    assert twg.launches == before + 2
    for (c, bias), (c_r, bias_r) in zip(out, ref):
        assert _err(c, c_r) <= 10 * tol and (bias is None) == (bias_r is None)
        if bias is not None:
            assert _err(bias, bias_r) <= tol


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
