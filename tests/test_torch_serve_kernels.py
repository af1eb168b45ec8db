"""The plain versions of the kernels behind ``parallel.use_pallas`` against
the JAX package's Pallas kernels in interpret mode, on the same numpy
inputs, on the CPU: ``conv_bank_pallas``, ``attention_step_pallas``,
``overlap_add_pallas`` and ``gl_fast_iterations_pallas``; and the wrappers'
own checks.  The kernels against their plain versions on the card are in
``test_torch_gpu.py``, which also makes the numpy input cases.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the comparisons with the JAX package run where flax is installed; the card
# tests of the same ops live in test_torch_gpu.py, which needs no JAX
pytest.importorskip("flax")

from tacotron_multispeaker_tpu.ops.attention_step import attention_step_pallas  # noqa: E402
from tacotron_multispeaker_tpu.ops.conv_bank import conv_bank_pallas  # noqa: E402
from tacotron_multispeaker_tpu.ops.gl_iteration import gl_fast_iterations_pallas  # noqa: E402
from tacotron_multispeaker_tpu.ops.overlap_add import overlap_add_pallas  # noqa: E402
from tacotron_multispeaker_tpu.ops.overlap_add import overlap_add_reference  # noqa: E402
from tacotron_multispeaker_tpu.models.modules import _bank_mask  # noqa: E402
from tacotron_multispeaker_torch.audio.dsp import hann_window  # noqa: E402
from tacotron_multispeaker_torch.models.modules import ConvBank  # noqa: E402
from tacotron_multispeaker_torch.ops import attention_step as tas  # noqa: E402
from tacotron_multispeaker_torch.ops import conv_bank as tcb  # noqa: E402
from tacotron_multispeaker_torch.ops import gl_iteration as tgl  # noqa: E402
from tacotron_multispeaker_torch.ops import overlap_add as tola  # noqa: E402
from test_torch_gpu import attention_case, conv_bank_case, gl_case  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _both(a, name):
    """numpy → (torch, jax) in the dtype ``name`` (both round to nearest even)."""
    tdt, jdt = DTYPES[name]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a, jdt)


@pytest.mark.parametrize("B,T,D,K,C,dtype", [
    (2, 19, 12, 4, 8, "float32"),      # T not a multiple of the TPU's 8
    (1, 33, 16, 5, 4, "float32"),      # odd K
    (2, 19, 12, 8, 8, "bfloat16"),     # the serving precision, post-net K
])
def test_conv_bank_plain_matches_pallas_interpret(B, T, D, K, C, dtype):
    rs = np.random.RandomState(K)
    (x_t, x_j), (w_t, w_j), (b_t, b_j) = (_both(a, dtype) for a in
                                          conv_bank_case(rs, B, T, D, K, C))
    y_t = tcb.conv_bank(x_t, w_t, b_t)
    y_j = np.asarray(conv_bank_pallas(x_j, w_j, b_j, interpret=True).astype(jnp.float32))
    assert y_t.dtype == x_t.dtype and y_t.shape == (B, T, K * C)
    if dtype == "float32":
        # the same f32 products, summed in another order -> 1e-5
        np.testing.assert_allclose(y_t.numpy(), y_j, atol=1e-5)
    else:
        # bf16 products are exact in f32; the f32 sum-order difference (as
        # above) can move the one final rounding by one bf16 ulp
        np.testing.assert_allclose(y_t.float().numpy(), y_j, rtol=2 ** -7, atol=1e-5)


@pytest.mark.parametrize("B,T,D,K,C,dtype", [
    (2, 13, 10, 3, 4, "float32"),      # odd K, D not a multiple of 16, T of 8
    (2, 13, 10, 4, 4, "float32"),      # even K
    (1, 21, 10, 8, 3, "float32"),      # the post-net's K
    (2, 13, 10, 4, 4, "bfloat16"),
    (2, 13, 10, 8, 3, "bfloat16"),
])
def test_conv_bank_with_bank_channels_matches_pallas_interpret(B, T, D, K, C, dtype):
    # the bank's function (the mask applied from bank_channels) against the
    # Pallas kernel on the masked weight that conv_bank_case makes
    rs = np.random.RandomState(K + 20)
    (x_t, x_j), (w_t, w_j), (b_t, b_j) = (_both(a, dtype) for a in
                                          conv_bank_case(rs, B, T, D, K, C))
    y_t = tcb.conv_bank(x_t, w_t, b_t, bank_channels=C)
    y_j = np.asarray(conv_bank_pallas(x_j, w_j, b_j, interpret=True).astype(jnp.float32))
    assert y_t.dtype == x_t.dtype and y_t.shape == (B, T, K * C)
    peak = np.abs(y_j).max()
    if dtype == "float32":
        # the same f32 products, summed in another order -> 1e-5 of the peak
        np.testing.assert_allclose(y_t.numpy(), y_j, rtol=0, atol=1e-5 * peak)
    else:
        # exact bf16 products; the sum order may move the rounding one ulp
        np.testing.assert_allclose(y_t.float().numpy(), y_j, rtol=2 ** -7, atol=1e-5 * peak)


@pytest.mark.parametrize("K,C,groups", [(3, 4, 3), (4, 2, 4), (8, 3, 8), (8, 4, 5)])
def test_conv_bank_with_bank_channels_masks_any_weight(K, C, groups):
    # an unmasked w: bank_channels=C computes the conv of w ⊙ mask, the mask
    # being the JAX package's _bank_mask (its first groups*C columns when the
    # bank has fewer groups than taps)
    rs = np.random.RandomState(K * C)
    B, T, D, O = 2, 11, 6, groups * C
    x = torch.from_numpy(rs.randn(B, T, D).astype(np.float32))
    w = torch.from_numpy(rs.randn(K, D, O).astype(np.float32))
    b = torch.from_numpy(rs.randn(O).astype(np.float32) * 0.1)
    mask = torch.from_numpy(_bank_mask(K, C)[:, :, :O])
    torch.testing.assert_close(tcb.bank_mask(K, C, O), mask, rtol=0, atol=0)
    y = tcb.conv_bank(x, w, b, bank_channels=C)
    torch.testing.assert_close(y, tcb.conv_bank(x, w * mask, b), rtol=0, atol=0)
    assert not torch.equal(y, tcb.conv_bank(x, w, b))        # the mask mattered


def test_conv_bank_bank_channels_must_divide_the_columns():
    rs = np.random.RandomState(21)
    x, w, b = map(torch.from_numpy, conv_bank_case(rs, 1, 5, 4, 3, 2))   # O = 6
    with pytest.raises(ValueError, match="bank_channels=4"):
        tcb.conv_bank(x, w, b, bank_channels=4)
    with pytest.raises(ValueError, match="bank_channels=1"):             # 6 groups > K
        tcb.conv_bank(x, w, b, bank_channels=1)
    with pytest.raises(ValueError, match="bank_channels=0"):
        tcb.conv_bank(x, w, b, bank_channels=0)


def test_conv_bank_module_passes_its_group_width(monkeypatch):
    # ConvBank(use_pallas=True) tells the kernel its group width, so the
    # kernel can skip the taps the mask zeroes
    calls = []
    real = tcb.conv_bank

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(tcb, "conv_bank", spy)
    bank = ConvBank(6, 4, 5, use_pallas=True).eval()
    torch.nn.init.normal_(bank.weight)
    with torch.no_grad():
        y = bank(torch.from_numpy(np.random.RandomState(3).randn(2, 9, 6).astype(np.float32)))
    assert calls == [{"bank_channels": 5}] and y.shape == (2, 9, 20)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("loc", [False, True])
def test_attention_step_plain_matches_pallas_interpret(dtype, loc):
    rs = np.random.RandomState(3 + loc)
    B, L, A, D = 3, 21, 24, 10
    keys, q, v, mem, mask, lt = attention_case(rs, B, L, A, D, loc)
    t = [_both(a, dtype) for a in (keys, q, v, mem)]
    lt_t, lt_j = _both(lt, dtype) if loc else (None, None)
    ctx_t, al_t = tas.attention_step(*(a for a, _ in t), torch.from_numpy(mask), lt_t)
    ctx_j, al_j = attention_step_pallas(*(b for _, b in t), jnp.asarray(mask), lt_j,
                                        interpret=True)
    assert ctx_t.dtype == al_t.dtype == torch.float32
    assert ctx_t.shape == (B, D) and al_t.shape == (B, L)
    assert torch.all(al_t[~torch.from_numpy(mask)] == 0.0)
    if dtype == "float32":
        # the same f32 arithmetic in another sum order
        tol_al, tol_ctx = 1e-6, 1e-5
    else:
        # bf16 act rounds after each add and after tanh on both sides; the
        # two libraries' f32 tanh may differ by an ulp, which can flip a bf16
        # rounding of one act element (2^-8 of it) and move an energy by
        # ~|v_a|·2^-8 ~ 1e-3 -> alignments 1e-3, context 1e-2 (|memory| ~ 3)
        tol_al, tol_ctx = 1e-3, 1e-2
    np.testing.assert_allclose(al_t.numpy(), np.asarray(al_j), atol=tol_al)
    np.testing.assert_allclose(ctx_t.numpy(), np.asarray(ctx_j), atol=tol_ctx)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_overlap_add_plain_matches_pallas_interpret(dtype):
    # hop 100 does not divide n_fft 256 (m = 3); window, sums and norm are
    # f32 on both sides whatever the frames' dtype: only the sum order of
    # the <= 3 frames per sample differs -> 1e-5 of the peak
    rs = np.random.RandomState(5)
    frames = rs.randn(3, 7, 256).astype(np.float32)
    win = (np.hanning(256) + 0.1).astype(np.float32)
    f_t, f_j = _both(frames, dtype)
    out_t = tola.overlap_add(f_t, torch.from_numpy(win), 100)
    out_j = np.asarray(overlap_add_pallas(f_j, jnp.asarray(win), 100, interpret=True))
    assert out_t.dtype == torch.float32 and out_t.shape == (3, 256 + 100 * 6)
    np.testing.assert_allclose(out_t.numpy(), out_j, atol=1e-5 * np.abs(out_j).max())


@pytest.mark.parametrize("Wn,win_length,hop", [
    (256, 200, 100),     # full frame: a zero-padded window, hop not dividing n_fft (m = 3)
    (200, 200, 64),      # window support, hop not dividing it (m = 4)
    (1102, 1102, 275),   # the serving support (50 ms at 22.05 kHz), hop 275 (m = 5)
])
def test_overlap_add_prewindowed_matches_pallas_interpret(Wn, win_length, hop):
    # frames prewindowed as the inverse DFT product gives them (frames ×
    # window): the port's plain version, which skips the multiply, against
    # the JAX kernel, which makes it, and the JAX reference, which skips it.
    # f32 products, sums of <= m frames in another order -> 1e-5 relative a
    # sample.  Samples at the edges divide by a norm near the 1e-10 clamp
    # (Hann's w[1]^2) and reach ~1e5, so the peak is no scale; interior
    # samples are O(1), hence atol 1e-5
    rs = np.random.RandomState(Wn + hop)
    frames = rs.randn(2, 6, Wn).astype(np.float32)
    win = hann_window(win_length, Wn)
    pre = frames * win
    out_t = tola.overlap_add_plain(torch.from_numpy(pre), torch.from_numpy(win), hop,
                                   prewindowed=True)
    out_w = tola.overlap_add(torch.from_numpy(pre), torch.from_numpy(win), hop,
                             prewindowed=True)
    out_k = np.asarray(overlap_add_pallas(jnp.asarray(frames), jnp.asarray(win), hop,
                                          interpret=True))
    out_r = np.asarray(overlap_add_reference(jnp.asarray(pre), jnp.asarray(win), hop,
                                             prewindowed=True))
    assert out_t.dtype == torch.float32 and out_t.shape == out_k.shape == (2, Wn + hop * 5)
    assert torch.equal(out_w, out_t)                  # the wrapper's CPU route
    np.testing.assert_allclose(out_t.numpy(), out_k, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out_t.numpy(), out_r, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("F,n_fft,hop,n_iters,mom", [
    (6, 128, 32, 3, 0.0),
    (11, 128, 48, 2, 0.99 / 1.99),   # hop not dividing n_fft, odd frames
    (8, 256, 100, 4, 0.5),
])
def test_gl_fast_iterations_plain_matches_pallas_interpret(F, n_fft, hop, n_iters, mom):
    # the parametrisations of the JAX package's own kernel test; both sides
    # round at the same points (bf16 frames and matmul operands, f32 sums),
    # but phase estimation is chaotic where |spectrum| ~ 0, so a sum-order
    # difference there grows over the iterations: 3e-2 of each output's
    # peak, the JAX test's own tolerance
    rs = np.random.RandomState(0)
    wf0, mag, win = gl_case(rs, 2, F, n_fft)
    out_t = tgl.gl_fast_iterations(torch.from_numpy(wf0).to(torch.bfloat16),
                                   torch.from_numpy(mag), torch.from_numpy(win), hop,
                                   n_iters, mom)
    out_j = gl_fast_iterations_pallas(jnp.asarray(wf0, jnp.bfloat16), jnp.asarray(mag),
                                      jnp.asarray(win), hop, n_iters, mom, interpret=True)
    for name, a, b in zip(("sre", "sim", "pre", "pim"), out_t, out_j):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert np.abs(a.numpy() - b).max() < 3e-2 * max(np.abs(b).max(), 1e-6), name


def test_gl_shift_coeffs_are_built_once_per_geometry():
    # the kernel's banded OLA coefficients and the window's support, cached
    # by the window's values: equal to shift_coeffs and window_support, and
    # one entry for equal windows in new tensors
    win = torch.from_numpy(gl_case(np.random.RandomState(7), 1, 1, 64)[2])
    tgl._device_shift_coeffs.cache_clear()
    for w in (win, win.clone()):
        N, Sd, support = tgl._device_shift_coeffs(w.numpy().tobytes(), 9, 20,
                                                  torch.device("cpu"))
    assert tgl._device_shift_coeffs.cache_info().misses == 1
    for got, want in zip((N, Sd), tgl.shift_coeffs(win, 9, 20)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert support == tgl.window_support(win.numpy()) == (0, 64)


def _interior_zeros(n=256):
    w = np.hanning(n).astype(np.float32) + 0.05
    w[:30], w[100:120], w[200:] = 0.0, 0.0, 0.0
    return w


@pytest.mark.parametrize("window,step,support", [
    # the serving window: nonzero on [474, 1575) (the periodic Hann's first
    # sample is exactly 0), rounded out to the kernels' 64-sample k-block
    (hann_window(1102, 2048), tgl.K_STEP, (448, 1600)),
    (hann_window(1102, 2048), 1, (474, 1575)),
    # no zero: the whole frame
    (np.hanning(2048).astype(np.float32) + 0.05, tgl.K_STEP, (0, 2048)),
    # zeros inside the window do not split it: the hull of the nonzeros
    (_interior_zeros(), 16, (16, 208)),
    (_interior_zeros(), 1, (30, 200)),
])
def test_window_support_is_the_rounded_hull_of_the_nonzeros(window, step, support):
    assert tgl.window_support(window, step) == support


def test_window_support_of_an_all_zero_window_raises():
    with pytest.raises(ValueError, match="no nonzero sample"):
        tgl.window_support(np.zeros(256, np.float32))


def _support_iterations(wf0, mag, win, hop, n_iters, mom, lo, hi):
    """The fast iterations in f32 with the kernels' restriction: iteration 1's
    forward product over the whole frame, later ones over [lo, hi); the
    inverse product only for frame columns [lo, hi); the OLA only for
    outputs in [lo, hi) from sources in [lo, hi), over increasing d."""
    B, F, n_fft = wf0.shape
    m = -(-n_fft // hop)
    C, S, iC, iS = (torch.from_numpy(a).float() for a in tgl.dft_matrices(n_fft))
    N, Sd = tgl.shift_coeffs(win, F, hop)
    pre = pim = torch.zeros_like(mag)
    wf = wf0
    for it in range(n_iters):
        k0, k1 = (0, n_fft) if it == 0 else (lo, hi)
        f = wf[..., k0:k1]
        re, im = f @ C[k0:k1], f @ S[k0:k1]
        are, aim = re - mom * pre, im - mom * pim
        pre, pim = re, im
        scale = mag / torch.clamp(torch.sqrt(are * are + aim * aim), min=1e-8)
        sre, sim = are * scale, aim * scale
        fr = sre @ iC[:, lo:hi] + sim @ iS[:, lo:hi]          # frame columns [lo, hi)
        acc = torch.zeros(B, F, hi - lo)
        for d in range(-(m - 1), m):
            # outputs i whose source i + d*hop lies in [lo, hi), frames g with
            # g - d in [0, F)
            i0, i1 = max(lo, lo - d * hop), min(hi, hi - d * hop)
            g0, g1 = max(0, d), min(F, F + d)
            if i0 < i1 and g0 < g1:
                acc[:, g0:g1, i0 - lo:i1 - lo] += (
                    fr[:, g0 - d:g1 - d, i0 + d * hop - lo:i1 + d * hop - lo]
                    * Sd[d + m - 1, i0:i1])
        wf = torch.zeros_like(wf0)
        wf[..., lo:hi] = acc * N[:, lo:hi]
    return sre, sim, pre, pim


@pytest.mark.parametrize("step", [1, 16])
def test_support_restriction_equals_the_full_frame_iterations(step):
    # the kernels' support algebra: every term the restriction drops is a
    # product with an exact zero (N and S_d vanish outside the window), so
    # the restricted f32 iterations equal the full-frame reference up to the
    # products' sum order; wf0 is nonzero everywhere, so iteration 1 must
    # read the whole frame
    n_fft, hop, F = 256, 64, 9
    win = hann_window(150, n_fft)
    lo, hi = tgl.window_support(win, step)
    assert 0 < lo and hi < n_fft
    rs = np.random.RandomState(21)
    wf0 = torch.from_numpy(rs.randn(2, F, n_fft).astype(np.float32))
    mag = torch.from_numpy(np.abs(rs.randn(2, F, n_fft // 2 + 1)).astype(np.float32))
    w = torch.from_numpy(win)
    got = _support_iterations(wf0, mag, w, hop, 3, 0.5, lo, hi)
    want = tgl.gl_fast_iterations_reference(wf0, mag, w, hop, 3, 0.5)
    for name, a, b in zip(("sre", "sim", "pre", "pim"), got, want):
        assert (a - b).abs().max().item() <= 1e-6 * b.abs().max().item(), name


@pytest.mark.parametrize("n_fft", [64, 200, 2048])
def test_kernel_dft_matrices_interleave_the_dft(n_fft):
    # the kernels' operands hold dft_matrices' C, S, iC, iS exactly: the
    # cosine and sine of bin j in forward columns 2j, 2j+1 (zero columns up
    # to a multiple of the 128-column tile), iC[j] and iS[j] in inverse rows
    # 2j, 2j+1 (zero rows up to a multiple of 8)
    C, S, iC, iS = tgl.dft_matrices(n_fft)
    bins = n_fft // 2 + 1
    fwd, inv = tgl._kernel_matrices(n_fft)
    assert fwd.shape == (n_fft, -(-2 * bins // 128) * 128)
    assert inv.shape == (-(-2 * bins // 8) * 8, n_fft)
    np.testing.assert_array_equal(fwd[:, 0:2 * bins:2], C)
    np.testing.assert_array_equal(fwd[:, 1:2 * bins:2], S)
    np.testing.assert_array_equal(inv[0:2 * bins:2], iC)
    np.testing.assert_array_equal(inv[1:2 * bins:2], iS)
    assert not fwd[:, 2 * bins:].any() and not inv[2 * bins:].any()
    for got, want in zip(tgl._device_matrices(n_fft, torch.float64, torch.device("cpu")),
                         (fwd, inv)):
        np.testing.assert_array_equal(got.numpy(), want)


def test_new_kernel_wrappers_check_their_inputs():
    rs = np.random.RandomState(6)
    x, w, b = map(torch.from_numpy, conv_bank_case(rs, 1, 5, 4, 3, 2))
    with pytest.raises(ValueError, match="do not fit"):
        tcb.conv_bank(x, w[:, :3], b)
    with pytest.raises(TypeError, match="bias"):
        tcb.conv_bank(x, w, b.double())
    keys, q, v, mem, mask, lt = (None if a is None else torch.from_numpy(a)
                                 for a in attention_case(rs, 2, 5, 8, 4))
    with pytest.raises(ValueError, match="location_term"):
        tas.attention_step(keys, q, v, mem, mask, lt[:, :4])
    with pytest.raises(TypeError, match="mask"):
        tas.attention_step(keys, q, v, mem, mask.float(), lt)
    with pytest.raises(TypeError, match="memory"):
        tas.attention_step(keys.bfloat16(), q.bfloat16(), v.bfloat16(), mem, mask)
    with pytest.raises(ValueError, match="window"):
        tola.overlap_add(torch.zeros(1, 3, 16), torch.ones(15), 4)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tola.overlap_add(torch.zeros(1, 3, 16, dtype=torch.float64), torch.ones(16), 4)
    wf0, mag, win = map(torch.from_numpy, gl_case(rs, 1, 4, 32))
    with pytest.raises(ValueError, match="magT"):
        tgl.gl_fast_iterations(wf0, mag[..., :5], win, 8, 2, 0.0)
    with pytest.raises(ValueError, match="n_iters"):
        tgl.gl_fast_iterations(wf0, mag, win, 8, 0, 0.0)
    meta = torch.zeros(1, 3, 16, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tola.overlap_add(meta, torch.ones(16, device="meta"), 4)


def test_conv_bank_refuses_a_gradient():
    # the Pallas kernel has no VJP: the port's wrapper raises rather than
    # give the plain version's gradient on the CPU and fail on the card
    rs = np.random.RandomState(7)
    x, w, b = map(torch.from_numpy, conv_bank_case(rs, 1, 6, 4, 3, 2))
    w.requires_grad_(True)
    with pytest.raises(RuntimeError, match="inference-only"):
        tcb.conv_bank(x, w, b)
    with torch.no_grad():
        assert tcb.conv_bank(x, w, b).shape == (1, 6, 6)
