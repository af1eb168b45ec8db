"""The port's ops against the JAX package's kernels and references.

CPU: the plain PyTorch versions (what a wrapper runs for CPU tensors) are
held against the Pallas kernels in interpret mode (``bigru_scan_pallas``,
``_bigru_scan_bwd_pallas``, ``decoder_loop_pallas``,
``_teacher_decoder_fwd_pallas``, ``_teacher_decoder_bwd_pallas``,
``_dkeys_pallas``) and against the JAX references and ``jax.grad``, on the
same numpy inputs; the autograd Functions are held against
``torch.autograd`` of their plain forwards.  The kernels against their
plain versions on the card are in ``test_torch_gpu.py``, which also makes
the numpy input cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the comparisons with the JAX package run where flax is installed; the card
# tests of the same ops live in test_torch_gpu.py, which needs no JAX
pytest.importorskip("flax")

from tacotron_multispeaker_tpu.ops import decoder_loop as jdl  # noqa: E402
from tacotron_multispeaker_tpu.ops import gru_scan as jgs  # noqa: E402
from tacotron_multispeaker_tpu.ops import teacher_decoder as jtd  # noqa: E402
from tacotron_multispeaker_torch.ops import decoder_loop as tdl  # noqa: E402
from tacotron_multispeaker_torch.ops import gru_scan as tgs  # noqa: E402
from tacotron_multispeaker_torch.ops import teacher_decoder as ttd  # noqa: E402
from tacotron_multispeaker_torch.ops import wgrad as twg  # noqa: E402
from test_torch_gpu import (bigru_inputs, decoder_case, teacher_args,  # noqa: E402
                            teacher_case, teacher_weights, torch_weights)


def test_bigru_plain_matches_pallas_interpret_and_reference():
    # f32 on both sides, same math: the only difference is the order of the
    # 128-term sums -> 1e-5
    rs = np.random.RandomState(0)
    args = bigru_inputs(rs, T=9, B=3, F=128)
    ys_t = tgs.bigru_scan(*map(torch.from_numpy, args)).numpy()
    ys_p = np.asarray(jgs.bigru_scan_pallas(*map(jnp.asarray, args), interpret=True))
    xg, xc, whg, whc, h0 = map(jnp.asarray, args)
    ys_r = np.stack([np.asarray(jgs.gru_scan_reference(
        xg[:, d], xc[:, d], whg[d], whc[d], h0[d])) for d in range(2)], axis=1)
    assert ys_t.shape == ys_p.shape == ys_r.shape == (9, 2, 3, 128)
    np.testing.assert_allclose(ys_t, ys_p, atol=1e-5)
    np.testing.assert_allclose(ys_t, ys_r, atol=1e-5)


def test_bigru_plain_bf16_casts_match_reference():
    # bf16 matmul inputs and outputs: both sides round at the same places;
    # a sum-order difference can flip one bf16 rounding (ulp 2^-8 near 1),
    # which the recurrence carries -> 2e-2
    rs = np.random.RandomState(1)
    args = bigru_inputs(rs, T=12, B=2, F=32)
    bf = lambda a: a.astype(jnp.bfloat16)
    xg, xc, whg, whc, h0 = map(jnp.asarray, args)
    ys_r = np.stack([np.asarray(jgs.gru_scan_reference(
        bf(xg[:, d]), bf(xc[:, d]), bf(whg[d]), bf(whc[d]), h0[d]).astype(jnp.float32))
        for d in range(2)], axis=1)
    t = [torch.from_numpy(a) for a in args]
    ys_t = tgs.bigru_scan(*(a.to(torch.bfloat16) for a in t[:4]), t[4])
    assert ys_t.dtype == torch.bfloat16
    np.testing.assert_allclose(ys_t.float().numpy(), ys_r, atol=2e-2)


def _jax_weights(w):
    conv = lambda v: (tuple(map(jnp.asarray, v)) if isinstance(v, tuple)
                      else jnp.asarray(v))
    return jdl.DecoderWeights(**{k: conv(v) for k, v in w.items()})


def test_decoder_loop_plain_matches_jax_reference_and_pallas_interpret():
    # L=13 is not a multiple of 8 (nor of the Pallas kernel's 128-lane pad);
    # dropout masks from numpy feed both sides.  f32, contractive weights:
    # sum-order differences stay ~1e-6 over the steps -> 1e-4 / 1e-5
    rs = np.random.RandomState(11)
    w, arrays, n_steps, M = decoder_case(rs, B=3, L=13, n_steps=5)
    f_t, a_t = tdl.decoder_loop(torch_weights(w), *map(torch.from_numpy, arrays),
                                n_steps, M)
    jargs = (_jax_weights(w), *map(jnp.asarray, arrays), n_steps, M)
    f_r, a_r = jdl.decoder_loop_reference(*jargs)
    f_p, a_p = jdl.decoder_loop_pallas(*jargs, interpret=True)
    assert f_t.shape == f_r.shape == (n_steps, 3, 2 * M)
    assert a_t.shape == a_r.shape == (n_steps, 3, 13)
    for f_j, a_j in ((f_r, a_r), (f_p, a_p)):
        np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=1e-5)
    # masked positions get exactly zero weight
    assert np.all(a_t.numpy()[:, ~arrays[2]] == 0.0)


def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    tgs.launches = 0
    tdl.launches = 0
    rs = np.random.RandomState(2)
    args = [torch.from_numpy(a) for a in bigru_inputs(rs, T=4, B=2, F=16)]
    assert torch.equal(tgs.bigru_scan(*args), tgs.bigru_scan_reference(*args))
    w, arrays, n_steps, M = decoder_case(rs, B=2, L=7, n_steps=3, H=32, A=16, D=24)
    tw, targs = torch_weights(w), [torch.from_numpy(a) for a in arrays]
    out = tdl.decoder_loop(tw, *targs, n_steps, M)
    ref = tdl.decoder_loop_reference(tw, *targs, n_steps, M)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert tgs.launches == 0 and tdl.launches == 0


def test_wrappers_raise_on_bad_inputs():
    rs = np.random.RandomState(3)
    args = [torch.from_numpy(a) for a in bigru_inputs(rs, T=4, B=2, F=16)]
    with pytest.raises(ValueError, match="xc"):
        tgs.bigru_scan(args[0], args[1][:, :, :1], *args[2:])
    with pytest.raises(TypeError, match="h0"):
        tgs.bigru_scan(*args[:4], args[4].double())
    with pytest.raises(ValueError, match="cpu or cuda"):
        tgs.bigru_scan(*(a.to("meta") for a in args))
    w, arrays, n_steps, M = decoder_case(rs, B=2, L=7, n_steps=3, H=32, A=16, D=24)
    targs = [torch.from_numpy(a) for a in arrays]
    targs[3] = targs[3][:2]                                   # dropout1 steps
    with pytest.raises(ValueError, match="dropout1"):
        tdl.decoder_loop(torch_weights(w), *targs, n_steps, M)


def _close(a, b, tol, what=""):
    """max |a - b| <= tol · max(|b|, 1e-6) (relative to b's peak)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = max(float(np.abs(b).max()), 1e-6)
    err = float(np.abs(a - b).max()) / scale
    assert err <= tol, (what, err)


def _bigru_bwd_case(rs, T, B, F):
    args = bigru_inputs(rs, T=T, B=B, F=F)
    ys = tgs.bigru_scan_reference(*map(torch.from_numpy, args)).numpy()
    hprev = np.concatenate([args[4][None], ys[:-1]])
    dys = rs.randn(*ys.shape).astype(np.float32)
    return args, hprev, dys


def test_bigru_backward_plain_matches_pallas_interpret_and_jax_grad():
    # f32, T=9 and B=3 (no multiple of the TPU tiles): the plain backward
    # does the Pallas kernel's arithmetic in another sum order (1e-5 of each
    # output's peak); jax.grad of gru_scan_reference differentiates the same
    # function through XLA's own transpose rules (1e-4)
    rs = np.random.RandomState(20)
    (xg, xc, whg, whc, h0), hprev, dys = _bigru_bwd_case(rs, T=9, B=3, F=128)
    out = tgs.bigru_scan_bwd_reference(*map(torch.from_numpy, (xg, xc, hprev, dys, whg, whc)))
    pallas = jgs._bigru_scan_bwd_pallas(*map(jnp.asarray, (xg, xc, hprev, dys, whg, whc)),
                                        interpret=True)
    names = ("dxg", "dxc", "dwhg", "dwhc", "dh0")
    for name, a, b in zip(names, out, pallas):
        _close(a.numpy(), b, 1e-5, name)
    for d in range(2):
        loss = lambda *a: jnp.sum(jgs.gru_scan_reference(*a) * dys[:, d])
        grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(xg[:, d], xc[:, d], whg[d], whc[d],
                                                       h0[d])
        ours = (out[0][:, d], out[1][:, d], out[2][d], out[3][d], out[4][d])
        for name, a, b in zip(names, ours, grads):
            _close(a.numpy(), b, 1e-4, f"{name} direction {d}")


def test_bigru_function_matches_autograd_of_plain_forward():
    # BiGRUScan on CPU tensors: the plain forward, then the plain backward
    # (what the card runs as kernels) against torch.autograd through the
    # plain forward; f32, sum order only -> 1e-5
    rs = np.random.RandomState(21)
    args = [torch.from_numpy(a) for a in bigru_inputs(rs, T=7, B=2, F=16)]
    w = torch.from_numpy(rs.randn(7, 2, 2, 16).astype(np.float32))
    leaves = lambda: [a.clone().requires_grad_() for a in args]
    a1, a2 = leaves(), leaves()
    (tgs.BiGRUScan.apply(*a1) * w).sum().backward()
    (tgs.bigru_scan_reference(*a2) * w).sum().backward()
    for name, x, y in zip(("xg", "xc", "whg", "whc", "h0"), a1, a2):
        assert x.grad.dtype == y.dtype
        _close(x.grad.numpy(), y.grad.numpy(), 1e-5, name)


def _jax_teacher_weights(w):
    conv = lambda v: tuple(map(jnp.asarray, v)) if isinstance(v, tuple) else jnp.asarray(v)
    return jtd.TeacherDecoderWeights(**{k: conv(v) for k, v in w.items()})


def _teacher_numpy_case(seed, S=5, B=3, L=13):
    # H = A = 128 (the Pallas forward asserts multiples of 128); L=13 and
    # D=96 are no multiple of its tiles; contractive weights
    rs = np.random.RandomState(seed)
    w, arrays = teacher_case(rs, S, B, L, H=128, A=128, D=96)
    return rs, w, arrays


def test_teacher_forward_plain_matches_jax_reference_and_pallas_interpret():
    # f32, the same arithmetic in other sum orders over 5 contractive steps
    # -> xs and states 1e-5 of their peak, alignments 1e-6 absolute
    _, w, arrays = _teacher_numpy_case(22)
    png, pnc, h0a, h0d, keys, memory, mask = arrays
    out = ttd.teacher_decoder_fwd_reference(*teacher_args(arrays)[:4], teacher_weights(w),
                                            *teacher_args(arrays)[4:])
    jargs = (*map(jnp.asarray, (png, pnc, h0a, h0d)), _jax_teacher_weights(w),
             jnp.asarray(keys), jnp.asarray(memory), jnp.asarray(mask.astype(np.float32)))
    xs_r, al_r = jtd.teacher_decoder_reference(*jargs)
    xs_p, al_p, ha_p, hds_p = jtd._teacher_decoder_fwd_pallas(*jargs, interpret=True)
    for xs_j, al_j in ((xs_r, al_r), (xs_p, al_p)):
        _close(out[0].numpy(), xs_j, 1e-5, "xs")
        np.testing.assert_allclose(out[1].numpy(), np.asarray(al_j), atol=1e-6)
    _close(out[2].numpy(), ha_p, 1e-5, "ha")
    for i in range(2):
        _close(out[3][i].numpy(), hds_p[i], 1e-5, f"hd_{i}")
    assert np.all(out[1].numpy()[:, ~mask] == 0.0)


def test_teacher_backward_plain_matches_pallas_interpret():
    # the same forward states (from the Pallas forward) and cotangents into
    # both backward paths; every output by name, f32 sums in other orders
    # over 5 steps x 3 rows -> 1e-5 of each output's peak
    rs, w, arrays = _teacher_numpy_case(23)
    png, pnc, h0a, h0d, keys, memory, mask = arrays
    maskf = jnp.asarray(mask.astype(np.float32))
    jw = _jax_teacher_weights(w)
    xs, al, ha, hds = (np.asarray(a) if not isinstance(a, tuple) else tuple(map(np.asarray, a))
                       for a in jtd._teacher_decoder_fwd_pallas(
                           *map(jnp.asarray, (png, pnc, h0a, h0d)), jw, jnp.asarray(keys),
                           jnp.asarray(memory), maskf, interpret=True))
    dxs = rs.randn(*xs.shape).astype(np.float32)
    dal = (rs.randn(*al.shape) * 0.1).astype(np.float32)
    shift = lambda a, a0: np.concatenate([a0[None], a[:-1]])
    hap, hdps = shift(ha, h0a), tuple(shift(hds[i], h0d[i]) for i in range(2))
    pp = shift(al, np.zeros_like(al[0]))
    j = jtd._teacher_decoder_bwd_pallas(
        *map(jnp.asarray, (png, pnc, ha, hap)), tuple(map(jnp.asarray, hds)),
        tuple(map(jnp.asarray, hdps)), *map(jnp.asarray, (xs, al, pp, dxs, dal)), jw,
        jnp.asarray(keys), jnp.asarray(memory), maskf, interpret=True)
    t = lambda a: torch.from_numpy(np.array(a))
    out = ttd.teacher_decoder_backward(
        *teacher_args(arrays)[:4], teacher_weights(w), *teacher_args(arrays)[4:],
        t(xs), t(al), t(ha), tuple(map(t, hds)), t(dxs), t(dal))
    S, B, L = al.shape
    names = ("dpng", "dpnc", "dh0a", "dh0d")
    for name, a, b in zip(names, out[:4], j[:4]):
        _close(a.numpy(), b, 1e-5, name)
    for name, a, b in zip(jtd.TeacherDecoderWeights._fields, out[4], j[4]):
        for x, y in zip(*((a, b) if isinstance(a, tuple) else ((a,), (b,)))):
            _close(x.numpy(), y, 1e-5, name)
    _close(out[5].numpy(), j[5], 1e-5, "dkeys")
    _close(out[6].numpy(), j[6], 1e-5, "dmemory")
    _close(out[7].numpy(), np.asarray(j[7])[:S, :B, :L], 1e-5, "de")
    _close(out[8].numpy(), np.asarray(j[8])[:S, :B], 1e-5, "dctx")
    assert np.all(out[7].numpy()[:, ~mask] == 0.0)       # no gradient at masked positions


def test_dkeys_plain_matches_pallas_interpret():
    # the Pallas kernel wants L a multiple of 128 and S of its chunk: pad L
    # with zero de (no contribution) and compare the 13 real positions;
    # f32 sums over 6 steps -> 1e-6 of the peak.  dv against numpy.
    rs = np.random.RandomState(24)
    S, B, L, A = 6, 3, 13, 128
    keys = (rs.randn(B, L, A) * 0.3).astype(np.float32)
    q = rs.randn(S, B, A).astype(np.float32)
    de = rs.randn(S, B, L).astype(np.float32)
    v = rs.randn(A).astype(np.float32)
    dk, dv = ttd.dkeys_reference(*map(torch.from_numpy, (keys, q, de, v)))
    pad = lambda a, axis: np.pad(a, [(0, 128 - L if i == axis else 0) for i in range(a.ndim)])
    dk_p = jtd._dkeys_pallas(jnp.asarray(pad(keys, 1)), jnp.asarray(q),
                             jnp.asarray(pad(de, 2)), jnp.asarray(v[None]), S,
                             interpret=True)
    _close(dk.numpy(), np.asarray(dk_p)[:, :L], 1e-6, "dkeys")
    act = np.tanh(keys[None] + q[:, :, None, :])
    _close(dv.numpy(), np.einsum("sbl,sbla->a", de, act), 1e-5, "dv")


def test_teacher_function_matches_autograd_of_plain_forward():
    # TeacherDecoder on CPU tensors (plain forward, plain backward) against
    # torch.autograd through teacher_decoder_reference, alignment cotangents
    # included; f32 -> 1e-4 of each gradient's peak (the autograd path
    # differentiates the same sums in other orders)
    rs = np.random.RandomState(25)
    w, arrays = teacher_case(rs, S=4, B=2, L=7, H=16, A=8, D=12)

    def run(fn):
        args = [a.requires_grad_() if a.is_floating_point() else a
                for a in teacher_args(arrays)]
        tw = teacher_weights(w)
        flat = [t.requires_grad_() for t in tw.flat()]
        tw = ttd.TeacherDecoderWeights.unflat(flat, 2)
        xs, al = fn(*args[:4], tw, *args[4:])
        (torch.sin(xs).sum() + (al * al).sum()).backward()
        return [a.grad for a in args if a.is_floating_point()] + [t.grad for t in flat]

    for n, (a, b) in enumerate(zip(run(ttd.teacher_decoder), run(ttd.teacher_decoder_reference))):
        _close(a.numpy(), b.numpy(), 1e-4, f"gradient {n}")


def test_wgrad_plain_rounds_both_factors():
    # bf16: the products round both factors, the bias sums do not
    a = torch.tensor([[[1.0 + 2 ** -9]], [[1.0]]])                   # [2, 1, 1]
    g = torch.tensor([[[1.0 + 2 ** -9, 3.0]], [[1.0, 0.0]]])         # [2, 1, 2]
    (c, bias), = twg.wgrad([(a, g, True)], torch.bfloat16)
    assert c.tolist() == [[2.0, 3.0]]
    assert bias.tolist() == [2.0 + 2 ** -9, 3.0]


def test_training_wrappers_take_the_plain_path_for_cpu_tensors():
    tgs.bwd_launches = ttd.fwd_launches = ttd.bwd_launches = ttd.dkeys_launches = 0
    twg.launches = 0
    rs = np.random.RandomState(26)
    (xg, xc, whg, whc, _), hprev, dys = _bigru_bwd_case(rs, T=4, B=2, F=16)
    args = [torch.from_numpy(a) for a in (xg, xc, hprev, dys, whg, whc)]
    for a, b in zip(tgs.bigru_scan_bwd(*args), tgs.bigru_scan_bwd_reference(*args)):
        assert torch.equal(a, b)
    w, arrays = teacher_case(rs, S=3, B=2, L=5, H=16, A=8, D=12)
    targs, tw = teacher_args(arrays), teacher_weights(w)
    out = ttd.teacher_decoder_fwd(*targs[:4], tw, *targs[4:])
    ref = ttd.teacher_decoder_fwd_reference(*targs[:4], tw, *targs[4:])
    assert all(torch.equal(a, b) for a, b in zip(out[:3], ref[:3]))
    keys, q, de = targs[4], torch.randn(3, 2, 8), torch.randn(3, 2, 5)
    assert all(torch.equal(a, b) for a, b in zip(ttd.dkeys(keys, q, de, tw.v),
                                                 ttd.dkeys_reference(keys, q, de, tw.v)))
    assert (tgs.bwd_launches, ttd.fwd_launches, ttd.bwd_launches, ttd.dkeys_launches,
            twg.launches) == (0, 0, 0, 0, 0)


def test_training_wrappers_raise_on_bad_inputs():
    rs = np.random.RandomState(27)
    (xg, xc, whg, whc, _), hprev, dys = _bigru_bwd_case(rs, T=4, B=2, F=16)
    args = [torch.from_numpy(a) for a in (xg, xc, hprev, dys, whg, whc)]
    with pytest.raises(ValueError, match="dys"):
        tgs.bigru_scan_bwd(*args[:3], args[3][:2], *args[4:])
    with pytest.raises(TypeError, match="hprev"):
        tgs.bigru_scan_bwd(args[0], args[1], args[2].double(), *args[3:])
    with pytest.raises(ValueError, match="cpu or cuda"):
        tgs.bigru_scan_bwd(*(a.to("meta") for a in args))
    w, arrays = teacher_case(rs, S=3, B=2, L=5, H=16, A=8, D=12)
    targs, tw = list(teacher_args(arrays)), teacher_weights(w)
    with pytest.raises(ValueError, match="pnc"):
        ttd.teacher_decoder_fwd(targs[0], targs[1][:, :, :3], *targs[2:4], tw, *targs[4:])
    with pytest.raises(TypeError, match="mask"):
        ttd.teacher_decoder_fwd(*targs[:4], tw, *targs[4:6], targs[6].float())
    with pytest.raises(ValueError, match="w_ctx"):
        ttd.teacher_decoder_fwd(*targs[:4], tw._replace(w_ctx=tw.w_ctx[:, :5]), *targs[4:])
    with pytest.raises(ValueError, match="de"):
        ttd.dkeys(targs[4], torch.zeros(3, 2, 8), torch.zeros(3, 2, 4), tw.v)
    with pytest.raises(ValueError, match="share"):
        twg.wgrad([(torch.zeros(2, 3, 4), torch.zeros(3, 2, 4), False)], torch.float32)
