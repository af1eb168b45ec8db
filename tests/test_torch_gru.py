"""The port's one-direction GRU scan (kernels 1 and 2 of the JAX package's
``ops/gru_scan.py``: ``gru_scan_pallas`` and ``_gru_scan_bwd_pallas``) and the
``GRU`` module that calls it, against the JAX package on the CPU.

The plain versions (what the wrappers run for CPU tensors) are held against
the Pallas kernels in interpret mode; ``GRUScan`` against ``jax.grad`` of the
JAX ``gru_scan`` custom VJP; the port's ``GRU`` (both routes, both
directions, ragged lengths) against JAX ``GRU(F, use_pallas=True)`` with the
same weights carried over by ``convert.py``.  The kernels against their
plain versions on the card are in ``test_torch_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the comparisons with the JAX package run where flax is installed
pytest.importorskip("flax")

from tacotron_multispeaker_tpu.models import modules as jmod  # noqa: E402
from tacotron_multispeaker_tpu.ops import gru_scan as jgs  # noqa: E402
from tacotron_multispeaker_torch import convert  # noqa: E402
from tacotron_multispeaker_torch.device import warm_cpu_math  # noqa: E402
from tacotron_multispeaker_torch.models import modules as tmod  # noqa: E402
from tacotron_multispeaker_torch.ops import gru_scan as tgs  # noqa: E402
from tacotron_multispeaker_torch.ops import wgrad as twg  # noqa: E402
from test_torch_gpu import gru_inputs, split_bwd_reference  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _cpu_math_ready():
    # the tests call the port's ops on CPU tensors directly, not through an
    # entry point, so they make PyTorch's float32 math ready as the entry
    # points do (device.warm_cpu_math: a thread's first tanh of a process can
    # err by ~1e-4)
    warm_cpu_math()


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("T,B,F", [(16, 2, 128), (37, 3, 128)])
def test_gru_scan_plain_matches_pallas_interpret(T, B, F):
    # f32, the same math: only the order of the F-term sums differs -> 1e-5
    args = gru_inputs(np.random.RandomState(T), T, B, F)
    ys_t = tgs.gru_scan(*_t(args)).numpy()
    ys_p = np.asarray(jgs.gru_scan_pallas(*map(jnp.asarray, args), interpret=True,
                                          time_chunk=32))
    ys_r = np.asarray(jgs.gru_scan_reference(*map(jnp.asarray, args)))
    assert ys_t.shape == ys_p.shape == (T, B, F)
    np.testing.assert_allclose(ys_t, ys_p, atol=1e-5)
    np.testing.assert_allclose(ys_t, ys_r, atol=1e-5)


def test_gru_scan_plain_bf16_matches_pallas_interpret():
    # bf16 streams and weights, f32 h0 and carry: both sides round the same
    # matmul inputs; a sum-order difference can flip one bf16 rounding (ulp
    # 2^-8 near 1), which the recurrence carries -> 2e-2
    xg, xc, whg, whc, h0 = gru_inputs(np.random.RandomState(3), 20, 3, 128)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    ys_p = jgs.gru_scan_pallas(bf(xg), bf(xc), bf(whg), bf(whc), jnp.asarray(h0),
                               interpret=True, time_chunk=32)
    t = _t((xg, xc, whg, whc, h0))
    ys_t = tgs.gru_scan(*(a.to(torch.bfloat16) for a in t[:4]), t[4])
    assert ys_t.dtype == torch.bfloat16 and ys_p.dtype == jnp.bfloat16
    np.testing.assert_allclose(ys_t.float().numpy(), np.asarray(ys_p.astype(jnp.float32)),
                               atol=2e-2)


@pytest.mark.parametrize("T,B,F", [(16, 2, 128), (37, 3, 128)])
def test_gru_scan_bwd_plain_matches_pallas_interpret(T, B, F):
    # the backward from the forward's states: f32 on both sides; dW sums
    # T*B rounded products in another order -> 1e-4 of each output's peak
    rs = np.random.RandomState(T + 1)
    xg, xc, whg, whc, h0 = gru_inputs(rs, T, B, F)
    ys = np.asarray(jgs.gru_scan_reference(*map(jnp.asarray, (xg, xc, whg, whc, h0))))
    hprev = np.concatenate([h0[None], ys[:-1]]).astype(np.float32)
    dys = rs.randn(T, B, F).astype(np.float32)
    args = (xg, xc, hprev, dys, whg, whc)
    out_t = tgs.gru_scan_bwd(*_t(args))
    out_p = jgs._gru_scan_bwd_pallas(*map(jnp.asarray, args), interpret=True, time_chunk=32)
    for name, a, b in zip(("dxg", "dxc", "dwhg", "dwhc", "dh0"), out_t, out_p):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4 * max(np.abs(b).max(), 1.0),
                                   err_msg=name)


@pytest.mark.parametrize("T,B,F", [(16, 2, 128), (37, 3, 32)])
def test_gru_scan_split_backward_plain_matches_pallas_interpret(T, B, F):
    # one direction through the card's two launches as plain parts (the
    # prologue over all T*B rows, the gradient-only scan, the weight
    # gradients from their factors) against the Pallas kernel, at the CBHG
    # width F=128 and tiny's F=32: 1e-4 of max(peak, 1) as the whole plain
    # backward's test above; the one-direction prologue wrapper on CPU
    # tensors is its plain version
    rs = np.random.RandomState(T + 2)
    xg, xc, whg, whc, h0 = gru_inputs(rs, T, B, F)
    ys = np.asarray(jgs.gru_scan_reference(*map(jnp.asarray, (xg, xc, whg, whc, h0))))
    hprev = np.concatenate([h0[None], ys[:-1]]).astype(np.float32)
    dys = rs.randn(T, B, F).astype(np.float32)
    args = (xg, xc, hprev, dys, whg, whc)
    t = _t(args)
    out = split_bwd_reference(*(a[:, None] for a in t[:4]), t[4][None], t[5][None])
    out = [a[:, 0] if a.dim() == 4 else a[0] for a in out]
    out_p = jgs._gru_scan_bwd_pallas(*map(jnp.asarray, args), interpret=True, time_chunk=32)
    for name, a, b in zip(("dxg", "dxc", "dwhg", "dwhc", "dh0"), out, out_p):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4 * max(np.abs(b).max(), 1.0),
                                   err_msg=name)
    tgs.gru_bwd_remat_launches = 0
    ruc, rh = tgs.bwd_remat(t[0], t[1], t[2], t[4], t[5])
    ruc_r, rh_r = tgs.bigru_bwd_remat_reference(t[0][:, None], t[1][:, None], t[2][:, None],
                                                t[4][None], t[5][None])
    assert torch.equal(ruc, ruc_r[:, 0]) and torch.equal(rh, rh_r[:, 0])
    assert ruc.shape == (T, B, 3 * F) and tgs.gru_bwd_remat_launches == 0


@pytest.mark.parametrize("T,B,F", [(16, 2, 128), (37, 3, 128), (130, 4, 256)])
def test_gru_scan_function_grads_match_jax_grad(T, B, F):
    # the shapes and tolerances of the JAX package's own custom-VJP test
    # (test_ops_pallas.py test_gru_scan_grad_matches_reference): loss 1e-5
    # relative, gradients rtol 1e-4 and atol 1e-3 of max(peak, 1)
    rs = np.random.RandomState(11)
    f = lambda *s, sc: (rs.randn(*s) * sc).astype(np.float32)
    args = (f(T, B, 2 * F, sc=0.5), f(T, B, F, sc=0.5), f(F, 2 * F, sc=0.1),
            f(F, F, sc=0.1), f(B, F, sc=0.1))
    w = rs.randn(T, B, F).astype(np.float32)
    jw = jnp.asarray(w)
    loss_j = lambda a: jnp.sum(jgs.gru_scan(*a, True, 32) * jw)
    jargs = tuple(map(jnp.asarray, args))
    g_j = jax.grad(loss_j)(jargs)
    targs = [a.requires_grad_() for a in _t(args)]
    loss_t = (tgs.GRUScan.apply(*targs) * torch.from_numpy(w)).sum()
    np.testing.assert_allclose(loss_t.item(), float(loss_j(jargs)), rtol=1e-5)
    loss_t.backward()
    for name, a, b in zip(("xg", "xc", "whg", "whc", "h0"), targs, g_j):
        b = np.asarray(b)
        np.testing.assert_allclose(a.grad.numpy(), b, rtol=1e-4,
                                   atol=1e-3 * max(float(np.abs(b).max()), 1.0), err_msg=name)


@pytest.fixture(scope="module")
def gru_pair():
    """(JAX GRU(F, use_pallas=True), its numpy variables, xs, lengths, loss
    weights) at the JAX module test's shapes: B=3, T=25, D=64, F=128."""
    rs = np.random.RandomState(12)
    B, T, D, F = 3, 25, 64, 128
    xs = rs.randn(B, T, D).astype(np.float32)
    lengths = np.array([25, 11, 17])
    w = rs.randn(B, T, F).astype(np.float32)
    jm = jmod.GRU(F, use_pallas=True)
    v = jax.tree.map(np.asarray, jax.device_get(
        jmod.GRU(F).init(jax.random.PRNGKey(0), jnp.asarray(xs), jnp.asarray(lengths))))
    return jm, v, xs, lengths, w


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_module_matches_jax(gru_pair, use_pallas, reverse):
    # forward: f32, the same math (the kernel route's plain version, or the
    # per-step cell) -> 1e-5 absolute; parameter gradients against jax.grad
    # of the JAX module on its kernel route: rtol 1e-4, atol 1e-3 x
    # max(peak, 1), the JAX module test's own
    jm, v, xs, lengths, w = gru_pair
    F = w.shape[-1]
    model = tmod.GRU(xs.shape[-1], F, use_pallas=use_pallas)
    model.load_state_dict(convert.flax_to_state_dict(v, model), strict=True)
    jx, jl, jw = map(jnp.asarray, (xs, lengths, w))
    ys_j = jm.apply(v, jx, jl, reverse=reverse)
    g_j = jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, jx, jl, reverse=reverse) * jw))(
        v["params"])
    tgs.gru_launches = tgs.gru_fma_launches = tgs.gru_bwd_launches = 0
    ys_t = model(torch.from_numpy(xs), torch.from_numpy(lengths), reverse=reverse)
    np.testing.assert_allclose(ys_t.detach().numpy(), np.asarray(ys_j), atol=1e-5)
    # padded steps are exactly zero on both sides
    pad = np.arange(xs.shape[1])[None, :] >= lengths[:, None]
    assert np.all(ys_t.detach().numpy()[pad] == 0.0)
    (ys_t * torch.from_numpy(w)).sum().backward()
    got = dict(_leaves(convert.grads_to_flax(model)))
    for path, b in _leaves(jax.device_get(g_j)):
        np.testing.assert_allclose(got[path], b, rtol=1e-4,
                                   atol=1e-3 * max(float(np.abs(b).max()), 1.0),
                                   err_msg=f"{'/'.join(path)} reverse={reverse}")
    assert tgs.gru_launches == tgs.gru_fma_launches == tgs.gru_bwd_launches == 0  # CPU: plain


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_gru_module_bf16_routes_agree():
    # bf16 compute on both routes: the kernel route keeps an f32 carry and
    # rounds the matmul inputs, the per-step route (flax's nn.scan) rounds
    # each Dense output; over 20 steps of O(1) states -> 5e-2
    rs = np.random.RandomState(13)
    xs = torch.from_numpy(rs.randn(2, 20, 24).astype(np.float32))
    lengths = torch.tensor([20, 9])
    a = tmod.GRU(24, 32, torch.bfloat16, use_pallas=True)
    b = tmod.GRU(24, 32, torch.bfloat16)
    b.load_state_dict(a.state_dict())
    ya, yb = a(xs, lengths, reverse=True), b(xs, lengths, reverse=True)
    assert ya.dtype == torch.bfloat16
    np.testing.assert_allclose(ya.float().detach().numpy(), yb.float().detach().numpy(),
                               atol=5e-2)


def test_bigru_keeps_its_parameter_tree():
    # GRU's new switch adds no tensor: BiGRU's leaves are the converter's
    names = sorted(tmod.BiGRU(16, 8).state_dict())
    assert names == sorted(f"{d}.cell.{p}.{k}" for d in ("bwd", "fwd")
                           for p, k in (("xg", "weight"), ("xg", "bias"), ("hg", "weight"),
                                        ("xc", "weight"), ("xc", "bias"), ("hc", "weight")))


def test_gru_wrappers_raise_on_bad_inputs_and_cpu_launches_nothing():
    tgs.gru_launches = tgs.gru_fma_launches = tgs.gru_bwd_launches = twg.launches = 0
    twg.fma_launches = 0
    args = _t(gru_inputs(np.random.RandomState(4), 5, 2, 16))
    assert torch.equal(tgs.gru_scan(*args), tgs.gru_scan_reference(*args))
    with pytest.raises(ValueError, match="xg"):
        tgs.gru_scan(args[0][..., :-1], *args[1:])
    with pytest.raises(ValueError, match="xc"):
        tgs.gru_scan(args[0], args[1][:, :1], *args[2:])
    with pytest.raises(ValueError, match="whc"):
        tgs.gru_scan(*args[:3], args[3][:8], args[4])
    with pytest.raises(TypeError, match="h0"):
        tgs.gru_scan(*args[:4], args[4].double())
    with pytest.raises(TypeError, match="xc"):
        tgs.gru_scan(args[0], args[1].to(torch.bfloat16), *args[2:])
    with pytest.raises(ValueError, match="cpu or cuda"):
        tgs.gru_scan(*(a.to("meta") for a in args))
    hprev = torch.zeros_like(args[1])
    with pytest.raises(ValueError, match="dys"):
        tgs.gru_scan_bwd(args[0], args[1], hprev, hprev[:2], *args[2:4])
    with pytest.raises(ValueError, match="reverse"):
        tmod.GRU(4, 8)(torch.zeros(1, 3, 4), reverse=True)
    assert (tgs.gru_launches == tgs.gru_fma_launches == tgs.gru_bwd_launches == twg.launches
            == twg.fma_launches == 0)
