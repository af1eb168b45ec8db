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
from tacotron_multispeaker_torch.device import warm_cpu_math  # noqa: E402
from test_torch_gpu import (bigru_inputs, decoder_case, split_bwd_reference,  # noqa: E402
                            teacher_args, teacher_case, teacher_weights, torch_weights)


@pytest.fixture(scope="module", autouse=True)
def _cpu_math_ready():
    # the tests call the port's ops on CPU tensors directly, not through an
    # entry point, so they make PyTorch's float32 math ready as the entry
    # points do (device.warm_cpu_math: a thread's first tanh of a process can
    # err by ~1e-4)
    warm_cpu_math()


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
    tgs.launches = tgs.fma_launches = 0
    tdl.launches = 0
    rs = np.random.RandomState(2)
    args = [torch.from_numpy(a) for a in bigru_inputs(rs, T=4, B=2, F=16)]
    assert torch.equal(tgs.bigru_scan(*args), tgs.bigru_scan_reference(*args))
    w, arrays, n_steps, M = decoder_case(rs, B=2, L=7, n_steps=3, H=32, A=16, D=24)
    tw, targs = torch_weights(w), [torch.from_numpy(a) for a in arrays]
    out = tdl.decoder_loop(tw, *targs, n_steps, M)
    ref = tdl.decoder_loop_reference(tw, *targs, n_steps, M)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert tgs.launches == tgs.fma_launches == 0 and tdl.launches == 0


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


@pytest.mark.parametrize("name,D", [("tiny", 64), ("single_speaker", 256),
                                    ("multispeaker_vctk", 320), ("pod_synthesis", 384)])
def test_decoder_loop_limits_take_every_preset(name, D):
    # the widths each preset gives the fused decoder kernel, at its longest
    # input and in both compute types
    from tacotron_multispeaker_torch.config import get_config
    from tacotron_multispeaker_torch.models.tacotron import _speaker_dim
    cfg = get_config(name)
    m, M = cfg.model, cfg.audio.num_mels
    assert m.encoder_depth + _speaker_dim(cfg, "memory") == D
    for vec in (4, 8):
        tdl.check_limits(L=cfg.train.max_input_length, A=m.attention_depth, D=D,
                         H=m.decoder_depth, M=M, P1=m.prenet_depths[0],
                         P2=m.prenet_depths[1], RM=m.outputs_per_step * M,
                         n_layers=m.decoder_layers, vec=vec)


def test_decoder_loop_limits_raise():
    ok = dict(L=192, A=256, D=320, H=256, M=80, P1=256, P2=128, RM=400, n_layers=2, vec=8)
    tdl.check_limits(**ok)
    for bad, match in (({"n_layers": 5}, "layers"), ({"D": 324}, "D=324"),
                       ({"P1": 4104}, "P1=4104"), ({"H": 684, "vec": 4}, "3H=2052"),
                       ({"RM": 40}, "num_mels"), ({"L": 20000}, "shared memory")):
        with pytest.raises(ValueError, match=match):
            tdl.check_limits(**{**ok, **bad})


# a plausible answer of the card: co-resident clusters by size
_COUNTS = {16: 7, 8: 16, 4: 33, 2: 66, 1: 132}


@pytest.mark.parametrize("B,want", [(1, 16), (3, 16), (32, 4), (256, 1)])
def test_decoder_loop_launch_plan(B, want):
    # the largest C whose B clusters the card holds at once; 1 past that
    assert tdl.launch_plan(B, 256, 8, _COUNTS) == want
    assert tdl.launch_plan(B, 256, 4, _COUNTS) == want


def test_decoder_loop_launch_plan_caps():
    # no C above the hidden width's 16-byte groups (tiny, bf16: 64 / 8)
    assert tdl.launch_plan(1, 64, 8, _COUNTS) == 8
    assert tdl.launch_plan(1, 64, 4, _COUNTS) == 16
    # sizes the card cannot hold are skipped
    assert tdl.launch_plan(1, 256, 8, {**_COUNTS, 16: 0, 8: 0}) == 4
    assert tdl.launch_plan(1, 256, 8, {1: 132}) == 1


@pytest.mark.parametrize("name,D", [("tiny", 64), ("single_speaker", 256),
                                    ("multispeaker_vctk", 320), ("pod_synthesis", 384)])
def test_teacher_fwd_limits_take_every_preset(name, D):
    # the widths each preset gives the teacher-forced forward kernel, at its
    # longest input, in both compute types, and a CTA's shared memory at
    # every cluster size
    from tacotron_multispeaker_torch.config import get_config
    from tacotron_multispeaker_torch.models.tacotron import _speaker_dim
    cfg = get_config(name)
    m, L = cfg.model, cfg.train.max_input_length
    assert m.encoder_depth + _speaker_dim(cfg, "memory") == D
    for vec in (4, 8):
        ttd.fwd_check_limits(L=L, A=m.attention_depth, D=D, H=m.decoder_depth,
                             N=m.decoder_layers, vec=vec)
        for C in ttd.CLUSTER_SIZES:
            assert ttd.fwd_smem_bytes(L, m.attention_depth, D, m.decoder_depth,
                                      m.decoder_layers, C, vec) <= ttd._SMEM_LIMIT


def test_teacher_fwd_limits_raise():
    ok = dict(L=192, A=256, D=384, H=256, N=2, vec=8)
    ttd.fwd_check_limits(**ok)
    for bad, match in (({"N": 5}, "layers"), ({"D": 324}, "D=324"), ({"H": 252}, "H=252"),
                       ({"H": 400, "vec": 4}, "4H=1600"), ({"A": 2880}, "A\\+H=3136"),
                       ({"D": 3080}, "D=3080"), ({"L": 20000}, "shared memory")):
        with pytest.raises(ValueError, match=match):
            ttd.fwd_check_limits(**{**ok, **bad})


def test_teacher_fwd_smem_grows_with_the_cluster():
    # each CTA keeps every rank's partial energies (C x L floats)
    one = ttd.fwd_smem_bytes(192, 256, 320, 256, 2, 1, 8)
    assert ttd.fwd_smem_bytes(192, 256, 320, 256, 2, 16, 8) == one + 15 * 192 * 4


@pytest.mark.parametrize("B,want", [(1, 16), (32, 2), (200, 1)])
def test_teacher_fwd_launch_plan(B, want):
    # the decoder loop's rule over the forward kernel's own co-resident
    # counts (those the card gives kernel 5 at these widths): C=2 at the
    # train batch's B=32, C=16 at B=1, one CTA a row past 66 rows
    counts = {16: 7, 8: 15, 4: 30, 2: 66, 1: 132}
    assert ttd.launch_plan(B, 256, 8, counts) == want
    # tiny's H=64 in bf16 leaves 8 groups of 8: no C above 8
    assert ttd.launch_plan(1, 64, 8, counts) == 8


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


@pytest.mark.parametrize("F", [128, 32])
def test_bigru_split_backward_plain_matches_pallas_interpret(F):
    # the card's two launches as plain parts: the prologue over all T*B rows
    # (r, u, c and r*h_prev), then the gradient-only scan, then the weight
    # gradients from their factors.  f32, T=9 B=3, at the post-net's F=128
    # and tiny's F=32: against the Pallas kernel (the same arithmetic in
    # another sum order) and the whole plain backward, 1e-5 of each peak
    rs = np.random.RandomState(22 + F)
    (xg, xc, whg, whc, h0), hprev, dys = _bigru_bwd_case(rs, T=9, B=3, F=F)
    targs = [torch.from_numpy(a) for a in (xg, xc, hprev, dys, whg, whc)]
    tgs.bwd_remat_launches = 0
    ruc, rh = tgs.bwd_remat(*targs[:3], *targs[4:])
    assert tgs.bwd_remat_launches == 0                      # CPU: the plain version
    ruc_r, rh_r = tgs.bigru_bwd_remat_reference(*targs[:3], *targs[4:])
    assert torch.equal(ruc, ruc_r) and torch.equal(rh, rh_r)
    assert ruc.shape == (9, 2, 3, 3 * F) and rh.shape == (9, 2, 3, F)
    out = split_bwd_reference(*targs)
    whole = tgs.bigru_scan_bwd_reference(*targs)
    pallas = jgs._bigru_scan_bwd_pallas(*map(jnp.asarray, (xg, xc, hprev, dys, whg, whc)),
                                        interpret=True)
    for name, a, b, c in zip(("dxg", "dxc", "dwhg", "dwhc", "dh0"), out, whole, pallas):
        assert a.dtype == torch.float32
        _close(a.numpy(), b.numpy(), 1e-5, f"{name} vs the whole plain backward")
        _close(a.numpy(), c, 1e-5, f"{name} vs the Pallas kernel")


def test_bigru_split_backward_prologue_rebuilds_the_forward():
    # the prologue's r, u and c give back the forward's next state
    # (u*h_prev + (1-u)*c = ys) and rh = r*h_prev; f32 -> 1e-5 of the peak
    rs = np.random.RandomState(23)
    args = bigru_inputs(rs, T=6, B=2, F=32)
    ys = tgs.bigru_scan_reference(*map(torch.from_numpy, args))
    hprev = torch.cat([torch.from_numpy(args[4])[None], ys[:-1]])
    xg, xc, whg, whc = (torch.from_numpy(a) for a in args[:4])
    ruc, rh = tgs.bwd_remat(xg, xc, hprev, whg, whc)
    r, u, c = ruc[..., :32], ruc[..., 32:64], ruc[..., 64:]
    _close((u * hprev + (1.0 - u) * c).numpy(), ys.numpy(), 1e-5, "next state")
    _close(rh.numpy(), (r * hprev).numpy(), 1e-5, "rh")


@pytest.mark.parametrize("name", ["tiny", "single_speaker", "multispeaker_vctk",
                                  "large_multispeaker", "pod_synthesis"])
def test_gru_bwd_limits_take_every_preset(name):
    # both launches of the GRU scan backward (the prologue and the scan) at
    # each preset's widths (the encoder BiGRU's encoder_depth / 2 and the
    # post-net's postnet_gru_units: tiny's 32, 128 elsewhere) and batch
    # (up to pod_synthesis's 256), over its longest output, in both compute
    # types; the shared memory of both blocks within a block's limit
    from tacotron_multispeaker_torch.config import get_config
    cfg = get_config(name)
    m, tr = cfg.model, cfg.train
    widths = {m.encoder_depth // 2, m.postnet_gru_units}
    assert widths <= {32, 128} and tr.batch_size <= 256
    for F in widths:
        for esize in (2, 4):
            tgs.bwd_check_limits(T=tr.max_output_length, B=tr.batch_size, F=F, esize=esize)
            assert all(s <= tgs._SMEM_LIMIT for s in tgs.bwd_smem_bytes(F, esize))


def test_gru_bwd_limits_raise():
    ok = dict(T=1000, B=32, F=128, esize=2)
    tgs.bwd_check_limits(**ok)
    tgs.bwd_check_limits(**{**ok, "F": 184})            # the widest bf16 scan
    tgs.bwd_check_limits(**{**ok, "F": 128, "esize": 4})  # the widest f32 scan
    for bad, match in (({"F": 100}, "multiple of 8"), ({"F": 200}, "768"),
                       ({"F": 520}, "1024 threads"), ({"B": 70000}, "65535"),
                       ({"T": 2 ** 26, "B": 64}, "2\\^31"), ({"F": 192}, "scan"),
                       ({"F": 136, "esize": 4}, "scan")):
        with pytest.raises(ValueError, match=match):
            tgs.bwd_check_limits(**{**ok, **bad})


@pytest.mark.parametrize("name", ["tiny", "single_speaker", "multispeaker_vctk",
                                  "large_multispeaker", "pod_synthesis"])
def test_gru_fwd_routes_take_every_preset(name):
    # the forward at each preset's widths (the encoder BiGRU's encoder_depth
    # / 2 and the post-net's postnet_gru_units) and batch: bf16 takes the
    # tensor cores, f32 the FMA kernel, and both routes' limits hold (the
    # shared memory of a block within a block's limit)
    from tacotron_multispeaker_torch.config import get_config
    cfg = get_config(name)
    m, tr = cfg.model, cfg.train
    for F in {m.encoder_depth // 2, m.postnet_gru_units}:
        assert tgs.fwd_route(F, torch.bfloat16) == "mma"
        assert tgs.fwd_route(F, torch.float32) == "fma"
        for route, esize in (("mma", 2), ("fma", 2), ("fma", 4)):
            tgs.fwd_check_limits(B=tr.batch_size, F=F, esize=esize, route=route)
            assert tgs.fwd_smem_bytes(F, esize, route) <= tgs._SMEM_LIMIT


@pytest.mark.parametrize("F,dtype,route", [
    (128, torch.bfloat16, "mma"), (32, torch.bfloat16, "mma"), (72, torch.bfloat16, "mma"),
    (8, torch.bfloat16, "mma"), (100, torch.bfloat16, "fma"), (136, torch.bfloat16, "fma"),
    (195, torch.bfloat16, "fma"), (128, torch.float32, "fma"), (32, torch.float32, "fma"),
    (0, torch.bfloat16, "fma")])
def test_gru_fwd_route(F, dtype, route):
    # tensor cores for bf16 with F a multiple of 8 up to the register
    # budget's 128; f32 (whose product there would be TF32) and every other
    # bf16 width on the FMA kernel, which took them before
    assert tgs.fwd_route(F, dtype) == route


def test_gru_fwd_limits_raise():
    ok = dict(B=32, F=128, esize=2)
    tgs.fwd_check_limits(**ok, route="mma")
    tgs.fwd_check_limits(**ok, route="fma")
    tgs.fwd_check_limits(**{**ok, "B": 4 * 65535}, route="mma")   # 4 rows a block
    tgs.fwd_check_limits(**{**ok, "F": 195}, route="fma")          # the widest bf16 FMA block
    tgs.fwd_check_limits(**{**ok, "F": 138, "esize": 4}, route="fma")
    for bad, route, match in (({"F": 136}, "mma", "tensor-core"),
                              ({"F": 100}, "mma", "tensor-core"),
                              ({"esize": 4}, "mma", "tensor-core"),
                              ({"B": 4 * 65535 + 1}, "mma", "rows"),
                              ({"F": 520}, "fma", "1024 threads"),
                              ({"B": 65536}, "fma", "65535"),
                              ({"F": 196}, "fma", "shared memory"),
                              ({"F": 139, "esize": 4}, "fma", "shared memory"),
                              ({}, "tf32", "route")):
        with pytest.raises(ValueError, match=match):
            tgs.fwd_check_limits(**{**ok, **bad}, route=route)


def test_gru_fwd_smem_counts():
    # the mirror of bigru_scan_smem_bytes: the tensor-core block's two
    # [8][16 ceil(F/16) + 8] B-operand buffers and three slots of 4 rows of
    # xg and xc padded by 8 elements; the FMA block's weights and four
    # vectors of F floats
    assert tgs.fwd_smem_bytes(128, 2, "mma") == (2 * 8 * 136 + 3 * 4 * 400) * 2 == 13952
    assert tgs.fwd_smem_bytes(72, 2, "mma") == (2 * 8 * 88 + 3 * 4 * 232) * 2
    assert tgs.fwd_smem_bytes(128, 2, "fma") == 3 * 128 * 128 * 2 + 4 * 128 * 4
    assert tgs.fwd_smem_bytes(100, 4, "fma") == 3 * 100 * 100 * 4 + 4 * 100 * 4


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


def _pallas_teacher_case(seed):
    """A numpy case, its Pallas forward's states (interpret mode) and the
    backward's shifted states: (rs, w, arrays, (xs, al, ha, hds), (hap,
    hdps, pp))."""
    rs, w, arrays = _teacher_numpy_case(seed)
    png, pnc, h0a, h0d, keys, memory, mask = arrays
    states = tuple(np.asarray(a) if not isinstance(a, tuple) else tuple(map(np.asarray, a))
                   for a in jtd._teacher_decoder_fwd_pallas(
                       *map(jnp.asarray, (png, pnc, h0a, h0d)), _jax_teacher_weights(w),
                       jnp.asarray(keys), jnp.asarray(memory),
                       jnp.asarray(mask.astype(np.float32)), interpret=True))
    xs, al, ha, hds = states
    shift = lambda a, a0: np.concatenate([a0[None], a[:-1]])
    shifted = (shift(ha, h0a), tuple(shift(hds[i], h0d[i]) for i in range(2)),
               shift(al, np.zeros_like(al[0])))
    return rs, w, arrays, states, shifted


def _torch_bwd_args(w, arrays, states, shifted, pp, dxs, dal):
    """The arguments of ``teacher_decoder_bwd`` as CPU tensors."""
    t = lambda a: torch.from_numpy(np.array(a))
    targs = teacher_args(arrays)
    xs, al, ha, hds = states
    hap, hdps, _ = shifted
    return (targs[0], targs[1], t(ha), t(hap), tuple(map(t, hds)), tuple(map(t, hdps)),
            t(xs), t(al), t(pp), t(dxs), t(dal), teacher_weights(w), *targs[4:])


def test_teacher_remat_plain_rebuilds_pallas_forward_states():
    # the backward's prologue from the Pallas forward's states: each GRU's
    # r, u, c give back its next state (u*h_prev + (1-u)*c = hds[i], ha),
    # r*h_prev is rh, ctx = p_t @ memory and q = ha @ wq; f32, the same
    # products in other sum orders -> 1e-5 of each peak
    _, w, arrays, states, shifted = _pallas_teacher_case(28)
    xs, al, ha, hds = states
    hap, hdps, pp = shifted
    memory = arrays[5]
    args = _torch_bwd_args(w, arrays, states, shifted, pp, np.zeros_like(xs),
                           np.zeros_like(al))
    xin, rh, ruc, rh_a, ctx, q = ttd.teacher_bwd_remat(*args)
    H = ha.shape[-1]
    for name, i, h, hp, rh_i in (("hd_0", 0, hds[0], hdps[0], rh[0]),
                                 ("hd_1", 1, hds[1], hdps[1], rh[1]),
                                 ("ha", 2, ha, hap, rh_a)):
        r, u, c = (ruc[i][..., k * H:(k + 1) * H].numpy() for k in range(3))
        _close(u * hp + (1.0 - u) * c, h, 1e-5, name)
        _close(rh_i.numpy(), r * hp, 1e-5, f"rh of {name}")
    _close(ctx.numpy(), np.einsum("sbl,bld->sbd", al, memory), 1e-5, "ctx")
    _close(q.numpy(), ha @ w["wq"], 1e-5, "q")
    _close(xin[1].numpy(), xs - hds[1], 1e-5, "xin[1]")
    _close(xin[0].numpy(), xs - hds[1] - hds[0], 1e-5, "xin[0]")


@pytest.mark.parametrize("pp_kind", ["shifted", "random"])
def test_teacher_split_backward_matches_pallas_interpret(pp_kind):
    # teacher_decoder_bwd on CPU tensors (the plain prologue over all rows,
    # then the plain scan) against _teacher_decoder_bwd_pallas on the same
    # arguments, every output by name; pp is an argument of both, so a pp
    # that is not the alignments shifted must give the same gradients too.
    # f32 sums in other orders over 5 steps x 3 rows -> 1e-5 of each peak
    rs, w, arrays, states, shifted = _pallas_teacher_case(29)
    png, pnc, h0a, h0d, keys, memory, mask = arrays
    xs, al, ha, hds = states
    hap, hdps, pp = shifted
    if pp_kind == "random":
        pp = (rs.rand(*al.shape) * mask[None] / mask.sum(-1)[None, :, None]).astype(np.float32)
    dxs = rs.randn(*xs.shape).astype(np.float32)
    dal = (rs.randn(*al.shape) * 0.1).astype(np.float32)
    j = jtd._teacher_decoder_bwd_pallas(
        *map(jnp.asarray, (png, pnc, ha, hap)), tuple(map(jnp.asarray, hds)),
        tuple(map(jnp.asarray, hdps)), *map(jnp.asarray, (xs, al, pp, dxs, dal)),
        _jax_teacher_weights(w), jnp.asarray(keys), jnp.asarray(memory),
        jnp.asarray(mask.astype(np.float32)), interpret=True)
    dpng, dpnc, de, dctx, dh0a, dh0d, dw = ttd.teacher_decoder_bwd(
        *_torch_bwd_args(w, arrays, states, shifted, pp, dxs, dal))
    S, B, L = al.shape
    for name, a, b in (("dpng", dpng, j[0]), ("dpnc", dpnc, j[1]), ("dh0a", dh0a, j[2]),
                       ("dh0d", dh0d, j[3]), ("de", de, np.asarray(j[7])[:S, :B, :L]),
                       ("dctx", dctx, np.asarray(j[8])[:S, :B])):
        _close(a.numpy(), b, 1e-5, name)
    for name, a, b in zip(jtd.TeacherDecoderWeights._fields, dw, j[4]):
        if name == "v":                # summed by dkeys, outside this function
            continue
        for x, y in zip(*((a, b) if isinstance(a, tuple) else ((a,), (b,)))):
            _close(x.numpy(), y, 1e-5, name)


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


def test_dkeys_plain_matches_pallas_interpret_on_saturated_inputs():
    # keys and q uniform in [-40, 40]: the inputs on which the card kernel
    # takes its guarded tanhf (|k| or |q| > 20) or sums k + q up to 40, so
    # its card test stands on a checked plain version; tanh saturates there,
    # the f32 sums over 6 steps -> 1e-6 of the peak, dv against numpy 1e-5
    rs = np.random.RandomState(28)
    S, B, L, A = 6, 3, 13, 128
    keys = rs.uniform(-40, 40, (B, L, A)).astype(np.float32)
    q = rs.uniform(-40, 40, (S, B, A)).astype(np.float32)
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
    # most elements saturate (|k + q| > 9: 1 - tanh^2 below 1e-7), and the
    # guard's share of them is real
    assert (np.abs(keys[None] + q[:, :, None, :]) > 9).mean() > 0.5
    assert (np.maximum(np.abs(keys)[None], np.abs(q)[:, :, None, :]) > 20).mean() > 0.5


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
    twg.launches = twg.fma_launches = 0
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
            twg.launches, twg.fma_launches) == (0, 0, 0, 0, 0, 0)


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
