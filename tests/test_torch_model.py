"""The port's model modules against the JAX package's flax modules.

Each flax module's variables are shaped with ``jax.eval_shape`` and filled
with numpy (random non-trivial BatchNorm statistics where it has them), go
through convert.py into the port's module, and both run on the same numpy
inputs, in float32 on the CPU.  Tolerances: 1e-5 for feed-forward modules (same f32 math, sums in
another order), 1e-4 where a recurrence or an autoregressive loop carries
those differences forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the JAX package's models need flax: where it is not installed this module
# skips, and `pytest -m gpu tests/test_torch_*.py` still collects the gpu tests
pytest.importorskip("flax")

from tacotron_multispeaker_tpu import config as jconfig
from tacotron_multispeaker_tpu.models import attention as jatt
from tacotron_multispeaker_tpu.models import create_model as jcreate_model
from tacotron_multispeaker_tpu.models import modules as jmod
from tacotron_multispeaker_tpu.training import create_train_state
from tacotron_multispeaker_torch import config as tconfig
from tacotron_multispeaker_torch import convert
from tacotron_multispeaker_torch.models import attention as tatt
from tacotron_multispeaker_torch.models import create_model
from tacotron_multispeaker_torch.models import modules as tmod


def _fill(abstract, rs):
    """Numpy values for an abstract flax variable tree (``jax.eval_shape``
    of ``init``; tracing nothing numerically keeps the tests fast):
    lecun-scaled kernels, small biases, and non-trivial BatchNorm scales
    and running statistics."""
    def leaf(path, s):
        name = path[-1].key
        if name in ("kernel", "embedding", "v"):
            fan_in = int(np.prod(s.shape[:-1])) if name != "embedding" else s.shape[-1]
            return (rs.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            return rs.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "var":
            return rs.uniform(0.5, 2.0, s.shape).astype(np.float32)
        # np.asarray: randn() of the 0-d score bias ``b`` is a Python float
        return np.asarray(rs.randn(*s.shape) * (0.5 if name == "mean" else 0.1), np.float32)
    out = jax.tree_util.tree_map_with_path(leaf, dict(abstract))
    out.setdefault("batch_stats", {})
    return out


def _variables(jm, *args, seed=0, **kw):
    abstract = jax.eval_shape(
        lambda k: jm.init({"params": k, "dropout": k}, *args, **kw),
        jax.random.PRNGKey(seed))
    return _fill(abstract, np.random.RandomState(seed))


def _apply(jm, variables, *args, **kw):
    return jax.jit(lambda v, *a: jm.apply(v, *a, **kw))(variables, *args)


def _port(module, variables):
    module.load_state_dict(convert.flax_to_state_dict(variables, module), strict=True)
    return module.eval()


def _run(module, *args):
    with torch.inference_mode():
        return module(*args)


def test_prenet_without_dropout():
    x = np.random.RandomState(0).randn(2, 5, 48).astype(np.float32)
    jm = jmod.Prenet((64, 32), 0.0)
    v = _variables(jm, x)
    y_j = _apply(jm, v, x, rngs={"dropout": jax.random.PRNGKey(0)})
    y_t = _run(_port(tmod.Prenet(48, (64, 32), 0.0), v), torch.from_numpy(x))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)


def test_highway():
    x = np.random.RandomState(1).randn(3, 4, 16).astype(np.float32)
    jm = jmod.HighwayNet(16)
    v = _variables(jm, x)
    y_j = _apply(jm, v, x)
    y_t = _run(_port(tmod.HighwayNet(16), v), torch.from_numpy(x))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)


@pytest.mark.parametrize("bank_k", [4, 5])
def test_conv_bank_eval_mode(bank_k):
    rs = np.random.RandomState(bank_k)
    x = rs.randn(2, 9, 12).astype(np.float32)
    jm = jmod.ConvBank(bank_k, 8)
    v = _variables(jm, x, train=False, seed=bank_k)
    y_j = _apply(jm, v, x, train=False)
    y_t = _run(_port(tmod.ConvBank(12, bank_k, 8), v), torch.from_numpy(x))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)


def test_bigru_ragged_lengths():
    rs = np.random.RandomState(3)
    x = rs.randn(3, 7, 5).astype(np.float32)
    lengths = np.array([7, 4, 1])
    jm = jmod.BiGRU(6)
    v = _variables(jm, x, lengths)
    y_j = np.asarray(_apply(jm, v, x, lengths))
    y_t = _run(_port(tmod.BiGRU(5, 6), v), torch.from_numpy(x),
               torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(y_t, y_j, atol=1e-5)
    assert np.all(y_t[1, 4:] == 0.0) and np.all(y_t[2, 1:] == 0.0)


def test_cbhg_eval_mode_with_random_batch_stats():
    rs = np.random.RandomState(4)
    x = rs.randn(2, 11, 12).astype(np.float32)
    lengths = np.array([11, 6])
    jm = jmod.CBHG(4, 8, (16, 12), 2, highway_depth=8, gru_units=6)
    v = _variables(jm, x, lengths, train=False)
    assert "highway_in" in v["params"] and v["batch_stats"]
    y_j = _apply(jm, v, x, lengths, train=False)
    port = tmod.CBHG(12, 4, 8, (16, 12), 2, highway_depth=8, gru_units=6)
    y_t = _run(_port(port, v), torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)


def test_bahdanau_attention_step_and_masked_softmax():
    rs = np.random.RandomState(5)
    B, L, Q, D, A = 3, 9, 10, 14, 16
    query = rs.randn(B, Q).astype(np.float32)
    memory = rs.randn(B, L, D).astype(np.float32)
    mask = np.arange(L)[None, :] < np.array([9, 5, 1])[:, None]
    jm = jatt.BahdanauAttention(A)

    def step(mod, q, mem, m):
        keys = mod.precompute_keys(mem)
        ctx, align, _ = mod(q, keys, mem, m, mod.init_state(q.shape[0], mem.shape[1]))
        return ctx, align

    jargs = (jnp.asarray(query), jnp.asarray(memory), jnp.asarray(mask))
    v = _variables(jm, *jargs, method=step)
    ctx_j, al_j = _apply(jm, v, *jargs, method=step)
    port = _port(tatt.BahdanauAttention(A, Q, D), v)
    with torch.inference_mode():
        mem_t = torch.from_numpy(memory)
        ctx_t, al_t, _ = port(torch.from_numpy(query), port.precompute_keys(mem_t), mem_t,
                              torch.from_numpy(mask))
    np.testing.assert_allclose(ctx_t.numpy(), np.asarray(ctx_j), atol=1e-5)
    np.testing.assert_allclose(al_t.numpy(), np.asarray(al_j), atol=1e-6)
    e = rs.randn(B, L).astype(np.float32)
    np.testing.assert_allclose(
        tatt.masked_softmax(torch.from_numpy(e), torch.from_numpy(mask)).numpy(),
        np.asarray(jatt.masked_softmax(jnp.asarray(e), jnp.asarray(mask))), atol=1e-7)


def _attention_steps(jm, port, query, memory, mask, n=3):
    """``n`` steps of a flax attention module and its port on the same
    queries, carrying each one's state → [(ctx, align)] pairs per step."""
    def steps(mod, qs, mem, m):
        keys = mod.precompute_keys(mem)
        state, out = mod.init_state(qs.shape[1], mem.shape[1]), []
        for q in qs:
            ctx, align, state = mod(q, keys, mem, m, state)
            out.append((ctx, align))
        return out, state.accumulated

    jargs = (jnp.asarray(query), jnp.asarray(memory), jnp.asarray(mask))
    v = _variables(jm, *jargs, method=steps)
    out_j, acc_j = _apply(jm, v, *jargs, method=steps)
    port = _port(port, v)
    with torch.inference_mode():
        mem_t, mask_t = torch.from_numpy(memory), torch.from_numpy(mask)
        keys, state, out_t = port.precompute_keys(mem_t), None, []
        for q in torch.from_numpy(query):
            ctx, align, state = port(q, keys, mem_t, mask_t, state)
            out_t.append((ctx, align))
    return out_j, acc_j, out_t, state.accumulated


@pytest.mark.parametrize("use_pallas", [False, True])
def test_location_attention_steps_match_flax(use_pallas):
    # three steps, so the location term sees a non-zero cumulative
    # alignment; the kernel path (interpret mode in JAX, the plain version
    # here) leaves out the score bias, which the softmax ignores.  f32:
    # 1e-5 (sum order), alignments 1e-6
    rs = np.random.RandomState(8)
    B, L, Q, D, A = 3, 11, 10, 14, 16
    query = rs.randn(3, B, Q).astype(np.float32)
    memory = rs.randn(B, L, D).astype(np.float32)
    mask = np.arange(L)[None, :] < np.array([11, 6, 1])[:, None]
    jm = jatt.LocationSensitiveAttention(A, location_filters=4, location_kernel=5,
                                         use_pallas=use_pallas)
    port = tatt.LocationSensitiveAttention(A, Q, D, filters=4, kernel=5,
                                           use_pallas=use_pallas)
    out_j, acc_j, out_t, acc_t = _attention_steps(jm, port, query, memory, mask)
    for (cj, aj), (ct, at) in zip(out_j, out_t):
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5)
        np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=1e-6)
    np.testing.assert_allclose(acc_t.numpy(), np.asarray(acc_j), atol=1e-5)
    assert port.b.item() != 0.0                   # the score bias was carried over


def test_conv_bank_use_pallas_matches_flax():
    # the kernel route's rounding (bias added to the f32 sums) against the
    # flax module's conv_bank_pallas in interpret mode; f32 -> 1e-5
    rs = np.random.RandomState(9)
    x = rs.randn(2, 13, 12).astype(np.float32)
    jm = jmod.ConvBank(5, 8, use_pallas=True)
    v = _variables(jm, x, train=False, seed=5)
    y_j = _apply(jm, v, x, train=False)
    y_t = _run(_port(tmod.ConvBank(12, 5, 8, use_pallas=True), v), torch.from_numpy(x))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)


def _generate_pair(overrides, max_iters, seed=0):
    jcfg = jconfig.get_config("tiny", overrides)
    jm = jcreate_model("tacotron", jcfg)
    st = jax.eval_shape(lambda r: create_train_state(jcfg, r, model=jm)[1],
                        jax.random.PRNGKey(seed))
    variables = _fill({"params": st.params, "batch_stats": st.batch_stats},
                      np.random.RandomState(seed))
    port = create_model("tacotron", tconfig.get_config("tiny", overrides))
    port = _port(port, variables)
    rs = np.random.RandomState(seed)
    inputs = rs.randint(2, 60, (3, 14))
    lengths = np.array([14, 9, 3])
    sids = np.array([0, 2, 1]) if "num_speakers" in overrides else None
    out_j = _apply(jm, variables, inputs, lengths,
                   None if sids is None else jnp.asarray(sids), max_iters=max_iters,
                   train=False, rngs={"dropout": jax.random.PRNGKey(1)},
                   method=jm.generate)
    with torch.inference_mode():
        out_t = port.generate(torch.from_numpy(inputs), torch.from_numpy(lengths),
                              None if sids is None else torch.from_numpy(sids),
                              max_iters=max_iters)
    return out_j, out_t


@pytest.mark.parametrize("overrides", [
    "model.prenet_dropout=0.0",
    "model.prenet_dropout=0.0,model.num_speakers=3",
])
def test_generate_matches_jax(overrides):
    out_j, out_t = _generate_pair(overrides, max_iters=16)
    for name, a, b in zip(("mel", "linear", "alignments"), out_j, out_t):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape), name
        np.testing.assert_allclose(b.numpy(), a, atol=1e-4, err_msg=name)


def test_dropout_stays_on_at_inference():
    cfg = tconfig.get_config("tiny")
    assert cfg.model.prenet_dropout > 0
    model = create_model("tacotron", cfg).reset_parameters(
        torch.Generator().manual_seed(0)).eval()
    inputs = torch.randint(2, 60, (2, 10), generator=torch.Generator().manual_seed(1))
    lengths = torch.tensor([10, 7])

    def mel(seed):
        with torch.inference_mode():
            return model.generate(inputs, lengths, max_iters=6,
                                  generator=torch.Generator().manual_seed(seed)).mel_outputs
    assert torch.equal(mel(3), mel(3))
    assert not torch.allclose(mel(3), mel(4))


def test_decoder_weights_cache_follows_parameters():
    cfg = tconfig.get_config("tiny", "model.prenet_dropout=0.0")
    a, b = (create_model("tacotron", cfg).reset_parameters(
        torch.Generator().manual_seed(s)).eval() for s in (0, 1))
    inputs = torch.randint(2, 60, (2, 10), generator=torch.Generator().manual_seed(2))
    lengths = torch.tensor([10, 7])
    gen = lambda m: m.generate(inputs, lengths, max_iters=6).mel_outputs
    with torch.inference_mode():
        first = a._fused_decoder_weights()
        assert a._fused_decoder_weights() is first            # built once
        mel_b = gen(b)
        assert not torch.allclose(gen(a), mel_b)
    a.load_state_dict(b.state_dict())                          # copies in place
    with torch.inference_mode():
        assert a._fused_decoder_weights() is not first
        assert torch.equal(gen(a), mel_b)
    with torch.no_grad():
        a.decoder_cell.frame_proj.bias.add_(1.0)
    with torch.inference_mode():
        assert torch.equal(a._fused_decoder_weights().bf, b.decoder_cell.frame_proj.bias + 1.0)
    a.float()                                                  # _apply drops the cache
    assert a._dec_weights_cache is None


@pytest.mark.parametrize("overrides", [
    # (a) Bahdanau with the kernels' rounding: JAX runs its per-step scan
    # with attention_step_pallas and conv_bank_pallas (tiny's depths are not
    # multiples of 128), the port its fused decode and conv-bank route
    "model.prenet_dropout=0.0,parallel.use_pallas=true",
    # (b) location-sensitive attention, plain module math and kernel route
    "model.prenet_dropout=0.0,model.attention_type=location",
    "model.prenet_dropout=0.0,model.attention_type=location,parallel.use_pallas=true",
    # (c) a three-layer prenet: the per-step decode where the fused loop
    # cannot run
    "model.prenet_dropout=0.0,model.prenet_depths=(64,48,32)",
])
def test_generate_per_step_and_kernel_routes_match_jax(overrides):
    # f32, six autoregressive steps: sum-order differences carried -> 1e-4
    out_j, out_t = _generate_pair(overrides, max_iters=6)
    for name, a, b in zip(("mel", "linear", "alignments"), out_j, out_t):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape), name
        np.testing.assert_allclose(b.numpy(), a, atol=1e-4, err_msg=name)


def test_per_step_decode_equals_fused_decode():
    # dropout on: both branches draw the same prenet masks from the same
    # generator; f32, the fused plain version splits the concatenated
    # products at the concat boundaries (sum order) -> 1e-5
    cfg = tconfig.get_config("tiny", "model.num_speakers=3")
    per_step = tconfig.get_config("tiny", "model.num_speakers=3,"
                                  "parallel.use_pallas_decode=false")
    a = create_model("tacotron", cfg).reset_parameters(torch.Generator().manual_seed(0))
    b = create_model("tacotron", per_step)
    b.load_state_dict(a.state_dict())
    inputs = torch.randint(2, 60, (2, 12), generator=torch.Generator().manual_seed(1))
    lengths, sids = torch.tensor([12, 8]), torch.tensor([2, 0])
    with torch.inference_mode():
        outs = [m.eval().generate(inputs, lengths, sids, max_iters=6,
                                  generator=torch.Generator().manual_seed(3))
                for m in (a, b)]
    for name, x, y in zip(("mel", "linear", "alignments"), *outs):
        torch.testing.assert_close(y, x, atol=1e-5, rtol=0, msg=name)


def test_location_attention_training_path_raises():
    # the teacher-forced location path trains with the plain attention step;
    # under parallel.use_pallas it raises when a gradient is asked, as
    # jax.grad through the JAX attention-step kernel does (no VJP)
    inputs, lengths = torch.randint(2, 60, (2, 7)), torch.tensor([7, 4])
    for ov, raises in (("", False), (",parallel.use_pallas=true", True)):
        cfg = tconfig.get_config("tiny", "model.attention_type=location" + ov)
        model = create_model("tacotron", cfg).reset_parameters(torch.Generator().manual_seed(0))
        mel = torch.rand(2, 10, cfg.audio.num_mels)
        if raises:
            with pytest.raises(RuntimeError, match="no backward"):
                model(inputs, lengths, mel)
            with torch.no_grad():
                model(inputs, lengths, mel)
        else:
            out = model(inputs, lengths, mel)
            out.mel_outputs.sum().backward()
            assert out.alignments.shape == (2, 2, 7)


def test_use_pallas_conv_bank_refuses_training():
    cfg = tconfig.get_config("tiny", "parallel.use_pallas=true")
    model = create_model("tacotron", cfg).reset_parameters(torch.Generator().manual_seed(0))
    inputs, lengths = torch.randint(2, 60, (2, 7)), torch.tensor([7, 4])
    with pytest.raises(RuntimeError, match="inference-only"):
        model.train()(inputs, lengths, torch.rand(2, 10, cfg.audio.num_mels))
