"""The port's training slice against the JAX package, on the CPU.

BatchNorm in training mode, the loss, the learning-rate schedule, the
optimizer, the teacher-forced model (outputs, running statistics,
gradients) and two whole train steps, each on the same numpy inputs and
weights on both sides, in float32.  The model-level cases run the ``tiny``
preset with three speakers (every speaker-injection point) and prenet
dropout off (the two frameworks draw different bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the JAX package's models need flax: where it is not installed this module
# skips, and `pytest -m gpu tests/test_torch_*.py` still collects the gpu tests
pytest.importorskip("flax")

import flax.linen as fnn  # noqa: E402
import optax  # noqa: E402

from tacotron_multispeaker_tpu import config as jconfig  # noqa: E402
from tacotron_multispeaker_tpu import training as jtraining  # noqa: E402
from tacotron_multispeaker_tpu.models import create_model as jcreate_model  # noqa: E402
from tacotron_multispeaker_tpu.models import losses as jlosses  # noqa: E402
from tacotron_multispeaker_torch import config as tconfig  # noqa: E402
from tacotron_multispeaker_torch import convert, training  # noqa: E402
from tacotron_multispeaker_torch.models import create_model, losses  # noqa: E402
from tacotron_multispeaker_torch.models import helpers  # noqa: E402
from tacotron_multispeaker_torch.models import modules as tmod  # noqa: E402
from test_torch_gpu import train_batch  # noqa: E402
from test_torch_model import _fill  # noqa: E402

OVERRIDES = "model.num_speakers=3,model.prenet_dropout=0.0,model.compute_dtype=float32"


def _close(a, b, tol, what="", floor=1e-6):
    """max |a - b| <= tol · max(|b|, floor)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = float(np.abs(a - b).max()) / max(float(np.abs(b).max()), floor)
    assert err <= tol, (what, err)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _compare_trees(ours, theirs, tol, what, floor=1e-6):
    a, b = dict(_leaves(ours)), dict(_leaves(theirs))
    assert sorted(a) == sorted(b), what
    for path in b:
        _close(a[path], b[path], tol, f"{what} {'/'.join(path)}", floor)


def test_batchnorm_train_mode_matches_flax_mutable_batch_stats():
    # batch statistics over every axis but the last (zeroed pad frames
    # included), biased var, running update 0.99·old + 0.01·batch; f32
    # reductions in another order -> 1e-6 relative; the eval path after the
    # update uses the new running statistics on both sides
    rs = np.random.RandomState(0)
    x = (rs.randn(3, 7, 5) * 2 + 1).astype(np.float32)
    x[1, 4:] = 0.0
    jm = fnn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3)
    v = {"params": {"scale": rs.uniform(0.5, 1.5, 5).astype(np.float32),
                    "bias": rs.randn(5).astype(np.float32)},
         "batch_stats": {"mean": rs.randn(5).astype(np.float32),
                         "var": rs.uniform(0.5, 2, 5).astype(np.float32)}}
    y_j, upd = jm.apply(v, x, mutable=["batch_stats"])
    bn = tmod.BatchNorm(5)
    with torch.no_grad():
        for name in ("scale", "bias"):
            getattr(bn, name).copy_(torch.from_numpy(v["params"][name]))
        for name in ("mean", "var"):
            getattr(bn, name).copy_(torch.from_numpy(v["batch_stats"][name]))
    y_t = bn.train()(torch.from_numpy(x))
    _close(y_t.detach().numpy(), y_j, 1e-6, "y")
    for name in ("mean", "var"):
        _close(getattr(bn, name).numpy(), upd["batch_stats"][name], 1e-6, name)
    jm_eval = fnn.BatchNorm(use_running_average=True, epsilon=1e-3)
    y2_j = jm_eval.apply({"params": v["params"], "batch_stats": upd["batch_stats"]}, x)
    with torch.no_grad():
        _close(bn.eval()(torch.from_numpy(x)).numpy(), y2_j, 1e-6, "eval")


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_tacotron_loss_matches_jax(fused, masked):
    # same f32 sums in another order -> 1e-6 relative
    rs = np.random.RandomState(1)
    B, T, M, F = 3, 10, 8, 33
    arrays = [rs.rand(B, T, M), rs.rand(B, T, F), rs.rand(B, T, M), rs.rand(B, T, F)]
    arrays = [a.astype(np.float32) for a in arrays]
    lengths = np.array([10, 4, 7]) if masked else None
    kw = dict(num_freq=F, sample_rate=16000, prioritize_hz=3000.0, fused_linear=fused)
    j = jlosses.tacotron_loss(*map(jnp.asarray, arrays),
                              None if lengths is None else jnp.asarray(lengths), **kw)
    t = losses.tacotron_loss(*map(torch.from_numpy, arrays),
                             None if lengths is None else torch.from_numpy(lengths), **kw)
    assert losses.priority_bins(F, 16000) == jlosses.priority_bins(F, 16000) == 12
    for k in ("mel_loss", "linear_loss", "loss"):
        _close(t[k].item(), float(j[k]), 1e-6, k)


def test_loss_axis_name_waits_for_the_parallel_slice():
    z = torch.zeros(1, 5, 4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        losses.tacotron_loss(z, z, z, z, None, num_freq=4, sample_rate=16000,
                             axis_name="data")


@pytest.mark.parametrize("decay", [True, False])
def test_learning_rate_schedule_matches_jax(decay):
    # the JAX schedule runs in f32, the port's in Python floats -> 1e-6
    cfg = f"train.decay_learning_rate={str(decay).lower()},train.warmup_steps=10"
    j = jtraining.learning_rate_schedule(jconfig.get_config("tiny", cfg))
    t = training.learning_rate_schedule(tconfig.get_config("tiny", cfg))
    for step in (0, 1, 5, 9, 10, 11, 50, 4000):
        _close(t(step), float(j(jnp.asarray(step))), 1e-6, f"step {step}")


def test_optimizer_matches_optax_chain():
    # three updates, the first two with a global norm above the clip (1.0),
    # the third below it; Adam's moments and bias corrections in f32 on both
    # sides, written in other orders -> parameters 1e-6 relative
    cfg_s = "train.warmup_steps=5"
    jcfg, tcfg = jconfig.get_config("tiny", cfg_s), tconfig.get_config("tiny", cfg_s)
    rs = np.random.RandomState(2)
    params = {"a": rs.randn(4, 3).astype(np.float32), "b": rs.randn(5).astype(np.float32)}
    grads = [{k: (rs.randn(*v.shape) * s).astype(np.float32) for k, v in params.items()}
             for s in (3.0, 1.0, 0.01)]
    tx = jtraining.make_optimizer(jcfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = training.make_optimizer(tcfg, tp.values())
    for n, g in enumerate(grads):
        upd, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        norm = opt.step(n)
        _close(norm.item(), float(optax.global_norm(g)), 1e-6, f"norm {n}")
        for k in params:
            _close(tp[k].detach().numpy(), jp[k], 1e-6, f"{k} after update {n}")


def test_teacher_inputs_match_jax():
    from tacotron_multispeaker_tpu.models import helpers as jhelpers
    mel = np.random.RandomState(3).randn(2, 15, 4).astype(np.float32)
    np.testing.assert_array_equal(helpers.teacher_inputs(torch.from_numpy(mel), 5).numpy(),
                                  np.asarray(jhelpers.teacher_inputs(jnp.asarray(mel), 5)))
    with pytest.raises(ValueError, match="multiple"):
        helpers.teacher_inputs(torch.from_numpy(mel[:, :14]), 5)


def test_unported_training_options_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        training.create_train_state(tconfig.get_config("tiny", "train.adam_mu_dtype=bfloat16"),
                                    device="cpu")
    cfg = tconfig.get_config("tiny", "train.targets_from_wav=true")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        training.make_train_step(cfg, create_model("tacotron", cfg))


# --------------------------------------------------------------------------
# model level: tiny, three speakers, dropout off, f32
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """(JAX config, JAX model, numpy variables, port config, batch), the
    variables filled with numpy (non-trivial BatchNorm statistics)."""
    jcfg = jconfig.get_config("tiny", OVERRIDES)
    jm = jcreate_model("tacotron", jcfg)
    st = jax.eval_shape(lambda r: jtraining.create_train_state(jcfg, r, model=jm)[1],
                        jax.random.PRNGKey(0))
    variables = _fill({"params": st.params, "batch_stats": st.batch_stats},
                      np.random.RandomState(4))
    tcfg = tconfig.get_config("tiny", OVERRIDES)
    batch = train_batch(np.random.RandomState(5), tcfg, B=3, L=11, T=20)
    return jcfg, jm, variables, tcfg, batch


def _port_model(tcfg, variables):
    model = create_model("tacotron", tcfg)
    model.load_state_dict(convert.flax_to_state_dict(variables, model), strict=True)
    return model.train()


def test_forward_and_gradients_match_jax(pair):
    # outputs: the port's fused teacher scan against flax's cell scan (same
    # math split at other concat boundaries, f32) -> 1e-5 relative; running
    # statistics after the pass 1e-5; every gradient leaf against
    # jax.grad(_make_loss_fn) -> 1e-4 of its peak (reverse-mode sums through
    # two recurrences and the BatchNorms in other orders), or of 1e-3 of the
    # largest gradient for leaves that are zero in exact arithmetic (a conv
    # bias right before a training-mode BatchNorm: both sides hold 1e-9 noise)
    jcfg, jm, variables, tcfg, batch = pair
    inputs, in_len, mel, lin, tg_len, spk = batch
    loss_fn = jtraining._make_loss_fn(jcfg, jm)
    (loss_j, (losses_j, bs_j)), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"], jax.random.PRNGKey(0),
        *map(jnp.asarray, batch))
    out_j, _ = jax.jit(lambda v, *a: jm.apply(
        v, *a, train=True, rngs={"dropout": jax.random.PRNGKey(0)},
        mutable=["batch_stats"]))(variables, inputs, in_len, mel, spk)

    model = _port_model(tcfg, variables)
    t = [torch.from_numpy(a) for a in batch]
    out_t = model(t[0], t[1], t[2], t[5])
    for name, a, b in zip(("mel", "linear", "alignments"), out_t, out_j):
        _close(a.detach().numpy(), b, 1e-5, name)
    loss_t = losses.tacotron_loss(out_t.mel_outputs, out_t.linear_outputs, t[2], t[3], t[4],
                                  num_freq=tcfg.audio.num_freq,
                                  sample_rate=tcfg.audio.sample_rate,
                                  fused_linear=tcfg.train.fused_linear_loss)
    _close(loss_t["loss"].item(), float(loss_j), 1e-5, "loss")
    stats = convert.state_dict_to_flax(model.state_dict(), model)["batch_stats"]
    _compare_trees(stats, bs_j, 1e-5, "batch_stats")
    loss_t["loss"].backward()
    peak = max(float(np.abs(g).max()) for _, g in _leaves(grads_j))
    _compare_trees(convert.grads_to_flax(model), grads_j, 1e-4, "grad", floor=1e-3 * peak)


def test_two_train_steps_match_make_train_step(pair):
    # the whole step twice from the same weights and batch: loss and grad
    # norm 1e-5 relative; parameters after each Adam update and running
    # statistics 1e-5 of each leaf's peak (the first update moves every
    # weight by about lr = 2e-5, sign(g) for all but near-zero gradients)
    jcfg, jm, variables, tcfg, batch = pair
    tx = jtraining.make_optimizer(jcfg)
    jstate = jtraining.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]),
        rng=jax.random.PRNGKey(0))
    jstep = jax.jit(jtraining.make_train_step(jcfg, jm, tx))

    model = _port_model(tcfg, variables)
    state = training.TrainState(step=0, model=model,
                                optimizer=training.make_optimizer(tcfg, model.parameters()),
                                seed=0)
    tstep = training.make_train_step(tcfg, model)
    t = [torch.from_numpy(a) for a in batch]
    for n in range(2):
        jstate, mj = jstep(jstate, *map(jnp.asarray, batch))
        state, mt = tstep(state, *t)
        for k in ("loss", "mel_loss", "linear_loss", "grad_norm", "lr"):
            _close(float(mt[k]), float(mj[k]), 1e-5, f"step {n} {k}")
        flax_now = convert.state_dict_to_flax(model.state_dict(), model)
        _compare_trees(flax_now["params"], jstate.params, 1e-5, f"step {n} params")
        _compare_trees(flax_now["batch_stats"], jstate.batch_stats, 1e-5, f"step {n} stats")
    assert state.step == int(jstate.step) == 2


def test_generate_keeps_running_statistics_in_training_mode(pair):
    # generate() is inference: its BatchNorms read the running statistics
    # (and leave them alone) whether the model is in training mode or not
    _, _, variables, tcfg, batch = pair
    model = _port_model(tcfg, variables)
    t = [torch.from_numpy(a) for a in batch]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        a = model.train().generate(t[0], t[1], t[5], max_iters=3)
        b = model.eval().generate(t[0], t[1], t[5], max_iters=3)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    assert model.train().training
