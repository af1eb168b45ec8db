"""Location-attention training: the port's teacher-forced per-step loop
against the JAX package's XLA scan, on the CPU, in float32.

The ``tiny`` preset with ``model.attention_type=location`` and three
speakers (every speaker-injection point), prenet dropout off: the forward,
the running statistics, every gradient leaf against ``jax.grad`` and one
whole train step against ``make_train_step``; the inference forward under
``parallel.use_pallas`` (the JAX attention-step kernel in interpret mode,
the port's plain version of kernel 9) and, as in JAX, no gradient there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax")

from tacotron_multispeaker_tpu import config as jconfig  # noqa: E402
from tacotron_multispeaker_tpu import training as jtraining  # noqa: E402
from tacotron_multispeaker_tpu.models import create_model as jcreate_model  # noqa: E402
from tacotron_multispeaker_torch import config as tconfig  # noqa: E402
from tacotron_multispeaker_torch import convert, training  # noqa: E402
from tacotron_multispeaker_torch.models import create_model, losses  # noqa: E402
from test_torch_gpu import train_batch  # noqa: E402
from test_torch_model import _fill  # noqa: E402
from test_torch_train import _close, _compare_trees, _leaves  # noqa: E402

OVERRIDES = ("model.num_speakers=3,model.prenet_dropout=0.0,model.compute_dtype=float32,"
             "model.attention_type=location")


@pytest.fixture(scope="module")
def pair():
    """(JAX config, JAX model, numpy variables, port config, batch)."""
    jcfg = jconfig.get_config("tiny", OVERRIDES)
    jm = jcreate_model("tacotron", jcfg)
    st = jax.eval_shape(lambda r: jtraining.create_train_state(jcfg, r, model=jm)[1],
                        jax.random.PRNGKey(0))
    variables = _fill({"params": st.params, "batch_stats": st.batch_stats},
                      np.random.RandomState(6))
    tcfg = tconfig.get_config("tiny", OVERRIDES)
    batch = train_batch(np.random.RandomState(7), tcfg, B=3, L=11, T=20)
    return jcfg, jm, variables, tcfg, batch


def _port_model(tcfg, variables):
    model = create_model("tacotron", tcfg)
    model.load_state_dict(convert.flax_to_state_dict(variables, model), strict=True)
    return model.train()


def test_location_forward_and_gradients_match_jax(pair):
    # outputs: the port's per-step loop against flax's scan over the same
    # merged projections, f32 -> 1e-5 relative; running statistics 1e-5;
    # every gradient leaf against jax.grad of the loss -> 1e-4 of its peak
    # (reverse-mode sums through the recurrences, the location conv and the
    # BatchNorms in other orders), or of 1e-3 of the largest gradient for
    # leaves that are zero in exact arithmetic (a conv bias before a
    # training-mode BatchNorm)
    jcfg, jm, variables, tcfg, batch = pair
    inputs, in_len, mel, lin, tg_len, spk = batch
    loss_fn = jtraining._make_loss_fn(jcfg, jm)
    (loss_j, (_, bs_j)), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
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
    grads_t = convert.grads_to_flax(model)
    # the location conv and projection are on the gradient's path
    att = grads_t["attention"]
    assert all(np.abs(att[name]["kernel"]).max() > 0 for name in ("loc_conv", "loc_proj"))
    peak = max(float(np.abs(g).max()) for _, g in _leaves(grads_j))
    _compare_trees(grads_t, grads_j, 1e-4, "grad", floor=1e-3 * peak)


def test_location_train_step_matches_make_train_step(pair):
    # one whole step from the same weights and batch: loss and grad norm
    # 1e-5 relative; parameters after the Adam update and running statistics
    # 1e-5 of each leaf's peak
    jcfg, jm, variables, tcfg, batch = pair
    tx = jtraining.make_optimizer(jcfg)
    jstate = jtraining.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]),
        rng=jax.random.PRNGKey(0))
    jstate, mj = jax.jit(jtraining.make_train_step(jcfg, jm, tx))(jstate,
                                                                 *map(jnp.asarray, batch))
    model = _port_model(tcfg, variables)
    state = training.TrainState(step=0, model=model,
                                optimizer=training.make_optimizer(tcfg, model.parameters()),
                                seed=0)
    state, mt = training.make_train_step(tcfg, model)(state, *map(torch.from_numpy, batch))
    for k in ("loss", "mel_loss", "linear_loss", "grad_norm", "lr"):
        _close(float(mt[k]), float(mj[k]), 1e-5, k)
    flax_now = convert.state_dict_to_flax(model.state_dict(), model)
    _compare_trees(flax_now["params"], jstate.params, 1e-5, "params")
    _compare_trees(flax_now["batch_stats"], jstate.batch_stats, 1e-5, "stats")


def test_location_inference_forward_under_use_pallas_matches_jax(pair):
    # parallel.use_pallas, train=False (the validate forward): JAX runs the
    # attention-step and conv-bank kernels in interpret mode, the port their
    # plain versions on the CPU -> 1e-5 relative
    _, _, variables, _, batch = pair
    ov = OVERRIDES + ",parallel.use_pallas=true"
    jcfg, tcfg = jconfig.get_config("tiny", ov), tconfig.get_config("tiny", ov)
    jm = jcreate_model("tacotron", jcfg)
    inputs, in_len, mel, _, _, spk = batch
    out_j, _ = jax.jit(lambda v, *a: jm.apply(
        v, *a, train=False, rngs={"dropout": jax.random.PRNGKey(0)},
        mutable=["batch_stats"]))(variables, inputs, in_len, mel, spk)
    model = _port_model(tcfg, variables).eval()
    t = [torch.from_numpy(a) for a in batch]
    with torch.no_grad():
        out_t = model(t[0], t[1], t[2], t[5])
    for name, a, b in zip(("mel", "linear", "alignments"), out_t, out_j):
        _close(a.numpy(), b, 1e-5, name)


def test_location_training_under_use_pallas_raises_as_jax_does(pair):
    # jax.grad through attention_step_pallas (no VJP) raises; so does the
    # port, before any work, with the reason
    _, _, variables, _, batch = pair
    tcfg = tconfig.get_config("tiny", OVERRIDES + ",parallel.use_pallas=true")
    model = _port_model(tcfg, variables)
    t = [torch.from_numpy(a) for a in batch]
    with pytest.raises(RuntimeError, match="no backward"):
        model(t[0], t[1], t[2], t[5])
