"""Weight bridge: flax {"params", "batch_stats"} <-> the PyTorch port's
state_dict (tacotron_multispeaker_torch/convert.py).

The big presets are shaped with ``jax.eval_shape`` (nothing is traced
numerically) and filled with numpy, so the round trip is checked on every
leaf of the real trees.  Tolerance: none — the bridge only transposes and
reshapes, so every leaf must come back bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

# the JAX package's models need flax: where it is not installed this module
# skips, and `pytest -m gpu tests/test_torch_*.py` still collects the gpu tests
pytest.importorskip("flax")

from tacotron_multispeaker_tpu import config as jconfig
from tacotron_multispeaker_tpu.training import create_train_state
from tacotron_multispeaker_torch import config as tconfig
from tacotron_multispeaker_torch import convert
from tacotron_multispeaker_torch.models import create_model


def _numpy_variables(preset: str, overrides: str, seed: int = 0):
    cfg = jconfig.get_config(preset, overrides)
    abstract = jax.eval_shape(lambda r: create_train_state(cfg, r)[1],
                              jax.random.PRNGKey(0))
    rs = np.random.RandomState(seed)
    fill = lambda s: rs.standard_normal(s.shape).astype(s.dtype)
    return {"params": jax.tree.map(fill, abstract.params),
            "batch_stats": jax.tree.map(fill, abstract.batch_stats)}


@pytest.mark.parametrize("preset,overrides", [
    ("tiny", ""),
    ("tiny", "model.num_speakers=3"),
    ("single_speaker", ""),
    ("multispeaker_vctk", ""),
    ("tiny", "model.attention_type=location"),
    ("multispeaker_vctk", "model.attention_type=location"),
])
def test_flax_tree_round_trips_bit_exactly(preset, overrides):
    variables = _numpy_variables(preset, overrides)
    model = create_model("tacotron", tconfig.get_config(preset, overrides))
    state = convert.flax_to_state_dict(variables, model)
    # no port tensor is left unset, and none is invented
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state, strict=True)
    back = convert.state_dict_to_flax(model.state_dict(), model)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(variables))
    for a, b in zip(jax.tree.leaves(variables), jax.tree.leaves(back)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.array_equal(a, b)


def test_layouts_follow_the_flax_conventions():
    """Spot-check each layout rule on the tiny multispeaker tree."""
    variables = _numpy_variables("tiny", "model.num_speakers=3", seed=1)
    model = create_model("tacotron", tconfig.get_config("tiny", "model.num_speakers=3"))
    state = convert.flax_to_state_dict(variables, model)
    p, bs = variables["params"], variables["batch_stats"]
    xg = p["decoder_cell"]["attn_rnn"]["xg"]["kernel"]              # [in, out]
    assert np.array_equal(state["decoder_cell.attn_rnn.xg.weight"].numpy(), xg.T)
    conv = p["encoder"]["cbhg"]["proj_0"]["conv"]["kernel"]         # [K, in, out]
    assert np.array_equal(state["encoder.cbhg.proj_0.conv.weight"].numpy(),
                          conv.transpose(2, 1, 0))
    bank = p["encoder"]["cbhg"]["bank"]["kernel"]                   # unmasked
    assert np.array_equal(state["encoder.cbhg.bank.weight"].numpy(),
                          bank.transpose(2, 1, 0))
    assert np.array_equal(state["attention.v"].numpy(), p["attention"]["v"][:, 0])
    assert np.array_equal(state["speaker_table.weight"].numpy(),
                          p["speaker_table"]["embedding"])
    assert np.array_equal(state["post_cbhg.bank.bn.var"].numpy(),
                          bs["post_cbhg"]["bank"]["bn"]["var"])
    assert np.array_equal(state["post_cbhg.bank.bn.scale"].numpy(),
                          p["post_cbhg"]["bank"]["bn"]["scale"])


def test_location_attention_leaves():
    """loc_conv WIO [W, 1, filters] <-> [filters, 1, W], loc_proj as a
    Dense, the score bias ``b`` as a 0-d tensor, in all three directions."""
    ov = "model.attention_type=location,model.num_speakers=3"
    variables = _numpy_variables("tiny", ov, seed=2)
    model = create_model("tacotron", tconfig.get_config("tiny", ov))
    state = convert.flax_to_state_dict(variables, model)
    att = variables["params"]["attention"]
    assert att["loc_conv"]["kernel"].shape == (31, 1, 32)
    assert np.array_equal(state["attention.loc_conv.weight"].numpy(),
                          att["loc_conv"]["kernel"].transpose(2, 1, 0))
    assert np.array_equal(state["attention.loc_proj.weight"].numpy(),
                          att["loc_proj"]["kernel"].T)
    assert state["attention.b"].shape == () and state["attention.b"].item() == att["b"]
    model.load_state_dict(state, strict=True)
    for p in model.parameters():
        p.grad = torch.full_like(p, 0.5)
    grads = convert.grads_to_flax(model)
    assert grads["attention"]["b"].shape == ()
    assert grads["attention"]["loc_conv"]["kernel"].shape == (31, 1, 32)
    assert (jax.tree_util.tree_structure(grads)
            == jax.tree_util.tree_structure(variables["params"]))


def test_missing_or_extra_leaves_raise():
    variables = _numpy_variables("tiny", "")
    model = create_model("tacotron", tconfig.get_config("tiny"))
    extra = jax.tree.map(lambda a: a, variables)
    extra["params"]["stray"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="stray"):
        convert.flax_to_state_dict(extra, model)
    missing = jax.tree.map(lambda a: a, variables)
    del missing["params"]["linear_proj"]["bias"]
    with pytest.raises(KeyError):
        convert.flax_to_state_dict(missing, model)
    wrong = jax.tree.map(lambda a: a, variables)
    wrong["params"]["linear_proj"]["kernel"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="linear_proj"):
        convert.flax_to_state_dict(wrong, model)


def test_random_init_follows_flax_initialisers():
    """reset_parameters: GRU gate biases 1, highway T biases -1, BatchNorm
    identity, truncated-normal kernels within 2 std."""
    model = create_model("tacotron", tconfig.get_config("tiny"))
    model.reset_parameters(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert torch.all(sd["decoder_cell.attn_rnn.xg.bias"] == 1.0)
    assert torch.all(sd["encoder.cbhg.highway_0.T.bias"] == -1.0)
    assert torch.all(sd["encoder.cbhg.highway_0.H.bias"] == 0.0)
    assert torch.all(sd["post_cbhg.bank.bn.var"] == 1.0)
    w = sd["linear_proj.weight"]
    std = (1.0 / w.shape[1]) ** 0.5 / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std + 1e-6
    again = create_model("tacotron", tconfig.get_config("tiny"))
    again.reset_parameters(torch.Generator().manual_seed(0))
    assert all(torch.equal(sd[k], v) for k, v in again.state_dict().items())
