"""The port's sharded synthesis (``Synthesizer.make_sharded_synth``) and its
distributed-softmax attention step against the JAX package's, on the CPU.

The port runs one process per mesh position: each test spawns four gloo
ranks (``parallel.run_ranks``, a ``file://`` store in a temporary
directory), and every rank returns what it computed.  The JAX side runs in
this process on four of the eight virtual CPU devices (conftest.py).  The
rank functions sit at the top of this module, which imports JAX only inside
the tests, so that a spawned rank imports nothing but PyTorch and the port.
"""

import math

import numpy as np
import pytest
import torch

from tacotron_multispeaker_torch import config as tconfig
from tacotron_multispeaker_torch.device import warm_cpu_math
from tacotron_multispeaker_torch.models.attention import make_attention
from tacotron_multispeaker_torch.ops import attention_step as tas
from tacotron_multispeaker_torch.ops.sharded_attention import make_sharded_attention_step
from tacotron_multispeaker_torch.parallel import (Mesh, initialize_distributed, make_mesh,
                                                  run_ranks)
from tacotron_multispeaker_torch.synthesizer import Synthesizer
from tacotron_multispeaker_torch.training import sharded_speaker_embed

# tiny, f32, 16 speakers whose table shards over a model axis of 2 or 4,
# dropout off, exact Griffin-Lim (so the waveforms compare elementwise)
OVERRIDES = ("model.compute_dtype=float32,model.prenet_dropout=0.0,model.num_speakers=16,"
             "model.speaker_embed_depth=8,parallel.model_parallel_size=4,"
             "parallel.shard_speaker_table_min=8,audio.gl_method=dft_f32")


@pytest.fixture(scope="module", autouse=True)
def _cpu_math_ready():
    # the tests call the port's ops on CPU tensors directly, not through an
    # entry point, so they make PyTorch's float32 math ready as the entry
    # points do (device.warm_cpu_math: a thread's first tanh of a process can
    # err by ~1e-4)
    warm_cpu_math()


def _jax():
    """The JAX side (imported here, not at the top: see the module doc)."""
    pytest.importorskip("flax")
    import jax
    import jax.numpy as jnp
    from tacotron_multispeaker_tpu import config as jconfig
    from tacotron_multispeaker_tpu.parallel import make_mesh as jmake_mesh
    return jax, jnp, jconfig, jmake_mesh


def _mesh_jax(data, model):
    jax, _, _, jmake_mesh = _jax()
    return jmake_mesh(devices=jax.devices()[: data * model], data=data, model=model)


# -- kernel 10's plain version against attention_step_partial ------------------

def _partial_case(rs, B=4, L=256, A=32, D=48):
    """The shapes of test_parallel.py's sharded-attention test (v at the
    model's lecun scale); rows 1 and 3 end early (40 and 0 positions), so a
    slice of L past them is a fully masked shard."""
    f = lambda *s, sc=1.0: (rs.randn(*s) * sc).astype(np.float32)
    lengths = np.array([L, 40, rs.randint(100, L), 0])
    return (f(B, L, A), f(B, A), f(A, sc=A ** -0.5), f(B, L, D),
            np.arange(L)[None, :] < lengths[:, None], lengths)


def _partial_f64(keys, q, v, mem, mask):
    """attention_step_partial's function in float64 numpy."""
    f = lambda a: np.asarray(a, np.float64)
    e = (np.tanh(f(keys) + f(q)[:, None, :]) * f(v)).sum(-1)
    e = np.where(mask, e, -1e9)
    m = e.max(-1, keepdims=True)
    p = np.exp(e - m) * mask
    return np.einsum("bl,bld->bd", p, f(mem)), p, m, p.sum(-1, keepdims=True)


def _partial_diagnosis(inputs, sides, jax):
    """What a failure of the parity test below reports: each side's largest
    distance from the float64 function per output, and the process's
    numeric state."""
    import os
    exact = _partial_f64(*inputs)
    dist = {k: {n: float(np.abs(np.asarray(a, np.float64) - b).max())
                for n, a, b in zip(("ctx", "p", "m", "s"), out, exact)}
            for k, out in sides.items()}
    tiny = np.array([1e-40], np.float32)
    one, ulp = np.float32(1.0), np.float32(2.0 ** -23)
    # round to nearest takes 1 + ulp/4 to 1 and 1 + 3 ulp/4 to 1 + ulp
    nearest = (one + ulp / 4 == one) and (one + 3 * ulp / 4 > one)
    return {"distance from float64": dist,
            "rounds to nearest (numpy, this thread)": bool(nearest),
            "torch threads": torch.get_num_threads(),
            "torch interop threads": torch.get_num_interop_threads(),
            "torch float32 matmul precision": torch.get_float32_matmul_precision(),
            "XLA_FLAGS": os.environ.get("XLA_FLAGS"),
            "jax matmul precision": jax.config.jax_default_matmul_precision,
            "denormals flushed (numpy)": bool((tiny * np.float32(1.0))[0] == 0.0),
            "denormals flushed (torch)": bool((torch.from_numpy(tiny) * 1.0)[0] == 0.0)}


@pytest.mark.parametrize("shard", [slice(0, 256), slice(64, 128), slice(192, 256)])
def test_attention_step_partial_plain_matches_jax(shard):
    # f32, the dtype of the sequence-sharded path (the model casts to it);
    # bf16 is held against the kernel on the card (test_torch_gpu.py)
    jax, jnp, _, _ = _jax()
    from tacotron_multispeaker_tpu.ops.attention_step import (
        attention_step_partial, attention_step_partial_reference)
    keys, q, v, mem, mask, _ = _partial_case(np.random.RandomState(0))
    keys, mem, mask = keys[:, shard], mem[:, shard], mask[:, shard]
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (keys, q, v, mem, mask)]
    j = [jnp.asarray(a) for a in (keys, q, v, mem, mask)]
    dead = ~mask.any(axis=1)                     # fully masked rows of this shard
    assert dead[3] and dead[1] == (shard.start > 0)
    sides = {"torch wrapper": tas.attention_step_partial(*t),
             "torch plain": tas.attention_step_partial_reference(*t)}
    refs = {"jax pallas interpret": attention_step_partial(*j, interpret=True),
            "jax reference": attention_step_partial_reference(*j)}
    # the CPU wrapper and the plain version, each against both JAX functions
    for got in sides.values():
        for ref in refs.values():
            # the same f32 arithmetic in another sum order
            for name, a, b, tol in zip(("ctx", "p", "m", "s"), got, ref,
                                       (1e-4, 1e-5, 1e-5, 1e-5)):
                assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, name
                try:
                    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol,
                                               err_msg=name)
                except AssertionError as e:
                    diagnosis = _partial_diagnosis((keys, q, v, mem, mask),
                                                   {**sides, **refs}, jax)
                    raise AssertionError(f"{e}\n{diagnosis}") from None
        ctx, p, m, s = (a.numpy() for a in got)
        assert (m[dead] == -1e9).all() and (s[dead] == 0).all()
        assert (p[dead] == 0).all() and (ctx[dead] == 0).all()


def test_attention_step_partial_checks_its_inputs():
    keys, q, v, mem, mask, _ = (torch.from_numpy(np.ascontiguousarray(a[:, :8]))
                                if a.ndim > 1 and a.shape[1] == 256 else torch.from_numpy(a)
                                for a in _partial_case(np.random.RandomState(1)))
    with pytest.raises(ValueError, match="memory"):
        tas.attention_step_partial(keys, q, v, mem[:, :4], mask)
    with pytest.raises(ValueError, match="q must be"):
        tas.attention_step_partial(keys, q[:, :3], v, mem, mask)
    with pytest.raises(TypeError, match="mask"):
        tas.attention_step_partial(keys, q, v, mem, mask.float())
    with pytest.raises(TypeError, match="memory"):
        tas.attention_step_partial(keys, q, v, mem.double(), mask)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tas.attention_step_partial(keys.half(), q.half(), v.half(), mem.half(), mask)
    meta = [t.to("meta") for t in (keys, q, v, mem, mask)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        tas.attention_step_partial(*meta)
    # an empty shard is a fully masked one
    ctx, p, m, s = tas.attention_step_partial(keys[:, :0], q, v, mem[:, :0], mask[:, :0])
    assert p.shape == (4, 0) and (ctx == 0).all() and (m == -1e9).all() and (s == 0).all()
    assert tas.partial_launches == 0


# -- the rank side: one spawn of four gloo ranks for the whole module ---------

def _attention_rank(rank, use_kernel, keys, q, v, mem, mask):
    mesh = make_mesh(data=1, model=4)
    step = make_sharded_attention_step(mesh, use_kernel=use_kernel)
    sl = slice(rank * keys.shape[1] // 4, (rank + 1) * keys.shape[1] // 4)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a[:, sl]))
    ctx, p = step(t(keys), torch.from_numpy(q), torch.from_numpy(v), t(mem), t(mask))
    return ctx.numpy(), p.numpy()


def _synth_rank(rank, mesh_shape, overrides, variables, B, L, iters, inputs, lengths, sids,
                angles):
    cfg = tconfig.get_config("tiny", overrides)
    mesh = make_mesh(cfg.parallel, data=mesh_shape[0], model=mesh_shape[1])
    syn = Synthesizer(cfg, mesh=mesh).load_variables(variables)
    fn = syn.make_sharded_synth(mesh, B, L, max_iters=iters)
    wav, align, mel = fn(inputs, lengths, sids, seed=5, gl_angles=angles)
    out = {"wav": wav.numpy(), "align": align.numpy(), "mel": mel.numpy(),
           "table": syn.model.speaker_table.weight.detach().numpy()}
    rows = syn.shards.get("speaker_table.weight")
    if rows is not None:
        # the gather from the row-sharded table, both ways: the hybrid
        # branch's (ids differ across the row) and the sequence branch's
        table = syn.model.speaker_table.weight
        b = B // mesh.size
        mine = torch.as_tensor(sids[rank * b:(rank + 1) * b])
        row = torch.as_tensor(sids[mesh.data_index * (B // mesh.data):][:B // mesh.data])
        with torch.no_grad():
            out["embed_hybrid"] = sharded_speaker_embed(table, rows.start, mine, mesh).numpy()
            out["embed_seq"] = sharded_speaker_embed(table, rows.start, row, mesh,
                                                     batch_sharded=False).numpy()
        out["rows"] = (rows.start, rows.stop)
    return out


def _module_rank(rank, attention_args, synth_cases):
    torch.set_num_threads(1)
    return {"attention": {k: _attention_rank(rank, k, *attention_args) for k in (True, False)},
            "synth": {name: _synth_rank(rank, *case) for name, case in synth_cases.items()}}


BRANCHES = {
    # name: (mesh, B, L, overrides); hybrid_model_axis=false routes a
    # non-trivial model axis to the sequence-sharded decode
    "seq": ((2, 2), 4, 16, ",parallel.hybrid_model_axis=false"),
    "hybrid": ((2, 2), 8, 16, ""),
    "dp": ((4, 1), 8, 16, ""),
}
ITERS = 4


def _synth_case(branch):
    """(the rank arguments, the JAX key) of one branch: numpy flax variables
    (test_torch_synth's draw), a batch whose last text ends in the first
    L-shard, and the Griffin-Lim initial phases JAX draws: per batch shard
    from the key folded with the shard index (DP: the data index; hybrid:
    data·M + model), or once for the whole batch (sequence-sharded)."""
    jax, _, jconfig, _ = _jax()
    from test_torch_synth import _variables
    (n_data, n_model), B, L, extra = BRANCHES[branch]
    jcfg = jconfig.parse_overrides(jconfig.tiny(), OVERRIDES + extra)
    rs = np.random.RandomState(0)
    inputs = rs.randint(2, 40, (B, L))
    lengths = rs.randint(L // 2, L + 1, B)
    lengths[-1] = L // 4 - 1
    sids = rs.randint(0, 16, B)
    key = jax.random.PRNGKey(7)
    frames, bins = ITERS * jcfg.model.outputs_per_step, jcfg.audio.num_freq
    draw = lambda k, b: np.asarray(jax.random.uniform(k, (b, frames, bins),
                                                      minval=-math.pi, maxval=math.pi))
    parts = {"dp": n_data, "hybrid": n_data * n_model, "seq": 1}[branch]
    angles = (draw(key, B) if parts == 1 else np.concatenate(
        [draw(jax.random.fold_in(key, i), B // parts) for i in range(parts)]))
    return ((n_data, n_model), OVERRIDES + extra, _variables(jcfg, seed=3), B, L, ITERS,
            inputs, lengths, sids, angles), key


@pytest.fixture(scope="module")
def ranks():
    """Every rank computation of this module, from one spawn of four gloo
    ranks (a spawn costs seconds of imports): the sharded attention step
    with and without the kernel wrapper, and make_sharded_synth in each
    branch.  Returns (attention inputs, {branch: (rank args, key)}, each
    rank's results)."""
    att = _partial_case(np.random.RandomState(2))[:5]
    cases = {b: _synth_case(b) for b in BRANCHES}
    outs = run_ranks(_module_rank, 4, att, {b: c[0] for b, c in cases.items()},
                     device="cpu", timeout=300)
    return att, cases, outs


# -- the distributed softmax over four ranks -----------------------------------

@pytest.mark.parametrize("use_kernel", [True, False])
def test_sharded_attention_step_matches_jax(use_kernel, ranks):
    # (data=1, model=4): each rank holds a quarter of L=256; row 1 (40
    # positions) is fully masked on three ranks and row 3 on all four
    jax, jnp, _, _ = _jax()
    from tacotron_multispeaker_tpu.ops.attention_step import attention_step_reference
    from tacotron_multispeaker_tpu.ops.sharded_attention import (
        make_sharded_attention_step as jstep, shard_attention_inputs)
    att, _, outs = ranks
    ctx = [o["attention"][use_kernel][0] for o in outs]
    al = np.concatenate([o["attention"][use_kernel][1] for o in outs], axis=1)
    assert all(np.array_equal(c, ctx[0]) for c in ctx)       # the same on every rank
    jmesh = _mesh_jax(1, 4)
    args = [jnp.asarray(a) for a in att]
    ctx_s, al_s = jax.jit(jstep(jmesh, "model", use_pallas=use_kernel, interpret=True))(
        *shard_attention_inputs(jmesh, "model", *args))
    ctx_r, al_r = attention_step_reference(*args)
    for c, a in ((ctx_s, al_s), (ctx_r, al_r)):
        np.testing.assert_allclose(ctx[0], np.asarray(c), atol=1e-4)
        np.testing.assert_allclose(al, np.asarray(a), atol=1e-5)


# -- make_sharded_synth, each branch, against the JAX package's ----------------

@pytest.mark.parametrize("branch", list(BRANCHES))
def test_make_sharded_synth_matches_jax(branch, ranks):
    jax, jnp, jconfig, _ = _jax()
    from tacotron_multispeaker_tpu.synthesizer import Synthesizer as JSynthesizer
    _, cases, outs = ranks
    ((n_data, n_model), overrides, variables, B, L, iters, inputs, lengths, sids, _), key = \
        cases[branch]
    jcfg = jconfig.parse_overrides(jconfig.tiny(), overrides)
    jsyn = JSynthesizer(jcfg).load_variables(variables)
    jfn = jsyn.make_sharded_synth(_mesh_jax(n_data, n_model), B, L, max_iters=iters)
    wav_j, al_j, mel_j = (np.asarray(a) for a in jfn(
        variables, jnp.asarray(inputs, jnp.int32), jnp.asarray(lengths, jnp.int32),
        jnp.asarray(sids, jnp.int32), key))
    outs = [o["synth"][branch] for o in outs]
    # test_parallel.py's tolerances for the sharded decode (f32, sum order
    # carried through the autoregressive steps), the waveform to 1e-3 of its
    # peak with the phases injected (as test_torch_synth.py)
    for r, out in enumerate(outs):
        assert out["mel"].shape == mel_j.shape and out["align"].shape == al_j.shape
        np.testing.assert_allclose(out["mel"], mel_j, atol=2e-3, err_msg=f"rank {r}")
        np.testing.assert_allclose(out["align"], al_j, atol=1e-4, err_msg=f"rank {r}")
        np.testing.assert_allclose(out["wav"], wav_j, atol=1e-3 * np.abs(wav_j).max(),
                                   err_msg=f"rank {r}")
    # each rank keeps only its S/M rows of the speaker table, as P("model", None)
    table = variables["params"]["speaker_table"]["embedding"]
    for r, out in enumerate(outs):
        if n_model == 1:
            assert "rows" not in out and np.array_equal(out["table"], table)
            continue
        j = r % n_model
        assert out["rows"] == (j * 16 // n_model, (j + 1) * 16 // n_model)
        np.testing.assert_array_equal(out["table"], table[slice(*out["rows"])])
        b = B // 4
        np.testing.assert_array_equal(out["embed_hybrid"], table[sids[r * b:(r + 1) * b]])
        i = r // n_model
        np.testing.assert_array_equal(out["embed_seq"],
                                      table[sids[i * B // n_data:(i + 1) * B // n_data]])


# -- guards --------------------------------------------------------------------

def _failing_rank(rank):
    if rank == 1:
        raise ValueError("rank 1 failed on purpose")
    return rank


def test_run_ranks_fails_when_a_rank_fails():
    with pytest.raises(Exception, match="rank 1 failed on purpose"):
        run_ranks(_failing_rank, 2, device="cpu", timeout=120)
    assert run_ranks(_failing_rank, 1, device="cpu", timeout=120) == [0]


def test_location_attention_under_sequence_sharding_raises():
    cfg = tconfig.get_config("tiny", "model.attention_type=location")
    with pytest.raises(NotImplementedError, match="bahdanau attention only"):
        make_attention(cfg.model, 64, seq_mesh=make_mesh(device="cpu"))
    _, _, jconfig, _ = _jax()
    from tacotron_multispeaker_tpu.models.attention import make_attention as jmake
    with pytest.raises(NotImplementedError, match="bahdanau attention only"):
        jmake(jconfig.get_config("tiny", "model.attention_type=location").model, None,
              seq_mesh=object())


def test_mesh_and_make_sharded_synth_refuse_what_they_cannot_serve(tmp_path):
    with pytest.raises(ValueError, match="cannot form mesh"):
        make_mesh(data=3, model=1, device="cpu")                # one process, not 3
    with pytest.raises(ValueError, match="nccl"):
        initialize_distributed(init_method=f"file://{tmp_path}/store", world_size=2,
                               rank=0, device="cpu", backend="nccl")
    cfg = tconfig.get_config("tiny", OVERRIDES)
    mesh = Mesh(data=2, model=2, rank=3, device=torch.device("cpu"))
    syn = Synthesizer(cfg, mesh=mesh)
    assert syn.shards == {"speaker_table.weight": slice(8, 16)}
    assert syn.model.speaker_table.weight.shape == (8, 8)
    with pytest.raises(ValueError, match="batch 3 not divisible by data axis 2"):
        syn.make_sharded_synth(mesh, 3, 16)
    with pytest.raises(ValueError, match="length 15 not divisible by model axis 2"):
        syn.make_sharded_synth(mesh, 4, 15)
    with pytest.raises(ValueError, match="built for this mesh"):
        syn.make_sharded_synth(Mesh(2, 2, 3, torch.device("cpu")), 4, 16)
    with pytest.raises(ValueError, match="make_sharded_synth"):
        syn.synthesize_batch(["hello"])
    with pytest.raises(ValueError, match="not the mesh's"):
        Synthesizer(cfg, device="meta", mesh=mesh)
