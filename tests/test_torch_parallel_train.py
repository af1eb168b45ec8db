"""The port's sharded train steps against the JAX package's, on the CPU.

The port runs one process per mesh position: the module spawns four gloo
ranks once (``parallel.run_ranks``, a ``file://`` store in a temporary
directory), every rank runs every case and returns what it computed.  The
JAX side runs in this process on four of the eight virtual CPU devices
(conftest.py) through ``make_sharded_train_step``, from the same initial
weights (carried over by ``convert.py``) and the same global batch.  The
rank functions sit at the top of this module, which imports JAX only inside
the fixtures and tests, so that a spawned rank imports nothing but PyTorch
and the port.

``tiny``, float32, prenet dropout off (the frameworks draw different bits),
variable input and target lengths.  Tolerances are ``tests/test_parallel.py``'s:
loss rtol 1e-5, grad norm rtol 1e-4, every parameter and running statistic
atol 1e-5 after one and after two steps, but for an Adam sign flip of a
near-zero gradient (``_params_close``); the all-reduced gradients leaf by
leaf where they equal the unsharded step's.
"""

import numpy as np
import pytest
import torch

from tacotron_multispeaker_torch import config as tconfig
from tacotron_multispeaker_torch import convert, training
from tacotron_multispeaker_torch.device import warm_cpu_math
from tacotron_multispeaker_torch.parallel import make_mesh, run_ranks

BASE = "model.compute_dtype=float32,model.prenet_dropout=0.0"
# 16 speakers whose table shards over a model axis of 2 (the JAX
# _HYBRID_OVERRIDES at model_parallel_size 2)
SPEAKERS = ("model.num_speakers=16,model.speaker_embed_depth=8,"
            "parallel.model_parallel_size=2,parallel.shard_speaker_table_min=8")

# name: (overrides, mesh (data, model), the route make_sharded_train_step takes)
CASES = {
    "dp_cross_bn": (BASE + ",train.batch_size=8,parallel.bn_cross_replica=true",
                    (4, 1), "data_parallel"),
    "dp_local_bn": (BASE + ",train.batch_size=8", (4, 1), "data_parallel"),
    "dp_unmasked": (BASE + ",train.batch_size=8,train.loss_masking=false", (4, 1),
                    "data_parallel"),
    "hybrid": (BASE + ",train.batch_size=8,parallel.bn_cross_replica=true," + SPEAKERS,
               (2, 2), "hybrid"),
    # per-rank statistics, the running statistics averaged over the mesh
    "hybrid_local_bn": (BASE + ",train.batch_size=8," + SPEAKERS, (2, 2), "hybrid"),
    # 6 rows do not divide over the 4 ranks: the JAX package's GSPMD route,
    # the batch over data only
    "replicated": (BASE + ",train.batch_size=6," + SPEAKERS, (2, 2), "replicated"),
}
# the cases whose all-reduced gradient is the unsharded step's (global
# BatchNorm statistics): held leaf by leaf against jax.grad of the JAX loss
UNSHARDED_GRADS = ("dp_cross_bn", "hybrid", "replicated")
STEPS = 2
L, T = 12, 20


def _batch(cfg, B, seed):
    """A global batch in the Feeder's layout (numpy): variable input and
    target lengths, speakers over the whole table."""
    rs = np.random.RandomState(seed)
    in_len = np.r_[L, rs.randint(L // 2, L + 1, B - 1)]
    inputs = rs.randint(2, 60, (B, L)) * (np.arange(L)[None] < in_len[:, None])
    return (inputs.astype(np.int64), in_len.astype(np.int64),
            rs.rand(B, T, cfg.audio.num_mels).astype(np.float32),
            rs.rand(B, T, cfg.audio.num_freq).astype(np.float32),
            np.r_[T, rs.randint(T // 2, T + 1, B - 1)].astype(np.int64),
            rs.randint(0, max(cfg.model.num_speakers, 1), B).astype(np.int64))


def _state(cfg, mesh, variables):
    model, state = training.create_train_state(cfg, seed=0, device="cpu", mesh=mesh)
    model.load_state_dict(convert.flax_to_state_dict(variables, model, state.shards),
                          strict=True)
    return model, state


def _local(cfg, mesh, batch):
    index, count = training.batch_slice(cfg, mesh)
    n = batch[0].shape[0] // count
    return [torch.from_numpy(a[index * n:(index + 1) * n]) for a in batch]


def _rank_cases(rank, variables, batches, dropout_variables):
    """Every case on this rank: its route, table rows and, after each step,
    the metrics and the flax tree of its state; the clipped gradients of the
    first step; then the dropout case (the prenet outputs of a step, twice
    from the same state)."""
    warm_cpu_math()
    out = {}
    for name, (ov, (data, mdl), _) in CASES.items():
        cfg = tconfig.get_config("tiny", ov)
        mesh = make_mesh(cfg.parallel, data=data, model=mdl, device="cpu")
        model, state = _state(cfg, mesh, variables[name])
        step = training.make_sharded_train_step(cfg, model, mesh)
        local = _local(cfg, mesh, batches[name])
        res = {"route": training.train_route(cfg, mesh), "shards": state.shards, "steps": []}
        for n in range(STEPS):
            state, m = step(state, *local)
            res["steps"].append(({k: float(v) for k, v in m.items()},
                                 convert.state_dict_to_flax(model.state_dict(), model)))
            if n == 0:
                res["grads"] = convert.grads_to_flax(model)
        out[name] = res

    # dropout on: every rank gets the same rows, so the prenet outputs differ
    # across ranks only by their masks; a rerun from the same state repeats them
    cfg = tconfig.get_config("tiny", "model.compute_dtype=float32,train.batch_size=8")
    mesh = make_mesh(cfg.parallel, data=4, model=1, device="cpu")
    runs = []
    for _ in range(2):
        model, state = _state(cfg, mesh, dropout_variables)
        seen = []
        hooks = [mod.register_forward_hook(lambda _m, _i, o: seen.append(o.detach().clone()))
                 for mod in (model.encoder.prenet, model.dec_prenet)]
        step = training.make_sharded_train_step(cfg, model, mesh)
        local = [torch.from_numpy(a[:2]) for a in batches["dropout"]]
        for _ in range(STEPS):
            state, m = step(state, *local)
        for h in hooks:
            h.remove()
        runs.append((seen, float(m["loss"])))
    out["dropout"] = runs
    return out


def _jax():
    """The JAX side (imported here, not at the top: see the module doc)."""
    pytest.importorskip("flax")
    import jax
    from tacotron_multispeaker_tpu import config as jconfig
    from tacotron_multispeaker_tpu import training as jtraining
    from tacotron_multispeaker_tpu.parallel import make_mesh as jmake_mesh
    return jax, jconfig, jtraining, jmake_mesh


def _np_tree(tree):
    return {k: _np_tree(v) if hasattr(v, "items") else np.asarray(v) for k, v in tree.items()}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.fixture(scope="module")
def runs():
    """{case: (JAX steps, JAX first-step gradients or None, every rank's
    result)}, and the dropout case's per-rank runs.  The ranks run in a
    thread while this process runs the JAX side."""
    import threading
    import jax.numpy as jnp
    from test_torch_model import _fill
    jax, jconfig, jtraining, jmake_mesh = _jax()

    def initial(cfg, seed):
        """Numpy weights with non-trivial BatchNorm statistics (eval_shape:
        no init to compile) and the JAX state holding them."""
        model = jtraining.create_model("tacotron", cfg)
        abstract = jax.eval_shape(lambda r: jtraining.create_train_state(cfg, r, model)[1],
                                  jax.random.PRNGKey(0))
        v = _np_tree(_fill({"params": abstract.params, "batch_stats": abstract.batch_stats},
                           np.random.RandomState(seed)))
        state = jtraining.TrainState(
            step=jnp.zeros((), jnp.int32), params=v["params"], batch_stats=v["batch_stats"],
            opt_state=jtraining.make_optimizer(cfg).init(v["params"]),
            rng=jax.random.PRNGKey(0))
        return v, model, state

    variables, batches, jax_side = {}, {}, {}
    for seed, (name, (ov, _, _)) in enumerate(CASES.items()):
        cfg = jconfig.get_config("tiny", ov)
        variables[name], model, state0 = initial(cfg, seed)
        batches[name] = _batch(cfg, cfg.train.batch_size, seed=10 + seed)
        jax_side[name] = (cfg, model, state0)
    cfg = jconfig.get_config("tiny", "train.batch_size=8")
    dropout_variables = initial(cfg, 7)[0]
    batches["dropout"] = tuple(np.concatenate([a] * 4) for a in _batch(cfg, 2, seed=20))

    ranks = {}

    def spawn_ranks():
        try:
            ranks["out"] = run_ranks(_rank_cases, 4, variables, batches, dropout_variables,
                                     device="cpu", timeout=600)
        except BaseException as e:       # raised again in this thread below
            ranks["error"] = e

    spawn = threading.Thread(target=spawn_ranks)
    spawn.start()
    try:
        jax_runs = {}
        for name, (cfg, model, state0) in jax_side.items():
            data, mdl = CASES[name][1]
            batch = batches[name]
            grads = None
            if name in UNSHARDED_GRADS:
                loss_fn = jtraining._make_loss_fn(cfg, model)
                grads = _np_tree(jax.jit(jax.grad(loss_fn, has_aux=True))(
                    state0.params, state0.batch_stats, jax.random.PRNGKey(0), *batch)[0])
            mesh = jmake_mesh(devices=jax.devices()[:data * mdl], data=data, model=mdl)
            step_fn, state_sh = jtraining.make_sharded_train_step(cfg, model, mesh)(state0)
            state, steps = jax.device_put(state0, state_sh), []
            for _ in range(STEPS):
                state, m = step_fn(state, *batch)
                steps.append(({k: float(v) for k, v in m.items()},
                              _np_tree({"params": jax.device_get(state.params),
                                        "batch_stats": jax.device_get(state.batch_stats)})))
            jax_runs[name] = (steps, grads)
    finally:
        spawn.join()
    if "error" in ranks:
        raise ranks["error"]
    return {name: (*jax_runs[name], [r[name] for r in ranks["out"]]) for name in CASES}, [
        r["dropout"] for r in ranks["out"]]


def _params_close(got, want, lr_sum, what):
    """Parameters after the Adam updates: atol 1e-5 (test_parallel.py's),
    except that one element a leaf (or 1e-4 of its elements, if more) may
    lie up to 2·Σlr + 1e-5 apart.  Adam's update is close to lr·sign(g), so
    an element whose gradient is near zero can take the other sign under
    another f32 summation order (here the all-reduce and the BatchNorm sums
    against XLA's) and then sits 2·lr apart; a wrong gradient moves many
    elements."""
    diff = np.abs(np.asarray(got, np.float64) - want)
    bad = diff > 1e-5
    assert bad.sum() <= max(1, 1e-4 * diff.size), (what, int(bad.sum()), float(diff.max()))
    assert diff.max() <= 2 * lr_sum + 1e-5, (what, float(diff.max()), lr_sum)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_train_steps_match_jax(runs, name):
    jax_steps, _, ranks = runs[0][name]
    route = CASES[name][2]
    assert [r["route"] for r in ranks] == [route] * 4
    for n in range(STEPS):
        mj, tree_j = jax_steps[n]
        for rank, res in enumerate(ranks):
            mt, tree_t = res["steps"][n]
            what = f"{name} step {n} rank {rank}"
            np.testing.assert_allclose(mt["loss"], mj["loss"], rtol=1e-5, err_msg=what)
            np.testing.assert_allclose(mt["mel_loss"], mj["mel_loss"], rtol=1e-5, err_msg=what)
            np.testing.assert_allclose(mt["grad_norm"], mj["grad_norm"], rtol=1e-4,
                                       err_msg=what)
            assert mt["lr"] == pytest.approx(mj["lr"], rel=1e-6)
            rows = res["shards"].get("speaker_table.weight")
            j, t = dict(_leaves(tree_j)), dict(_leaves(tree_t))
            assert sorted(j) == sorted(t), what
            lr_sum = sum(jax_steps[k][0]["lr"] for k in range(n + 1))
            for path, b in j.items():
                if rows is not None and path == ("params", "speaker_table", "embedding"):
                    b = b[rows]                  # this rank's rows of the JAX table
                if path[0] == "batch_stats":
                    np.testing.assert_allclose(t[path], b, rtol=0, atol=1e-5,
                                               err_msg=f"{what} {'/'.join(path)}")
                else:
                    _params_close(t[path], b, lr_sum, f"{what} {'/'.join(path)}")
    if name in ("hybrid", "hybrid_local_bn", "replicated"):
        # each rank keeps its half of the table, and the rows learned
        assert [r["shards"]["speaker_table.weight"] for r in ranks] == [
            slice(0, 8), slice(8, 16)] * 2
        first = dict(_leaves(ranks[0]["steps"][-1][1]))
        assert first[("params", "speaker_table", "embedding")].shape == (8, 8)


@pytest.mark.parametrize("name", UNSHARDED_GRADS)
def test_sharded_gradients_match_jax_grad(runs, name):
    # the all-reduced gradient on every rank (clipped by the step's global
    # norm, in place) against jax.grad of the unsharded loss, clipped alike:
    # 1e-4 of each leaf's peak (reverse-mode sums through two recurrences and
    # the BatchNorms in other orders), floored at 1e-3 of the largest gradient
    # for leaves that are zero in exact arithmetic (a conv bias right before a
    # training-mode BatchNorm holds 1e-9 noise on both sides)
    jax_steps, grads_j, ranks = runs[0][name]
    norm = jax_steps[0][0]["grad_norm"]
    clip = min(1.0, tconfig.get_config("tiny").train.grad_clip_norm / norm)
    peak = max(float(np.abs(g).max()) for _, g in _leaves(grads_j)) * clip
    for rank, res in enumerate(ranks):
        rows = res["shards"].get("speaker_table.weight")
        got = dict(_leaves(res["grads"]))
        for path, g in _leaves(grads_j):
            g = g * clip
            if rows is not None and path == ("speaker_table", "embedding"):
                g = g[rows]
            err = np.abs(got[path] - g).max() / max(np.abs(g).max(), 1e-3 * peak)
            assert err <= 1e-4, (name, rank, path, err)


def test_dropout_masks_differ_across_ranks_and_repeat(runs):
    # prenet dropout on (tiny's 0.5), the same rows and weights on every
    # rank: each rank draws its own masks from (seed, step, data index), so
    # the prenets' outputs differ across ranks, and a second run from the
    # same state draws the same masks (bit for bit, losses included)
    _, dropout = runs
    for rank, ((first, loss_a), (second, loss_b)) in enumerate(dropout):
        assert len(first) == len(second) == 2 * STEPS, rank
        assert all(torch.equal(x, y) for x, y in zip(first, second)), rank
        assert loss_a == loss_b and np.isfinite(loss_a), rank
    for r in range(4):
        for s in range(r + 1, 4):
            for x, y in zip(dropout[r][0][0], dropout[s][0][0]):
                assert x.shape == y.shape and not torch.equal(x, y), (r, s)


def test_mesh_of_one_is_the_single_device_step():
    # outside a process group make_mesh gives a mesh of one, and the sharded
    # step is today's single-device step: two steps bit for bit (dropout on)
    cfg = tconfig.get_config("tiny", "train.batch_size=4")
    mesh = make_mesh(cfg.parallel, device="cpu")
    assert (mesh.size, training.train_route(cfg, mesh),
            training.batch_slice(cfg, mesh)) == (1, "single", (0, 1))
    batch = [torch.from_numpy(a) for a in _batch(cfg, 4, seed=3)]
    sides = []
    for m in (None, mesh):
        model, state = training.create_train_state(cfg, seed=1, device="cpu", mesh=m)
        step = (training.make_train_step(cfg, model) if m is None
                else training.make_sharded_train_step(cfg, model, m))
        metrics = []
        for _ in range(STEPS):
            state, mt = step(state, *batch)
            metrics.append({k: float(v) for k, v in mt.items()})
        sides.append((metrics, model.state_dict(), state.shards))
    assert sides[0][0] == sides[1][0] and sides[1][2] == {}
    assert all(torch.equal(v, sides[1][1][k]) for k, v in sides[0][1].items())
