"""The port's Synthesizer against the JAX package's, and the port's import
boundary (it must not import JAX, flax, grain, ml_dtypes or the JAX
package, nor load the JAX package's native library)."""

import ast
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

# the JAX package's models need flax: where it is not installed this module
# skips, and `pytest -m gpu tests/test_torch_*.py` still collects the gpu tests
pytest.importorskip("flax")

from tacotron_multispeaker_tpu import config as jconfig
from tacotron_multispeaker_tpu.synthesizer import Synthesizer as JSynthesizer
from tacotron_multispeaker_tpu.training import create_train_state
from tacotron_multispeaker_torch import config as tconfig
from tacotron_multispeaker_torch.ops import decoder_loop, gru_scan
from tacotron_multispeaker_torch.synthesizer import Synthesizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "tacotron_multispeaker_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "grain", "ml_dtypes",
             "tacotron_multispeaker_tpu")


def _variables(jcfg, seed=0):
    """Numpy flax variables shaped by eval_shape: lecun-scaled kernels,
    small biases, non-trivial BatchNorm statistics."""
    st = jax.eval_shape(lambda r: create_train_state(jcfg, r)[1], jax.random.PRNGKey(0))
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name in ("kernel", "embedding", "v"):
            fan_in = int(np.prod(s.shape[:-1])) if name != "embedding" else s.shape[-1]
            return (rs.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("scale", "var"):
            return rs.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return np.asarray(rs.randn(*s.shape) * 0.1, np.float32)
    return jax.tree_util.tree_map_with_path(
        leaf, {"params": st.params, "batch_stats": st.batch_stats})


SYNTH_OVERRIDES = ("model.prenet_dropout=0.0,model.num_speakers=3,"
                   "audio.gl_method=dft_f32,model.max_iters=12")


def test_synthesize_batch_matches_jax():
    # f32 throughout, dropout off, the JAX Griffin-Lim's initial phases
    # injected; the 12-step autoregressive decode and 15 GL iterations carry
    # f32 sum-order differences -> 1e-3 of the peak on the waveform
    jcfg = jconfig.get_config("tiny", SYNTH_OVERRIDES)
    variables = _variables(jcfg)
    texts = ["Hello there, world.", "A short one."]
    sids, seed = [0, 2], 3
    wavs_j, al_j = JSynthesizer(jcfg).load_variables(variables).synthesize_batch(
        texts, sids, seed=seed)
    syn = Synthesizer(tconfig.get_config("tiny", SYNTH_OVERRIDES), device="cpu")
    frames = jcfg.model.max_iters * jcfg.model.outputs_per_step
    angles = jax.random.uniform(jax.random.PRNGKey(seed),
                                (2, frames, jcfg.audio.num_freq),
                                minval=-math.pi, maxval=math.pi)
    wavs_t, al_t = syn.load_variables(variables).synthesize_batch(
        texts, sids, seed=seed, gl_angles=np.asarray(angles))
    assert al_t.shape == al_j.shape
    np.testing.assert_allclose(al_t, al_j, atol=1e-4)
    for w_t, w_j in zip(wavs_t, wavs_j):
        assert w_t.shape == w_j.shape
        np.testing.assert_allclose(w_t, w_j, atol=1e-3 * np.abs(w_j).max())


def test_synthesize_batch_with_use_pallas_matches_jax():
    # parallel.use_pallas: the JAX package runs conv_bank_pallas, the
    # per-step scan with attention_step_pallas and overlap_add_pallas for
    # every overlap-add of dft_f32 (interpret mode), the port their plain
    # versions; f32, dropout off, the same initial phases -> as above
    ov = SYNTH_OVERRIDES + ",parallel.use_pallas=true,model.attention_type=location"
    jcfg = jconfig.get_config("tiny", ov)
    variables = _variables(jcfg, seed=1)
    texts, sids, seed = ["Hello there, world.", "A short one."], [1, 2], 4
    wavs_j, al_j = JSynthesizer(jcfg).load_variables(variables).synthesize_batch(
        texts, sids, seed=seed)
    frames = jcfg.model.max_iters * jcfg.model.outputs_per_step
    angles = jax.random.uniform(jax.random.PRNGKey(seed), (2, frames, jcfg.audio.num_freq),
                                minval=-math.pi, maxval=math.pi)
    syn = Synthesizer(tconfig.get_config("tiny", ov), device="cpu").load_variables(variables)
    wavs_t, al_t = syn.synthesize_batch(texts, sids, seed=seed, gl_angles=np.asarray(angles))
    np.testing.assert_allclose(al_t, al_j, atol=1e-4)
    for w_t, w_j in zip(wavs_t, wavs_j):
        assert w_t.shape == w_j.shape
        np.testing.assert_allclose(w_t, w_j, atol=1e-3 * np.abs(w_j).max())


@pytest.mark.parametrize("preset,overrides", [
    ("tiny", ""), ("tiny", "model.serve_frames_per_char=10"),
    ("multispeaker_vctk", "model.serve_frames_per_char=7.5")])
def test_serve_bucket_and_iters_agree(preset, overrides):
    jsyn = JSynthesizer(jconfig.get_config(preset, overrides))
    tsyn = Synthesizer.__new__(Synthesizer)      # no weights needed
    tsyn.cfg = tconfig.get_config(preset, overrides)
    for n in range(1, 260):
        assert tsyn._serve_bucket(n) == jsyn._serve_bucket(n)
        assert tsyn._iters_for(n) == jsyn._iters_for(n)
    texts = ["hi.", "Printing, in the only sense with which we are at present concerned."]
    assert tsyn.serve_bucket_for(texts) == jsyn.serve_bucket_for(texts)


def test_synthesize_on_cpu_returns_a_wav_and_launches_nothing(tmp_path):
    gru_scan.launches = gru_scan.fma_launches = 0
    decoder_loop.launches = 0
    cfg = tconfig.get_config("tiny", "model.num_speakers=3,model.max_iters=8")
    syn = Synthesizer(cfg, device="cpu", seed=1)
    syn.warmup()
    data = syn.synthesize("Hello.", speaker_id=2)
    assert data[:4] == b"RIFF" and len(data) > 44
    assert gru_scan.launches == gru_scan.fma_launches == decoder_loop.launches == 0
    path = str(tmp_path / "weights.pt")
    syn.save(path)
    other = Synthesizer(cfg, device="cpu", seed=2).load(path)
    assert all(torch.equal(a, b) for a, b in zip(syn.model.state_dict().values(),
                                                  other.model.state_dict().values()))


def test_entry_points_need_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Synthesizer(tconfig.get_config("tiny"))


def _python_files():
    for root, _, files in os.walk(PORT):
        yield from (os.path.join(root, f) for f in files if f.endswith(".py"))
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "gl_ab.py")
    # a test module that runs only the port (its ranks and the train loop)
    yield os.path.join(REPO, "tests", "test_torch_parallel_loop.py")
    # the tools that import the port or chip_smoke.py
    for name in ("decoder_variants.py", "decoder_phase_clock.py", "teacher_bwd_variants.py",
                 "gru_bwd_variants.py", "gru_bwd_phase_clock.py", "gru_fwd_variants.py",
                 "gru_fwd_phase_clock.py", "gru_fwd_sigmoid_check.py", "variant_build.py",
                 "attention_variants.py", "attention_phase_clock.py",
                 "attention_plan_sweep.py", "ola_variants.py", "wgrad_variants.py",
                 "dkeys_variants.py", "sharded_relu_flips.py"):
        yield os.path.join(REPO, "tools", name)


def test_port_sources_import_nothing_of_jax():
    """AST scan: every import statement, including those inside functions."""
    bad = []
    for path in _python_files():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [f"{os.path.relpath(path, REPO)}: {n}" for n in names
                    if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("name", ["test_torch_parallel.py", "test_torch_parallel_train.py"])
def test_rank_modules_import_jax_only_inside_functions(name):
    """A test module whose ranks are spawned is imported by every rank: its
    top-level imports (those a rank runs) name nothing of JAX, and its JAX
    side is imported inside functions."""
    path = os.path.join(REPO, "tests", name)
    tree = ast.parse(open(path).read(), path)
    top = []
    for node in tree.body:
        if isinstance(node, ast.Import):
            top += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            top.append(node.module or "")
    assert "tacotron_multispeaker_torch" in {n.split(".")[0] for n in top}
    assert not [n for n in top if n.split(".")[0] in FORBIDDEN], top
    inner = [n for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
             and (n.module or "").startswith("tacotron_multispeaker_tpu")]
    assert inner                                     # the JAX side, inside a function


def test_importing_the_port_loads_no_jax_module():
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import tacotron_multispeaker_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        f"spec = importlib.util.spec_from_file_location('chip_smoke', {os.path.join(REPO, 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "import tacotron_multispeaker_torch.train as t, tacotron_multispeaker_torch.preprocess as q\n"
        "import tacotron_multispeaker_torch.validate as v, tacotron_multispeaker_torch.eval as e\n"
        "import tacotron_multispeaker_torch.demo_server as d\n"
        "import contextlib, io\n"
        "for main in (t.main, q.main, v.main, e.main, d.main):\n"
        "    with contextlib.redirect_stdout(io.StringIO()):\n"
        "        try:\n"
        "            main(['--help'])\n"
        "        except SystemExit:\n"
        "            pass\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len([m for m in sys.modules if m.startswith(p.__name__)]), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # every module was imported, the entry points and the train loop's among them
    assert int(proc.stdout.split()[0]) >= 30


def test_port_builds_and_loads_its_own_native_batcher():
    # no source of the port names the JAX package's native directory or its
    # library; the batcher the port loads is its own build of its own copy
    from tacotron_multispeaker_torch.data import native_batcher
    bad = [os.path.relpath(path, REPO) for path in _python_files()
           if "tacotron_multispeaker_tpu/native" in open(path).read()
           or "libbatcher" in open(path).read()]
    assert not bad, bad
    assert native_batcher.SRC == native_batcher._PKG / "native" / "batcher.cc"
    assert native_batcher.available(), native_batcher.build_error()
    loaded = os.path.realpath(native_batcher._lib._name)
    assert loaded.startswith(os.path.join(PORT, "build") + os.sep), loaded
