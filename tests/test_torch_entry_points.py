"""The port's ``validate``, ``eval`` and ``demo_server`` entry points and the
Feeder's ``shuffle`` / ``drop_remainder`` options, on the CPU, ``tiny``
preset, three speakers, prenet dropout off.

One synthetic corpus (11 utterances: groups of 8 leave a short last batch)
and one checkpoint of numpy weights serve the module.  ``validate``'s report
is held against the root ``validate.py`` (the JAX package) on the same
weights and corpus; the Feeder's plans against the JAX Feeder's; ``eval``'s
bucket groups against the root ``eval.py``'s; ``demo_server`` is started as
``python -m tacotron_multispeaker_torch.demo_server --port 0`` and asked
over a real socket.
"""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

pytest.importorskip("flax")

from scipy.io import wavfile  # noqa: E402

from tacotron_multispeaker_tpu import config as jconfig  # noqa: E402
from tacotron_multispeaker_tpu import training as jtraining  # noqa: E402
from tacotron_multispeaker_tpu.data import feeder as jfeeder  # noqa: E402
from tacotron_multispeaker_torch import config as tconfig  # noqa: E402
from tacotron_multispeaker_torch import eval as eval_main  # noqa: E402
from tacotron_multispeaker_torch import preprocess as preprocess_main  # noqa: E402
from tacotron_multispeaker_torch import validate as validate_main  # noqa: E402
from tacotron_multispeaker_torch.data import feeder, grain_pipeline  # noqa: E402
from tacotron_multispeaker_torch.synthesizer import Synthesizer  # noqa: E402
from test_torch_model import _fill  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one output bucket; the eval and demo checks add a second input bucket
OV = ("model.num_speakers=3,model.prenet_dropout=0.0,model.max_iters=8,"
      "train.batch_size=4,train.batches_per_group=2,audio.griffin_lim_iters=2,"
      "train.input_bucket_boundaries=(64),train.bucket_boundaries=(200)")
OV_SERVE = OV.replace("train.input_bucket_boundaries=(64)",
                      "train.input_bucket_boundaries=(16,64)")
N_UTTS = 11


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(corpus dir, checkpoint file, flax variables)."""
    base = str(tmp_path_factory.mktemp("entry"))
    path = preprocess_main.main(["--dataset", "synthetic", "--base_dir", base, "--preset",
                                 "tiny", "--n_utts", str(N_UTTS), "--n_speakers", "3",
                                 "--device", "cpu"])
    jcfg = jconfig.get_config("tiny", OV)
    st = jax.eval_shape(lambda r: jtraining.create_train_state(jcfg, r)[1],
                        jax.random.PRNGKey(0))
    variables = _fill({"params": st.params, "batch_stats": st.batch_stats},
                      np.random.RandomState(8))
    ckpt = os.path.join(base, "weights.pt")
    Synthesizer(tconfig.get_config("tiny", OV), device="cpu").load_variables(variables).save(ckpt)
    return os.path.dirname(path), ckpt, variables


@pytest.mark.parametrize("shuffle,drop_remainder", [(True, True), (False, False),
                                                    (False, True), (True, False)])
def test_feeder_plan_options_match_jax(setup, shuffle, drop_remainder):
    corpus = setup[0]
    tcfg, jcfg = tconfig.get_config("tiny", OV), jconfig.get_config("tiny", OV)
    kw = dict(shuffle=shuffle, drop_remainder=drop_remainder, use_native=False)
    plan = feeder.Feeder(corpus, tcfg, seed=3, **kw).epoch_plan(1)
    jplan = jfeeder.Feeder(corpus, jcfg, seed=3, process_index=0, process_count=1,
                           **kw).epoch_plan(1)
    assert plan == jplan
    rows = [i for entry in plan for i in entry[2]]
    assert len(set(rows)) == len(rows) == (8 if drop_remainder else N_UTTS)
    if not shuffle:
        # the metadata order within the group sort
        frames = [r["n_frames"] for r in feeder.Feeder(corpus, tcfg, use_native=False).meta]
        assert rows == sorted(range(8), key=frames.__getitem__) + sorted(
            range(8, len(rows)), key=frames.__getitem__)
    if shuffle and drop_remainder:
        # the defaults keep the plan the port's train loop has always used
        assert plan == feeder.Feeder(corpus, tcfg, seed=3, use_native=False).epoch_plan(1)


def test_short_last_batch_native_numpy_and_loader(setup):
    # drop_remainder=False leaves a 3-row batch: the native assembler, the
    # numpy path and the loader's in-process dataset give the same arrays,
    # and the JAX Feeder's
    corpus = setup[0]
    tcfg, jcfg = tconfig.get_config("tiny", OV), jconfig.get_config("tiny", OV)
    f_cc = feeder.Feeder(corpus, tcfg, shuffle=False, drop_remainder=False, use_native=True)
    f_py = feeder.Feeder(corpus, tcfg, shuffle=False, drop_remainder=False, use_native=False)
    assert f_cc.use_native
    plan = f_cc.epoch_plan(0)
    short = [i for i, e in enumerate(plan) if len(e[2]) < 4]
    assert len(short) == 1 and len(plan[short[0]][2]) == N_UTTS % 8
    entry = plan[short[0]]
    loader = grain_pipeline._PlanBatches(f_py, len(plan), 1, None)
    jbatch = jfeeder.Feeder(corpus, jcfg, shuffle=False, drop_remainder=False,
                            use_native=False, process_index=0,
                            process_count=1).materialize(entry)
    for b in (f_cc.materialize(entry), f_py.materialize(entry), loader[short[0]]):
        for name in ("inputs", "input_lengths", "mel_targets", "linear_targets",
                     "target_lengths", "speaker_ids"):
            np.testing.assert_array_equal(np.asarray(getattr(b, name)),
                                          np.asarray(getattr(jbatch, name)), name)


def test_validate_report_matches_root_validate(setup, tmp_path, monkeypatch):
    # every utterance (n_utterances = the corpus size, the short batch
    # included); frames exact; per-speaker and overall L1s 1e-5 relative
    # (the port's fused teacher decoder against the JAX XLA scan, f32, as
    # in tests/test_torch_train.py)
    corpus, ckpt, variables = setup
    ours = tmp_path / "port.json"
    report = validate_main.main(["--checkpoint_dir", ckpt, "--data_dir", corpus, "--preset",
                                 "tiny", "--hparams", OV, "--json_out", str(ours),
                                 "--device", "cpu"])
    assert json.loads(ours.read_text()) == report

    import validate as jvalidate
    from tacotron_multispeaker_tpu import synthesizer as jsynth
    monkeypatch.setattr(jsynth.Synthesizer, "load",
                        lambda self, d, step=None: self.load_variables(variables))
    theirs = tmp_path / "jax.json"
    monkeypatch.setattr(sys, "argv", ["validate.py", "--checkpoint_dir", "-", "--data_dir",
                                      corpus, "--preset", "tiny", "--hparams", OV,
                                      "--json_out", str(theirs)])
    jvalidate.main()
    ref = json.loads(theirs.read_text())
    assert report["n_utterances"] == ref["n_utterances"] == N_UTTS
    assert sorted(report["per_speaker"]) == sorted(ref["per_speaker"]) == ["0", "1", "2"]
    for sid, r in ref["per_speaker"].items():
        o = report["per_speaker"][sid]
        assert o["frames"] == r["frames"]
        for k in ("mel_l1", "linear_l1"):
            assert abs(o[k] - r[k]) <= 1e-5 * abs(r[k]), (sid, k, o[k], r[k])
    for k in ("mel_l1", "linear_l1"):
        assert abs(report["overall"][k] - ref["overall"][k]) <= 1e-5 * ref["overall"][k]
    # --limit stops at the first batch that reaches it, as the JAX loop does
    few = validate_main.main(["--checkpoint_dir", ckpt, "--data_dir", corpus, "--preset",
                              "tiny", "--hparams", OV, "--limit", "3", "--device", "cpu"])
    assert few["n_utterances"] == 4


TEXTS = ["The quick brown fox jumps over the lazy dog near the river.", "Hi there.",
         "Researchers counted eleven thousand samples.", "Go on."]


def test_eval_groups_by_bucket_and_writes_wavs(setup, tmp_path):
    # the root eval.py's groups (the JAX Synthesizer's buckets) and names
    import eval as jeval
    from tacotron_multispeaker_tpu.synthesizer import Synthesizer as JSynthesizer
    _, ckpt, _ = setup
    syn = Synthesizer(tconfig.get_config("tiny", OV_SERVE), device="cpu")
    groups = list(eval_main.group_by_bucket(syn, TEXTS, 1))
    jgroups = list(jeval.group_by_bucket(JSynthesizer(jconfig.get_config("tiny", OV_SERVE)),
                                         TEXTS, 1))
    assert groups == jgroups
    assert [g[0] for g in eval_main.group_by_bucket(syn, TEXTS, 2)] == [[1, 3], [0, 2]]
    assert eval_main.SENTENCES == jeval.SENTENCES
    out = tmp_path / "eval"
    paths = eval_main.main(["--checkpoint_dir", ckpt, "--preset", "tiny", "--hparams",
                            OV_SERVE, "--out_dir", str(out), "--batch_size", "2",
                            "--speaker_id", "2", "--device", "cpu", *sum(
                                (["--text", t] for t in TEXTS), [])])
    assert paths == [str(out / f"eval-{i}.wav") for i in (1, 3, 0, 2)]
    for p in paths:
        sr, wav = wavfile.read(p)
        assert sr == syn.cfg.audio.sample_rate and wav.ndim == 1 and len(wav) > 0


def _get(url):
    """(status, headers, body) of a GET, HTTP errors included."""
    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def test_demo_server_over_a_socket(setup):
    _, ckpt, _ = setup
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "tacotron_multispeaker_torch.demo_server", "--checkpoint_dir",
         ckpt, "--preset", "tiny", "--hparams", OV_SERVE, "--port", "0", "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving on"):
                break
        assert lines and lines[0].startswith("warming up"), lines
        port = int(lines[-1].rsplit(":", 1)[1])
        url = f"http://127.0.0.1:{port}"
        status, headers, body = _get(url + "/")
        assert status == 200 and headers["Content-Type"] == "text/html"
        assert b"/synthesize" in body
        assert _get(url + "/synthesize")[0] == 400
        assert _get(url + "/synthesize?speaker_id=1")[0] == 400
        assert _get(url + "/nowhere")[0] == 404
        # two requests at once, in two input buckets, and the first again
        results = {}
        asks = {"long": "/synthesize?text=" + urllib.request.quote(TEXTS[0]) + "&speaker_id=1",
                "short": "/synthesize?text=Hi%20there.&speaker_id=2"}
        threads = [threading.Thread(target=lambda k=k, q=q: results.__setitem__(k, _get(url + q)))
                   for k, q in asks.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for status, headers, body in results.values():
            assert status == 200 and headers["Content-Type"] == "audio/wav"
            assert body[:4] == b"RIFF" and body[8:12] == b"WAVE"
            assert int(headers["Content-Length"]) == len(body)
        assert _get(url + asks["long"])[2] == results["long"][2]
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        proc.stdout.close()
