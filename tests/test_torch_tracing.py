"""The port's spans (``tacotron_multispeaker_torch.tracing``) on the CPU,
``tiny`` preset: nothing recorded and no ``record_function`` entered
without a profiler, and records but no ``record_function`` inside
``tracing.record()``; under a profiler, a ``synthesize_batch`` call's spans nest
under one ``synth.call`` root, agree with the profiler's own events, and
feed the benchmark's per-call readers; the profile window's idle time by
innermost host span.  Also what ``synthesize_batch`` returns: each row is
the untrimmed waveform cut at ``find_endpoint``, no later call writes into
an earlier call's arrays, and ``synth.trim`` notes the rows cut and the
share kept (on the CPU, and on a card with the ``gpu`` marker)."""

import json
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import tacotron_multispeaker_torch
from benchmark import core
from tacotron_multispeaker_torch import tracing
from tacotron_multispeaker_torch.config import get_config
from tacotron_multispeaker_torch.synthesizer import Synthesizer

OV = "model.num_speakers=4,model.max_iters=6,audio.gl_method=dft_f32"
TEXTS, SPEAKERS = ["hello there, a test.", "a short one"], [0, 3]
CHILDREN = ["synth.prepare", "synth.encoder", "synth.decode", "synth.postnet",
            "synth.griffin_lim", "synth.trim", "synth.copy"]
READERS = {"prepare_ms_per_call.synth": "host", "encoder_ms_per_call.synth": "device",
           "decode_ms_per_call.synth": "device", "postnet_ms_per_call.synth": "device",
           "griffin_lim_ms_per_call.synth": "device", "trim_ms_per_call.synth": "host"}


@pytest.fixture(scope="module")
def synth():
    s = Synthesizer(get_config("tiny", OV), device="cpu", seed=0)
    s.synthesize_batch(TEXTS, SPEAKERS, seed=1, pad_to=32)
    return s


def traced_call(synth):
    """One call under a CPU profiler → (its records, the profiler)."""
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        synth.synthesize_batch(TEXTS, SPEAKERS, seed=1, pad_to=32)
    return tracing.spans(), prof


def reader(name):
    return core.load_by_path(core.HERE / "metrics" / f"{name}.py",
                             "reader_" + name.replace(".", "_"))


def test_without_a_profiler_nothing_is_entered_or_recorded(synth, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered without a profiler")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    tracing.clear()
    wavs, _ = synth.synthesize_batch(TEXTS, SPEAKERS, seed=1, pad_to=32)
    assert len(wavs) == 2 and tracing.spans() == []
    off = tracing.span("synth.call", device="cpu", rows=2)
    assert off is tracing.OFF and tracing.span("anything") is off
    with off as s:
        s.note(bucket=32)
    assert tracing.spans() == []


def test_record_turns_the_spans_on_without_a_profiler(synth, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered without a profiler")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    tracing.clear()
    with tracing.record():
        synth.synthesize_batch(TEXTS, SPEAKERS, seed=1, pad_to=32)
    recs = tracing.spans()
    root, = [r for r in recs if r.name == "synth.call"]
    assert [r.name for r in recs if r.parent == root.id] == CHILDREN
    assert root.attrs == {"rows": 2, "bucket": 32}
    assert tracing.span("synth.call") is tracing.OFF        # off again after the block
    tracing.clear()


def test_call_spans_nest_under_one_root(synth):
    recs, _ = traced_call(synth)
    roots = [r for r in recs if r.name == "synth.call"]
    assert len(roots) == 1
    root = roots[0]
    assert root.parent is None and root.root == root.id
    assert root.attrs == {"rows": 2, "bucket": 32}
    kids = [r for r in recs if r.parent == root.id]
    assert [r.name for r in kids] == CHILDREN
    # the width of Griffin-Lim's products: the tiny preset's 513 bins to 520
    assert kids[CHILDREN.index("synth.griffin_lim")].attrs == {"gl_bins": 520}
    by_id = {r.id: r for r in recs}
    for r in recs:
        assert r.root == root.id and r.device_ms is None
        if r.parent is not None:
            up = by_id[r.parent]
            assert up.start_ns <= r.start_ns <= r.end_ns <= up.end_ns, (r, up)
        assert tracing.self_ms(r, recs) >= 0
    # the children account for the call: its self time is the glue between them
    assert tracing.self_ms(root, recs) < root.host_ms


# 40 steps: 54,725 samples a row, past find_endpoint's window and hop (22,050
# at 22.05 kHz); a linear-projection bias of 0.4 leaves one of the four
# rows silent from its start and the others above the threshold throughout
CUT_OV = "model.num_speakers=4,model.max_iters=40,audio.gl_method=dft_f32"
CUT_TEXTS, CUT_SPEAKERS = (["hello there, a test.", "a short one", "and a third text here",
                            "four"], [0, 3, 1, 2])
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)]


def cut_synth(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: python -m pytest -m gpu tests/test_torch_*.py")
    s = Synthesizer(get_config("tiny", CUT_OV), device=device, seed=0)
    with torch.no_grad():
        s.model.linear_proj.bias.fill_(0.4)
    return s


@pytest.mark.parametrize("device", DEVICES)
def test_rows_are_the_untrimmed_waveform_cut_at_find_endpoint(device, monkeypatch):
    s = cut_synth(device)
    untrimmed = []
    make_fn = s._make_fn

    def spy(*args, **kw):
        fn = make_fn(*args, **kw)

        def run(*a):
            out = fn(*a)
            untrimmed.append(out[0].cpu().numpy().copy())
            return out
        return run
    monkeypatch.setattr(s, "_make_fn", spy)
    wavs, aligns = s.synthesize_batch(CUT_TEXTS, CUT_SPEAKERS, seed=1, pad_to=32)
    (full,) = untrimmed
    assert full.shape == (4, 54725) and aligns.shape == (4, 40, 32)
    ends = [s.ap.find_endpoint(row) for row in full]
    assert 0 < sum(e < full.shape[1] for e in ends) < 4       # cut and uncut rows
    for w, row, e in zip(wavs, full, ends):
        assert w.dtype == np.float32 and np.array_equal(w, row[:e])


@pytest.mark.parametrize("device", DEVICES)
def test_a_later_call_leaves_earlier_arrays_alone(device):
    s = cut_synth(device)
    calls = [s.synthesize_batch(CUT_TEXTS, CUT_SPEAKERS, seed=1, pad_to=32)]
    kept = [[w.copy() for w in calls[0][0]], calls[0][1].copy()]
    for seed in (2, 3, 4):           # other phases and dropout: other samples
        calls.append(s.synthesize_batch(CUT_TEXTS[::-1], CUT_SPEAKERS, seed=seed, pad_to=32))
    wavs, aligns = calls[0]
    assert all(np.array_equal(a, b) for a, b in zip(wavs, kept[0]))
    assert np.array_equal(aligns, kept[1])
    assert not np.array_equal(calls[-1][1], aligns)


def test_trim_notes_rows_cut_and_the_share_kept():
    s = cut_synth("cpu")
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        wavs, _ = s.synthesize_batch(CUT_TEXTS, CUT_SPEAKERS, seed=1, pad_to=32)
    recs = tracing.spans()
    (root,) = [r for r in recs if r.name == "synth.call"]
    assert [r.name for r in recs if r.parent == root.id] == CHILDREN
    (trim,) = [r for r in recs if r.name == "synth.trim"]
    n = 54725                                    # the untrimmed row
    assert trim.attrs["rows_cut"] == sum(len(w) < n for w in wavs) == 1
    assert trim.attrs["kept"] == pytest.approx(sum(len(w) for w in wavs) / (4 * n))
    assert 0 < trim.attrs["kept"] < 1


def test_profiler_events_agree_with_the_records(synth):
    recs, prof = traced_call(synth)
    events = {}
    for e in prof.events():
        if e.name.startswith("synth.") and e.device_type == DeviceType.CPU:
            events.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
    assert sorted(events) == sorted({r.name for r in recs})
    for r in recs:
        (ms,) = events[r.name]
        assert abs(ms - r.host_ms) <= max(0.1 * r.host_ms, 1.0), (r.name, ms, r.host_ms)


def _open_and_close(name):
    with tracing.span(name):
        pass


def test_spans_nest_per_thread_and_self_time():
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("outer", kind="a") as outer:
            outer.note(more=1)
            with tracing.span("inner.1"):
                torch.ones(64).sum()
            t = threading.Thread(target=_open_and_close, args=("other",))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            with tracing.span("inner.2"):
                with tracing.span("leaf"):
                    pass
    recs = {r.name: r for r in tracing.spans()}
    assert set(recs) == {"outer", "inner.1", "inner.2", "leaf", "other"}
    outer = recs["outer"]
    assert outer.attrs == {"kind": "a", "more": 1}
    assert recs["other"].parent is None and recs["other"].root == recs["other"].id
    assert recs["leaf"].parent == recs["inner.2"].id and recs["leaf"].root == outer.id
    all_recs = list(recs.values())
    kids = recs["inner.1"].host_ms + recs["inner.2"].host_ms
    assert tracing.self_ms(outer, all_recs) == pytest.approx(outer.host_ms - kids, abs=1e-6)
    assert tracing.self_ms(recs["leaf"], all_recs) == recs["leaf"].host_ms
    tracing.clear()
    assert tracing.spans() == []


def synth_window():
    """The benchmark's ``synth_batch`` loop at the tiny preset on the CPU,
    its window under a CPU profiler: every call of the window is traced."""
    import dataclasses

    from benchmark.drivers import synth_batch
    mix = core.load_json(core.HERE / "traffic/mixes/synth_b32.json")
    mix.update(batch=2, min_chars=10, max_chars=60, median_chars=25, buckets=[32, 64],
               block=10, sample=1, trace_calls=2, reference_rows=2)
    cell = core.load_cell("vctk_synth_b32")
    cell.traffic = mix
    cell.config = {"name": "tiny", "preset": "tiny", "overrides": OV,
                   "serve_weights": {"linear_proj.bias": 0.6},
                   "resolved": json.loads(json.dumps(dataclasses.asdict(get_config("tiny", OV))))}
    d = synth_batch.Driver(cell, 2**31 + 977, "cpu")
    d.setup()
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        d.window(0.3)
    d.traced = list(d.calls_done)
    d.release()
    return d


def test_benchmark_readers_read_the_spans(capsys, monkeypatch):
    d = synth_window()
    ctx = d.layer_context()
    assert len(ctx["calls"]) >= 1
    recs = tracing.spans()
    calls = [r for r in recs if r.name == "synth.call"]
    assert len(calls) == len(ctx["calls"])
    for name, clock in READERS.items():
        value = reader(name).read(ctx)
        if clock == "host":
            stage = "synth." + name.split("_ms_")[0]
            want = sum(r.host_ms for r in recs if r.name == stage) / len(calls)
            assert value == pytest.approx(want) and value > 0, name
        else:
            assert value is None, name          # no device time on the CPU
    assert capsys.readouterr().err == ""
    # a count or shape that differs from the window's traced calls is reported
    ctx["calls"] = ctx["calls"] + [(999, [1])]
    assert reader("trim_ms_per_call.synth").read(ctx) > 0
    assert "the window traced" in capsys.readouterr().err
    # a port without the tracing module gives no reading
    monkeypatch.setitem(sys.modules, "tacotron_multispeaker_torch.tracing", None)
    monkeypatch.delattr(tacotron_multispeaker_torch, "tracing")
    assert reader("prepare_ms_per_call.synth").read(ctx) is None


def _event(name, start, end, device, annotation=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=device, is_user_annotation=annotation)


def test_device_idle_by_innermost_host_span():
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    prof = SimpleNamespace(events=lambda: [
        _event("synth.call", 0, 1000, cpu), _event("synth.encoder", 10, 200, cpu),
        _event("synth.trim", 600, 990, cpu), _event("aten::mm", 20, 40, cpu),
        _event("synth.call", 0, 1000, cuda, annotation=True),    # a span's device copy
        _event("k1", 30, 100, cuda), _event("k2", 140, 300, cuda),
        _event("k3", 500, 520, cuda), _event("k4", 980, 1000, cuda)])
    busy, n, by_name = tracing.device_busy(prof)
    assert (busy, n) == ((70 + 160 + 20 + 20) / 1e3, 4) and "synth.call" not in by_name
    # gaps: 100-140 (mid 120: the encoder), 300-500 (mid 400: the call
    # itself), 520-980 (mid 750: the trim)
    assert dict(tracing.idle_by_span(prof)) == pytest.approx(
        {"synth.encoder": 0.04, "synth.call": 0.2, "synth.trim": 0.46})
