"""Where the port's time goes: named spans on the profiler's clock, and the
trainer's profile window.

``span(name, device=None, **attrs)`` marks a stage of the work.  Spans are
on exactly while a ``torch.profiler`` (or ``torch.autograd.profiler``)
session runs in the process, or inside ``record()``, which turns them on
with no profiler (host intervals and device-stream ms from the events
alone, without the profiler's cost at each launch); otherwise ``span``
returns one shared no-op object and costs a function call.  An open span

* under a profiler, enters ``record_function(name)``, so the stage appears
  in the profiler's trace on the clock of the device activity (a device
  idle gap is put down to the innermost span over it);
* takes its host interval from ``time.perf_counter_ns``;
* on a CUDA device (``device``, or its parent's), records a timing event
  pair on the device's current stream; nothing waits for them until the
  records are read;
* when it closes, appends a :class:`SpanRecord` to this process's list:
  its name, host interval, device-stream ms, parent, root and ``attrs``
  (an attribute noted as a device tensor is read when the records are).

Spans nest per thread.  ``spans()`` returns the finished records with the
device times resolved (one synchronize), ``clear()`` empties the list, and
``self_ms`` gives a record's host time outside its children.

The synthesis path's spans (all under one ``synth.call`` root a call):
``synth.prepare`` (texts to padded device tensors), ``synth.encoder``,
``synth.decode`` (Tacotron 2's notes ``steps`` and ``replays``, the CUDA
graph replays), Tacotron 2's ``synth.stop`` (each row's stop frame; it notes
``rows_stopped``), ``synth.postnet``, ``synth.griffin_lim`` (it notes
``gl_bins``, the spectrum width its products run at, ``audio.dsp.gl_bins``;
Tacotron 2's holds ``synth.mel_to_linear``), ``synth.trim``
(the launches of each row's endpoint search on the device; it notes
``rows_cut``, the rows cut short, and ``kept``, the share of the decoded
samples returned), ``synth.copy`` (the copies to pinned host memory and the
host's one wait for the device) and, in pod synthesis, ``synth.gather``.  The
train loop's: ``train.next_batch``, ``train.step``, ``train.sync`` and
``train.checkpoint``.

``start_profile`` / ``stop_profile`` are the train loop's ``--profile``
window; ``device_busy`` and ``idle_by_span`` reduce a finished profile.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.autograd import profiler as _profiler

from .utils.infolog import log


@dataclass
class SpanRecord:
    """A finished span.  ``start_ns`` / ``end_ns``: host ``perf_counter_ns``;
    ``device_ms``: the device stream's time between the span's two events
    (None off a CUDA device, and until ``spans()`` resolves it);
    ``root``: the id of the outermost span it ran under (its own if none)."""
    name: str
    id: int
    parent: int | None
    root: int
    start_ns: int
    end_ns: int
    attrs: dict
    device_ms: float | None = None
    _events: tuple | None = field(default=None, repr=False)

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class _Off:
    """The span while no profiler runs: enters nothing, records nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **attrs) -> None:
        pass


OFF = _Off()
_recording = 0                   # open record() blocks
_records: list[SpanRecord] = []
_ids = itertools.count(1)
_local = threading.local()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Span:
    __slots__ = ("name", "device", "attrs", "id", "parent", "root", "_rf", "_ev0", "_t0")

    def __init__(self, name, device, attrs):
        self.name, self.device, self.attrs = name, device, attrs

    def note(self, **attrs) -> None:
        """Add attributes known only once the span has started (or closed:
        its record keeps the same attributes)."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _stack()
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = up.id if up is not None else None
        self.root = up.root if up is not None else self.id
        if self.device is None and up is not None:
            self.device = up.device
        elif self.device is not None:
            self.device = torch.device(self.device)
        self._rf = None
        if _profiler._is_profiler_enabled:
            self._rf = _profiler.record_function(self.name)
            self._rf.__enter__()
        self._ev0 = None
        if self.device is not None and self.device.type == "cuda":
            self._ev0 = torch.cuda.Event(enable_timing=True)
            self._ev0.record(torch.cuda.current_stream(self.device))
        stack.append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        events = None
        if self._ev0 is not None:
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record(torch.cuda.current_stream(self.device))
            events = (self._ev0, ev1, self.device)
        _stack().pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _records.append(SpanRecord(self.name, self.id, self.parent, self.root, self._t0, t1,
                                   self.attrs, _events=events))
        return False


def span(name: str, device=None, **attrs):
    """A context manager marking one stage; see the module docstring.
    ``device``: the torch device its work runs on (default: the enclosing
    span's).  ``attrs`` are kept on the record; ``note(**attrs)`` adds more
    inside the span."""
    if not (_recording or _profiler._is_profiler_enabled):
        return OFF
    return _Span(name, device, attrs)


@contextlib.contextmanager
def record():
    """Spans on for the block with no profiler running."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def spans() -> list[SpanRecord]:
    """The finished records in the order they closed, device times resolved."""
    recs = list(_records)
    pending = [r for r in recs if r._events is not None]
    for dev in {r._events[2] for r in pending}:
        torch.cuda.synchronize(dev)
    for r in pending:
        r.device_ms = r._events[0].elapsed_time(r._events[1])
        r._events = None
    for r in recs:
        for k, v in r.attrs.items():
            if isinstance(v, torch.Tensor):       # noted on the device, read now
                r.attrs[k] = v.item()
    return recs


def clear() -> None:
    _records.clear()


def self_ms(record: SpanRecord, records: list[SpanRecord]) -> float:
    """``record``'s host ms outside the union of its children's intervals."""
    kids = sorted((max(r.start_ns, record.start_ns), min(r.end_ns, record.end_ns))
                  for r in records if r.parent == record.id)
    covered, end = 0, record.start_ns
    for s, e in kids:
        s = max(s, end)
        if e > s:
            covered += e - s
            end = e
    return (record.end_ns - record.start_ns - covered) / 1e6


# -- reading a finished profile -------------------------------------------------

def _device_ops(prof) -> list[tuple[int, int, str]]:
    """(start us, end us, name) of the device's operations; a span's copy on
    the device track (a user annotation) is no operation."""
    from torch.autograd import DeviceType
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))


def _busy_intervals(ops) -> list[list]:
    merged = []
    for s, e, _ in ops:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def device_busy(prof) -> tuple[float | None, int, dict]:
    """Of a finished ``torch.profiler`` run: the device-busy ms (the union
    of the device's operations; None when the trace holds none), the number
    of operations, and {kernel name: (device ms, count)}."""
    ops = _device_ops(prof)
    if not ops:
        return None, 0, {}
    by_name = {}
    for s, e, name in ops:
        tot, n = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + (e - s) / 1e3, n + 1)
    busy_us = sum(e - s for s, e in _busy_intervals(ops))
    return busy_us / 1e3, len(ops), by_name


def idle_by_span(prof) -> list[tuple[str, float]]:
    """The device's idle ms between its first and last operation, by the
    innermost host event (a span or an operator) open at each gap's
    midpoint: the ten largest."""
    from torch.autograd import DeviceType
    busy = _busy_intervals(_device_ops(prof))
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    host = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.device_type == DeviceType.CPU)
    idle, active, i = defaultdict(float), [], 0
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        while i < len(host) and host[i][0] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= mid]
        idle[active[-1][2] if active else "no host span"] += (g1 - g0) / 1e3
    return sorted(idle.items(), key=lambda kv: -kv[1])[:10]


# -- the train loop's profile window ------------------------------------------

def start_profile(dev):
    """Start a ``torch.profiler`` over the host and, on a CUDA device, the
    device; → (the profiler, its start on the host clock)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    prof = profile(activities=acts)
    prof.start()
    return prof, time.perf_counter()


def stop_profile(prof, t0, dev, log_dir, steps) -> dict:
    """Stop the trace, write it to ``<log_dir>/profile/``, and log the
    window's wall time, device-busy time (the union of the device's
    operations), idle share, top device kernels and the device's idle time
    by innermost host span."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof.stop()
    os.makedirs(os.path.join(log_dir, "profile"), exist_ok=True)
    path = os.path.join(log_dir, "profile", f"steps-{steps[0]}-{steps[1]}.json")
    prof.export_chrome_trace(path)
    busy_ms, n_spans, by_name = device_busy(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    summary = {"steps": list(steps), "wall_ms": wall_ms, "device_busy_ms": busy_ms,
               "device_spans": n_spans, "top": [(name[:60], ms) for name, (ms, _) in top]}
    if busy_ms is not None:
        summary["idle_share"] = 1.0 - busy_ms / wall_ms
        summary["idle_by_span"] = [(name[:60], ms) for name, ms in idle_by_span(prof)]
    log(f"profiler trace of steps [{steps[0]}, {steps[1]}) written to {path}: {summary}")
    return summary
