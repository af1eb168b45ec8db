#!/usr/bin/env python3
"""Time one kernel of one checkout of the port, for an A/B in turns.

    python3 gl_ab.py DIR [build] [--mode MODE]

MODE is one of gl, decoder, teacher, teacher_fwd, gru_bwd, gru_fwd,
attention, ola, wgrad and loop.

Runs the port of the checkout in DIR (any commit of it) on inputs made by
this checkout's ``chip_smoke.py`` and prints one ``AB`` line.  ``build``
builds every kernel library of DIR first.

- ``gl`` (the default): the fused Griffin-Lim call (kernel 13,
  ``ops.gl_iteration.gl_fast_iterations``) at B=32 and B=1 (F=1000, n_fft
  2048, hop 275, 12 bf16 iterations, the serving window, the inputs of
  ``phase_gl_iteration``): the call's time (CUDA events) and the device
  time of each of its three kernels (profiler).
- ``decoder``: the fused decoder loop (kernel 5, ``ops.decoder_loop``) at
  B=1 L=96 and B=32 L=192, 200 bf16 steps (the inputs of
  ``phase_decoder``), CUDA events; then ``Synthesizer`` at full-width
  ``multispeaker_vctk`` on the ``serve`` and ``serve_pallas`` paths (random
  weights from a seed): a B=1 request and a B=32 batch at input bucket 192,
  each the median of three host-clock runs ending in a synchronise, and
  each one's device-busy ms (profiler, one more run).
- ``teacher``: the teacher-forced backward (kernel 8,
  ``ops.teacher_decoder._bwd_kernel``) at B=32 L=192 S=200 H=A=256 D=320
  bf16 (the inputs of ``phase_teacher``): its time (CUDA events) and the
  device time of its launches (profiler: ``teacher_bwd`` is every launch,
  ``remat`` and ``scan`` the two of the prologue design); then the bare
  train step at full-width ``multispeaker_vctk`` B=32 L=192 T=1000 bf16
  (``training.make_train_step``, random weights from a seed, the batch of
  ``phase_train``): the median of three host-clock steps ending in a
  synchronise, and one more step's device-busy ms (profiler).
- ``teacher_fwd``: the teacher-forced forward (kernel 6,
  ``ops.teacher_decoder.teacher_decoder_fwd``) at B=32 L=192 S=200 H=A=256
  D=320 bf16 (the inputs of ``phase_teacher``): its call time (CUDA events;
  the cluster size where the checkout has one) and its launch's device time
  (profiler), then the bare train step as for ``teacher``.
- ``gru_bwd``: the GRU scan backward (``ops.gru_scan._bwd_kernel``, B=32
  F=128 bf16, the inputs of ``phase_bigru_bwd`` / ``phase_gru_scan_bwd``):
  kernel 4 (two directions) at T=192 and T=1000 and kernel 2 (one
  direction) at T=1000, each call's time (CUDA events) and the device time
  of its launches (profiler: ``bigru`` is every launch, ``remat`` and
  ``scan`` the two of the prologue design); then the bare train step as
  for ``teacher``.
- ``gru_fwd``: the GRU scan forward (``ops.gru_scan.bigru_scan`` /
  ``gru_scan``, F=128 bf16, the inputs of ``phase_bigru`` /
  ``phase_gru_scan``): kernel 3 (two directions) at B=32 T=192 and T=1000
  and at B=1 T=1000, kernel 1 (one direction) at B=32 T=1000, each call's
  time (CUDA events) and its launch's device time (profiler); then
  ``Synthesizer`` at full-width ``multispeaker_vctk`` on the ``serve``
  path, a B=1 request at input bucket 192 (the median of three host-clock
  runs and one more run's device-busy ms), and the bare train step as for
  ``teacher``.
- ``attention``: the attention step (kernel 9, ``ops.attention_step``) at
  B=32 L=192 and B=1 L=96 (A=256 D=320 bf16, location term) and its
  per-shard partial (kernel 10) at B=8 L=48 A=256 D=384 f32 (the inputs
  of ``phase_attention_step`` / ``phase_attention_partial``), each call's
  time back to back (CUDA events; the wrapper's host time bounds it) and
  its launch's device time (profiler; the cluster size where the checkout
  has one); then ``Synthesizer`` on the ``serve_location`` path: a B=1
  request at input buckets 96 and 192 and a B=32 batch at 192, each the
  median of three host-clock runs and one more run's device-busy ms.
- ``ola``: the overlap-add (kernel 12, ``ops.overlap_add.overlap_add``) at
  F=1000 hop 275 f32 (the inputs of ``phase_overlap_add``): windowed
  2048-sample frames and, where the checkout's wrapper takes
  ``prewindowed``, prewindowed 1102-sample support frames, each at B=32 and
  B=1: the call's time back to back (CUDA events) and a launch's device
  time (profiler); then ``serve_location`` as for ``attention``.
- ``wgrad``: the weight-gradient reduction (``ops.wgrad.wgrad``, bf16) at
  the train step's three launches (``_wgrad_problems``: the teacher
  backward's 11 products over 6400 rows, the BiGRU's 4 and the GRU's 2 over
  32000), each call's time back to back (CUDA events) and the device time
  of its kernels (profiler, every kernel named ``wgrad*``); kernel 7
  (``ops.teacher_decoder.dkeys``) at S=200 B=32 L=192 A=256 bf16, its call
  time and the device time of its two kernels; then the bare train step as
  for ``teacher``.
- ``loop``: the trainer's loop (``train_loop.train``) at full-width
  ``multispeaker_vctk`` B=32 on ``chip_smoke._loop_corpus`` (64 utterances
  featurised on the card), the timed window of ``chip_smoke._loop_window``
  from a fresh start (steps 7-22 timed, 23-26 profiled): ms a step and the
  profiled steps' idle share, on the Feeder and, where the checkout has
  it, on the grain loader with 4 worker processes.

To compare two versions on one card, run it in turns in one command:
parent, change, change, parent.  Needs a CUDA device.
"""

import argparse
import os
import statistics
import sys
import time


def _gl(c, torch):
    from tacotron_multispeaker_torch.ops import gl_iteration as gl
    times = []
    for B, reps in ((32, 5), (1, 10)):
        wf0, mag, win = c._gl_case(B, 1000, seed=51 if B > 1 else 52)
        w0 = wf0.to(torch.bfloat16)
        run = lambda: gl.gl_fast_iterations(w0, mag, win, 275, 12, 0.99 / 1.99)  # noqa: E731
        ms = c.cuda_time_ms(run, reps=reps)
        split, _ = c._device_split_ms(run, c.GL_KERNELS)
        times.append(f"B={B} {ms:.3f} ms " + str({k: round(v, 3) for k, v in split.items()}))
    return " ".join(times)


def _host_ms(torch, fn, reps=3):
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def _busy_ms(torch, fn):
    from torch.profiler import ProfilerActivity, profile
    try:
        from tacotron_multispeaker_torch.tracing import device_busy
    except ImportError:         # a checkout from before the tracing module
        from tacotron_multispeaker_torch.train_loop import device_busy
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return device_busy(prof)[0]


def _decoder(c, torch):
    from tacotron_multispeaker_torch.config import get_config
    from tacotron_multispeaker_torch.ops import decoder_loop as dl
    from tacotron_multispeaker_torch.synthesizer import Synthesizer
    parts = []
    for B, L, seed in ((1, 96, 6), (32, 192, 5)):
        args = c._decoder_case(B, L, 200, torch.bfloat16, scale=0.05, seed=seed)
        ms = c.cuda_time_ms(lambda: dl.decoder_loop(*args), reps=5)
        plan = getattr(dl, "last_plan", None)
        parts.append(f"kernel B={B} L={L} S=200 {ms:.3f} ms"
                     + (f" (C={plan[0]})" if plan else ""))
    text, spk = c.SERVE_TEXTS[2]
    batch = [c.SERVE_TEXTS[i % len(c.SERVE_TEXTS)][0] for i in range(32)]
    for path in ("serve", "serve_pallas"):
        cfg = get_config("multispeaker_vctk", c.PATHS[path])
        syn = Synthesizer(cfg, seed=0)
        spks = [(7 * i) % cfg.model.num_speakers for i in range(32)]
        syn.warmup()
        one = lambda: syn.synthesize_batch([text], [spk], pad_to=192)  # noqa: E731
        many = lambda: syn.synthesize_batch(batch, spks, pad_to=192)  # noqa: E731
        one()
        many()
        parts.append(f"{path} B=1 {_host_ms(torch, one):.2f} ms busy "
                     f"{_busy_ms(torch, one):.2f}; B=32 {_host_ms(torch, many):.2f} ms busy "
                     f"{_busy_ms(torch, many):.2f}")
    return " | ".join(parts)


def _train_step(c, torch, B=32, L=192):
    """The bare train step at full-width ``multispeaker_vctk`` B=32 L=192
    T=1000 bf16: the median of three host-clock steps and one more step's
    device-busy ms."""
    from tacotron_multispeaker_torch import training
    from tacotron_multispeaker_torch.config import get_config
    cfg = get_config("multispeaker_vctk")
    model, state = training.create_train_state(cfg, seed=0)
    step = training.make_train_step(cfg, model)
    batch = c._train_batch(cfg, B, L, 1000, seed=5, device="cuda")
    holder = [state]

    def one():
        holder[0] = step(holder[0], *batch)[0]

    one()
    one()
    return f"train step B={B} {_host_ms(torch, one):.2f} ms busy {_busy_ms(torch, one):.2f}"


def _teacher(c, torch):
    from tacotron_multispeaker_torch.ops import teacher_decoder as td
    B, L, S = 32, 192, 200
    w, args = c._teacher_case(B, L, S, torch.bfloat16, seed=24)
    png, pnc, h0a, h0d, keys, memory, mask = args
    states = td.teacher_decoder_fwd(png, pnc, h0a, h0d, w, keys, memory, mask)
    bargs = c._teacher_bwd_args(args, w, states, seed=25)
    run = lambda: td._bwd_kernel(*bargs)  # noqa: E731
    ms = c.cuda_time_ms(run, reps=3)
    split, _ = c._device_split_ms(run, ("teacher_bwd", "teacher_bwd_remat", "teacher_bwd_scan"))
    parts = [f"kernel 8 B={B} L={L} S={S} {ms:.3f} ms "
             + str({k: round(v, 3) for k, v in split.items()})]
    del bargs, states
    parts.append(_train_step(c, torch, B, L))
    return " | ".join(parts)


def _teacher_fwd(c, torch):
    from tacotron_multispeaker_torch.ops import teacher_decoder as td
    B, L, S = 32, 192, 200
    w, args = c._teacher_case(B, L, S, torch.bfloat16, seed=24)
    run = lambda: td.teacher_decoder_fwd(*args[:4], w, *args[4:])  # noqa: E731
    ms = c.cuda_time_ms(run, reps=5)
    plan = getattr(td, "fwd_last_plan", None)
    split, _ = c._device_split_ms(run, ("teacher_fwd",))
    parts = [f"kernel 6 B={B} L={L} S={S} {ms:.3f} ms" + (f" (C={plan[0]})" if plan else "")
             + f" device {split['teacher_fwd']:.3f}"]
    del args
    parts.append(_train_step(c, torch, B, L))
    return " | ".join(parts)


def _gru_bwd(c, torch):
    from tacotron_multispeaker_torch.ops import gru_scan as gs
    parts = []
    for dirs, T in ((2, 192), (2, 1000), (1, 1000)):
        args = c._gru_bwd_case(dirs, T, 32, 128, torch.bfloat16, seed=11 if dirs == 2 else 12)
        run = lambda: gs._bwd_kernel(*args)  # noqa: E731
        ms = c.cuda_time_ms(run, reps=5)
        split, _ = c._device_split_ms(run, ("bigru", "bigru_bwd_remat", "bigru_bwd_scan"))
        parts.append(f"kernel {4 if dirs == 2 else 2} T={T} B=32 {ms:.3f} ms "
                     + str({k: round(v, 4) for k, v in split.items()}))
    del args
    parts.append(_train_step(c, torch))
    return " | ".join(parts)


def _gru_fwd(c, torch):
    from tacotron_multispeaker_torch.config import get_config
    from tacotron_multispeaker_torch.ops import gru_scan as gs
    from tacotron_multispeaker_torch.synthesizer import Synthesizer
    parts = []
    for dirs, B, T in ((2, 32, 192), (2, 32, 1000), (2, 1, 1000), (1, 32, 1000)):
        fwd, inputs = ((gs.bigru_scan, c._bigru_inputs) if dirs == 2
                       else (gs.gru_scan, c._gru_inputs))
        args = inputs(T, B, 128, torch.bfloat16, seed=7 if dirs == 2 else 9)
        run = lambda: fwd(*args)  # noqa: E731
        ms = c.cuda_time_ms(run, reps=10)
        dev = c._launch_device_ms(run, "bigru_scan")
        parts.append(f"kernel {3 if dirs == 2 else 1} B={B} T={T} {ms:.4f} ms device {dev:.4f}")
    del args
    text, spk = c.SERVE_TEXTS[2]
    syn = Synthesizer(get_config("multispeaker_vctk", c.PATHS["serve"]), seed=0)
    syn.warmup()
    one = lambda: syn.synthesize_batch([text], [spk], pad_to=192)  # noqa: E731
    one()
    parts.append(f"serve B=1 {_host_ms(torch, one):.2f} ms busy {_busy_ms(torch, one):.2f}")
    del syn
    parts.append(_train_step(c, torch))
    return " | ".join(parts)


def _attention(c, torch):
    from tacotron_multispeaker_torch.ops import attention_step as ast
    parts = []
    for B, L in ((32, 192), (1, 96)):
        args = c._attention_case(B, L, 256, 320, torch.bfloat16, seed=33 + B + L)
        run = lambda: ast.attention_step(*args)  # noqa: E731
        ms = c.cuda_time_ms(run, reps=50)
        dev = c._launch_device_ms(run, "attention_step", reps=20)
        plan = getattr(ast, "last_plan", None)
        parts.append(f"kernel 9 B={B} L={L} {ms:.4f} ms device {dev:.4f}"
                     + (f" (C={plan[0]})" if plan else ""))
    args = c._partial_case(8, 48, 256, 384, torch.float32, seed=42)
    run = lambda: ast.attention_step_partial(*args)  # noqa: E731
    ms = c.cuda_time_ms(run, reps=200)
    dev = c._launch_device_ms(run, "attention_step", reps=20)
    parts.append(f"kernel 10 B=8 L=48 f32 {ms:.4f} ms device {dev:.4f}")
    del args
    return " | ".join(parts + _serve_location(c, torch))


def _serve_location(c, torch):
    """``Synthesizer`` on the ``serve_location`` path: a B=1 request at input
    buckets 96 and 192 and a B=32 batch at 192, each the median of three
    host-clock runs and one more run's device-busy ms."""
    from tacotron_multispeaker_torch.config import get_config
    from tacotron_multispeaker_torch.synthesizer import Synthesizer
    parts = []
    syn = Synthesizer(get_config("multispeaker_vctk", c.PATHS["serve_location"]), seed=0)
    syn.warmup()
    for bucket, (text, spk) in ((96, c.SERVE_TEXTS[1]), (192, c.SERVE_TEXTS[2])):
        one = lambda: syn.synthesize_batch([text], [spk], pad_to=bucket)  # noqa: E731
        one()
        parts.append(f"serve_location B=1 bucket {bucket} {_host_ms(torch, one):.2f} ms busy "
                     f"{_busy_ms(torch, one):.2f}")
    batch = [c.SERVE_TEXTS[i % len(c.SERVE_TEXTS)][0] for i in range(32)]
    spks = [(7 * i) % syn.cfg.model.num_speakers for i in range(32)]
    many = lambda: syn.synthesize_batch(batch, spks, pad_to=192)  # noqa: E731
    many()
    parts.append(f"serve_location B=32 {_host_ms(torch, many):.2f} ms busy "
                 f"{_busy_ms(torch, many):.2f}")
    return parts


def _ola(c, torch):
    import inspect
    from tacotron_multispeaker_torch.ops import overlap_add as ola
    support = "prewindowed" in inspect.signature(ola.overlap_add).parameters
    parts = []
    for mode, (Wn, prewindowed) in c.OLA_MODES.items():
        if prewindowed and not support:
            continue
        for B in (32, 1):
            frames, win = c._ola_case(B, 1000, Wn, prewindowed, torch.float32, seed=43 + B)
            kw = {"prewindowed": True} if prewindowed else {}
            run = lambda: ola.overlap_add(frames, win, 275, **kw)  # noqa: E731
            ms = c.cuda_time_ms(run, reps=50 if B == 1 else 20)
            dev = c._launch_device_ms(run, "overlap_add", reps=20 if B == 1 else 5)
            parts.append(f"kernel 12 {mode} B={B} {ms:.4f} ms device {dev:.4f}")
            del frames
    return " | ".join(parts + _serve_location(c, torch))


def _wgrad(c, torch):
    from tacotron_multispeaker_torch.ops import teacher_decoder as td
    from tacotron_multispeaker_torch.ops import wgrad as wg
    parts = []
    for n, kind in enumerate(("teacher", "bigru", "gru")):
        probs = c._wgrad_problems(kind, seed=71 + n)
        run = lambda: wg.wgrad(probs, torch.bfloat16)  # noqa: E731
        ms = c.cuda_time_ms(run, reps=10)
        split, _ = c._device_split_ms(run, ("wgrad",), reps=3)
        parts.append(f"wgrad {kind} {ms:.4f} ms device {split['wgrad']:.4f}")
    del probs
    B, L, A, S = 32, 192, 256, 200
    g = torch.Generator(device="cuda").manual_seed(23)
    keys = (torch.randn(B, L, A, generator=g, device="cuda") * 0.3).to(torch.bfloat16)
    q = torch.randn(S, B, A, generator=g, device="cuda")
    de = torch.randn(S, B, L, generator=g, device="cuda") * 1e-2
    v = (torch.randn(A, generator=g, device="cuda") * 0.2).to(torch.bfloat16)
    run = lambda: td.dkeys(keys, q, de, v)  # noqa: E731
    ms = c.cuda_time_ms(run, reps=10)
    split, _ = c._device_split_ms(run, ("dkeys", "dv_reduce"), reps=3)
    parts.append(f"kernel 7 S={S} B={B} L={L} A={A} {ms:.4f} ms device "
                 f"{sum(split.values()):.4f} ({split['dkeys']:.4f} + {split['dv_reduce']:.4f})")
    del keys, q, de
    parts.append(_train_step(c, torch))
    return " | ".join(parts)


def _loop(c, torch):
    import inspect
    import shutil
    import tempfile
    from tacotron_multispeaker_torch import train_loop
    from tacotron_multispeaker_torch.config import get_config
    cfg = get_config("multispeaker_vctk", c.LOOP_OVERRIDES)
    runs = [("feeder", {})]
    if "pipeline_workers" in inspect.signature(train_loop.train).parameters:
        runs.append((f"grain {c.LOOP_WORKERS} workers",
                     dict(pipeline="grain", pipeline_workers=c.LOOP_WORKERS)))
    parts = [] if len(runs) > 1 else ["grain: not in this checkout"]
    base = tempfile.mkdtemp(prefix="loop_ab-")
    try:
        data = c._loop_corpus(base, cfg)[0]
        for n, (label, kw) in enumerate(runs):
            ms, prof = c._loop_window(os.path.join(base, f"logs{n}"), data, "", 0,
                                      6 + c.LOOP_TIMED, **kw)
            parts.append(f"{label} {ms:.2f} ms a step, idle share {prof['idle_share']:.3f} "
                         f"(busy {prof['device_busy_ms']:.2f} of {prof['wall_ms']:.2f} ms over "
                         f"{c.LOOP_PROFILED} profiled steps)")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return " | ".join(parts)


def main() -> int:
    import torch
    import chip_smoke as c          # this checkout's; it imports the port lazily
    ap = argparse.ArgumentParser()
    ap.add_argument("dir")
    ap.add_argument("build", nargs="?", choices=["build"])
    ap.add_argument("--mode", choices=["gl", "decoder", "teacher", "teacher_fwd", "gru_bwd",
                                       "gru_fwd", "attention", "ola", "wgrad", "loop"],
                    default="gl")
    opts = ap.parse_args()
    root = os.path.abspath(opts.dir)
    os.chdir(root)
    sys.path.insert(0, root)
    if not torch.cuda.is_available():
        print("gl_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if opts.build:
        from tacotron_multispeaker_torch.ops import KERNELS, cuda_build
        cuda_build.build_all(KERNELS)
    line = {"gl": _gl, "decoder": _decoder, "teacher": _teacher,
            "teacher_fwd": _teacher_fwd, "gru_bwd": _gru_bwd,
            "gru_fwd": _gru_fwd, "attention": _attention, "ola": _ola,
            "wgrad": _wgrad, "loop": _loop}[opts.mode](c, torch)
    print(f"AB {opts.mode} {opts.dir}: {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
