#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases (no failure is caught; any exception exits non-zero):

1. The card: name and power limit (``nvidia-smi``), torch and CUDA versions.
   Exits non-zero when there is no CUDA device.
2. Builds every kernel library from ``tacotron_multispeaker_torch/csrc``
   with nvcc (in parallel) and prints the build seconds and ptxas register,
   shared memory and spill lines.
3. Holds each kernel against its plain PyTorch version on the card at the
   serving, training, one-direction GRU and sharded paths' shapes, in float32 and bfloat16, every
   output by name, and times kernel, plain version and, where one PyTorch
   call computes the same function, that call (``library_ms``).  The
   decoder loop (kernel 5) is held at every thread-block-cluster size the
   card takes, and its per-step latency bound is computed from latencies
   probed on the card (``csrc/latency_probe.cu``).  The teacher-forced
   forward (kernel 6) is held likewise at every cluster size, at S=12, 20
   and 200, ragged and at D=384, timed at B=32 and B=1 with a sweep over
   C and its per-step latency bound from the same probe.  The teacher-forced
   backward (kernel 8) is held whole and its prologue launch alone, the two
   launches timed apart, its scan's per-step latency bound from the same
   probe.  The GRU scan backward (kernel 4, two directions; kernel 2, one)
   likewise: its prologue launch alone and the whole backward at T=192 and
   1000, F=128 and 32, the two launches timed apart, its scan's per-step
   latency bound from a shared-memory probe on the card.  The GRU scan
   forward (kernel 3, two directions; kernel 1, one) on both its routes
   (tensor cores for bf16 up to F=128, the FMA kernel for f32 and wider
   bf16) at B=1, 3, 8, 9, 32, T=1, 192, 1000 and F=128, 32, 72, 100, 136,
   timed on both routes in the same call, its per-step latency bound from
   the barrier and mma.sync chain probes.  The attention step and its
   per-shard partial (kernels 9 and 10, one cluster kernel) are held at the
   plan's cluster size and every size the card takes, on both routes
   (staged; direct for rows that are not 16-byte multiples), each launch
   repeated bit for bit (a race shows as a launch that differs), and timed
   at each C by the device time of a launch beside its latency bound.  The
   overlap-add (kernel 12) is held in both modes (prewindowed support
   frames, windowed full frames) at both widths, each mode timed at B=32
   and B=1 (a launch's device time) beside ``fold`` + a division, and the
   ``serve_location`` Griffin-Lim is held against its plain route.  The
   weight-gradient reduction (``csrc/wgrad.cu``) is held at the three
   backward launches of the train step (the teacher's 11 products, the
   BiGRU's 4, the GRU's 2) in f32 (its FMA route) and bf16 (the tensor
   cores, and the FMA route forced), each launch repeated bit for bit and
   its route counted, and timed beside ``torch.mm`` of the rounded factors
   (``library_ms``).  Kernel 7 (``csrc/dkeys.cu``) is held on inputs of
   randn scale and on keys and q uniform in [-40, 40] (its guarded
   elements), each launch repeated bit for bit.
4. Checks ``generate`` at full-width ``multispeaker_vctk``, dropout off: in
   float32 on the card against the plain path on the CPU (the default and
   the location-attention path), and in bfloat16 (the serving precision)
   on the card with the kernels against the same run with their plain
   versions swapped in (all three serving paths).
5. Serves through ``Synthesizer`` at full-width ``multispeaker_vctk`` with
   random weights from a seed, on each serving path of ``PATHS``: ``serve``
   (the defaults), ``serve_pallas`` (``parallel.use_pallas``: the conv-bank
   and Griffin-Lim kernels) and ``serve_location`` (location attention
   through the per-step decode with the attention-step kernel, exact
   Griffin-Lim with the overlap-add kernel): ``warmup()``, B=1
   ``synthesize()`` requests over both input buckets and several speakers,
   one B=32 batch of 200 decoder steps, each with its exact launches of
   every kernel (``path_launches``).  ``serve_tacotron2``: full-width
   ``tacotron2_sv2tts`` B=32 batches at buckets 96 and 192, 1,000 steps
   replayed from CUDA graphs, each kernel's launches counted through the
   replays; the captured decode held bit for bit against its eager step
   loop, and each step's attention kernel against the plain attention.
6. Where the time goes: a profile of a B=1 request and the B=32 batch on
   each serving path and of one full-width train step (device busy, idle
   share, top kernels).
7. Trains: one full-width ``multispeaker_vctk`` step in float32 (dropout
   off, B=2, short lengths) on the card against the same step on the CPU
   plain path (loss, grad norm, every gradient leaf, the updated running
   statistics); a few bf16 steps with the kernels against the same run
   with their plain versions swapped in; then five timed steps at full
   width (B=32, L=192, T=1000, bf16) with the launches of every kernel
   checked per step (every weight-gradient launch on the tensor cores).  The ``gru`` path: ``GRU(use_pallas=True)`` (the
   one-direction scan, kernels 1 and 2) at full CBHG width, forward and
   backward, both directions, against its plain versions, launches exact.
   The ``train_loop`` path: a synthetic corpus written by the port's
   ``make_corpus`` and featurised by its ``preprocess`` on the card (PCM
   kept), then ``train_loop.train`` at full-width ``multispeaker_vctk``
   (B=32): 12 steps with a checkpoint and eval at step 10, a resume to 14,
   a timed and profiled window on the Feeder and again on the grain loader
   with 4 worker processes for f32, bf16 and PCM targets; the native batch
   assembler asserted and held bit for bit against the numpy path, the
   input pipeline's parts timed apart (``materialize``, the loader at 0
   and 4 workers, the copy from pinned and pageable memory, fed steps), the
   targets derived on the card held against the offline features, and two
   ``python -m tacotron_multispeaker_torch.train`` runs, the second with
   ``--pipeline grain --pipeline_workers 2``; the first loop run with
   ``TACOTRON_TB=1``, its event files read back where tensorboard imports.
   Phase 7c: ``entry_points`` (``validate`` and ``eval`` in this process on
   that corpus and its step-14 checkpoint, launches exact; then ``python -m
   tacotron_multispeaker_torch.validate``, ``.eval`` and ``.demo_server
   --port 0`` as subprocesses, the server asked over a socket, each one's
   wall time); ``train_location`` (the f32 location-attention step on the
   card against the CPU's, three timed full-width bf16 steps, launches
   exact: kernels 3, 4 and the weight gradients, none of 6, 7, 8);
   ``adam_bf16`` (the f32 step with ``train.adam_mu_dtype=bfloat16``
   against the CPU's, bf16 first moments); ``gl_methods`` (Griffin-Lim
   ``fft`` and ``ct_*`` at B=32 F=1000 n_fft=2048, the overlap-add kernel's
   route against the plain route, launches counted, card against CPU in
   f32, each method's ms).
8. Sharded synthesis (``Synthesizer.make_sharded_synth``): four ranks
   spawned on the one card (gloo over a ``file://`` store).  An f32
   ``shard_seq`` decode of 20 steps against the single-process unsharded
   port on the card, then full-width ``pod_synthesis`` (2048 x 128 speaker
   table, 400 steps, bucket 192) on each path of ``SHARD_PATHS``:
   ``shard_dp`` (mesh (4, 1), B=32), ``shard_hybrid`` ((1, 4), B=32) and
   ``shard_seq`` ((1, 4), ``hybrid_model_axis=false``, B=8: the sequence-
   sharded decode with kernel 10), each rank's launches checked per
   request, request ms and audio-s/s, a profile on rank 0.

Each path (three serving paths, ``serve_tacotron2``, training, ``gru``, ``train_loop``, the
paths of phase 7c, three sharded paths) is driven
with every launch count set to 0 just before it and read just after (on
each rank for the sharded paths).  Prints the per-request
and per-step times, one ``kernels`` JSON line (each kernel's time, plain
time, library time, bound, launches on each path's run), and as its last
line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor and
# plain f32 FLOP/s.  bound_ms is the larger of bytes/HBM and ops/peak.
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def _bound_ms(bytes_, bf16_flops=0.0, f32_flops=0.0):
    t_bytes = bytes_ / HBM_BYTES_S
    t_ops = bf16_flops / BF16_FLOPS + f32_flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _counters():
    """kernel name -> (module, attribute) of its launch count."""
    from tacotron_multispeaker_torch.ops import (attention_step, conv_bank, decoder_loop,
                                                 gl_iteration, gru_scan, overlap_add,
                                                 teacher_decoder, wgrad)
    return {"bigru_scan": (gru_scan, "launches"),
            "bigru_scan_fma": (gru_scan, "fma_launches"),
            "decoder_loop": (decoder_loop, "launches"),
            "bigru_scan_bwd": (gru_scan, "bwd_launches"),
            "bigru_scan_bwd_remat": (gru_scan, "bwd_remat_launches"),
            "gru_scan": (gru_scan, "gru_launches"),
            "gru_scan_fma": (gru_scan, "gru_fma_launches"),
            "gru_scan_bwd": (gru_scan, "gru_bwd_launches"),
            "gru_scan_bwd_remat": (gru_scan, "gru_bwd_remat_launches"),
            "teacher_decoder_fwd": (teacher_decoder, "fwd_launches"),
            "dkeys": (teacher_decoder, "dkeys_launches"),
            "teacher_decoder_bwd": (teacher_decoder, "bwd_launches"),
            "teacher_decoder_bwd_remat": (teacher_decoder, "bwd_remat_launches"),
            "wgrad": (wgrad, "launches"),
            "wgrad_fma": (wgrad, "fma_launches"),
            "conv_bank": (conv_bank, "launches"),
            "attention_step": (attention_step, "launches"),
            "attention_step_partial": (attention_step, "partial_launches"),
            "attention_step_direct": (attention_step, "direct_launches"),
            "attention_step_partial_direct": (attention_step, "partial_direct_launches"),
            "overlap_add": (overlap_add, "launches"),
            "gl_iteration": (gl_iteration, "launches")}


def reset_counts() -> None:
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in _counters().items()}


def _rel_err(a, b) -> float:
    """max |a - b| relative to max(|b|, 1e-6)."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1e-6)).item()


def phase_card():
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from tacotron_multispeaker_torch.ops import KERNELS, cuda_build
    t0 = time.perf_counter()
    info = cuda_build.build_all((*KERNELS, "latency_probe"))
    log(f"[build] {len(info)} kernel libraries in {time.perf_counter() - t0:.2f} s "
        f"(parallel nvcc)")
    for name, rec in info.items():
        log(f"[build] {name}: {rec['seconds']:.2f} s -> {os.path.relpath(rec['path'], REPO)}")
        for line in rec["ptxas"].splitlines():
            if (any(w in line for w in ("registers", "spill", "Compiling entry", "smem"))
                    and "C7519" not in line):
                log(f"[ptxas] {name}: {line.strip()}")
        if "C7519" in rec["ptxas"]:
            log(f"[ptxas] {name}: {rec['ptxas'].count('C7519')} notes C7519 (warpgroup.arrive "
                f"injected by ptxas around wgmma accumulators)")


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def _bigru_inputs(T, B, F, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s, sc=1.0: (torch.randn(*s, generator=g, device="cuda") * sc)
    return (rn(T, 2, B, 2 * F, sc=0.5).to(dtype), rn(T, 2, B, F, sc=0.5).to(dtype),
            rn(2, F, 2 * F, sc=0.08).to(dtype), rn(2, F, F, sc=0.08).to(dtype),
            rn(2, B, F, sc=0.1))


def _bigru_bound_ms(T, B, F, esize):
    bytes_ = (T * 2 * B * (2 * F + F + F) * esize + 2 * 3 * F * F * esize
              + 2 * B * F * 4)
    return _bound_ms(bytes_, bf16_flops=T * 2 * B * 2 * 3 * F * F)


def _gru_inputs(T, B, F, dtype, seed):
    """xg, xc, whg, whc, h0 of the one-direction scan (time-major [T, B, .])."""
    return tuple((a[:, 0] if a.dim() == 4 else a[0]).contiguous()
                 for a in _bigru_inputs(T, B, F, dtype, seed))


def _fwd_cases():
    """(T, B, F) of the forward's checks.  B = 1, 3, 8, 9, 32: one row, a
    partial block of the tensor-core route's 4 rows, two full blocks, one
    row past them, eight blocks.  At the CBHG width F=128 every T of 1, 192
    and 1000; at tiny's F=32, F=72 (not a multiple of 16: zero tail tiles),
    F=100 (not a multiple of 8: the FMA route in bf16 too) and F=136 (past
    the tensor-core register budget: the FMA route) T = 1 and 192."""
    return ([(T, B, 128) for T in (1, 192, 1000) for B in (1, 3, 8, 9, 32)]
            + [(T, B, F) for F in (32, 72, 100, 136) for T in (1, 192)
               for B in (1, 3, 8, 9, 32)])


def _mma_probe():
    """One dependent mma.sync.m16n8k16 bf16 product on this card (us;
    ``csrc/latency_probe.cu probe_mma_chain``, CUDA events over a chain of
    20,000)."""
    import ctypes
    import torch
    from tacotron_multispeaker_torch.ops import cuda_build
    lib = cuda_build.library("latency_probe")
    lib.probe_mma_chain.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream
    sink = torch.zeros(4, device="cuda")
    iters = 20000
    call = lambda: lib.probe_mma_chain(iters, sink.data_ptr(), stream)  # noqa: E731
    call()
    torch.cuda.synchronize()
    return cuda_time_ms(lambda: cuda_build.check(call(), "mma probe"), reps=3) * 1e3 / iters


# independent accumulator chains of each of a tensor-core step's two
# dependent products (r's, then the candidate's; TC_KS of csrc/bigru_scan.cu)
FWD_CHAINS = 4


def _gru_fwd_latency_bound_ms(T, B, F, dirs, probe, mma_us, n_sm):
    """The per-step latency bound of csrc/bigru_scan.cu's tensor-core route:
    two barriers a step, each a barrier plus a shared-memory round trip
    (``probe_block_exchange`` at the block's 32 ceil(F/16) threads), plus
    the step's dependent mma.sync chain, ceil(F/16) / FWD_CHAINS products
    of each of its two products (``probe_mma_chain``); one block a direction and
    ``_MMA_ROWS`` rows, blocks beyond the SMs in later waves."""
    import math
    from tacotron_multispeaker_torch.ops import gru_scan as gs
    nk = -(-F // 16)
    chain = 2 * -(-nk // FWD_CHAINS)
    step_us = 2 * probe["exchange_us"] + chain * mma_us
    return T * math.ceil(dirs * -(-B // gs._MMA_ROWS) / n_sm) * step_us * 1e-3


def _gru_fwd_phase(dirs):
    """Kernel 3 (dirs=2: ``bigru_scan``) or kernel 1 (dirs=1: ``gru_scan``),
    csrc/bigru_scan.cu on both routes.  Every case of ``_fwd_cases`` in f32
    and bf16 through the public wrapper (the route ``fwd_route`` picks,
    launches counted on that route's counter), and in bf16 on the tensor
    cores also the FMA route forced, against the plain version.  Then, at
    F=128 bf16 (kernel 3: B=32 at T=192 and 1000, B=1 at T=96, 192 and
    1000; kernel 1: B=32 T=1000): each route's call ms and its launch's
    device ms, the per-step latency bound (probed on this card) and its
    share; the plain version and the byte bound at T=1000 B=32."""
    import torch
    from tacotron_multispeaker_torch.ops import gru_scan as gs
    tag = "bigru_scan" if dirs == 2 else "gru_scan"
    fwd, ref_fn, inputs = ((gs.bigru_scan, gs.bigru_scan_reference, _bigru_inputs) if dirs == 2
                           else (gs.gru_scan, gs.gru_scan_reference, _gru_inputs))
    counters = {"mma": "launches" if dirs == 2 else "gru_launches",
                "fma": "fma_launches" if dirs == 2 else "gru_fma_launches"}
    count = lambda: {r: getattr(gs, c) for r, c in counters.items()}  # noqa: E731
    # f32: the same arithmetic in another sum order; bf16: a sum landing
    # on a rounding boundary flips one bf16 ulp of a product input, which
    # the recurrence carries
    tol = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
    worst = {}
    for F in sorted({F for _, _, F in _fwd_cases()}):
        for dtype in (torch.float32, torch.bfloat16):
            route = gs.fwd_route(F, dtype)
            errs = {route: 0.0, **({"fma": 0.0} if route == "mma" else {})}
            cases = [(T, B) for T, B, f in _fwd_cases() if f == F]
            for T, B in cases:
                args = inputs(T, B, F, dtype, seed=T + B + F + dirs)
                ref = ref_fn(*args)
                before = count()
                ys = fwd(*args)
                got = {r: n - before[r] for r, n in count().items()}
                if got != {r: int(r == route) for r in counters}:
                    raise AssertionError(f"{tag} T={T} B={B} F={F} {dtype}: launches {got}, "
                                         f"expected one on the {route} route")
                outs = {route: ys}
                if route == "mma":
                    outs["fma"] = gs._fwd_kernel(*args, route="fma")
                torch.cuda.synchronize()
                for r, y in outs.items():
                    if y.dtype != dtype or y.shape != ref.shape:
                        raise AssertionError(f"{tag} {r} route: ys {y.dtype} {tuple(y.shape)}")
                    errs[r] = max(errs[r], (y.float() - ref.float()).abs().max().item())
            label = ", ".join(f"{r} {e:.3e}" for r, e in errs.items())
            log(f"[{tag}] F={F} {str(dtype)[6:]} (route {route}), {len(cases)} cases (T "
                f"{sorted({T for T, _ in cases})} x B {sorted({B for _, B in cases})}): "
                f"max|kernel-plain| by route {label} (tol {tol[dtype]:.0e})")
            if not all(e <= tol[dtype] for e in errs.values()):
                raise AssertionError(f"{tag} disagrees with its plain version: F={F} "
                                     f"{dtype} {errs}")
            for r, e in errs.items():
                worst[r] = max(worst.get(r, 0.0), e)
    # timing at F=128 bf16: the post-net's T=1000 frames and the encoder's
    # 192 of the B=32 batch and train step, a B=1 request's encoder (96 or
    # 192) and post-net
    F, dtype = 128, torch.bfloat16
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    nk = -(-F // 16)
    probe = _smem_probe(32 * nk)
    mma_us = _mma_probe()
    rec = {}
    shapes = ((32, 192), (32, 1000), (1, 96), (1, 192), (1, 1000)) if dirs == 2 else ((32, 1000),)
    for B, T in shapes:
        args = inputs(T, B, F, dtype, seed=7 if dirs == 2 else 9)
        t = {}
        for route in ("mma", "fma"):
            run = lambda: gs._fwd_kernel(*args, route=route)  # noqa: E731
            t[route] = (cuda_time_ms(run, reps=10), _launch_device_ms(run, "bigru_scan"))
        lat_ms = _gru_fwd_latency_bound_ms(T, B, F, dirs, probe, mma_us, n_sm)
        log(f"[{tag}] T={T} B={B} F={F} bf16: tensor cores {t['mma'][0]:.4f} ms (device "
            f"{t['mma'][1]:.4f}), FMA route {t['fma'][0]:.4f} ms (device {t['fma'][1]:.4f}) in "
            f"the same call; latency bound {lat_ms:.4f} ms "
            f"({100 * lat_ms / t['mma'][1]:.1f} % "
            f"of the tensor-core launch's device time reached)")
        rec[(B, T)] = (t, lat_ms)
    log(f"[{tag}] probe: barrier + shared-memory exchange of {probe['threads']} threads "
        f"{probe['exchange_us']:.4f} us, one dependent mma.sync.m16n8k16 {mma_us:.4f} us; a "
        f"tensor-core step's bound: 2 exchanges + "
        f"{2 * -(-nk // FWD_CHAINS)} dependent products")
    T, B = 1000, 32
    args = inputs(T, B, F, dtype, seed=7 if dirs == 2 else 9)
    plain_ms = cuda_time_ms(lambda: ref_fn(*args), reps=2)
    if dirs == 2:
        bound_ms, bound_by = _bigru_bound_ms(T, B, F, 2)
    else:
        bound_ms, bound_by = _bound_ms(_nbytes(*args) + T * B * F * 2,
                                       bf16_flops=T * B * 2 * 3 * F * F)
    t, lat_ms = rec[(B, T)]
    log(f"[{tag}] T={T} B={B} F={F} bf16: kernel {t['mma'][0]:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    out = {"max_abs_err": max(worst.values()), "ms": t["mma"][0], "ms_device": t["mma"][1],
           "ms_fma": t["fma"][0], "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "bound_latency_ms": lat_ms,
           "latency_share": lat_ms / t["mma"][1],
           "shape": f"T={T} B={B} F={F} bf16",
           "design": "bf16 with F a multiple of 8 up to 128: tensor cores (mma.sync "
                     "m16n8k16, weights resident in registers, 4 batch rows a block on the "
                     "product's even columns); f32 and other bf16 widths: the FMA kernel of "
                     "the first design",
           "error": "max |kernel - plain| over T=1, 192, 1000 x B=1, 3, 8, 9, 32 at F=128 "
                    "and T=1, 192 x the same B at F=32, 72, 100, 136, f32 and bf16, both "
                    "routes where bf16 takes the tensor cores (by route: "
                    + ", ".join(f"{r} {e:.3e}" for r, e in worst.items()) + ")"}
    if dirs == 2:
        out["ms_b1"] = rec[(1, 1000)][0]["mma"][0]
    return out


def phase_bigru():
    """Kernel 3 (csrc/bigru_scan.cu, two directions, see ``_gru_fwd_phase``)."""
    return _gru_fwd_phase(2)


def phase_gru_scan():
    """Kernel 1 (the one-direction launcher of csrc/bigru_scan.cu, see
    ``_gru_fwd_phase``)."""
    return _gru_fwd_phase(1)


def phase_gru_scan_bwd():
    """Kernel 2 (the one-direction launchers of csrc/bigru_scan_bwd.cu, see
    ``_gru_bwd_phase``).  Returns (its record, its prologue's record, (the
    wgrad error, the wgrad launch's record))."""
    return _gru_bwd_phase(1)


# per forward + backward, by compute dtype (f32 takes the forward's and the
# weight gradients' FMA routes, bf16 both tensor-core routes)
GRU_LAUNCHES = {dt: {fwd: 1, "gru_scan_bwd": 1, "gru_scan_bwd_remat": 1, wg: 1}
                for dt, fwd, wg in (("float32", "gru_scan_fma", "wgrad_fma"),
                                    ("bfloat16", "gru_scan", "wgrad"))}


def phase_gru():
    """The ``gru`` path: ``GRU(use_pallas=True)`` at the full CBHG width
    (in 128, F=128, B=32, T=1000, ragged lengths) on the card, forward and
    backward through autograd, both directions, f32 and bf16, against the
    same module with the plain versions swapped in; each run's launches
    counted exactly.  Returns the path's launches."""
    import torch
    from tacotron_multispeaker_torch.models.modules import GRU
    B, T, D, F = 32, 1000, 128, 128
    g = torch.Generator(device="cuda").manual_seed(61)
    xs = torch.randn(B, T, D, generator=g, device="cuda")
    lengths = torch.randint(T // 4, T + 1, (B,), generator=g, device="cuda")
    lengths[0] = T
    w = torch.randn(B, T, F, generator=g, device="cuda")
    # relative to max(peak, 1): f32 sum order (the weight gradients sum
    # T*B rows) -> 1e-4; bf16 flipped roundings carried by the recurrence
    # and into the input projection's gradient -> 5e-2
    tol = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
    err = lambda a, b: ((a.float() - b.float()).abs().max()
                        / b.float().abs().max().clamp(min=1.0)).item()
    reset_counts()
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator().manual_seed(62)
        module = GRU(D, F, dtype, use_pallas=True)
        with torch.no_grad():
            for p in module.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * D ** -0.5)
        module.cuda()
        for reverse in (False, True):
            outs = []
            for plain in (False, True):
                module.zero_grad()
                before = read_counts()
                with plain_kernels() if plain else contextlib.nullcontext():
                    ys = module(xs, lengths, reverse=reverse)
                    (ys.float() * w).sum().backward()
                torch.cuda.synchronize()
                got = {k: v for k, v in _delta(before).items() if v}
                want = {} if plain else GRU_LAUNCHES[str(dtype)[6:]]
                if got != want:
                    raise AssertionError(f"gru path {str(dtype)[6:]} reverse={reverse} "
                                         f"plain={plain}: launches {got}, expected {want}")
                outs.append([ys.detach()] + [p.grad.detach().clone()
                                             for p in module.parameters()])
            errs = [err(a, b) for a, b in zip(*outs)]
            log(f"[gru] GRU(use_pallas=True) B={B} T={T} D={D} F={F} {str(dtype)[6:]} "
                f"reverse={reverse}, forward + backward, kernels vs plain versions: ys "
                f"{errs[0]:.3e}, parameter gradients max {max(errs[1:]):.3e} (tol "
                f"{tol[dtype]:.0e}, relative to max(peak, 1))")
            if not (torch.isfinite(outs[0][0]).all() and max(errs) <= tol[dtype]):
                raise AssertionError(f"GRU(use_pallas=True) disagrees with its plain version")
    total = read_counts()
    step = lambda: (module(xs, lengths, reverse=True).float() * w).sum().backward()
    ms = cuda_time_ms(step, reps=5)
    log(f"[gru] B={B} T={T} bf16 forward + backward: {ms:.3f} ms; launches over the path "
        f"{json.dumps(total)}")
    return total


def _decoder_case(B, L, n_steps, dtype, scale, seed, M=80, P1=256, P2=128, H=256,
                  A=256, D=320, r=5, n_layers=2):
    import torch
    from tacotron_multispeaker_torch.ops.decoder_loop import DecoderWeights
    g = torch.Generator(device="cuda").manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=g, device="cuda") * scale
    w = DecoderWeights(
        w1=f(M, P1), b1=f(P1), w2=f(P1, P2), b2=f(P2),
        a_xg_pn=f(P2, 2 * H), a_xg_ctx=f(D, 2 * H), a_bg=f(2 * H) + 1.0,
        a_xc_pn=f(P2, H), a_xc_ctx=f(D, H), a_bc=f(H),
        a_hg=f(H, 2 * H), a_hc=f(H, H), wq=f(H, A), v=f(A) * 4.0,
        d_h=f(H, H), d_ctx=f(D, H), d_b=f(H),
        l_xg=tuple(f(H, 2 * H) for _ in range(n_layers)),
        l_bg=tuple(f(2 * H) + 1.0 for _ in range(n_layers)),
        l_xc=tuple(f(H, H) for _ in range(n_layers)),
        l_bc=tuple(f(H) for _ in range(n_layers)),
        l_hg=tuple(f(H, 2 * H) for _ in range(n_layers)),
        l_hc=tuple(f(H, H) for _ in range(n_layers)),
        wf=f(H, r * M), bf=f(r * M)).cast(dtype)
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    keys = (rn(B, L, A) * 0.3).to(dtype)
    memory = rn(B, L, D).to(dtype)
    lengths = torch.randint(1, L + 1, (B,), generator=g, device="cuda")
    lengths[0] = L
    mask = torch.arange(L, device="cuda")[None, :] < lengths[:, None]
    keep = 0.5
    dm1 = (torch.rand(n_steps, B, P1, generator=g, device="cuda") < keep).float() / keep
    dm2 = (torch.rand(n_steps, B, P2, generator=g, device="cuda") < keep).float() / keep
    attn_h0 = rn(B, H) * 0.1
    dec_h0 = rn(n_layers, B, H) * 0.1
    return (w, keys, memory, mask, dm1, dm2, attn_h0, dec_h0, n_steps, M)


def _decoder_dims(args):
    """decoder_loop's launch dims of a ``_decoder_case``: B, L, A, D, H, M,
    P1, P2, RM, n_layers, n_steps."""
    w, keys, memory, mask, dm1, dm2, attn_h0, dec_h0, S, M = args
    B, L, A = keys.shape
    return (B, L, A, memory.shape[-1], w.a_hc.shape[0], M, w.w1.shape[1], w.w2.shape[1],
            w.wf.shape[1], len(w.l_xg), S)


def _decoder_bound_ms(args):
    w, keys, memory, mask, dm1, dm2, attn_h0, dec_h0, S, M = args
    B, L, A = keys.shape
    D = memory.shape[-1]
    tensors = [t for v in w for t in (v if isinstance(v, tuple) else (v,))]
    mac_per_step = sum(t.numel() for t in tensors if t.dim() == 2) + L * D
    RM = w.wf.shape[1]
    bytes_ = (_nbytes(*tensors, keys, memory, mask, dm1, dm2, attn_h0, dec_h0)
              + S * B * (RM + L) * 4)
    # matrix-vector products in the compute type, energies in f32
    # (add, tanh, multiply-add per key element; exp and normalise per position)
    return _bound_ms(bytes_, bf16_flops=S * B * 2 * mac_per_step,
                     f32_flops=S * B * (3 * L * A + 4 * L))


def _latency_probe(sizes):
    """Latencies behind kernel 5's per-step bound, measured on this card
    (``csrc/latency_probe.cu``, CUDA events over many dependent operations):
    one L2 round trip (us), one DSMEM store + cluster barrier for each
    cluster size in ``sizes`` (us), one SM's L2 bandwidth and the whole
    card's (bytes/s, from an L2-resident 4 MB buffer)."""
    import ctypes
    import numpy as np
    import torch
    from tacotron_multispeaker_torch.ops import cuda_build
    lib = cuda_build.library("latency_probe")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.probe_l2_chase.argtypes = [vp, ci, vp, vp]
    lib.probe_cluster_sync.argtypes = [ci, ci, vp, vp]
    lib.probe_l2_stream.argtypes = [vp, ctypes.c_size_t, ci, ci, vp, vp]
    stream = torch.cuda.current_stream().cuda_stream
    sink = torch.zeros(4, device="cuda")
    n = 1 << 20                                   # 4 MB of int32: in L2, not L1
    perm = np.random.RandomState(0).permutation(n)
    nxt = np.empty(n, np.int32)
    nxt[perm] = np.roll(perm, -1)
    nxt = torch.from_numpy(nxt).cuda()
    nxt.sum().item()                              # brings the chain into L2

    def timed(call, count):
        call()
        torch.cuda.synchronize()
        ms = cuda_time_ms(lambda: cuda_build.check(call(), "latency probe"), reps=3)
        return ms * 1e3 / count

    hops = 20000
    rt_us = timed(lambda: lib.probe_l2_chase(nxt.data_ptr(), hops, sink.data_ptr(), stream),
                  hops)
    iters = 20000
    bar_us = {C: timed(lambda C=C: lib.probe_cluster_sync(C, iters, sink.data_ptr(), stream),
                       iters) for C in sizes}
    buf = torch.ones(1 << 20, device="cuda")      # 4 MB
    reps = 8
    n16 = buf.numel() * 4 // 16
    sm_s = timed(lambda: lib.probe_l2_stream(buf.data_ptr(), n16, reps, 1, sink.data_ptr(),
                                             stream), 1) * 1e-6
    card_s = timed(lambda: lib.probe_l2_stream(buf.data_ptr(), n16, reps, 132,
                                               sink.data_ptr(), stream), 1) * 1e-6
    nbytes = buf.numel() * 4 * reps
    return {"l2_round_trip_us": rt_us, "cluster_barrier_us": bar_us,
            "sm_l2_bytes_s": nbytes / sm_s, "card_l2_bytes_s": 132 * nbytes / card_s}


def _cluster_latency_bound_ms(S, B, phases, step_bytes, C, coresident, probe):
    """The per-step latency bound of a kernel that runs a batch row's step on
    a cluster of C CTAs: each of ``phases`` dependent phases waits one L2
    round trip and one DSMEM exchange + cluster barrier, and a CTA streams
    its 1/C of the step's ``step_bytes`` through its SM's L2 port (or all
    running rows share the card's L2 bandwidth, whichever is slower); rows
    beyond the co-resident clusters run in later waves."""
    import math
    running = min(B, coresident)
    stream_s = max(step_bytes / C / probe["sm_l2_bytes_s"],
                   running * step_bytes / probe["card_l2_bytes_s"])
    step_s = (phases * (probe["l2_round_trip_us"] + probe["cluster_barrier_us"][C]) * 1e-6
              + stream_s)
    return S * math.ceil(B / coresident) * step_s * 1e3


def _decoder_latency_bound_ms(args, C, coresident, probe):
    """Kernel 5's per-step latency bound (``_cluster_latency_bound_ms``):
    8 + 2N phases; a step reads every weight matrix and one row's keys and
    memory."""
    w, keys, memory, mask, dm1, dm2, attn_h0, dec_h0, S, M = args
    mats = [t for v in w for t in (v if isinstance(v, tuple) else (v,)) if t.dim() == 2]
    step_bytes = _nbytes(*mats) + (keys[0].numel() + memory[0].numel()) * keys.element_size()
    return _cluster_latency_bound_ms(S, keys.shape[0], 8 + 2 * len(w.l_xg), step_bytes, C,
                                     coresident, probe)


def _teacher_fwd_latency_bound_ms(w, keys, memory, S, C, coresident, probe):
    """Kernel 6's per-step latency bound (``_cluster_latency_bound_ms``):
    5 + 2N phases; a step reads every weight matrix and one row's keys and
    memory."""
    mats = [t for t in w.flat() if t.dim() == 2]
    step_bytes = _nbytes(*mats) + (keys[0].numel() + memory[0].numel()) * keys.element_size()
    return _cluster_latency_bound_ms(S, keys.shape[0], 5 + 2 * len(w.w_r), step_bytes, C,
                                     coresident, probe)


def _teacher_bwd_phases(n_layers, hoisted=True):
    """Dependent phases of a step of kernel 8's reverse scan: per layer two
    products (da_c @ hc^T; dg @ [w_r^T | (hg^T; 0)]), then [dha_loc |
    dctx_x], dp, the softmax sum, dq, dq @ wq^T and the attention GRU's two;
    before the prologue took the carry-free products, six a layer and 14."""
    return 2 * n_layers + 7 if hoisted else 6 * n_layers + 14


def _teacher_bwd_step_bytes(H, A, D, L, N, esize, hoisted=True):
    """Weight, key and memory bytes one batch row's step of kernel 8's scan
    reads (each product's whole weight matrix, once)."""
    if hoisted:
        elems = N * 7 * H * H + H * (H + D) + A * H + H * H + 3 * H * (H + D) + L * D + L * A
    else:
        elems = N * 12 * H * H + 7 * H * H + 8 * H * D + 2 * H * A + 3 * L * D + L * A
    return elems * esize


def _teacher_bwd_latency_bound_ms(S, B, phases, step_bytes, probe, n_sm):
    """Kernel 8's scan's per-step latency bound: each of ``phases``
    dependent phases waits one L2 round trip, and a row streams
    ``step_bytes`` through its SM's L2 port (or all running rows share the
    card's L2 bandwidth, whichever is slower); one block a row, rows beyond
    the SMs in later waves."""
    import math
    running = min(B, n_sm)
    stream_s = max(step_bytes / probe["sm_l2_bytes_s"],
                   running * step_bytes / probe["card_l2_bytes_s"])
    step_s = phases * probe["l2_round_trip_us"] * 1e-6 + stream_s
    return S * math.ceil(B / n_sm) * step_s * 1e3


def phase_decoder():
    import torch
    from tacotron_multispeaker_torch.ops import decoder_loop as dl
    # (frames, alignments).  f32: both sides do the same f32 arithmetic in
    # another summation order.  bf16: both round the same matmul inputs, but a
    # sum that lands on a rounding boundary in one order and not the other
    # flips one bf16 ulp (2^-8 relative) of an intermediate, which the
    # recurrence carries on; frames are O(1), hence 5e-2.  Energies, softmax
    # and alignments stay f32 on both sides, so a flip reaches them only
    # through the carry: 1e-3 is a tenth of a typical weight at L=192
    # (~1/L = 5e-3) and fails a broken bf16 key load or softmax.
    tol = {torch.float32: (1e-3, 1e-4), torch.bfloat16: (5e-2, 1e-3)}
    worst = 0.0
    # B=1; ragged B=3 L=13 (some CTAs hold no position at C=16); the B=32
    # batch at D=320 (multispeaker_vctk) and D=384 (pod_synthesis); each at
    # the plan's C and at every C forced through the launcher
    cases = [(1, 96, 320), (3, 13, 320), (32, 192, 320), (32, 192, 384)]
    for dtype in (torch.float32, torch.bfloat16):
        for ci, (B, L, D) in enumerate(cases):
            args = _decoder_case(B, L, 8, dtype, scale=0.05, seed=3 + ci, D=D)
            fr, ar = dl.decoder_loop_reference(*args)
            vec = 16 // args[1].element_size()
            counts = dl.cluster_counts(_decoder_dims(args), int(dtype == torch.bfloat16),
                                       args[1].device)
            runs = [("plan", lambda: dl.decoder_loop(*args))]
            runs += [(f"C={C}", lambda C=C: dl._decoder_loop_cuda(*args, cluster=C))
                     for C in dl.CLUSTER_SIZES if counts[C] > 0]
            for label, run in runs:
                fk, ak = run()
                torch.cuda.synchronize()
                ef = (fk - fr).abs().max().item()
                ea = (ak - ar).abs().max().item()
                tf, ta = tol[dtype]
                log(f"[decoder_loop] B={B} L={L} D={D} S=8 {str(dtype)[6:]} {label} "
                    f"(ran C={dl.last_plan[0]}): max|kernel-plain| frames {ef:.3e} "
                    f"(tol {tf:.0e}) align {ea:.3e} (tol {ta:.0e})")
                if not (ef <= tf and ea <= ta):
                    raise AssertionError(f"decoder_loop disagrees with its plain version "
                                         f"(B={B} L={L} D={D} {label}): {ef}, {ea}")
                worst = max(worst, ef, ea)
            log(f"[decoder_loop] B={B} L={L} D={D} {str(dtype)[6:]}: co-resident clusters "
                f"{counts}, plan C={dl.launch_plan(B, _decoder_dims(args)[4], vec, counts)}")
    probe = _latency_probe(dl.CLUSTER_SIZES)
    log(f"[decoder_loop] probe: L2 round trip {probe['l2_round_trip_us']:.3f} us, DSMEM store "
        f"+ cluster barrier {json.dumps({C: round(v, 3) for C, v in probe['cluster_barrier_us'].items()})} "
        f"us, one SM's L2 read {probe['sm_l2_bytes_s'] / 1e9:.1f} GB/s, the card's "
        f"{probe['card_l2_bytes_s'] / 1e9:.1f} GB/s")
    # timing (bf16): the serving paths' B=1 (L=96) and B=32 (L=192) shapes,
    # 200 steps, and pod_synthesis's (B=32 L=192 D=384, 400 steps); the
    # plan's C, then every C the card can hold, for the sweep
    timed = {}
    for label, (B, L, S, D) in (("B=1 L=96 S=200", (1, 96, 200, 320)),
                                ("B=32 L=192 S=200", (32, 192, 200, 320)),
                                ("B=32 L=192 S=400 D=384", (32, 192, 400, 384))):
        args = _decoder_case(B, L, S, torch.bfloat16, scale=0.05, seed=5 + B + S, D=D)
        ms = cuda_time_ms(lambda: dl.decoder_loop(*args), reps=5)
        C, coresident = dl.last_plan
        bound_ms, bound_by = _decoder_bound_ms(args)
        lat_ms = _decoder_latency_bound_ms(args, C, coresident, probe)
        sweep = {}
        if S == 200:
            counts = dl.cluster_counts(_decoder_dims(args), 1, args[1].device)
            for c in dl.CLUSTER_SIZES:
                if counts[c] > 0:
                    sweep[c] = round(cuda_time_ms(
                        lambda c=c: dl._decoder_loop_cuda(*args, cluster=c), reps=3), 3)
        log(f"[decoder_loop] {label} bf16: kernel {ms:.3f} ms at C={C} ({coresident} "
            f"clusters co-resident), bound {bound_ms:.4f} ms ({bound_by}), latency bound "
            f"{lat_ms:.3f} ms ({100 * lat_ms / ms:.1f} % of the kernel's time)"
            + (f"; by C: {json.dumps(sweep)} ms" if sweep else ""))
        timed[label] = (args, ms, C, bound_ms, bound_by, lat_ms)
    args, ms, C, bound_ms, bound_by, lat_ms = timed["B=32 L=192 S=200"]
    plain_ms = cuda_time_ms(lambda: dl.decoder_loop_reference(*args), reps=1)
    log(f"[decoder_loop] B=32 L=192 S=200 bf16: plain {plain_ms:.3f} ms")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_latency_ms": lat_ms,
            "cluster": C, "ms_b1": timed["B=1 L=96 S=200"][1],
            "ms_pod": timed["B=32 L=192 S=400 D=384"][1],
            "shape": "B=32 L=192 S=200 H=A=256 D=320 bf16"}


# --------------------------------------------------------------------------
# phase 3 (training kernels): backward kernels against their plain versions
# --------------------------------------------------------------------------

def _distinct_nbytes(*tensors):
    """Bytes of the distinct elements that the tensors view: views of one
    storage that overlap (a stream handed whole to one product and in column
    slices to others) count each element once."""
    import torch
    marks = {}
    for t in tensors:
        key = (t.untyped_storage().data_ptr(), t.element_size())
        if key not in marks:
            marks[key] = torch.zeros(t.untyped_storage().nbytes() // t.element_size(),
                                     dtype=torch.bool, device=t.device)
        marks[key].as_strided(t.shape, t.stride(), t.storage_offset()).fill_(True)
    return sum(int(m.sum()) * es for (_, es), m in marks.items())


def _wgrad_bound_ms(problems):
    """Each distinct factor element read once (``_distinct_nbytes``), each
    product and bias written once; the products' operations at bf16 peak."""
    bytes_ = _distinct_nbytes(*(t for a, g, _ in problems for t in (a, g))) + sum(
        a.shape[-1] * g.shape[-1] * 4 + (g.shape[-1] * 4 if b else 0) for a, g, b in problems)
    flops = sum(2 * a.shape[0] * a.shape[1] * a.shape[-1] * g.shape[-1] for a, g, _ in problems)
    return _bound_ms(bytes_, bf16_flops=flops)


def _wgrad_problems(kind, seed, dtype=None):
    """Random factors laid out as the main path's weight-gradient launches
    hand them to ``wgrad``: ``teacher``, the teacher backward's 11 products
    over S*B = 6400 rows (every factor f32, as kernels 6 and 8 write them;
    ``_weight_grad_problems``); ``bigru``, the BiGRU backward's 4 over
    T*B = 32000 rows (h_prev and r*h_prev [T, 2, B, F] in the compute
    dtype, the gate cotangents f32); ``gru``, the one-direction GRU's 2."""
    import torch
    from tacotron_multispeaker_torch.ops import teacher_decoder as td
    dtype = dtype or torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(seed)
    f = lambda *s, dt=torch.float32: torch.randn(*s, generator=g, device="cuda").to(dt)
    if kind == "teacher":
        S, B, H, A, D, N = 200, 32, 256, 256, 320, 2
        ha, hap = f(S, B, H), f(S, B, H)
        hdps = tuple(f(S, B, H) for _ in range(N))
        outs = (f(S, B, 2 * H), f(S, B, H))
        streams = (f(S, B, H), f(S, B, 4 * H), f(S, B, D), f(S, B, A), f(N, S, B, H),
                   f(N, S, B, H), f(N, S, B, 3 * H))
        return td._weight_grad_problems(ha, hap, hdps, outs, streams)
    T, B, F = 1000, 32, 128
    if kind == "bigru":
        hprev, dxg = f(T, 2, B, F, dt=dtype), f(T, 2, B, 2 * F)
        rh, dxc = f(T, 2, B, F, dt=dtype), f(T, 2, B, F)
        return ([(hprev[:, d], dxg[:, d], False) for d in range(2)]
                + [(rh[:, d], dxc[:, d], False) for d in range(2)])
    hprev, dxg, rh, dxc = f(T, B, F, dt=dtype), f(T, B, 2 * F), f(T, B, F, dt=dtype), f(T, B, F)
    return [(hprev, dxg, False), (rh, dxc, False)]


def _wgrad_library_ms(problems, cdt, f32=False):
    """One PyTorch call a product computing the same sums, summed over the
    launch's problems, on factors rounded to ``cdt`` beforehand (outside the
    timed window): cuBLAS ``torch.mm`` of the rounded factors with f32
    output (``out_dtype``; a bf16 x bf16 product is exact in f32, so this
    is the function up to summation order); with ``f32``, ``torch.mm`` of
    the rounded factors widened to f32 (TF32 off)."""
    import torch
    pairs = []
    for a, g, _ in problems:
        a2 = a.reshape(-1, a.shape[-1]).to(cdt)
        g2 = g.reshape(-1, g.shape[-1]).to(cdt)
        pairs.append((a2.float(), g2.float()) if f32 else (a2, g2))
    if f32:
        return cuda_time_ms(lambda: [torch.mm(x.t(), y) for x, y in pairs], reps=5)
    return cuda_time_ms(lambda: [torch.mm(x.t(), y, out_dtype=torch.float32)
                                 for x, y in pairs], reps=5)


def _time_wgrad(problems, dtype, label):
    """The weight-gradient launch of one backward at its main-path shape: the
    call's ms back to back (CUDA events), its kernels' device ms (profiler:
    the tile kernel and, with several row ranges, the partials' pass), the
    FMA route's device ms in the same call, the plain version, the library
    calls (``_wgrad_library_ms``) and the bound."""
    from tacotron_multispeaker_torch.ops import wgrad
    import torch
    run = lambda: wgrad.wgrad(problems, dtype)
    ms = cuda_time_ms(run, reps=5)
    p = wgrad.plan(problems, dtype, torch.cuda.get_device_properties(0).multi_processor_count)
    stems = ("wgrad_tc",) + (("wgrad_reduce",) if p.splits > 1 else ())
    split, _ = _device_split_ms(run, stems, reps=3, per_call=dict.fromkeys(stems, 1))
    fma = lambda: wgrad.wgrad(problems, dtype, fma=True)
    fma_split, _ = _device_split_ms(fma, ("wgrad_kernel",), reps=2, per_call={"wgrad_kernel": 1})
    plain_ms = cuda_time_ms(lambda: wgrad.wgrad_reference(problems, dtype), reps=2)
    lib = _wgrad_library_ms(problems, dtype)
    lib_f32 = _wgrad_library_ms(problems, dtype, f32=True)
    bound = _wgrad_bound_ms(problems)
    rec = {"ms": ms, "ms_device": sum(split.values()), "ms_device_parts": split,
           "ms_device_fma": sum(fma_split.values()), "plain_ms": plain_ms, "library_ms": lib,
           "library_f32_ms": lib_f32, "bound_ms": bound[0], "bound_by": bound[1],
           "splits": p.splits, "tiles": sum(tk * tn for tk, tn in p.tiles)}
    log(f"[wgrad] {label} {str(dtype)[6:]}: tensor cores {rec['tiles']} tiles x "
        f"{p.splits} row ranges, a call {ms:.4f} ms, device {rec['ms_device']:.4f} ms ("
        + " + ".join(f"{k} {v:.4f}" for k, v in split.items())
        + f"); the FMA route's device {rec['ms_device_fma']:.4f} ms; plain {plain_ms:.3f} ms; "
        f"library (torch.mm of the rounded factors, f32 out) {lib:.4f} ms, the same "
        f"widened to f32 {lib_f32:.4f} ms; bound {bound[0]:.4f} ms ({bound[1]})")
    return rec


def _check_wgrad(problems, label):
    """wgrad against its plain version on one backward's factors, rounding
    them to float32 (the FMA route) and to bfloat16 (the tensor cores, and
    the FMA route forced); returns the worst error.  Both sides multiply
    the same rounded factors exactly in f32 (a bf16 x bf16 product is exact
    there) and differ in summation order only (row ranges over blocks
    against cuBLAS without TF32): 1e-4 of each product's peak, 1e-5 of
    each bias's.  Each launch is repeated and the two must agree bit for
    bit (no atomics: a race or an order that changes shows here)."""
    import torch
    from tacotron_multispeaker_torch.ops import wgrad
    worst = 0.0
    for cdt, force in ((torch.float32, False), (torch.bfloat16, False), (torch.bfloat16, True)):
        # the main path's factors keep the tensor-core rule: bf16 takes it
        natural = "mma" if cdt == torch.bfloat16 else "fma"
        if wgrad.route(problems, cdt) != natural:
            raise AssertionError(f"wgrad {label} {cdt}: route {wgrad.route(problems, cdt)}")
        want = "fma" if force else natural
        before = (wgrad.launches, wgrad.fma_launches)
        out = wgrad.wgrad(problems, cdt, fma=force)
        again = wgrad.wgrad(problems, cdt, fma=force)
        got = (wgrad.launches - before[0], wgrad.fma_launches - before[1])
        ref = wgrad.wgrad_reference(problems, cdt)
        torch.cuda.synchronize()
        if got != ((2, 0) if want == "mma" else (0, 2)):
            raise AssertionError(f"wgrad {label} {cdt}: launches by route {got}")
        same = all(torch.equal(c, c2) and (b is None or torch.equal(b, b2))
                   for (c, b), (c2, b2) in zip(out, again))
        errs = [_rel_err(c, c_r) for (c, _), (c_r, _) in zip(out, ref)]
        berrs = [_rel_err(b, b_r) for (_, b), (_, b_r) in zip(out, ref) if b is not None]
        log(f"[wgrad] {label} {str(cdt)[6:]} {want} route: max|kernel-plain|/max|plain| over "
            f"{len(errs)} products {max(errs):.3e} (tol 1e-4)"
            + (f", {len(berrs)} biases {max(berrs):.3e} (tol 1e-5)" if berrs else "")
            + f"; a second launch bit-identical: {same}")
        if not (max(errs) <= 1e-4 and all(e <= 1e-5 for e in berrs) and same):
            raise AssertionError(f"wgrad disagrees with its plain version or itself: {label} "
                                 f"{errs} {berrs} identical {same}")
        worst = max(worst, *errs, *berrs)
    return worst


def phase_bigru_bwd():
    """Kernel 4 (csrc/bigru_scan_bwd.cu, two directions, see
    ``_gru_bwd_phase``).  Returns (its record, its prologue's record, (the
    wgrad error, the wgrad launch's record))."""
    return _gru_bwd_phase(2)


def _gru_bwd_case(dirs, T, B, F, dtype, seed):
    """xg, xc, hprev, dys, whg, whc of the GRU scan backward, two directions
    or one: the forward kernel's states shifted one step, random cotangents."""
    import torch
    from tacotron_multispeaker_torch.ops import gru_scan as gs
    inputs, fwd = (_bigru_inputs, gs.bigru_scan) if dirs == 2 else (_gru_inputs, gs.gru_scan)
    xg, xc, whg, whc, h0 = inputs(T, B, F, dtype, seed)
    ys = fwd(xg, xc, whg, whc, h0)
    hprev = torch.cat([h0[None].to(dtype), ys[:-1]]).contiguous()
    g = torch.Generator(device="cuda").manual_seed(seed)
    dys = torch.randn(tuple(ys.shape), generator=g, device="cuda").to(dtype)
    return xg, xc, hprev, dys, whg, whc


def _gru_remat_plain(args):
    """The prologue's plain version on a backward's arguments (either
    direction count) → (ruc, rh)."""
    from tacotron_multispeaker_torch.ops import gru_scan as gs
    xg, xc, hprev, _, whg, whc = args
    if xg.dim() == 4:
        return gs.bigru_bwd_remat_reference(xg, xc, hprev, whg, whc)
    out = gs.bigru_bwd_remat_reference(xg[:, None], xc[:, None], hprev[:, None], whg[None],
                                       whc[None])
    return tuple(a[:, 0] for a in out)


def _smem_probe(threads):
    """Latencies behind the GRU backward scan's per-step bound, measured on
    this card (``csrc/latency_probe.cu``, CUDA events over many dependent
    operations): one barrier + shared-memory exchange of a block of
    ``threads`` threads (us), one SM's shared-memory read bandwidth
    (bytes/s, 16-byte loads from 1024 threads)."""
    import ctypes
    import torch
    from tacotron_multispeaker_torch.ops import cuda_build
    lib = cuda_build.library("latency_probe")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.probe_block_exchange.argtypes = [ci, ci, vp, vp]
    lib.probe_smem_stream.argtypes = [ci, vp, vp]
    stream = torch.cuda.current_stream().cuda_stream
    sink = torch.zeros(4, device="cuda")

    def timed(call, count):
        call()
        torch.cuda.synchronize()
        return cuda_time_ms(lambda: cuda_build.check(call(), "smem probe"), reps=3) * 1e3 / count

    iters, reps = 20000, 4096
    ex_us = timed(lambda: lib.probe_block_exchange(threads, iters, sink.data_ptr(), stream),
                  iters)
    s = timed(lambda: lib.probe_smem_stream(reps, sink.data_ptr(), stream), 1) * 1e-6
    return {"exchange_us": ex_us, "threads": threads, "sm_smem_bytes_s": reps * 32768 / s}


def _gru_bwd_latency_bound_ms(T, B, F, dirs, esize, probe, n_sm):
    """The per-step latency bound of csrc/bigru_scan_bwd.cu's scan: two
    dependent phases a step, each a barrier plus a shared-memory round trip
    (``probe_block_exchange`` at the block's 4F threads), plus the 3F^2
    weight elements a step reads from shared memory over one SM's
    shared-memory bandwidth; one block a (direction, row), blocks beyond
    the SMs in later waves."""
    import math
    step_s = (2 * probe["exchange_us"] * 1e-6
              + 3 * F * F * esize / probe["sm_smem_bytes_s"])
    return T * math.ceil(dirs * B / n_sm) * step_s * 1e3


def _gru_bwd_phase(dirs):
    """Kernel 4 (dirs=2: ``bigru_scan_bwd``) or kernel 2 (dirs=1:
    ``gru_scan_bwd``).  The prologue launch alone (``bwd_remat``) and the
    whole backward (prologue, scan and one wgrad launch) against their plain
    versions at B=32, T=192 and 1000, the CBHG width F=128 and tiny's F=32,
    f32 and bf16; then, at B=32 F=128 bf16 (T=192 and 1000 for two
    directions, T=1000 for one): the two launches' call ms, each launch's
    device ms, the plain version, the byte/FLOP bound and the scan's
    per-step latency bound (probed on this card).  Returns (the backward's
    record, the prologue's record, (the wgrad error, the wgrad launch's
    record))."""
    import torch
    from tacotron_multispeaker_torch.ops import gru_scan as gs
    tag = "bigru_scan_bwd" if dirs == 2 else "gru_scan_bwd"
    bwd, bwd_ref = ((gs.bigru_scan_bwd, gs.bigru_scan_bwd_reference) if dirs == 2
                    else (gs.gru_scan_bwd, gs.gru_scan_bwd_reference))
    B = 32
    names = ("dxg", "dxc", "dwhg", "dwhc", "dh0")
    # the whole backward, relative to each output's peak.  f32: the same
    # arithmetic in another sum order (the weight gradients sum T*B rows)
    # -> 1e-4.  bf16: a sum landing on a rounding boundary flips one bf16
    # ulp of a matmul input (2^-8 relative), which the reverse recurrence
    # carries -> 5e-2.
    tol = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
    # the prologue alone, each of r, u, c and rh relative to its peak.
    # f32: sum order only, no recurrence -> 1e-5.  bf16: both sides round
    # the same inputs, but an order difference can flip the bf16 rounding of
    # r*h_prev (one ulp, 2^-8 of rh), which the candidate's product rounds
    # again -> 1e-2
    rtol = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
    worst = {"bwd": 0.0, "remat": 0.0}
    for F in (128, 32):
        for T in (192, 1000):
            for dtype in (torch.float32, torch.bfloat16):
                args = _gru_bwd_case(dirs, T, B, F, dtype, seed=T + F + dirs)
                ruc, rh = gs.bwd_remat(*args[:3], *args[4:])
                ruc_r, rh_r = _gru_remat_plain(args)
                torch.cuda.synchronize()
                errs = {p: _rel_err(ruc[..., k * F:(k + 1) * F], ruc_r[..., k * F:(k + 1) * F])
                        for k, p in enumerate("ruc")}
                errs["rh"] = _rel_err(rh, rh_r)
                label = f"T={T} B={B} F={F} {str(dtype)[6:]}"
                log(f"[{tag}_remat] {label}: max|kernel-plain|/max|plain| "
                    + " ".join(f"{n} {e:.3e}" for n, e in errs.items())
                    + f" (tol {rtol[dtype]:.0e})")
                if not all(e <= rtol[dtype] for e in errs.values()):
                    raise AssertionError(f"{tag} prologue disagrees with its plain version: "
                                         f"{errs}")
                worst["remat"] = max(worst["remat"], *errs.values())
                out = bwd(*args)
                ref = bwd_ref(*args)
                torch.cuda.synchronize()
                errs = {n: _rel_err(a, b) for n, a, b in zip(names, out, ref)}
                log(f"[{tag}] {label}: max|kernel-plain|/max|plain| "
                    + " ".join(f"{n} {e:.3e}" for n, e in errs.items())
                    + f" (tol {tol[dtype]:.0e})")
                if not all(e <= tol[dtype] for e in errs.values()):
                    raise AssertionError(f"{tag} disagrees with its plain version: {errs}")
                worst["bwd"] = max(worst["bwd"], *errs.values())
    # timing at the train batch's shapes: the encoder's L=192 and the
    # post-net's T=1000 frames, B=32, F=128, bf16
    F, dtype = 128, torch.bfloat16
    probe = _smem_probe(4 * F)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    stems = ("bigru_bwd_remat", "bigru_bwd_scan")
    for T in ((192, 1000) if dirs == 2 else (1000,)):
        args = _gru_bwd_case(dirs, T, B, F, dtype, seed=11 if dirs == 2 else 12)
        run = lambda: gs._bwd_kernel(*args)
        ms = cuda_time_ms(run, reps=5)
        split, split_n = _device_split_ms(run, stems, per_call=dict.fromkeys(stems, 1))
        lat_ms = _gru_bwd_latency_bound_ms(T, B, F, dirs, 2, probe, n_sm)
        log(f"[{tag}] T={T} B={B} F={F} bf16: kernel (prologue + scan) {ms:.3f} ms, device "
            f"{json.dumps({k: round(v, 4) for k, v in split.items()})} ms "
            f"({json.dumps(split_n)} launches); scan latency bound {lat_ms:.3f} ms "
            f"({100 * lat_ms / split['bigru_bwd_scan']:.1f} % of the scan's "
            f"time)")
    log(f"[{tag}] probe: barrier + shared-memory exchange of {probe['threads']} threads "
        f"{probe['exchange_us']:.4f} us, one SM's shared-memory read "
        f"{probe['sm_smem_bytes_s'] / 1e9:.1f} GB/s; the scan's bound a step: 2 phases + "
        f"{3 * F * F * 2 / 1e3:.1f} KB of weights")
    plain_ms = cuda_time_ms(lambda: bwd_ref(*args), reps=1)
    xg, xc, hprev, dys, whg, whc = args
    dxg, dxc, rh, dh0 = gs._bwd_kernel(*args)
    bytes_ = _nbytes(xg, xc, hprev, dys, whg, whc, dxg, dxc, rh, dh0)
    bound_ms, bound_by = _bound_ms(bytes_, bf16_flops=T * dirs * B * 12 * F * F)
    D = range(dirs)
    if dirs == 2:
        problems = ([(hprev[:, d], dxg[:, d], False) for d in D]
                    + [(rh[:, d], dxc[:, d], False) for d in D])
    else:
        problems = [(hprev, dxg, False), (rh, dxc, False)]
    w_label = f"{tag}, {2 * dirs} products over {T * B} rows"
    w_err = _check_wgrad(problems, w_label)
    w_rec = _time_wgrad(problems, dtype, w_label)
    w_ms, w_plain = w_rec["ms"], w_rec["plain_ms"]
    log(f"[{tag}] T={T} B={B} F={F} bf16: kernel {ms:.3f} ms, plain (with its weight "
        f"gradients) {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}); its wgrad "
        f"launch {w_ms:.3f} ms (plain {w_plain:.3f} ms, bound "
        f"{_wgrad_bound_ms(problems)[0]:.4f} ms)")
    rec = {"max_abs_err": worst["bwd"], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "bound_latency_ms": lat_ms,
           "ms_remat": split["bigru_bwd_remat"], "ms_scan": split["bigru_bwd_scan"],
           "shape": f"T={T} B={B} F={F} bf16",
           "error": "max |kernel - plain| / max |plain| over every output; B=32 at T=192 and "
                    "1000, F=128 and 32, f32 and bf16"}
    if dirs == 1:
        rec.update(wgrad_ms=w_ms, wgrad_plain_ms=w_plain)
    # the prologue alone: time, plain time, bound (inputs read once, outputs
    # written once; the products in bf16)
    r_ms = cuda_time_ms(lambda: gs._remat_kernel(xg, xc, hprev, whg, whc), reps=10)
    r_plain = cuda_time_ms(lambda: _gru_remat_plain(args), reps=3)
    ruc, rh = gs._remat_kernel(xg, xc, hprev, whg, whc)
    r_bound = _bound_ms(_nbytes(xg, xc, hprev, whg, whc, ruc, rh),
                        bf16_flops=2 * T * dirs * B * 3 * F * F)
    log(f"[{tag}_remat] T={T} B={B} F={F} bf16 ({T * dirs * B} rows): kernel {r_ms:.4f} ms, "
        f"plain {r_plain:.3f} ms, bound {r_bound[0]:.4f} ms ({r_bound[1]})")
    remat = {"max_abs_err": worst["remat"], "ms": r_ms, "plain_ms": r_plain,
             "bound_ms": r_bound[0], "bound_by": r_bound[1],
             "shape": f"T*D*B={T * dirs * B} rows, F={F} bf16",
             "error": "max |kernel - plain| / max |plain| over r, u, c and r*h_prev; B=32 at "
                      "T=192 and 1000, F=128 and 32, f32 and bf16"}
    return rec, remat, (w_err, w_rec)


def _teacher_case(B, L, S, dtype, seed, scale=0.05, H=256, A=256, D=320, N=2):
    import torch
    from tacotron_multispeaker_torch.ops.teacher_decoder import TeacherDecoderWeights
    g = torch.Generator(device="cuda").manual_seed(seed)
    f = lambda *s, sc=scale: torch.randn(*s, generator=g, device="cuda") * sc
    w = TeacherDecoderWeights(
        a_hg=f(H, 2 * H), a_hc=f(H, H), wq=f(H, A), v=f(A, sc=4 * scale), w_ctx=f(D, 4 * H),
        wd_h=f(H, H), d_b=f(H), w_r=tuple(f(H, 3 * H) for _ in range(N)),
        b_r=tuple(f(3 * H) for _ in range(N)), hg=tuple(f(H, 2 * H) for _ in range(N)),
        hc=tuple(f(H, H) for _ in range(N))).cast(dtype)
    lengths = torch.randint(1, L + 1, (B,), generator=g, device="cuda")
    lengths[0] = L
    mask = (torch.arange(L, device="cuda")[None, :] < lengths[:, None]).contiguous()
    args = (f(S, B, 2 * H, sc=0.5).to(dtype), f(S, B, H, sc=0.5).to(dtype), f(B, H, sc=0.3),
            f(N, B, H, sc=0.3), f(B, L, A, sc=0.3).to(dtype), f(B, L, D, sc=1.0).to(dtype),
            mask)
    return w, args


class plain_kernels:
    """Swap every kernel wrapper that the model's forward and generate reach
    for its plain version (which runs on CUDA tensors too) inside the block;
    the Griffin-Lim kernels are held against theirs in their own phases."""

    def __enter__(self):
        from tacotron_multispeaker_torch.ops import decoder_loop as dl
        from tacotron_multispeaker_torch.ops import gru_scan as gs
        from tacotron_multispeaker_torch.ops import teacher_decoder as td
        from tacotron_multispeaker_torch.ops import attention_step as ast
        from tacotron_multispeaker_torch.ops import conv_bank as cb
        self.swaps = [(cb, "conv_bank", cb.conv_bank_reference),
                      (ast, "attention_step", ast.attention_step_reference),
                      (gs, "bigru_scan", gs.bigru_scan_reference),
                      (gs, "bigru_scan_bwd", gs.bigru_scan_bwd_reference),
                      (gs, "gru_scan", gs.gru_scan_reference),
                      (gs, "gru_scan_bwd", gs.gru_scan_bwd_reference),
                      (dl, "decoder_loop", dl.decoder_loop_reference),
                      (td, "teacher_decoder_fwd", td.teacher_decoder_fwd_reference),
                      (td, "teacher_decoder_bwd", td.teacher_decoder_bwd_reference),
                      (td, "dkeys", td.dkeys_reference)]
        self.saved = [(mod, name, getattr(mod, name)) for mod, name, _ in self.swaps]
        for mod, name, fn in self.swaps:
            setattr(mod, name, fn)

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _teacher_bwd_args(fwd_args, w, states, seed):
    """The arguments of ``teacher_decoder_bwd`` from a forward's states, as
    ``teacher_decoder_backward`` shifts them, with random cotangents."""
    import torch
    png, pnc, h0a, h0d, keys, memory, mask = fwd_args
    xs, align, ha, hds = states
    shift = lambda a, a0: torch.cat([a0[None].to(a.dtype), a[:-1]]).contiguous()
    hap = shift(ha, h0a)
    hdps = tuple(shift(hds[i], h0d[i]) for i in range(len(hds)))
    pp = shift(align, torch.zeros_like(align[0]))
    g = torch.Generator(device="cuda").manual_seed(seed)
    dxs = torch.randn(tuple(xs.shape), generator=g, device="cuda")
    dal = torch.randn(tuple(align.shape), generator=g, device="cuda") * 0.1
    return (png, pnc, ha, hap, tuple(hds), hdps, xs, align, pp, dxs, dal, w, keys, memory,
            mask)


def _random_pp(align, mask, seed):
    """A previous-step alignment that is not ``align`` shifted: random and
    normalised over each row's unmasked keys, at the alignments' scale (the
    backward takes pp as given)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = torch.rand(tuple(align.shape), generator=g, device="cuda") * mask[None].float()
    return (r / r.sum(-1, keepdim=True)).contiguous()


def _bwd_errors(out, ref):
    """Each output of ``teacher_decoder_bwd`` relative to its peak."""
    from tacotron_multispeaker_torch.ops.teacher_decoder import TeacherDecoderWeights
    names = ("dpng", "dpnc", "de", "dctx", "dh0a", "dh0d")
    errs = {n: _rel_err(a, b) for n, a, b in zip(names, out[:6], ref[:6])}
    for n, a, b in zip(TeacherDecoderWeights._fields, out[6], ref[6]):
        if b is not None:
            pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
            errs.update({f"{n}[{i}]" if isinstance(a, tuple) else n: _rel_err(x, y)
                         for i, (x, y) in enumerate(pairs)})
    return errs


def _remat_errors(out, ref):
    """Each prologue output relative to its peak: every GRU's r, u and c,
    q, ctx, the layer inputs and r*h_prev."""
    xin, rh, ruc, rh_a, ctx, q = out
    xin_r, rh_r, ruc_r, rh_a_r, ctx_r, q_r = ref
    H = rh_a.shape[-1]
    errs = {}
    for g in range(len(ruc_r)):
        name = "attn" if g == len(ruc_r) - 1 else f"layer{g}"
        for k, part in enumerate("ruc"):
            sl = slice(k * H, (k + 1) * H)
            errs[f"{name}.{part}"] = _rel_err(ruc[g][..., sl], ruc_r[g][..., sl])
    errs.update(q=_rel_err(q, q_r), ctx=_rel_err(ctx, ctx_r), rh_a=_rel_err(rh_a, rh_a_r))
    for i in range(len(xin_r)):
        errs[f"xin{i}"] = _rel_err(xin[i], xin_r[i])
        errs[f"rh{i}"] = _rel_err(rh[i], rh_r[i])
    return errs


def _check_teacher_fwd(w, args, tol):
    """Kernel 6 against its plain version on one case, at the launch plan's
    C and at every C the card holds (forced through ``_teacher_fwd_cuda``):
    xs and the states relative to their peak, alignments absolute.  Returns
    (the plain outputs, the worst error)."""
    import torch
    from tacotron_multispeaker_torch.ops import teacher_decoder as td
    png, pnc, h0a, h0d, keys, memory, mask = args
    S, B = png.shape[:2]
    L, A, D, H, N = keys.shape[1], keys.shape[2], memory.shape[-1], png.shape[-1] // 2, len(w.w_r)
    ref = td.teacher_decoder_fwd_reference(png, pnc, h0a, h0d, w, keys, memory, mask)
    counts = td.fwd_cluster_counts((S, B, L, A, D, H, N), int(keys.dtype == torch.bfloat16),
                                   keys.device)
    runs = [("plan", lambda: td.teacher_decoder_fwd(png, pnc, h0a, h0d, w, keys, memory, mask))]
    runs += [(f"C={C}", lambda C=C: td._teacher_fwd_cuda(png, pnc, h0a, h0d, w, keys, memory,
                                                         mask, cluster=C))
             for C in td.CLUSTER_SIZES if counts[C] > 0]
    xt, at = tol
    worst = 0.0
    for label, run in runs:
        out = run()
        torch.cuda.synchronize()
        errs = {"xs": _rel_err(out[0], ref[0]), "ha": _rel_err(out[2], ref[2]),
                **{f"hd_{i}": _rel_err(out[3][i], ref[3][i]) for i in range(N)}}
        e_al = (out[1] - ref[1]).abs().max().item()
        log(f"[teacher_fwd] B={B} L={L} S={S} H=A={H} D={D} {str(keys.dtype)[6:]} {label} "
            f"(ran C={td.fwd_last_plan[0]}): " + " ".join(f"{n} {e:.3e}" for n, e in errs.items())
            + f" (relative, tol {xt:.0e}); align {e_al:.3e} (absolute, tol {at:.0e})")
        if not (all(e <= xt for e in errs.values()) and e_al <= at):
            raise AssertionError(f"teacher_decoder_fwd disagrees with its plain version "
                                 f"(B={B} L={L} S={S} D={D} {label})")
        worst = max(worst, *errs.values(), e_al)
    log(f"[teacher_fwd] B={B} L={L} D={D} {str(keys.dtype)[6:]}: co-resident clusters "
        f"{counts}, plan C={td.launch_plan(B, H, 16 // keys.element_size(), counts)}")
    return ref, worst


def phase_teacher(gru_wgrad):
    """Kernels 6, 7 and 8 at the train batch's shapes, and the weight-
    gradient reduction: the teacher backward's launch here, ``gru_wgrad``
    the (error, record) of the BiGRU's and the GRU's from their phases."""
    import torch
    from tacotron_multispeaker_torch.ops import teacher_decoder as td
    B, L, H, A, D, N = 32, 192, 256, 256, 320, 2
    result = {}
    # forward: (xs/states relative to their peak, alignments absolute).
    # f32: sum order only.  bf16: flipped roundings of matmul inputs carried
    # by the recurrences; energies and softmax stay f32 (1e-3 is a fifth of
    # a typical weight ~1/L at L=192).
    ftol = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (5e-2, 1e-3)}
    # backward, every gradient relative to its peak: f32 sum order (weight
    # gradients over S*B rows); bf16 flipped roundings carried back
    btol = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
    # the prologue alone, each output relative to its peak.  f32: sum order
    # only, no recurrence (K <= D + H terms).  bf16: both sides round the
    # same inputs and multiply exactly; but an order difference can flip the
    # bf16 rounding of an intermediate the next product rounds again
    # (ctx_prev, r*h_prev): one ulp (2^-8 relative) of ctx_prev (|.| up to
    # ~4 here) times a weight (|.| up to ~0.2) moves a pre-activation by
    # ~3e-3 of the gates' peak (1)
    rtol = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
    worst = {"fwd": 0.0, "bwd": 0.0, "remat": 0.0}
    # the forward alone: a ragged B=3 L=13 batch (some CTAs hold no position
    # at C=16) and pod_synthesis's D=384, short runs in f32 and bf16
    for dtype in (torch.float32, torch.bfloat16):
        for b_, l_, d_ in ((3, 13, D), (B, L, 384)):
            w, args = _teacher_case(b_, l_, 20, dtype, seed=27, D=d_)
            worst["fwd"] = max(worst["fwd"], _check_teacher_fwd(w, args, ftol[dtype])[1])
    # S=12 and 20: one partial tile of the prologue (a block takes 64 steps
    # of a batch row); S=200, the train batch's: three full tiles and a
    # partial one.  The forward is held at every S, at the launch plan's C
    # and at every C the card holds
    for dtype, S in ((torch.float32, 12), (torch.bfloat16, 20), (torch.float32, 200),
                     (torch.bfloat16, 200)):
        w, args = _teacher_case(B, L, S, dtype, seed=21)
        png, pnc, h0a, h0d, keys, memory, mask = args
        ref, err = _check_teacher_fwd(w, args, ftol[dtype])
        worst["fwd"] = max(worst["fwd"], err)
        # the backward's prologue alone, from the plain forward's states:
        # with the alignments shifted into pp, as the train path gives it,
        # and with a random pp (the prologue must not assume the shift); the
        # two launches together with the random pp (every output of
        # teacher_decoder_bwd, tolerances of the whole backward's check below)
        bargs = list(_teacher_bwd_args(args, w, ref, seed=22))
        for pp_kind in ("shifted", "random"):
            if pp_kind == "random":
                bargs[8] = _random_pp(bargs[7], mask, seed=26)
            errs = _remat_errors(td.teacher_bwd_remat(*bargs),
                                 td.teacher_bwd_remat_reference(*bargs))
            torch.cuda.synchronize()
            log(f"[teacher_bwd_remat] B={B} L={L} S={S} {str(dtype)[6:]} {pp_kind} pp: "
                f"max|kernel-plain|/max|plain| "
                + " ".join(f"{n} {e:.2e}" for n, e in errs.items())
                + f" (tol {rtol[dtype]:.0e})")
            if not all(e <= rtol[dtype] for e in errs.values()):
                raise AssertionError("teacher backward prologue disagrees with its plain version")
            worst["remat"] = max(worst["remat"], *errs.values())
        errs = _bwd_errors(td.teacher_decoder_bwd(*bargs), td.teacher_decoder_bwd_reference(*bargs))
        log(f"[teacher_bwd] B={B} L={L} S={S} {str(dtype)[6:]} random pp: max|kernel-plain|/"
            f"max|plain| " + " ".join(f"{n} {e:.2e}" for n, e in errs.items())
            + f" (tol {btol[dtype]:.0e})")
        if not all(e <= btol[dtype] for e in errs.values()):
            raise AssertionError("teacher decoder backward disagrees with its plain version "
                                 "(random pp)")
        worst["bwd"] = max(worst["bwd"], *errs.values())
        # the whole backward from the plain forward's states, random cotangents
        g = torch.Generator(device="cuda").manual_seed(22)
        xs, align, ha, hds = ref
        dxs = torch.randn(tuple(xs.shape), generator=g, device="cuda")
        dal = torch.randn(tuple(align.shape), generator=g, device="cuda") * 0.1
        bargs = (png, pnc, h0a, h0d, w, keys, memory, mask, xs, align, ha, hds, dxs, dal)
        out = td.teacher_decoder_backward(*bargs)
        with plain_kernels():
            ref = td.teacher_decoder_backward(*bargs)
        torch.cuda.synchronize()
        errs = {n: _rel_err(a, b) for n, a, b in
                zip(("dpng", "dpnc", "dh0a", "dh0d"), out[:4], ref[:4])}
        for n, a, b in zip(td.TeacherDecoderWeights._fields, out[4], ref[4]):
            pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
            for i, (x, y) in enumerate(pairs):
                errs[n if not isinstance(a, tuple) else f"{n}[{i}]"] = _rel_err(x, y)
        errs.update({n: _rel_err(a, b) for n, a, b in
                     zip(("dkeys", "dmemory", "de", "dctx"), out[5:], ref[5:])})
        log(f"[teacher_bwd] B={B} L={L} S={S} {str(dtype)[6:]}: max|kernel-plain|/max|plain| "
            + " ".join(f"{n} {e:.2e}" for n, e in errs.items()) + f" (tol {btol[dtype]:.0e})")
        if not all(e <= btol[dtype] for e in errs.values()):
            raise AssertionError(f"teacher decoder backward disagrees with its plain version")
        worst["bwd"] = max(worst["bwd"], *errs.values())

    # d_keys at the full train shape, both dtypes, relative to the peak:
    # f32 sums of 200 steps in another order, keys and v rounded on both
    # sides, the kernel's tanh from exp(2k) exp(2q) and an approximate
    # reciprocal (a few ulp from tanhf) -> 1e-4.  "guard": keys and q
    # uniform in [-40, 40], so that most elements take the guarded tanhf
    # (|k| or |q| > 20) and the rest sum k + q up to 40
    S = 200
    g = torch.Generator(device="cuda").manual_seed(23)
    dk_worst = 0.0
    for dtype, kind in ((torch.float32, "normal"), (torch.bfloat16, "normal"),
                        (torch.float32, "guard"), (torch.bfloat16, "guard")):
        tol = 1e-4
        if kind == "guard":
            u = lambda *sh: (torch.rand(*sh, generator=g, device="cuda") * 2 - 1) * 40
            keys, q = u(B, L, A).to(dtype), u(S, B, A)
        else:
            keys = (torch.randn(B, L, A, generator=g, device="cuda") * 0.3).to(dtype)
            q = torch.randn(S, B, A, generator=g, device="cuda")
        de = torch.randn(S, B, L, generator=g, device="cuda") * 1e-2
        v = (torch.randn(A, generator=g, device="cuda") * 0.2).to(dtype)
        dk, dv = td.dkeys(keys, q, de, v)
        dk2, dv2 = td.dkeys(keys, q, de, v)
        dk_r, dv_r = td.dkeys_reference(keys, q, de, v)
        torch.cuda.synchronize()
        e_k, e_v = _rel_err(dk, dk_r), _rel_err(dv, dv_r)
        same = torch.equal(dk, dk2) and torch.equal(dv, dv2)
        log(f"[dkeys] S={S} B={B} L={L} A={A} {str(dtype)[6:]} {kind} inputs: dkeys {e_k:.3e} "
            f"dv {e_v:.3e} (relative to peak, tol {tol:.0e}); a second launch bit-identical: "
            f"{same}")
        if not (e_k <= tol and e_v <= tol and same):
            raise AssertionError("dkeys disagrees with its plain version or itself")
        dk_worst = max(dk_worst, e_k, e_v)

    # timing at the B=32 train batch's shape: S=200 steps, L=192, bf16; the
    # forward at the plan's C, its device ms and per-step latency bound
    # (probed on this card), then a sweep over C at B=32 and B=1
    dtype = torch.bfloat16
    probe = _latency_probe(td.CLUSTER_SIZES)
    w, args = _teacher_case(B, L, S, dtype, seed=24)
    png, pnc, h0a, h0d, keys, memory, mask = args
    fwd = lambda: td.teacher_decoder_fwd(png, pnc, h0a, h0d, w, keys, memory, mask)
    dev, _ = _device_split_ms(fwd, ("teacher_fwd",))
    plain_ms = cuda_time_ms(lambda: td.teacher_decoder_fwd_reference(
        png, pnc, h0a, h0d, w, keys, memory, mask), reps=1)
    sweep, plan_b = {}, {}
    for b_ in (B, 1):
        wb, ab = (w, args) if b_ == B else _teacher_case(1, L, S, dtype, seed=28)
        t_ms = cuda_time_ms(lambda: td.teacher_decoder_fwd(*ab[:4], wb, *ab[4:]), reps=3)
        c_b, co_b = td.fwd_last_plan
        plan_b[b_] = (t_ms, c_b, co_b, _teacher_fwd_latency_bound_ms(wb, ab[4], ab[5], S, c_b,
                                                                     co_b, probe))
        counts = td.fwd_cluster_counts((S, b_, L, A, D, H, N), 1, keys.device)
        sweep[b_] = {c: round(cuda_time_ms(lambda c=c: td._teacher_fwd_cuda(
            *ab[:4], wb, *ab[4:], cluster=c), reps=3), 3) for c in td.CLUSTER_SIZES
            if counts[c] > 0}
    ms, C, coresident, lat_ms = plan_b[B]
    xs, align, ha, hds = fwd()
    wts = [t for t in w.flat()]
    macs = (H * 2 * H + H * H + H * A + D * 4 * H + H * H + L * D
            + N * (3 * H * H + 2 * H * H + H * H))
    bound = _bound_ms(_nbytes(*wts, png, pnc, h0a, h0d, keys, memory, mask, xs, align, ha,
                              *hds),
                      bf16_flops=2 * S * B * macs, f32_flops=S * B * (3 * L * A + 4 * L))
    result["teacher_decoder_fwd"] = {"max_abs_err": worst["fwd"], "ms": ms,
                                     "plain_ms": plain_ms, "bound_ms": bound[0],
                                     "bound_by": bound[1], "bound_latency_ms": lat_ms,
                                     "cluster": C, "ms_b1": plan_b[1][0],
                                     "shape": f"B={B} L={L} S={S} H=A={H} D={D} bf16",
                                     "error": "xs/states relative to peak, align absolute; "
                                              "B=32 L=192 at S=12, 20 and 200, B=3 L=13, "
                                              "D=384, f32 and bf16, every C"}
    log(f"[teacher_fwd] B={B} L={L} S={S} bf16: kernel {ms:.3f} ms at C={C} ({coresident} "
        f"clusters co-resident; device {dev['teacher_fwd']:.3f} ms), plain {plain_ms:.3f} ms, "
        f"bound {bound[0]:.4f} ms ({bound[1]}), latency bound {lat_ms:.3f} ms ({5 + 2 * N} "
        f"phases a step; {100 * lat_ms / ms:.1f} % of the kernel's time)")
    for b_, (t_ms, c_b, _, l_ms) in plan_b.items():
        log(f"[teacher_fwd] B={b_} L={L} S={S} bf16: plan C={c_b} {t_ms:.3f} ms, latency bound "
            f"{l_ms:.3f} ms ({100 * l_ms / t_ms:.1f} %); by C: {json.dumps(sweep[b_])} ms")
    bargs = _teacher_bwd_args(args, w, (xs, align, ha, hds), seed=25)
    png, pnc, ha, hap, hds, hdps, xs, align, pp, dxs, dal = bargs[:11]
    run = lambda: td._bwd_kernel(*bargs)
    ms = cuda_time_ms(run, reps=3)
    split, split_n = _device_split_ms(run, ("teacher_bwd_remat", "teacher_bwd_scan"),
                                      per_call={"teacher_bwd_remat": 1, "teacher_bwd_scan": 1})
    plain_ms = cuda_time_ms(lambda: td.teacher_decoder_bwd_reference(*bargs), reps=1)
    outs, streams = run()
    macs = (N * 12 * H * H + H * H + L * D + 4 * H * D + L * D + 2 * H * A + L * D
            + D * 4 * H + 6 * H * H)
    bound = _bound_ms(_nbytes(png, pnc, ha, hap, *hds, *hdps, xs, align, pp, dxs, dal, keys,
                              memory, mask, *wts, *outs, *streams),
                      bf16_flops=2 * S * B * macs, f32_flops=S * B * 5 * L * A)
    # the scan's per-step latency bound, and the one of the design before
    # the prologue (every product on the chain), from this card's latencies
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    lat = {hoisted: _teacher_bwd_latency_bound_ms(
        S, B, _teacher_bwd_phases(N, hoisted),
        _teacher_bwd_step_bytes(H, A, D, L, N, 2, hoisted), probe, n_sm)
        for hoisted in (True, False)}
    result["teacher_decoder_bwd"] = {"max_abs_err": worst["bwd"], "ms": ms,
                                     "plain_ms": plain_ms, "bound_ms": bound[0],
                                     "bound_by": bound[1], "bound_latency_ms": lat[True],
                                     "ms_remat": split["teacher_bwd_remat"],
                                     "ms_scan": split["teacher_bwd_scan"],
                                     "shape": f"B={B} L={L} S={S} H=A={H} D={D} bf16",
                                     "error": "max |kernel - plain| / max |plain| over every "
                                              "gradient of the backward; B=32 L=192 at S=12, 20 "
                                              "and 200, f32 and bf16, pp shifted and random"}
    log(f"[teacher_bwd] B={B} L={L} S={S} bf16: kernel (prologue + scan) {ms:.3f} ms, device "
        f"{json.dumps({k: round(v, 3) for k, v in split.items()})} ms ({json.dumps(split_n)} "
        f"launches), plain (with its weight gradients) {plain_ms:.3f} ms, bound "
        f"{bound[0]:.4f} ms ({bound[1]})")
    log(f"[teacher_bwd] scan latency bound {lat[True]:.3f} ms ({_teacher_bwd_phases(N)} phases "
        f"a step, {_teacher_bwd_step_bytes(H, A, D, L, N, 2) / 1e6:.2f} MB a row's step; "
        f"{100 * lat[True] / split['teacher_bwd_scan']:.1f} % of the scan's "
        f"time); with every "
        f"product on the chain {lat[False]:.3f} ms ({_teacher_bwd_phases(N, False)} phases, "
        f"{_teacher_bwd_step_bytes(H, A, D, L, N, 2, False) / 1e6:.2f} MB); probe: L2 round "
        f"trip {probe['l2_round_trip_us']:.3f} us, one SM's L2 read "
        f"{probe['sm_l2_bytes_s'] / 1e9:.1f} GB/s, the card's "
        f"{probe['card_l2_bytes_s'] / 1e9:.1f} GB/s")
    # the prologue alone: its time, plain time and product bound (inputs read
    # once, outputs written once; the products in bf16)
    r_ms = cuda_time_ms(lambda: td._remat_kernel(*bargs), reps=5)
    r_plain = cuda_time_ms(lambda: td.teacher_bwd_remat_reference(*bargs), reps=2)
    xin, rh, ruc, rh_a, ctx, q = td._remat_kernel(*bargs)
    r_macs = N * 6 * H * H + 2 * L * D + 3 * H * (D + H) + H * A
    r_bound = _bound_ms(_nbytes(png, pnc, ha, hap, *hds, *hdps, xs, align, pp, memory,
                                w.a_hg, w.a_hc, w.wq, w.w_ctx, *w.w_r, *w.b_r, *w.hg, *w.hc,
                                xin, rh, ruc, rh_a, ctx, q),
                        bf16_flops=2 * S * B * r_macs)
    result["teacher_decoder_bwd_remat"] = {
        "max_abs_err": worst["remat"], "ms": r_ms, "plain_ms": r_plain,
        "bound_ms": r_bound[0], "bound_by": r_bound[1],
        "shape": f"S*B={S * B} rows, H=A={H} D={D} L={L} bf16",
        "error": "max |kernel - plain| / max |plain| over each GRU's r, u, c, q, ctx, the "
                 "layer inputs and r*h_prev; B=32 L=192 at S=12, 20 and 200, f32 and bf16, "
                 "pp shifted and random"}
    log(f"[teacher_bwd_remat] S*B={S * B} rows bf16: kernel {r_ms:.3f} ms, plain "
        f"{r_plain:.3f} ms, bound {r_bound[0]:.4f} ms ({r_bound[1]})")
    # its weight-gradient reduction (one grouped wgrad launch, 11 products)
    problems = td._weight_grad_problems(ha, hap, hdps, outs, streams)
    w_label = f"teacher backward, {len(problems)} products over {S * B} rows"
    w_err = _check_wgrad(problems, w_label)
    wr = _time_wgrad(problems, dtype, w_label)
    (bi_err, bi), (g_err, gr) = gru_wgrad
    result["wgrad"] = {
        "max_abs_err": max(w_err, bi_err, g_err), "ms": wr["ms"], "ms_device": wr["ms_device"],
        "ms_device_fma": wr["ms_device_fma"], "plain_ms": wr["plain_ms"],
        "library_ms": wr["library_ms"], "library_f32_ms": wr["library_f32_ms"],
        "bound_ms": wr["bound_ms"], "bound_by": wr["bound_by"],
        "library": "torch.mm(round(a).t(), round(g), out_dtype=float32) a product on the "
                   "bf16 factors, made outside the timed window; library_f32_ms: torch.mm "
                   "of the same factors widened to f32 (TF32 off)",
        "by_launch": {name: {k: r[k] for k in ("ms", "ms_device", "ms_device_fma", "plain_ms",
                                               "library_ms", "library_f32_ms", "bound_ms",
                                               "splits", "tiles")}
                      for name, r in (("teacher", wr), ("bigru", bi), ("gru", gr))},
        "shape": f"the teacher backward's {len(problems)} products over S*B={S * B} rows, "
                 f"bf16 (tensor cores); by_launch: also the BiGRU's 4 and the GRU's 2 "
                 f"products over T*B=32000 rows",
        "error": "max |kernel - plain| / max |plain| over every product and bias of the "
                 "three backward kernels' launches, f32 (FMA route) and bf16 (tensor cores "
                 "and the FMA route forced)"}
    # d_keys timing at the same shape
    q = (ha.to(dtype).float() @ w.wq.float()).contiguous()
    de = outs[2]
    run = lambda: td.dkeys(keys, q, de, w.v)
    ms = cuda_time_ms(run, reps=5)
    split, _ = _device_split_ms(run, ("dkeys_kernel", "dv_reduce"), reps=3,
                                per_call={"dkeys_kernel": 1, "dv_reduce": 1})
    plain_ms = cuda_time_ms(lambda: td.dkeys_reference(keys, q, de, w.v), reps=1)
    bound = _bound_ms(_nbytes(keys, q, de, w.v) + B * L * A * 4 + A * 4,
                      f32_flops=7 * S * B * L * A)
    result["dkeys"] = {"max_abs_err": dk_worst, "ms": ms, "ms_device": sum(split.values()),
                       "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
                       "shape": f"S={S} B={B} L={L} A={A} bf16 keys",
                       "error": "relative to peak; S=200 B=32 L=192 A=256, f32 and bf16, "
                                "keys and q of randn scale and uniform in [-40, 40]"}
    log(f"[dkeys] S={S} B={B} L={L} A={A} bf16: kernel {ms:.4f} ms a call, device "
        f"{result['dkeys']['ms_device']:.4f} ms ("
        + " + ".join(f"{k} {v:.4f}" for k, v in split.items())
        + f"), plain {plain_ms:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
    return result


# --------------------------------------------------------------------------
# phase 3 (kernel-gated serving): the four kernels behind parallel.use_pallas
# --------------------------------------------------------------------------

# (B, T, D, K, C) of the B=32 batch's two conv banks: the encoder's (prenet
# width 128 in, widths 1..16 of 128 channels) and the post-net's (80 mels
# in, widths 1..8 of 128 channels over 5 * 200 frames)
CONV_BANK_SHAPES = {"encoder": (32, 192, 128, 16, 128), "post-net": (32, 1000, 80, 8, 128)}


def _conv_bank_case(B, T, D, K, C, dtype, seed):
    import torch
    from tacotron_multispeaker_torch.models.modules import _bank_mask
    g = torch.Generator(device="cuda").manual_seed(seed)
    mask = torch.from_numpy(_bank_mask(K, C)).cuda()
    x = torch.randn(B, T, D, generator=g, device="cuda").to(dtype)
    w = (torch.randn(K, D, K * C, generator=g, device="cuda") * (K * D) ** -0.5 * mask)
    b = torch.randn(K * C, generator=g, device="cuda") * 0.1
    return x, w.to(dtype), b.to(dtype)


def _conv_bank_flops(B, T, D, K, C, masked):
    """2·B·T·D times the taps the function needs: Σ_k k·C over the width
    groups with the mask, K·O without it."""
    taps = C * K * (K + 1) // 2 if masked else K * K * C
    return 2 * B * T * D * taps


def phase_conv_bank():
    import torch
    import torch.nn.functional as F
    from tacotron_multispeaker_torch.ops import conv_bank as cb
    from tacotron_multispeaker_torch.ops import cuda_build
    for line in cuda_build.build_info["conv_bank"]["ptxas"].splitlines():
        if any(w in line for w in ("registers", "spill", "smem", "Compiling entry")) \
                and "C7519" not in line:
            log(f"[conv_bank] ptxas: {line.strip()}")
    for label, (B, T, D, K, C) in CONV_BANK_SHAPES.items():
        for Bn, Tn in ((B, T), (1, 96 if label == "encoder" else T)):
            log(f"[conv_bank] {label} B={Bn} T={Tn} D={D} bf16 launch: layout {cb.a_layout(D)}, "
                f"{cb.bf16_plan(Bn, Tn, D, K, K * C)} (dynamic shared memory a block)")
    # f32: the same products summed in another order -> 1e-5 of the peak.
    # bf16: the products are exact in f32; the f32 sum-order difference
    # (the f32 allowance, 1e-5 of the peak) can move the one final rounding
    # by one ulp (at most 2^-7 of the value).  Both with the mask given
    # (bank_channels, as ConvBank calls it) and without.
    worst = 0.0
    for label, (B, T, D, K, C) in CONV_BANK_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            x, w, b = _conv_bank_case(B, T, D, K, C, dtype, seed=K)
            for bc in (C, None):
                with torch.inference_mode():
                    y = cb.conv_bank(x, w, b, bank_channels=bc)
                    ref = cb.conv_bank_reference(x, w, b, bank_channels=bc)
                torch.cuda.synchronize()
                err = _rel_err(y, ref)
                if dtype == torch.float32:
                    ok, tol = err <= 1e-5, "1e-5 of the peak"
                else:
                    peak = ref.float().abs().max().item()
                    ok = bool(((y.float() - ref.float()).abs()
                               <= 2 ** -7 * ref.float().abs() + 1e-5 * peak).all())
                    tol = "one bf16 ulp per element + 1e-5 of the peak"
                log(f"[conv_bank] {label} B={B} T={T} D={D} K={K} O={K * C} "
                    f"{str(dtype)[6:]} bank_channels={bc}: max|kernel-plain|/max|plain| "
                    f"{err:.3e} (tol {tol}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"conv_bank disagrees with its plain version: "
                                         f"{label} {dtype} bank_channels={bc}")
                worst = max(worst, err)
    ms = plain_ms = lib_ms = bound_s = bound_full_s = 0.0
    for label, (B, T, D, K, C) in CONV_BANK_SHAPES.items():
        for Bn in (B, 1):
            for Tn in ((96, 192) if label == "encoder" and Bn == 1 else (T,)):
                x, w, b = _conv_bank_case(Bn, Tn, D, K, C, torch.bfloat16, seed=K + 1)
                xp = F.pad(x.transpose(1, 2), ((K - 1) // 2, K // 2)).contiguous()
                wt = w.permute(2, 1, 0).contiguous()
                run = lambda: cb.conv_bank(x, w, b, bank_channels=C)  # noqa: E731
                with torch.inference_mode():
                    k_ms = cuda_time_ms(run, reps=50, warmup=3)
                    dev_ms = _device_ms(run, 20, "conv_bank")
                    full_ms = cuda_time_ms(lambda: cb.conv_bank(x, w, b), reps=50, warmup=3)
                    l_ms = cuda_time_ms(lambda: F.conv1d(xp, wt, b), reps=50, warmup=3)
                    p_ms = (cuda_time_ms(lambda: cb.conv_bank_reference(x, w, b, C), reps=5)
                            if Bn == B else float("nan"))
                O = K * C
                nbytes = _nbytes(x, w, b) + Bn * Tn * O * 2
                bound = _bound_ms(nbytes, bf16_flops=_conv_bank_flops(Bn, Tn, D, K, C, True))
                bound_full = _bound_ms(nbytes,
                                       bf16_flops=_conv_bank_flops(Bn, Tn, D, K, C, False))
                log(f"[conv_bank] {label} B={Bn} T={Tn} D={D} K={K} O={O} bf16 "
                    f"bank_channels={C}: kernel {k_ms:.4f} ms (device {dev_ms:.4f}), "
                    f"all taps {full_ms:.4f} ms, F.conv1d {l_ms:.4f} ms, plain {p_ms:.3f} ms, "
                    f"bound {bound[0]:.4f} ms ({bound[1]}, nonzero taps; "
                    f"{bound_full[0]:.4f} with every tap), {100 * bound[0] / k_ms:.1f}% of "
                    f"the bound, {'faster' if k_ms < l_ms else 'NOT faster'} than F.conv1d")
                if Bn == B:
                    ms, plain_ms, lib_ms = ms + k_ms, plain_ms + p_ms, lib_ms + l_ms
                    bound_s, bound_full_s = bound_s + bound[0], bound_full_s + bound_full[0]
        if D % 64:
            # the A-operand layout for a D that is not a multiple of 64: the
            # launcher's choice against the other one, same inputs
            x, w, b = _conv_bank_case(B, T, D, K, C, torch.bfloat16, seed=K + 1)
            with torch.inference_mode():
                ref = cb.conv_bank_reference(x, w, b, C)
                times = {}
                for lay in ("narrow", "wide"):
                    y = cb._launch(x, w, b, C, layout=lay)
                    torch.cuda.synchronize()
                    if not torch.equal(y, cb.conv_bank(x, w, b, bank_channels=C)):
                        peak = ref.float().abs().max().item()
                        assert bool(((y.float() - ref.float()).abs()
                                     <= 2 ** -7 * ref.float().abs() + 1e-5 * peak).all()), lay
                    times[lay] = cuda_time_ms(lambda: cb._launch(x, w, b, C, layout=lay),
                                              reps=50, warmup=3)
            log(f"[conv_bank] {label} D={D} A-operand layout: narrow (16-channel boxes, "
                f"32-byte swizzle) {times['narrow']:.4f} ms, wide (64-channel boxes, "
                f"128-byte swizzle, D zero-filled to {-(-D // 64) * 64}) "
                f"{times['wide']:.4f} ms; the launcher takes {cb.a_layout(D)}")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_s, "bound_by": "operations", "bound_all_taps_ms": bound_full_s,
            "shape": "both banks of a B=32 batch as ConvBank calls them (bank_channels=128), "
                     "summed: encoder B=32 T=192 D=128 K=16 O=2048 + post-net B=32 T=1000 "
                     "D=80 K=8 O=1024, bf16; bound on the nonzero taps",
            "error": "max |kernel - plain| / max |plain|, f32 and bf16, with and without "
                     "bank_channels"}


def _attention_case(B, L, A, D, dtype, seed, loc=True):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s, sc=1.0: (torch.randn(*s, generator=g, device="cuda") * sc).to(dtype)
    lengths = torch.randint(1, L + 1, (B,), generator=g, device="cuda")
    lengths[0] = L
    mask = (torch.arange(L, device="cuda")[None, :] < lengths[:, None]).contiguous()
    return (rn(B, L, A, sc=0.5), rn(B, A, sc=0.5), rn(A, sc=A ** -0.5), rn(B, L, D), mask,
            rn(B, L, A, sc=0.3) if loc else None)


def _attention_bound_ms(args, out_floats):
    """Bytes the step must move (memory, q, v, mask, the keys and location
    terms of the unmasked positions only: a masked energy is -1e9 whatever
    its keys hold; the outputs written once) and its f32 operations (three
    a key element, four with the location term, two a context element)."""
    keys, q, v, memory, mask = args[:5]
    loc = args[5] if len(args) > 5 else None
    B, L, A = keys.shape
    on = int(mask.sum().item())
    key_bytes = on * A * keys.element_size() * (2 if loc is not None else 1)
    moved = key_bytes + _nbytes(q, v, memory, mask) + 4 * out_floats
    return _bound_ms(moved, f32_flops=on * (4 if loc is not None else 3) * A
                     + B * L * 2 * memory.shape[-1])


# Dependent phases of a launch of csrc/attention_step.cu: each waits one
# round trip and one DSMEM exchange + cluster barrier (the slabs' arrival
# with the softmax's (m_k, s_k) exchange; the context's reduce-scatter)
ATTENTION_PHASES = 2


def _attention_latency_bound_ms(args, C, coresident, probe):
    """The launch's latency bound (``_cluster_latency_bound_ms`` over one
    step): ATTENTION_PHASES phases; a row's step streams its keys, location
    terms and memory."""
    keys, memory = args[0], args[3]
    loc = args[5] if len(args) > 5 else None
    step_bytes = _nbytes(keys[0], memory[0]) + (0 if loc is None else _nbytes(loc[0]))
    return _cluster_latency_bound_ms(1, keys.shape[0], ATTENTION_PHASES, step_bytes, C,
                                     coresident, probe)


def _attention_sizes(counts, L):
    """None (the plan's C) and every C the card holds at these widths."""
    from tacotron_multispeaker_torch.ops.cluster_plan import CLUSTER_SIZES
    return [None] + [C for C in CLUSTER_SIZES if C <= L and counts[C] > 0]


def _attention_counts(args, partial):
    import torch
    from tacotron_multispeaker_torch.ops import attention_step as ast
    keys, memory = args[0], args[3]
    loc = args[5] if len(args) > 5 else None
    B, L, A = keys.shape
    D = memory.shape[-1]
    return ast.cluster_counts(L, A, D, int(keys.dtype == torch.bfloat16), loc is not None,
                              int(partial), ast.rows_aligned(A, D, keys.element_size()),
                              keys.device)


# launches of each attention case at each C held bit for bit against the
# first: the kernel's sums run in a fixed order, so a launch that differs
# shows a race between its warps or CTAs
ATTENTION_REPEATS = 20


def _attention_repeatable(fn, args, C, first):
    """Whether ATTENTION_REPEATS more launches of ``fn`` at cluster ``C``
    give ``first``, its first launch's outputs, bit for bit."""
    import torch
    for _ in range(ATTENTION_REPEATS):
        got = fn(*args, cluster=C)
        if not all(torch.equal(a, b) for a, b in zip(got, first)):
            return False
    return True


def _attention_timing(tag, fn, args, probe, reps=50):
    """Call ms (CUDA events, back to back), the device ms of a launch
    (profiler) at the plan's C and at every C, the latency bound and its
    share reached, for one shape."""
    from tacotron_multispeaker_torch.ops import attention_step as ast
    ms = cuda_time_ms(lambda: fn(*args), reps=reps)
    dev = _launch_device_ms(lambda: fn(*args), "attention_step", reps=20)
    C, route, coresident = ast.last_plan
    sweep = {}
    for c in _attention_sizes(_attention_counts(args, fn is ast.attention_step_partial),
                              args[0].shape[1])[1:]:
        sweep[c] = round(_launch_device_ms(lambda c=c: fn(*args, cluster=c), "attention_step",
                                           reps=20), 4)
        coresident_c = ast.last_plan[2]
        sweep[c] = (sweep[c], round(_attention_latency_bound_ms(args, c, coresident_c, probe), 5))
    lat = _attention_latency_bound_ms(args, C, coresident, probe)
    log(f"[{tag}] call {ms:.4f} ms back to back (the wrapper's host time bounds it), device "
        f"{dev:.4f} ms a launch at the plan's C={C} ({route}, {coresident} clusters "
        f"co-resident); latency bound {lat:.5f} ms ({100 * lat / dev:.1f} % of it reached); "
        f"by C (device ms, latency bound ms): {json.dumps(sweep)}")
    return ms, dev, C, lat


def phase_attention_step():
    import torch
    from tacotron_multispeaker_torch.ops import attention_step as ast
    # (alignments, context) absolute.  f32: the same arithmetic in another
    # sum order.  bf16: both sides round act after each add and after tanh;
    # CUDA's tanhf and torch's tanh may differ by an f32 ulp, which can flip
    # one bf16 rounding (2^-8 of an act element) and move an energy by
    # ~|v|*2^-8 -> alignments 1e-3, context 1e-2 (|memory| ~ 3)
    tol = {torch.float32: (1e-6, 1e-5), torch.bfloat16: (1e-3, 1e-2)}
    worst = 0.0
    # the serving shapes (B=1 L=96, 192; B=32 L=192), one position, ragged
    # B=3 L=13, rows that are not 16-byte multiples (A=100, D=72: the
    # direct route) and Tacotron 2's (B=32 L=96, 192 A=128 D=768); each at
    # the plan's C and every C the card takes; row 1 of B > 1 fully masked
    cases = [(1, 1, 256, 320), (1, 96, 256, 320), (1, 192, 256, 320), (3, 13, 256, 320),
             (32, 192, 256, 320), (3, 13, 100, 72), (3, 96, 100, 72),
             (32, 96, 128, 768), (32, 192, 128, 768)]
    for ci, (B, L, A, D) in enumerate(cases):
        for loc in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                args = list(_attention_case(B, L, A, D, dtype, seed=31 + ci, loc=loc))
                if B > 1:
                    args[4][1] = False
                ref = ast.attention_step_reference(*args)
                for C in _attention_sizes(_attention_counts(args, False), L):
                    before = ast.direct_launches
                    ctx, al = ast.attention_step(*args, cluster=C)
                    torch.cuda.synchronize()
                    ran, route, _ = ast.last_plan
                    e_al = (al - ref[1]).abs().max().item()
                    e_ctx = (ctx - ref[0]).abs().max().item()
                    ta, tc = tol[dtype]
                    counted = ast.direct_launches - before == (route == "direct")
                    same = _attention_repeatable(ast.attention_step, args, ran, (ctx, al))
                    log(f"[attention_step] B={B} L={L} A={A} D={D} {str(dtype)[6:]} "
                        f"{'with' if loc else 'without'} location term, "
                        f"{'plan' if C is None else 'forced'} C={ran} ({route}): align "
                        f"{e_al:.3e} (tol {ta:.0e}) ctx {e_ctx:.3e} (tol {tc:.0e}); "
                        f"{ATTENTION_REPEATS} more launches bit for bit: {same}")
                    masked_zero = bool(torch.all(al[~args[4]] == 0.0))
                    if B > 1:
                        masked_zero &= bool(torch.all(ctx[1] == 0.0))
                    if not (e_al <= ta and e_ctx <= tc and masked_zero and counted and same):
                        raise AssertionError(f"attention_step disagrees with its plain version "
                                             f"(B={B} L={L} A={A} D={D} C={ran})")
                    worst = max(worst, e_al, e_ctx)
    probe = _latency_probe((16, 8, 4, 2, 1))
    timed = {}
    for label, (B, L) in (("B=32 L=192", (32, 192)), ("B=1 L=96", (1, 96)),
                          ("B=1 L=192", (1, 192))):
        args = _attention_case(B, L, 256, 320, torch.bfloat16, seed=33 + B + L)
        # (args, call ms, device ms, C, latency bound ms)
        timed[label] = (args, *_attention_timing(f"attention_step {label} A=256 D=320 bf16, "
                                                 f"location term", ast.attention_step,
                                                 args, probe))
    args, ms, dev, C, lat = timed["B=32 L=192"]
    B, L, _ = args[0].shape
    plain_ms = cuda_time_ms(lambda: ast.attention_step_reference(*args), reps=10)
    bound = _attention_bound_ms(args, B * (args[3].shape[-1] + L))
    log(f"[attention_step] B=32 L=192 A=256 D=320 bf16 with location term: plain "
        f"{plain_ms:.4f} ms, bound {bound[0]:.5f} ms ({bound[1]})")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "ms_device": dev, "cluster": C, "bound_latency_ms": lat,
            "latency_share": lat / dev, "ms_b1": timed["B=1 L=96"][1],
            "ms_device_b1": timed["B=1 L=96"][2], "cluster_b1": timed["B=1 L=96"][3],
            "ms_device_b1_l192": timed["B=1 L=192"][2],
            "design": "a row over a cluster of C CTAs split along L; slabs by bulk copy; "
                      "(m_k, s_k) and the context exchanged over DSMEM",
            "shape": "B=32 L=192 A=256 D=320 bf16, location term (ms: a call back to back; "
                     "ms_device: a launch)",
            "error": "alignments and context absolute, f32 and bf16, with and without "
                     "the location term, at the plan's C and every C"}


def _device_ms(fn, reps, kernel):
    """Device time a launch of the kernel whose name holds ``kernel``, from
    the profiler over ``reps`` calls of ``fn``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA and kernel in e.name]
    return sum(spans) / len(spans) / 1e3 if spans else float("nan")


def _partial_case(B, L, A, D, dtype, seed, ended=(1, 3)):
    """One L-shard of the sequence-sharded decode: the rows in ``ended``
    end in an earlier shard (fully masked here), the others inside this one
    or past it."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s, sc=1.0: (torch.randn(*s, generator=g, device="cuda") * sc).to(dtype)
    lengths = torch.randint(1, 2 * L, (B,), generator=g, device="cuda")
    lengths[list(ended)] = 0
    mask = (torch.arange(L, device="cuda")[None, :] < lengths[:, None]).contiguous()
    return rn(B, L, A, sc=0.5), rn(B, A, sc=0.5), rn(A, sc=A ** -0.5), rn(B, L, D), mask


def phase_attention_partial():
    """Kernel 10 at the full-width shard of ``shard_seq``: B=8, L/M = 192/4,
    A=256, memory depth D = 256 + 128 (encoder + speaker); and at other
    shapes, each at the plan's C and every C the card takes."""
    import torch
    from tacotron_multispeaker_torch.ops import attention_step as ast
    # absolute, per output.  f32: the same arithmetic in another sum order.
    # bf16: an f32-ulp tanh difference may flip one bf16 rounding of act and
    # move an energy by ~|v|*2^-8 (p, m 1e-3; s sums 48 weights, 1e-2), and
    # the context rounds that weight to bf16 (2^-8 * |memory| ~ 1e-2)
    tol = {torch.float32: {"ctx": 1e-4, "p": 1e-5, "m": 1e-5, "s": 1e-4},
           torch.bfloat16: {"ctx": 2e-2, "p": 1e-3, "m": 1e-3, "s": 1e-2}}
    worst = 0.0
    cases = [(8, 48, 256, 384), (3, 13, 256, 384), (8, 1, 256, 384), (8, 48, 100, 72)]
    for ci, (B, L, A, D) in enumerate(cases):
        ended = (1, 3) if B > 3 else (1,)
        for dtype in (torch.float32, torch.bfloat16):
            args = _partial_case(B, L, A, D, dtype, seed=41 + ci, ended=ended)
            ref = ast.attention_step_partial_reference(*args)
            for C in _attention_sizes(_attention_counts(args, True), L):
                got = ast.attention_step_partial(*args, cluster=C)
                torch.cuda.synchronize()
                ran, route, _ = ast.last_plan
                errs = {n: (a - b).abs().max().item()
                        for n, a, b in zip(("ctx", "p", "m", "s"), got, ref)}
                ctx, p, m, sm = (t[list(ended)] for t in got)
                exact = bool((m == -1e9).all() and (sm == 0).all() and (p == 0).all()
                             and (ctx == 0).all())
                same = _attention_repeatable(ast.attention_step_partial, args, ran, got)
                log(f"[attention_step_partial] B={B} L={L} A={A} D={D} {str(dtype)[6:]} "
                    f"{'plan' if C is None else 'forced'} C={ran} ({route}): "
                    + ", ".join(f"{n} {e:.3e} (tol {tol[dtype][n]:.0e})" for n, e in errs.items())
                    + f"; fully masked rows exact: {exact}; {ATTENTION_REPEATS} more launches "
                    f"bit for bit: {same}")
                if not (exact and same and all(e <= tol[dtype][n] for n, e in errs.items())):
                    raise AssertionError(f"attention_step_partial disagrees with its plain "
                                         f"version (B={B} L={L} A={A} D={D} C={ran})")
                worst = max(worst, *errs.values())
    B, L, A, D = 8, 48, 256, 384
    args = _partial_case(B, L, A, D, torch.float32, seed=42)     # the path's dtype
    probe = _latency_probe((16, 8, 4, 2, 1))
    ms, dev, C, lat = _attention_timing(f"attention_step_partial B={B} L={L} A={A} D={D} f32",
                                        ast.attention_step_partial, args, probe, reps=200)
    plain_ms = cuda_time_ms(lambda: ast.attention_step_partial_reference(*args), reps=50)
    bound = _attention_bound_ms(args, B * (D + L + 2))
    log(f"[attention_step_partial] B={B} L={L} A={A} D={D} f32: plain {plain_ms:.4f} ms, "
        f"bound {bound[0]:.6f} ms ({bound[1]})")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "ms_device": dev, "cluster": C, "bound_latency_ms": lat,
            "latency_share": lat / dev,
            "design": "kernel 9's cluster kernel without the location term or the "
                      "normalisation",
            "shape": f"B={B} L={L} A={A} D={D} f32 (one of 4 L-shards; ms: a call back to "
                     f"back; ms_device: a launch)",
            "error": "ctx_u, p_u, m, s absolute, f32 and bf16, fully masked rows exact, at "
                     "the plan's C and every C"}


def _window(n_fft=2048, win_length=1102):
    import torch
    from tacotron_multispeaker_torch.audio.dsp import hann_window
    return torch.from_numpy(hann_window(win_length, n_fft)).cuda()


def _ola_case(B, F, Wn, prewindowed, dtype, seed):
    """(frames [B, F, Wn] in ``dtype``, window [Wn]) on the card at hop 275:
    the serving window (its 1102-sample support, or centred in 2048 zeros);
    prewindowed frames are randn × window, as the inverse DFT product gives
    them in the window-support layout."""
    import torch
    win = _window(Wn, min(Wn, 1102))
    g = torch.Generator(device="cuda").manual_seed(seed)
    frames = torch.randn(B, F, Wn, generator=g, device="cuda")
    return (frames * win if prewindowed else frames).to(dtype), win


def _ola_library(frames, win, hop):
    """``torch.nn.functional.fold`` of prewindowed frames (the overlap-add)
    followed by one division by the window-square norm, which is made here
    once, outside the call: the library yardstick of the prewindowed
    kernel (no one call windows, overlap-adds and divides)."""
    import torch
    from tacotron_multispeaker_torch.ops.overlap_add import _wsq_norm
    B, F, Wn = frames.shape
    out_len = Wn + hop * (F - 1)
    norm = _wsq_norm(win, F, hop)[:out_len].contiguous()
    cols = frames.transpose(1, 2)
    return lambda: (torch.nn.functional.fold(cols, (1, out_len), (1, Wn), stride=(1, hop))
                    .view(B, out_len) / norm)


OLA_MODES = {"support": (1102, True), "full": (2048, False)}   # Wn, prewindowed


def phase_overlap_add():
    """Kernel 12 in both modes at Griffin-Lim's geometries (hop 275, F=1000
    frames): prewindowed 1102-sample support frames, the layout of
    ``dft_f32``/``dft_hi`` under ``parallel.use_pallas``, and windowed
    2048-sample frames, the TPU kernel's function; every width in both
    modes and dtypes against the plain version, each mode timed at B=32
    and B=1; then the ``serve_location`` Griffin-Lim against its plain
    route."""
    import torch
    from tacotron_multispeaker_torch.audio.dsp import STFTParams, griffin_lim
    from tacotron_multispeaker_torch.ops import overlap_add as ola
    F, hop = 1000, 275
    # window, sums and norm f32 on both sides whatever the frames' type, the
    # same sums in the same order: 1e-5 of the peak (the tolerance of the
    # first design, whose order differed); the per-sample error is printed
    # beside it, since the edges, divided by a norm near the 1e-10 clamp,
    # set the peak
    worst = 0.0
    for Wn in (1102, 2048):
        for prewindowed in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                frames, win = _ola_case(32, F, Wn, prewindowed, dtype, seed=41 + Wn)
                out = ola.overlap_add(frames, win, hop, prewindowed=prewindowed)
                ref = ola.overlap_add_plain(frames, win, hop, prewindowed=prewindowed)
                torch.cuda.synchronize()
                err = _rel_err(out, ref)
                per = ((out - ref).abs() / (1.0 + ref.abs())).max().item()
                unequal = int((out != ref).sum())
                log(f"[overlap_add] B=32 F={F} Wn={Wn} hop={hop} {str(dtype)[6:]} "
                    f"{'prewindowed' if prewindowed else 'windowed'}: max|kernel-plain|/"
                    f"max|plain| {err:.3e} (tol 1e-5), max |d|/(1+|plain|) {per:.3e}, "
                    f"{unequal} of {out.numel()} samples not bit-equal")
                if not (err <= 1e-5 and per <= 1e-5 and torch.isfinite(out).all()):
                    raise AssertionError("overlap_add disagrees with its plain version")
                worst = max(worst, err)
                del frames, out, ref
    res = {}
    for mode, (Wn, prewindowed) in OLA_MODES.items():
        for B in (32, 1):
            frames, win = _ola_case(B, F, Wn, prewindowed, torch.float32, seed=43 + B)
            run = lambda: ola.overlap_add(  # noqa: E731
                frames, win, hop, prewindowed=prewindowed)
            ms = cuda_time_ms(run, reps=50 if B == 1 else 20)
            dev = _launch_device_ms(run, "overlap_add", reps=20 if B == 1 else 5)
            bound = _bound_ms(_nbytes(frames, win) + B * (Wn + hop * (F - 1)) * 4)
            plain_ms = cuda_time_ms(lambda: ola.overlap_add_plain(
                frames, win, hop, prewindowed=prewindowed), reps=5)
            lib = None
            if prewindowed:
                fold = _ola_library(frames, win, hop)
                lib_err = _rel_err(fold(), run())
                if not lib_err <= 1e-5:
                    raise AssertionError(f"fold + division disagrees with the kernel: {lib_err}")
                lib = cuda_time_ms(fold, reps=10)
            res[mode, B] = (ms, dev, bound, plain_ms, lib)
            log(f"[overlap_add] {mode} B={B} F={F} Wn={Wn} hop={hop} f32 "
                f"{'prewindowed' if prewindowed else 'windowed'}: a call back to back "
                f"{ms:.4f} ms, device a launch {dev:.4f} ms ({bound[0] / dev:.1%} of the "
                f"bound), bound {bound[0]:.4f} ms ({bound[1]}), plain {plain_ms:.3f} ms"
                + ("" if lib is None else f", fold + division {lib:.4f} ms"))
            del frames

    # serve_location's Griffin-Lim (dft_f32, 60 iterations, the support
    # layout): the kernel route against the plain one (use_pallas off),
    # both on the card from the same magnitudes and angles.  The kernel's
    # sums are the plain version's, so only a difference that 60 iterations
    # carry could show: held at 1e-3 of the peak, as the card test holds the
    # location path's waveform against the CPU
    params = STFTParams(2048, hop, 1102)
    g = torch.Generator(device="cuda").manual_seed(47)
    mag = torch.randn(2, 1025, 200, generator=g, device="cuda").abs()
    angles = (torch.rand(2, 200, 1025, generator=g, device="cuda") * 2 - 1) * math.pi
    before = ola.launches
    y = griffin_lim(mag, params, 60, method="dft_f32", angles=angles, use_pallas=True)
    n_launch = ola.launches - before
    y_ref = griffin_lim(mag, params, 60, method="dft_f32", angles=angles, use_pallas=False)
    torch.cuda.synchronize()
    gl_err = _rel_err(y, y_ref)
    log(f"[overlap_add] serve_location Griffin-Lim B=2 F=200 dft_f32 60 iterations, kernel "
        f"route vs plain route: max|d|/max|plain| {gl_err:.3e} (tol 1e-3), {n_launch} "
        f"launches (61 expected), bit-equal: {bool(torch.equal(y, y_ref))}")
    if not (gl_err <= 1e-3 and n_launch == 61 and torch.isfinite(y).all()):
        raise AssertionError("serve_location Griffin-Lim: the kernel route disagrees")

    ms, dev, bound, plain_ms, lib = res["support", 32]
    full = res["full", 32]
    return {"max_abs_err": worst, "ms": ms, "ms_device": dev, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib,
            "library": "torch.nn.functional.fold of the prewindowed frames, then one "
                       "division by the window-square norm (made once, outside the call)",
            "ms_b1": res["support", 1][0], "ms_device_b1": res["support", 1][1],
            "bound_b1_ms": res["support", 1][2][0], "library_ms_b1": res["support", 1][4],
            "ms_full": full[0], "ms_device_full": full[1], "bound_full_frame_ms": full[2][0],
            "plain_ms_full": full[3], "ms_device_full_b1": res["full", 1][1],
            "design": "persistent blocks, the window staged once a block in shared memory; "
                      "an item a 512-sample tile of a row, 2 samples a thread 256 apart, the "
                      "frame loop unrolled to ceil(Wn/hop) with every load issued first",
            "shape": f"B=32 F={F} Wn=1102 hop={hop} f32 prewindowed (the support layout; "
                     f"ms: a call back to back, ms_device: a launch; *_full: Wn=2048 windowed)",
            "error": "max |kernel - plain| / max |plain|, both modes, Wn 1102 and 2048, "
                     "f32 and bf16 frames"}


def _gl_case(B, F, seed, n_fft=2048, hop=275, broadband=False, win=None, frame_win=None):
    """A magnitude [B, F, bins] and initial frames [B, F, n_fft] from random
    phases (irfft, overlap-add, re-framing with the window), as Griffin-Lim
    starts.  The magnitude is a harmonic test signal's (f0 from 100 Hz up,
    8 harmonics at 22.05 kHz: most bins near zero), or with ``broadband``
    |randn| in every bin (every bin carries weight in an elementwise check).
    ``win`` defaults to the serving window; the frames are windowed by
    ``frame_win`` (default ``win``).  torch.fft makes this test data only."""
    import math
    import torch
    from tacotron_multispeaker_torch.ops.overlap_add import overlap_add_plain
    win = _window(n_fft) if win is None else win
    g = torch.Generator(device="cuda").manual_seed(seed)
    if broadband:
        mag = torch.randn((B, F, n_fft // 2 + 1), generator=g, device="cuda").abs()
    else:
        t = torch.arange(n_fft + hop * (F - 1), device="cuda") / 22050.0
        f0 = 100.0 + 7.0 * torch.arange(B, device="cuda")[:, None]
        y = sum(torch.sin(2 * math.pi * k * f0 * t) / k for k in range(1, 9))
        mag = torch.fft.rfft(y.unfold(-1, n_fft, hop) * win).abs().float().contiguous()
    phase = (torch.rand(mag.shape, generator=g, device="cuda") * 2 - 1) * math.pi
    sig = overlap_add_plain(torch.fft.irfft(torch.polar(mag, phase), n=n_fft), win, hop)
    wf0 = (sig.unfold(-1, n_fft, hop) * (win if frame_win is None else frame_win)).contiguous()
    return wf0, mag, win


def _spectral_convergence(sre, sim, mag, win, hop):
    """||STFT(y)| - mag| / |mag| of the signal y the spectrum (sre, sim)
    gives (irfft, overlap-add), as Griffin-Lim's output is made."""
    import torch
    from tacotron_multispeaker_torch.ops.overlap_add import overlap_add_plain
    n_fft = win.shape[0]
    y = overlap_add_plain(torch.fft.irfft(torch.complex(sre, sim), n=n_fft), win, hop)
    st = torch.fft.rfft(y.unfold(-1, n_fft, hop) * win).abs()
    return ((st - mag).norm() / mag.norm()).item()


def phase_endpoint():
    """``AudioProcessor.find_endpoints`` (each synthesized row's endpoint, in
    plain PyTorch on the waveform's device) on the card against the CPU's
    answer and the host's ``find_endpoint``, at the two synthesis shapes
    (``vctk`` [32, 275000] at 22.05 kHz, ``pod`` [64, 500000] at 20 kHz:
    rows cut at random, never and from the start), on short rows and with a
    window that is not a multiple of 4; at both shapes a call's host ms (its
    launches), its stream ms, the device ms and count of its kernels from
    the profiler beside the byte bound of one read of the waveform; then the
    waveform's copy home, pageable against pinned, and the first allocation
    of a pinned block against a cached one (each logged)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from tacotron_multispeaker_torch.audio import AudioProcessor
    from tacotron_multispeaker_torch.config import AudioConfig
    g = torch.Generator(device="cuda").manual_seed(24)

    def case(B, N, cut, thr):
        wav = (torch.rand(B, N, generator=g, device="cuda") - 0.5) * (8 * thr)
        return torch.where(torch.arange(N, device="cuda") >= cut[:, None], wav * 0.1, wav)

    # 0.8 s windows at 22.05 and 20 kHz; 0.3 s at 22.05 kHz is 6615, three
    # samples past its four hops
    for tag, sr, sec, B, N in (("vctk", 22050, 0.8, 32, 275000), ("pod", 20000, 0.8, 64, 500000),
                               ("short", 22050, 0.8, 5, 22051),
                               ("window_not_by_4", 22050, 0.3, 8, 90000)):
        ap = AudioProcessor(AudioConfig(sample_rate=sr, min_silence_sec=sec), device="cuda")
        thr = ap.silence()[1]
        cuts = {"random": torch.randint(0, N, (B,), generator=g, device="cuda"),
                "none": torch.full((B,), N, device="cuda"),
                "all": torch.zeros(B, dtype=torch.long, device="cuda")}
        for how, cut in cuts.items():
            wav = case(B, N, cut, thr)
            got = ap.find_endpoints(wav).cpu().tolist()
            host = wav.cpu()
            want = ap.find_endpoints(host).tolist()
            if got != want or got != [ap.find_endpoint(r) for r in host.numpy()]:
                raise AssertionError(f"endpoint {tag} cut={how}: card {got[:8]}, cpu {want[:8]}")
            if tag in ("vctk", "pod") and how != "all":
                run = lambda: ap.find_endpoints(wav)  # noqa: E731
                call = cuda_time_ms(run, reps=20)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(20):
                    run()
                host_ms = (time.perf_counter() - t0) * 1e3 / 20
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        run()
                    torch.cuda.synchronize()
                kernels = [e.time_range.end - e.time_range.start for e in prof.events()
                           if e.device_type == DeviceType.CUDA]
                bound, _ = _bound_ms(_nbytes(wav))
                log(f"[endpoint] {tag} B={B} N={N} cut={how}: a call {host_ms:.4f} ms on "
                    f"the host, {call:.4f} ms on the stream, its {len(kernels) / 5:.0f} "
                    f"kernels {sum(kernels) / 5 / 1e3:.4f} device ms; one read of the "
                    f"waveform's bytes {bound:.4f} ms; rows cut {sum(e < N for e in got)} "
                    f"of {B}")
            del wav, host
        log(f"[endpoint] {tag} B={B} N={N}: card equals the cpu and the host's "
            f"find_endpoint (random, uncut and all-silent rows)")
    for tag, B, N in (("vctk", 32, 275000), ("pod", 64, 500000)):
        wav = torch.zeros(B, N, device="cuda")
        pageable = cuda_time_ms(lambda: wav.cpu(), reps=5)
        host = torch.empty(B, N, pin_memory=True)
        pinned = cuda_time_ms(lambda: host.copy_(wav, non_blocking=True), reps=5)
        del host
        # twice the waveform: a power-of-two size class the caching host
        # allocator holds no block of yet
        t0 = time.perf_counter()
        fresh = torch.empty(2 * B * N, pin_memory=True)
        first_ms = (time.perf_counter() - t0) * 1e3
        del fresh
        t0 = time.perf_counter()
        again = torch.empty(2 * B * N, pin_memory=True)
        cached_ms = (time.perf_counter() - t0) * 1e3
        del again
        gbs = _nbytes(wav) / 1e6
        log(f"[endpoint] {tag} waveform copy home, {gbs:.1f} MB: pageable {pageable:.3f} ms "
            f"({gbs / pageable:.2f} GB/s), pinned {pinned:.3f} ms ({gbs / pinned:.2f} GB/s); "
            f"a new pinned block of twice that {first_ms:.3f} ms, cached {cached_ms:.4f} ms")


GL_KERNELS = ("gl_fwd", "gl_inv", "gl_ola")    # kernel-name stems of csrc/gl_iteration.cu


def _stem_of(name):
    return name.split("<")[0]


def _profile_kernels(fn, reps, stems):
    """{kernel name: (device ms, launches)} over ``reps`` calls of ``fn``
    (after one), from torch.profiler.  A trace can miss launches (seen on
    the first trace after another phase's), so a pass is repeated until two
    in a row hold the same number of device spans and every stem has a span,
    at most four passes, and of the passes that hold every stem the one with
    the most spans is kept.  Raises if no pass holds a span of every stem:
    a device time that was not measured is never reported as 0."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tacotron_multispeaker_torch.tracing import device_busy
    fn()
    torch.cuda.synchronize()
    best, last = (-1, None), None
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        _, n, by_name = device_busy(prof)
        whole = all(any(s in _stem_of(name) for name in by_name) for s in stems)
        if whole and n > best[0]:
            best = (n, by_name)
        if whole and n == last:
            break
        last = n
    if best[1] is None:
        raise AssertionError(f"no profiled pass of four holds a device span of each of {stems}")
    return best[1]


def _device_split_ms(fn, stems, reps=2, per_call=None):
    """Device ms a call of ``fn`` spends in the kernels whose names start
    with each stem (``_profile_kernels`` over ``reps`` calls), and their
    launches a call.  A trace can drop some launches and keep the rest, so
    where ``per_call`` gives a stem's launches a call, its time is its mean
    a launch over the launches the trace holds, times that count."""
    by_name = _profile_kernels(fn, reps, stems)
    split, launches = {}, {}
    for s in stems:
        hits = [(ms, n) for name, (ms, n) in by_name.items() if s in _stem_of(name)]
        ms, n = sum(h[0] for h in hits), sum(h[1] for h in hits)
        if per_call and s in per_call:
            split[s], launches[s] = ms / n * per_call[s], per_call[s]
        else:
            split[s], launches[s] = ms / reps, n // reps
    return split, launches


def _launch_device_ms(fn, stem, reps=3):
    """Device ms of one launch of the kernels whose names start with
    ``stem``: the mean over the launches the trace holds."""
    return _device_split_ms(fn, (stem,), reps, per_call={stem: 1})[0][stem]


def phase_gl_iteration():
    import numpy as np
    import torch
    from tacotron_multispeaker_torch.audio.dsp import STFTParams, griffin_lim
    from tacotron_multispeaker_torch.ops import gl_iteration as gl
    B, F, n_fft, hop = 32, 1000, 2048, 275
    mom = 0.99 / 1.99
    win = _window()
    plan = gl.bf16_plan(win)
    lo, hi = plan["support"]
    log("[gl_iteration] bf16 launch plan: " + "; ".join(
        f"{k} product {plan[k]['tile']}, {plan[k]['warpgroups']} consumer warpgroups, "
        f"{plan[k]['stages']} stages, {plan[k]['smem_bytes']} B of dynamic shared memory "
        "a block" for k in ("forward", "inverse"))
        + f"; serving window hann(1102) in {n_fft}: {int((win != 0).sum())} nonzero "
        f"samples, support [{lo}, {hi}) (rounded out to {gl.K_STEP})")
    # two iterations elementwise on a broadband magnitude (every bin of
    # every output near the same scale, peak ~7x the RMS).  Per output and
    # dtype: (a) the elements off by more than `peak` of the output's peak,
    # at most `share` of them; (b) the norm-wise error ||k-p||/||p|| within
    # `bulk`, which a kernel wrong on one frame of the 32000 already fails
    # (a frame is 3e-5 of the elements, ~8e-3 of the norm).  f32: the same
    # arithmetic in another sum order, amplified where |S| ~ 0: no element
    # past 1e-3 of the peak (worst 2.0e-4 on the H100), norm 1e-5 (1.2e-6).
    # bf16: a flipped rounding turns the phase of a bin where |S| ~ 0
    # (chaotic, as the JAX test says): 5 and 7 of sre's and sim's 3.28e7
    # elements pass the JAX package's 3e-2 of the peak, so at most 1e-6 of
    # them may (32 elements); norm 3e-3 (3.1e-4 on the H100).
    # Three cases: the serving window and frames windowed by it (the
    # serving path's input); the serving window and frames windowed by it
    # plus 0.05, so nonzero outside its support (iteration 1 must read the
    # whole frame: white frames cut to the support have a spectrum 7 % off
    # in norm, 7000x the f32 bulk limit); a window with no zero (the whole
    # frame is the support).  Frames with more weight outside the support
    # put more bins near |a| ~ 0 in iteration 2, where phase flips pass the
    # elementwise limits with every norm-wise error inside its own:
    # unwindowed frames gave 50 and 37 bf16 elements past 3e-2 of the peak
    # (at most 32), and frames windowed by hann + 0.05 one f32 element past
    # 1e-3.
    tol = {torch.float32: (1e-3, 0.0, 1e-5), torch.bfloat16: (3e-2, 1e-6, 3e-3)}
    off_zero = torch.from_numpy(np.hanning(n_fft).astype(np.float32) + 0.05).cuda()
    cases = {"serving window, frames windowed by it": dict(),
             "serving window, frames nonzero outside its support": dict(frame_win=win + 0.05),
             "window without zeros": dict(win=off_zero)}
    worst = 0.0
    for label, kw in cases.items():
        wf0, mag, w = _gl_case(B, F, seed=51, broadband=True, **kw)
        if label == "serving window, frames nonzero outside its support":
            outside = torch.cat([wf0[..., :lo], wf0[..., hi:]], -1)
            assert bool((outside != 0).any()), "the frames must be nonzero outside the support"
        for dtype in (torch.float32, torch.bfloat16):
            w0 = wf0.to(dtype)
            out = gl.gl_fast_iterations(w0, mag, w, hop, 2, mom)
            ref = gl.gl_fast_iterations_reference(w0, mag, w, hop, 2, mom)
            torch.cuda.synchronize()
            names = ("sre", "sim", "pre", "pim")
            peak, share, bulk_tol = tol[dtype]
            errs, over, bulk = {}, {}, {}
            for n, a, b in zip(names, out, ref):
                e = (a - b).abs()
                errs[n] = (e.max() / b.abs().max()).item()
                over[n] = int((e > peak * b.abs().max()).sum())
                bulk[n] = (e.norm() / b.norm()).item()
            n_max = int(share * out[0].numel())
            log(f"[gl_iteration] B={B} F={F} n_fft={n_fft} hop={hop} 2 iterations "
                f"{str(dtype)[6:]}, broadband, {label}: max|kernel-plain|/max|plain| "
                + " ".join(f"{n} {e:.3e}" for n, e in errs.items())
                + f"; elements past {peak:.0e} of the peak "
                + " ".join(f"{n} {c}" for n, c in over.items()) + f" (at most {n_max}); "
                "||kernel-plain||/||plain|| "
                + " ".join(f"{n} {e:.3e}" for n, e in bulk.items()) + f" (tol {bulk_tol:.0e})")
            if not (max(over.values()) <= n_max and max(bulk.values()) <= bulk_tol):
                raise AssertionError(f"gl_iteration disagrees with its plain version: {label}")
            worst = max(worst, *errs.values())
            del out, ref
        del wf0, mag
    # the serving path's 12 fast bf16 iterations on the harmonic signal: the
    # phase estimates of the two diverge in detail, so they are held by what
    # Griffin-Lim minimises, the spectral convergence of the signal each
    # gives: within 10% of each other, and both well below the random-phase
    # start
    wf0, mag, win = _gl_case(B, F, seed=51)
    w0 = wf0.to(torch.bfloat16)
    sc0 = ((torch.fft.rfft(wf0).abs() - mag).norm() / mag.norm()).item()
    out = gl.gl_fast_iterations(w0, mag, win, hop, 12, mom)
    ref = gl.gl_fast_iterations_reference(w0, mag, win, hop, 12, mom)
    sc_k = _spectral_convergence(out[0], out[1], mag, win, hop)
    sc_p = _spectral_convergence(ref[0], ref[1], mag, win, hop)
    log(f"[gl_iteration] B={B} F={F} 12 iterations bf16: spectral convergence kernel "
        f"{sc_k:.4f}, plain {sc_p:.4f} (within 10% of each other), random-phase start "
        f"{sc0:.4f}")
    if not (abs(sc_k - sc_p) <= 0.1 * sc_p and sc_k < 0.5 * sc0):
        raise AssertionError("12 kernel Griffin-Lim iterations do not converge as the plain ones")
    del out, ref
    run = lambda: gl.gl_fast_iterations(w0, mag, win, hop, 12, mom)  # noqa: E731
    ms = cuda_time_ms(run, reps=3)
    split, n_launch = _device_split_ms(run, GL_KERNELS)
    plain_ms = cuda_time_ms(
        lambda: gl.gl_fast_iterations_reference(w0, mag, win, hop, 12, mom), reps=1)
    # 12 forward DFT pairs and 11 inverse ones (the last iteration's frames
    # are not needed), each pair 2 products of 2·F·n_fft·bins operations;
    # these frames are zero outside the window, so the work the data needs
    # is each product over the window's nonzero samples; the full-frame
    # bound beside it
    bins = n_fft // 2 + 1
    nnz = int((win != 0).sum())
    io_bytes = _nbytes(w0, mag, win) + 4 * B * F * bins * 4
    bound = _bound_ms(io_bytes, bf16_flops=(2 * 12 - 1) * 4 * B * F * nnz * bins)
    bound_full = _bound_ms(io_bytes, bf16_flops=(2 * 12 - 1) * 4 * B * F * n_fft * bins)
    # the default route (use_pallas=False): 12 bf16 iterations as cuBLAS
    # products in the window-support layout, from the same magnitude
    angles = torch.rand(mag.shape, generator=torch.Generator(device="cuda").manual_seed(53),
                        device="cuda") * 2 * np.pi - np.pi
    params = STFTParams(n_fft, hop, 1102)
    magT = mag.transpose(1, 2)
    cublas_ms = cuda_time_ms(lambda: griffin_lim(magT, params, 12, method="dft_bf16",
                                                 momentum=0.99, angles=angles), reps=3)
    w1, m1, _ = _gl_case(1, F, seed=52)
    w1 = w1.to(torch.bfloat16)
    run1 = lambda: gl.gl_fast_iterations(w1, m1, win, hop, 12, mom)  # noqa: E731
    ms1 = cuda_time_ms(run1, reps=5)
    split1, _ = _device_split_ms(run1, GL_KERNELS)
    log(f"[gl_iteration] B={B} F={F} n_fft={n_fft} hop={hop} 12 iterations bf16: kernel "
        f"{ms:.3f} ms (device: " + ", ".join(f"{s} {split[s]:.3f} x{n_launch[s]}"
                                              for s in GL_KERNELS)
        + f"), plain {plain_ms:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]}, the window's "
        f"{nnz} nonzero samples), full-frame bound {bound_full[0]:.4f} ms; cuBLAS route "
        f"(griffin_lim dft_bf16, use_pallas=False, 12 iterations with its two overlap-adds) "
        f"{cublas_ms:.3f} ms; B=1: kernel {ms1:.3f} ms (device: "
        + ", ".join(f"{s} {split1[s]:.3f}" for s in GL_KERNELS) + ")")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "bound_full_frame_ms": bound_full[0],
            "cublas_route_ms": cublas_ms,
            "shape": f"B={B} F={F} n_fft={n_fft} hop={hop}, 12 iterations, bf16",
            "error": "max |kernel - plain| / max |plain| over sre/sim/pre/pim after 2 "
                     "iterations on a broadband magnitude, f32 and bf16, three windows/frames "
                     "(held by the share of elements past the limit and the norm-wise error); "
                     "12 iterations by spectral convergence"}


# --------------------------------------------------------------------------
# phase 7: training
# --------------------------------------------------------------------------

def _train_batch(cfg, B, L, T, seed, device):
    """A batch in the Feeder's layout on ``device``: inputs [B, L] (ids past
    each length zero), input_lengths, mel_targets [B, T, M] and
    linear_targets [B, T, num_freq] in [0, 1], target_lengths (multiples of
    r), speaker_ids; row 0 has both full lengths."""
    import numpy as np
    import torch
    rs = np.random.RandomState(seed)
    r = cfg.model.outputs_per_step
    in_len = np.r_[L, rs.randint(L // 4, L + 1, B - 1)]
    tg_len = np.r_[T, r * rs.randint(T // (4 * r), T // r + 1, B - 1)]
    inputs = rs.randint(2, 60, (B, L)) * (np.arange(L)[None] < in_len[:, None])
    g = torch.Generator(device=device).manual_seed(seed)
    mel = torch.rand((B, T, cfg.audio.num_mels), generator=g, device=device)
    lin = torch.rand((B, T, cfg.audio.num_freq), generator=g, device=device)
    spk = rs.randint(0, cfg.model.num_speakers, B)
    t = lambda a: torch.as_tensor(a, dtype=torch.long, device=device)
    return t(inputs), t(in_len), mel, lin, t(tg_len), t(spk)


def phase_train_reference(extra="", tag="train f32"):
    """One f32 step (dropout off) at full width on the card against the same
    step on the CPU plain path, from the same weights and batch; ``extra``:
    more overrides (a path of its own).  Returns {device: train state} and
    the card step's launches."""
    import torch
    from tacotron_multispeaker_torch import training
    from tacotron_multispeaker_torch.config import get_config
    cfg = get_config("multispeaker_vctk", ",".join(
        o for o in ("model.compute_dtype=float32,model.prenet_dropout=0.0", extra) if o))
    batch = _train_batch(cfg, B=2, L=23, T=40, seed=3, device="cpu")
    runs, states = {}, {}
    for dev in ("cpu", "cuda"):
        model, state = training.create_train_state(cfg, seed=1, device=dev)
        step = training.make_train_step(cfg, model)
        if dev == "cuda":
            reset_counts()
        state, m = step(state, *(a.to(dev) for a in batch))
        torch.cuda.synchronize()
        states[dev] = state
        runs[dev] = ({k: float(m[k]) for k in ("loss", "grad_norm")},
                     {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                     {n: b.detach().cpu() for n, b in model.named_buffers()
                      if n.endswith((".mean", ".var"))},
                     {n: p.detach().cpu() for n, p in model.named_parameters()})
    launches = read_counts()
    want = train_launches(cfg)
    if launches != want:
        raise AssertionError(f"{tag} step on the card: launches {launches}, expected {want}")
    (mc, gc, bc, pc), (mg, gg, bg, pg) = runs["cpu"], runs["cuda"]
    # loss/grad norm: f32 sums in other orders (cuBLAS, cuDNN without TF32,
    # the kernels) -> 1e-5 / 1e-4 relative.  Gradient leaves (clipped by
    # each side's own norm): 1e-3 of the leaf's peak, floored at 1e-3 of the
    # largest gradient (leaves that are zero in exact arithmetic hold noise).
    # Running statistics 1e-5 relative.  Parameters after the update: Adam
    # moves each by about lr (5e-7 here), so 1e-6 absolute.
    errs = {"loss": abs(mg["loss"] - mc["loss"]) / abs(mc["loss"]),
            "grad_norm": abs(mg["grad_norm"] - mc["grad_norm"]) / mc["grad_norm"]}
    peak = max(g.abs().max().item() for g in gc.values())
    floor = 1e-3 * peak
    g_err = max(((gg[n] - gc[n]).abs().max() / max(gc[n].abs().max().item(), floor)).item()
                for n in gc)
    b_err = max(_rel_err(bg[n], bc[n]) for n in bc)
    p_err = max((pg[n] - pc[n]).abs().max().item() for n in pc)
    log(f"[{tag}] multispeaker_vctk{' ' + extra if extra else ''} B=2 L=23 T=40, card vs "
        f"cpu plain path: loss "
        f"{mc['loss']:.6f} vs {mg['loss']:.6f} (rel {errs['loss']:.2e}, tol 1e-5), grad_norm "
        f"{mc['grad_norm']:.6f} vs {mg['grad_norm']:.6f} (rel {errs['grad_norm']:.2e}, tol "
        f"1e-4), worst gradient leaf {g_err:.2e} (tol 1e-3) over {len(gc)} leaves, running "
        f"stats {b_err:.2e} (tol 1e-5) over {len(bc)}, params after update {p_err:.2e} "
        f"(abs, tol 1e-6); launches on the card {json.dumps(launches)}")
    if not (errs["loss"] <= 1e-5 and errs["grad_norm"] <= 1e-4 and g_err <= 1e-3
            and b_err <= 1e-5 and p_err <= 1e-6):
        raise AssertionError(f"the {tag} step on the card disagrees with the CPU")
    return states, launches


def phase_train_bf16():
    """Three bf16 steps (dropout on, the same masks) at full width with the
    kernels against the same run with their plain versions swapped in."""
    import torch
    from tacotron_multispeaker_torch import training
    from tacotron_multispeaker_torch.config import get_config
    cfg = get_config("multispeaker_vctk")
    batch = _train_batch(cfg, B=4, L=48, T=60, seed=4, device="cuda")
    runs = []
    for plain in (False, True):
        model, state = training.create_train_state(cfg, seed=2)
        step = training.make_train_step(cfg, model)
        metrics = []
        with plain_kernels() if plain else contextlib.nullcontext():
            for _ in range(3):
                state, m = step(state, *batch)
                metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
                if not metrics[1:]:
                    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        torch.cuda.synchronize()
        runs.append((metrics, grads))
    (mk, gk), (mp, gp) = runs
    # bf16: both sides round the same matmul inputs, but a sum landing on a
    # rounding boundary in one order flips one bf16 ulp (2^-8) that the
    # recurrences and the BatchNorms carry.  Loss and grad norm: 2e-2
    # relative per step.  First-step gradients: the training-mode BatchNorm
    # backward subtracts batch means (sums that cancel) and ReLU masks flip
    # where a pre-activation sits near 0, which turns the kernels' ~1e-3
    # differences into ~2e-2 of the tree (measured on the card: 2.02e-2):
    # the whole tree's relative L2 distance 5e-2; each leaf 0.25 of its peak
    # (floored at 1e-2 of the largest gradient: leaves that are zero in
    # exact arithmetic hold noise).  A leaf wired to the wrong gradient is an
    # O(1) error; the float32 step above holds every leaf to 1e-3.
    peak = max(g.abs().max().item() for g in gp.values())
    leaf = {n: ((gk[n].float() - gp[n].float()).abs().max()
                / max(gp[n].abs().max().item(), 1e-2 * peak)).item() for n in gp}
    l2 = (sum(((gk[n].float() - gp[n].float()) ** 2).sum().item() for n in gp)
          / sum((gp[n].float() ** 2).sum().item() for n in gp)) ** 0.5
    worst_leaves = sorted(leaf.items(), key=lambda kv: -kv[1])[:3]
    share = {n: ((gk[n].float() - gp[n].float()) ** 2).sum().item() for n in gp}
    top_share = sorted(share.items(), key=lambda kv: -kv[1])[:3]
    total_sq = max(sum(share.values()), 1e-30)
    rel = lambda a, b: abs(a - b) / abs(b)
    worst = max(max(rel(a[k], b[k]) for k in a) for a, b in zip(mk, mp))
    for n, (a, b) in enumerate(zip(mk, mp)):
        log(f"[train bf16] step {n}: kernels loss {a['loss']:.6f} grad_norm "
            f"{a['grad_norm']:.6f}; plain versions loss {b['loss']:.6f} grad_norm "
            f"{b['grad_norm']:.6f}")
    log(f"[train bf16] multispeaker_vctk B=4 L=48 T=60, kernels vs plain versions on the "
        f"card: worst metric {worst:.2e} (tol 2e-2); first-step gradients: relative L2 "
        f"{l2:.2e} (tol 5e-2; largest shares of it "
        + ", ".join(f"{n} {s / total_sq:.2f}" for n, s in top_share) + "), worst leaves "
        + ", ".join(f"{n} {e:.2e}" for n, e in worst_leaves) + " (tol 0.25)")
    if not (worst <= 2e-2 and l2 <= 5e-2 and worst_leaves[0][1] <= 0.25):
        raise AssertionError("bf16 train steps disagree with their plain versions")


TRAIN_LAUNCHES = {"bigru_scan": 2, "bigru_scan_fma": 0, "decoder_loop": 0,
                  "bigru_scan_bwd": 2, "bigru_scan_bwd_remat": 2, "gru_scan": 0,
                  "gru_scan_fma": 0, "gru_scan_bwd": 0, "gru_scan_bwd_remat": 0,
                  "teacher_decoder_fwd": 1, "dkeys": 1, "teacher_decoder_bwd": 1,
                  "teacher_decoder_bwd_remat": 1,
                  "wgrad": 3, "wgrad_fma": 0, "conv_bank": 0, "attention_step": 0,
                  "attention_step_partial": 0, "attention_step_direct": 0,
                  "attention_step_partial_direct": 0, "overlap_add": 0, "gl_iteration": 0}



def train_launches(cfg):
    """Each kernel's launches in one train step of ``cfg`` (``TRAIN_LAUNCHES``
    is the bf16 Bahdanau step's): f32 runs the BiGRU forward and the
    weight gradients on their FMA routes; location attention trains through
    the per-step loop, without the teacher-decoder kernels (6, 7, 8) and
    their weight-gradient launch."""
    want = dict(TRAIN_LAUNCHES)
    if cfg.model.attention_type == "location":
        want.update(teacher_decoder_fwd=0, dkeys=0, teacher_decoder_bwd=0,
                    teacher_decoder_bwd_remat=0, wgrad=want["wgrad"] - 1)
    if cfg.model.compute_dtype == "float32":
        want.update(bigru_scan=0, bigru_scan_fma=want["bigru_scan"], wgrad=0,
                    wgrad_fma=want["wgrad"])
    return want


def phase_train():
    """Five timed train steps at full width: multispeaker_vctk, B=32,
    L=192, T=1000, bf16, random weights from seed 0."""
    import math
    import torch
    from tacotron_multispeaker_torch import training
    from tacotron_multispeaker_torch.config import get_config
    cfg = get_config("multispeaker_vctk")
    B, L, T = 32, 192, 1000
    model, state = training.create_train_state(cfg, seed=0)
    step = training.make_train_step(cfg, model)
    batch = _train_batch(cfg, B, L, T, seed=5, device="cuda")
    before_params = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = []
    for n in range(5):
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, *batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        times.append(dt)
        got = {k: v - before[k] for k, v in read_counts().items()}
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        log(f"[train] step {n}: {dt * 1e3:.2f} ms, {B / dt:.2f} examples/s, "
            f"{B * T / dt:.0f} mel frames/s ({B * T // cfg.model.outputs_per_step / dt:.0f} "
            f"decoder steps/s), loss {loss:.6f}, grad_norm {gn:.6f}, lr {m['lr']:.3e}, "
            f"launches {json.dumps(got)}")
        if got != TRAIN_LAUNCHES:
            raise AssertionError(f"train step {n}: launches {got}, expected {TRAIN_LAUNCHES}")
        if not (math.isfinite(loss) and math.isfinite(gn)):
            raise AssertionError(f"train step {n}: loss {loss}, grad_norm {gn}")
    total = read_counts()
    unchanged = [n for n, p in model.named_parameters()
                 if p.grad is not None and p.grad.abs().max().item() > 0
                 and torch.equal(p.detach(), before_params[n])]
    n_params = sum(1 for _ in model.parameters())
    log(f"[train] {n_params} parameters, {len(unchanged)} with a gradient left unchanged; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if unchanged:
        raise AssertionError(f"parameters with a gradient did not change: {unchanged[:5]}")
    steady = sorted(times[1:])[len(times[1:]) // 2]
    log(f"[train] multispeaker_vctk B={B} L={L} T={T} bf16: median of steps 1-4 "
        f"{steady * 1e3:.2f} ms ({B / steady:.2f} examples/s); launches over the five steps "
        f"{json.dumps(total)}")
    phase_profile([(f"train step B={B} L={L} T={T}", lambda: step(state, *batch))])
    return total, steady


# --------------------------------------------------------------------------
# phase 7b: the trainer through its own entry points
# --------------------------------------------------------------------------

LOOP_OVERRIDES = "train.checkpoint_interval=10"
LOOP_STEPS, LOOP_RESUME, LOOP_TIMED, LOOP_PROFILED = 12, 14, 20, 4
LOOP_WORKERS = 4
# the timed windows of the loop after the Feeder's: (label, pipeline,
# worker processes, overrides)
LOOP_VARIANTS = (("grain, 4 workers, f32 targets", "grain", LOOP_WORKERS, ""),
                 ("grain, 4 workers, bf16 targets", "grain", LOOP_WORKERS,
                  "train.targets_dtype=bfloat16"),
                 ("grain, 4 workers, PCM targets", "grain", LOOP_WORKERS,
                  "train.targets_from_wav=true"))


def _loop_corpus(base, cfg):
    """A synthetic corpus (64 utterances, 64 speaker ids, 12-30 words) that
    the port's ``make_corpus`` writes and its ``preprocess`` featurises on
    the card, the int16 PCM kept: (data dir, metadata rows, seconds to
    make, seconds to featurise)."""
    import torch
    from tacotron_multispeaker_torch.data import preprocess, synthetic
    t0 = time.perf_counter()
    raw = synthetic.make_corpus(os.path.join(base, "raw"), n_utts=64, n_speakers=64,
                                sample_rate=cfg.audio.sample_rate, seed=5,
                                min_words=12, max_words=30)
    t1 = time.perf_counter()
    data = os.path.join(base, "training")
    rows = preprocess.CORPORA["generic"](raw, data, cfg.audio, keep_wavs=True)
    preprocess.write_metadata(rows, data, cfg.audio)
    torch.cuda.synchronize()
    return data, rows, t1 - t0, time.perf_counter() - t1


def _loop_window(log_dir, data, overrides, start, end, **train_kw):
    """``train_loop.train`` at full-width ``multispeaker_vctk`` (B=32) from
    step ``start`` (a checkpoint in ``log_dir``, or 0) to ``end``: the
    loop's own cadence (a loss read every 32 steps and at steps 1-5), no
    checkpoint inside, the last ``LOOP_PROFILED`` steps profiled; launches
    exactly ``TRAIN_LAUNCHES`` a step and a finite loss.  Returns (ms a
    step over the steps after the first two and after step 6, before the
    profiled ones; the profile summary)."""
    import math
    from tacotron_multispeaker_torch import train_loop
    from tacotron_multispeaker_torch.config import get_config
    cfg = get_config("multispeaker_vctk", ",".join(
        o for o in ("train.checkpoint_interval=100000", overrides) if o))
    reset_counts()
    out = train_loop.train(log_dir, data, cfg, max_steps=end,
                           profile_steps=(end - LOOP_PROFILED, end), **train_kw)
    got = read_counts()
    want = {k: (end - start) * v for k, v in TRAIN_LAUNCHES.items()}
    if got != want:
        raise AssertionError(f"timed loop launches {got}, expected {want}")
    if not (out["step"] == end and math.isfinite(out["loss"])
            and math.isfinite(out["grad_norm"])):
        raise AssertionError(f"timed loop to step {end}: {out}")
    steady = sorted(dt * 1e3 for step, dt in out["step_seconds"]
                    if max(start + 2, 6) < step <= end - LOOP_PROFILED)
    prof = dict(out["profile"], step_ms=(steady[0], steady[len(steady) // 2], steady[-1]))
    return sum(steady) / len(steady), prof


def _window_line(label, ms, prof, bare_step_s):
    lo, mid, hi = prof["step_ms"]
    return (f"[train_loop] {label}: {ms:.2f} ms a step (min {lo:.2f}, median {mid:.2f}, max "
            f"{hi:.2f}; {32e3 / ms:.2f} examples/s), phase "
            f"7's bare step (B=32 L=192 T=1000) {bare_step_s * 1e3:.2f} ms; profiled steps "
            f"{prof['steps'][0] + 1}-{prof['steps'][1]} (profiler on): wall "
            f"{prof['wall_ms']:.2f} ms, device busy {prof['device_busy_ms']:.2f} ms, idle share "
            f"{prof['idle_share']:.3f}, {prof['device_spans']} device spans, top device time "
            + ", ".join(f"{n} {ms:.2f}" for n, ms in prof["top"]))


def _batches_equal(a, b) -> bool:
    import numpy as np
    import torch
    host = lambda x: x.numpy() if isinstance(x, torch.Tensor) else x
    return all(np.array_equal(host(getattr(a, f)), host(getattr(b, f)))
               for f in ("inputs", "input_lengths", "mel_targets", "linear_targets",
                         "target_lengths", "speaker_ids"))


def _run_cli(base, name, extra):
    """``python -m tacotron_multispeaker_torch.train --max_steps 2`` in a
    subprocess: exit 0, a checkpoint at 2, two finite losses."""
    import math
    from tacotron_multispeaker_torch.utils.checkpoint import CheckpointManager
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tacotron_multispeaker_torch.train", "--base_dir", base,
         "--input", "training", "--preset", "multispeaker_vctk", "--name", name,
         "--max_steps", "2", "--hparams", LOOP_OVERRIDES, *extra],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    cli = os.path.join(base, f"logs-{name}")
    steps = (CheckpointManager(os.path.join(cli, "checkpoints")).steps()
             if os.path.isdir(os.path.join(cli, "checkpoints")) else [])
    losses = ([json.loads(line)["loss"] for line in open(os.path.join(cli, "metrics.jsonl"))]
              if os.path.exists(os.path.join(cli, "metrics.jsonl")) else [])
    log(f"[train_loop] python -m tacotron_multispeaker_torch.train --max_steps 2 "
        f"{' '.join(extra)}: exit {proc.returncode} in {time.perf_counter() - t0:.2f} s, "
        f"checkpoints {steps}, losses {losses}")
    if not (proc.returncode == 0 and steps == [2] and len(losses) == 2
            and all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"the train entry point failed:\n{proc.stdout[-3000:]}"
                             f"\n{proc.stderr[-3000:]}")


def phase_train_loop(bare_step_s, base):
    """``train_loop.train`` at full-width ``multispeaker_vctk`` (B=32) on
    ``_loop_corpus``: 12 steps with a checkpoint and eval at step 10
    (finite losses, checkpoints at 10 and 12, the eval WAV, every launch:
    12 steps' ``TRAIN_LAUNCHES`` plus one ``serve`` request's), a resume to
    step 14, and a timed and profiled resume to 34 (``_loop_window``) on
    the Feeder, then again on each of ``LOOP_VARIANTS`` (the grain loader
    with 4 worker processes; f32, bf16 and PCM targets) from the same
    checkpoint.  The parts of a loop step timed apart: the native
    assembler (asserted to build, its batches bit-equal to the numpy
    path's) against the numpy path, the loader's batches a second at 0 and
    4 workers, the copy to the card from pinned and from pageable memory,
    the PCM targets' derivation on the card, and steps fed from batches
    made beforehand.  The targets ``derive_wav_targets`` computes on the
    card against the offline features (max < 0.01, 90th percentile <
    2e-4).  Two ``python -m tacotron_multispeaker_torch.train --max_steps
    2`` subprocesses, the second with ``--pipeline grain
    --pipeline_workers 2``.  The corpus stays in ``base`` for phase 9.
    Returns the launches of the 12-step run."""
    import math
    import shutil
    import numpy as np
    import torch
    from scipy.io import wavfile
    from tacotron_multispeaker_torch import train_loop
    from tacotron_multispeaker_torch.config import get_config
    from tacotron_multispeaker_torch.data import native_batcher, preprocess
    from tacotron_multispeaker_torch.data.feeder import Feeder, pinned_empty
    from tacotron_multispeaker_torch.data.grain_pipeline import grain_global_batches
    from tacotron_multispeaker_torch.training import (create_train_state, derive_wav_targets,
                                                      make_train_step)
    from tacotron_multispeaker_torch.utils.checkpoint import CheckpointManager

    cfg = get_config("multispeaker_vctk", LOOP_OVERRIDES)
    data, rows, make_s, feat_s = _loop_corpus(base, cfg)
    plan = Feeder(data, cfg).epoch_plan(0)
    frames = sorted(r[2] for r in rows)
    log(f"[train_loop] corpus: 64 utterances, {frames[0]}-{frames[-1]} frames, made in "
        f"{make_s:.2f} s, featurised on the card in {feat_s:.2f} s (PCM kept); epoch 0 "
        f"batches (L, T): {[(e[3], e[4]) for e in plan]}")

    log_dir = os.path.join(base, "logs")
    reset_counts()
    t0 = time.perf_counter()
    os.environ["TACOTRON_TB"] = "1"
    try:
        out = train_loop.train(log_dir, data, cfg, max_steps=LOOP_STEPS)
    finally:
        del os.environ["TACOTRON_TB"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total = read_counts()
    want = {k: LOOP_STEPS * v for k, v in TRAIN_LAUNCHES.items()}
    for k, v in path_launches("serve", cfg, cfg.model.max_iters).items():
        want[k] += v                                 # the eval request at step 10
    if total != want:
        raise AssertionError(f"train loop launches {total}, expected {want}")
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        summaries = [json.loads(line) for line in f]
    ckpts = CheckpointManager(os.path.join(log_dir, "checkpoints")).steps()
    wav = os.path.join(log_dir, "step-10-audio.wav")
    rate, pcm = wavfile.read(wav)
    eval_log = [line.strip() for line in open(os.path.join(log_dir, "train.log"))
                if "eval artifact" in line]
    log(f"[train_loop] multispeaker_vctk B=32, {LOOP_STEPS} steps in {wall:.2f} s "
        f"(setup included): losses " + ", ".join(f"{r['step']}: {r['loss']:.5f}"
                                                 for r in summaries)
        + f"; checkpoints {ckpts}; eval WAV {pcm.shape[0]} samples at {rate} Hz; "
        f"{eval_log}; launches {json.dumps(total)}")
    if not (out["step"] == LOOP_STEPS and ckpts == [10, LOOP_STEPS]
            and [r["step"] for r in summaries] == [1, 2, 3, 4, 5]
            and all(math.isfinite(r["loss"]) for r in summaries)
            and math.isfinite(out["loss"])
            and rate == cfg.audio.sample_rate and pcm.shape[0] > 0
            and eval_log and "wrote" in eval_log[-1]):
        raise AssertionError("the train loop's run is wrong (see the line above)")
    _check_tensorboard(log_dir, range(1, 6), 10)

    out = train_loop.train(log_dir, data, cfg, max_steps=LOOP_RESUME)
    resumed = [line.strip() for line in open(os.path.join(log_dir, "train.log"))
               if "resumed from checkpoint" in line]
    ckpts = CheckpointManager(os.path.join(log_dir, "checkpoints")).steps()
    log(f"[train_loop] resume to {LOOP_RESUME}: {resumed}; checkpoints {ckpts}; loss "
        f"{out['loss']:.5f}")
    if not (resumed and resumed[-1].endswith(f"step {LOOP_STEPS}")
            and out["step"] == LOOP_RESUME and ckpts == [10, LOOP_STEPS, LOOP_RESUME]):
        raise AssertionError("the resume did not continue from step 12")
    resume_ckpt = CheckpointManager(os.path.join(log_dir, "checkpoints")).path(LOOP_RESUME)

    # timed: the Feeder, then each variant from the same checkpoint
    end = LOOP_RESUME + LOOP_TIMED
    loop_ms, prof = _loop_window(log_dir, data, "", LOOP_RESUME, end)
    log(_window_line(f"Feeder, steps {LOOP_RESUME + 3}-{end - LOOP_PROFILED}", loop_ms,
                     prof, bare_step_s))
    for n, (label, pipeline, workers, ov) in enumerate(LOOP_VARIANTS):
        vdir = os.path.join(base, f"logs-v{n}")
        os.makedirs(os.path.join(vdir, "checkpoints"))
        shutil.copy(resume_ckpt, os.path.join(vdir, "checkpoints"))
        ms, vprof = _loop_window(vdir, data, ov, LOOP_RESUME, end, pipeline=pipeline,
                                 pipeline_workers=workers)
        log(_window_line(f"{label}, steps {LOOP_RESUME + 3}-{end - LOOP_PROFILED}", ms,
                         vprof, bare_step_s))

    # where the loop's step goes.  The native assembler: it must build
    # here (a failed g++ build fails the run), and its batches equal
    # the numpy path's bit for bit
    feeder = Feeder(data, cfg)
    numpy_feeder = Feeder(data, cfg, use_native=False)
    if not feeder.use_native:
        raise AssertionError(f"the native batch assembler did not build: "
                             f"{native_batcher.build_error()}")
    same = [_batches_equal(feeder.materialize(e), numpy_feeder.materialize(e))
            for e in plan]
    log(f"[train_loop] native assembler batches equal to the numpy path's, bit for bit: "
        f"{same} (epoch 0's {len(plan)} batches)")
    if not all(same):
        raise AssertionError("the native assembler's batches differ from the numpy path's")
    timed = {}
    for name, f in (("native", feeder), ("numpy", numpy_feeder),
                    ("native into pinned memory", Feeder(data, cfg, empty=pinned_empty))):
        t0 = time.perf_counter()
        host = [f.materialize(e) for e in plan * 2]
        timed[name] = ((time.perf_counter() - t0) * 1e3 / len(host), host)
    log("[train_loop] Feeder.materialize a B=32 batch: " + ", ".join(
        f"{k} {ms:.2f} ms" for k, (ms, _) in timed.items()))
    rates = []
    for workers in (0, LOOP_WORKERS):
        t0 = time.perf_counter()
        stream = grain_global_batches(data, cfg, worker_count=workers, pin_memory=True,
                                      timeout=600)
        try:
            next(stream)
            t1 = time.perf_counter()
            warm = 2 * max(workers, 1)           # every worker's first batches
            for _ in range(warm):
                next(stream)
            t2 = time.perf_counter()
            n_batches = 16
            for _ in range(n_batches):
                next(stream)
            t3 = time.perf_counter()
        finally:
            stream.close()
        rates.append(f"{workers} workers {n_batches / (t3 - t2):.2f} batches/s (first "
                     f"batch, startup included, {t1 - t0:.2f} s; the next {warm} "
                     f"{t2 - t1:.2f} s)")
    log("[train_loop] the grain loader alone, pinned batches: " + "; ".join(rates))
    copy_ms = {}
    for name, key, non_blocking in (("pageable", "native", False),
                                    ("pinned", "native into pinned memory", True)):
        dts = []
        for hb in timed[key][1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_loop.batch_to_device(hb, "cuda", non_blocking=non_blocking)
            torch.cuda.synchronize()
            dts.append((time.perf_counter() - t0) * 1e3)
        copy_ms[name] = sum(dts) / len(dts)
    host = timed["native"][1]
    nbytes = sum(hb.mel_targets.nbytes + hb.linear_targets.nbytes for hb in host) / len(host)
    log(f"[train_loop] the copy to the card alone, {nbytes / 1e6:.1f} MB of targets a "
        f"batch: pageable {copy_ms['pageable']:.2f} ms, pinned {copy_ms['pinned']:.2f} ms "
        f"({nbytes / copy_ms['pinned'] / 1e6:.2f} GB/s)")

    # the PCM targets: derived on the card against the offline features
    # of the same utterances (the JAX gate: max < 0.01, 90th pct < 2e-4)
    # on every frame whose window lies inside its utterance; the last
    # few frames of each see the batch's zero padding where the offline
    # analysis reflects the utterance, and are reported apart
    wcfg = get_config("multispeaker_vctk", "train.targets_from_wav=true")
    pb = Feeder(data, wcfg).materialize(plan[0])
    pcm_dev = torch.as_tensor(pb.mel_targets).cuda()
    mel, lin = derive_wav_targets(pcm_dev, wcfg)
    derive_ms = cuda_time_ms(lambda: derive_wav_targets(pcm_dev, wcfg), reps=5)
    ref = numpy_feeder.materialize(plan[0])
    a = wcfg.audio
    reach = (a.n_fft - a.win_length) // 2 - a.n_fft // 2 + a.win_length
    diffs = {"mel": [], "linear": []}
    tails = {"mel": [0.0], "linear": [0.0]}
    for b, i in enumerate(plan[0][2]):
        n = int(ref.target_lengths[b])
        samples = np.load(os.path.join(data, preprocess.wav_file_for(feeder.meta[i]))).shape[0]
        inside = min(n, max(0, (samples - reach) // a.hop_length + 1))
        for name, got, want in (("mel", mel, ref.mel_targets), ("linear", lin,
                                                               ref.linear_targets)):
            d = np.abs(got[b, :n].cpu().numpy() - want[b, :n])
            diffs[name].append(d[:inside].ravel())
            tails[name].append(float(d[inside:].max()) if inside < n else 0.0)
    worst = {k: (float(np.concatenate(v).max()), float(np.percentile(np.concatenate(v), 90)))
             for k, v in diffs.items()}
    log(f"[train_loop] PCM targets: {pb.mel_targets.nbytes / 1e6:.1f} MB a batch (int16 "
        f"{tuple(pb.mel_targets.shape)}); derive_wav_targets on the card {derive_ms:.2f} ms "
        f"(B=32 T={ref.mel_targets.shape[1]}); against the offline features, frames inside "
        f"their utterance: " + ", ".join(f"{k} max {m:.2e} p90 {p:.2e}"
                                         for k, (m, p) in worst.items())
        + " (tol max 1e-2, p90 2e-4); the last frames, whose window reaches the batch's "
        "padding: " + ", ".join(f"{k} max {max(v):.2e}" for k, v in tails.items()))
    if not all(m < 1e-2 and p < 2e-4 for m, p in worst.values()):
        raise AssertionError("derived targets disagree with the offline features")
    del pcm_dev, mel, lin

    model, state = create_train_state(cfg, cfg.train.seed)
    step_fn = make_train_step(cfg, model)
    state, m = step_fn(state, *train_loop.batch_to_device(host[0], "cuda"))  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for hb in host:
        state, m = step_fn(state, *train_loop.batch_to_device(hb, "cuda"))
    float(m["loss"])
    fed_ms = (time.perf_counter() - t0) * 1e3 / len(host)
    del model, state, step_fn
    log(f"[train_loop] a loop step's parts, over the epoch's batches (T "
        f"{[e[4] for e in plan]}): Feeder.materialize alone {timed['native'][0]:.2f} ms a "
        f"batch (native); the copy to the card alone {copy_ms['pageable']:.2f} ms a batch "
        f"(pageable), {copy_ms['pinned']:.2f} (pinned); steps fed from batches made "
        f"beforehand {fed_ms:.2f} ms a step (pageable copy included); the loop on the "
        f"Feeder {loop_ms:.2f} ms a step")

    _run_cli(base, "cli", [])
    _run_cli(base, "cli-grain", ["--pipeline", "grain", "--pipeline_workers", "2"])
    torch.cuda.empty_cache()
    return total


# --------------------------------------------------------------------------
# phase 7c: the entry points, location-attention training, the bf16 Adam
# moment and the fft / ct_* Griffin-Lim methods
# --------------------------------------------------------------------------

def _run_module(name, args, timeout=600):
    """``python -m tacotron_multispeaker_torch.<name> *args`` on the card:
    (completed process, wall seconds); a non-zero exit fails the run."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"tacotron_multispeaker_torch.{name}", *args],
                          cwd=REPO, capture_output=True, text=True, timeout=timeout)
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"python -m tacotron_multispeaker_torch.{name} exited "
                             f"{proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return proc, dt


def _http_get(url):
    """(status, content type, body) of a GET, HTTP errors included."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=300) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _check_report(report, n_utts, what):
    l1s = [v for sp in report["per_speaker"].values() for k, v in sp.items() if k != "frames"]
    l1s += list(report["overall"].values())
    if not (report["n_utterances"] == n_utts and l1s and all(math.isfinite(x) for x in l1s)):
        raise AssertionError(f"{what}: report {json.dumps(report)[:2000]}")


def phase_entry_points(base):
    """``validate``, ``eval`` and ``demo_server`` at full-width
    ``multispeaker_vctk`` on phase 7b's corpus and step-14 checkpoint.  In
    this process, with every count set to 0 just before and read just
    after: ``validate.validate`` over the whole corpus (short batches
    kept), exactly 2 BiGRU forwards (kernel 3) and one teacher forward
    (kernel 6) a batch; ``eval.main`` on 3 sentences over both input
    buckets, one ``serve`` request's launches a bucket (and with
    ``parallel.use_pallas``, the ``serve_pallas`` request's: kernels 11
    and 13).  Then each as a subprocess of its ``-m`` module on the card,
    its wall time printed: ``validate`` (its JSON: every utterance, finite
    L1s), ``eval`` (one WAV a sentence) and ``demo_server --port 0`` (``/``
    and two concurrent ``/synthesize`` requests in two buckets, valid
    WAVs; then stopped).  Returns {path: launches}."""
    import threading
    from scipy.io import wavfile
    from tacotron_multispeaker_torch import eval as eval_main
    from tacotron_multispeaker_torch import validate as validate_main
    from tacotron_multispeaker_torch.config import get_config
    from tacotron_multispeaker_torch.data.feeder import Feeder
    from tacotron_multispeaker_torch.synthesizer import Synthesizer
    from tacotron_multispeaker_torch.utils.checkpoint import CheckpointManager
    import torch

    cfg = get_config("multispeaker_vctk", LOOP_OVERRIDES)
    texts = [SERVE_TEXTS[i][0] for i in (0, 2, 4)]          # both input buckets
    data = os.path.join(base, "training")
    ckpt = CheckpointManager(os.path.join(base, "logs", "checkpoints")).path(LOOP_RESUME)
    n_utts = len(Feeder(data, cfg, use_native=False))
    n_batches = len(Feeder(data, cfg, shuffle=False, drop_remainder=False,
                           use_native=False).epoch_plan(0))
    out = {}

    syn = Synthesizer(cfg).load(ckpt)
    reset_counts()
    t0 = time.perf_counter()
    report = validate_main.validate(syn, data)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = read_counts()
    want = dict({k: 0 for k in got}, bigru_scan=2 * n_batches, teacher_decoder_fwd=n_batches)
    _check_report(report, n_utts, "validate")
    log(f"[entry_points] validate in process: {n_utts} utterances in {n_batches} batches, "
        f"{dt:.2f} s; overall mel L1 {report['overall']['mel_l1']:.6f}, linear L1 "
        f"{report['overall']['linear_l1']:.6f}; launches {json.dumps(got)}")
    if got != want:
        raise AssertionError(f"validate launches {got}, expected {want}")
    out["validate"] = got

    groups = list(eval_main.group_by_bucket(syn, texts, 8))
    if len(groups) != 2:
        raise AssertionError(f"eval's sentences fall in {len(groups)} buckets, need 2")
    for path in ("serve", "serve_pallas"):
        ov = ",".join(o for o in (LOOP_OVERRIDES, PATHS[path]) if o)
        with tempfile.TemporaryDirectory() as d:
            reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                paths = eval_main.main(["--checkpoint_dir", ckpt, "--preset",
                                        "multispeaker_vctk", "--hparams", ov, "--out_dir", d,
                                        *sum((["--text", t] for t in texts), [])])
            dt = time.perf_counter() - t0
            got = read_counts()
            want = {k: len(groups) * v for k, v in path_launches(
                path, get_config("multispeaker_vctk", ov), cfg.model.max_iters).items()}
            log(f"[entry_points] eval in process ({path}): {len(paths)} WAVs in {dt:.2f} s "
                f"(checkpoint load included); launches {json.dumps(got)}")
            if got != want or len(paths) != len(texts):
                raise AssertionError(f"eval ({path}) launches {got}, expected {want}")
        out["eval" if path == "serve" else "eval_pallas"] = got
    del syn
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as d:
        common = ["--checkpoint_dir", ckpt, "--preset", "multispeaker_vctk", "--hparams",
                  LOOP_OVERRIDES]
        _, dt = _run_module("validate", [*common[:2], "--data_dir", data, *common[2:],
                                         "--json_out", os.path.join(d, "report.json")])
        with open(os.path.join(d, "report.json")) as f:
            sub = json.load(f)
        _check_report(sub, n_utts, "python -m ...validate")
        log(f"[entry_points] python -m tacotron_multispeaker_torch.validate: {dt:.2f} s; "
            f"n_utterances {sub['n_utterances']}, speakers {len(sub['per_speaker'])}, overall "
            f"mel L1 {sub['overall']['mel_l1']:.6f} (in process "
            f"{report['overall']['mel_l1']:.6f})")

        _, dt = _run_module("eval", [*common, "--out_dir", os.path.join(d, "eval"),
                                     "--speaker_id", "17",
                                     *sum((["--text", t] for t in texts), [])])
        wavs = sorted(os.listdir(os.path.join(d, "eval")))
        rates = [wavfile.read(os.path.join(d, "eval", w)) for w in wavs]
        log(f"[entry_points] python -m tacotron_multispeaker_torch.eval: {dt:.2f} s; {wavs}, "
            f"samples {[pcm.shape[0] for _, pcm in rates]}")
        if not (wavs == [f"eval-{i}.wav" for i in range(len(texts))]
                and all(r == cfg.audio.sample_rate and pcm.shape[0] > 0 for r, pcm in rates)):
            raise AssertionError("eval did not write one WAV a sentence")

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "tacotron_multispeaker_torch.demo_server", "--checkpoint_dir",
         ckpt, "--preset", "multispeaker_vctk", "--hparams", LOOP_OVERRIDES, "--port", "0"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    watchdog = threading.Timer(600, proc.kill)
    watchdog.start()
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line.strip())
            if line.startswith("serving on"):
                break
        if not (lines and lines[-1].startswith("serving on")):
            raise AssertionError(f"demo_server did not start: {lines}\n{proc.stderr.read()}")
        ready = time.perf_counter() - t0
        url = f"http://127.0.0.1:{int(lines[-1].rsplit(':', 1)[1])}"
        status, ctype, body = _http_get(url + "/")
        if status != 200 or ctype != "text/html":
            raise AssertionError(f"demo_server GET /: {status} {ctype}")
        from urllib.parse import quote
        asks = [f"/synthesize?text={quote(t)}&speaker_id={s}"
                for t, s in (SERVE_TEXTS[0], SERVE_TEXTS[2])]
        answers = [None] * len(asks)
        t1 = time.perf_counter()
        threads = [threading.Thread(target=lambda i=i: answers.__setitem__(
            i, _http_get(url + asks[i]))) for i in range(len(asks))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        both = time.perf_counter() - t1
        for status, ctype, body in answers:
            rate, pcm = wavfile.read(io.BytesIO(body))
            if not (status == 200 and ctype == "audio/wav" and body[:4] == b"RIFF"
                    and rate == cfg.audio.sample_rate and pcm.shape[0] > 0):
                raise AssertionError(f"demo_server /synthesize: {status} {ctype}")
        missing = _http_get(url + "/nowhere")[0]
        log(f"[entry_points] python -m tacotron_multispeaker_torch.demo_server --port 0: "
            f"warmed up and listening after {ready:.2f} s; GET / 200; two concurrent "
            f"/synthesize (buckets 96 and 192) {both * 1e3:.2f} ms, WAVs of "
            f"{[len(b) for _, _, b in answers]} bytes; GET /nowhere {missing}")
        if missing != 404:
            raise AssertionError(f"demo_server GET /nowhere: {missing}")
    finally:
        watchdog.cancel()
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()
    return out


LOCATION_TRAIN = "model.attention_type=location"


def phase_train_location():
    """Location-attention training (the teacher-forced per-step loop): the
    f32 step on the card against the CPU's (``phase_train_reference``),
    then three timed full-width bf16 steps (multispeaker_vctk, B=32, L=192,
    T=1000) with their launches checked a step (``train_launches``: the
    BiGRU kernels 3 and 4 and the weight gradients, none of kernels 6, 7
    and 8).  Returns the launches of the timed steps."""
    import torch
    from tacotron_multispeaker_torch import training
    from tacotron_multispeaker_torch.config import get_config
    phase_train_reference(LOCATION_TRAIN, "train_location f32")
    cfg = get_config("multispeaker_vctk", LOCATION_TRAIN)
    B, L, T = 32, 192, 1000
    model, state = training.create_train_state(cfg, seed=0)
    step = training.make_train_step(cfg, model)
    batch = _train_batch(cfg, B, L, T, seed=5, device="cuda")
    want = train_launches(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = []
    for n in range(3):
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, *batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        got = _delta(before)
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        log(f"[train_location] step {n}: {times[-1] * 1e3:.2f} ms, {B / times[-1]:.2f} "
            f"examples/s, loss {loss:.6f}, grad_norm {gn:.6f}, launches {json.dumps(got)}")
        if got != want:
            raise AssertionError(f"location train step {n}: launches {got}, expected {want}")
        if not (math.isfinite(loss) and math.isfinite(gn)):
            raise AssertionError(f"location train step {n}: loss {loss}, grad_norm {gn}")
    total = read_counts()
    log(f"[train_location] multispeaker_vctk location attention B={B} L={L} T={T} bf16: "
        f"steps 1-2 {times[1] * 1e3:.2f}, {times[2] * 1e3:.2f} ms; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model, state, step, batch
    torch.cuda.empty_cache()
    return total


def phase_adam_bf16():
    """``train.adam_mu_dtype=bfloat16``: phase 7's f32 step on the card
    against the CPU's (``phase_train_reference``), the stored first moments
    bf16 on both and one bf16 ulp apart at most (2^-7 of each leaf's peak),
    the second moments f32.  Returns the card step's launches."""
    states, launches = phase_train_reference("train.adam_mu_dtype=bfloat16", "adam_bf16")
    moments = {}
    for dev, state in states.items():
        opt = state.optimizer
        moments[dev] = [(opt.adam.state[p]["exp_avg"], opt.adam.state[p]["exp_avg_sq"])
                        for p in opt.params]
    dtypes = {(mu.dtype, nu.dtype) for dev in moments for mu, nu in moments[dev]}
    # each leaf against its peak, floored at 1e-3 of the largest moment:
    # leaves whose gradient is zero in exact arithmetic hold noise
    floor = 1e-3 * max(mu.float().abs().max().item() for mu, _ in moments["cpu"])
    err = max(((a[0].cpu().float() - b[0].float()).abs().max()
               / max(b[0].float().abs().max().item(), floor)).item()
              for a, b in zip(moments["cuda"], moments["cpu"]))
    log(f"[adam_bf16] {len(moments['cuda'])} first moments, dtypes {sorted(map(str, dtypes))}; "
        f"card vs cpu, worst leaf {err:.2e} of its peak (floored at 1e-3 of the largest; "
        f"tol 2^-7, one bf16 ulp)")
    import torch
    if dtypes != {(torch.bfloat16, torch.float32)} or err > 2.0 ** -7:
        raise AssertionError("the bf16 Adam moments are wrong (see the line above)")
    return launches


GL_METHODS = ("fft", "ct_f32", "ct_hi", "ct_bf16", "ct_mix")
GL_METHOD_ITERS = 4


def phase_gl_methods():
    """Griffin-Lim ``fft`` and ``ct_*`` at B=32 F=1000 n_fft=2048 (hop 275,
    win 1102), momentum 0.99, ``GL_METHOD_ITERS`` iterations, the same
    injected initial angles: each method's kernel route (``use_pallas``:
    every overlap-add in kernel 12, counted: iterations + 1) against its
    plain route on the card; ``fft`` and ``ct_f32`` on the card against the
    CPU's plain route on two rows; each method's ms.  Returns the launches
    of the kernel routes."""
    import torch
    from tacotron_multispeaker_torch.audio import dsp
    B, F, n_iters = 32, 1000, GL_METHOD_ITERS
    p = dsp.STFTParams(2048, 275, 1102)
    g = torch.Generator(device="cuda").manual_seed(9)
    mag = torch.rand((B, 1025, F), generator=g, device="cuda") * 2.0
    angles = torch.rand((B, F, 1025), generator=g, device="cuda") * (2 * math.pi) - math.pi
    run = lambda m, k: dsp.griffin_lim(mag, p, n_iters, method=m, momentum=0.99,
                                       angles=angles, use_pallas=k)
    reset_counts()
    for method in GL_METHODS:
        before = read_counts()
        y_k = run(method, True)
        torch.cuda.synchronize()
        got = _delta(before)
        want = dict({k: 0 for k in got}, overlap_add=n_iters + 1)
        before = read_counts()
        y_p = run(method, False)
        torch.cuda.synchronize()
        if got != want or _delta(before) != {k: 0 for k in got}:
            raise AssertionError(f"{method}: launches {got}, expected {want} (kernel route) "
                                 "and none on the plain route")
        ms_k = cuda_time_ms(lambda: run(method, True), reps=2)
        ms_p = cuda_time_ms(lambda: run(method, False), reps=2)
        peak = y_p.abs().max().item()
        err = (y_k - y_p).abs()
        e_max, e_mean = err.max().item() / peak, err.mean().item() / peak
        # f32: kernel 12 repeats its plain version's f32 sums -> 1e-5 of the
        # peak.  bf16 / mix: the plain route's overlap-add runs in bf16 (the
        # JAX XLA path), the kernel's in f32; the phase estimate carries the
        # bf16 roundings where |S| ~ 0 (CPU, B=2 F=300: max 5.2e-2, mean
        # 5.3e-3) -> mean 2e-2 and worst sample 0.2 of the peak
        bf16 = method in ("ct_bf16", "ct_mix")
        ok = (e_mean <= 2e-2 and e_max <= 0.2) if bf16 else e_max <= 1e-5
        line = (f"[gl_methods] {method} B={B} F={F} n_fft=2048 {n_iters} iterations: kernel "
                f"route {ms_k:.2f} ms, plain route {ms_p:.2f} ms; kernel vs plain route max "
                f"{e_max:.2e} mean {e_mean:.2e} of the peak ({'mean 2e-2, max 0.2' if bf16 else 'max 1e-5'})")
        if method in ("fft", "ct_f32"):
            y_c = dsp.griffin_lim(mag[:2].cpu(), p, n_iters, method=method, momentum=0.99,
                                  angles=angles[:2].cpu())
            c_err = (y_p[:2].cpu() - y_c).abs().max().item() / y_c.abs().max().item()
            line += f"; card vs cpu (rows 0-1) max {c_err:.2e} of the peak (tol 1e-4)"
            ok = ok and c_err <= 1e-4
        log(line + f"; launches {json.dumps({k: v for k, v in got.items() if v})}")
        if not (ok and torch.isfinite(y_k).all() and y_k.shape == (B, 275 * (F - 1))):
            raise AssertionError(f"Griffin-Lim {method} is wrong (see the line above)")
    total = read_counts()
    del mag, angles
    torch.cuda.empty_cache()
    return total


def _check_tensorboard(log_dir, steps, image_step):
    """The event files ``TACOTRON_TB=1`` wrote under ``log_dir``/tb: the
    loss at ``steps``, and the alignment image at ``image_step`` where
    matplotlib drew its plot; a line says so where tensorboard does not
    import."""
    try:
        from tensorboard.backend.event_processing import event_accumulator
    except ImportError as e:
        log(f"[train_loop] tensorboard does not import here ({e}): no event files written, "
            "metrics.jsonl only")
        if os.path.exists(os.path.join(log_dir, "tb")):
            raise AssertionError("event files written without tensorboard")
        return
    acc = event_accumulator.EventAccumulator(os.path.join(log_dir, "tb"),
                                             size_guidance={"scalars": 0, "images": 0})
    acc.Reload()
    got = [e.step for e in acc.Scalars("loss")]
    plot = os.path.exists(os.path.join(log_dir, f"step-{image_step}-align.png"))
    images = [(e.step, e.width, e.height) for e in acc.Images("alignment")] if plot else []
    log(f"[train_loop] TACOTRON_TB=1: event files with the loss at steps {got}, alignment "
        f"images {images}" + ("" if plot else " (no plot: matplotlib does not import here)"))
    if got != list(steps) or (plot and [s for s, _, _ in images] != [image_step]):
        raise AssertionError("the TensorBoard event files are wrong (see the line above)")


# --------------------------------------------------------------------------
# phase 4: the generate paths on the card against the plain paths
# --------------------------------------------------------------------------

# the serving paths: overrides on multispeaker_vctk
PATHS = {
    "serve": "",
    "serve_pallas": "parallel.use_pallas=true",
    "serve_location": "parallel.use_pallas=true,model.attention_type=location,"
                      "audio.gl_method=dft_f32,audio.griffin_lim_iters=60,"
                      "audio.gl_momentum=0.0",
}


def _bigru_launches(cfg):
    """The forward launches of the encoder's and the post-net's BiGRU,
    pinned as ``TRAIN_LAUNCHES`` pins them (not asked of ``fwd_route``, the
    function under test): bf16 at the full CBHG width F=128 on the tensor
    cores, f32 on the FMA kernel."""
    widths = (cfg.model.encoder_depth // 2, cfg.model.postnet_gru_units)
    bf16 = cfg.model.compute_dtype == "bfloat16"
    if bf16 and widths != (128, 128):
        raise AssertionError(f"no pinned BiGRU route for bf16 at widths {widths}")
    return {"bigru_scan": 2 * bf16, "bigru_scan_fma": 2 * (not bf16)}


def path_launches(path, cfg, n_steps):
    """Each kernel's launches for one request (or batch) of ``n_steps``
    decoder steps on a serving path."""
    want = {name: 0 for name in _counters()}
    want.update(_bigru_launches(cfg))            # encoder and post-net CBHG
    if path == "serve_location":
        want.update(conv_bank=2, attention_step=n_steps,
                    overlap_add=cfg.audio.griffin_lim_iters + 1)
    else:
        want["decoder_loop"] = 1
    if path == "serve_pallas":
        want.update(conv_bank=2, gl_iteration=1)
    return want


def _delta(before):
    return {k: v - before[k] for k, v in read_counts().items()}


def phase_generate_reference(path="serve"):
    """f32 generate (dropout off) at full width on the card against the
    plain path on the CPU, from the same weights."""
    import numpy as np
    import torch
    from tacotron_multispeaker_torch.config import get_config
    from tacotron_multispeaker_torch.models import create_model
    ov = "model.compute_dtype=float32,model.prenet_dropout=0.0"
    cfg = get_config("multispeaker_vctk", ov + ("," + PATHS[path] if PATHS[path] else ""))
    model = create_model("tacotron", cfg).reset_parameters(
        torch.Generator().manual_seed(1)).eval()
    rs = np.random.RandomState(0)
    inputs = torch.as_tensor(rs.randint(2, 60, (2, 37)))
    lengths = torch.tensor([37, 21])
    sids = torch.tensor([3, 100])
    with torch.inference_mode():
        ref = model.generate(inputs, lengths, sids, max_iters=20)
        model.cuda()
        before = read_counts()
        out = model.generate(inputs.cuda(), lengths.cuda(), sids.cuda(), max_iters=20)
        torch.cuda.synchronize()
    got = _delta(before)
    want = path_launches(path, cfg, 20)
    want.update(overlap_add=0, gl_iteration=0)            # no Griffin-Lim here
    if got != want:
        raise AssertionError(f"{path} f32 generate: launches {got}, expected {want}")
    # f32 on both sides (cuBLAS and cuDNN without TF32, the kernels' sums
    # in other orders), carried by 20 autoregressive steps -> 2e-3
    tol = 2e-3
    for name, a, b in zip(("mel", "linear", "align"), out, ref):
        err = (a.cpu() - b).abs().max().item()
        log(f"[generate {path}] full-width f32, card vs cpu plain path: {name} "
            f"{tuple(a.shape)} max|diff| {err:.3e} (tol {tol:.0e})")
        if not (torch.isfinite(a).all() and err <= tol):
            raise AssertionError(f"generate on the card disagrees with the CPU: {name} {err}")


def phase_generate_bf16(path="serve"):
    """The serving precision (bf16, dropout off) through ``generate`` on the
    card, with the kernels and then with their plain versions swapped in:
    everything around the kernels is the same cuBLAS/elementwise work."""
    import numpy as np
    import torch
    from tacotron_multispeaker_torch.config import get_config
    from tacotron_multispeaker_torch.models import create_model
    cfg = get_config("multispeaker_vctk", "model.prenet_dropout=0.0"
                     + ("," + PATHS[path] if PATHS[path] else ""))
    model = create_model("tacotron", cfg).reset_parameters(
        torch.Generator().manual_seed(2)).eval().cuda()
    rs = np.random.RandomState(1)
    inputs = torch.as_tensor(rs.randint(2, 60, (2, 96))).cuda()
    lengths = torch.tensor([96, 53]).cuda()
    sids = torch.tensor([5, 77]).cuda()
    run = lambda: model.generate(inputs, lengths, sids, max_iters=20)
    with torch.inference_mode():
        before = read_counts()
        out = run()
        got = _delta(before)
        want = path_launches(path, cfg, 20)
        want.update(overlap_add=0, gl_iteration=0)
        if got != want:
            raise AssertionError(f"{path} bf16 generate: launches {got}, expected {want}")
        with plain_kernels():
            ref = run()
        torch.cuda.synchronize()
    # relative to the output's largest magnitude (mel, linear) for the
    # reason given in phase_decoder (bf16 ulp flips carried by the
    # recurrence, here over 20 steps and both CBHGs); alignments absolute,
    # as there (f32 energies and softmax, 1e-3 < 1/L at L=96).
    tol = {"mel": 5e-2, "linear": 5e-2, "align": 1e-3}
    for name, a, b in zip(("mel", "linear", "align"), out, ref):
        scale = 1.0 if name == "align" else b.abs().max().item()
        err = (a - b).abs().max().item() / scale
        log(f"[generate {path}] full-width bf16, kernels vs plain versions on the card: "
            f"{name} {tuple(a.shape)} max|diff|{'' if name == 'align' else '/max|plain|'} "
            f"{err:.3e} (tol {tol[name]:.0e}; max|plain| {b.abs().max().item():.3e})")
        if not (torch.isfinite(a).all() and err <= tol[name]):
            raise AssertionError(f"bf16 generate disagrees with its plain version: {name} {err}")


# --------------------------------------------------------------------------
# phase 5: serving
# --------------------------------------------------------------------------

SERVE_TEXTS = [
    ("Hello there.", 0),
    ("The quick brown fox jumps over the lazy dog near the river bank.", 17),
    ("Printing, in the only sense with which we are at present concerned, differs "
     "from most if not from all the arts and crafts represented in the exhibition.", 42),
    ("He was the last of his line; and yet, in all the years that followed, nobody "
     "could say for certain where the old house had stood, or who had built it.", 108),
    ("One two three.", 64),
]


def phase_serve(path="serve", texts=SERVE_TEXTS):
    """Serve full-width multispeaker_vctk on one path: warmup, B=1 requests
    over both input buckets, one B=32 batch, each with its exact launches
    and one endpoint search on the card; every count set to 0 just before
    and read just after.  The batch's rows are its untrimmed waveform cut at
    the host's ``find_endpoint``."""
    import numpy as np
    import torch
    from scipy.io import wavfile
    from tacotron_multispeaker_torch.config import get_config
    from tacotron_multispeaker_torch.synthesizer import Synthesizer
    from tacotron_multispeaker_torch.text import text_to_sequence

    cfg = get_config("multispeaker_vctk", PATHS[path])
    syn = Synthesizer(cfg, seed=0)
    sr = cfg.audio.sample_rate
    steps = cfg.model.max_iters
    max_samples = steps * cfg.model.outputs_per_step * cfg.audio.hop_length
    tag = f"[{path}]"

    searched_on = []                     # the device of each endpoint search
    find_endpoints = syn.ap.find_endpoints

    def spy(wavs):
        searched_on.append(wavs.device.type)
        return find_endpoints(wavs)
    syn.ap.find_endpoints = spy

    def expect(before, what):
        got, want = _delta(before), path_launches(path, cfg, steps)
        if got != want:
            raise AssertionError(f"{path} {what}: launches {got}, expected {want}")
        if searched_on != ["cuda"]:
            raise AssertionError(f"{path} {what}: endpoint searches on {searched_on}, "
                                 "expected one on the card")
        searched_on.clear()

    def check_wav(w, what):
        if not (w.ndim == 1 and 0 < w.shape[0] <= max_samples and np.isfinite(w).all()):
            raise AssertionError(f"{what}: bad wav shape {w.shape} or non-finite values")

    reset_counts()
    t0 = time.perf_counter()
    syn.warmup()
    torch.cuda.synchronize()
    searched_on.clear()
    log(f"{tag} warmup (both input buckets) {time.perf_counter() - t0:.2f} s")

    buckets = set()
    for text, spk in texts:
        n = len(text_to_sequence(text, cfg.cleaners))
        bucket = syn.serve_bucket_for([text])
        buckets.add(bucket)
        before = read_counts()
        t0 = time.perf_counter()
        data = syn.synthesize(text, speaker_id=spk, seed=spk)
        dt = time.perf_counter() - t0
        expect(before, f"synthesize(len={n})")
        rate, pcm = wavfile.read(io.BytesIO(data))
        if rate != sr or not 0 < pcm.shape[0] <= max_samples:
            raise AssertionError(f"synthesize(len={n}): wav rate {rate}, {pcm.shape}")
        before = read_counts()
        wavs, aligns = syn.synthesize_batch([text], [spk], seed=spk, pad_to=bucket)
        expect(before, f"synthesize_batch(len={n})")
        check_wav(wavs[0], f"request len={n}")
        if aligns.shape != (1, steps, bucket):
            raise AssertionError(f"alignments {aligns.shape}")
        full_s, trim_s = max_samples / sr, pcm.shape[0] / sr
        log(f"{tag} request len={n:3d} bucket={bucket} speaker={spk:3d}: "
            f"{dt * 1e3:8.2f} ms, {full_s:.2f} s audio decoded "
            f"({full_s / dt:7.2f} audio-s/s), {trim_s:.3f} s after the endpoint trim")
    if buckets != {96, 192}:
        raise AssertionError(f"requests covered buckets {buckets}, need 96 and 192")

    batch = [texts[i % len(texts)][0] for i in range(32)]
    spks = [(7 * i) % cfg.model.num_speakers for i in range(32)]
    before = read_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wavs, aligns = syn.synthesize_batch(batch, spks, max_iters=steps, seed=1,
                                        pad_to=syn.serve_bucket_for(batch))
    dt = time.perf_counter() - t0
    expect(before, "synthesize_batch(B=32)")
    for i, w in enumerate(wavs):
        check_wav(w, f"batch row {i}")
    # the same batch again, its untrimmed waveform kept on the way
    untrimmed, make_fn = [], syn._make_fn

    def keep(*args, **kw):
        fn = make_fn(*args, **kw)

        def run(*a):
            out = fn(*a)
            untrimmed.append(out[0].cpu().numpy())
            return out
        return run
    syn._make_fn = keep
    again, _ = syn.synthesize_batch(batch, spks, max_iters=steps, seed=1,
                                    pad_to=syn.serve_bucket_for(batch))
    del syn._make_fn
    searched_on.clear()
    (full,) = untrimmed
    ends = [syn.ap.find_endpoint(row) for row in full]
    if not all(np.array_equal(w, row[:e]) for w, row, e in zip(again, full, ends)):
        raise AssertionError(f"{path} B=32: rows are not the waveform cut at find_endpoint")
    log(f"{tag} batch B=32: each row is its untrimmed waveform cut at the host's "
        f"find_endpoint; {sum(e < full.shape[1] for e in ends)} of 32 rows cut")
    audio_s = sum(w.shape[0] for w in wavs) / sr
    untrimmed_s = 32 * max_samples / sr
    log(f"{tag} batch B=32 max_iters={steps}: {dt * 1e3:.2f} ms, {untrimmed_s:.1f} s "
        f"audio decoded ({untrimmed_s / dt:.2f} audio-s/s), {audio_s:.3f} s after the "
        f"endpoint trim")
    total = read_counts()
    log(f"{tag} launches over the serving run: {json.dumps(total)}")
    used = [k for k, v in path_launches(path, cfg, steps).items() if v]
    if min(total[k] for k in used) <= 0:
        raise AssertionError("a kernel of the serving path was never launched")
    phase_profile([
        (f"{path} B=1 request L=192", lambda: syn.synthesize_batch(
            [texts[2][0]], [texts[2][1]], pad_to=192)),
        (f"{path} B=32 batch L=192", lambda: syn.synthesize_batch(batch, spks, pad_to=192))])
    return total


# --------------------------------------------------------------------------
# phase 8: sharded synthesis (make_sharded_synth), four ranks on the card
# --------------------------------------------------------------------------

# the sharded paths: pod_synthesis (full Tacotron-1 widths, 2048 x 128
# speaker table, 400 decoder steps, model_parallel_size 4) on a mesh of four
# ranks sharing the one card (gloo), input bucket 192
SHARD_PATHS = {
    "shard_dp": ((4, 1), 32, ""),
    "shard_hybrid": ((1, 4), 32, ""),
    "shard_seq": ((1, 4), 8, "parallel.hybrid_model_axis=false"),
}
SHARD_REQUESTS = 2          # timed requests per path (after one warm-up)


def phase_serve_tacotron2():
    """Serve ``tacotron2_sv2tts`` at its published widths with the
    benchmark cell's weight biases (loud frames, no row stops): a B=32
    ``synthesize_batch`` at each of the cell's buckets (96, 192), graphs
    captured by a call before, with each kernel's launches counted
    through the graph replays (every count set to 0 just before and read
    just after; the decode's steps and replays from its span).  Then the
    captured decode at B=32 L=192 against the eager step loop, bit for
    bit, and each of that loop's 1,000 attention steps against the plain
    attention on the same inputs (phase_attention_step's bf16 limits)."""
    import numpy as np
    import torch
    from tacotron_multispeaker_torch import tracing
    from tacotron_multispeaker_torch.config import get_config
    from tacotron_multispeaker_torch.ops import attention_step as ast
    from tacotron_multispeaker_torch.synthesizer import Synthesizer
    from tacotron_multispeaker_torch.text import text_to_sequence
    cfg = get_config("tacotron2_sv2tts")
    B, S = 32, cfg.model.max_iters
    syn = Synthesizer(cfg, device="cuda", seed=0)
    m, dev = syn.model, syn.device
    with torch.no_grad():
        m.frame_proj.bias.fill_(0.6)
        m.stop_proj.bias.fill_(-10.0)
    texts = [SERVE_TEXTS[i % len(SERVE_TEXTS)][0] for i in range(B)]
    spks = [(7 * i) % cfg.model.num_speakers for i in range(B)]
    failures, total = [], {name: 0 for name in _counters()}
    for L in (96, 192):
        syn.synthesize_batch(texts, spks, seed=1, pad_to=L)
        torch.cuda.synchronize()
        reset_counts()
        tracing.clear()
        t0 = time.perf_counter()
        with tracing.record():
            wavs, aligns = syn.synthesize_batch(texts, spks, seed=2, pad_to=L)
        dt = time.perf_counter() - t0
        got = read_counts()
        recs = tracing.spans()
        tracing.clear()
        (dec,) = [r for r in recs if r.name == "synth.decode"]
        steps, replays = dec.attrs["steps"], dec.attrs["replays"]
        want = {name: 0 for name in got}
        want.update(attention_step=steps, gl_iteration=1)
        log(f"[serve_tacotron2] B={B} L={L} {steps} steps in {replays} replays of a "
            f"{steps // replays}-step graph: call {dt * 1e3:.1f} ms (spans on, no profiler), "
            f"decode {dec.device_ms:.1f} ms device-stream; launches counted through the "
            f"replays {json.dumps({k: v for k, v in got.items() if v})}")
        if got != want or steps != S:
            failures.append(f"L={L}: launches {got}, expected {want}")
        if not (len(wavs) == B and aligns.shape == (B, S, L)
                and all(len(w) > 0 and np.isfinite(w).all() for w in wavs)):
            failures.append(f"L={L}: {len(wavs)} rows, alignments {aligns.shape}")
        total = {k: total[k] + got[k] for k in total}
    L = 192
    seqs = [np.asarray(text_to_sequence(t, cfg.cleaners), np.int64)[:L] for t in texts]
    inputs = torch.as_tensor(np.stack([np.pad(q, (0, L - len(q))) for q in seqs]), device=dev)
    lengths = torch.as_tensor([len(q) for q in seqs], device=dev)
    keep = 1.0 - cfg.model.prenet_dropout
    gen = torch.Generator(device=dev).manual_seed(3)
    kernel, worst = ast.attention_step, torch.zeros(2, device=dev)

    def both(*args, **kw):
        ctx, al = kernel(*args, **kw)
        rc, ra = ast.attention_step_reference(*args)
        torch.maximum(worst, torch.stack([(al - ra).abs().max(), (ctx - rc).abs().max()]),
                      out=worst)
        return ctx, al
    with torch.inference_mode():
        memory = m.encode(inputs, lengths, m.speaker_vectors(
            torch.as_tensor(spks, device=dev))).contiguous()
        keys = m.attention.precompute_keys(memory).contiguous()
        mask = (torch.arange(L, device=dev)[None, :] < lengths[:, None]).contiguous()
        masks = [(torch.rand((S, B, n), generator=gen, device=dev) < keep).float() / keep
                 for n in cfg.model.prenet_depths]
        graph = m.decode(keys, memory, mask, masks, S)
        ast.attention_step = both
        try:
            eager = m.decode_eager(keys, memory, mask, masks, S)
        finally:
            ast.attention_step = kernel
        torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(graph[:3], eager)]
    e_al, e_ctx = worst.tolist()
    log(f"[serve_tacotron2] B={B} L={L} A=128 D=768 bf16, {S} steps: graph-replayed decode "
        f"vs the eager step loop bit for bit (frames, alignments, stop logits): {same}; "
        f"each eager step's kernel 9 vs the plain attention on its inputs: align "
        f"{e_al:.3e} (tol 1e-03) ctx {e_ctx:.3e} (tol 1e-02)")
    if not all(same):
        failures.append(f"graph decode differs from the eager loop: {same}")
    if not (e_al <= 1e-3 and e_ctx <= 1e-2):
        failures.append(f"kernel 9 vs plain attention: align {e_al} ctx {e_ctx}")
    if failures:
        raise AssertionError("serve_tacotron2: " + "; ".join(failures))
    return total


def shard_launches(path, cfg, n_steps):
    """Each kernel's launches on one rank for one request of ``n_steps``."""
    want = {name: 0 for name in _counters()}
    want.update(_bigru_launches(cfg))            # encoder and post-net CBHG
    if path == "shard_seq":
        want["attention_step_partial"] = n_steps  # one per step per model rank
    else:
        want["decoder_loop"] = 1
    return want


def _shard_batch(cfg, B, L=192):
    """A global batch: SERVE_TEXTS cycled, padded to ``L``, speakers spread
    over the whole table."""
    import numpy as np
    from tacotron_multispeaker_torch.text import text_to_sequence
    seqs = [text_to_sequence(SERVE_TEXTS[i % len(SERVE_TEXTS)][0], cfg.cleaners)[:L]
            for i in range(B)]
    inputs = np.zeros((B, L), np.int64)
    for i, q in enumerate(seqs):
        inputs[i, :len(q)] = q
    sids = (np.arange(B) * 263 + 5) % cfg.model.num_speakers
    return inputs, np.array([len(q) for q in seqs]), sids


def _shard_rank(rank, check_case):
    """One rank of phase 8: the f32 ``shard_seq`` check (its outputs go back
    to the parent), then each sharded path: a warm-up and timed requests
    with this rank's launches checked per request, counts set to 0 just
    before the path's run and read just after."""
    import torch
    from tacotron_multispeaker_torch.config import get_config
    from tacotron_multispeaker_torch.parallel import make_mesh
    from tacotron_multispeaker_torch.synthesizer import Synthesizer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    overrides, inputs, lengths, sids, angles, iters = check_case
    cfg = get_config("pod_synthesis", overrides + ",parallel.hybrid_model_axis=false")
    mesh = make_mesh(cfg.parallel, data=1, model=4)
    fn = Synthesizer(cfg, mesh=mesh, seed=3).make_sharded_synth(mesh, *inputs.shape, iters)
    out["check"] = [t.cpu() for t in fn(inputs, lengths, sids, gl_angles=angles)]

    # one all-reduce of the step's context size between the four ranks: on
    # the card tensor (what the port runs) and, under gloo, staged through
    # host memory
    import torch.distributed as dist
    ctx = torch.zeros(8, 384, device=mesh.device)
    out["backend"] = dist.get_backend()
    out["allreduce_ms_staged"] = float("nan")
    for staged in (False, True)[:1 + (out["backend"] == "gloo")]:
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            if staged:
                host = ctx.cpu()
                dist.all_reduce(host)
                ctx.copy_(host)
            else:
                dist.all_reduce(ctx)
        torch.cuda.synchronize()
        out[f"allreduce_ms_{'staged' if staged else 'card'}"] = (
            (time.perf_counter() - t0) / 50 * 1e3)

    for path, ((n_data, n_model), B, ov) in SHARD_PATHS.items():
        cfg = get_config("pod_synthesis", ov)
        steps = cfg.model.max_iters
        mesh = make_mesh(cfg.parallel, data=n_data, model=n_model)
        syn = Synthesizer(cfg, mesh=mesh, seed=0)
        fn = syn.make_sharded_synth(mesh, B, 192)
        inputs, lengths, sids = _shard_batch(cfg, B)
        reset_counts()
        times, launches = [], []
        for n in range(1 + SHARD_REQUESTS):
            before = read_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wav, align, mel = fn(inputs, lengths, sids, seed=n)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            launches.append(_delta(before))
            samples = steps * cfg.model.outputs_per_step * cfg.audio.hop_length
            if not (wav.shape[0] == B and 0 < wav.shape[1] <= samples
                    and align.shape == (B, steps, 192) and torch.isfinite(wav).all()
                    and torch.isfinite(mel).all()):
                raise AssertionError(f"{path}: rank {rank} got wav {tuple(wav.shape)}, "
                                     f"alignments {tuple(align.shape)} or non-finite values")
        total = read_counts()
        want = shard_launches(path, cfg, steps)
        if any(got != want for got in launches):
            raise AssertionError(f"{path}: rank {rank} launches {launches}, expected {want} "
                                 f"per request")
        # one more request on every rank (its collectives need them all),
        # profiled on rank 0
        request = lambda: fn(inputs, lengths, sids, seed=9)
        if rank == 0:
            phase_profile([(f"{path} B={B} (rank 0 of 4)", request)])
        else:
            request()
            torch.cuda.synchronize()
        out[path] = {"times": times, "launches": total, "audio_s": wav.shape[1] * B
                     / cfg.audio.sample_rate, "table_rows": tuple(
                         syn.model.speaker_table.weight.shape)}
    return out


def phase_shard():
    """Sharded synthesis through ``Synthesizer.make_sharded_synth`` on four
    ranks sharing the card (torch.multiprocessing, gloo over a ``file://``
    store): an f32 check of ``shard_seq`` (20 steps, B=8, bucket 192)
    against the single-process unsharded port on the card, then full-width
    ``pod_synthesis`` on each path of ``SHARD_PATHS``.  Returns each path's
    launches summed over the four ranks."""
    import numpy as np
    import torch
    from tacotron_multispeaker_torch.config import get_config
    from tacotron_multispeaker_torch.parallel import run_ranks
    from tacotron_multispeaker_torch.synthesizer import Synthesizer
    # f32, dropout off, exact Griffin-Lim, the same phases on both sides
    ov, iters = "model.compute_dtype=float32,model.prenet_dropout=0.0,audio.gl_method=dft_f32", 20
    cfg = get_config("pod_synthesis", ov)
    inputs, lengths, sids = _shard_batch(cfg, 8)
    lengths[2] = 30                         # ends in the first of four L-shards
    angles = np.random.RandomState(8).uniform(
        -np.pi, np.pi, (8, iters * cfg.model.outputs_per_step, cfg.audio.num_freq))
    dev = torch.device("cuda")
    ref = Synthesizer(cfg, device=dev, seed=3)._make_fn(iters)(
        torch.as_tensor(inputs, device=dev), torch.as_tensor(lengths, device=dev),
        torch.as_tensor(sids, device=dev), torch.Generator(device=dev),
        torch.as_tensor(angles, dtype=torch.float32, device=dev))
    ref = [t.cpu() for t in ref[:3]]
    t0 = time.perf_counter()
    outs = run_ranks(_shard_rank, 4, (ov, inputs, lengths, sids, angles, iters), timeout=900)
    log(f"[shard] four ranks on {torch.cuda.device_count()} card(s), all paths: "
        f"{time.perf_counter() - t0:.2f} s")
    log(f"[shard] one {outs[0]['backend']} all-reduce of [8, 384] f32 among the four ranks, "
        "per rank: on the card tensor " + ", ".join(f"{o['allreduce_ms_card']:.3f}" for o in outs)
        + " ms; staged through host memory "
        + ", ".join(f"{o['allreduce_ms_staged']:.3f}" for o in outs) + " ms")
    # test_parallel.py's tolerances for the sharded decode (mel 2e-3,
    # alignments 1e-4); the waveform to 1e-3 of its peak
    tol = {"wav": 1e-3 * ref[0].abs().max().item(), "align": 1e-4, "mel": 2e-3}
    for rank, out in enumerate(outs):
        for name, a, b in zip(("wav", "align", "mel"), out["check"], ref):
            err = (a - b).abs().max().item()
            log(f"[shard_seq] f32 pod_synthesis B=8 L=192 {iters} steps, rank {rank} vs the "
                f"unsharded port on the card: {name} {tuple(a.shape)} max|diff| {err:.3e} "
                f"(tol {tol[name]:.1e})")
            if not (a.shape == b.shape and err <= tol[name]):
                raise AssertionError(f"shard_seq on rank {rank} disagrees: {name} {err}")
    launches = {}
    for path, ((n_data, n_model), B, _) in SHARD_PATHS.items():
        per_rank = [o[path] for o in outs]
        req = [max(r["times"][n] for r in per_rank) for n in range(1 + SHARD_REQUESTS)]
        audio_s = per_rank[0]["audio_s"]
        log(f"[{path}] mesh ({n_data}, {n_model}) B={B} bucket 192 400 steps, speaker table "
            f"rows on each rank {[r['table_rows'][0] for r in per_rank]}: warm-up "
            f"{req[0] * 1e3:.2f} ms; requests " + ", ".join(
                f"{t * 1e3:.2f} ms ({audio_s / t:.2f} audio-s/s)" for t in req[1:])
            + f" ({audio_s:.2f} s of audio decoded a request)")
        launches[path] = {k: sum(r["launches"][k] for r in per_rank) for k in _counters()}
        log(f"[{path}] launches over the run, summed over the 4 ranks: "
            f"{json.dumps(launches[path])}")
    return launches


# --------------------------------------------------------------------------
# phase 9: sharded training
# --------------------------------------------------------------------------

# the f32 checks against the single-process step on the card: (preset, mesh
# (data, model), global batch, the route make_sharded_train_step takes);
# dropout off and cross-replica BatchNorm, so each equals the one-process step
PAR_CHECKS = {
    "train_dp": ("multispeaker_vctk", (4, 1), 8, "data_parallel"),
    "train_hybrid": ("large_multispeaker", (1, 4), 8, "hybrid"),
    "replicated": ("large_multispeaker", (2, 2), 6, "replicated"),
}
PAR_CHECK_OV = ("model.compute_dtype=float32,model.prenet_dropout=0.0,"
                "parallel.bn_cross_replica=true")
PAR_CHECK_L, PAR_CHECK_T = 23, 40
# the full-width bf16 paths: (preset, mesh, global batch)
TRAIN_PAR_PATHS = {
    "train_dp": ("multispeaker_vctk", (4, 1), 32),
    "train_hybrid": ("large_multispeaker", (1, 4), 64),
}
TRAIN_PAR_STEPS = 4         # timed steps a path (after one warm-up)
PAR_L, PAR_T = 192, 1000


def _train_leaves(model):
    """(parameters, their gradients, BatchNorm running statistics) on the CPU."""
    return ({n: p.detach().cpu() for n, p in model.named_parameters()},
            {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            {n: b.detach().cpu() for n, b in model.named_buffers()
             if n.endswith((".mean", ".var"))})


def _par_check_errors(ref, got, shards, lr):
    """This rank's one f32 step against the single-process one: relative
    loss and grad-norm errors, the whole gradient's relative L2 distance,
    the worst gradient leaf (relative to its peak, floored at 1e-3 of the
    largest gradient) and its name, the worst running statistic (relative)
    and the largest parameter move apart (absolute); the sharded table
    against its rows of the reference."""
    (m_ref, (p_ref, g_ref, b_ref)), (m, (p, g, b)) = ref, got
    rows = shards.get("speaker_table.weight")
    cut = lambda n, t: t[rows] if rows is not None and n == "speaker_table.weight" else t
    peak = max(t.abs().max().item() for t in g_ref.values())
    leaf = {n: ((g[n] - cut(n, t)).abs().max()
                / max(cut(n, t).abs().max().item(), 1e-3 * peak)).item()
            for n, t in g_ref.items()}
    worst = max(leaf, key=leaf.get)
    sq = lambda d: sum((t.double() ** 2).sum().item() for t in d.values())
    return {
        "loss": abs(m["loss"] - m_ref["loss"]) / abs(m_ref["loss"]),
        "grad_norm": abs(m["grad_norm"] - m_ref["grad_norm"]) / m_ref["grad_norm"],
        "grad_l2": (sq({n: g[n] - cut(n, t) for n, t in g_ref.items()})
                    / sq({n: cut(n, t) for n, t in g_ref.items()})) ** 0.5,
        "grad": leaf[worst], "worst_leaf": worst,
        "stats": max(_rel_err(b[n], t) for n, t in b_ref.items()),
        "params": max((p[n] - cut(n, t)).abs().max().item() for n, t in p_ref.items()),
        "param_tol": 2.5 * lr, "table_rows": tuple(p["speaker_table.weight"].shape)}


def _train_parallel_rank(rank, refs, batches, data, log_root):
    """One rank of phase 9: the f32 checks (each against the reference step
    in ``refs``), then each path of ``TRAIN_PAR_PATHS`` (a warm-up and timed
    steps, this rank's launches checked per step, the gradient all-reduce
    timed alone, a profiled step on rank 0), then ``train_loop.train`` to
    ``LOOP_STEPS`` and a resume to ``LOOP_RESUME`` on phase 7b's corpus.
    Counts are set to 0 just before each path's run and read just after."""
    import torch
    import torch.distributed as dist
    from tacotron_multispeaker_torch import train_loop, training
    from tacotron_multispeaker_torch.config import get_config
    from tacotron_multispeaker_torch.parallel import make_mesh
    from tacotron_multispeaker_torch.parallel.distributed import all_reduce_coalesced
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"backend": dist.get_backend(), "checks": {}}
    for name, (preset, (n_data, n_model), B, route) in PAR_CHECKS.items():
        cfg = get_config(preset, f"{PAR_CHECK_OV},train.batch_size={B}")
        mesh = make_mesh(cfg.parallel, data=n_data, model=n_model)
        if training.train_route(cfg, mesh) != route:
            raise AssertionError(f"{name}: route {training.train_route(cfg, mesh)}, not {route}")
        model, state = training.create_train_state(cfg, seed=1, mesh=mesh)
        step = training.make_sharded_train_step(cfg, model, mesh)
        index, count = training.batch_slice(cfg, mesh)
        n = B // count
        state, m = step(state, *(a[index * n:(index + 1) * n].to(mesh.device)
                                 for a in batches[name]))
        got = ({k: float(m[k]) for k in ("loss", "grad_norm")}, _train_leaves(model))
        out["checks"][name] = _par_check_errors(
            refs[name], got, state.shards, training.learning_rate_schedule(cfg)(0))
        del model, state, step
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()

    for path, (preset, (n_data, n_model), B) in TRAIN_PAR_PATHS.items():
        cfg = get_config(preset, f"train.batch_size={B}")
        mesh = make_mesh(cfg.parallel, data=n_data, model=n_model)
        model, state = training.create_train_state(cfg, seed=0, mesh=mesh)
        step = training.make_sharded_train_step(cfg, model, mesh)
        index, count = training.batch_slice(cfg, mesh)
        batch = _train_batch(cfg, B // count, PAR_L, PAR_T, seed=30 + index, device=mesh.device)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        times, launches, losses = [], [], []
        for n in range(1 + TRAIN_PAR_STEPS):
            before = read_counts()
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, *batch)
            losses.append((float(m["loss"]), float(m["grad_norm"])))
            times.append(time.perf_counter() - t0)
            launches.append(_delta(before))
        total = read_counts()
        if any(got != TRAIN_LAUNCHES for got in launches):
            raise AssertionError(f"{path}: rank {rank} launches {launches}, expected "
                                 f"{TRAIN_LAUNCHES} a step")
        if not all(math.isfinite(x) for pair in losses for x in pair):
            raise AssertionError(f"{path}: rank {rank} losses {losses}")
        # the step's gradient all-reduce alone: the replicated gradients'
        # one flat buffer over the whole mesh
        grads = [p.grad.clone() for name, p in model.named_parameters()
                 if name not in state.shards]
        group = mesh.data_group if n_model == 1 else mesh.world_group
        ar = []
        for _ in range(3):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            all_reduce_coalesced(grads, group)
            torch.cuda.synchronize()
            ar.append((time.perf_counter() - t0) * 1e3)
        one_step = lambda: (step(state, *batch), torch.cuda.synchronize())
        if rank == 0:
            phase_profile([(f"{path} {preset} B={B // count} a rank L={PAR_L} T={PAR_T} "
                            f"(rank 0 of 4)", one_step)])
        else:
            one_step()
        out[path] = {"times": times, "losses": losses, "launches": total,
                     "allreduce_ms": sorted(ar)[1], "allreduce_mb": sum(
                         g.numel() * g.element_size() for g in grads) / 1e6,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                     "table_rows": tuple(model.speaker_table.weight.shape)}
        del model, state, step, grads, batch
        torch.cuda.empty_cache()

    cfg = get_config("multispeaker_vctk", LOOP_OVERRIDES)
    log_dir = os.path.join(log_root, "logs-train-par")
    reset_counts()
    t0 = time.perf_counter()
    first = train_loop.train(log_dir, data, cfg, max_steps=LOOP_STEPS)
    resumed = train_loop.train(log_dir, data, cfg, max_steps=LOOP_RESUME)
    out["train_loop_dp"] = {"launches": read_counts(), "wall_s": time.perf_counter() - t0,
                            "results": [{k: v for k, v in r.items() if k != "step_seconds"}
                                        for r in (first, resumed)],
                            "step_ms": sorted(dt * 1e3 for step, dt in first["step_seconds"]
                                              if 2 < step <= LOOP_STEPS and step != 11)}
    return out


def phase_train_parallel(base):
    """Sharded training on four ranks sharing the card (gloo; NCCL where
    each rank has a card of its own): the f32 data-parallel, hybrid and
    row-replicated steps (dropout off, cross-replica BatchNorm) against the
    single-process step on the card from the same weights and batch (loss,
    grad norm, every all-reduced gradient leaf before Adam, the updated
    parameters and running statistics); full-width bf16 ``train_dp``
    (``multispeaker_vctk``, mesh (4, 1), B=32) and ``train_hybrid``
    (``large_multispeaker``, mesh (1, 4), B=64, 512 table rows a rank), a
    warm-up and ``TRAIN_PAR_STEPS`` timed steps each, every rank's launches
    checked per step against ``TRAIN_LAUNCHES``; then ``train_loop_dp``:
    ``train_loop.train`` on the four ranks from phase 7b's corpus in
    ``base``, 12 steps with a checkpoint and eval at 10, a resume to 14.
    Returns each path's launches summed over the four ranks."""
    import torch
    from scipy.io import wavfile
    from tacotron_multispeaker_torch import training
    from tacotron_multispeaker_torch.config import get_config
    from tacotron_multispeaker_torch.parallel import run_ranks
    from tacotron_multispeaker_torch.utils.checkpoint import CheckpointManager
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    refs, batches = {}, {}
    for name, (preset, _, B, _) in PAR_CHECKS.items():
        cfg = get_config(preset, f"{PAR_CHECK_OV},train.batch_size={B}")
        batches[name] = _train_batch(cfg, B, PAR_CHECK_L, PAR_CHECK_T, seed=6, device="cpu")
        model, state = training.create_train_state(cfg, seed=1)
        state, m = training.make_train_step(cfg, model)(state, *(a.cuda() for a in
                                                                batches[name]))
        refs[name] = ({k: float(m[k]) for k in ("loss", "grad_norm")}, _train_leaves(model))
        del model, state
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()
    data = os.path.join(base, "training")
    t0 = time.perf_counter()
    outs = run_ranks(_train_parallel_rank, 4, refs, batches, data, base, timeout=900)
    log(f"[train_parallel] four ranks on {torch.cuda.device_count()} card(s), "
        f"{outs[0]['backend']}: {time.perf_counter() - t0:.2f} s")
    # f32: loss 1e-5 and grad norm 1e-4 relative: the same f32 sums in
    # other orders (the all-reduces, the BatchNorm statistics as the mean of
    # the ranks' means).  The gradient: its relative L2 distance 1e-2, each
    # leaf 5e-2 of its peak (floored at 1e-3 of the largest gradient).  A
    # ReLU whose pre-activation sits within rounding of 0 can take the other
    # side at another batch split and moves one position's whole gradient
    # in or out of the conv below it and everything upstream: measured on
    # the card at (4, 1), one flip in post_cbhg.proj_0 (|pre| 3.1e-6) gave
    # an L2 distance of 1.42e-3 and 2.85e-2 of post_cbhg.proj_0.conv.bias's
    # peak, while (2, 1), without a flip, gave 2.4e-6; a missing all-reduce
    # is an O(1) error.  Running statistics 5e-5 relative (a mean of four
    # f32 sums against one).  Parameters after the update: Adam's first step
    # moves each by about lr·sign(g), so a near-zero gradient whose sign
    # the sum order flips moves it 2·lr apart: 2.5·lr absolute
    tol = {"loss": 1e-5, "grad_norm": 1e-4, "grad_l2": 1e-2, "grad": 5e-2, "stats": 5e-5}
    for name, (preset, (n_data, n_model), B, route) in PAR_CHECKS.items():
        errs = [o["checks"][name] for o in outs]
        worst = {k: max(e[k] for e in errs) for k in (*tol, "params")}
        leaf = max(errs, key=lambda e: e["grad"])["worst_leaf"]
        log(f"[train_parallel f32] {name}: {preset} mesh ({n_data}, {n_model}) B={B} "
            f"L={PAR_CHECK_L} T={PAR_CHECK_T} ({route} route; table rows a rank "
            f"{[e['table_rows'][0] for e in errs]}) against the single-process step on the "
            f"card, worst over the ranks: loss {worst['loss']:.2e} (tol 1e-5), grad_norm "
            f"{worst['grad_norm']:.2e} (tol 1e-4), gradient relative L2 {worst['grad_l2']:.2e} "
            f"(tol 1e-2), gradient leaf {worst['grad']:.2e} ({leaf}; tol 5e-2), running stats "
            f"{worst['stats']:.2e} (tol 5e-5), params after the update {worst['params']:.2e} "
            f"(abs, tol {errs[0]['param_tol']:.2e} = 2.5 lr)")
        if not (all(worst[k] <= t for k, t in tol.items())
                and worst["params"] <= errs[0]["param_tol"]):
            raise AssertionError(f"the sharded f32 step {name} disagrees with one process")

    launches = {}
    for path, (preset, (n_data, n_model), B) in TRAIN_PAR_PATHS.items():
        per_rank = [o[path] for o in outs]
        steps = [max(r["times"][n] for r in per_rank) for n in range(1 + TRAIN_PAR_STEPS)]
        median = sorted(steps[1:])[TRAIN_PAR_STEPS // 2]
        log(f"[{path}] {preset} mesh ({n_data}, {n_model}) B={B} ({B // (n_data * n_model)} "
            f"a rank) L={PAR_L} T={PAR_T} bf16, {outs[0]['backend']}: step ms (slowest rank) "
            f"warm-up {steps[0] * 1e3:.2f}, then " + ", ".join(f"{t * 1e3:.2f}" for t in steps[1:])
            + f"; median {median * 1e3:.2f} ms ({B / median:.2f} examples/s); gradient "
            f"all-reduce alone ({per_rank[0]['allreduce_mb']:.1f} MB f32, one flat buffer) "
            + ", ".join(f"{r['allreduce_ms']:.2f}" for r in per_rank) + " ms a rank; peak "
            "memory " + ", ".join(f"{r['peak_gib']:.2f}" for r in per_rank) + " GiB a rank; "
            f"table rows a rank {[r['table_rows'][0] for r in per_rank]}; losses (rank 0) "
            + ", ".join(f"{lo:.5f}" for lo, _ in per_rank[0]["losses"]))
        if any(r["losses"] != per_rank[0]["losses"] for r in per_rank):
            raise AssertionError(f"{path}: the ranks' losses differ")
        launches[path] = {k: sum(r["launches"][k] for r in per_rank) for k in _counters()}
        log(f"[{path}] launches over the run, summed over the 4 ranks: "
            f"{json.dumps(launches[path])}")

    cfg = get_config("multispeaker_vctk", LOOP_OVERRIDES)
    log_dir = os.path.join(base, "logs-train-par")
    per_rank = [o["train_loop_dp"] for o in outs]
    for rank, r in enumerate(per_rank):
        want = {k: LOOP_RESUME * v for k, v in TRAIN_LAUNCHES.items()}
        if rank == 0:
            for k, v in path_launches("serve", cfg, cfg.model.max_iters).items():
                want[k] += v                             # the eval request at step 10
        if r["launches"] != want:
            raise AssertionError(f"train_loop_dp: rank {rank} launches {r['launches']}, "
                                 f"expected {want}")
    ckpts = CheckpointManager(os.path.join(log_dir, "checkpoints")).steps()
    rate, pcm = wavfile.read(os.path.join(log_dir, "step-10-audio.wav"))
    text = open(os.path.join(log_dir, "train.log")).read()
    results = [r["results"] for r in per_rank]
    steady = per_rank[0]["step_ms"]
    log(f"[train_loop_dp] train_loop.train on 4 ranks, multispeaker_vctk B=32 (8 a rank), "
        f"{LOOP_STEPS} steps and a resume to {LOOP_RESUME} in {per_rank[0]['wall_s']:.2f} s "
        f"(setup included): final losses " + ", ".join(
            f"{r[0]['loss']:.5f} / {r[1]['loss']:.5f}" for r in results)
        + f" a rank; rank 0's steps 3-12 but 11 (the first after the checkpoint) "
        f"{steady[0]:.2f}-{steady[-1]:.2f} ms, median {steady[len(steady) // 2]:.2f}; "
        f"checkpoints {ckpts}; eval WAV {pcm.shape[0]} samples at {rate} Hz")
    if not (all(r == results[0] for r in results) and results[0][1]["step"] == LOOP_RESUME
            and all(math.isfinite(x["loss"]) for x in results[0])
            and ckpts == [10, LOOP_STEPS, LOOP_RESUME] and rate == cfg.audio.sample_rate
            and pcm.shape[0] > 0 and "wrote eval artifacts for step 10" in text
            and f"resumed from checkpoint at step {LOOP_STEPS}" in text):
        raise AssertionError("the four-rank train loop's run is wrong (see the line above)")
    launches["train_loop_dp"] = {k: sum(r["launches"][k] for r in per_rank)
                                 for k in _counters()}
    log(f"[train_loop_dp] launches over the run, summed over the 4 ranks: "
        f"{json.dumps(launches['train_loop_dp'])}")
    return launches


# --------------------------------------------------------------------------
# phase 6: where the time goes
# --------------------------------------------------------------------------

def phase_profile(runs):
    """torch.profiler over each (label, fn) run: device time by kernel, and
    device-busy time (union of the kernel and copy intervals) against the
    host's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tacotron_multispeaker_torch.tracing import device_busy
    for label, fn in runs:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms, n_spans, by_name = device_busy(prof)
        if busy_ms is None:
            log(f"[profile] {label}: the profiler saw no device time (not measured)")
            continue
        log(f"[profile] {label}: wall {wall_ms:.2f} ms (profiler on), "
            f"device busy {busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
            f"{n_spans} device spans")
        for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:14]:
            log(f"[profile]   {ms:9.3f} ms {100 * ms / busy_ms:5.1f}% x{n:<5d} {name[:90]}")


KERNEL_META = {
    # name: (source, the TPU kernel it replaces, the path whose launches count)
    "bigru_scan": ("tacotron_multispeaker_torch/csrc/bigru_scan.cu",
                   "tacotron_multispeaker_tpu/ops/gru_scan.py:366", "serve"),
    "decoder_loop": ("tacotron_multispeaker_torch/csrc/decoder_loop.cu",
                     "tacotron_multispeaker_tpu/ops/decoder_loop.py:185", "serve"),
    "bigru_scan_bwd": ("tacotron_multispeaker_torch/csrc/bigru_scan_bwd.cu",
                       "tacotron_multispeaker_tpu/ops/gru_scan.py:485", "train"),
    "bigru_scan_bwd_remat": ("tacotron_multispeaker_torch/csrc/bigru_scan_bwd.cu",
                             "tacotron_multispeaker_tpu/ops/gru_scan.py:485", "train"),
    "gru_scan": ("tacotron_multispeaker_torch/csrc/bigru_scan.cu",
                 "tacotron_multispeaker_tpu/ops/gru_scan.py:87", "gru"),
    "gru_scan_bwd": ("tacotron_multispeaker_torch/csrc/bigru_scan_bwd.cu",
                     "tacotron_multispeaker_tpu/ops/gru_scan.py:225", "gru"),
    "gru_scan_bwd_remat": ("tacotron_multispeaker_torch/csrc/bigru_scan_bwd.cu",
                           "tacotron_multispeaker_tpu/ops/gru_scan.py:225", "gru"),
    "teacher_decoder_fwd": ("tacotron_multispeaker_torch/csrc/teacher_decoder_fwd.cu",
                            "tacotron_multispeaker_tpu/ops/teacher_decoder.py:190", "train"),
    "dkeys": ("tacotron_multispeaker_torch/csrc/dkeys.cu",
              "tacotron_multispeaker_tpu/ops/teacher_decoder.py:298", "train"),
    "teacher_decoder_bwd": ("tacotron_multispeaker_torch/csrc/teacher_decoder_bwd.cu",
                            "tacotron_multispeaker_tpu/ops/teacher_decoder.py:498", "train"),
    "teacher_decoder_bwd_remat": ("tacotron_multispeaker_torch/csrc/teacher_decoder_bwd.cu",
                                  "tacotron_multispeaker_tpu/ops/teacher_decoder.py:498",
                                  "train"),
    "wgrad": ("tacotron_multispeaker_torch/csrc/wgrad.cu",
              "tacotron_multispeaker_tpu/ops/teacher_decoder.py:498", "train"),
    "conv_bank": ("tacotron_multispeaker_torch/csrc/conv_bank.cu",
                  "tacotron_multispeaker_tpu/ops/conv_bank.py:37", "serve_pallas"),
    "attention_step": ("tacotron_multispeaker_torch/csrc/attention_step.cu",
                       "tacotron_multispeaker_tpu/ops/attention_step.py:53", "serve_location"),
    "attention_step_partial": ("tacotron_multispeaker_torch/csrc/attention_step.cu",
                               "tacotron_multispeaker_tpu/ops/attention_step.py:130",
                               "shard_seq"),
    "overlap_add": ("tacotron_multispeaker_torch/csrc/overlap_add.cu",
                    "tacotron_multispeaker_tpu/ops/overlap_add.py:115", "serve_location"),
    "gl_iteration": ("tacotron_multispeaker_torch/csrc/gl_iteration.cu",
                     "tacotron_multispeaker_tpu/ops/gl_iteration.py:113", "serve_pallas"),
}
LIBRARY_NULL = {
    "bigru_scan": "torch.nn.GRU applies the reset gate after the matmul, another function",
    "decoder_loop": "no one PyTorch call decodes",
    "bigru_scan_bwd": "no one PyTorch call computes the legacy-GRU backward",
    "bigru_scan_bwd_remat": "no one PyTorch call rebuilds legacy-GRU gates from saved states",
    "gru_scan": "torch.nn.GRU applies the reset gate after the matmul, another function",
    "gru_scan_bwd": "no one PyTorch call computes the legacy-GRU backward",
    "gru_scan_bwd_remat": "no one PyTorch call rebuilds legacy-GRU gates from saved states",
    "teacher_decoder_fwd": "no one PyTorch call runs the attention decoder scan",
    "dkeys": "no one PyTorch call computes this tanh-derivative reduction",
    "teacher_decoder_bwd": "no one PyTorch call runs the decoder scan's backward",
    "teacher_decoder_bwd_remat": "no one PyTorch call rebuilds GRU gate values and the "
                                 "attention context from saved states",
    "attention_step": "scaled_dot_product_attention is dot-product attention; no one "
                      "PyTorch call computes additive (tanh) attention",
    "attention_step_partial": "no one PyTorch call computes an unnormalised additive "
                              "(tanh) attention partial with its local max and sum",
    "gl_iteration": "no one PyTorch call runs Griffin-Lim iterations (cublas_route_ms: the "
                    "default route's several calls, for comparison)",
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import tacotron_multispeaker_torch  # noqa: F401  (fails outside a checkout)
    smi = phase_card()
    phase_build()
    kern = {"bigru_scan": phase_bigru(), "decoder_loop": phase_decoder()}
    kern["bigru_scan_bwd"], kern["bigru_scan_bwd_remat"], bigru_wgrad = phase_bigru_bwd()
    kern["gru_scan"] = phase_gru_scan()
    kern["gru_scan_bwd"], kern["gru_scan_bwd_remat"], gru_wgrad = phase_gru_scan_bwd()
    kern.update(phase_teacher((bigru_wgrad, gru_wgrad)))
    kern.update(conv_bank=phase_conv_bank(), attention_step=phase_attention_step(),
                attention_step_partial=phase_attention_partial(),
                overlap_add=phase_overlap_add(), gl_iteration=phase_gl_iteration())
    phase_endpoint()
    for path in ("serve", "serve_location"):
        phase_generate_reference(path)
    for path in PATHS:
        phase_generate_bf16(path)
    launches = {path: phase_serve(path) for path in PATHS}
    launches["serve_tacotron2"] = phase_serve_tacotron2()
    phase_train_reference()
    phase_train_bf16()
    launches["train"], bare_step_s = phase_train()
    launches["gru"] = phase_gru()
    base = tempfile.mkdtemp(prefix="train_loop-")
    try:
        launches["train_loop"] = phase_train_loop(bare_step_s, base)
        launches.update(phase_entry_points(base))
        launches["train_location"] = phase_train_location()
        launches["adam_bf16"] = phase_adam_bf16()
        launches["gl_methods"] = phase_gl_methods()
        launches.update(phase_shard())
        launches.update(phase_train_parallel(base))
    finally:
        shutil.rmtree(base, ignore_errors=True)
    paths = (*PATHS, "serve_tacotron2", "train", "gru", "train_loop", "validate", "eval", "eval_pallas",
             "train_location", "adam_bf16", "gl_methods", *SHARD_PATHS, *TRAIN_PAR_PATHS,
             "train_loop_dp")
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[path][name], "launches_by_path": {
             p: launches[p][name] for p in paths},
         "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"], "bound_ms": kern[name]["bound_ms"],
         "bound_by": kern[name]["bound_by"], "library_ms": kern[name].get("library_ms"),
         **({} if name not in LIBRARY_NULL else {"library_ms_null": LIBRARY_NULL[name]}),
         **{k: v for k, v in kern[name].items()
            if k in ("bound_all_taps_ms", "bound_full_frame_ms", "cublas_route_ms",
                     "bound_latency_ms", "cluster", "ms_b1", "ms_pod", "ms_remat",
                     "ms_scan", "ms_device", "ms_fma", "latency_share", "design", "error",
                     "ms_device_b1", "cluster_b1", "ms_device_b1_l192", "library",
                     "bound_b1_ms", "library_ms_b1", "ms_full", "ms_device_full",
                     "plain_ms_full", "ms_device_full_b1", "ms_device_fma",
                     "library_f32_ms", "by_launch")},
         **({} if f"{name}_fma" not in launches["train"] else {"fma_route_launches_by_path": {
             p: launches[p][f"{name}_fma"] for p in paths}}),
         **({} if f"{name}_direct" not in launches["train"] else {
             "direct_route_launches_by_path": {
                 p: launches[p][f"{name}_direct"] for p in paths}}),
         "shape": kern[name]["shape"]}
        for name, (src, replaces, path) in KERNEL_META.items()]}
    log(smi)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
