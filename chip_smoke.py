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
   serving and training paths' shapes, in float32 (contractive weights,
   modest step counts) and bfloat16, every output by name, and times kernel
   and plain version.
4. Checks the whole generate path at full-width ``multispeaker_vctk``,
   dropout off: in float32 on the card against the plain path on the CPU,
   and in bfloat16 (the serving precision) on the card with the kernels
   against the same run with their plain versions swapped in.
5. Serves through ``Synthesizer`` at full-width ``multispeaker_vctk`` with
   random weights from a seed: ``warmup()``, B=1 ``synthesize()`` requests
   over both input buckets and several speakers, one B=32 batch of 200
   decoder steps.  Each request must launch ``bigru_scan`` twice (encoder
   and post-net CBHG) and ``decoder_loop`` once.

6. Where the time goes: a profile of a B=1 request, the B=32 batch and
   one full-width train step (device busy, idle share, top kernels).
7. Trains: one full-width ``multispeaker_vctk`` step in float32 (dropout
   off, B=2, short lengths) on the card against the same step on the CPU
   plain path (loss, grad norm, every gradient leaf, the updated running
   statistics); a few bf16 steps with the kernels against the same run
   with their plain versions swapped in; then five timed steps at full
   width (B=32, L=192, T=1000, bf16) with the launches of every kernel
   checked per step.

Each path (serving, training) is driven with every launch count set to 0
just before it and read just after.  Prints the per-request and per-step
times, one ``kernels`` JSON line (each kernel's time, plain time, bound,
launches on its path's run), and as its last line ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
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
    from tacotron_multispeaker_torch.ops import decoder_loop, gru_scan, teacher_decoder, wgrad
    return {"bigru_scan": (gru_scan, "launches"),
            "decoder_loop": (decoder_loop, "launches"),
            "bigru_scan_bwd": (gru_scan, "bwd_launches"),
            "teacher_decoder_fwd": (teacher_decoder, "fwd_launches"),
            "dkeys": (teacher_decoder, "dkeys_launches"),
            "teacher_decoder_bwd": (teacher_decoder, "bwd_launches"),
            "wgrad": (wgrad, "launches")}


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
    info = cuda_build.build_all(KERNELS)
    log(f"[build] {len(info)} kernel libraries in {time.perf_counter() - t0:.2f} s "
        f"(parallel nvcc)")
    for name, rec in info.items():
        log(f"[build] {name}: {rec['seconds']:.2f} s -> {os.path.relpath(rec['path'], REPO)}")
        for line in rec["ptxas"].splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "smem")):
                log(f"[ptxas] {name}: {line.strip()}")


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


def phase_bigru():
    import torch
    from tacotron_multispeaker_torch.ops import gru_scan
    F, B = 128, 32
    tol = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
    worst = 0.0
    for T in (192, 1000):
        for dtype in (torch.float32, torch.bfloat16):
            args = _bigru_inputs(T, B, F, dtype, seed=T)
            ys = gru_scan.bigru_scan(*args)
            ref = gru_scan.bigru_scan_reference(*args)
            torch.cuda.synchronize()
            err = (ys.float() - ref.float()).abs().max().item()
            log(f"[bigru_scan] T={T} B={B} F={F} {str(dtype)[6:]}: max|kernel-plain| "
                f"{err:.3e} (tol {tol[dtype]:.0e})")
            if not err <= tol[dtype]:
                raise AssertionError(f"bigru_scan disagrees with its plain version: {err}")
            worst = max(worst, err)
    # timing at the post-net shape of the B=32 batch (T = 5 * 200 frames)
    T, dtype = 1000, torch.bfloat16
    args = _bigru_inputs(T, B, F, dtype, seed=7)
    ms = cuda_time_ms(lambda: gru_scan.bigru_scan(*args), reps=10)
    plain_ms = cuda_time_ms(lambda: gru_scan.bigru_scan_reference(*args), reps=2)
    bound_ms, bound_by = _bigru_bound_ms(T, B, F, 2)
    log(f"[bigru_scan] T={T} B={B} F={F} bf16: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    for T1 in (96, 192, 1000):          # the B=1 request's encoder and post-net
        args1 = _bigru_inputs(T1, 1, F, dtype, seed=8)
        log(f"[bigru_scan] T={T1} B=1 F={F} bf16: kernel "
            f"{cuda_time_ms(lambda: gru_scan.bigru_scan(*args1), reps=10):.3f} ms")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "shape": f"T={T} B={B} F={F} bf16"}


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
    for dtype in (torch.float32, torch.bfloat16):
        args = _decoder_case(32, 192, 8, dtype, scale=0.05, seed=3)
        fk, ak = dl.decoder_loop(*args)
        fr, ar = dl.decoder_loop_reference(*args)
        torch.cuda.synchronize()
        ef = (fk - fr).abs().max().item()
        ea = (ak - ar).abs().max().item()
        tf, ta = tol[dtype]
        log(f"[decoder_loop] B=32 L=192 S=8 {str(dtype)[6:]}: max|kernel-plain| "
            f"frames {ef:.3e} (tol {tf:.0e}) align {ea:.3e} (tol {ta:.0e})")
        if not (ef <= tf and ea <= ta):
            raise AssertionError(f"decoder_loop disagrees with its plain version: {ef}, {ea}")
        worst = max(worst, ef, ea)
    # timing at the B=32 batch's shape: 200 steps, L=192, bf16
    args = _decoder_case(32, 192, 200, torch.bfloat16, scale=0.05, seed=5)
    ms = cuda_time_ms(lambda: dl.decoder_loop(*args), reps=5)
    plain_ms = cuda_time_ms(lambda: dl.decoder_loop_reference(*args), reps=1)
    bound_ms, bound_by = _decoder_bound_ms(args)
    log(f"[decoder_loop] B=32 L=192 S=200 bf16: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    args1 = _decoder_case(1, 96, 200, torch.bfloat16, scale=0.05, seed=6)
    ms1 = cuda_time_ms(lambda: dl.decoder_loop(*args1), reps=5)
    log(f"[decoder_loop] B=1 L=96 S=200 bf16: kernel {ms1:.3f} ms")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "shape": "B=32 L=192 S=200 H=A=256 D=320 bf16"}


# --------------------------------------------------------------------------
# phase 3 (training kernels): backward kernels against their plain versions
# --------------------------------------------------------------------------

def _wgrad_bound_ms(problems):
    bytes_ = sum(_nbytes(a, g) + a.shape[-1] * g.shape[-1] * 4 + (g.shape[-1] * 4 if b else 0)
                 for a, g, b in problems)
    flops = sum(2 * a.shape[0] * a.shape[1] * a.shape[-1] * g.shape[-1] for a, g, _ in problems)
    return _bound_ms(bytes_, bf16_flops=flops)


def _time_wgrad(problems, dtype):
    from tacotron_multispeaker_torch.ops import wgrad
    ms = cuda_time_ms(lambda: wgrad.wgrad(problems, dtype), reps=5)
    plain_ms = cuda_time_ms(lambda: wgrad.wgrad_reference(problems, dtype), reps=2)
    return ms, plain_ms


def _check_wgrad(problems, label):
    """wgrad against its plain version on one backward's factors, rounding
    them to float32 and to bfloat16; returns the worst error.  Both sides
    multiply the same rounded factors exactly in f32 (a bf16 x bf16 product
    is exact there) and differ in summation order only (row ranges over
    blocks against cuBLAS without TF32): 1e-4 of each output's peak."""
    import torch
    from tacotron_multispeaker_torch.ops import wgrad
    worst = 0.0
    for cdt in (torch.float32, torch.bfloat16):
        out = wgrad.wgrad(problems, cdt)
        ref = wgrad.wgrad_reference(problems, cdt)
        torch.cuda.synchronize()
        errs = [_rel_err(c, c_r) for (c, _), (c_r, _) in zip(out, ref)]
        errs += [_rel_err(b, b_r) for (_, b), (_, b_r) in zip(out, ref) if b is not None]
        log(f"[wgrad] {label} {str(cdt)[6:]}: max|kernel-plain|/max|plain| over "
            f"{len(errs)} outputs {max(errs):.3e} (tol 1e-4)")
        if not max(errs) <= 1e-4:
            raise AssertionError(f"wgrad disagrees with its plain version: {label} {errs}")
        worst = max(worst, *errs)
    return worst


def phase_bigru_bwd():
    import torch
    from tacotron_multispeaker_torch.ops import gru_scan as gs
    F, B = 128, 32
    names = ("dxg", "dxc", "dwhg", "dwhc", "dh0")
    # relative to each output's peak.  f32: the same arithmetic in another
    # sum order (the weight gradients sum T*B rows) -> 1e-4.  bf16: a sum
    # landing on a rounding boundary flips one bf16 ulp of a matmul input
    # (2^-8 relative), which the reverse recurrence carries -> 5e-2.
    tol = {torch.float32: 1e-4, torch.bfloat16: 5e-2}

    def case(T, dtype, seed):
        xg, xc, whg, whc, h0 = _bigru_inputs(T, B, F, dtype, seed)
        ys = gs.bigru_scan(xg, xc, whg, whc, h0)
        hprev = torch.cat([h0[None].to(dtype), ys[:-1]]).contiguous()
        g = torch.Generator(device="cuda").manual_seed(seed)
        dys = torch.randn(tuple(ys.shape), generator=g, device="cuda").to(dtype)
        return xg, xc, hprev, dys, whg, whc

    worst = 0.0
    for T in (192, 1000):
        for dtype in (torch.float32, torch.bfloat16):
            args = case(T, dtype, seed=T + 1)
            out = gs.bigru_scan_bwd(*args)
            ref = gs.bigru_scan_bwd_reference(*args)
            torch.cuda.synchronize()
            errs = {n: _rel_err(a, b) for n, a, b in zip(names, out, ref)}
            log(f"[bigru_scan_bwd] T={T} B={B} F={F} {str(dtype)[6:]}: max|kernel-plain|/"
                f"max|plain| " + " ".join(f"{n} {e:.3e}" for n, e in errs.items())
                + f" (tol {tol[dtype]:.0e})")
            if not all(e <= tol[dtype] for e in errs.values()):
                raise AssertionError(f"bigru_scan_bwd disagrees with its plain version: {errs}")
            worst = max(worst, *errs.values())
    # timing at the post-net shape of the B=32 train batch (T = 1000 frames)
    T, dtype = 1000, torch.bfloat16
    args = case(T, dtype, seed=11)
    ms = cuda_time_ms(lambda: gs._bwd_kernel(*args), reps=5)
    plain_ms = cuda_time_ms(lambda: gs.bigru_scan_bwd_reference(*args), reps=1)
    xg, xc, hprev, dys, whg, whc = args
    dxg, dxc, rh, dh0 = gs._bwd_kernel(*args)
    bytes_ = _nbytes(xg, xc, hprev, dys, whg, whc, dxg, dxc, rh, dh0)
    bound_ms, bound_by = _bound_ms(bytes_, bf16_flops=T * 2 * B * 12 * F * F)
    problems = ([(hprev[:, d], dxg[:, d], False) for d in range(2)]
                + [(rh[:, d], dxc[:, d], False) for d in range(2)])
    w_err = _check_wgrad(problems, f"bigru backward, 4 products over {T * B} rows")
    w_ms, w_plain = _time_wgrad(problems, dtype)
    log(f"[bigru_scan_bwd] T={T} B={B} F={F} bf16: kernel {ms:.3f} ms, plain (with its "
        f"weight gradients) {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}); its "
        f"wgrad launch {w_ms:.3f} ms (plain {w_plain:.3f} ms, bound "
        f"{_wgrad_bound_ms(problems)[0]:.4f} ms)")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "shape": f"T={T} B={B} F={F} bf16",
            "error": "max |kernel - plain| / max |plain| over every output"}, w_err


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
    """Swap every training and serving kernel wrapper for its plain version
    (which runs on CUDA tensors too) inside the block."""

    def __enter__(self):
        from tacotron_multispeaker_torch.ops import decoder_loop as dl
        from tacotron_multispeaker_torch.ops import gru_scan as gs
        from tacotron_multispeaker_torch.ops import teacher_decoder as td
        self.swaps = [(gs, "bigru_scan", gs.bigru_scan_reference),
                      (gs, "bigru_scan_bwd", gs.bigru_scan_bwd_reference),
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


def phase_teacher(bigru_wgrad_err):
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
    worst = {"fwd": 0.0, "bwd": 0.0}
    for dtype, S in ((torch.float32, 12), (torch.bfloat16, 20)):
        w, args = _teacher_case(B, L, S, dtype, seed=21)
        png, pnc, h0a, h0d, keys, memory, mask = args
        out = td.teacher_decoder_fwd(png, pnc, h0a, h0d, w, keys, memory, mask)
        ref = td.teacher_decoder_fwd_reference(png, pnc, h0a, h0d, w, keys, memory, mask)
        torch.cuda.synchronize()
        errs = {"xs": _rel_err(out[0], ref[0]), "ha": _rel_err(out[2], ref[2]),
                **{f"hd_{i}": _rel_err(out[3][i], ref[3][i]) for i in range(N)}}
        e_al = (out[1] - ref[1]).abs().max().item()
        xt, at = ftol[dtype]
        log(f"[teacher_fwd] B={B} L={L} S={S} H=A={H} D={D} {str(dtype)[6:]}: "
            + " ".join(f"{n} {e:.3e}" for n, e in errs.items())
            + f" (relative, tol {xt:.0e}); align {e_al:.3e} (absolute, tol {at:.0e})")
        if not (all(e <= xt for e in errs.values()) and e_al <= at):
            raise AssertionError(f"teacher_decoder_fwd disagrees with its plain version")
        worst["fwd"] = max(worst["fwd"], *errs.values(), e_al)
        # backward from the plain forward's states, random cotangents
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

    # d_keys at the full train shape, both dtypes (absolute on f32 sums of
    # 200 steps; keys and v rounded on both sides)
    S = 200
    g = torch.Generator(device="cuda").manual_seed(23)
    dk_worst = 0.0
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-4)):
        keys = (torch.randn(B, L, A, generator=g, device="cuda") * 0.3).to(dtype)
        q = torch.randn(S, B, A, generator=g, device="cuda")
        de = torch.randn(S, B, L, generator=g, device="cuda") * 1e-2
        v = (torch.randn(A, generator=g, device="cuda") * 0.2).to(dtype)
        dk, dv = td.dkeys(keys, q, de, v)
        dk_r, dv_r = td.dkeys_reference(keys, q, de, v)
        torch.cuda.synchronize()
        e_k, e_v = _rel_err(dk, dk_r), _rel_err(dv, dv_r)
        log(f"[dkeys] S={S} B={B} L={L} A={A} {str(dtype)[6:]}: dkeys {e_k:.3e} dv "
            f"{e_v:.3e} (relative to peak, tol {tol:.0e})")
        if not (e_k <= tol and e_v <= tol):
            raise AssertionError("dkeys disagrees with its plain version")
        dk_worst = max(dk_worst, e_k, e_v)

    # timing at the B=32 train batch's shape: S=200 steps, L=192, bf16
    dtype = torch.bfloat16
    w, args = _teacher_case(B, L, S, dtype, seed=24)
    png, pnc, h0a, h0d, keys, memory, mask = args
    fwd = lambda: td.teacher_decoder_fwd(png, pnc, h0a, h0d, w, keys, memory, mask)
    ms = cuda_time_ms(fwd, reps=3)
    plain_ms = cuda_time_ms(lambda: td.teacher_decoder_fwd_reference(
        png, pnc, h0a, h0d, w, keys, memory, mask), reps=1)
    xs, align, ha, hds = fwd()
    wts = [t for t in w.flat()]
    macs = (H * 2 * H + H * H + H * A + D * 4 * H + H * H + L * D
            + N * (3 * H * H + 2 * H * H + H * H))
    bound = _bound_ms(_nbytes(*wts, png, pnc, h0a, h0d, keys, memory, mask, xs, align, ha,
                              *hds),
                      bf16_flops=2 * S * B * macs, f32_flops=S * B * (3 * L * A + 4 * L))
    result["teacher_decoder_fwd"] = {"max_abs_err": worst["fwd"], "ms": ms,
                                     "plain_ms": plain_ms, "bound_ms": bound[0],
                                     "bound_by": bound[1],
                                     "shape": f"B={B} L={L} S={S} H=A={H} D={D} bf16",
                                     "error": "xs/states relative to peak, align absolute"}
    log(f"[teacher_fwd] B={B} L={L} S={S} bf16: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound[0]:.4f} ms ({bound[1]})")
    shift = lambda a, a0: torch.cat([a0[None].to(a.dtype), a[:-1]]).contiguous()
    hap = shift(ha, h0a)
    hdps = tuple(shift(hds[i], h0d[i]) for i in range(N))
    pp = shift(align, torch.zeros_like(align[0]))
    dxs = torch.randn(tuple(xs.shape), generator=g, device="cuda")
    dal = torch.randn(tuple(align.shape), generator=g, device="cuda") * 0.1
    bargs = (png, pnc, ha, hap, hds, hdps, xs, align, pp, dxs, dal, w, keys, memory, mask)
    ms = cuda_time_ms(lambda: td._bwd_kernel(*bargs), reps=3)
    plain_ms = cuda_time_ms(lambda: td.teacher_decoder_bwd_reference(*bargs), reps=1)
    outs, streams = td._bwd_kernel(*bargs)
    macs = (N * 12 * H * H + H * H + L * D + 4 * H * D + L * D + 2 * H * A + L * D
            + D * 4 * H + 6 * H * H)
    bound = _bound_ms(_nbytes(png, pnc, ha, hap, *hds, *hdps, xs, align, pp, dxs, dal, keys,
                              memory, mask, *wts, *outs, *streams),
                      bf16_flops=2 * S * B * macs, f32_flops=S * B * 5 * L * A)
    result["teacher_decoder_bwd"] = {"max_abs_err": worst["bwd"], "ms": ms,
                                     "plain_ms": plain_ms, "bound_ms": bound[0],
                                     "bound_by": bound[1],
                                     "shape": f"B={B} L={L} S={S} H=A={H} D={D} bf16",
                                     "error": "max |kernel - plain| / max |plain| over every "
                                              "gradient of the backward"}
    log(f"[teacher_bwd] B={B} L={L} S={S} bf16: kernel {ms:.3f} ms, plain (with its weight "
        f"gradients) {plain_ms:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
    # its weight-gradient reduction (one grouped wgrad launch, 11 products)
    problems = td._weight_grad_problems(ha, hap, hdps, outs, streams)
    w_err = _check_wgrad(problems, f"teacher backward, {len(problems)} products over "
                                   f"{S * B} rows")
    w_ms, w_plain = _time_wgrad(problems, dtype)
    w_bound = _wgrad_bound_ms(problems)
    result["wgrad"] = {"max_abs_err": max(w_err, bigru_wgrad_err), "ms": w_ms,
                       "plain_ms": w_plain, "bound_ms": w_bound[0], "bound_by": w_bound[1],
                       "shape": f"the teacher backward's {len(problems)} products over "
                                f"S*B={S * B} rows, bf16",
                       "error": "max |kernel - plain| / max |plain| over every product and "
                                "bias of both backward kernels, f32 and bf16 rounding"}
    log(f"[wgrad] teacher backward, {len(problems)} products over {S * B} rows bf16: kernel "
        f"{w_ms:.3f} ms, plain {w_plain:.3f} ms, bound {w_bound[0]:.4f} ms ({w_bound[1]})")
    # d_keys timing at the same shape
    q = (ha.to(dtype).float() @ w.wq.float()).contiguous()
    de = outs[2]
    ms = cuda_time_ms(lambda: td.dkeys(keys, q, de, w.v), reps=5)
    plain_ms = cuda_time_ms(lambda: td.dkeys_reference(keys, q, de, w.v), reps=1)
    bound = _bound_ms(_nbytes(keys, q, de, w.v) + B * L * A * 4 + A * 4,
                      f32_flops=7 * S * B * L * A)
    result["dkeys"] = {"max_abs_err": dk_worst, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound[0], "bound_by": bound[1],
                       "shape": f"S={S} B={B} L={L} A={A} bf16 keys",
                       "error": "relative to peak"}
    log(f"[dkeys] S={S} B={B} L={L} A={A} bf16: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound[0]:.4f} ms ({bound[1]})")
    return result


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


def phase_train_reference():
    """One f32 step (dropout off) at full width on the card against the same
    step on the CPU plain path, from the same weights and batch."""
    import torch
    from tacotron_multispeaker_torch import training
    from tacotron_multispeaker_torch.config import get_config
    cfg = get_config("multispeaker_vctk", "model.compute_dtype=float32,model.prenet_dropout=0.0")
    batch = _train_batch(cfg, B=2, L=23, T=40, seed=3, device="cpu")
    runs = {}
    for dev in ("cpu", "cuda"):
        model, state = training.create_train_state(cfg, seed=1, device=dev)
        step = training.make_train_step(cfg, model)
        state, m = step(state, *(a.to(dev) for a in batch))
        torch.cuda.synchronize()
        runs[dev] = ({k: float(m[k]) for k in ("loss", "grad_norm")},
                     {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                     {n: b.detach().cpu() for n, b in model.named_buffers()
                      if n.endswith((".mean", ".var"))},
                     {n: p.detach().cpu() for n, p in model.named_parameters()})
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
    log(f"[train f32] multispeaker_vctk B=2 L=23 T=40, card vs cpu plain path: loss "
        f"{mc['loss']:.6f} vs {mg['loss']:.6f} (rel {errs['loss']:.2e}, tol 1e-5), grad_norm "
        f"{mc['grad_norm']:.6f} vs {mg['grad_norm']:.6f} (rel {errs['grad_norm']:.2e}, tol "
        f"1e-4), worst gradient leaf {g_err:.2e} (tol 1e-3) over {len(gc)} leaves, running "
        f"stats {b_err:.2e} (tol 1e-5) over {len(bc)}, params after update {p_err:.2e} "
        f"(abs, tol 1e-6)")
    if not (errs["loss"] <= 1e-5 and errs["grad_norm"] <= 1e-4 and g_err <= 1e-3
            and b_err <= 1e-5 and p_err <= 1e-6):
        raise AssertionError("the f32 train step on the card disagrees with the CPU")


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


TRAIN_LAUNCHES = {"bigru_scan": 2, "decoder_loop": 0, "bigru_scan_bwd": 2,
                  "teacher_decoder_fwd": 1, "dkeys": 1, "teacher_decoder_bwd": 1,
                  "wgrad": 3}


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
    return total


# --------------------------------------------------------------------------
# phase 4: the generate path on the card against the plain path on the CPU
# --------------------------------------------------------------------------

def phase_generate_reference():
    import numpy as np
    import torch
    from tacotron_multispeaker_torch.config import get_config
    from tacotron_multispeaker_torch.models import create_model
    cfg = get_config("multispeaker_vctk",
                     "model.compute_dtype=float32,model.prenet_dropout=0.0")
    model = create_model("tacotron", cfg).reset_parameters(
        torch.Generator().manual_seed(1)).eval()
    rs = np.random.RandomState(0)
    inputs = torch.as_tensor(rs.randint(2, 60, (2, 37)))
    lengths = torch.tensor([37, 21])
    sids = torch.tensor([3, 100])
    with torch.inference_mode():
        ref = model.generate(inputs, lengths, sids, max_iters=20)
        model.cuda()
        out = model.generate(inputs.cuda(), lengths.cuda(), sids.cuda(), max_iters=20)
        torch.cuda.synchronize()
    tol = 2e-3
    for name, a, b in zip(("mel", "linear", "align"), out, ref):
        err = (a.cpu() - b).abs().max().item()
        log(f"[generate] full-width f32, card vs cpu plain path: {name} "
            f"{tuple(a.shape)} max|diff| {err:.3e} (tol {tol:.0e})")
        if not (torch.isfinite(a).all() and err <= tol):
            raise AssertionError(f"generate on the card disagrees with the CPU: {name} {err}")


def phase_generate_bf16():
    """The serving precision (bf16, dropout off) through ``generate`` on the
    card, with the kernels and then with their plain versions swapped in:
    everything around the kernels is the same cuBLAS/elementwise work."""
    import numpy as np
    import torch
    from tacotron_multispeaker_torch.config import get_config
    from tacotron_multispeaker_torch.models import create_model
    from tacotron_multispeaker_torch.ops import decoder_loop as dl
    from tacotron_multispeaker_torch.ops import gru_scan as gs
    cfg = get_config("multispeaker_vctk", "model.prenet_dropout=0.0")
    model = create_model("tacotron", cfg).reset_parameters(
        torch.Generator().manual_seed(2)).eval().cuda()
    rs = np.random.RandomState(1)
    inputs = torch.as_tensor(rs.randint(2, 60, (2, 96))).cuda()
    lengths = torch.tensor([96, 53]).cuda()
    sids = torch.tensor([5, 77]).cuda()
    run = lambda: model.generate(inputs, lengths, sids, max_iters=20)
    with torch.inference_mode():
        before = (gs.launches, dl.launches)
        out = run()
        if (gs.launches - before[0], dl.launches - before[1]) != (2, 1):
            raise AssertionError("bf16 generate did not go through both kernels")
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
        log(f"[generate] full-width bf16, kernels vs plain versions on the card: "
            f"{name} {tuple(a.shape)} max|diff|{'' if name == 'align' else '/max|plain|'} "
            f"{err:.3e} (tol {tol[name]:.0e}; max|plain| {b.abs().max().item():.3e})")
        if not (torch.isfinite(a).all() and err <= tol[name]):
            raise AssertionError(f"bf16 generate disagrees with its plain version: {name} {err}")


# --------------------------------------------------------------------------
# phase 5: serving
# --------------------------------------------------------------------------

def phase_serve():
    import numpy as np
    import torch
    from scipy.io import wavfile
    from tacotron_multispeaker_torch.config import get_config
    from tacotron_multispeaker_torch.ops import decoder_loop, gru_scan
    from tacotron_multispeaker_torch.synthesizer import Synthesizer
    from tacotron_multispeaker_torch.text import text_to_sequence

    cfg = get_config("multispeaker_vctk")
    syn = Synthesizer(cfg, seed=0)
    sr = cfg.audio.sample_rate
    max_samples = cfg.model.max_iters * cfg.model.outputs_per_step * cfg.audio.hop_length
    counts = lambda: (gru_scan.launches, decoder_loop.launches)

    def expect(before, n_requests, what):
        got = (counts()[0] - before[0], counts()[1] - before[1])
        want = (2 * n_requests, n_requests)
        if got != want:
            raise AssertionError(f"{what}: launches (bigru_scan, decoder_loop) {got}, "
                                 f"expected {want}")

    def check_wav(w, what):
        if not (w.ndim == 1 and 0 < w.shape[0] <= max_samples and np.isfinite(w).all()):
            raise AssertionError(f"{what}: bad wav shape {w.shape} or non-finite values")

    reset_counts()
    t0 = time.perf_counter()
    syn.warmup()
    torch.cuda.synchronize()
    log(f"[serve] warmup (both input buckets) {time.perf_counter() - t0:.2f} s")

    texts = [
        ("Hello there.", 0),
        ("The quick brown fox jumps over the lazy dog near the river bank.", 17),
        ("Printing, in the only sense with which we are at present concerned, differs "
         "from most if not from all the arts and crafts represented in the exhibition.", 42),
        ("He was the last of his line; and yet, in all the years that followed, nobody "
         "could say for certain where the old house had stood, or who had built it.", 108),
        ("One two three.", 64),
    ]
    buckets = set()
    for text, spk in texts:
        n = len(text_to_sequence(text, cfg.cleaners))
        bucket = syn.serve_bucket_for([text])
        buckets.add(bucket)
        before = counts()
        t0 = time.perf_counter()
        data = syn.synthesize(text, speaker_id=spk, seed=spk)
        dt = time.perf_counter() - t0
        expect(before, 1, f"synthesize(len={n})")
        rate, pcm = wavfile.read(io.BytesIO(data))
        if rate != sr or not 0 < pcm.shape[0] <= max_samples:
            raise AssertionError(f"synthesize(len={n}): wav rate {rate}, {pcm.shape}")
        before = counts()
        wavs, aligns = syn.synthesize_batch([text], [spk], seed=spk, pad_to=bucket)
        expect(before, 1, f"synthesize_batch(len={n})")
        check_wav(wavs[0], f"request len={n}")
        if aligns.shape != (1, cfg.model.max_iters, bucket):
            raise AssertionError(f"alignments {aligns.shape}")
        full_s, trim_s = max_samples / sr, pcm.shape[0] / sr
        log(f"[serve] request len={n:3d} bucket={bucket} speaker={spk:3d}: "
            f"{dt * 1e3:8.2f} ms, {full_s:.2f} s audio decoded "
            f"({full_s / dt:7.2f} audio-s/s), {trim_s:.3f} s after the endpoint trim")
    if buckets != {96, 192}:
        raise AssertionError(f"requests covered buckets {buckets}, need 96 and 192")

    batch = [texts[i % len(texts)][0] for i in range(32)]
    spks = [(7 * i) % cfg.model.num_speakers for i in range(32)]
    before = counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wavs, aligns = syn.synthesize_batch(batch, spks, max_iters=200, seed=1,
                                        pad_to=syn.serve_bucket_for(batch))
    dt = time.perf_counter() - t0
    expect(before, 1, "synthesize_batch(B=32)")
    for i, w in enumerate(wavs):
        check_wav(w, f"batch row {i}")
    audio_s = sum(w.shape[0] for w in wavs) / sr
    untrimmed_s = 32 * max_samples / sr
    log(f"[serve] batch B=32 max_iters=200: {dt * 1e3:.2f} ms, {untrimmed_s:.1f} s "
        f"audio decoded ({untrimmed_s / dt:.2f} audio-s/s), {audio_s:.3f} s after the "
        f"endpoint trim")
    total = read_counts()
    log(f"[serve] launches over the serving run: {json.dumps(total)}")
    if min(total["bigru_scan"], total["decoder_loop"]) <= 0:
        raise AssertionError("a kernel of the serving path was never launched")
    phase_profile([
        ("B=1 request L=192", lambda: syn.synthesize_batch([texts[2][0]], [texts[2][1]],
                                                           pad_to=192)),
        ("B=32 batch L=192", lambda: syn.synthesize_batch(batch, spks, pad_to=192))])
    return total


# --------------------------------------------------------------------------
# phase 6: where the time goes
# --------------------------------------------------------------------------

def phase_profile(runs):
    """torch.profiler over each (label, fn) run: device time by kernel, and
    device-busy time (union of the kernel and copy intervals) against the
    host's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for label, fn in runs:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events() if e.device_type == DeviceType.CUDA)
        if not spans:
            log(f"[profile] {label}: the profiler saw no device time (not measured)")
            continue
        busy_us, cur_s, cur_e, by_name = 0.0, None, None, {}
        for s, e, name in spans:
            tot, n = by_name.get(name, (0.0, 0))
            by_name[name] = (tot + (e - s), n + 1)
            if cur_e is None or s > cur_e:
                busy_us += 0.0 if cur_e is None else cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy_ms = (busy_us + cur_e - cur_s) / 1e3
        log(f"[profile] {label}: wall {wall_ms:.2f} ms (profiler on), "
            f"device busy {busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
            f"{len(spans)} device spans")
        for name, (tot, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:14]:
            log(f"[profile]   {tot / 1e3:9.3f} ms {100 * tot / 1e3 / busy_ms:5.1f}% "
                f"x{n:<5d} {name[:90]}")


KERNEL_META = {
    # name: (source, the TPU kernel it replaces, the path whose launches count)
    "bigru_scan": ("tacotron_multispeaker_torch/csrc/bigru_scan.cu",
                   "tacotron_multispeaker_tpu/ops/gru_scan.py:366", "serve"),
    "decoder_loop": ("tacotron_multispeaker_torch/csrc/decoder_loop.cu",
                     "tacotron_multispeaker_tpu/ops/decoder_loop.py:185", "serve"),
    "bigru_scan_bwd": ("tacotron_multispeaker_torch/csrc/bigru_scan_bwd.cu",
                       "tacotron_multispeaker_tpu/ops/gru_scan.py:485", "train"),
    "teacher_decoder_fwd": ("tacotron_multispeaker_torch/csrc/teacher_decoder_fwd.cu",
                            "tacotron_multispeaker_tpu/ops/teacher_decoder.py:190", "train"),
    "dkeys": ("tacotron_multispeaker_torch/csrc/dkeys.cu",
              "tacotron_multispeaker_tpu/ops/teacher_decoder.py:298", "train"),
    "teacher_decoder_bwd": ("tacotron_multispeaker_torch/csrc/teacher_decoder_bwd.cu",
                            "tacotron_multispeaker_tpu/ops/teacher_decoder.py:498", "train"),
    "wgrad": ("tacotron_multispeaker_torch/csrc/wgrad.cu",
              "tacotron_multispeaker_tpu/ops/teacher_decoder.py:498", "train"),
}
LIBRARY_NULL = {
    "bigru_scan": "torch.nn.GRU applies the reset gate after the matmul, another function",
    "decoder_loop": "no one PyTorch call decodes",
    "bigru_scan_bwd": "no one PyTorch call computes the legacy-GRU backward",
    "teacher_decoder_fwd": "no one PyTorch call runs the attention decoder scan",
    "dkeys": "no one PyTorch call computes this tanh-derivative reduction",
    "teacher_decoder_bwd": "no one PyTorch call runs the decoder scan's backward",
    "wgrad": "part of the backward kernels (rounded factors, grouped); a matmul is not "
             "the kernel's function",
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
    kern["bigru_scan_bwd"], bigru_wgrad_err = phase_bigru_bwd()
    kern.update(phase_teacher(bigru_wgrad_err))
    phase_generate_reference()
    phase_generate_bf16()
    launches = {"serve": phase_serve()}
    phase_train_reference()
    phase_train_bf16()
    launches["train"] = phase_train()
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[path][name], "launches_by_path": {
             p: launches[p][name] for p in ("serve", "train")},
         "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"], "bound_ms": kern[name]["bound_ms"],
         "bound_by": kern[name]["bound_by"], "library_ms": None,
         "library_ms_null": LIBRARY_NULL[name], "shape": kern[name]["shape"]}
        for name, (src, replaces, path) in KERNEL_META.items()]}
    log(smi)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
