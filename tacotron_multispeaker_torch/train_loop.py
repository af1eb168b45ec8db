"""The training loop: preprocessed corpus → train steps → checkpoints.

Port of ``tacotron_multispeaker_tpu/train_loop.py``.  Per step: one
``make_train_step`` update on the device.  Its batch comes from the
``Feeder`` (``pipeline="feeder"``) or from ``pipeline_workers`` worker
processes over the Feeder's plan (``pipeline="grain"``,
data/grain_pipeline.py), either on a prefetch thread, and lands in
page-locked memory on a CUDA device; :class:`DeviceBatches` copies it to
the device on a side stream one batch ahead of the step.  Every
``checkpoint_interval`` steps: a checkpoint
(utils/checkpoint.py), then inference on a training example through the
``Synthesizer`` with the training weights, written as a Griffin-Lim WAV,
its alignments (``.npy``) and, where matplotlib is installed, their plot
(the reference's artifact-driven workflow).  Summaries go to
``metrics.jsonl`` and, with ``TACOTRON_TB=1``, to TensorBoard event files
(utils/metrics.py), the alignment plots as images.

One host sync every ``sync_every = min(summary_interval, 32)`` steps reads
the loss and aborts on a non-finite one; summaries at steps ≤ 5 and every
``summary_interval``; after a divergence abort no checkpoint is written,
otherwise the final state is saved.  ``profile_steps=(START, STOP)`` traces
steps [START, STOP) with ``torch.profiler`` (tracing.py), where the loop's
spans ``train.next_batch``, ``train.step``, ``train.sync`` and
``train.checkpoint`` name what the host was doing.

In a process group (``torchrun``, or ``parallel.initialize_distributed``)
every rank runs this loop as one position of the (data, model) mesh that
``parallel.make_mesh`` builds from ``cfg.parallel``: its step is
``training.make_sharded_train_step``'s, its input pipeline loads only the
rows of each global batch that the step takes (``training.batch_slice``),
the checkpoint holds the full state in the single-process layout (written
by rank 0 from rows gathered over the model axis), and rank 0 evaluates
from that full state while the others wait at a barrier.  The loss is the
same on every rank, so the divergence check and the final save take the
same branch everywhere.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from . import tracing
from .config import Config
from .data.feeder import Feeder, PrefetchIterator, pinned_empty
from .device import resolve_device
from .parallel.distributed import barrier, is_primary_host
from .parallel.mesh import make_mesh
from .training import batch_slice, create_train_state, make_sharded_train_step, train_route
from .utils import infolog, plot
from .utils.checkpoint import CheckpointManager, full_state
from .utils.metrics import MetricsWriter

log = infolog.log

# the grain loader's limit on one batch (seconds): a stuck worker process
# fails the run instead of hanging it
LOADER_TIMEOUT_S = 600


def train(log_dir: str, data_dir: str, cfg: Config, *, max_steps: int | None = None,
          restore: bool = True, profile_steps: tuple[int, int] | None = None,
          cmudict_path: str | None = None, pipeline: str = "feeder",
          pipeline_workers: int = 0, device=None, mesh=None) -> dict:
    """Run training; returns the final step and metrics, ``step_seconds``
    (the host time of each of the last ≤ 100 steps, as (step, seconds);
    checkpoints and eval artifacts excluded) and, with ``profile_steps``,
    the profiled window's summary under ``profile``.  ``pipeline``:
    "feeder" or "grain" (``pipeline_workers`` worker processes; 0 is
    in-process).  ``device=None`` is the CUDA device (raises without one),
    or in a process group the rank's device.  ``mesh``: the mesh of ranks
    (default ``parallel.make_mesh(cfg.parallel)``: one rank outside a
    process group); every rank of it must call ``train``."""
    if pipeline not in ("feeder", "grain"):
        raise ValueError(f"pipeline={pipeline!r}: 'feeder' or 'grain'")
    if mesh is None:
        mesh = make_mesh(cfg.parallel, device=None if device is None
                         else resolve_device(device))
    elif device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    if cfg.train.batch_size % mesh.data != 0:
        raise ValueError(f"train.batch_size={cfg.train.batch_size} must be divisible by "
                         f"the data-parallel axis size {mesh.data}")
    dev = resolve_device(mesh.device)
    os.makedirs(log_dir, exist_ok=True)
    infolog.init(os.path.join(log_dir, "train.log"), cfg.name, enabled=is_primary_host())
    log(cfg.debug_string())
    log(f"device: {dev}" + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
                            else ""))
    index, count = batch_slice(cfg, mesh)
    if mesh.size > 1:
        log(f"mesh ({mesh.data}, {mesh.model}), {torch.distributed.get_backend()}: "
            f"{train_route(cfg, mesh)} step, each rank loads 1/{count} of every batch")

    model, state = create_train_state(cfg, cfg.train.seed, mesh=mesh)
    log(f"initialized model: {sum(p.numel() for p in model.parameters()):,} params")
    ckpt = CheckpointManager(os.path.join(log_dir, "checkpoints"))
    if restore and ckpt.latest_step() is not None:
        ckpt.restore(state)
        log(f"resumed from checkpoint at step {state.step}")
    # read once, before any rank can write: every rank then takes the same
    # branch at the final save (its gather is collective)
    saved = set(ckpt.steps())
    step_fn = make_sharded_train_step(cfg, model, mesh)

    writer = MetricsWriter(log_dir, use_tensorboard=os.environ.get("TACOTRON_TB") == "1",
                           enabled=is_primary_host())
    synth = None
    if is_primary_host():
        from .synthesizer import Synthesizer
        synth = Synthesizer(cfg, device=dev, seed=cfg.train.seed)
    pin = dev.type == "cuda"
    if pipeline == "grain":
        from .data.grain_pipeline import grain_global_batches
        source = grain_global_batches(data_dir, cfg, cmudict_path=cmudict_path,
                                      worker_count=pipeline_workers, pin_memory=pin,
                                      timeout=LOADER_TIMEOUT_S, process_index=index,
                                      process_count=count)
    else:
        source = iter(Feeder(data_dir, cfg, cmudict_path=cmudict_path,
                             empty=pinned_empty if pin else None, process_index=index,
                             process_count=count))
    batches = PrefetchIterator(source, prefetch=4)
    feed = DeviceBatches(batches, dev)

    max_steps = max_steps if max_steps is not None else cfg.train.max_steps
    metrics = {}
    t_last = time.time()
    window = []
    prof, prof_t0, prof_summary = None, 0.0, None
    diverged = False
    # The step enqueues its work without waiting for the device; reading the
    # loss waits.  One read every ``sync_every`` steps bounds how far the
    # host runs ahead (and with it the batches held in memory), and its
    # value feeds the divergence check.
    step = state.step
    sync_every = max(1, min(cfg.train.summary_interval, 32))

    def check_finite(loss: float) -> None:
        nonlocal diverged
        if not np.isfinite(loss):
            diverged = True
            log(f"loss exploded by step {step}; aborting")
            raise FloatingPointError(f"non-finite loss at step {step}")

    try:
        while step < max_steps:
            if profile_steps is not None:
                if prof is None and step == profile_steps[0]:
                    prof, prof_t0 = tracing.start_profile(dev)
                    log(f"profiler trace started at step {step}")
                elif prof is not None and step >= profile_steps[1]:
                    prof_summary = tracing.stop_profile(prof, prof_t0, dev, log_dir,
                                                        profile_steps)
                    prof = None
            host_batch, args = feed.take()
            with tracing.span("train.step", device=dev, step=step):
                state, metrics = step_fn(state, *args)
            step += 1
            if step < max_steps:
                feed.prefetch()         # the next batch's copy runs beside this step
            if step % sync_every == 0:
                with tracing.span("train.sync", device=dev):
                    check_finite(float(metrics["loss"]))
            t_now = time.time()
            window = (window + [(step, t_now - t_last)])[-100:]
            t_last = t_now
            sec_per_step = float(np.mean([dt for _, dt in window]))
            if step % cfg.train.summary_interval == 0 or step <= 5:
                with tracing.span("train.sync", device=dev):
                    loss = float(metrics["loss"])
                    check_finite(loss)
                    values = {k: float(metrics[k]) for k in
                              ("loss", "mel_loss", "linear_loss", "grad_norm", "lr")}
                writer.scalars(step, {**values, "sec_per_step": sec_per_step})
                log(f"step {step:7d}  loss={loss:.5f}  mel={values['mel_loss']:.5f}  "
                    f"lin={values['linear_loss']:.5f}  gnorm={values['grad_norm']:.3f}  "
                    f"lr={values['lr']:.6f}  sec/step={sec_per_step:.3f}")
            if step % cfg.train.checkpoint_interval == 0:
                with tracing.span("train.checkpoint", device=dev, step=step):
                    # the interval need not divide sync_every: check here, so a
                    # blow-up is never written as a restorable checkpoint
                    check_finite(float(metrics["loss"]))
                    _checkpoint_and_eval(ckpt, state, step, synth, host_batch, cfg, log_dir,
                                         writer)
                    saved.add(step)
                    # the other ranks wait here for rank 0's eval, not inside
                    # the next step's collectives
                    barrier()
                t_last = time.time()        # the next step's time leaves this out
    finally:
        if prof is not None:
            prof_summary = tracing.stop_profile(prof, prof_t0, dev, log_dir, profile_steps)
        batches.close()
        writer.close()
        if diverged:
            # saving here would make the diverged state the newest
            # checkpoint, and restore=True would resume from it
            log("divergence abort: final state NOT checkpointed; latest restorable "
                "checkpoint is the last finite one")
        elif state.step not in saved:
            ckpt.save(state.step, state)
    out = {"step": state.step, **{k: float(v) for k, v in metrics.items()},
           "step_seconds": window}
    if prof_summary is not None:
        out["profile"] = prof_summary
    return out


def batch_to_device(batch, dev, non_blocking: bool = False) -> list[torch.Tensor]:
    """A host ``Batch`` as ``make_train_step``'s arguments on ``dev``: the
    id and length arrays as int64, the targets in their own dtype (float32,
    bfloat16, or the int16 PCM of ``train.targets_from_wav``)."""
    to = lambda a: torch.as_tensor(a).to(dev, non_blocking=non_blocking)
    return [to(batch.inputs).long(), to(batch.input_lengths).long(), to(batch.mel_targets),
            to(batch.linear_targets), to(batch.target_lengths).long(),
            to(batch.speaker_ids).long()]


class DeviceBatches:
    """Host batches → (host batch, ``make_train_step``'s arguments on
    ``dev``).  On a CUDA device :meth:`prefetch` issues the next batch's
    copy (``non_blocking``; asynchronous from page-locked memory) on a side
    stream and records an event; :meth:`take` makes the current stream
    wait on that event and marks the copies as used by it
    (``record_stream``), so the allocator reuses their memory only after
    the step that reads them.  Elsewhere the copy is plain."""

    def __init__(self, batches, dev: torch.device):
        self._batches = batches
        self.dev = dev
        self._stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self._next = None

    def prefetch(self) -> None:
        with tracing.span("train.next_batch", device=self.dev):
            host = next(self._batches)
        if self._stream is None:
            self._next = (host, batch_to_device(host, self.dev), None)
            return
        with torch.cuda.stream(self._stream):
            args = batch_to_device(host, self.dev, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        self._next = (host, args, done)

    def take(self):
        if self._next is None:
            self.prefetch()
        host, args, done = self._next
        self._next = None
        if done is not None:
            stream = torch.cuda.current_stream(self.dev)
            stream.wait_event(done)
            for a in args:
                a.record_stream(stream)
        return host, args


def _checkpoint_and_eval(ckpt, state, step, synth, batch, cfg, log_dir, writer=None):
    """Save a checkpoint (the full state: every rank gathers, rank 0
    writes), then, on rank 0, synthesize the batch's first example with the
    full training weights and write its WAV, alignments and alignment plot
    (also to ``writer``'s TensorBoard images).
    A failure of the artifacts is logged and training goes on; loading the
    weights into the synthesizer is outside that: a state that does not fit
    the model raises."""
    log(f"saving checkpoint at step {step}")
    full = full_state(state)
    ckpt.save(step, state, full)
    if synth is None:          # the other ranks only gather
        return
    synth.model.load_state_dict(full[0], strict=True)
    try:
        dev = synth.device
        row = lambda a: torch.as_tensor(a[:1], device=dev).long()
        fn = synth._make_fn(cfg.model.max_iters)
        wav, aligns, _, _ = fn(row(batch.inputs), row(batch.input_lengths),
                            row(batch.speaker_ids), torch.Generator(device=dev).manual_seed(0))
        synth.ap.save_wav(wav[0].cpu().numpy(), os.path.join(log_dir, f"step-{step}-audio.wav"))
        align = aligns[0].cpu().numpy()
        np.save(os.path.join(log_dir, f"step-{step}-align.npy"), align)
        stamp = time.strftime("%Y-%m-%d %H:%M")
        align_path = os.path.join(log_dir, f"step-{step}-align.png")
        try:
            plot.plot_alignment(align, align_path, info=f"{cfg.name}, step={step}, {stamp}")
            if writer is not None:
                writer.image(step, "alignment", align_path)
        except ImportError as e:    # matplotlib is optional: the .npy holds the alignment
            log(f"alignment plot not drawn ({e})")
        log(f"wrote eval artifacts for step {step}")
    except Exception as e:  # noqa: BLE001 - eval artifacts must never stop training
        rank = torch.distributed.get_rank() if torch.distributed.is_initialized() else 0
        log(f"eval artifact generation failed on rank {rank}: {type(e).__name__}: {e}")
