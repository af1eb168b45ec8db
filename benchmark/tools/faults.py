"""Faults planted in the port for the correctness tests and the limits'
readings.  Each wraps what a driver takes from the port (the synthesizer's
``synthesize_batch``, the train state and step) for as long as the context
lasts, so the drivers' timed loops carry no branch for them."""

from __future__ import annotations

from contextlib import contextmanager
from unittest import mock

import numpy as np

FAULTS = {"synth_batch": ("half_batch", "answer"),
          "train_steps": ("unchanged", "half_batch", "answer")}


def _synth_patch(fault: str):
    from tacotron_multispeaker_torch import synthesizer
    serve = synthesizer.Synthesizer.synthesize_batch

    def half_batch(self, texts, speaker_ids, **kw):
        # the first half of the rows served, and each answer given twice
        h = len(texts) // 2
        wavs, aligns = serve(self, texts[:h], speaker_ids[:h], **kw)
        return wavs + wavs, np.concatenate([aligns, aligns])

    def answer(self, texts, speaker_ids, **kw):
        # one row's waveform altered where it is produced
        wavs, aligns = serve(self, texts, speaker_ids, **kw)
        wavs[0] = wavs[0].copy()
        wavs[0][: len(wavs[0]) // 4] *= 0.5
        return wavs, aligns

    return mock.patch.object(synthesizer.Synthesizer, "synthesize_batch",
                             {"half_batch": half_batch, "answer": answer}[fault])


def _train_patch(fault: str):
    import torch
    from tacotron_multispeaker_torch import training
    if fault == "unchanged":
        create = training.create_train_state

        def create_train_state(*a, **kw):
            # the optimizer's update is nought: every step returns its state unchanged
            model, state = create(*a, **kw)
            dev = next(model.parameters()).device
            state.optimizer.step = lambda count, norm=None: torch.zeros((), device=dev)
            return model, state

        return mock.patch.object(training, "create_train_state", create_train_state)
    make = training.make_sharded_train_step

    def make_sharded_train_step(*a, **kw):
        step = make(*a, **kw)

        def faulty(state, *args):
            if fault == "half_batch":       # half of the batch left out, the mean over the rest
                args = [x[: x.shape[0] // 2] for x in args]
            state, metrics = step(state, *args)
            if fault == "answer":           # the loss altered by 1 % where it is returned
                metrics = {**metrics, "loss": metrics["loss"] * 1.01}
            return state, metrics

        return faulty

    return mock.patch.object(training, "make_sharded_train_step", make_sharded_train_step)


@contextmanager
def planted(driver: str, fault: str | None):
    """Plant ``fault`` (one of ``FAULTS[driver]``) for the duration; ``None``
    plants nothing."""
    if fault is None:
        yield
        return
    if fault not in FAULTS[driver]:
        raise ValueError(f"fault {fault!r}: one of {FAULTS[driver]}")
    patch = _synth_patch(fault) if driver == "synth_batch" else _train_patch(fault)
    with patch:
        yield
