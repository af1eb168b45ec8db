"""The port's training checkpoints: save, keep the newest few, resume.

The JAX package checkpoints with orbax; the port keeps its own format (an
orbax checkpoint does not import, ROADMAP.md).  A checkpoint is one
``torch.save`` file ``<directory>/ckpt-<step>.pt`` holding {``step``,
``seed``, ``model``: the model's ``state_dict`` (parameters and BatchNorm
running statistics), ``optimizer``: the Adam state}.  The newest
``max_to_keep`` stay.  :func:`load_model_state` reads the model part of a
checkpoint file or of a directory's latest one, for ``Synthesizer.load``.
"""

from __future__ import annotations

import os
import re

import torch

_NAME = re.compile(r"^ckpt-(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt-{int(step):08d}.pt")

    def steps(self) -> list[int]:
        """The steps checkpointed here, oldest first."""
        found = (_NAME.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state) -> str:
        """Write ``state`` (training.TrainState) as the checkpoint of
        ``step`` (atomically: a temporary file renamed into place) and drop
        all but the newest ``max_to_keep``."""
        path = self.path(step)
        tmp = f"{path}.tmp{os.getpid()}"
        torch.save({"step": int(step), "seed": int(state.seed),
                    "model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict()}, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))
        return path

    def restore(self, state, step: int | None = None):
        """Load the checkpoint of ``step`` (default: the latest) into
        ``state``'s model and optimizer, and its step and seed; returns
        ``state``."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint to restore in {self.directory}")
        dev = next(state.model.parameters()).device
        ckpt = torch.load(self.path(step), map_location=dev, weights_only=True)
        state.model.load_state_dict(ckpt["model"], strict=True)
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step, state.seed = int(ckpt["step"]), int(ckpt["seed"])
        return state


def load_model_state(path: str, device) -> dict:
    """The model ``state_dict`` of a checkpoint file, of the latest
    checkpoint in a directory, or of a bare ``state_dict`` file."""
    if os.path.isdir(path):
        mgr = CheckpointManager(path)
        step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {path}")
        path = mgr.path(step)
    obj = torch.load(path, map_location=device, weights_only=True)
    return obj["model"] if "model" in obj and "optimizer" in obj else obj
