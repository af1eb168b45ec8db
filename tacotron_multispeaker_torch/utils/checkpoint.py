"""The port's training checkpoints: save, keep the newest few, resume.

The JAX package checkpoints with orbax; the port keeps its own format (an
orbax checkpoint does not import, ROADMAP.md).  A checkpoint is one
``torch.save`` file ``<directory>/ckpt-<step>.pt`` holding {``step``,
``seed``, ``model``: the model's ``state_dict`` (parameters and BatchNorm
running statistics), ``optimizer``: the Adam state}.  The newest
``max_to_keep`` stay.  :func:`load_model_state` reads the model part of a
checkpoint file or of a directory's latest one, for ``Synthesizer.load``.

A sharded run (``TrainState.mesh``) writes the same single-process layout:
every rank gathers the rows of the parameters that shard
(``TrainState.shards``, the speaker table) and their Adam moments over the
mesh's ``model`` axis (:func:`full_state`, collective), and rank 0 alone
writes the file.  Every rank restores from it and keeps its own rows, so a
checkpoint moves between a sharded run, a single process and
``Synthesizer.load`` unchanged.
"""

from __future__ import annotations

import os
import re

import torch

from ..parallel.distributed import gather_rows, is_primary_host

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

    def save(self, step: int, state, full: tuple[dict, dict] | None = None) -> str | None:
        """Write ``state`` (training.TrainState) as the checkpoint of
        ``step`` (atomically: a temporary file renamed into place) and drop
        all but the newest ``max_to_keep``.  ``full``: ``full_state(state)``
        where the caller has it already; None gathers it (collective: every
        rank of a mesh calls ``save``).  Rank 0 writes and returns the path;
        the other ranks return None."""
        model, optimizer = full if full is not None else full_state(state)
        if not is_primary_host():
            return None
        path = self.path(step)
        tmp = f"{path}.tmp{os.getpid()}"
        torch.save({"step": int(step), "seed": int(state.seed), "model": model,
                    "optimizer": optimizer}, tmp)
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
        model, optimizer = ckpt["model"], ckpt["optimizer"]
        for name, rows in state.shards.items():
            model[name] = model[name][rows]
            moments = optimizer["state"].get(_param_index(state, name))
            for k in _MOMENTS if moments is not None else ():
                moments[k] = moments[k][rows]
        state.model.load_state_dict(model, strict=True)
        state.optimizer.load_state_dict(optimizer)
        state.step, state.seed = int(ckpt["step"]), int(ckpt["seed"])
        return state


_MOMENTS = ("exp_avg", "exp_avg_sq")


def _param_index(state, name: str) -> int:
    """The key of parameter ``name`` in the optimizer ``state_dict``."""
    return [n for n, p in state.model.named_parameters() if p.requires_grad].index(name)


def full_state(state) -> tuple[dict, dict]:
    """(model ``state_dict``, optimizer ``state_dict``) of ``state`` in the
    single-process layout.  For a rank of a mesh the rows of each sharded
    parameter and of its Adam moments (there are none before the first
    update) are gathered over the mesh's ``model`` axis: every rank must
    call it."""
    model = state.model.state_dict()
    optimizer = state.optimizer.state_dict()
    if state.shards:
        group = state.mesh.model_group
        model = dict(model)
        optimizer = {**optimizer, "state": dict(optimizer["state"])}
        for name in state.shards:
            model[name] = gather_rows(model[name], group)
            key = _param_index(state, name)
            if key in optimizer["state"]:
                optimizer["state"][key] = {
                    k: gather_rows(v, group) if k in _MOMENTS else v
                    for k, v in optimizer["state"][key].items()}
    return model, optimizer


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
