"""The (data, model) mesh of ranks, and which parameters a rank keeps in part.

Port of ``tacotron_multispeaker_tpu/parallel/mesh.py`` (``make_mesh`` and
the table rule of ``param_specs``).  Rank r sits at mesh position
``(r // model, r % model)``, as ``np.asarray(devices).reshape(data, model)``
places the JAX package's devices.  The mesh holds the rank's groups: its
``data`` column (the ranks of its model index, over which the batch
shards) and its ``model`` row (the ranks of its data index, over which the
speaker table and, in the sequence-sharded decode, the encoder length
shard).  An axis of size 1 has no group, and its collectives are no-ops.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch import nn

from . import distributed


@dataclass(frozen=True, eq=False)
class Mesh:
    data: int
    model: int
    rank: int
    device: torch.device
    data_group: object = None     # this rank's column (same model index)
    model_group: object = None    # this rank's row (same data index)
    world_group: object = None    # every rank (None for a mesh of one)

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model


def make_mesh(cfg_parallel=None, data: int | None = None, model: int | None = None,
              device=None) -> Mesh:
    """The (data, model) mesh over every rank of the process group (one
    rank, unjoined, is a mesh of one).  ``model`` defaults to
    ``cfg_parallel.model_parallel_size`` (else 1) and ``data`` to the rest.
    Every rank must call it, with the same arguments, in the same order: it
    creates every row and column group on every rank.  Raises when the world
    size is not ``data·model``.  ``device`` defaults to the rank's device
    (:func:`distributed.rank_device`)."""
    joined = dist.is_initialized()
    world = dist.get_world_size() if joined else 1
    rank = dist.get_rank() if joined else 0
    if model is None:
        model = cfg_parallel.model_parallel_size if cfg_parallel else 1
    model = min(model, world)
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"{world} ranks cannot form mesh ({data}, {model})")
    data_group = model_group = None
    for j in range(model):                 # columns: the data axis
        g = dist.new_group([i * model + j for i in range(data)]) if joined and data > 1 else None
        if rank % model == j:
            data_group = g
    for i in range(data):                  # rows: the model axis
        g = dist.new_group([i * model + j for j in range(model)]) if joined and model > 1 else None
        if rank // model == i:
            model_group = g
    return Mesh(data, model, rank,
                torch.device(device) if device is not None else distributed.rank_device(),
                data_group, model_group, dist.group.WORLD if joined and world > 1 else None)


def param_shards(cfg, mesh: Mesh) -> dict[str, slice]:
    """The parameters this rank keeps only in part: port parameter name →
    the rows (dim 0) it keeps.  As ``param_specs``: everything is
    replicated except the speaker table, whose rows shard over ``model``
    (``P("model", None)``) when the mesh's model axis is non-trivial and the
    table is big enough (``parallel.model_parallel_size > 1`` and
    ``num_speakers >= parallel.shard_speaker_table_min``).  Shard j keeps
    rows ``[j·c, (j+1)·c)`` with c = ceil(S / M), the last shard fewer."""
    m, p = cfg.model, cfg.parallel
    if not (mesh.model > 1 and m.num_speakers > 1 and p.model_parallel_size > 1
            and m.num_speakers >= p.shard_speaker_table_min):
        return {}
    per = -(-m.num_speakers // mesh.model)
    lo = min(m.num_speakers, mesh.model_index * per)
    return {"speaker_table.weight": slice(lo, min(m.num_speakers, lo + per))}


@torch.no_grad()
def keep_shards(model: nn.Module, shards: dict[str, slice]) -> nn.Module:
    """Cut each parameter named in ``shards`` to the rows this rank keeps,
    in place."""
    for name, rows in shards.items():
        owner, _, attr = name.rpartition(".")
        mod = model.get_submodule(owner)
        setattr(mod, attr, nn.Parameter(getattr(mod, attr)[rows].clone()))
        if isinstance(mod, nn.Embedding):
            mod.num_embeddings = rows.stop - rows.start
    return model
