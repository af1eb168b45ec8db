"""Multi-process runtime: one process (rank) per mesh position.

Port of ``tacotron_multispeaker_tpu/parallel/distributed.py``.  The JAX
package runs one controller over a mesh of devices and lets XLA place the
collectives; the port runs SPMD over ``torch.distributed``: every rank runs
the same program on its own shard and calls the collectives below itself.

:func:`initialize_distributed` joins the process group (torchrun's
variables, or an explicit ``init_method``) and picks the rank's device and
the collective backend: NCCL when every rank of the host has a card of its
own, gloo when ranks share a card (one H100 serving four ranks) or run on
the CPU.  gloo takes CUDA tensors for the all-reduces and all-gathers used
here (checked on an H100), so the helpers never stage through the host.
The sharded train steps use :func:`psum` (differentiable: its backward is
again a SUM over the group, as ``jax.lax.psum`` transposes), one
:func:`all_reduce_coalesced` of the gradients a group and one
:func:`all_reduce_scalars` of the losses; checkpoints gather a sharded
parameter's rows with :func:`gather_rows`.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..device import resolve_device

# the device initialize_distributed chose for this rank (None before it ran)
_device: torch.device | None = None


def initialize_distributed(init_method: str | None = None, world_size: int | None = None,
                           rank: int | None = None, local_rank: int | None = None,
                           device=None, backend: str | None = None,
                           timeout: float | None = None) -> torch.device:
    """Join the process group of a multi-process run; returns this rank's
    device.

    Without arguments the torchrun variables are read (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, with
    ``MASTER_ADDR``/``MASTER_PORT`` for the ``env://`` rendezvous); an
    explicit ``init_method`` (``file://…``, ``tcp://host:port``) needs
    ``world_size`` and ``rank``, and all ranks then count as one host's
    unless ``LOCAL_WORLD_SIZE`` says otherwise.  A single process (no ``init_method`` and a
    world size of at most 1) joins nothing.

    ``device=None`` is ``cuda:{local_rank % device_count}`` and raises
    without a card; ``device="cpu"`` runs the rank on the CPU.
    ``backend=None`` is NCCL when every rank of the host has a card of its
    own (``local_world_size <= device_count``), else gloo; an explicit
    backend that cannot serve the placement raises, as does a failed join:
    nothing falls back.  ``timeout`` (seconds) bounds every collective, so
    a rank whose peer died raises instead of hanging."""
    global _device
    env = os.environ
    world_size = world_size if world_size is not None else int(env.get("WORLD_SIZE", "1"))
    rank = rank if rank is not None else int(env.get("RANK", "0"))
    local_rank = local_rank if local_rank is not None else int(env.get("LOCAL_RANK", rank))
    local_world_size = int(env.get("LOCAL_WORLD_SIZE", world_size))
    if device is None:
        resolve_device(None)                      # raises without a card
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    else:
        dev = torch.device(device)
    if init_method is None and world_size <= 1:
        _device = dev
        return dev
    shared = dev.type != "cuda" or local_world_size > torch.cuda.device_count()
    if backend is None:
        backend = "gloo" if shared else "nccl"
    elif backend == "nccl" and shared:
        raise ValueError(f"backend 'nccl' needs a card of its own for each rank: "
                         f"{local_world_size} ranks on this host, device {dev}, "
                         f"{torch.cuda.device_count()} cards (use gloo)")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size, rank=rank,
        timeout=None if timeout is None else datetime.timedelta(seconds=timeout))
    _device = dev
    return dev


def rank_device() -> torch.device:
    """The device :func:`initialize_distributed` chose, or, before it ran,
    the CUDA device (raises without one)."""
    return _device if _device is not None else resolve_device(None)


def is_primary_host() -> bool:
    """Rank 0 of the process group (a single process is its own primary)."""
    return not dist.is_initialized() or dist.get_rank() == 0


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """``op`` ("sum" or "max") of ``t`` over ``group``, out of place; a
    ``None`` group (an axis of size 1) returns ``t``."""
    if group is None:
        return t
    out = t.clone()
    dist.all_reduce(out, op=_OPS[op], group=group)
    return out


class _SumAllReduce(torch.autograd.Function):
    """SUM over a group whose backward is again a SUM of the cotangent over
    the group: the transpose ``jax.lax.psum`` has under
    ``shard_map(check_vma=False)``."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=ctx.group)
        return out, None


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """Differentiable SUM of ``t`` over ``group`` (its gradient is the SUM
    of the cotangents over the group); a ``None`` group returns ``t``."""
    if group is None:
        return t
    return _SumAllReduce.apply(t, group)


@torch.no_grad()
def all_reduce_coalesced(tensors, group) -> None:
    """SUM each tensor over ``group`` in place, through one flat buffer a
    dtype (one all-reduce for a list of one dtype, such as a step's f32
    gradients); a ``None`` group leaves them as they are."""
    if group is None:
        return
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


@torch.no_grad()
def all_reduce_scalars(values: dict, group) -> dict:
    """{name: 0-dim tensor} summed over ``group`` in one all-reduce of the
    stacked values; a ``None`` group returns them as they are."""
    if group is None:
        return values
    stacked = torch.stack([v.detach().float() for v in values.values()])
    return dict(zip(values, all_reduce(stacked, "sum", group).unbind()))


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's tensors (all of one shape), concatenated along ``dim`` in
    rank order; a ``None`` group returns ``t``."""
    if group is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The group's tensors concatenated along dim 0 in rank order, where the
    ranks may hold different numbers of rows (an uneven last shard); a
    ``None`` group returns ``t``.  Every rank of the group must call it."""
    if group is None:
        return t
    n = torch.tensor([t.shape[0]], device=t.device)
    counts = all_gather(n, 0, group).tolist()
    most = max(counts)
    padded = t.new_zeros((most, *t.shape[1:]))
    padded[:t.shape[0]] = t
    parts = all_gather(padded, 0, group).split(most)
    return torch.cat([p[:c] for p, c in zip(parts, counts)])


def barrier() -> None:
    """Wait for every rank of the process group (a single process returns)."""
    if dist.is_initialized():
        dist.barrier()


def destroy() -> None:
    """Leave the process group (if joined)."""
    global _device
    if dist.is_initialized():
        dist.destroy_process_group()
    _device = None
