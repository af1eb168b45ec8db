"""The trainer's multiprocess input pipeline (``--pipeline grain``).

Port of ``tacotron_multispeaker_tpu/data/grain_pipeline.py
grain_global_batches`` on ``torch.utils.data`` worker processes: the port
imports no ``grain``.  The Feeder's metadata-only global batch plan
(``Feeder.epoch_plan``: seeded shuffle, group sort, batch slice, bucket
choice; the same in every process) is the record stream, and each record
is materialised as this process's contiguous slice of one planned batch.
Batches come out in plan order at every worker count.

Worker processes start by ``spawn`` (never ``fork``: the parent holds CUDA
and threads), persist across epochs, and never touch CUDA.  A worker
assembles a batch's targets into a slot of a :class:`_Ring` of shared
memory that this process made before the workers started, and sends back
only where they lie in the slot: this process reads them through its own
mapping, so no data is pickled, no file descriptor is passed, and no page
of new shared memory is faulted in on either side (where page faults are
dear, a new shared buffer a batch cost more than the assembly).  This
process copies the targets out (into page-locked memory with
``pin_memory``) and frees the slot.

The JAX module's other stream, ``grain_batches`` (each process bucketing
its own index stream), is not ported: its order comes from grain's own
index shuffle, and the trainer does not use it (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Iterator

import torch

from .feeder import Batch, Feeder, pinned_empty

# the bound of an "endless" stream: plans repeat deterministically per
# epoch, and no real run reaches it (a long run on a tiny corpus can; it
# then raises)
ENDLESS_EPOCHS = 100_000
SLOTS_PER_WORKER = 2    # the loader keeps up to 2 tasks a worker in flight
_ALIGN = 64
_TARGETS = ("mel_targets", "linear_targets")


class _Ring:
    """``workers * SLOTS_PER_WORKER`` shared-memory slots of ``nbytes``
    each (the largest batch's targets) and a shared flag a slot: 1 from
    when a worker starts a batch in it until this process has copied the
    batch out.  Each process writes the slots it will touch once up front
    (:meth:`touch`), so their pages are in its mapping before the first
    batch rather than faulted in along the first batches."""

    def __init__(self, workers: int, nbytes: int):
        self.nbytes = nbytes
        self.slots = [torch.UntypedStorage._new_shared(nbytes)
                      for _ in range(workers * SLOTS_PER_WORKER)]
        self.busy = torch.zeros(len(self.slots), dtype=torch.int32).share_memory_()
        self.touch(range(len(self.slots)))

    def touch(self, slots) -> None:
        for i in slots:
            self.slots[i].fill_(0)


class _SlotAllocator:
    """The Feeder's ``empty`` inside a worker: consecutive regions of one
    ring slot, from its start again at each batch."""

    def __init__(self, ring: _Ring):
        self.ring = ring
        self.slot = 0
        self.offset = 0

    def start(self, slot: int) -> None:
        self.slot, self.offset = slot, 0

    def __call__(self, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        start = -(-self.offset // _ALIGN) * _ALIGN
        self.offset = start + math.prod(shape) * dtype.itemsize
        if self.offset > self.ring.nbytes:
            raise ValueError(f"a batch's targets exceed a ring slot ({self.ring.nbytes} bytes)")
        return torch.empty(0, dtype=dtype).set_(self.ring.slots[self.slot],
                                                start // dtype.itemsize, shape)


class _PlanBatches(torch.utils.data.Dataset):
    """Flat index ``epoch * plan_len + i`` → this process's slice of entry
    ``i`` of that epoch's plan (the JAX ``_PlanLookup`` and
    ``_MaterializeBatch``).  Each worker derives the epoch's plan itself
    and caches the current one.  With a ring (worker processes), the item
    is ``(slot, batch)``: the batch's target tensors lie in that slot, and
    the batch carries each as (byte offset, shape, dtype)."""

    def __init__(self, feeder: Feeder, plan_len: int, n_epochs: int, ring: _Ring | None):
        self.feeder = feeder
        self.plan_len = plan_len
        self.n_epochs = n_epochs
        self.ring = ring
        self._epoch = -1
        self._plan = None
        self._alloc = None
        self._count = 0

    def __len__(self) -> int:
        return self.plan_len * self.n_epochs

    def __getitem__(self, idx: int):
        epoch, i = divmod(idx, self.plan_len)
        if epoch != self._epoch:
            self._plan = self.feeder.epoch_plan(epoch)
            self._epoch = epoch
        if self.ring is None:
            return self.feeder.materialize(self._plan[i])
        first = torch.utils.data.get_worker_info().id * SLOTS_PER_WORKER
        if self._alloc is None:            # first item in this worker
            self._alloc = self.feeder.empty = _SlotAllocator(self.ring)
            self.ring.touch(range(first, first + SLOTS_PER_WORKER))
        slot = first + self._count % SLOTS_PER_WORKER
        self._count += 1
        while self.ring.busy[slot]:        # its last batch is not copied out yet
            time.sleep(0.001)
        self.ring.busy[slot] = 1
        self._alloc.start(slot)
        batch = self.feeder.materialize(self._plan[i])
        # each target tensor as (byte offset in the slot, shape, dtype)
        return slot, dataclasses.replace(batch, **{
            f: (t.storage_offset() * t.element_size(), tuple(t.shape), t.dtype)
            for f in _TARGETS if isinstance(t := getattr(batch, f), torch.Tensor)})


class GlobalBatches:
    """The batch stream of :func:`grain_global_batches`; :meth:`close`
    stops its worker processes."""

    def __init__(self, dataset: _PlanBatches, bounded: bool, worker_count: int,
                 pin_memory: bool, timeout: float):
        self._dataset = dataset
        self._bounded = bounded
        self._empty = pinned_empty if pin_memory else (
            lambda shape, dtype: torch.empty(shape, dtype=dtype))
        self._workers = None
        if worker_count > 0:
            loader = torch.utils.data.DataLoader(
                dataset, batch_size=None, shuffle=False, num_workers=worker_count,
                multiprocessing_context="spawn", persistent_workers=True,
                prefetch_factor=SLOTS_PER_WORKER, timeout=timeout)
            self._workers = iter(loader)
            batches = map(self._copy_out, self._workers)
        else:
            batches = (dataset[i] for i in range(len(dataset)))
        self._it = self._run(batches)

    def _copy_out(self, item) -> Batch:
        """A worker's batch with its targets copied out of the ring, which
        frees the slot."""
        slot, batch = item
        storage = self._dataset.ring.slots[slot]

        def copy(start, shape, dtype):
            view = torch.empty(0, dtype=dtype).set_(storage, start // dtype.itemsize, shape)
            return self._empty(shape, dtype).copy_(view)

        out = dataclasses.replace(batch, **{f: copy(*getattr(batch, f)) for f in _TARGETS
                                            if isinstance(getattr(batch, f), tuple)})
        self._dataset.ring.busy[slot] = 0
        return out

    def _run(self, batches) -> Iterator[Batch]:
        n = 0
        for batch in batches:
            yield batch
            n += 1
        if not self._bounded:
            ds = self._dataset
            raise RuntimeError(
                f"grain epoch bound exhausted after {n} batches ({ds.plan_len} batches/epoch "
                f"x {ds.n_epochs} epochs): the corpus is small enough that this run outlived "
                "the endless-stream bound; pass num_epochs explicitly or derive it from "
                "max_steps")

    def __iter__(self):
        return self

    def __next__(self) -> Batch:
        return next(self._it)

    def close(self) -> None:
        if self._workers is not None:
            # free every slot first: a worker waiting for one would otherwise
            # sit out the loader's join timeout before it is terminated
            self._dataset.ring.busy.zero_()
            self._workers._shutdown_workers()
            self._workers = None


def _slot_bytes(feeder: Feeder) -> int:
    """The most bytes a batch's targets take (the last output bucket), with
    room for the alignment of each of its two tensors."""
    cfg, audio = feeder.cfg, feeder.audio
    B, T = feeder.local_batch_size, feeder.boundaries[-1]
    if cfg.train.targets_from_wav:
        nbytes = B * T * audio.hop_length * 2
    else:
        nbytes = B * T * (audio.num_mels + audio.num_freq) * (
            2 if cfg.train.targets_dtype == "bfloat16" else 4)
    return nbytes + 2 * _ALIGN


def grain_global_batches(data_dir: str, cfg, *, num_epochs: int | None = None,
                         worker_count: int = 0, cmudict_path: str | None = None,
                         process_index: int | None = None, process_count: int | None = None,
                         pin_memory: bool = False, timeout: float = 0) -> Iterator[Batch]:
    """The stream of this process's slices of the Feeder's global batches,
    over ``num_epochs`` epochs (None: endless, up to ``ENDLESS_EPOCHS``,
    then a ``RuntimeError``).

    Every process iterates the same plan, so the shapes of a step agree
    across processes, and loads only its ``batch_size // process_count``
    rows of each batch.  ``worker_count > 0`` materialises batches in that
    many worker processes (one loader spans every epoch: a loader an epoch
    would respawn the pool and re-pickle the Feeder at each boundary);
    ``timeout`` is the loader's limit in seconds on one batch (0: none).
    ``pin_memory``: the targets arrive in page-locked memory (needs CUDA)."""
    feeder = Feeder(data_dir, cfg, cmudict_path=cmudict_path,
                    empty=pinned_empty if pin_memory and worker_count == 0 else None,
                    process_index=process_index, process_count=process_count)
    plan_len = len(feeder.epoch_plan(0))
    if plan_len == 0:
        return iter(())
    ring = _Ring(worker_count, _slot_bytes(feeder)) if worker_count > 0 else None
    dataset = _PlanBatches(feeder, plan_len,
                           ENDLESS_EPOCHS if num_epochs is None else num_epochs, ring)
    return GlobalBatches(dataset, num_epochs is not None, worker_count, pin_memory, timeout)
