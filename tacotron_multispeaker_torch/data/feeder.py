"""Bucketed-length batch feeder.

Port of ``tacotron_multispeaker_tpu/data/feeder.py``: groups of
``batch_size * batches_per_group`` examples sorted by output length, sliced
into batches and shuffled (the reference's ``datasets/datafeeder.py``
policy).  Batches pad to a small fixed set of shapes: inputs to an input
bucket, targets to one of ``bucket_boundaries`` (each a multiple of the
reduction factor r).  Optional random cmudict pronunciation substitution is
applied at text-encode time.  :class:`PrefetchIterator` keeps host batches
ready on a background thread.

Targets are read and padded by the native batch assembler
(``data/native_batcher.py``) where it builds, else by numpy (its
reference).  ``train.targets_dtype=bfloat16`` rounds them on the host
(half the bytes to copy); ``train.targets_from_wav`` ships int16 PCM
instead, from which the train step derives them.  A Feeder given
``empty`` assembles the targets straight into the tensors it returns:
page-locked memory (:func:`pinned_empty`) for an asynchronous copy to the
card, or a worker process's slot of shared memory
(data/grain_pipeline.py).
"""

from __future__ import annotations

import os
import queue
import random
import re
import threading
import time
from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np
import torch

from ..text import CMUDict, text_to_sequence
from ..utils import infolog
from . import native_batcher

_WORD_RE = re.compile(r"([a-zA-Z']+)")
_NUMPY = {torch.float32: np.float32, torch.int16: np.int16}


@dataclass
class Batch:
    """One padded training batch on the host.

    The id and length fields are numpy arrays.  The targets are numpy
    arrays, or CPU tensors where the Feeder was given ``empty`` or they are
    bfloat16 (which numpy lacks).  With ``train.targets_from_wav``,
    ``mel_targets`` carries the [B, T*hop] int16 PCM instead and
    ``linear_targets`` is an empty [B, 0, 0] placeholder: the train step
    derives both spectrograms (training.py derive_wav_targets), and the
    step's signature stays the same."""

    inputs: np.ndarray          # [B, L] int32 symbol ids
    input_lengths: np.ndarray   # [B] int32
    mel_targets: np.ndarray     # [B, T, num_mels] float32 or bfloat16 (or int16 PCM)
    linear_targets: np.ndarray  # [B, T, num_freq] float32 or bfloat16
    target_lengths: np.ndarray  # [B] int32 (true frame counts, <= T)
    speaker_ids: np.ndarray     # [B] int32

    @property
    def batch_size(self) -> int:
        return self.inputs.shape[0]


def pinned_empty(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    """A host tensor in page-locked memory (PyTorch's caching host
    allocator): its copy to the card runs asynchronously."""
    return torch.empty(shape, dtype=dtype, pin_memory=True)


def pad_axis(x: np.ndarray, length: int, axis: int = 0) -> np.ndarray:
    """Pad with zeros (or truncate) along ``axis`` to exactly ``length``."""
    cur = x.shape[axis]
    if cur == length:
        return x
    if cur > length:
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(0, length)
        return x[tuple(sl)]
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, length - cur)
    return np.pad(x, widths)


def pick_bucket(n_frames: int, boundaries: Sequence[int]) -> int:
    """Smallest boundary >= n_frames (last boundary if none)."""
    for b in boundaries:
        if n_frames <= b:
            return b
    return boundaries[-1]


def _process_group() -> tuple[int, int]:
    """(rank, world size) of the initialised ``torch.distributed`` group, else (0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Feeder:
    """Deterministic bucketed feeder over a preprocessed corpus dir.

    ``cfg.train.batch_size`` is the global batch size.  Every process
    computes the same metadata-only batch plan (seeded shuffle → group sort
    → batch slice → batch shuffle, over the whole ``train.txt``), so the
    bucket chosen for each step agrees across processes; each process then
    loads only its contiguous ``batch_size // process_count`` slice of every
    global batch.  ``process_index`` / ``process_count`` default to the
    rank and world size of ``torch.distributed`` when it is initialised,
    else 0 and 1.  ``shuffle`` shuffles the metadata order and each
    group's batch order from ``seed`` (default ``cfg.train.seed``); without
    it the plan keeps the metadata order within the group sort.
    ``drop_remainder`` drops a group's short last batch; validation keeps it.

    ``use_native``: the C++ assembler for the f32 targets; None means
    "where it builds" (the choice is logged).  ``empty(shape, dtype)``
    allocates the targets' tensors; None gives numpy arrays.
    """

    def __init__(self, data_dir: str, cfg, *, shuffle: bool = True,
                 seed: int | None = None, cmudict_path: str | None = None,
                 drop_remainder: bool = True, use_native: bool | None = None, empty=None,
                 process_index: int | None = None, process_count: int | None = None):
        from .preprocess import load_metadata
        if cfg.train.targets_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"train.targets_dtype={cfg.train.targets_dtype!r}: "
                             "float32 or bfloat16")
        self.data_dir = data_dir
        self.cfg = cfg
        self.audio = cfg.audio
        self.shuffle = shuffle
        self.seed = cfg.train.seed if seed is None else seed
        self.drop_remainder = drop_remainder
        self.meta = load_metadata(os.path.join(data_dir, "train.txt"))
        if not self.meta:
            raise ValueError(f"no metadata rows in {data_dir}/train.txt")
        if process_index is None or process_count is None:
            process_index, process_count = _process_group()
        self.process_index = process_index
        self.process_count = process_count
        if cfg.train.batch_size % process_count != 0:
            raise ValueError(f"global batch_size={cfg.train.batch_size} must divide by "
                             f"process_count={process_count}")
        r = cfg.model.outputs_per_step
        self.boundaries = tuple(-(-b // r) * r for b in cfg.train.bucket_boundaries)
        self.cmudict = None
        if cmudict_path and cfg.train.cmudict_prob > 0:
            self.cmudict = CMUDict(cmudict_path, keep_ambiguous=False)
        self._epoch = 0
        self._enc_len_cache: dict[str, int] = {}
        if use_native is None:
            use_native = native_batcher.available()
            infolog.log("feeder: native batch assembler " + (
                "on" if use_native else f"off, numpy path ({native_batcher.build_error()})"))
        self.use_native = use_native
        self.empty = empty

    @property
    def local_batch_size(self) -> int:
        return self.cfg.train.batch_size // self.process_count

    def __len__(self) -> int:
        return len(self.meta)

    # -- text encoding -------------------------------------------------------

    def _maybe_arpabet(self, word: str, rng: random.Random) -> str:
        if self.cmudict and rng.random() < self.cfg.train.cmudict_prob:
            pron = self.cmudict.lookup(word)
            if pron:
                return "{%s}" % pron[0]
        return word

    def encode_text(self, text: str, rng: random.Random | None = None) -> np.ndarray:
        if self.cmudict is not None and rng is not None:
            text = "".join(self._maybe_arpabet(p, rng) if _WORD_RE.fullmatch(p) else p
                           for p in _WORD_RE.split(text))
        return np.asarray(text_to_sequence(text, self.cfg.cleaners), dtype=np.int32)

    # -- example / batch assembly -------------------------------------------

    def _encoded_length(self, row: dict) -> int:
        """Encoded text length without cmudict substitution (cached by text):
        the input bucket comes from metadata alone, so every process agrees
        on it; a substitution that lengthens a sequence past it is cut."""
        text = row["text"]
        if text not in self._enc_len_cache:
            self._enc_len_cache[text] = len(text_to_sequence(text, self.cfg.cleaners))
        return self._enc_len_cache[text]

    def _input_bucket(self, rows: list) -> int:
        bounds = [b for b in self.cfg.train.input_bucket_boundaries
                  if b <= self.cfg.train.max_input_length]
        if not bounds:
            return self.cfg.train.max_input_length
        return pick_bucket(max(self._encoded_length(r) for r in rows), bounds)

    def _make_batch(self, rows: list, rngs, *, L: int | None = None,
                    T: int | None = None) -> Batch:
        """``rngs``: one Random per row, or one shared across the rows."""
        if L is None:
            L = self._input_bucket(rows)
        if T is None:
            T = pick_bucket(max(r["n_frames"] for r in rows), self.boundaries)
        if isinstance(rngs, random.Random):
            rngs = [rngs] * len(rows)
        ids = [self.encode_text(r["text"], rng) for r, rng in zip(rows, rngs)]
        inputs = np.stack([pad_axis(i, L) for i in ids]).astype(np.int32)
        input_lengths = np.asarray([min(len(i), L) for i in ids], np.int32)
        speaker_ids = np.asarray([r["speaker_id"] for r in rows], np.int32)
        if self.cfg.train.targets_from_wav:
            # PCM padded to T*hop samples: centered framing then gives T+1
            # frames, of which the step keeps T, so no true sample is cut
            pcm, held = self._buffer((len(rows), T * self.audio.hop_length), torch.int16)
            for i, r in enumerate(rows):
                self._fill_row(pcm[i], self._load_wav(r))
            target_lengths = np.asarray([min(r["n_frames"], T) for r in rows], np.int32)
            return Batch(inputs, input_lengths, held, np.zeros((len(rows), 0, 0), np.float32),
                         target_lengths, speaker_ids)
        mels, target_lengths = self._targets(rows, T, "mel_file", self.audio.num_mels)
        linears, _ = self._targets(rows, T, "linear_file", self.audio.num_freq)
        return Batch(inputs, input_lengths, mels, linears, target_lengths, speaker_ids)

    def _buffer(self, shape: tuple, dtype: torch.dtype) -> tuple[np.ndarray, object]:
        """(the array to fill, what the Batch holds): one numpy array, or
        the tensor from ``empty`` and its array."""
        if self.empty is None:
            a = np.empty(shape, _NUMPY[dtype])
            return a, a
        t = self.empty(shape, dtype)
        return t.numpy(), t

    @staticmethod
    def _fill_row(out: np.ndarray, x: np.ndarray) -> int:
        """``x`` cut or zero-padded along its first axis into ``out``."""
        n = min(len(x), len(out))
        out[:n] = x[:n]
        out[n:] = 0
        return n

    def _load_wav(self, row: dict) -> np.ndarray:
        from .preprocess import wav_file_for
        path = os.path.join(self.data_dir, wav_file_for(row))
        try:
            return np.load(path, allow_pickle=False)
        except FileNotFoundError:
            raise FileNotFoundError(
                f"{path} missing — train.targets_from_wav needs the PCM passthrough; re-run "
                "preprocess with --keep_wavs") from None

    def _targets(self, rows: list, T: int, key: str, cols: int):
        """[B, T, cols] targets of ``rows`` (file column ``key``), and the
        frames each has (<= T)."""
        bf16 = self.cfg.train.targets_dtype == "bfloat16"
        shape = (len(rows), T, cols)
        if bf16:                    # rounded below from an f32 array
            out = held = np.empty(shape, np.float32)
        else:
            out, held = self._buffer(shape, torch.float32)
        paths = [os.path.join(self.data_dir, r[key]) for r in rows]
        if self.use_native:
            lengths = native_batcher.assemble_into(paths, out)
        else:
            lengths = np.asarray([self._fill_row(o, np.load(p, allow_pickle=False))
                                  for o, p in zip(out, paths)], np.int32)
        if bf16:
            # round to nearest even, as ml_dtypes does
            src = torch.from_numpy(out)
            held = (src.to(torch.bfloat16) if self.empty is None
                    else self.empty(shape, torch.bfloat16).copy_(src))
        return held, lengths

    def epoch_plan(self, epoch: int) -> list[tuple]:
        """The metadata-only batch plan for one epoch: take ``batch_size *
        batches_per_group`` examples, sort by output length, slice into
        batches, shuffle the batch order within the group.  The same on every
        process; entries ``(epoch, batch_index, global_row_indices, L, T)``."""
        rng = random.Random(f"{self.seed}-{epoch}")
        order = list(range(len(self.meta)))
        if self.shuffle:
            rng.shuffle(order)
        bs = self.cfg.train.batch_size
        group = bs * self.cfg.train.batches_per_group
        n_batch = 0
        plan = []
        for g0 in range(0, len(order), group):
            idxs = order[g0: g0 + group]
            idxs.sort(key=lambda i: self.meta[i]["n_frames"])
            batches = [idxs[i: i + bs] for i in range(0, len(idxs), bs)]
            if self.drop_remainder and batches and len(batches[-1]) < bs:
                batches.pop()
            if self.shuffle:
                rng.shuffle(batches)
            for bidx in batches:
                rows = [self.meta[i] for i in bidx]
                # bucket shapes from the whole global batch
                L = self._input_bucket(rows)
                T = pick_bucket(max(r["n_frames"] for r in rows), self.boundaries)
                plan.append((epoch, n_batch, bidx, L, T))
                n_batch += 1
        return plan

    def materialize(self, entry: tuple) -> Batch:
        """Load this process's slice of one planned global batch."""
        epoch, n_batch, bidx, L, T = entry
        rows = [self.meta[i] for i in bidx]
        # one text rng per row, keyed on its global position: the cmudict
        # substitutions do not depend on how many processes slice the batch
        row_rngs = [random.Random(f"{self.seed}-{epoch}-{n_batch}-{j}")
                    for j in range(len(rows))]
        if self.process_count > 1:
            lo = self.process_index * self.local_batch_size
            rows = rows[lo: lo + self.local_batch_size]
            row_rngs = row_rngs[lo: lo + self.local_batch_size]
        return self._make_batch(rows, row_rngs, L=L, T=T)

    def epoch_batches(self, epoch: int | None = None) -> Iterator[Batch]:
        """One epoch of group-sort-bucketed batches (plan → materialize)."""
        if epoch is None:
            epoch = self._epoch
            self._epoch += 1
        for entry in self.epoch_plan(epoch):
            yield self.materialize(entry)

    def __iter__(self) -> Iterator[Batch]:
        """Endless stream of batches across epochs."""
        while True:
            yield from self.epoch_batches()


class PrefetchIterator:
    """Background-thread prefetch wrapper: a bounded queue filled by a
    daemon thread; an exception in the thread is raised to the consumer.
    :meth:`close` stops the thread, then closes the source where it has a
    ``close`` (a loader's worker processes)."""

    _DONE = object()

    def __init__(self, iterable, prefetch: int = 4):
        self._source = iterable
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._exc: BaseException | None = None

        def run():
            try:
                for item in iterable:
                    if self._stop.is_set():
                        return
                    self._q.put(item)
            except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
                self._exc = e
            finally:
                self._q.put(self._DONE)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item

    def _drain(self):
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def close(self, timeout: float = 60.0):
        self._stop.set()
        # the thread ends after at most one more item; its puts may block on
        # a full queue, so drain while waiting
        deadline = time.monotonic() + timeout
        while self._thread.is_alive() and time.monotonic() < deadline:
            self._drain()
            self._thread.join(0.05)
        self._drain()
        close = getattr(self._source, "close", None)
        if close is not None and not self._thread.is_alive():
            close()
