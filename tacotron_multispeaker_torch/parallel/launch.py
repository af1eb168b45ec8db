"""Run a function on N ranks of one host: ``torch.multiprocessing`` spawns
the processes, which join one process group over a ``file://`` store in a
temporary directory.  Used by the tests (gloo ranks on the CPU) and by
``chip_smoke.py`` (ranks sharing one card)."""

from __future__ import annotations

import json
import os
import tempfile
import time
import traceback

import torch
import torch.multiprocessing as mp

from . import distributed


def _rank_main(rank, fn, world_size, store_dir, device, timeout):
    if device is not None and torch.device(device).type == "cpu":
        # CPU ranks share the host's cores: each takes its share of the
        # intra-op threads instead of one thread a core each
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    try:
        args = torch.load(os.path.join(store_dir, "args.pt"), weights_only=False)
        distributed.initialize_distributed(
            init_method=f"file://{os.path.join(store_dir, 'store')}", world_size=world_size,
            rank=rank, local_rank=rank, device=device, timeout=timeout)
        out = fn(rank, *args)
        torch.save(out, os.path.join(store_dir, f"rank{rank}.pt"))
    except BaseException:
        # noted before this rank leaves the group, so it precedes the errors
        # that its leaving causes in the other ranks
        with open(os.path.join(store_dir, f"rank{rank}.err"), "w") as f:
            json.dump({"at": time.monotonic(), "trace": traceback.format_exc()}, f)
        raise
    finally:
        distributed.destroy()


def _first_failure(store_dir, world_size):
    """(rank, traceback) of the rank that failed first, or None."""
    failed = []
    for r in range(world_size):
        try:
            with open(os.path.join(store_dir, f"rank{r}.err")) as f:
                failed.append((json.load(f)["at"], r))
        except (OSError, ValueError):
            continue
    if not failed:
        return None
    r = min(failed)[1]
    with open(os.path.join(store_dir, f"rank{r}.err")) as f:
        return r, json.load(f)["trace"]


def run_ranks(fn, world_size: int, *args, device=None, timeout: float = 600.0) -> list:
    """``fn(rank, *args)`` on ``world_size`` spawned ranks (``fn`` and
    ``args`` picklable; ``device`` as :func:`distributed.initialize_distributed`
    takes it); returns each rank's return value (saved with ``torch.save``),
    in rank order.  A rank that raises fails the call with the traceback of
    the rank that failed first; a run past ``timeout`` seconds kills every
    rank and raises ``TimeoutError``.  No process outlives the call."""
    with tempfile.TemporaryDirectory() as store_dir:
        # the arguments go through a file: a spawned child reads its pipe only
        # after its imports, so large pickled arguments would start the ranks
        # one after another
        torch.save(args, os.path.join(store_dir, "args.pt"))
        ctx = mp.start_processes(
            _rank_main, args=(fn, world_size, store_dir, device, timeout),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=0.5):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks still running after {timeout} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            # join reports whichever failed rank it saw first; the cause is
            # the rank that failed first in time
            first = _first_failure(store_dir, world_size)
            if first is None:
                raise
            raise RuntimeError(f"rank {first[0]} failed first:\n{first[1]}") from e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(store_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]
