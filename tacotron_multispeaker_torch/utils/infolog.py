"""Timestamped file + stdout logging for a training run.

Port of ``tacotron_multispeaker_tpu/utils/infolog.py`` (the reference's
``util/infolog.py``): ``init`` opens a run log, ``log`` writes stamped lines
to stdout and the file.  The JAX package's optional HTTP webhook is not
ported.  Only the primary process logs when ``enabled`` is false elsewhere.
"""

from __future__ import annotations

import atexit
from datetime import datetime
from typing import IO

_fmt = "%Y-%m-%d %H:%M:%S.%f"
_file: IO[str] | None = None
_enabled = True


def init(filename: str, run_name: str, enabled: bool = True) -> None:
    global _file, _enabled
    close()
    _enabled = enabled
    if not enabled:
        return
    _file = open(filename, "a", encoding="utf-8")
    _file.write("\n-----------------------------------------------------\n")
    _file.write(f"Starting new training run of {run_name}\n")
    _file.write("-----------------------------------------------------\n")


def log(msg: str) -> None:
    if not _enabled:
        return
    stamped = f"[{datetime.now().strftime(_fmt)[:-3]}]  {msg}"
    print(stamped, flush=True)
    if _file is not None:
        _file.write(stamped + "\n")
        _file.flush()


def close() -> None:
    global _file
    if _file is not None:
        _file.close()
        _file = None


atexit.register(close)
