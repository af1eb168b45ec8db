"""Scalar metrics writer: one JSON line per summary in ``metrics.jsonl``.

Port of ``tacotron_multispeaker_tpu/utils/metrics.py``.  Its TensorBoard
event files are not ported: asking for them raises.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any


class MetricsWriter:
    def __init__(self, log_dir: str, use_tensorboard: bool = False, enabled: bool = True):
        if use_tensorboard:
            raise NotImplementedError("TensorBoard summaries (TACOTRON_TB=1) are not ported "
                                      "yet (ROADMAP.md, 'Data + loop'); metrics.jsonl is "
                                      "written always")
        # enabled=False (a non-primary process): a no-op writer
        self.enabled = enabled
        self._jsonl = None
        if enabled:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a", encoding="utf-8")

    def scalars(self, step: int, values: dict[str, Any]) -> None:
        if not self.enabled:
            return
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
