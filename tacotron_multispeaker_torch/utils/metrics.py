"""Scalar and image metrics writer.

Port of ``tacotron_multispeaker_tpu/utils/metrics.py``: one JSON line per
summary in ``metrics.jsonl``, always; with ``use_tensorboard`` also
TensorBoard event files under ``<log_dir>/tb`` through
``torch.utils.tensorboard`` (scalars, and the alignment plots as images).
Where the ``tensorboard`` package does not import, no event files are
written and one log line says so, as the JAX package goes on without its
writer library.
"""

from __future__ import annotations

import json
import os
import struct
import time
from typing import Any

from . import infolog

# PNG colour type (IHDR byte 25) -> TensorBoard image channels
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


class MetricsWriter:
    def __init__(self, log_dir: str, use_tensorboard: bool = False, enabled: bool = True):
        # enabled=False (a non-primary process): a no-op writer
        self.enabled = enabled
        self._jsonl = None
        self._tb = None
        if not enabled:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a", encoding="utf-8")
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                infolog.log(f"TensorBoard event files not written ({e}); metrics.jsonl is")
            else:
                self._tb = SummaryWriter(os.path.join(log_dir, "tb"))

    def scalars(self, step: int, values: dict[str, Any]) -> None:
        if not self.enabled:
            return
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(k, float(v), int(step))
            self._tb.flush()

    def image(self, step: int, tag: str, image_path: str) -> None:
        """Log an already-rendered PNG (the alignment plots) to TensorBoard,
        its bytes as they are (no decoding)."""
        if self._tb is None or not os.path.exists(image_path):
            return
        from tensorboard.compat.proto.summary_pb2 import Summary
        with open(image_path, "rb") as f:
            data = f.read()
        width, height = struct.unpack(">II", data[16:24])     # the IHDR chunk
        img = Summary.Image(height=height, width=width, colorspace=_PNG_CHANNELS[data[25]],
                            encoded_image_string=data)
        self._tb._get_file_writer().add_summary(
            Summary(value=[Summary.Value(tag=tag, image=img)]), int(step))
        self._tb.flush()

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
