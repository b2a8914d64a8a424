"""Scalar metrics writer (counterpart of ``visiondk_tpu/utils/metrics_writer.py``).

One JSON record per scalar in ``metrics.jsonl`` in the run directory,
``{"tag", "value", "step", "ts"}``, as the JAX package writes it: the
classification loop writes Train_loss, Train_images_per_sec, Train_lr and
Val_<metric> once per epoch (step = epoch). The JAX writer also mirrors the
scalars to TensorBoard where it is installed; this one writes the JSONL
stream only.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Union


class MetricsWriter:
    def __init__(self, logdir: Union[str, Path]):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.logdir / "metrics.jsonl", "a")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        rec = {"tag": tag, "value": float(value), "step": int(step), "ts": time.time()}
        self._jsonl.write(json.dumps(rec) + "\n")

    def flush(self) -> None:
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()
