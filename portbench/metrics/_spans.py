"""Readings of the port's own spans (``visiondk_tpu_torch/utils/spans.py``),
the one module of the benchmark that imports them.

The port records spans only while a profiler records, so once a traffic kind
has run, the record holds the calls of its traced stretch alone
(``trace_calls`` + ``labelled_calls``), each under one root span
(``vdk.train.step``, ``vdk.serve.step``).

A span's CUDA-event time holds the card's waits on the host inside it,
unless the card led the span: the device had not reached the span's start
when the host closed it, so all of its work was queued before the device
began it. A reading therefore takes, for each call of a span in a root (the
k-th span of its name, the same call in every root), the median over the
traced roots of the calls the card led. Calls of one shape (``keys``) do the
same work and are pooled; a shape the card never led falls back to the
least of its event times, which still holds some wait.

None where there is nothing to read: a port without spans, no root of the
name (no traced stretch, or the ranks of ``train_ddp``, which are child
processes), roots that ran on no CUDA device, or roots that hold another
number of the span than ``keys`` has.
"""

from __future__ import annotations

import importlib
import statistics
from typing import Dict, Hashable, List, Optional, Sequence, Tuple


def roots(name: str) -> List[Dict]:
    """The summaries of the kept roots named ``name``."""
    try:
        spans = importlib.import_module("visiondk_tpu_torch.utils.spans")
    except ModuleNotFoundError:  # a port that has no spans
        return []
    return [r for r in spans.summary() if r["name"] == name]


def per_call(root: str, name: str, keys: Sequence[Hashable]) -> Optional[List[float]]:
    """The device seconds of each call of the span ``name`` in the roots named
    ``root``, in opening order: ``keys[k]`` is the shape of the k-th call, and
    a shape's seconds are the median over its calls that the card led (the
    least of its calls where it led none)."""
    found = roots(root)
    if not found:
        return None
    pooled: Dict[Hashable, Tuple[List[float], List[float]]] = {}
    for r in found:
        row = r["spans"].get(name)
        if row is None or row.get("device_each") is None or row["count"] != len(keys):
            return None
        for key, seconds, led in zip(keys, row["device_each"], row["led_each"]):
            pooled.setdefault(key, ([], []))[0 if led else 1].append(seconds)
    each = {key: statistics.median(led) if led else min(waited) for key, (led, waited) in pooled.items()}
    return [each[key] for key in keys]
