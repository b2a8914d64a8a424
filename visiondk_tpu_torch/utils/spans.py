"""Spans of the port's layers, on the profiler's clock.

``span(name, rows=None, device=None)`` marks a stretch of the program: a
train step and its phases, a serving call, one attention op's forward or
backward. Unless a ``torch.profiler`` is recording it does nothing: it
returns one shared no-op context, creates no object, enters no
``record_function`` and records no CUDA event, so the off path costs a flag
read (``torch.autograd.profiler._is_profiler_enabled``) and a ``with``.

While a profiler records, a span enters ``torch.profiler.record_function``
(it lands in the trace as a ``user_annotation``, on the same clock as the
device's kernels) and keeps an in-memory record: its name, its parent (the
innermost span open in the process when it opened), its root (the outermost,
the step or call it belongs to), host start and end (``perf_counter_ns``),
on a root ``rows``, the rows of the batch at the boundary, and, where the
root's ``device`` is a CUDA device, a pair of
``torch.cuda.Event(enable_timing=True)`` on the stream that was current when
the root opened (every span of the root records there).

A span's CUDA-event time is the device's time from its start to its end
event, and holds every stretch in which the card sat waiting on the host
inside it. So each span also notes whether the card led it: whether the
device had not yet reached its start event when the host closed it. Then
the host had queued all of the span's work before the device began it, and
the event time is the device's own: within a few per cent of the busy time
of the kernels launched inside the span, on an H100.

The stack of open spans is one for the process, under a lock, not one a
thread: the autograd engine runs a CUDA backward on its own thread while the
caller blocks in ``loss.backward()``, and the spans the engine's thread opens
take the caller's open span as their parent.

``summary()`` resolves the events (after the caller has synchronised the
device) and returns, for each root, each span name's count, host and device
seconds, self seconds (the span's duration less the part of it that its
child spans cover) and each span's device seconds and whether the card led
it. ``clear()`` empties the record; ``dump(path)`` writes it as JSON. At most
``MAX_ROOTS`` roots are kept, the newest; the events of a root that is
dropped or resolved are reused.

The spans (``engine/steps.py``, ``ops/attention.py``, ``ops/window_attention.py``):
``vdk.train.step`` (root) with ``vdk.train.preprocess``, ``vdk.train.forward``,
``vdk.train.backward``, ``vdk.train.sam``, ``vdk.train.update`` and, inside it,
``vdk.train.ema``; ``vdk.serve.step`` (root); ``vdk.attention`` and
``vdk.attention.backward`` in every attention op.
"""

from __future__ import annotations

import collections
import contextlib
import json
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.autograd import profiler as _profiler

MAX_ROOTS = 256

_OFF = contextlib.nullcontext()


class Span:
    """One span, open or closed. Device times are seconds from its root's
    start event, filled in when the root is resolved."""

    __slots__ = ("name", "rows", "device", "parent", "root", "children", "host", "events", "stream", "device_s",
                 "led", "_fn", "_record")

    def __init__(self, record: "SpanRecord", name: str, rows: Optional[int], device):
        self._record, self.name, self.rows, self.device = record, name, rows, device
        self.parent: Optional[Span] = None
        self.root: Span = self
        self.children: List[Span] = []   # on a root: every span of the root, itself first
        self.host = [0, 0]               # perf_counter_ns at start and end
        self.events: Optional[Tuple] = None
        self.stream = None               # the stream the root's events record on
        self.device_s: Optional[Tuple[float, float]] = None
        self.led = False                 # the device had not reached the start event when the host closed it
        self._fn = None

    def __enter__(self) -> "Span":
        self._fn = torch.profiler.record_function(self.name)
        self._fn.__enter__()
        self._record.open(self)
        return self

    def __exit__(self, *exc) -> None:
        self._record.close(self)
        self._fn.__exit__(*exc)
        self._fn = None


class SpanRecord:
    """The spans of the process: the open stack, the last ``MAX_ROOTS``
    closed roots, and a pool of CUDA events to reuse."""

    def __init__(self):
        self._lock = threading.Lock()
        self._open: List[Span] = []
        self._roots: collections.deque = collections.deque()
        self._free: Dict[torch.device, List[torch.cuda.Event]] = {}

    # ---------------------------------------------------------------- recording

    def _event(self, device: torch.device) -> torch.cuda.Event:
        with self._lock:
            free = self._free.get(device)
            if free:
                return free.pop()
        return torch.cuda.Event(enable_timing=True)

    def open(self, s: Span) -> None:
        with self._lock:
            if self._open:
                s.parent = self._open[-1]
                s.root = s.parent.root
            s.root.children.append(s)
            self._open.append(s)
        if s.root is s and s.device is not None and torch.device(s.device).type == "cuda":
            s.device = torch.device(s.device)
            if s.device.index is None:
                s.device = torch.device("cuda", torch.cuda.current_device())
            s.stream = torch.cuda.current_stream(s.device)
        else:
            s.device, s.stream = s.root.device, s.root.stream
        if s.stream is not None:
            s.events = (self._event(s.device), self._event(s.device))
            s.events[0].record(s.stream)
        s.host[0] = time.perf_counter_ns()

    def close(self, s: Span) -> None:
        s.host[1] = time.perf_counter_ns()
        if s.events is not None:
            s.events[1].record(s.stream)
            s.led = not s.events[0].query()
        with self._lock:
            for i in range(len(self._open) - 1, -1, -1):
                if self._open[i] is s:
                    del self._open[i]
                    break
            if s.root is s:
                self._roots.append(s)
                while len(self._roots) > MAX_ROOTS:
                    self._recycle(self._roots.popleft())

    def _recycle(self, root: Span) -> None:
        """Returns a root's events to the pool (under the lock)."""
        for s in root.children:
            if s.events is not None:
                self._free.setdefault(s.device, []).extend(s.events)
                s.events = None

    def clear(self) -> None:
        with self._lock:
            for root in self._roots:
                self._recycle(root)
            self._roots.clear()

    # ---------------------------------------------------------------- reading

    def _resolve(self, root: Span) -> None:
        """Device seconds of each span of ``root`` from its start event; needs
        the device to have passed every event (the caller synchronises)."""
        if root.events is None:
            return
        origin = root.events[0]
        for s in root.children:
            if s.events is not None:
                s.events[1].synchronize()
                s.device_s = (origin.elapsed_time(s.events[0]) * 1e-3, origin.elapsed_time(s.events[1]) * 1e-3)
        with self._lock:
            self._recycle(root)

    def roots(self) -> List[Span]:
        with self._lock:
            roots = list(self._roots)
        for root in roots:
            self._resolve(root)
        return roots

    def summary(self) -> List[Dict]:
        """For each kept root, oldest first: ``name``, ``rows`` and ``spans``,
        each span name's ``count``, ``host_s``, ``self_host_s``, ``device_s``
        and ``self_device_s`` (summed over the root's spans of that name), and
        ``device_each`` and ``led_each``, each span's device seconds and
        whether the card led it, in opening order. The device ones are None
        where the root ran on no CUDA device."""
        return [_root_summary(root) for root in self.roots()]

    def dump(self, path) -> None:
        """The record as JSON: each root's spans in opening order (name,
        parent index, host and device seconds from the root's start, whether
        the card led it) and its summary."""
        out = []
        for root in self.roots():
            index = {id(s): i for i, s in enumerate(root.children)}
            spans = [{"name": s.name, "parent": index.get(id(s.parent)),
                      "host_s": [(s.host[0] - root.host[0]) * 1e-9, (s.host[1] - root.host[0]) * 1e-9],
                      "device_s": list(s.device_s) if s.device_s is not None else None, "led": s.led}
                     for s in root.children]
            out.append({**_root_summary(root), "host_start_ns": root.host[0], "spans_in_order": spans})
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"max_roots": MAX_ROOTS, "roots": out}, indent=1))


def _covered(start: float, end: float, parts: Sequence[Tuple[float, float]]) -> float:
    """The length of [start, end] that the union of ``parts`` covers."""
    total, reach = 0.0, start
    for a, b in sorted(parts):
        a, b = max(a, reach), min(b, end)
        if b > a:
            total += b - a
            reach = b
    return total


def _root_summary(root: Span) -> Dict:
    kids: Dict[int, List[Span]] = {}
    for s in root.children:
        if s.parent is not None:
            kids.setdefault(id(s.parent), []).append(s)
    on_device = root.device_s is not None
    names: Dict[str, Dict] = {}
    for s in root.children:
        below = kids.get(id(s), [])
        host = (s.host[1] - s.host[0]) * 1e-9
        self_host = host - _covered(s.host[0], s.host[1], [tuple(c.host) for c in below]) * 1e-9
        row = names.setdefault(s.name, {"count": 0, "host_s": 0.0, "self_host_s": 0.0,
                                        "device_s": 0.0 if on_device else None,
                                        "self_device_s": 0.0 if on_device else None,
                                        "device_each": [] if on_device else None,
                                        "led_each": [] if on_device else None})
        row["count"] += 1
        row["host_s"] += host
        row["self_host_s"] += self_host
        if on_device:
            a, b = s.device_s
            row["device_s"] += b - a
            row["self_device_s"] += (b - a) - _covered(a, b, [c.device_s for c in below])
            row["device_each"].append(b - a)
            row["led_each"].append(s.led)
    return {"name": root.name, "rows": root.rows, "spans": names}


RECORD = SpanRecord()


def span(name: str, rows: Optional[int] = None, device=None):
    """A span named ``name`` while a profiler records (see the module doc),
    else the shared no-op context. ``rows`` and ``device``, read on a root:
    the batch rows at its boundary, and where its work runs (its spans record
    CUDA events where that is a CUDA device)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return Span(RECORD, name, rows, device)


def summary() -> List[Dict]:
    return RECORD.summary()


def clear() -> None:
    RECORD.clear()


def dump(path) -> None:
    RECORD.dump(path)
