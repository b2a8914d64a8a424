"""Reading the device trace of a stretch of calls.

``profile_stretch`` runs ``calls`` calls of a function twice under
``torch.profiler``: first with CUDA activity alone (what the device ran, with
the least cost to the host), then a few calls with the host's operators too,
so that each idle gap can be named by what the host was doing. Each trace is
exported as Chrome-trace JSON into a temporary directory (under ``TMPDIR``)
and read back.

From the first stretch: the seconds in which some device operation ran (the
union of the kernel, memcpy and memset intervals), the host seconds of the
stretch (between two synchronisations), and each device operation's seconds
and count by name. From the second: the device's idle gaps, each charged to
the innermost host operator or annotation that spans the gap's middle.
"""

from __future__ import annotations

import dataclasses
import heapq
import json
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Tuple


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
NAME_CHARS = 120


@dataclasses.dataclass
class Trace:
    window_s: float                             # host seconds of the traced calls
    busy_s: float                               # union of device operation intervals
    calls: int
    ops: Dict[str, Tuple[float, int]]           # device operation name → (seconds, count)
    gaps: List[Tuple[str, float]]               # host label → idle seconds, largest first

    def seconds(self, keys) -> float:
        """Device seconds of the operations whose lower-case name holds any of ``keys``."""
        return sum(s for name, (s, _) in self.ops.items() if any(k in name.lower() for k in keys))


def _events(prof) -> List[dict]:
    with tempfile.TemporaryDirectory(prefix="portbench-trace-") as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        data = json.loads(path.read_text())
    return data["traceEvents"] if isinstance(data, dict) else data


def _device(events: List[dict]) -> List[Tuple[float, float, str]]:
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            out.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e.get("name", "?")))
    return sorted(out)


def union(intervals: List[Tuple[float, float, str]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for start, end, _ in intervals:
        if merged and start <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], end))
        else:
            merged.append((start, end))
    return merged


def label_gaps(events: List[dict]) -> List[Tuple[str, float]]:
    """Idle seconds between device operations, by the innermost host span at each gap's middle."""
    busy = union(_device(events))
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e.get("name", "?"))
                  for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS)
    totals: Dict[str, float] = {}
    active: List[Tuple[float, float, str]] = []  # max-heap by start: (−start, end, name)
    k = 0
    for (_, end), (start, _) in zip(busy, busy[1:]):
        mid = 0.5 * (end + start)
        while k < len(host) and host[k][0] <= mid:
            heapq.heappush(active, (-host[k][0], host[k][1], host[k][2]))
            k += 1
        # the latest-starting span still running at ``mid`` is the innermost of nested spans;
        # a span that ended before this middle has ended before every later one
        while active and active[0][1] < mid:
            heapq.heappop(active)
        label = active[0][2][:NAME_CHARS] if active else "(no host span)"
        totals[label] = totals.get(label, 0.0) + (start - end) * 1e-6
    return sorted(totals.items(), key=lambda kv: -kv[1])


def profile_stretch(fn: Callable[[int], None], calls: int, labelled_calls: int, sync: Callable[[], None]) -> Trace:
    """Traces ``calls`` calls ``fn(i)``, then ``labelled_calls`` more with the host's operators."""
    from torch.profiler import ProfilerActivity, profile, record_function

    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        for i in range(calls):
            fn(i)
        sync()
        window = time.perf_counter() - t0
    events = _device(_events(prof))
    busy = sum(end - start for start, end in union(events)) * 1e-6
    ops: Dict[str, Tuple[float, int]] = {}
    for start, end, name in events:
        s, c = ops.get(name, (0.0, 0))
        ops[name] = (s + (end - start) * 1e-6, c + 1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(labelled_calls):
            with record_function("portbench.call"):
                fn(calls + i)
        sync()
    gaps = label_gaps(_events(prof))
    return Trace(window_s=window, busy_s=busy, calls=calls, ops=ops, gaps=gaps)


def breakdown(trace: Trace, top: int = 10) -> Dict[str, list]:
    ops = sorted(((name[:NAME_CHARS], s) for name, (s, _) in trace.ops.items()), key=lambda kv: -kv[1])
    merged: Dict[str, float] = {}
    for name, s in ops:
        merged[name] = merged.get(name, 0.0) + s
    device_ops = sorted(merged.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in device_ops], "idle_gaps": [[n, s] for n, s in trace.gaps[:top]]}
