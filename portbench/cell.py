"""One run of one cell: what the traffic kind is given and what it records.
The metric readers (``portbench/metrics/<name>.py``) read a ``Cell``."""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from portbench.trace import Trace


@dataclasses.dataclass
class Cell:
    name: str
    cfg: Dict                      # configs/<config>.json
    traffic: Dict                  # traffic/<traffic>.json
    limits: Dict[str, float]       # workloads/<cell>.json "limits"
    seed: int
    seconds: float
    trace_on: bool
    device: object                 # torch.device of rank 0
    chips: int = 1
    started: float = dataclasses.field(default_factory=time.perf_counter)
    fault: Optional[str] = None    # a planted fault (the harness's own tests)

    # recorded by the traffic kind
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    images: int = 0                # images completed in the window (all ranks)
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    enqueue_s: List[float] = dataclasses.field(default_factory=list)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)   # kernel launches a window call
    memory_peak_bytes: int = 0
    trace: Optional[Trace] = None
    numbers: Dict[str, float] = dataclasses.field(default_factory=dict)  # compared with ``limits``
    where: Dict[str, str] = dataclasses.field(default_factory=dict)      # the leaf or step of each number
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)   # set-up seconds by phase

    def phase(self, name: str) -> None:
        """Marks the end of a set-up phase (printed on standard error)."""
        self.phases[name] = round(time.perf_counter() - self.started - sum(self.phases.values()), 3)

    def mark_setup(self) -> None:
        """Set-up ends here: from process start to the first timed call."""
        self.setup_s = time.perf_counter() - self.started
