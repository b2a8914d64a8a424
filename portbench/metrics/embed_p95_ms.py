"""embed_p95_ms: the 95th percentile (nearest rank) over every call of the
window of the time from the call's start to its embeddings on the host."""

import math


def read(cell):
    if cell.traffic["kind"] != "embed" or not cell.latencies_s:
        return None
    ordered = sorted(cell.latencies_s)
    return ordered[math.ceil(0.95 * len(ordered)) - 1] * 1e3
