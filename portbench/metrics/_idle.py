"""The device's idle share of a traced stretch: 1 − (the union of its
device operations' intervals) / (the stretch's host seconds), in %."""


def share(cell):
    if cell.trace is None or cell.trace.window_s <= 0 or cell.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - cell.trace.busy_s / cell.trace.window_s)
