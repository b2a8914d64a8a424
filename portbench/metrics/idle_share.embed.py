"""idle_share.embed: the device's idle share of the traced stretch of an embed cell, in %."""

from portbench.metrics._idle import share


def read(cell):
    return share(cell) if cell.traffic["kind"] == "embed" else None
