"""idle_share.train: the device's idle share of the traced stretch of a train cell, in %."""

from portbench.metrics._idle import share


def read(cell):
    return share(cell) if cell.traffic["kind"] in ("train", "train_ddp") else None
