"""update_ms.train: the device ms a train step spends inside its update phase,
the span ``vdk.train.update`` (``apply_update``: accumulation, the clip,
schedules, SGD and the EMA), over the traced steps that the card led
(``_spans.per_call``)."""

from portbench.metrics._spans import per_call


def read(cell):
    if cell.traffic["kind"] not in ("train", "train_ddp"):
        return None
    update = per_call("vdk.train.step", "vdk.train.update", [None])
    return update[0] * 1e3 if update else None
