"""optim_ms.train: device ms a step of the optimizer and the EMA (the clip's
norms, SGD and the EMA's lerp run as foreach kernels, ``multi_tensor_apply``)
in the traced stretch of a train cell."""

KERNEL_KEYS = ("multi_tensor", "foreach")


def read(cell):
    if cell.traffic["kind"] not in ("train", "train_ddp") or cell.trace is None or cell.trace.calls <= 0:
        return None
    device_s = cell.trace.seconds(KERNEL_KEYS)
    return device_s / cell.trace.calls * 1e3 if device_s > 0 else None
