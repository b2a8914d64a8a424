"""nccl_ms.train: rank 0's device ms a step in NCCL kernels (the gradient
all-reduce of DDP, the global BatchNorm moments, the loss's mean) in the
traced stretch of a data-parallel train cell."""

KERNEL_KEYS = ("nccl",)


def read(cell):
    if cell.traffic["kind"] != "train_ddp" or cell.trace is None or cell.trace.calls <= 0:
        return None
    device_s = cell.trace.seconds(KERNEL_KEYS)
    return device_s / cell.trace.calls * 1e3 if device_s > 0 else None
