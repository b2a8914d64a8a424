"""The attention op's share of its roofline in a traced stretch: the Σ of
each call's bound (``counts.attention_bound_s``, the op's interface) over the
device seconds of the port's attention kernels, found by name."""

from portbench import counts

# the port's attention kernels (csrc/fused_qkv_attention*.cu, csrc/fused_window_attention*.cu)
KERNEL_KEYS = ("attention", "dbias_sum")


def share(cell, train: bool):
    if cell.trace is None or cell.trace.calls <= 0:
        return None
    device_s = cell.trace.seconds(KERNEL_KEYS)
    if device_s <= 0:
        return None
    bound = counts.attention_bound_s(cell.cfg["arch"], cell.traffic["batch"], train) * cell.trace.calls
    return 100.0 * bound / device_s
