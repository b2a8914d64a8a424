"""attn_op_roofline.train: the attention op's forward plus backward bound
(``counts.attention_bound_s``, the op's interface) over the device seconds a
train step spends inside the op's spans, ``vdk.attention`` and
``vdk.attention.backward``, in %. The spans hold all the op does on the
device, whatever implements it: its kernels and the backward's cast and copy
of dO. Each call's seconds are those of the traced calls of its shape that
the card led (``_spans.per_call``); the backward runs the blocks in reverse."""

from portbench import counts
from portbench.metrics._spans import per_call


def read(cell):
    if cell.traffic["kind"] not in ("train", "train_ddp"):
        return None
    keys = counts.attention_calls(cell.cfg["arch"], cell.traffic["batch"], False)
    forward = per_call("vdk.train.step", "vdk.attention", keys)
    backward = per_call("vdk.train.step", "vdk.attention.backward", keys[::-1])
    if forward is None or backward is None:
        return None
    return 100.0 * counts.attention_bound_s(cell.cfg["arch"], cell.traffic["batch"], True) / (sum(forward)
                                                                                              + sum(backward))
