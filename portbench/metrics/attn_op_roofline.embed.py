"""attn_op_roofline.embed: the attention op's forward bound
(``counts.attention_bound_s``, the op's interface) over the device seconds an
embed call spends inside the op's span ``vdk.attention``, in %. Each call's
seconds are those of the traced calls of its shape that the card led
(``_spans.per_call``)."""

from portbench import counts
from portbench.metrics._spans import per_call


def read(cell):
    if cell.traffic["kind"] != "embed":
        return None
    keys = counts.attention_calls(cell.cfg["arch"], cell.traffic["batch"], False)
    forward = per_call("vdk.serve.step", "vdk.attention", keys)
    if forward is None:
        return None
    return 100.0 * counts.attention_bound_s(cell.cfg["arch"], cell.traffic["batch"], False) / sum(forward)
