"""attn_roofline.embed: the attention op's forward bound (read qkv and the
bias, write O) over its kernels' device time in the traced stretch of an
embed cell, in %."""

from portbench.metrics._attention import share


def read(cell):
    if cell.traffic["kind"] != "embed":
        return None
    return share(cell, train=False)
