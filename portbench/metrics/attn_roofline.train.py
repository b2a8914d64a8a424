"""attn_roofline.train: the attention op's forward plus backward bound over
its kernels' device time in the traced stretch of a train cell, in %."""

from portbench.metrics._attention import share


def read(cell):
    if cell.traffic["kind"] not in ("train", "train_ddp"):
        return None
    return share(cell, train=True)
