"""mfu.embed: the forward's model FLOPs over every image embedded in the
run's timed window, as a share of the card's bf16 peak."""

from portbench import counts


def read(cell):
    if cell.traffic["kind"] != "embed" or cell.window_s <= 0:
        return None
    rate = counts.step_flops(cell.cfg["arch"], cell.images, train=False) / cell.window_s
    return 100.0 * rate / counts.PEAK_BF16_FLOP_PER_S
