"""mfu.train: the train step's model FLOPs (3x the forward's products, from
the configuration's shapes; recomputation not counted) over every image of
the run's timed window, as a share of the chips' bf16 peak."""

from portbench import counts


def read(cell):
    if cell.traffic["kind"] not in ("train", "train_ddp") or cell.window_s <= 0:
        return None
    rate = counts.step_flops(cell.cfg["arch"], cell.images, train=True) / cell.window_s
    return 100.0 * rate / (cell.chips * counts.PEAK_BF16_FLOP_PER_S)
