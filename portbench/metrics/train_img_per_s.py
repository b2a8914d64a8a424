"""train_img_per_s: every image of every train step completed in the window
(all ranks' rows), over the window, which ends with a synchronisation."""


def read(cell):
    if cell.traffic["kind"] not in ("train", "train_ddp") or cell.window_s <= 0:
        return None
    return cell.images / cell.window_s
