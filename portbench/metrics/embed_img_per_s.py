"""embed_img_per_s: every image embedded and copied to the host in the
window, over the window."""


def read(cell):
    if cell.traffic["kind"] != "embed" or cell.window_s <= 0:
        return None
    return cell.images / cell.window_s
