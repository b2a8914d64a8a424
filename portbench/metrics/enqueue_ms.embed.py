"""enqueue_ms.embed: the mean host ms from an embed call's start to the
step's return, before the copy to the host, over the window's calls."""


def read(cell):
    if cell.traffic["kind"] != "embed" or not cell.enqueue_s:
        return None
    return sum(cell.enqueue_s) / len(cell.enqueue_s) * 1e3
