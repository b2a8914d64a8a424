"""setup_s: seconds from process start to the first timed call (building the
model, the weights, the step and the pool; compiling; the warm-up calls)."""


def read(cell):
    return cell.setup_s if cell.setup_s > 0 else None
