"""Console colorization, image annotation and confusion-matrix rendering
(counterpart of ``visiondk_tpu/utils/plots.py``: ``colorstr``, ``Annotator``
and ``load_font``, which the predict tools use, and
``plot_confusion_matrix``). matplotlib is imported only when a confusion
matrix is drawn.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_COLORS = {
    "black": "\033[30m",
    "red": "\033[31m",
    "green": "\033[32m",
    "yellow": "\033[33m",
    "blue": "\033[34m",
    "magenta": "\033[35m",
    "cyan": "\033[36m",
    "white": "\033[37m",
    "bright_black": "\033[90m",
    "bright_red": "\033[91m",
    "bright_green": "\033[92m",
    "bright_yellow": "\033[93m",
    "bright_blue": "\033[94m",
    "bright_magenta": "\033[95m",
    "bright_cyan": "\033[96m",
    "bright_white": "\033[97m",
    "bold": "\033[1m",
    "underline": "\033[4m",
    "end": "\033[0m",
}


def colorstr(*inputs):
    """colorstr('blue', 'bold', 'hello') or colorstr('hello') (default blue+bold)."""
    if len(inputs) == 1:
        styles, text = ("blue", "bold"), inputs[0]
    else:
        styles, text = inputs[:-1], inputs[-1]
    return "".join(_COLORS[s] for s in styles) + str(text) + _COLORS["end"]


def load_font(size: int):
    """DejaVuSans at ``size`` where PIL finds it, else PIL's default font
    (nothing is downloaded)."""
    from PIL import ImageFont

    try:
        return ImageFont.truetype("DejaVuSans.ttf", size)
    except OSError:
        return ImageFont.load_default()


class Annotator:
    """Draw top-k prediction text onto a PIL image (top-left, stacked)."""

    def __init__(self, im, font_size: Optional[int] = None):
        from PIL import ImageDraw

        self.im = im
        self.draw = ImageDraw.Draw(im)
        self.font = load_font(font_size or max(round(sum(im.size) / 2 * 0.035), 12))
        self._y = 2

    def text(self, text: str, color=(255, 0, 0)) -> None:
        self.draw.text((2, self._y), text, fill=color, font=self.font)
        bbox = self.draw.textbbox((2, self._y), text, font=self.font)
        self._y = bbox[3] + 2


def plot_confusion_matrix(
    cm: np.ndarray,
    class_names: Sequence[str],
    save_path,
    normalize: bool = True,
) -> Path:
    """Render an NxN confusion matrix heatmap to PNG. Returns the saved path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cm = np.asarray(cm, dtype=np.float64)
    if normalize:
        denom = cm.sum(axis=1, keepdims=True)
        cm_show = np.divide(cm, denom, out=np.zeros_like(cm), where=denom > 0)
    else:
        cm_show = cm

    n = len(class_names)
    fig, ax = plt.subplots(figsize=(max(6, n * 0.7), max(5, n * 0.6)))
    im = ax.imshow(cm_show, interpolation="nearest", cmap="Blues")
    fig.colorbar(im, ax=ax)
    ax.set(
        xticks=np.arange(n),
        yticks=np.arange(n),
        xticklabels=class_names,
        yticklabels=class_names,
        ylabel="True label",
        xlabel="Predicted label",
        title="Confusion matrix",
    )
    plt.setp(ax.get_xticklabels(), rotation=45, ha="right")
    thresh = cm_show.max() / 2.0 if cm_show.size else 0.5
    for i in range(n):
        for j in range(n):
            ax.text(
                j,
                i,
                f"{cm_show[i, j]:.2f}" if normalize else f"{int(cm[i, j])}",
                ha="center",
                va="center",
                color="white" if cm_show[i, j] > thresh else "black",
                fontsize=8,
            )
    fig.tight_layout()
    save_path = Path(save_path)
    save_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_path, dpi=150)
    plt.close(fig)
    return save_path
