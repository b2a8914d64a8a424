"""Prediction and retrieval visualization (counterpart of
``visiondk_tpu/engine/visualizer.py``).

- ``predict_images``: per-image top-5 prediction annotation, an optional CAM
  overlay side by side (``utils/cam.py``), the pseudo-label dump
  (``labels/<stem>.txt``) and badcase sorting into ``bad_case/`` keyed on a
  target class.
- ``visualize_results``: the CBIR query / ground-truth / top-k retrieval grid
  with red TP outlines, fed by ``engine/cbir_eval.valuate(vis=True)``, drawn
  with PIL in the JAX figure's layout.

Host code; the device work is the caller's forward and CAM passes.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
from PIL import Image, ImageDraw

from visiondk_tpu_torch.data.datasets import read_image
from visiondk_tpu_torch.utils.plots import Annotator, load_font

_CELL = (300, 600)  # one cell of the retrieval grid, pixels (3 × 6 in at 100 dpi)
_TITLE, _TITLE_SIZE, _PAD = 40, 20, 8


def _softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max())
    return e / e.sum()


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


class Visualizer:
    @staticmethod
    def predict_images(
        forward: Callable[[np.ndarray], np.ndarray],
        dataset,
        visual_path: Union[str, Path],
        class_indices: Dict[int, str],
        logger,
        thresh: Union[float, List[float]] = 0,
        remove_label: bool = False,
        save_image: bool = True,
        badcase: bool = False,
        cam=None,
        target_class: Optional[str] = None,
    ) -> None:
        """``forward(input [1,H,W,3] uint8) -> logits [C]``.

        ``dataset`` yields (raw PIL image, transformed array, path) triples
        (``visualize.py`` builds them over ``PredictImageDatasets``).
        ``thresh == 0`` means single-label (softmax); otherwise multilabel
        (sigmoid) with a scalar or per-class threshold vector.
        """
        visual_path = Path(visual_path)
        visual_path.mkdir(parents=True, exist_ok=True)
        is_single_label = isinstance(thresh, (int, float)) and thresh == 0
        activation = _softmax if is_single_label else _sigmoid

        target_thresh = None
        if not is_single_label:
            if target_class is None:
                raise ValueError("multilabel badcase/thresholding needs --target_class")
            target_idx = None
            for idx, name in class_indices.items():
                if name == target_class:
                    target_idx = int(idx)
                    break
            if target_idx is None:
                raise ValueError(f"Target class {target_class} not found in class indices")
            target_thresh = (
                float(thresh[target_idx]) if isinstance(thresh, (list, tuple)) else float(thresh)
            )

        n = len(dataset)
        width = len(str(n))
        fixed = 15
        postfix_table: Dict[str, str] = {}

        for i in range(n):
            raw_img, inputs, img_path = dataset[i]
            pil_img = raw_img if isinstance(raw_img, Image.Image) else Image.fromarray(np.asarray(raw_img))

            x = np.asarray(inputs)[None]
            logits = np.asarray(forward(x)).squeeze()
            probs = activation(logits.astype(np.float64))
            top5i = np.argsort(-probs)[:5].tolist()

            lines = [f"{class_indices[j]:<{fixed}} {probs[j]:.2f}" for j in top5i]
            text = "\n".join(lines)
            flat = "      ".join(f"{class_indices[j]:<{fixed}}{probs[j]:.2f}" for j in top5i)
            logger.console(
                f"[{i + 1:>{width}}|{n:<{width}}] {os.path.basename(img_path):<20} {flat}"
            )

            if cam is not None:
                cam_image = cam(image=np.asarray(pil_img), input_tensor=x)

            if not remove_label:
                annotator = Annotator(pil_img)
                for line in lines:
                    annotator.text(line, color=(0, 0, 0))

            if remove_label or badcase:
                labels_dir = visual_path / "labels"
                labels_dir.mkdir(exist_ok=True)
                stem = os.path.splitext(os.path.basename(img_path))[0]
                postfix_table[stem + ".txt"] = os.path.splitext(img_path)[1]
                with open(labels_dir / (stem + ".txt"), "a") as f:
                    f.write(text + "\n")  # "<class> <prob>" per line

            if save_image:
                out = visual_path / os.path.basename(img_path)
                if cam is not None:
                    side = np.hstack([np.asarray(pil_img), cam_image])
                    Image.fromarray(side).save(out)
                else:
                    pil_img.save(out)

        if badcase:
            Visualizer._sort_badcases(
                visual_path, postfix_table, is_single_label, target_class, target_thresh
            )

    @staticmethod
    def _sort_badcases(
        visual_path: Path,
        postfix_table: Dict[str, str],
        is_single_label: bool,
        target_class: Optional[str],
        target_thresh: Optional[float],
    ) -> None:
        """Move images whose prediction misses ``target_class`` into
        ``bad_case/``."""
        bad_dir = visual_path / "bad_case"
        bad_dir.mkdir(exist_ok=True)
        for txt in sorted((visual_path / "labels").glob("*.txt")):
            with open(txt) as f:
                lines = [ln for ln in f.read().splitlines() if ln.strip()]
            if is_single_label:
                is_bad = lines[0].split()[0] != target_class
            else:
                is_bad = True
                for line in lines:
                    name, prob = line.split()[0], float(line.split()[1])
                    if name == target_class and prob >= (target_thresh or 0.0):
                        is_bad = False
                        break
            if is_bad:
                img_name = txt.name.replace(".txt", postfix_table.get(txt.name, ""))
                src = visual_path / img_name
                if src.is_file():
                    shutil.move(str(src), str(bad_dir / img_name))

    @staticmethod
    def visualize_results(
        query: str,
        retrieval_results: Sequence[str],
        scores: Sequence[float],
        ground_truths: Sequence[str],
        savedir: Union[str, Path],
        max_rank: int = 5,
    ) -> Path:
        """Query / GT / top-k grid with red TP outlines, saved as
        ``<query's folder>_<query's name>`` in ``savedir``: the JAX
        package's 2 × (max_rank + 1) figure of 3 × 6 in cells at 100 dpi, its
        top row the first ground truths (up to 5), its bottom row the query
        and then the results titled ``score/true|false``. Drawn with PIL,
        so the grids need no matplotlib."""
        savedir = Path(savedir)
        savedir.mkdir(parents=True, exist_ok=True)
        cols = max_rank + 1
        canvas = Image.new("RGB", (cols * _CELL[0], 2 * _CELL[1]), "white")
        draw = ImageDraw.Draw(canvas)
        font = load_font(_TITLE_SIZE)

        def cell(row: int, col: int, path: str, title: str, outline: bool = False) -> None:
            img = read_image(path)
            fit = min((_CELL[0] - 2 * _PAD) / img.width, (_CELL[1] - _TITLE - 2 * _PAD) / img.height)
            img = img.resize((max(1, round(img.width * fit)), max(1, round(img.height * fit))), Image.BILINEAR)
            x = col * _CELL[0] + (_CELL[0] - img.width) // 2
            y = row * _CELL[1] + _TITLE + (_CELL[1] - _TITLE - img.height) // 2
            canvas.paste(img, (x, y))
            if outline:
                draw.rectangle((x, y, x + img.width - 1, y + img.height - 1), outline=(255, 0, 0), width=8)
            width = draw.textlength(title, font=font)
            draw.text((col * _CELL[0] + (_CELL[0] - width) / 2, y - _TITLE + _PAD), title, fill=(0, 0, 0),
                      font=font)

        cell(1, 0, query, "Query")
        for i in range(min(5, cols, len(ground_truths))):
            cell(0, i, ground_truths[i], "Ground Truth")
        for i in range(min(max_rank, len(retrieval_results))):
            is_tp = retrieval_results[i] in ground_truths
            cell(1, i + 1, retrieval_results[i], "{:.4f}/{}".format(float(scores[i]), "true" if is_tp else "false"),
                 outline=is_tp)

        image_unique = (
            os.path.basename(os.path.dirname(query)) + "_" + os.path.basename(query)
        )
        out = savedir / image_unique
        canvas.save(out)
        return out
