"""Train/val image datasets over a folder tree, a CSV or a HuggingFace
dataset (counterpart of ``visiondk_tpu/data/datasets.py``).

``ImageDatasets`` (with ``class_indices.json`` written into the run dir at
train time and read back at eval time, and a corrupt-image retry),
``smooth_labels`` (the BCE path's smoothed multi-hot targets),
``tell_data_distribution`` (the per-class train/val table) and
``read_image`` (PIL, cv2 as a fallback where installed). ``__getitem__``
returns a **uint8 HWC** array; the loaders stack fixed-shape numpy batches.
``CBIRDatasets`` is the query/gallery pair of the CBIR task and
``EmbeddingDistillDataset`` the (image, teacher feature) pairs of embedding
distillation, ``PredictImageDatasets`` the images the predict tools run
over. A CSV is read with the stdlib ``csv`` module (``read_label_csv``), as
the JAX package reads it with pandas. The HF source needs the ``datasets``
library and a dataset it can load offline.
"""

from __future__ import annotations

import csv
import json
import os
import random
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
from PIL import Image

IMG_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp", ".webp", ".tif", ".tiff"}


def read_image(path: str) -> Image.Image:
    """PIL first, cv2 fallback (reference basedataset.py:233-241)."""
    try:
        return Image.open(path).convert("RGB")
    except OSError:
        import cv2

        img = cv2.imread(path)
        if img is None:
            raise
        return Image.fromarray(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))


_CSV_TRUE = {"True", "TRUE", "true"}
_CSV_FALSE = {"False", "FALSE", "false"}


def read_label_csv(path: str) -> Tuple[List[str], List[Tuple[str, Optional[bool], np.ndarray]]]:
    """A multi-label CSV (``image_path``, optional ``train``, one column per
    class) read with the stdlib ``csv`` module as the JAX package reads it
    with pandas: the class columns in file order, and per row in file order
    (image path, train flag, f32 labels). A ``train`` cell may be a bool
    (``True``/``False`` in pandas' spellings) or a number, which selects
    the train split when it equals 1 and the val split when it equals 0
    (pandas' ``== True``/``== False``); a row with any other number is in
    neither split and left out. Without a ``train`` column the flag is None
    (every split takes the row). A cell that does not parse raises, naming
    the file."""
    import csv

    with open(path, newline="") as f:
        reader = csv.reader(f)
        try:
            header = next(reader)
        except StopIteration:
            raise ValueError(f"{path}: the CSV is empty") from None
        if "image_path" not in header:
            raise ValueError(f"{path}: the CSV has no image_path column (columns {header})")
        class_cols = [c for c in header if c not in ("image_path", "train")]
        col = {c: i for i, c in enumerate(header)}
        rows = []
        for line, cells in enumerate(reader, start=2):
            if not cells:
                continue
            if len(cells) != len(header):
                raise ValueError(f"{path}:{line}: {len(cells)} cells, the header has {len(header)}")
            try:
                labels = np.array([float(cells[col[c]]) for c in class_cols], dtype=np.float32)
                train = None
                if "train" in col:
                    cell = cells[col["train"]]
                    if cell in _CSV_TRUE or cell in _CSV_FALSE:
                        train = cell in _CSV_TRUE
                    else:
                        value = float(cell)
                        if value not in (0, 1):
                            continue
                        train = value == 1
            except ValueError as e:
                raise ValueError(f"{path}:{line}: cannot parse the row {cells} ({e})") from None
            rows.append((cells[col["image_path"]], train, labels))
    return class_cols, rows


def smooth_labels(
    label: Union[int, Sequence[int], np.ndarray],
    num_classes: int,
    label_smooth: float,
) -> np.ndarray:
    """Multi-hot vector with smoothing y·(1−α)+α/2 / background α/2
    (reference basedataset.py:197-231)."""
    if isinstance(label, np.ndarray) and label.shape[0] == num_classes:
        if label_smooth > 0:
            return label.astype(np.float32) * (1.0 - label_smooth) + 0.5 * label_smooth
        return label.astype(np.float32)
    vec = np.full((num_classes,), 0.5 * label_smooth, dtype=np.float32)
    if isinstance(label, (int, np.integer)):
        vec[label] = 1.0 - 0.5 * label_smooth
    else:
        idx = np.nonzero(np.asarray(label))[0]
        vec[idx] = 1.0 - 0.5 * label_smooth
    return vec


def _is_hf_root(root: str) -> bool:
    return not (os.path.isdir(root) or str(root).endswith(".csv"))


class ImageDatasets:
    """Train/val dataset over one of three backends.

    ``transforms`` is a callable PIL → ndarray (a compiled augment pipeline or
    a ClassWiseAugmenter). ``label_transforms`` optionally maps raw labels to
    smoothed multi-hot vectors (BCE path).
    """

    def __init__(
        self,
        root: str,
        mode: str,  # "train" | "val"
        transforms: Optional[Callable] = None,
        label_transforms: Optional[Callable] = None,
        project: Optional[str] = None,
        rank_is_primary: bool = True,
        training: bool = True,
    ):
        self.root = str(root)
        self.mode = mode
        self.transforms = transforms
        self.label_transforms = label_transforms
        self.multi_label = False
        self.images: List[Any] = []  # paths or HF indices
        self.labels: List[Any] = []
        self._hf_dataset = None

        if self.root.endswith(".csv"):
            self._init_from_csv()
        elif os.path.isdir(self.root):
            self._init_from_local()
        else:
            self._init_from_huggingface()

        # class_indices.json contract (reference basedataset.py:121-138):
        # written at train time into the run dir, reloaded at eval time.
        if project is not None:
            path = Path(project) / "class_indices.json"
            if training and mode == "train" and rank_is_primary:
                path.parent.mkdir(parents=True, exist_ok=True)
                with open(path, "w") as f:
                    json.dump({str(i): c for i, c in enumerate(self.class_names)}, f, indent=2)
            elif path.is_file():
                with open(path) as f:
                    idx2class = json.load(f)
                self.class_names = [idx2class[str(i)] for i in range(len(idx2class))]

    # ------------------------------------------------------------ backends

    def _init_from_local(self):
        split_dir = Path(self.root) / self.mode
        classes = sorted(
            d for d in os.listdir(split_dir)
            if not (d.startswith(".") or d.startswith("_")) and (split_dir / d).is_dir()
        )
        self.class_names = classes
        for ci, c in enumerate(classes):
            for f in sorted(os.listdir(split_dir / c)):
                if Path(f).suffix.lower() in IMG_EXTENSIONS:
                    self.images.append(str(split_dir / c / f))
                    self.labels.append(ci)

    def _init_from_csv(self):
        class_cols, rows = read_label_csv(self.root)
        self.class_names = class_cols
        self.multi_label = True
        want_train = self.mode == "train"
        for path, train, labels in rows:
            if train is None or train == want_train:
                self.images.append(path)
                self.labels.append(labels)

    def _init_from_huggingface(self):
        from datasets import load_dataset

        split = "train" if self.mode == "train" else "validation"
        try:
            ds = load_dataset(self.root, split=split)
        except ValueError:
            ds = load_dataset(self.root, split="test" if self.mode != "train" else "train")
        self._hf_dataset = ds
        label_feature = ds.features["label"]
        self.class_names = (
            list(label_feature.names) if hasattr(label_feature, "names")
            else sorted(set(ds["label"]))
        )
        self.images = list(range(len(ds)))
        self.labels = list(ds["label"])

    # ------------------------------------------------------------ access

    def __len__(self) -> int:
        return len(self.images)

    def _load(self, index: int) -> Image.Image:
        if self._hf_dataset is not None:
            img = self._hf_dataset[int(self.images[index])]["image"]
            return img.convert("RGB")
        return read_image(self.images[index])

    def __getitem__(self, index: int) -> Tuple[np.ndarray, Any]:
        # Corrupt-image retry with a random substitute (reference :140-161).
        for _ in range(10):
            try:
                img = self._load(index)
                break
            except Exception:
                index = random.randrange(len(self))
        else:
            raise RuntimeError("too many corrupt images")
        label = self.labels[index]
        if self.transforms is not None:
            try:
                img = self.transforms(img, label)  # ClassWiseAugmenter
            except TypeError:
                img = self.transforms(img)
        if self.label_transforms is not None:
            label = self.label_transforms(label)
        return np.asarray(img), label

    # ------------------------------------------------------------ reporting

    def tell_data_distribution(self) -> List[Tuple[str, int]]:
        """(class, count) pairs — the per-class distribution table
        (reference basedataset.py:256-306)."""
        counts: Dict[str, int] = {c: 0 for c in self.class_names}
        for lbl in self.labels:
            if isinstance(lbl, (int, np.integer)):
                counts[self.class_names[int(lbl)]] += 1
            else:
                for i in np.nonzero(np.asarray(lbl))[0]:
                    counts[self.class_names[int(i)]] += 1
        return list(counts.items())


def tell_data_distribution(
    datasets: Dict[str, "ImageDatasets"],
) -> Tuple[List[Tuple[str, Dict[str, int]]], str]:
    """Combined per-class train AND val distribution table (reference
    tell_data_distribution covers both splits, basedataset.py:256-306).

    ``datasets`` maps split name ('train'/'val') → dataset (val may be
    absent/None). Returns (rows sorted by class, rendered text table with a
    totals row).
    """
    splits = [(k, d) for k, d in datasets.items() if d is not None]
    dist: Dict[str, Dict[str, int]] = {}
    for split, ds in splits:
        for cls, n in ds.tell_data_distribution():
            dist.setdefault(cls, {s: 0 for s, _ in splits})[split] += n
    rows = sorted(dist.items())
    headers = ["Class"] + [f"{s.capitalize()} Samples" for s, _ in splits]
    table_rows = [
        [cls] + [str(counts.get(s, 0)) for s, _ in splits] for cls, counts in rows
    ]
    table_rows.append(
        ["total"]
        + [str(sum(c.get(s, 0) for _, c in rows)) for s, _ in splits]
    )
    widths = [
        max(len(headers[i]), *(len(r[i]) for r in table_rows))
        for i in range(len(headers))
    ]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    def fmt(cells):
        return "| " + " | ".join(c.ljust(w) for c, w in zip(cells, widths)) + " |"
    lines = [sep, fmt(headers), sep] + [fmt(r) for r in table_rows] + [sep]
    return rows, "\n".join(lines)


class PredictImageDatasets:
    """Inference dataset over a directory tree, a CSV with an ``image_path``
    column, or one image file: returns (uint8 array, path). A tree is walked
    in sorted order, only the folders named ``target_class`` where one is
    given; ``sampling`` keeps the first that many images."""

    def __init__(
        self,
        root: str,
        transforms: Optional[Callable] = None,
        target_class: Optional[str] = None,
        sampling: Optional[int] = None,
    ):
        self.transforms = transforms
        self.images: List[str] = []
        root = str(root)
        if os.path.isdir(root):
            for dirpath, _, files in sorted(os.walk(root)):
                if target_class is not None and Path(dirpath).name != target_class:
                    continue
                for f in sorted(files):
                    if Path(f).suffix.lower() in IMG_EXTENSIONS:
                        self.images.append(os.path.join(dirpath, f))
        elif root.endswith(".csv"):
            with open(root, newline="", encoding="utf-8") as f:
                self.images = [row["image_path"] for row in csv.DictReader(f)]
        elif os.path.isfile(root):
            self.images = [root]
        else:
            raise ValueError(f"cannot build prediction dataset from {root!r}")
        if sampling is not None:
            self.images = self.images[:sampling]

    def __len__(self):
        return len(self.images)

    def __getitem__(self, index: int) -> Tuple[np.ndarray, str]:
        # the next readable image where one is corrupt
        for off in range(len(self)):
            path = self.images[(index + off) % len(self)]
            try:
                img = read_image(path)
                break
            except Exception:
                continue
        else:
            raise RuntimeError("no readable images")
        if self.transforms is not None:
            img = self.transforms(img)
        return np.asarray(img), path


class EmbeddingDistillDataset:
    """(image, teacher-feature .npy) pairs for embedding distillation, with
    an optional exclude list (the JAX package's). Yields (uint8 array, f32
    feature vector)."""

    def __init__(
        self,
        image_dir: str,
        feat_dir: str,
        transforms: Optional[Callable] = None,
        exclude: Optional[str] = None,
        postfix: str = "jpg",
    ):
        self.transforms = transforms
        self.images: List[str] = []
        self.features: List[str] = []

        excluded = set()
        if exclude is not None:
            with open(exclude) as f:
                excluded = {line.strip() for line in f if line.strip()}

        with os.scandir(image_dir) as it:
            entries = sorted(e.path for e in it if e.is_file() and e.name.endswith(f".{postfix}"))
        for img_path in entries:
            feat_path = os.path.join(feat_dir, f"{Path(img_path).stem}.npy")
            if os.path.isfile(feat_path) and feat_path not in excluded:
                self.images.append(img_path)
                self.features.append(feat_path)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        img = read_image(self.images[index])
        if self.transforms is not None:
            img = self.transforms(img)
        return np.asarray(img), np.load(self.features[index]).astype(np.float32)


class CBIRDatasets:
    """Query/gallery pair (reference basedataset.py:463-596).

    Local layout: root/query/<id>/*, root/gallery/<id>/*; query ids must be a
    subset of gallery ids (:590-593). HF layout: splits named query/gallery
    with a ``class_name``-like column. ``build()`` returns (query, gallery).
    """

    def __init__(self, images: List[Any], ids: List[str], hf_dataset=None, transforms=None):
        self.images = images
        self.ids = ids
        self._hf_dataset = hf_dataset
        self.transforms = transforms

    @classmethod
    def build(cls, root: str, transforms=None) -> Tuple["CBIRDatasets", "CBIRDatasets"]:
        root = str(root)
        if os.path.isdir(root):
            def scan(split):
                images, ids = [], []
                base = Path(root) / split
                for cid in sorted(os.listdir(base)):
                    d = base / cid
                    if not d.is_dir() or cid.startswith("."):
                        continue
                    for f in sorted(os.listdir(d)):
                        if Path(f).suffix.lower() in IMG_EXTENSIONS:
                            images.append(str(d / f))
                            ids.append(cid)
                return images, ids

            q_images, q_ids = scan("query")
            g_images, g_ids = scan("gallery")
            if not set(q_ids) <= set(g_ids):
                raise AssertionError("query ids must be a subset of gallery ids")
            return (
                cls(q_images, q_ids, transforms=transforms),
                cls(g_images, g_ids, transforms=transforms),
            )

        from datasets import load_dataset

        q = load_dataset(root, split="query")
        g = load_dataset(root, split="gallery")
        label_col = "class_name" if "class_name" in q.features else "label"
        return (
            cls(list(range(len(q))), [str(x) for x in q[label_col]], hf_dataset=q, transforms=transforms),
            cls(list(range(len(g))), [str(x) for x in g[label_col]], hf_dataset=g, transforms=transforms),
        )

    def __len__(self):
        return len(self.images)

    def __getitem__(self, index: int) -> Tuple[np.ndarray, str]:
        if self._hf_dataset is not None:
            img = self._hf_dataset[int(self.images[index])]["image"].convert("RGB")
        else:
            img = read_image(self.images[index])
        if self.transforms is not None:
            img = self.transforms(img)
        return np.asarray(img), self.ids[index]

    def positives_for(self, query_id: str) -> List[int]:
        return [i for i, gid in enumerate(self.ids) if gid == query_id]
