"""Face pair verification: LFW-protocol 10-fold cross-validation
(counterpart of ``visiondk_tpu/engine/face_eval.py``, whose numpy code this
is).

Parse ``pair_txt``, embed the unique pair images (L2-normalised, from the
port's embed step), split the pairs into 10 folds, pick the best ROC
threshold (argmax tpr − fpr over 1000 thresholds) on nine and score the
held-out one; report mean ± SEM.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from visiondk_tpu_torch.data.datasets import read_image
from visiondk_tpu_torch.data.loader import DataLoader


def process_pair_txt(pair_txt: str, imgdir: str) -> Tuple[List[str], List[str], List[List[str]]]:
    """Returns (unique pair-file names, their full paths under <imgdir>/val,
    pair rows [name1, name2, label]) — names and paths index-aligned."""
    assert os.path.isfile(pair_txt), f"pair file not found: {pair_txt}"
    pair_array = np.loadtxt(pair_txt, dtype=str)
    unique = np.unique(pair_array[:, :2].flatten()).tolist()
    unique_paths = [os.path.join(imgdir, "val", p) for p in unique]
    return unique, unique_paths, pair_array.tolist()


def best_threshold(scores: np.ndarray, labels: np.ndarray, num_thresholds: int = 1000) -> float:
    """argmax(tpr − fpr) over a uniform threshold sweep (reference :84-113)."""
    pos = scores[labels == 1]
    neg = scores[labels == 0]
    lo, hi = scores.min(), scores.max()
    step = (hi - lo) / num_thresholds
    ts = lo + step * np.arange(1, num_thresholds + 1)
    fpr = (neg[None, :] > ts[:, None]).mean(axis=1)
    tpr = (pos[None, :] > ts[:, None]).mean(axis=1)
    return float(ts[np.argmax(tpr - fpr)])


def ten_fold_accuracy(
    pair_list: Sequence[Sequence], name2feat: Dict[str, np.ndarray]
) -> Tuple[float, float]:
    """mean ± SEM over 10 folds (reference test_one_model, :34-82)."""
    nps = len(pair_list)
    assert nps % 10 == 0, "number of pairs must be a multiple of 10"
    per = nps // 10
    scores = np.zeros((10, per), np.float32)
    labels = np.zeros((10, per), np.int8)
    for i, pair in enumerate(pair_list):
        f1 = name2feat[os.path.normpath(str(pair[0]))]
        f2 = name2feat[os.path.normpath(str(pair[1]))]
        scores[i // per, i % per] = float(np.dot(f1, f2))
        labels[i // per, i % per] = int(pair[2])

    accs = []
    for k in range(10):
        train_mask = np.ones(10, bool)
        train_mask[k] = False
        thr = best_threshold(scores[train_mask].ravel(), labels[train_mask].ravel())
        ts, tl = scores[k], labels[k]
        correct = int((ts[tl == 1] > thr).sum() + (ts[tl == 0] < thr).sum())
        accs.append(correct / per)
    mean = float(np.mean(accs))
    sem = float(np.std(accs, ddof=1) / np.sqrt(10))
    return mean, sem


def embed_batch(embed_step: Callable, batch: Dict) -> np.ndarray:
    """The embeddings of a loader batch's real rows (a padded last batch
    carries its real row count in ``'valid'``), as f32 numpy."""
    valid = int(batch.get("valid", batch["image"].shape[0]))
    image = batch["image"]
    feats = embed_step({"image": torch.from_numpy(image) if isinstance(image, np.ndarray) else image})
    return feats[:valid].cpu().numpy()


def extract_embeddings(embed_step: Callable, loader, names: Sequence[str]) -> Dict[str, np.ndarray]:
    """name → normalised embedding, in ``names``' order over the loader's
    batches (FeatureExtractor.extract_face, models/faceX/face_model.py:93-118)."""
    out: Dict[str, np.ndarray] = {}
    it = iter(names)
    for batch in loader:
        for f in embed_batch(embed_step, batch):
            out[os.path.normpath(next(it))] = f
    return out


class _PathDataset:
    def __init__(self, paths: Sequence[str], transforms):
        self.paths = paths
        self.transforms = transforms

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i):
        img = read_image(self.paths[i])
        if self.transforms is not None:
            img = self.transforms(img)
        return np.asarray(img), 0


def valuate(
    embed_step: Callable,
    pair_txt: str,
    imgdir: str,
    transforms,
    batch_size: int = 32,
) -> Tuple[float, float]:
    """Full face eval: a loader over the unique pair images → embed → 10-fold
    accuracy (reference faceX/evaluation.py:120-140). ``embed_step`` is the
    port's (``make_embed_step`` on the module to serve)."""
    unique_names, unique_paths, pair_list = process_pair_txt(pair_txt, imgdir)
    loader = DataLoader(
        _PathDataset(unique_paths, transforms), batch_size=batch_size, shuffle=False,
        drop_last=False, num_workers=8,
    )
    name2feat = extract_embeddings(embed_step, loader, unique_names)
    return ten_fold_accuracy(pair_list, name2feat)
