"""Classification evaluation (counterpart of ``visiondk_tpu/engine/evaluation.py``):
top-1/top-k overall and per class, multi-label precision/recall/F1 at
per-class thresholds, the confusion matrix. Metrics are reduced on the host
in numpy from the logits the device returns; the validation loss runs
through the port's loss functions on torch tensors.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch


def topk_accuracy(
    logits: np.ndarray, labels: np.ndarray, ks: Sequence[int] = (1, 5)
) -> Dict[int, float]:
    """Mean top-k accuracy; k clipped to #classes."""
    n_class = logits.shape[1]
    order = np.argsort(-logits, axis=1)
    out = {}
    for k in ks:
        kk = min(k, n_class)
        hit = (order[:, :kk] == labels[:, None]).any(axis=1)
        out[k] = float(hit.mean()) if len(hit) else 0.0
    return out


def per_class_topk(
    logits: np.ndarray, labels: np.ndarray, n_class: int, ks: Sequence[int] = (1, 5)
) -> List[Dict[str, Any]]:
    order = np.argsort(-logits, axis=1)
    rows = []
    for c in range(n_class):
        m = labels == c
        row: Dict[str, Any] = {"class": c, "nums": int(m.sum())}
        for k in ks:
            kk = min(k, n_class)
            row[f"top{k}"] = (
                float((order[m, :kk] == c).any(axis=1).mean()) if m.any() else 0.0
            )
        rows.append(row)
    return rows


def confusion_matrix(logits: np.ndarray, labels: np.ndarray, n_class: int) -> np.ndarray:
    pred = logits.argmax(axis=1)
    cm = np.zeros((n_class, n_class), dtype=np.int64)
    np.add.at(cm, (labels, pred), 1)
    return cm


def multilabel_prf1(
    probs: np.ndarray,
    targets: np.ndarray,
    thresh: Union[float, Sequence[float]],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-class precision/recall/F1 at scalar or per-class thresholds
    (reference evaluation.py:142-149 via torchmetrics)."""
    n_class = probs.shape[1]
    t = np.full((n_class,), thresh, np.float32) if np.isscalar(thresh) else np.asarray(thresh, np.float32)
    pred = probs >= t[None, :]
    pos = targets >= 0.5
    tp = (pred & pos).sum(axis=0).astype(np.float64)
    fp = (pred & ~pos).sum(axis=0).astype(np.float64)
    fn = (~pred & pos).sum(axis=0).astype(np.float64)
    precision = np.divide(tp, tp + fp, out=np.zeros(n_class), where=(tp + fp) > 0)
    recall = np.divide(tp, tp + fn, out=np.zeros(n_class), where=(tp + fn) > 0)
    f1 = np.divide(
        2 * precision * recall, precision + recall,
        out=np.zeros(n_class), where=(precision + recall) > 0,
    )
    return precision, recall, f1


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def valuate(
    eval_step: Callable,
    loader,
    num_classes: int,
    thresh: Union[float, Sequence[float], None] = None,
    lossfn: Optional[Callable] = None,
    class_names: Optional[Sequence[str]] = None,
    logger=None,
    conm_path=None,
    eval_topk: int = 5,
) -> Dict[str, Any]:
    """Run evaluation over a loader. ``eval_step(batch)`` serves the module
    it was built on (the EMA module for the trainer's validation) and
    returns f32 logits; rows past a padded batch's ``valid`` count are
    dropped. ``thresh`` falsy → single-label (top-1 / top-k); else
    multi-label P/R/F1. Returns a metrics dict incl. ``fitness`` (top1 or
    mean F1) and, with ``lossfn``, ``v_loss``.
    """
    all_logits, all_labels = [], []
    for batch in loader:
        valid = int(batch.get("valid", batch["image"].shape[0]))
        image = batch["image"]
        logits = eval_step({"image": torch.from_numpy(image) if isinstance(image, np.ndarray) else image})
        all_logits.append(logits[:valid].float().cpu().numpy())
        all_labels.append(np.asarray(batch["label"])[:valid])
    logits = np.concatenate(all_logits) if all_logits else np.zeros((0, num_classes))
    labels = np.concatenate(all_labels) if all_labels else np.zeros((0,), np.int64)

    metrics: Dict[str, Any] = {}
    if not thresh:  # single-label
        labels = labels.astype(np.int64)
        accs = topk_accuracy(logits, labels, ks=(1, eval_topk))
        metrics["top1"] = accs[1]
        metrics[f"top{eval_topk}"] = accs[eval_topk]
        metrics["per_class"] = per_class_topk(logits, labels, num_classes, ks=(1, eval_topk))
        metrics["fitness"] = accs[1]
        if lossfn is not None and len(labels):
            metrics["v_loss"] = float(lossfn(torch.from_numpy(logits), torch.from_numpy(labels)))
        if conm_path is not None and num_classes <= 10:
            from visiondk_tpu_torch.utils.plots import plot_confusion_matrix

            cm = confusion_matrix(logits, labels, num_classes)
            names = class_names or [str(i) for i in range(num_classes)]
            metrics["conm_path"] = str(plot_confusion_matrix(cm, names, conm_path))
    else:  # multi-label
        probs = _sigmoid(logits)
        targets = labels.astype(np.float32)
        precision, recall, f1 = multilabel_prf1(probs, targets, thresh)
        metrics["precision"] = float(precision.mean())
        metrics["recall"] = float(recall.mean())
        metrics["f1score"] = float(f1.mean())
        metrics["per_class"] = [
            {
                "class": c,
                "precision": float(precision[c]),
                "recall": float(recall[c]),
                "f1score": float(f1[c]),
            }
            for c in range(num_classes)
        ]
        metrics["fitness"] = metrics["f1score"]
        if lossfn is not None and len(targets):
            metrics["v_loss"] = float(lossfn(torch.from_numpy(logits), torch.from_numpy(targets)))

    if logger is not None:
        logger.log({k: v for k, v in metrics.items() if k != "per_class"})
    return metrics
