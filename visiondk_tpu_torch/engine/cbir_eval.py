"""CBIR retrieval evaluation: metrics and the end-to-end ``valuate``
(counterpart of ``visiondk_tpu/engine/cbir_eval.py``, whose numpy metric
code this is).

``CBIRMetrics`` (MRR/Recall/Precision@k, AUC, nDCG) in numpy, with exact
equivalents of sklearn's ``roc_auc_score`` and ``ndcg_score``; the memmap
gallery-embedding cache; and ``valuate``: embed the query and gallery sets
with the port's embed step, exact top-k inner-product search
(``ops/retrieval.py``, the reference's faiss Flat index) and the metrics.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from visiondk_tpu_torch.data.loader import DataLoader, NativeEvalLoader
from visiondk_tpu_torch.data import native
from visiondk_tpu_torch.data.transforms import is_plain_letterbox
from visiondk_tpu_torch.engine.face_eval import embed_batch
from visiondk_tpu_torch.ops import retrieval

# --------------------------------------------------------------- metric math


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Exact AUC via the rank-sum formulation (ties get average rank) —
    matches sklearn.roc_auc_score."""
    labels = np.asarray(labels).astype(bool).ravel()
    scores = np.asarray(scores, np.float64).ravel()
    n_pos, n_neg = labels.sum(), (~labels).sum()
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores)
    ranks = np.empty(len(scores), np.float64)
    sorted_scores = scores[order]
    i = 0
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i : j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    return float((ranks[labels].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def ndcg_at_k(rel: np.ndarray, scores: np.ndarray, k: int) -> float:
    """Mean nDCG@k over queries, matching sklearn.ndcg_score semantics
    (rel = graded relevance per ranked item, ranking induced by scores)."""
    rel = np.asarray(rel, np.float64)
    scores = np.asarray(scores, np.float64)
    n, m = rel.shape
    kk = min(k, m)
    discounts = 1.0 / np.log2(np.arange(2, kk + 2))
    out = []
    for i in range(n):
        order = np.argsort(-scores[i], kind="stable")
        dcg = (rel[i, order[:kk]] * discounts).sum()
        ideal = np.sort(rel[i])[::-1][:kk]
        idcg = (ideal * discounts[: len(ideal)]).sum()
        out.append(dcg / idcg if idcg > 0 else 0.0)
    return float(np.mean(out))


class CBIRMetrics:
    """Reference CBIRMetrics parity (cbir/evaluation.py:14-103).

    preds/labels are lists of gallery *keys* (image names) per query;
    preds_scores are the similarity scores for the ranked preds.
    """

    def __init__(self, cutoffs: Sequence[int] = (1, 10, 100)):
        self.cutoffs = list(cutoffs)
        self.metrics: Dict[str, float] = {}

    def compute_mrr(self, preds, labels):
        mrrs = np.zeros(len(self.cutoffs))
        for pred, label in zip(preds, labels):
            label_set = set(label)
            for i, x in enumerate(pred, 1):
                if x in label_set:
                    for k, cutoff in enumerate(self.cutoffs):
                        if i <= cutoff:
                            mrrs[k] += 1.0 / i
                    break
        mrrs /= max(len(preds), 1)
        for i, cutoff in enumerate(self.cutoffs):
            self.metrics[f"MRR@{cutoff}"] = float(mrrs[i])

    def compute_recall(self, preds, labels):
        recalls = np.zeros(len(self.cutoffs))
        for pred, label in zip(preds, labels):
            for k, cutoff in enumerate(self.cutoffs):
                inter = np.intersect1d(label, pred[:cutoff])
                recalls[k] += len(inter) / max(len(label), 1)
        recalls /= max(len(preds), 1)
        for i, cutoff in enumerate(self.cutoffs):
            self.metrics[f"Recall@{cutoff}"] = float(recalls[i])

    def compute_precision(self, preds, labels):
        precisions = np.zeros(len(self.cutoffs))
        for pred, label in zip(preds, labels):
            for k, cutoff in enumerate(self.cutoffs):
                inter = np.intersect1d(label, pred[:cutoff])
                precisions[k] += len(inter) / min(cutoff, max(len(label), 1))
        precisions /= max(len(preds), 1)
        for i, cutoff in enumerate(self.cutoffs):
            self.metrics[f"Precision@{cutoff}"] = float(precisions[i])

    @staticmethod
    def encode_pred2hard(preds, labels) -> List[List[int]]:
        return [np.isin(pred, label).astype(int).tolist() for pred, label in zip(preds, labels)]

    def compute_auc(self, preds, labels, preds_scores):
        hard = np.asarray(self.encode_pred2hard(preds, labels)).ravel()
        self.metrics[f"AUC@{self.cutoffs[-1]}"] = roc_auc(hard, np.asarray(preds_scores).ravel())

    def compute_ndcg(self, preds, labels, preds_scores):
        hard = np.asarray(self.encode_pred2hard(preds, labels), np.float64)
        for cutoff in self.cutoffs:
            self.metrics[f"nDCG@{cutoff}"] = ndcg_at_k(hard, np.asarray(preds_scores), cutoff)

    def reset(self):
        self.metrics.clear()


# ----------------------------------------------------------- embedding cache


def save_embedding_cache(path: str, embeddings: np.ndarray) -> None:
    """Memmap save of gallery embeddings (reference cbir/evaluation.py:135-151)
    with a sidecar meta file recording shape/dtype for self-describing load."""
    mm = np.memmap(path, shape=embeddings.shape, mode="w+", dtype=embeddings.dtype)
    step = 10000
    for i in range(0, embeddings.shape[0], step):
        mm[i : i + step] = embeddings[i : i + step]
    mm.flush()
    with open(path + ".meta.json", "w") as f:
        json.dump({"shape": list(embeddings.shape), "dtype": str(embeddings.dtype)}, f)


def load_embedding_cache(path: str, expected_rows: Optional[int] = None):
    """Read-only memmap of a cached gallery; None when absent or stale
    (row count no longer matches the dataset — safer than the reference's
    unchecked reshape, cbir/evaluation.py:124-129)."""
    if not (os.path.exists(path) and os.path.exists(path + ".meta.json")):
        return None
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    shape = tuple(meta["shape"])
    if expected_rows is not None and shape[0] != expected_rows:
        return None
    return np.memmap(path, mode="r", dtype=np.dtype(meta["dtype"])).reshape(shape)


# ------------------------------------------------------------------ valuate


def _extract(embed_step: Callable, dataset, batch_size: int):
    """Embed a CBIRDatasets split → (embeddings [N, D] f32, keys list). Local
    files under a plain letterbox pipeline take the C++ decode pool
    (``NativeEvalLoader``) where it loads, the PIL ``DataLoader`` otherwise."""
    loader = None
    images = getattr(dataset, "images", None)
    if (
        native.native_available()
        and images
        and isinstance(images[0], str)
        and getattr(dataset, "_hf_dataset", None) is None
    ):
        size = is_plain_letterbox(getattr(dataset, "transforms", None))
        if size is not None:
            loader = NativeEvalLoader(images, dataset.ids, size, batch_size, threads=8)

    if loader is None:
        def collate(samples):
            imgs, keys = zip(*samples)
            return {"image": np.stack([np.asarray(i) for i in imgs]), "keys": list(keys)}

        loader = DataLoader(
            dataset, batch_size=batch_size, shuffle=False, drop_last=False,
            num_workers=8, collate=collate,
        )
    feats_all, keys_all = [], []
    for batch in loader:
        feats = embed_batch(embed_step, batch)
        feats_all.append(feats)
        keys_all.extend(batch["keys"][: len(feats)])
    return np.concatenate(feats_all), keys_all


def valuate(
    embed_step: Callable,
    query_dataset,
    gallery_dataset,
    batch_size: int = 128,
    metrics: Sequence[str] = ("mrr", "recall", "precision", "auc", "ndcg"),
    cutoffs: Sequence[int] = (1, 3, 5),
    vis: bool = False,
    gallery_cache: Optional[str] = None,
    recall_target: Optional[float] = None,
    device="cuda",
    mesh=None,
) -> Dict[str, Any]:
    """End-to-end CBIR eval (reference cbir/evaluation.py:226-291): embed
    query + gallery with ``embed_step`` (the port's, on the module to serve)
    → top-k IP search on ``device`` (exact, or approximate at
    ``recall_target``; the gallery sharded over ``mesh``'s data ranks where it
    has more than one, ``ops/retrieval.py``) → metrics. ``vis=True`` also
    returns the raw results for visualisation.

    ``gallery_cache``: memmap path for the gallery embeddings, loaded when
    present and row-consistent, written after extraction otherwise."""
    q_emb, q_ids = _extract(embed_step, query_dataset, batch_size)
    g_emb = (
        load_embedding_cache(gallery_cache, expected_rows=len(gallery_dataset.images))
        if gallery_cache
        else None
    )
    if g_emb is None:
        g_emb, _ = _extract(embed_step, gallery_dataset, batch_size)
        if gallery_cache:
            save_embedding_cache(gallery_cache, g_emb)
    gallery_names = (
        gallery_dataset.images
        if not isinstance(gallery_dataset.images[0], int)
        else [str(i) for i in gallery_dataset.images]
    )

    k = max(cutoffs)
    scores, idx = retrieval.search(q_emb, g_emb, k=k, recall_target=recall_target, device=device, mesh=mesh)

    preds = [[gallery_names[j] for j in row] for row in idx]
    # ground truth: gallery items sharing the query's id
    id2names: Dict[str, List[str]] = {}
    for name, gid in zip(gallery_names, gallery_dataset.ids):
        id2names.setdefault(gid, []).append(name)
    labels = [id2names.get(qid, []) for qid in q_ids]

    m = CBIRMetrics(cutoffs=list(cutoffs))
    if "mrr" in metrics:
        m.compute_mrr(preds, labels)
    if "recall" in metrics:
        m.compute_recall(preds, labels)
    if "precision" in metrics:
        m.compute_precision(preds, labels)
    if "auc" in metrics:
        m.compute_auc(preds, labels, scores)
    if "ndcg" in metrics:
        m.compute_ndcg(preds, labels, scores)

    out = dict(m.metrics)
    if vis:
        out["_raw"] = {
            "query_ids": q_ids,
            "query_images": query_dataset.images,
            "preds": preds,
            "pred_indices": idx,
            "scores": scores,
            "labels": labels,
            "gallery_images": gallery_dataset.images,
        }
    return out
