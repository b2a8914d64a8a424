"""Exact inner-product top-k retrieval (counterpart of ``visiondk_tpu/ops/retrieval.py``).

Flat IP search is a matrix product and a top-k, as in the JAX package:

- scores = queries · galleryᵀ from inputs rounded to ``compute_dtype`` (bf16
  by default), multiplied and summed in float64 and rounded to f32: the JAX
  op's ``dot_general(bf16, bf16, preferred_element_type=f32)`` gives f32
  sums of exact bf16 products (a bf16 × bf16 ``torch.matmul`` would return
  bf16 scores and merge near-ties, and an f32 one would use TF32 wherever
  the caller allows it; no setting reaches a float64 product);
- the top k per query, ordered by score and, among equal scores, by the
  lower gallery index (``jax.lax.top_k`` and faiss Flat order them so;
  ``torch.topk``'s order among equal values is not specified).

``search`` runs chunks of queries against the whole gallery on one device.
``recall_target`` (the JAX package's ``approx_max_k``) has no PyTorch
counterpart and raises; the sharded gallery merge belongs to distributed
evaluation, which is not ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def require_exact(recall_target: Optional[float]) -> None:
    """Raise for a ``recall_target``: approximate search is not ported."""
    if recall_target is not None:
        raise NotImplementedError(
            "recall_target (approximate top-k, the JAX package's lax.approx_max_k) has no PyTorch "
            "counterpart and is not ported; omit it for exact search"
        )


def _rank_key(sim: torch.Tensor) -> torch.Tensor:
    """int64 keys whose descending order is (score descending, index
    ascending): the f32 score's bits made order-preserving, above the
    reversed index."""
    bits = sim.contiguous().view(torch.int32)
    ordered = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int64)
    index = torch.arange(sim.shape[1], device=sim.device, dtype=torch.int64)
    return ordered * (1 << 32) + ((1 << 32) - 1 - index)


def topk_lower_index(sim: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` of each row of f32 ``sim`` [Q, G]: (scores, indices), by
    score descending and, among equal scores, index ascending.
    ``torch.topk`` picks the k values; where a tie straddles the k-th place
    (more equal scores in the row than it kept) the row is ranked again by
    exact keys (``_rank_key``); then the k are ordered by (−score, index)."""
    vals, idx = torch.topk(sim, k, dim=1)
    kth = vals[:, -1:]
    straddles = (sim == kth).sum(dim=1) != (vals == kth).sum(dim=1)
    rows = straddles.nonzero().squeeze(1)
    if rows.numel():
        sub = sim.index_select(0, rows)
        _, sub_idx = torch.topk(_rank_key(sub), k, dim=1)
        idx[rows] = sub_idx
        vals[rows] = sub.gather(1, sub_idx)
    by_index = torch.argsort(idx, dim=1)
    idx, vals = idx.gather(1, by_index), vals.gather(1, by_index)
    by_score = torch.argsort(vals, dim=1, descending=True, stable=True)
    return vals.gather(1, by_score), idx.gather(1, by_score)


def _rounded(x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``compute_dtype``, held in float64 for the product."""
    return x.to(compute_dtype).to(torch.float64)


def scores(queries: torch.Tensor, gallery: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """f32 [Q, G] inner products of the inputs rounded to ``compute_dtype``."""
    return (_rounded(queries, compute_dtype) @ _rounded(gallery, compute_dtype).transpose(0, 1)).to(torch.float32)


def topk_ip(
    queries: torch.Tensor,
    gallery: torch.Tensor,
    k: int,
    compute_dtype: torch.dtype = torch.bfloat16,
    recall_target: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact IP top-k on one device: [Q, D] × [G, D] → (scores f32 [Q, k],
    indices int64 [Q, k]). ``k`` must not exceed G."""
    require_exact(recall_target)
    return topk_lower_index(scores(queries, gallery, compute_dtype), k)


def search(
    queries: np.ndarray,
    gallery: np.ndarray,
    k: int,
    query_chunk: int = 1024,
    compute_dtype: torch.dtype = torch.bfloat16,
    recall_target: Optional[float] = None,
    device: torch.device | str = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-facing exact top-k search: numpy arrays in, numpy (scores f32
    [Q, k], indices int64 [Q, k]) out, ``k`` clamped to the
    gallery size. The gallery moves to ``device`` once (the card unless the
    caller asks for the CPU) and the queries go through ``topk_ip`` in
    chunks of ``query_chunk`` rows."""
    require_exact(recall_target)
    device = torch.device(device)
    gallery = torch.tensor(np.asarray(gallery), device=device)  # a copy: the gallery may be a read-only memmap
    n_q = len(queries)
    k = min(k, gallery.shape[0])
    scores_out = np.empty((n_q, k), np.float32)
    idx_out = np.empty((n_q, k), np.int64)
    for start in range(0, n_q, max(query_chunk, 1)):
        q = torch.tensor(np.asarray(queries[start:start + query_chunk]), device=device)
        s, i = topk_ip(q, gallery, k, compute_dtype)
        scores_out[start:start + len(q)] = s.cpu().numpy()
        idx_out[start:start + len(q)] = i.cpu().numpy()
    return scores_out, idx_out
