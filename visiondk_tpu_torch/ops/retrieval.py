"""Inner-product top-k retrieval (counterpart of ``visiondk_tpu/ops/retrieval.py``).

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

``recall_target`` = r takes the approximate top-k of the JAX package's
``jax.lax.approx_max_k`` as the TPU computes it: each row's G scores are
reduced to the maxima of M bins (``approx_reduction_size``, XLA's formula:
M = (1 − k) / ln r bins make r the expected share of the true top k that no
other of them shares a bin with), and the top k of those maxima are
returned, with their true scores. Column j falls in bin j mod M, so a
gallery sorted by identity spreads over the bins. XLA's CPU and GPU backends
run ``approx_max_k`` exactly; the port keeps the TPU's reduction on every
device, so the flag means on the card what it means on the TPU.

``search`` runs chunks of queries on one device, or, with a ``MeshContext``
of more than one data shard (``mesh.n_data``: the ranks that do not share a
class shard), splits the gallery into one contiguous shard a data rank:
each rank takes its shard's (exact or approximate) top k, the ranks gather
the candidates over their data group, and every rank merges them into the
same exact top k (the lower global index first among equal scores).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

APPROX_TILING = 128  # XLA's reduction tiling for a rank-2 operand: M is a multiple of it


def approx_reduction_size(g: int, k: int, recall_target: float) -> int:
    """The number of bins M that ``approx_max_k`` reduces a row of ``g``
    scores to for the top ``k`` at ``recall_target`` (XLA's
    ``ApproxTopKReductionOutputSize`` for a rank-2 operand, which JAX's
    ``aggregate_to_topk=False`` returns): ``g`` itself where it fits one
    tile, at ``recall_target`` 1.0 or where the bins would not halve it;
    otherwise a multiple of 128 no smaller than k. Bins hold 2^l columns
    each, l = ⌊log2(g / m)⌋ for m = max((1 − k) / ln r, 128) columns; at
    k = 1 the row reduces to one tile (a bin's maximum holds the row's)."""
    if g <= APPROX_TILING:
        return g
    if k == 1:
        return APPROX_TILING
    if recall_target >= 1.0:
        return g
    m = min(max(int((1.0 - k) / math.log(recall_target)), APPROX_TILING), g)
    tiles = -(-g // APPROX_TILING)
    for log2_bins in range((g // m).bit_length() - 1, 0, -1):
        size = APPROX_TILING * -(-tiles // (1 << log2_bins))
        if size >= k:
            return size
    return g


def _rank_key(sim: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """int64 keys whose descending order is (score descending, index
    ascending): the f32 score's bits made order-preserving, above the
    reversed index (< 2³²)."""
    bits = sim.contiguous().view(torch.int32)
    ordered = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int64)
    return ordered * (1 << 32) + ((1 << 32) - 1 - index)


def topk_lower_index(sim: torch.Tensor, k: int, index: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` of each row of f32 ``sim`` [Q, G]: (scores, indices), by
    score descending and, among equal scores, index ascending. A column's
    index is its position, or its entry in ``index`` (int64 [Q, G]) where
    given. ``torch.topk`` picks the k values; where a tie straddles the k-th
    place (more equal scores in the row than it kept) the row is ranked again
    by exact keys (``_rank_key``); then the k are ordered by (−score, index)."""
    vals, pos = torch.topk(sim, k, dim=1)
    if index is None:
        index = torch.arange(sim.shape[1], device=sim.device, dtype=torch.int64).expand_as(sim)
    idx = index.gather(1, pos)
    kth = vals[:, -1:]
    straddles = (sim == kth).sum(dim=1) != (vals == kth).sum(dim=1)
    rows = straddles.nonzero().squeeze(1)
    if rows.numel():
        sub, sub_index = sim.index_select(0, rows), index.index_select(0, rows)
        _, sub_pos = torch.topk(_rank_key(sub, sub_index), k, dim=1)
        idx[rows] = sub_index.gather(1, sub_pos)
        vals[rows] = sub.gather(1, sub_pos)
    by_index = torch.argsort(idx, dim=1)
    idx, vals = idx.gather(1, by_index), vals.gather(1, by_index)
    by_score = torch.argsort(vals, dim=1, descending=True, stable=True)
    return vals.gather(1, by_score), idx.gather(1, by_score)


def approx_topk(sim: torch.Tensor, k: int, recall_target: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The approximate top ``k`` of each row of f32 ``sim`` [Q, G] at
    ``recall_target`` (see the module doc): ``sim`` padded with −∞ to M·2^l
    columns, column j in bin j mod M, each bin's maximum (the lower index
    among equal scores), then ``topk_lower_index`` of the M maxima by their
    gallery indices. Exact where M = G."""
    g = sim.shape[1]
    bins = approx_reduction_size(g, k, recall_target)
    if bins >= g:
        return topk_lower_index(sim, k)
    per_bin = -(-g // bins)
    padded = torch.nn.functional.pad(sim, (0, bins * per_bin - g), value=-math.inf)
    best, row = padded.view(sim.shape[0], per_bin, bins).max(dim=1)  # the first maximum: the lower index
    index = row * bins + torch.arange(bins, device=sim.device)
    return topk_lower_index(best, k, index)


def _rounded(x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``compute_dtype``, held in float64 for the product."""
    return x.to(compute_dtype).to(torch.float64)


def scores(queries: torch.Tensor, gallery: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """f32 [Q, G] inner products of the inputs rounded to ``compute_dtype``."""
    return (_rounded(queries, compute_dtype) @ _rounded(gallery, compute_dtype).transpose(0, 1)).to(torch.float32)


def _select(sim: torch.Tensor, k: int, recall_target: Optional[float]) -> Tuple[torch.Tensor, torch.Tensor]:
    return topk_lower_index(sim, k) if recall_target is None else approx_topk(sim, k, recall_target)


def topk_ip(
    queries: torch.Tensor,
    gallery: torch.Tensor,
    k: int,
    compute_dtype: torch.dtype = torch.bfloat16,
    recall_target: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """IP top-k on one device: [Q, D] × [G, D] → (scores f32 [Q, k],
    indices int64 [Q, k]), exact, or approximate at ``recall_target``.
    ``k`` must not exceed G."""
    return _select(scores(queries, gallery, compute_dtype), k, recall_target)


def pad_gallery(gallery: np.ndarray, multiple: int) -> Tuple[np.ndarray, int]:
    """The gallery with zero rows appended up to a multiple of ``multiple``
    (the shard count), and its real row count. The sharded search masks the
    pad rows' scores to −∞: a zero score would outrank a real negative one."""
    g = gallery.shape[0]
    padded = -(-g // multiple) * multiple
    if padded == g:
        return gallery, g
    return np.concatenate([gallery, np.zeros((padded - g, gallery.shape[1]), gallery.dtype)]), g


def sharded_topk_ip(queries: torch.Tensor, shard: torch.Tensor, k: int, mesh, offset: int, real_g: int,
                    compute_dtype: torch.dtype = torch.bfloat16, recall_target: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This data rank's part of a sharded search (the JAX
    ``make_sharded_search``): the scores against its gallery ``shard``
    (global rows from ``offset``), the columns of pad rows (global row ≥
    ``real_g``) at −∞ before its own top ``min(k, shard rows)``, then the
    candidates of every data rank gathered in rank order and merged into the
    exact top ``k``, the lower global index first among equal scores."""
    sim = scores(queries, shard, compute_dtype)
    if offset + shard.shape[0] > real_g:
        sim[:, max(real_g - offset, 0):] = -math.inf
    local_scores, local_idx = _select(sim, min(k, shard.shape[0]), recall_target)
    all_scores = mesh.data_gather(local_scores)  # [n_data, Q, k_local]
    all_idx = mesh.data_gather(local_idx + offset)
    q = queries.shape[0]
    return topk_lower_index(all_scores.permute(1, 0, 2).reshape(q, -1), k,
                            all_idx.permute(1, 0, 2).reshape(q, -1))


def search(
    queries: np.ndarray,
    gallery: np.ndarray,
    k: int,
    query_chunk: int = 1024,
    compute_dtype: torch.dtype = torch.bfloat16,
    recall_target: Optional[float] = None,
    device: torch.device | str = "cuda",
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-facing top-k search: numpy arrays in, numpy (scores f32 [Q, k],
    indices int64 [Q, k] into the unpadded gallery) out, ``k`` clamped to the
    gallery size. The gallery (or, with a ``mesh`` of more than one data
    shard, this rank's shard of it) moves to ``device`` once (the card unless
    the caller asks for the CPU), and the queries go through ``topk_ip`` (or
    ``sharded_topk_ip``) in chunks of ``query_chunk`` rows. Every rank of a
    mesh passes the same queries and gallery and gets the same answer."""
    device = torch.device(device)
    gallery = np.asarray(gallery)
    k = min(k, gallery.shape[0])
    if mesh is not None and mesh.n_data > 1:
        padded, real_g = pad_gallery(gallery, mesh.n_data)
        rows = padded.shape[0] // mesh.n_data
        offset = mesh.data_index * rows
        shard = torch.tensor(padded[offset:offset + rows], device=device)

        def select(q):
            return sharded_topk_ip(q, shard, k, mesh, offset, real_g, compute_dtype, recall_target)
    else:
        whole = torch.tensor(gallery, device=device)  # a copy: the gallery may be a read-only memmap

        def select(q):
            return topk_ip(q, whole, k, compute_dtype, recall_target)
    n_q = len(queries)
    scores_out = np.empty((n_q, k), np.float32)
    idx_out = np.empty((n_q, k), np.int64)
    for start in range(0, n_q, max(query_chunk, 1)):
        q = torch.tensor(np.asarray(queries[start:start + query_chunk]), device=device)
        s, i = select(q)
        scores_out[start:start + len(q)] = s.cpu().numpy()
        idx_out[start:start + len(q)] = i.cpu().numpy()
    return scores_out, idx_out
