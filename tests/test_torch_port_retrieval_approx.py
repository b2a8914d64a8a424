"""Approximate and sharded retrieval (``visiondk_tpu_torch/ops/retrieval.py``)
against the JAX package's ``visiondk_tpu.ops.retrieval``.

- ``approx_reduction_size`` equals the width of JAX's ``approx_max_k(...,
  aggregate_to_topk=False)`` (XLA's reduction formula) over G ∈ {100, 128,
  1000, 65536, 100003}, k ∈ {1, 10, 100}, r ∈ {0.8, 0.9, 0.95, 0.99, 1.0}
  (traced with ``jax.eval_shape``: nothing compiled);
- where M = G the port's ``search(recall_target=r)`` equals JAX's: indices
  exactly, scores within 1e-6 (``test_torch_port_embedding.py``'s bar: the
  port sums the products in float64, JAX in f32);
- where M < G the port reduces as the TPU does, which XLA's CPU backend does
  not (it runs ``approx_max_k`` exactly): on a 65,536-row gallery the mean
  recall@100 against JAX's (exact) results is at least r − 0.01, and every
  returned score is the true score at its index;
- the sharded search of two gloo ranks (``tests/torch_dist_worker.py``)
  equals the JAX ``make_sharded_search`` on a 2-device mesh on both ranks:
  indices exactly, scores exactly where every product is exact (exact ties
  across the shards) and within 1e-6 elsewhere; a gallery that pads with
  every similarity negative, shards smaller than k, and ``recall_target`` at
  M = G.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tests.torch_dist_worker import Ranks
from visiondk_tpu.ops import retrieval as jax_retrieval
from visiondk_tpu.parallel import build_mesh as jax_build_mesh
from visiondk_tpu_torch.ops import retrieval

GRID_G = (100, 128, 1000, 65536, 100003)
GRID_K = (1, 10, 100)
GRID_R = (0.8, 0.9, 0.95, 0.99, 1.0)
RECALL_SLACK = 0.01
SCORE_ATOL = 1e-6  # f32 sums (JAX) against float64 sums rounded to f32 (the port)


def _jax_width(g, k, r):
    out = jax.eval_shape(lambda x: lax.approx_max_k(x, k, recall_target=r, aggregate_to_topk=False),
                         jax.ShapeDtypeStruct((2, g), jnp.float32))
    return out[0].shape[1]


@pytest.mark.parametrize("g", GRID_G)
def test_reduction_size_is_xlas(g):
    for k in GRID_K:
        for r in GRID_R:
            assert retrieval.approx_reduction_size(g, k, r) == _jax_width(g, k, r), (g, k, r)


def _normal(q, g, d, seed):
    rng = np.random.default_rng(seed)
    queries = rng.normal(size=(q, d)).astype(np.float32)
    gallery = rng.normal(size=(g, d)).astype(np.float32)
    return (queries / np.linalg.norm(queries, axis=1, keepdims=True),
            gallery / np.linalg.norm(gallery, axis=1, keepdims=True))


@pytest.mark.parametrize("g,k,r", [(100, 7, 0.8), (1000, 10, 0.99), (300, 1, 0.9), (2000, 50, 1.0)],
                         ids=["one_tile", "bins_would_not_halve", "k1_one_tile", "recall_1"])
def test_search_equals_jax_where_nothing_is_reduced(g, k, r):
    queries, gallery = _normal(13, g, 24, seed=g)
    bins = retrieval.approx_reduction_size(g, k, r)
    assert bins == g or (k == 1 and bins == retrieval.APPROX_TILING)  # k 1: a bin's maximum is the row's
    ws, wi = jax_retrieval.search(queries, gallery, k=k, query_chunk=8, recall_target=r)
    s, i = retrieval.search(queries, gallery, k=k, query_chunk=8, recall_target=r, device="cpu")
    np.testing.assert_array_equal(i, wi)
    np.testing.assert_allclose(s, ws, rtol=0, atol=SCORE_ATOL)


@pytest.fixture(scope="module")
def gallery_65536():
    queries, gallery = _normal(64, 65536, 32, seed=7)
    exact_s, exact_i = jax_retrieval.search(queries, gallery, k=100)  # approx_max_k on the CPU is exact
    return queries, gallery, exact_i


@pytest.mark.parametrize("r", [0.9, 0.95, 0.99])
def test_recall_on_a_65536_gallery(gallery_65536, r):
    queries, gallery, exact_i = gallery_65536
    _, jax_i = jax_retrieval.search(queries, gallery, k=100, recall_target=r)
    np.testing.assert_array_equal(jax_i, exact_i)
    s, i = retrieval.search(queries, gallery, k=100, recall_target=r, device="cpu")
    recall = np.mean([len(set(a) & set(b)) / 100 for a, b in zip(i, jax_i)])
    assert retrieval.approx_reduction_size(65536, 100, r) < 65536
    assert recall >= r - RECALL_SLACK, recall
    true = retrieval.scores(torch.from_numpy(queries), torch.from_numpy(gallery)).numpy()
    np.testing.assert_array_equal(np.take_along_axis(true, i, axis=1), s)
    assert (np.diff(s, axis=1) <= 0).all()  # by score descending
    assert all(len(set(row)) == 100 for row in i)


# ---------------------------------------------------------------- the sharded merge


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = Ranks(tmp_path_factory.mktemp("search_ranks"))
    yield pool
    pool.close()


def _exact_ties(q, g, d, seed):
    """Entries in {−1, −½, 0, ½, 1}, every gallery row twice (the copies in
    the other shard): exact products, many exact ties across shards."""
    rng = np.random.default_rng(seed)
    queries = rng.integers(-2, 3, size=(q, d)).astype(np.float32) / 2
    gallery = rng.integers(-2, 3, size=(g, d)).astype(np.float32) / 2
    gallery[g // 2:] = gallery[: g - g // 2]
    return queries, gallery


def _negative(q, g, d, seed):
    """Every similarity negative: a zero-scored pad row would outrank them all."""
    rng = np.random.default_rng(seed)
    queries = np.concatenate([3 * np.ones((q, 1)), 0.5 * rng.normal(size=(q, d - 1))], axis=1).astype(np.float32)
    gallery = np.concatenate([-3 * np.ones((g, 1)), 0.5 * rng.normal(size=(g, d - 1))], axis=1).astype(np.float32)
    return (queries / np.linalg.norm(queries, axis=1, keepdims=True),
            gallery / np.linalg.norm(gallery, axis=1, keepdims=True))


SHARDED_CASES = {
    # name: (queries, gallery, k, query chunk, compute dtype, recall target)
    "exact_ties": (*_exact_ties(11, 40, 16, seed=1), 9, 4, "float32", None),
    "exact_ties_bf16": (*_exact_ties(11, 40, 16, seed=2), 6, 11, "bfloat16", None),
    "padded_negative": (*_negative(16, 101, 8, seed=7), 9, 16, "float32", None),
    "shard_below_k": (*_normal(5, 7, 8, seed=3), 6, 5, "float32", None),
    "recall_at_m_equal_g": (*_normal(9, 200, 16, seed=4), 10, 9, "bfloat16", 0.9),
}


@pytest.mark.parametrize("case", list(SHARDED_CASES))
def test_sharded_search_equals_jax_on_two_ranks(ranks, case):
    queries, gallery, k, chunk, dtype, r = SHARDED_CASES[case]
    if case == "padded_negative":
        assert (queries @ gallery.T < 0).all()
    if r is not None:  # each rank's shard fits one tile: nothing is reduced
        assert retrieval.approx_reduction_size(len(gallery) // 2, k, r) == len(gallery) // 2
    mesh = jax_build_mesh(devices=jax.devices()[:2])  # data 2
    ws, wi = jax_retrieval.search(queries, gallery, k=k, mesh=mesh.mesh, query_chunk=chunk,
                                  compute_dtype=getattr(jnp, dtype), recall_target=r)
    results = ranks.run("search", {"queries": queries, "gallery": gallery, "k": k, "chunk": chunk, "dtype": dtype,
                                   "recall_target": r})
    for got in results:
        assert got["idx"].shape == (len(queries), min(k, len(gallery)))
        np.testing.assert_array_equal(got["idx"], wi)
        np.testing.assert_allclose(got["scores"], ws, rtol=0, atol=0 if case.startswith("exact") else SCORE_ATOL)
    np.testing.assert_array_equal(results[0]["scores"], results[1]["scores"])
    assert (results[0]["idx"] < len(gallery)).all()
