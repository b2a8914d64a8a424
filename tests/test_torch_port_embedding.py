"""The port's embedding parts against the JAX package: margin ops and heads,
the weight bridge's head, retrieval, the pair and CBIR metrics, and the
embedding train step. Same numpy-seeded inputs on both sides, f32.

Tolerances, each with its reason:
- margin ops: cos within 1e-6 absolute (the same f32 formula, the product
  summed in another order: a few ulps) and logits within 1e-5 absolute plus
  1e-5 relative (the cos difference times the scale, up to 64, times the
  margin rewrite's slope, up to ~14 at θ ≈ 0.07 rad; CircleLoss's γ 256
  gives |logits| up to ~440, where one f32 ulp is 3e-5); MagFace's aux
  within 1e-6 relative; gradients (of a seeded weighting of the logits,
  plus the aux) within 1e-5 of their tensor's largest |entry|;
- heads through the bridge: the JAX head's first ``num_class`` logit columns
  (its pad columns are −1e9) at the margin-op bars, and the CE loss over
  them equal to the JAX loss over its padded logits within 1e-6 relative;
- retrieval: indices exactly equal, scores bit-equal on inputs whose every
  product and partial sum is exact in f32 (multiples of 1/2, many exact
  ties); on normal inputs scores within 1e-6 and indices exactly equal;
- pair and CBIR metrics: exactly equal (the same numpy code);
- three embedding train steps of a tiny Swin with an ArcFace head: the loss
  within 1e-5 relative; the updates θ₃ − θ₀ (and the EMA's move, and the
  neck's BatchNorm statistics) within 1e-5 of each tensor's largest update
  plus one f32 spacing of its largest |θ| (θ₃ is stored as θ₀ + Δ rounded
  to f32).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visiondk_tpu.engine import cbir_eval as jax_cbir_eval
from visiondk_tpu.engine import face_eval as jax_face_eval
from visiondk_tpu.engine.state import create_train_state as jax_create_train_state
from visiondk_tpu.engine.steps import StepConfig as JaxStepConfig
from visiondk_tpu.engine.steps import make_train_step as jax_make_train_step
from visiondk_tpu.engine.trainer import CenterProcessor
from visiondk_tpu.losses import losses as JL
from visiondk_tpu.models import get_model as jax_get_model
from visiondk_tpu.models.backbones import BACKBONES as JAX_BACKBONES
from visiondk_tpu.models.backbones.swin import _swin as jax_swin
from visiondk_tpu.models.convert import _flatten, _unflatten
from visiondk_tpu.models.heads import build_head as jax_build_head
from visiondk_tpu.ops import margin_heads as JMH
from visiondk_tpu.ops import retrieval as jax_retrieval
from visiondk_tpu_torch.engine import cbir_eval, face_eval
from visiondk_tpu_torch.engine.optim import create_optimizer
from visiondk_tpu_torch.engine.state import create_train_state
from visiondk_tpu_torch.engine.steps import StepConfig, make_train_step
from visiondk_tpu_torch.engine.trainer import build_tx
from visiondk_tpu_torch.losses import create_lossfn
from visiondk_tpu_torch.models import BACKBONES, EmbeddingModel, build_head, get_model
from visiondk_tpu_torch.models.backbones.swin import _swin
from visiondk_tpu_torch.models.convert import load_jax_params, param_paths, state_dict_from_jax
from visiondk_tpu_torch.models.heads import ArcFaceHead, MarginHead
from visiondk_tpu_torch.ops import margin_heads as MH
from visiondk_tpu_torch.ops import retrieval

TINY = "swin_tiny_port_embedding_test"
KWARGS = {"mlp_ratio": 2.0, "stochastic_depth_prob": 0.0}
COS_TOL, LOGIT_TOL, GRAD_RTOL = 1e-6, 1e-5, 1e-5

# (op name, options): every op, MV-Softmax in both modes
OPS = [
    ("arcface", {}),
    ("arcface", {"margin_arc": 0.5, "margin_am": 0.2, "scale": 64.0}),
    ("magface", {}),
    ("circleloss", {}),
    ("mv_softmax", {"is_am": False}),
    ("mv_softmax", {"is_am": True}),
]
OP_IDS = ["arcface", "arcface_am_fallback", "magface", "circleloss", "mv_arc", "mv_am"]


@pytest.fixture(scope="module", autouse=True)
def tiny_swin_registered():
    JAX_BACKBONES.register(jax_swin(16, (2, 2), (2, 4), window_size=4), name=TINY)
    BACKBONES.register(_swin(16, (2, 2), (2, 4), window_size=4), name=TINY)
    yield
    del JAX_BACKBONES._store[TINY]
    del BACKBONES._store[TINY]


def _inputs(b=12, d=16, c=10, seed=0, feat_scale=20.0):
    """Weight [d, c], features [b, d] and labels; row 0's feature points away
    from its target column (cos near −1: the ops' fallback branches) and row
    1's along it (cos near 1), both at angles of about 0.1 rad, where
    sin θ = √(1 − cos²θ) is still well conditioned (at 1e-3 rad a one-ulp
    change of cos moves a logit by ~1e-3)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(d, c)).astype(np.float32)
    f = (rng.normal(size=(b, d)) * feat_scale / np.sqrt(d)).astype(np.float32)
    y = rng.integers(0, c, size=b).astype(np.int32)
    f[0] = -3.0 * w[:, y[0]] + 0.3 * rng.normal(size=d)
    f[1] = 5.0 * w[:, y[1]] + 0.5 * rng.normal(size=d)
    g = rng.normal(size=(b, c)).astype(np.float32)  # weights the logits for a gradient
    return w, f, y, g


def _max_close(got, want, rtol, what):
    bar = rtol * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= bar, f"{what}: max |err| {err:.3e} > {bar:.3e}"


# ---------------------------------------------------------------- margin ops


def test_cosine_logits_match_jax():
    w, f, _, _ = _inputs()
    want = np.asarray(JMH.cosine_logits(jnp.asarray(w), jnp.asarray(f)))
    got = MH.cosine_logits(torch.from_numpy(w), torch.from_numpy(f))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=COS_TOL)
    assert np.abs(want).max() <= 1.0


@pytest.mark.parametrize("case", range(len(OPS)), ids=OP_IDS)
def test_margin_op_forward_and_gradient_match_jax(case):
    name, opts = OPS[case]
    w, f, y, g = _inputs(seed=case)
    jop, op = JMH.MARGIN_OPS[name], MH.MARGIN_OPS[name]
    want, want_aux = jop(jnp.asarray(w), jnp.asarray(f), jnp.asarray(y), **opts)

    def jloss(w_, f_):
        logits, aux = jop(w_, f_, jnp.asarray(y), **opts)
        return jnp.sum(logits * jnp.asarray(g)) + aux

    jgw, jgf = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(f))
    tw, tf = torch.from_numpy(w).requires_grad_(), torch.from_numpy(f).requires_grad_()
    logits, aux = op(tw, tf, torch.from_numpy(y), **opts)
    (torch.sum(logits * torch.from_numpy(g)) + aux).backward()

    assert logits.dtype == torch.float32 and logits.shape == want.shape
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-6, atol=0)
    if name == "magface":
        assert aux.item() > 0
    _max_close(tw.grad.numpy(), np.asarray(jgw), GRAD_RTOL, f"{name} dL/dW")
    _max_close(tf.grad.numpy(), np.asarray(jgf), GRAD_RTOL, f"{name} dL/dfeats")


def test_margin_ops_take_the_fallback_branches():
    """Row 0 (cos near −1 on its target) sits below ArcFace's min_cos: its
    target logit is the AM fallback (cos − m_am)·s, not cos(θ + m)·s."""
    w, f, y, _ = _inputs()
    cos = MH.cosine_logits(torch.from_numpy(w), torch.from_numpy(f))
    assert -0.9999 < cos[0, y[0]] < -0.95 and 0.95 < cos[1, y[1]] < 0.9999
    logits, _ = MH.arcface_logits(torch.from_numpy(w), torch.from_numpy(f), torch.from_numpy(y),
                                  margin_arc=0.5, margin_am=0.2, scale=64.0)
    np.testing.assert_allclose(logits[0, y[0]].item(), (cos[0, y[0]].item() - 0.2) * 64.0, rtol=1e-6)


def test_cosine_product_ignores_the_callers_matmul_precision():
    """The op sets the f32 product's precision itself and restores the
    caller's setting: the same logits and gradients under "high" as under
    "highest"."""
    w, f, y, g = _inputs(seed=3)

    def run():
        tw, tf = torch.from_numpy(w).requires_grad_(), torch.from_numpy(f).requires_grad_()
        logits, _ = MH.arcface_logits(tw, tf, torch.from_numpy(y))
        torch.sum(logits * torch.from_numpy(g)).backward()
        return logits.detach(), tw.grad, tf.grad

    ref = run()
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        got = run()
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_init_margin_weight_has_unit_columns():
    w = MH.init_margin_weight(torch.Generator().manual_seed(0), 16, 10)
    assert w.shape == (16, 10) and w.dtype == torch.float32
    np.testing.assert_allclose(torch.linalg.vector_norm(w, dim=0).numpy(), 1.0, rtol=1e-6)
    assert torch.equal(w, MH.init_margin_weight(torch.Generator().manual_seed(0), 16, 10))


# ---------------------------------------------------------------- heads and the bridge

HEADS = [
    {"arcface": {"feat_dim": 16, "num_class": 10, "margin_arc": 0.35, "margin_am": 0.0, "scale": 32}},
    {"magface": {"feat_dim": 16, "num_class": 10}},
    {"circleloss": {"feat_dim": 16, "num_class": 10, "margin": 0.3}},
    {"mv-softmax": {"feat_dim": 16, "num_class": 10, "is_am": True}},
    {"mv_softmax": {"feat_dim": 16, "num_class": 10}},
]


@pytest.mark.parametrize("head_cfg", HEADS, ids=lambda c: next(iter(c)) + str(next(iter(c.values())).get("is_am", "")))
def test_build_head_matches_jax_through_the_bridge(head_cfg):
    """The JAX head pads 10 classes to 128 columns; the bridge takes the
    first 10. Logits equal on the real columns, and CE over the port's 10
    equals CE over JAX's 128 (the pad logits are −1e9)."""
    w, f, y, _ = _inputs(seed=5)
    jhead = jax_build_head(head_cfg, class_pad_multiple=128)
    variables = jhead.init(jax.random.key(0), jnp.asarray(f), jnp.asarray(y))
    padded = np.asarray(variables["params"]["weight"]).copy()
    assert padded.shape == (16, 128)
    padded[:, :10] = w
    want, want_aux = jhead.apply({"params": {"weight": jnp.asarray(padded)}}, jnp.asarray(f), jnp.asarray(y))
    head = build_head(head_cfg)
    assert isinstance(head, MarginHead) and head.weight.shape == (16, 10)
    load_jax_params(head, {"params": {"weight": padded}})
    assert torch.equal(head.weight.detach(), torch.from_numpy(w))
    logits, aux = head(torch.from_numpy(f), torch.from_numpy(y))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want)[:, :10], rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert (np.asarray(want)[:, 10:] == -1e9).all()
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-6)
    jce = float(JL.create_lossfn("ce", valid_class=10)(want, jnp.asarray(y)))
    ce = create_lossfn("ce", valid_class=10)(logits, torch.from_numpy(y)).item()
    np.testing.assert_allclose(ce, jce, rtol=1e-6)


def test_build_head_raises_as_the_jax_factory():
    with pytest.raises(ValueError, match="not supported"):
        build_head({"cosface": {"feat_dim": 4, "num_class": 3}})
    with pytest.raises(ValueError, match="not supported"):
        jax_build_head({"cosface": {"feat_dim": 4, "num_class": 3}})
    with pytest.raises(TypeError, match="unexpected"):
        build_head({"arcface": {"feat_dim": 4, "num_class": 3, "s": 64}})
    assert build_head({"arcface": {"feat_dim": 4, "num_class": 3}}).options == {
        "margin_arc": 0.35, "margin_am": 0.0, "scale": 32.0}


def test_bridge_refuses_a_head_narrower_than_num_class():
    head = build_head({"arcface": {"feat_dim": 16, "num_class": 10}})
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(head, {"params": {"weight": np.zeros((16, 8), np.float32)}})


def _face_cfg(num_class=7, head=None):
    return {"task": "face", "image_size": 32,
            "backbone": {TINY: {"feat_dim": 16, "image_size": 32, **KWARGS}},
            "head": head or {"arcface": {"feat_dim": 16, "num_class": num_class, "margin_arc": 0.35,
                                         "margin_am": 0.0, "scale": 32}}}


def test_get_model_builds_the_head_and_layer_wise_lr_boosts_it():
    model = get_model(_face_cfg(), device="cpu")
    assert isinstance(model, EmbeddingModel) and isinstance(model.head, ArcFaceHead)
    paths = param_paths(model)
    assert paths["head.weight"] == "head/weight"
    np.testing.assert_allclose(torch.linalg.vector_norm(model.head.weight, dim=0).detach().numpy(), 1.0, rtol=1e-6)
    lr = lambda c: 1.0  # noqa: E731
    labels = create_optimizer("sgd", lr, 0.0, lr, layer_wise_lr=True).labels(model)
    assert labels["head.weight"] == 10.0
    assert {v for k, v in labels.items() if k != "head.weight"} == {1.0}  # the neck is not boosted
    headless = get_model({**_face_cfg(), "head": None}, device="cpu")
    assert headless.head is None
    with pytest.raises(ValueError, match="no margin head"):
        headless(torch.zeros(1, 32, 32, 3), torch.zeros(1, dtype=torch.long))


# ---------------------------------------------------------------- retrieval


def _exact_data(q=9, g=40, d=16, seed=0):
    """Entries in {−1, −½, 0, ½, 1} with duplicated gallery rows: every
    product and partial sum is exact in f32 whatever the order, and ties are
    many (some straddle the k-th place)."""
    rng = np.random.default_rng(seed)
    queries = rng.integers(-2, 3, size=(q, d)).astype(np.float32) / 2
    gallery = rng.integers(-2, 3, size=(g, d)).astype(np.float32) / 2
    gallery[g // 2:] = gallery[: g - g // 2]  # every row twice
    return queries, gallery


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("k", [1, 5, 17])
def test_topk_ip_matches_jax_with_exact_ties(dtype, k):
    queries, gallery = _exact_data(seed=k)
    ws, wi = jax_retrieval.topk_ip(jnp.asarray(queries), jnp.asarray(gallery), k,
                                   compute_dtype=getattr(jnp, dtype))
    s, i = retrieval.topk_ip(torch.from_numpy(queries), torch.from_numpy(gallery), k,
                             compute_dtype=getattr(torch, dtype))
    assert s.dtype == torch.float32 and i.dtype == torch.int64
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))
    # every gallery row is there twice: the best score of every query is a tie to break
    top2 = np.sort(queries @ gallery.T, axis=1)[:, -2:]
    assert (top2[:, 0] == top2[:, 1]).all()


def test_topk_lower_index_ranks_a_tie_that_straddles_the_kth_place():
    sim = torch.tensor([[0.5, 2.0, 1.0, 2.0, 1.0, 1.0, 3.0],
                        [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]])
    s, i = retrieval.topk_lower_index(sim, 4)
    assert i.tolist() == [[6, 1, 3, 2], [0, 1, 2, 3]]
    assert s.tolist() == [[3.0, 2.0, 2.0, 1.0], [1.0] * 4]


def _normal_data(q=21, g=50, d=24, seed=1):
    rng = np.random.default_rng(seed)
    queries = rng.normal(size=(q, d)).astype(np.float32)
    gallery = rng.normal(size=(g, d)).astype(np.float32)
    return (queries / np.linalg.norm(queries, axis=1, keepdims=True),
            gallery / np.linalg.norm(gallery, axis=1, keepdims=True))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("k,chunk", [(7, 8), (60, 5)], ids=["k7_chunks", "k_over_gallery"])
def test_search_matches_jax(dtype, k, chunk):
    queries, gallery = _normal_data()
    ws, wi = jax_retrieval.search(queries, gallery, k=k, query_chunk=chunk, compute_dtype=getattr(jnp, dtype))
    s, i = retrieval.search(queries, gallery, k=k, query_chunk=chunk, compute_dtype=getattr(torch, dtype),
                            device="cpu")
    assert s.shape == i.shape == (21, min(k, 50)) and s.dtype == np.float32 and i.dtype == np.int64
    np.testing.assert_array_equal(i, wi)
    np.testing.assert_allclose(s, ws, rtol=0, atol=1e-6)


def test_search_rounds_to_bf16_and_sums_in_f32():
    """bf16 inputs, f32 sums: the scores equal a float64 brute force over the
    bf16-rounded inputs to f32 accuracy (a bf16 product would not)."""
    queries, gallery = _normal_data(seed=2)
    s, _ = retrieval.search(queries, gallery, k=50, device="cpu")
    rq = torch.from_numpy(queries).bfloat16().double().numpy()
    rg = torch.from_numpy(gallery).bfloat16().double().numpy()
    brute = -np.sort(-(rq @ rg.T), axis=1)
    np.testing.assert_allclose(s, brute, rtol=0, atol=1e-6)


# ---------------------------------------------------------------- pair and CBIR metrics


def _pairs(seed=0, n=60, d=8):
    rng = np.random.default_rng(seed)
    names = [f"id{i // 3}/img{i}.jpg" for i in range(30)]
    feats = rng.normal(size=(30, d)).astype(np.float32)
    for i in range(30):  # same id: close
        feats[i] += 3.0 * np.eye(d, dtype=np.float32)[(i // 3) % d]
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    name2feat = {n_: f for n_, f in zip(names, feats)}
    pairs = []
    for j in range(n):
        a = int(rng.integers(30))
        same = j % 2 == 0
        b = (a // 3) * 3 + int(rng.integers(3)) if same else int(rng.integers(30))
        pairs.append([names[a], "./" + names[b], str(int(same or a // 3 == b // 3))])
    return pairs, name2feat


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ten_fold_accuracy_and_best_threshold_equal_jax(seed):
    pairs, name2feat = _pairs(seed)
    assert face_eval.ten_fold_accuracy(pairs, name2feat) == jax_face_eval.ten_fold_accuracy(pairs, name2feat)
    rng = np.random.default_rng(seed)
    scores, labels = rng.normal(size=200).astype(np.float32), rng.integers(0, 2, size=200)
    assert face_eval.best_threshold(scores, labels) == jax_face_eval.best_threshold(scores, labels)


def test_process_pair_txt_equals_jax(tmp_path):
    pairs, _ = _pairs()
    txt = tmp_path / "pairs.txt"
    txt.write_text("".join(" ".join(p) + "\n" for p in pairs))
    assert face_eval.process_pair_txt(str(txt), "/data") == jax_face_eval.process_pair_txt(str(txt), "/data")


def _retrieval_case(seed):
    rng = np.random.default_rng(seed)
    names = [f"g{i}" for i in range(25)]
    ids = [f"c{i % 5}" for i in range(25)]
    id2names = {}
    for n_, c in zip(names, ids):
        id2names.setdefault(c, []).append(n_)
    preds, labels, scores = [], [], []
    for q in range(12):
        order = rng.permutation(25)[:6]
        preds.append([names[j] for j in order])
        labels.append(id2names[f"c{q % 5}"])
        s = np.sort(rng.normal(size=6))[::-1].astype(np.float32)
        s[2] = s[3]  # a tied score
        scores.append(s)
    return preds, labels, np.stack(scores)


@pytest.mark.parametrize("seed", [0, 1])
def test_cbir_metrics_equal_jax(seed):
    preds, labels, scores = _retrieval_case(seed)
    got, want = cbir_eval.CBIRMetrics([1, 3, 5]), jax_cbir_eval.CBIRMetrics([1, 3, 5])
    for m in (got, want):
        m.compute_mrr(preds, labels)
        m.compute_recall(preds, labels)
        m.compute_precision(preds, labels)
        m.compute_auc(preds, labels, scores)
        m.compute_ndcg(preds, labels, scores)
    assert got.metrics == want.metrics and len(got.metrics) == 13
    rng = np.random.default_rng(seed)
    hard = rng.integers(0, 2, size=(7, 9)).astype(np.float64)
    raw = np.round(rng.normal(size=(7, 9)), 1)  # ties
    for k in (1, 3, 20):
        assert cbir_eval.ndcg_at_k(hard, raw, k) == jax_cbir_eval.ndcg_at_k(hard, raw, k)
    assert cbir_eval.roc_auc(hard.ravel(), raw.ravel()) == jax_cbir_eval.roc_auc(hard.ravel(), raw.ravel())
    assert np.isnan(cbir_eval.roc_auc(np.ones(4), np.arange(4.0)))


def test_embedding_cache_round_trip(tmp_path):
    emb = np.random.default_rng(0).normal(size=(23, 8)).astype(np.float32)
    path = str(tmp_path / "gallery.mm")
    cbir_eval.save_embedding_cache(path, emb)
    assert np.array_equal(cbir_eval.load_embedding_cache(path, expected_rows=23), emb)
    assert cbir_eval.load_embedding_cache(path, expected_rows=24) is None  # stale
    assert np.array_equal(jax_cbir_eval.load_embedding_cache(path), emb)  # the JAX reader reads it


# ---------------------------------------------------------------- the embedding train step

# the optimizer fields of configs/faceX/cbir_synth.yaml's `hyp:` (layer-wise lr: the head ×10)
CBIR_SYNTH_HYP = {
    "epochs": 5, "lr0": 0.006, "lrf_ratio": None, "momentum": 0.937, "weight_decay": 0.0005,
    "warmup_momentum": 0.8, "warm_ep": 1, "optimizer": ["sgd", True], "scheduler": "cosine_with_warm",
}


def _random_tree(variables, seed):
    rng = np.random.default_rng(seed)
    tree = {}
    for t in ("params", "batch_stats"):
        flat = {p: np.asarray(v) for p, v in _flatten(dict(variables.get(t, {}))).items()}
        for p, v in flat.items():
            if p.endswith("/var"):
                flat[p] = (0.5 + rng.random(v.shape)).astype(np.float32)
            elif p.endswith("/scale"):
                flat[p] = (1.0 + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
            elif p == "head/weight":
                flat[p] = rng.normal(size=v.shape).astype(np.float32)
            else:
                flat[p] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
        tree[t] = flat
    return tree


def test_three_embedding_train_steps_match_jax():
    cfg = _face_cfg()
    jmodel = jax_get_model(cfg, class_pad_multiple=128)
    variables = jmodel.init(jax.random.key(1), jnp.zeros((1, 32, 32, 3)), jnp.zeros((1,), jnp.int32), train=False)
    tree = _random_tree(variables, seed=6)
    assert tree["params"]["head/weight"].shape == (16, 128)
    port = load_jax_params(get_model(cfg, device="cpu"), tree)
    theta0 = {k: v.clone() for k, v in port.state_dict().items()}

    fake = SimpleNamespace(hyp_cfg=CBIR_SYNTH_HYP, opt_name="sgd", layer_wise=True, model_cfg={})
    jtx = CenterProcessor._build_tx(fake, 2, False)
    jstate = jax_create_train_state({t: jax.tree_util.tree_map(jnp.asarray, _unflatten(f)) for t, f in tree.items()},
                                    jtx)
    jstep = jax_make_train_step(jmodel, jtx, JL.create_lossfn("ce", valid_class=7), JaxStepConfig(task="embedding"),
                                jax.random.key(0), donate=False)
    tx = build_tx(CBIR_SYNTH_HYP, 2, False)
    state = create_train_state(port, tx)
    step = make_train_step(port, tx, create_lossfn("ce", valid_class=7), StepConfig(task="embedding"),
                           torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    for _ in range(3):
        batch = {"image": rng.integers(0, 256, size=(6, 32, 32, 3), dtype=np.uint8),
                 "label": rng.integers(0, 7, size=6).astype(np.int32)}
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.float32(0.0))
        metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), rtol=1e-5)
    assert state.step == 3 and state.optimizer.count == 3

    def check_moved(module, jparams, jstats, what):
        flat = {"params": {p: np.asarray(v) for p, v in _flatten(dict(jparams)).items()},
                "batch_stats": {p: np.asarray(v) for p, v in _flatten(dict(jstats)).items()}}
        want = state_dict_from_jax(module, flat)
        for key, value in module.state_dict().items():
            if key.endswith("num_batches_tracked"):
                continue
            got_d = (value - theta0[key]).numpy()
            want_d = (want[key] - theta0[key]).numpy()
            assert np.abs(want_d).max() > 0, (what, key)  # every tensor moved: head, neck and its statistics
            spacing = np.spacing(np.abs(want[key].numpy()).max())
            np.testing.assert_allclose(got_d, want_d, rtol=0, atol=1e-5 * np.abs(want_d).max() + spacing,
                                       err_msg=f"{what} {key}")

    check_moved(port, jstate.params, jstate.batch_stats, "update")
    check_moved(state.ema_model, jstate.ema_params, jstate.ema_batch_stats, "ema")
