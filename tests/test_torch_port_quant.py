"""The port's int8 serving (``visiondk_tpu_torch/ops/quant.py``) against the
JAX package's ``visiondk_tpu.ops.quant``.

- ``quantize_tensor``, per tensor and per channel: codes and scales
  bit-identical to JAX's on the same numpy-seeded inputs;
- ``int8_dense_prequant`` within 1e-6 relative of JAX's (the int32 product is
  exact on both sides; the f32 dequant may round once more or less), and the
  padded ``torch._int_mm`` product equal to the unpadded int32 product at
  shapes that break the card's rules (M 1, 5, 17; K 2, 24; N 4, 37);
- the weight cache's keys equal to JAX ``build_weight_cache``'s for a tiny
  model of each family (ViT, ViT with the ``map`` pool, Swin, SwinV2's CPB
  MLPs, ResNet, ConvNeXt, MobileNetV3's SE convs and ``conv_head``,
  EfficientNetV2, the embedding neck, ``attention_pool``), with the JAX
  weights carried into the port by the bridge; on ViT, MobileNetV3 and
  SwinV2 each entry's codes and scales bit-identical to the cache JAX builds
  eagerly;
- the int8 eval and embed steps against JAX's ``quant="int8"`` steps in f32:
  per-row cosine ≥ 0.9999 to JAX (the JAX ViT pads its tokens 17 → 24, which
  can move the per-tensor activation scale) and ≥ 0.995 to the port's own f32
  output; embeddings unit-norm within 1e-4;
- a wrong cache raises ``KeyError``/``ValueError``; ``check_quant``;
- ``validate --quant int8 --device cpu`` prints the top1 of the in-process
  int8 step.
"""

import re
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_port_serving_toys as toys
from visiondk_tpu.engine.state import create_train_state as jax_train_state
from visiondk_tpu.engine.steps import StepConfig as JaxStepConfig
from visiondk_tpu.engine.steps import make_embed_step as jax_embed_step
from visiondk_tpu.engine.steps import make_eval_step as jax_eval_step
from visiondk_tpu.models.backbones import BACKBONES as JAX_BACKBONES
from visiondk_tpu.models.backbones import mobilenet as jax_mobilenet
from visiondk_tpu.models.backbones import swinv2 as jax_swinv2
from visiondk_tpu.models.backbones.convnext import _convnext as jax_convnext
from visiondk_tpu.models.backbones.efficientnet import _effv2 as jax_effv2
from visiondk_tpu.models.backbones.resnet import _resnet as jax_resnet
from visiondk_tpu.models.backbones.swin import _swin as jax_swin
from visiondk_tpu.models.backbones.vit import _vit as jax_vit
from visiondk_tpu.ops import quant as jax_quant
from visiondk_tpu_torch.engine import evaluation as cls_eval
from visiondk_tpu_torch.engine.steps import StepConfig, make_embed_step, make_eval_step
from visiondk_tpu_torch.models import BACKBONES, get_model
from visiondk_tpu_torch.models.backbones.convnext import _convnext
from visiondk_tpu_torch.models.backbones.efficientnet import _effv2
from visiondk_tpu_torch.models.backbones.mobilenet import _mnv3
from visiondk_tpu_torch.models.backbones.resnet import _resnet
from visiondk_tpu_torch.models.backbones.swin import _swin
from visiondk_tpu_torch.models.backbones.swinv2 import _swinv2
from visiondk_tpu_torch.models.backbones.vit import _vit
from visiondk_tpu_torch.models.convert import load_jax_params
from visiondk_tpu_torch.ops import quant

SO400M_RATIO = 4304 / 1152
_MNV3_SE_HS = [(3, 16, 16, True, False, 2), (5, 32, 24, True, True, 2), (3, 48, 24, True, True, 1)]
_EFF_TINY = [("fused", 1, 3, 1, 1, 16), ("fused", 1, 3, 2, 4, 24), ("mb", 2, 3, 2, 4, 32)]
# kind → (JAX factory, port factory, image size)
TINY = {
    "vit": (jax_vit(8, 64, 2, 4), _vit(8, 64, 2, 4), 32),
    "map_vit": (jax_vit(4, 144, 2, 2, mlp_ratio=SO400M_RATIO, class_token=False, pool="map"),
                _vit(4, 144, 2, 2, mlp_ratio=SO400M_RATIO, class_token=False, pool="map"), 16),
    "swin": (jax_swin(16, (2, 2), (2, 4), window_size=4), _swin(16, (2, 2), (2, 4), window_size=4), 32),
    "swinv2": (jax_swinv2._swinv2(16, (2, 2), (2, 4), window_size=4), _swinv2(16, (2, 2), (2, 4), window_size=4),
               32),
    "resnet_se": (jax_resnet([1, 1, 1, 1], "bottleneck", use_se=True),
                  _resnet([1, 1, 1, 1], "bottleneck", use_se=True), 32),
    "convnext": (jax_convnext((1, 1), (8, 16)), _convnext((1, 1), (8, 16)), 32),
    "mobilenetv3": (jax_mobilenet._mnv3(_MNV3_SE_HS, 48, head_width=32), _mnv3(_MNV3_SE_HS, 48, head_width=32), 32),
    "effv2": (jax_effv2(_EFF_TINY, 16, head_ch=64), _effv2(_EFF_TINY, 16, head_ch=64), 32),
}
CLASSES = 37  # N not a multiple of 8: the head's columns are padded


def _name(kind):
    return f"{kind}_tiny_port_quant_test"


@pytest.fixture(scope="module", autouse=True)
def tiny_models_registered():
    for kind, (jax_factory, port_factory, _) in TINY.items():
        JAX_BACKBONES.register(jax_factory, name=_name(kind))
        BACKBONES.register(port_factory, name=_name(kind))
    yield
    for kind in TINY:
        del JAX_BACKBONES._store[_name(kind)]
        del BACKBONES._store[_name(kind)]


def _cls_cfg(kind, attention_pool=False):
    return {"task": "classification", "name": _name(kind), "num_classes": CLASSES, "image_size": TINY[kind][2],
            "attention_pool": attention_pool}


def _embed_cfg(kind):
    img = TINY[kind][2]
    return {"task": "cbir", "backbone": {_name(kind): {"feat_dim": 24, "image_size": img}},
            "head": {"arcface": {"feat_dim": 24, "num_class": 8, "margin_arc": 0.35, "margin_am": 0.0,
                                 "scale": 32}}}


# the configs of the cache-key test: every family, the embedding neck and attention_pool
CACHE_CASES = {**{kind: _cls_cfg(kind) for kind in TINY}, "vit_embedding": _embed_cfg("vit"),
               "swin_attention_pool": _cls_cfg("swin", attention_pool=True)}
_BUILT: dict = {}


_jax_cache = jax.jit(jax_quant.build_weight_cache)  # one compile, not one per eager op


def _both(case):
    """(JAX model, the numpy-seeded tree, the bridged port model in f32), once a case."""
    if case not in _BUILT:
        cfg = CACHE_CASES[case]
        embedding = cfg["task"] != "classification"
        img = TINY[next(iter(cfg["backbone"])).split("_tiny_")[0] if embedding else cfg["name"].split("_tiny_")[0]][2]
        jmodel, variables = toys.jax_init(cfg, img, embedding=embedding)
        tree = toys.random_tree(variables, seed=3)
        port = load_jax_params(get_model(cfg, device="cpu"), tree).eval()
        _BUILT[case] = (jmodel, tree, port, img)
    return _BUILT[case]


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / np.maximum(np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1), 1e-30)


@pytest.mark.parametrize("shape,spread", [((64, 32), 3.0), ((5, 37), 0.01), ((17, 2), 100.0), ((3, 7, 24), 1.0)])
def test_quantize_tensor_is_bit_identical_to_jax(shape, spread):
    rng = np.random.default_rng(sum(shape))
    x = (rng.normal(size=shape) * rng.uniform(0.01, spread, size=shape)).astype(np.float32)
    x.flat[0] = 0.5 * np.abs(x).max()  # a value that rounds half-way at some scale
    for axis in (None, len(shape) - 1, 0):
        jq, js = jax_quant.quantize_tensor(jnp.asarray(x), axis=axis)
        q, s = quant.quantize_tensor(torch.from_numpy(x), axis=axis)
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    zeros = quant.quantize_tensor(torch.zeros(4, 8))  # scale floor 1e-12/127, codes 0
    assert float(zeros[1]) == np.float32(np.float32(1e-12) / np.float32(127.0)) and not zeros[0].any()


@pytest.mark.parametrize("m", [1, 5, 17])
@pytest.mark.parametrize("k", [2, 24])
@pytest.mark.parametrize("n", [4, 37])
def test_padded_int8_product_is_exact(m, k, n):
    rng = np.random.default_rng(m * 100 + k * 10 + n)
    x = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    w = quant.quantize_weight(torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32)))
    assert w.mm.shape == quant.int_mm_shape(quant.INT_MM_MIN_ROWS, k, n)[1:]
    assert not w.mm[k:].any() and not w.mm[:, n:].any()  # the pad columns and rows are zeros
    got = quant.int8_matmul(x, w)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    want = x.to(torch.int64) @ w.q.to(torch.int64).T
    assert torch.equal(got.to(torch.int64), want)


def test_int_mm_shape_rules():
    assert quant.int_mm_shape(1, 2, 37) == (17, 8, 40)
    assert quant.int_mm_shape(25216, 768, 3072) == (25216, 768, 3072)
    assert quant.int_mm_shape(16, 9, 1000) == (17, 16, 1000)


@pytest.mark.parametrize("lead,k,n", [((6,), 24, 37), ((2, 5), 2, 8), ((1,), 64, 4)])
def test_int8_dense_prequant_matches_jax(lead, k, n):
    rng = np.random.default_rng(k + n)
    x = rng.normal(size=(*lead, k)).astype(np.float32)
    kernel = (0.2 * rng.normal(size=(k, n))).astype(np.float32)
    bias = rng.normal(size=(n,)).astype(np.float32)
    jq, js = jax_quant.quantize_tensor(jnp.asarray(kernel), axis=1)
    want = np.asarray(jax.jit(lambda x, q, s, b: jax_quant.int8_dense_prequant(x, q, s, b, jnp.float32))(
        x, jq, js, bias))
    w = quant.quantize_weight(torch.from_numpy(kernel.T.copy()))
    got = quant.int8_dense_prequant(torch.from_numpy(x), w, torch.from_numpy(bias), torch.float32).numpy()
    assert got.shape == want.shape == (*lead, n)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    eager = quant.int8_dense(torch.from_numpy(x), torch.from_numpy(kernel.T.copy()), None, torch.bfloat16)
    assert eager.dtype == torch.bfloat16


@pytest.mark.parametrize("case", list(CACHE_CASES))
def test_weight_cache_keys_are_jax_ones(case):
    _, tree, port, _ = _both(case)
    want = _jax_cache(toys.jax_vars(tree)["params"])
    got = quant.build_weight_cache(port)
    assert sorted(got) == sorted(want)
    for path, (jq, _) in want.items():
        assert tuple(got[path].q.shape) == tuple(jq.shape)[::-1], path
    family_keys = {"swinv2": ("attn/cpb_fc1", "attn/cpb_fc2"), "mobilenetv3": ("se/fc1", "se/fc2", "pre_head"),
                   "effv2": ("se/fc1", "se/fc2"), "resnet_se": ("se/fc1", "se/fc2"), "vit_embedding": ("neck/proj",),
                   "swin_attention_pool": ("pool/q", "pool/k", "pool/v", "pool/proj", "fc"),
                   "map_vit": ("attn_pool/q", "attn_pool/kv", "attn_pool/proj")}.get(case, ())
    for suffix in family_keys:
        assert any(p.endswith(suffix) for p in got), (case, suffix)


@pytest.mark.parametrize("case", ["vit", "mobilenetv3", "swinv2"])
def test_weight_cache_codes_are_bit_identical_to_jax(case):
    """Against JAX's cache built eagerly, as its serving CLIs build it (under
    ``jax.jit`` XLA divides by 127 through a reciprocal, which can move a
    scale's last bit)."""
    _, tree, port, _ = _both(case)
    want = jax_quant.build_weight_cache(toys.jax_vars(tree)["params"])
    got = quant.build_weight_cache(port)
    for path, (jq, js) in want.items():
        np.testing.assert_array_equal(got[path].q.numpy().T, np.asarray(jq), err_msg=path)
        np.testing.assert_array_equal(got[path].scale.numpy(), np.asarray(js)[0], err_msg=path)


def _jax_state(tree):
    return jax_train_state(toys.jax_vars(tree), optax.sgd(0.0))


def _batch(img, n=4, seed=9):
    return np.random.default_rng(seed).integers(0, 256, (n, img, img, 3)).astype(np.uint8)


@pytest.mark.parametrize("case", ["vit", "mobilenetv3", "swinv2"])
def test_int8_eval_step_matches_jax(case):
    jmodel, tree, port, img = _both(case)
    x = _batch(img)
    state = _jax_state(tree)
    want = np.asarray(jax_eval_step(jmodel, JaxStepConfig(), use_ema=False, quant="int8")(
        state, {"image": jnp.asarray(x)}))
    got = make_eval_step(port, StepConfig(), quant="int8", quant_cache=quant.build_weight_cache(port))(
        {"image": torch.from_numpy(x)}).numpy()
    f32 = make_eval_step(port, StepConfig())({"image": torch.from_numpy(x)}).numpy()
    uncached = make_eval_step(port, StepConfig(), quant="int8")({"image": torch.from_numpy(x)}).numpy()
    assert got.shape == want.shape == (4, CLASSES)
    assert _cos(got, want).min() >= 0.9999, _cos(got, want)
    assert _cos(got, f32).min() >= 0.995, _cos(got, f32)
    np.testing.assert_array_equal(uncached, got)  # the cache is the in-call quantization, done once
    assert not np.array_equal(got, f32)  # the int8 path ran


@pytest.mark.parametrize("case", ["vit_embedding"])
def test_int8_embed_step_matches_jax(case):
    jmodel, tree, port, img = _both(case)
    x = _batch(img)
    state = _jax_state(tree)
    want = np.asarray(jax_embed_step(jmodel, JaxStepConfig(), use_ema=False, quant="int8")(
        state, {"image": jnp.asarray(x)}))
    got = make_embed_step(port, StepConfig(), quant="int8", quant_cache=quant.build_weight_cache(port))(
        {"image": torch.from_numpy(x)}).numpy()
    f32 = make_embed_step(port, StepConfig())({"image": torch.from_numpy(x)}).numpy()
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-4)
    assert _cos(got, want).min() >= 0.9999, _cos(got, want)
    assert _cos(got, f32).min() >= 0.995, _cos(got, f32)


def test_a_wrong_cache_raises_and_check_quant():
    _, _, port, img = _both("vit")
    x = {"image": torch.from_numpy(_batch(img))}
    cache = quant.build_weight_cache(port)
    missing = {k: v for k, v in cache.items() if not k.endswith("head")}
    with pytest.raises(KeyError, match="no entry"):
        make_eval_step(port, StepConfig(), quant="int8", quant_cache=missing)(x)
    _, _, other, _ = _both("swin")
    with pytest.raises(ValueError, match="shape"):
        wrong = dict(cache)
        wrong["backbone/head"] = quant.build_weight_cache(other)["backbone/head"]
        make_eval_step(port, StepConfig(), quant="int8", quant_cache=wrong)(x)
    # the forwards are given back after a raise
    assert all("forward" not in m.__dict__ for m in port.modules())
    for off in ("", "none", "None", None):
        assert quant.check_quant(off) is None
    assert quant.check_quant("int8") == "int8"
    for bad in ("int4", "fp8", "INT8"):
        with pytest.raises(ValueError):
            quant.check_quant(bad)
        with pytest.raises(ValueError):
            make_eval_step(port, StepConfig(), quant=bad)


def test_validate_quant_int8_prints_the_int8_steps_top1(tmp_path, capsys):
    cfg, _, _, _, best = toys.classification_toy(tmp_path, _name("vit"), classes=5)
    saved = sys.argv
    sys.argv = ["visiondk_tpu_torch.validate", "--cfgs", str(best.parent / "config.yaml"), "--weight", str(best),
                "--quant", "int8", "--device", "cpu"]
    try:
        runpy.run_module("visiondk_tpu_torch.validate", run_name="__main__", alter_sys=True)
    finally:
        sys.argv = saved
    top1 = float(re.search(r"'top1': ([0-9.e+-]+)", capsys.readouterr().out).group(1))

    from visiondk_tpu_torch.engine.checkpoint import CheckpointManager
    from visiondk_tpu_torch.engine.state import create_train_state
    from visiondk_tpu_torch.engine.trainer import CenterProcessor, build_tx

    cp = CenterProcessor(cfg, project=str(best.parent), train=False, device="cpu")
    state, _ = CheckpointManager(best.parent).restore(
        "best", create_train_state(cp.model, build_tx(cfg["hyp"], 1, True, model_cfg=cfg["model"])))
    step = make_eval_step(state.model, cp.step_config(), quant="int8",
                          quant_cache=quant.build_weight_cache(state.model))
    want = cls_eval.valuate(step, cp.data_processor.dataloader("val", 4), 5, class_names=[str(c) for c in range(5)])
    assert top1 == want["top1"]
