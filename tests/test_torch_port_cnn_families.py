"""The port's ConvNeXt, MobileNetV3 and EfficientNetV2 (``visiondk_tpu_torch/
models/backbones/{convnext,mobilenet,efficientnet}.py``) and their layers
against the JAX package's.

Setup: one tiny variant per block kind, registered in both packages'
registries by this file, at 32×32 with 5 classes: ConvNeXt with dims (8, 16)
and one block a stage (block + downsample); MobileNetV3 with a strided
depthwise-separable block with SE, inverted residuals with SE and
hard-swish, and one with a residual; its relu 'minimal' form with TF 'SAME'
padding and BN eps 1e-3; EfficientNetV2 with a ConvBnAct (fused, no
expansion, residual), an EdgeResidual and two MBConv + SE blocks, and the
same with TF 'SAME' padding. Every JAX tensor is drawn from a numpy seed
(conv and dense kernels at lecun scale, norm scales near 1, running
variances positive) and carried into the port by the weight bridge; inputs
are numpy-seeded too. The bridge is checked strictly on every registered
name of the three families (13), each built by ``get_model(device="cpu")``
with its random draws replaced by a cheap pattern, both ways: the port's
state dict through
the JAX package's ``convert_state_dict`` (strict) gives the JAX model's
tree, name for name and shape for shape (``jax.eval_shape``), and that tree
through the port's bridge gives the port's state dict back exactly.

Tolerances, the bars of ``test_torch_port_resnet.py``: forward logits,
embeddings and BN running statistics in f32 on both sides rtol 1e-3, atol
3e-4 (measured worst: 4.2e-7 absolute on the logits, eval and train mode).
Three train steps with the port and the JAX step both in float64
(``jax.enable_x64``; the port's parameters, buffers and layers as
``chip_smoke.py``'s float64 mode sets them): each step's loss within 1e-5
relative (measured worst 1.4e-7: both sides take the loss in f32); every
update and EMA update within 1e-3 of its tensor's norm plus three f32
spacings of the tensor (measured worst update 6.3e-7 of its norm; the port's
EMA shadow is f32 by design, so its EMA updates sit within those spacings).
In f32 the port's three steps would not show what they test: the tiny
ConvNeXt's f32 logits are 3e-5 to 8e-5 from its float64 logits in the JAX
package itself, at dims 8 to 64. ``tf_same_padding`` is exact; the
activations are bit-equal in f32 and within one bf16 ulp in bf16; the SE
blocks at rtol 1e-5, atol 1e-6. The JAX side runs under ``jax.jit``
(eager JAX compiles op by op, three times slower here).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from visiondk_tpu.engine.optim import freeze_mask as jax_freeze_mask
from visiondk_tpu.engine.optim import layer_wise as jax_layer_wise
from visiondk_tpu.engine.state import create_train_state as jax_create_train_state
from visiondk_tpu.engine.steps import StepConfig as JaxStepConfig
from visiondk_tpu.engine.steps import make_train_step as jax_make_train_step
from visiondk_tpu.engine.trainer import CenterProcessor
from visiondk_tpu.losses import losses as JL
from visiondk_tpu.models import get_model as jax_get_model
from visiondk_tpu.models.backbones import BACKBONES as JAX_BACKBONES
from visiondk_tpu.models.backbones import mobilenet as jax_mobilenet
from visiondk_tpu.models.backbones.convnext import _convnext as jax_convnext
from visiondk_tpu.models.backbones.efficientnet import _effv2 as jax_effv2
from visiondk_tpu.models.convert import _flatten, _unflatten, convert_state_dict
from visiondk_tpu_torch.engine.optim import create_optimizer
from visiondk_tpu_torch.engine.state import create_train_state
from visiondk_tpu_torch.engine.steps import StepConfig, make_train_step
from visiondk_tpu_torch.engine.trainer import build_tx
from visiondk_tpu_torch.losses import create_lossfn
from visiondk_tpu_torch.models import BACKBONES, factory, get_model
from visiondk_tpu_torch.models.backbones.convnext import ConvNeXt, _convnext
from visiondk_tpu_torch.models.backbones.efficientnet import EfficientNetV2, _effv2
from visiondk_tpu_torch.models.backbones.mobilenet import MobileNetV3, _mnv3
from visiondk_tpu_torch.models.convert import load_jax_params, param_paths, state_dict_from_jax
from visiondk_tpu_torch.models.layers import (
    SEBlock, hard_sigmoid, hard_swish, make_divisible, tf_same_padding,
)

RTOL, ATOL = 1e-3, 3e-4
IMG, CLASSES = 32, 5
_MNV3_SE_HS = [(3, 16, 16, True, False, 2), (5, 32, 24, True, True, 2), (3, 48, 24, True, True, 1)]
_MNV3_MINIMAL = [(3, 16, 16, False, False, 1), (3, 32, 24, False, False, 2), (3, 48, 24, False, False, 1)]
_EFF_TINY = [("fused", 1, 3, 1, 1, 16), ("fused", 1, 3, 2, 4, 24), ("mb", 2, 3, 2, 4, 32)]
# kind → (its JAX factory, its port factory)
KINDS = {
    "convnext": (jax_convnext((1, 1), (8, 16)), _convnext((1, 1), (8, 16))),
    "mnv3_se_hs": (jax_mobilenet._mnv3(_MNV3_SE_HS, 48, head_width=32), _mnv3(_MNV3_SE_HS, 48, head_width=32)),
    "mnv3_minimal_tf": (
        jax_mobilenet._mnv3(_MNV3_MINIMAL, 48, head_width=32, tf_same=True, bn_eps=1e-3, relu_act=True),
        _mnv3(_MNV3_MINIMAL, 48, head_width=32, tf_same=True, bn_eps=1e-3, relu_act=True)),
    "effv2": (jax_effv2(_EFF_TINY, 16, head_ch=64), _effv2(_EFF_TINY, 16, head_ch=64)),
    "effv2_tf": (jax_effv2(_EFF_TINY, 16, head_ch=64, tf_same=True, bn_eps=1e-3),
                 _effv2(_EFF_TINY, 16, head_ch=64, tf_same=True, bn_eps=1e-3)),
}
FAMILIES = {"convnext": ConvNeXt, "mobilenetv3": MobileNetV3, "efficientnetv2": EfficientNetV2}
REGISTERED = {
    "convnext": ["convnext_tiny", "convnext_small", "convnext_base", "convnext_large"],
    "mobilenetv3": ["mobilenetv3_large_100", "mobilenetv3_small_100", "mobilenetv3_large_075",
                    "tf_mobilenetv3_large_minimal_100"],
    "efficientnetv2": ["efficientnetv2_s", "efficientnetv2_m", "efficientnetv2_l", "tf_efficientnetv2_s",
                       "tf_efficientnetv2_l"],
}
# the optimizer fields of the `hyp:` section of configs/classification/pet_synth.yaml
HYP = {"epochs": 6, "lr0": 0.01, "lrf_ratio": None, "momentum": 0.937, "weight_decay": 0.0005,
       "warmup_momentum": 0.8, "warm_ep": 1, "optimizer": ["sgd", False], "scheduler": "cosine_with_warm"}


@torch.no_grad()
def _pattern_init(module, generator):
    """A cheap stand-in for ``init_params`` in the bridge tests: every tensor
    a distinct arange pattern (torch's CPU ``trunc_normal_`` draws take
    seconds a full-size model), so the round trip checks every transpose."""
    for i, t in enumerate(module.state_dict().values()):
        t.copy_(((torch.arange(t.numel()) + 7 * i) % 251).reshape(t.shape).to(t.dtype))
    return module


def _name(kind):
    return f"cnn_tiny_{kind}_port_test"


@pytest.fixture(scope="module", autouse=True)
def tiny_cnns_registered():
    for kind, (jax_factory, port_factory) in KINDS.items():
        JAX_BACKBONES.register(jax_factory, name=_name(kind))
        BACKBONES.register(port_factory, name=_name(kind))
    yield
    for kind in KINDS:
        del JAX_BACKBONES._store[_name(kind)]
        del BACKBONES._store[_name(kind)]


def _cls_cfg(name, **extra):
    return {"task": "classification", "name": name, "num_classes": CLASSES, "image_size": IMG, "kwargs": {},
            **extra}


_INITS: dict = {}


def _init(jmodel, img=IMG, method=None):
    """The JAX model's variables, initialised under ``jax.jit`` (one compile,
    not one per op), once per model configuration."""
    key = (repr(jmodel), img, getattr(method, "__name__", None))
    if key not in _INITS:
        init = jax.jit(lambda x: jmodel.init(jax.random.key(0), x, train=False, method=method))
        _INITS[key] = init(jnp.zeros((1, img, img, 3)))
    return _INITS[key]


def _apply(jmodel, tree, x, train=False, method=None):
    """The JAX model on ``x`` under ``jax.jit``; in train mode (output, new
    batch statistics)."""
    extra = {"mutable": ["batch_stats"], "rngs": {"dropout": jax.random.key(0)}} if train else {}
    return jax.jit(lambda v, x: jmodel.apply(v, x, train=train, method=method, **extra))(_jax_vars(tree),
                                                                                          jnp.asarray(x))


def _random_tree(variables, seed):
    """Every JAX tensor re-drawn from a numpy seed: kernels at lecun scale
    (fan-in of an HWIO conv or an [in, out] dense), norm scales near 1,
    running variances positive, the rest small."""
    rng = np.random.default_rng(seed)
    tree = {}
    for t in ("params", "batch_stats"):
        flat = {p: np.asarray(v) for p, v in _flatten(dict(variables.get(t, {}))).items()}
        for p, v in flat.items():
            if p.endswith("/kernel"):
                fan_in = int(np.prod(v.shape[:-1]))
                flat[p] = (rng.normal(size=v.shape) / np.sqrt(fan_in)).astype(np.float32)
            elif p.endswith("/var"):
                flat[p] = (0.5 + rng.random(v.shape)).astype(np.float32)
            elif p.endswith("/scale"):
                flat[p] = (1.0 + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
            else:
                flat[p] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
        tree[t] = flat
    return tree


def _jax_vars(tree):
    return {t: jax.tree_util.tree_map(jnp.asarray, _unflatten(flat)) for t, flat in tree.items() if flat}


def _images(seed=1, batch=4, img=IMG):
    return np.random.default_rng(seed).normal(size=(batch, img, img, 3)).astype(np.float32)


def _stats_tree(stats):
    return {p: np.asarray(v) for p, v in _flatten(dict(stats)).items()}


def _assert_stats(model, jax_stats, tree):
    """The port's BN running statistics against a JAX ``batch_stats`` tree."""
    want = state_dict_from_jax(model, {"params": tree["params"], "batch_stats": _stats_tree(jax_stats)})
    got = model.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=RTOL, atol=ATOL, err_msg=k)


# ---------------------------------------------------------------- layers


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("kernel", [1, 2, 3, 5, 7])
def test_tf_same_padding_matches_jax(kernel, stride):
    for h in range(1, 41):
        w = 57 - h
        assert tf_same_padding(h, w, kernel, stride) == jax_mobilenet.tf_same_padding(h, w, kernel, stride)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hard_activations_match_jax(dtype):
    x = np.linspace(-8.0, 8.0, 4097, dtype=np.float32)
    jx, tx = jnp.asarray(x).astype(getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))
    ulp = 0.0 if dtype == "float32" else 2.0**-7
    for port_fn, jax_fn in ((hard_sigmoid, jax_mobilenet.hard_sigmoid), (hard_swish, jax_mobilenet.hard_swish)):
        got, want = port_fn(tx).float().numpy(), np.asarray(jax_fn(jx).astype(jnp.float32))
        np.testing.assert_allclose(got, want, rtol=ulp, atol=ulp * 1e-2)
    assert [make_divisible(v) for v in np.arange(1, 400, 0.75)] == [
        jax_mobilenet._make_divisible(v) for v in np.arange(1, 400, 0.75)]


@pytest.mark.parametrize("flavour", ["mobilenetv3", "efficientnetv2"])
def test_se_block_matches_jax(flavour):
    """MobileNetV3's relu + hard-sigmoid SE and EfficientNetV2's silu +
    sigmoid SE, the JAX Dense kernels as timm-layout 1×1 conv weights."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 5, 5, 24)).astype(np.float32)
    if flavour == "mobilenetv3":
        jse, port = jax_mobilenet.SEBlock(8), SEBlock(24, 8)
    else:
        jse, port = jax_mobilenet.SEBlock(8, act=jax.nn.silu, gate=jax.nn.sigmoid), \
            SEBlock(24, 8, act=F.silu, gate=torch.sigmoid)
    tree = _random_tree(jse.init(jax.random.key(0), jnp.asarray(x)), seed=4)["params"]
    with torch.no_grad():
        for conv, fc in ((port.conv_reduce, "fc1"), (port.conv_expand, "fc2")):
            conv.weight.copy_(torch.from_numpy(tree[f"{fc}/kernel"].T[:, :, None, None].copy()))
            conv.bias.copy_(torch.from_numpy(tree[f"{fc}/bias"]))
        out = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    ref = jse.apply({"params": _unflatten(tree)}, jnp.asarray(x))
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- models


@pytest.mark.parametrize("kind", list(KINDS))
def test_tiny_cnn_forward_and_batch_stats_match_jax(kind):
    """Eval-mode logits; train-mode logits (batch statistics) and the
    running statistics that forward leaves, against JAX's ``batch_stats``."""
    cfg = _cls_cfg(_name(kind))
    jmodel = jax_get_model(cfg)
    tree = _random_tree(_init(jmodel), seed=len(kind))
    x = _images()
    port = load_jax_params(get_model(cfg, device="cpu"), tree).eval()
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    ref = np.asarray(_apply(jmodel, tree, x))
    assert out.shape == (4, CLASSES) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)

    ref_t, new = _apply(jmodel, tree, x, train=True)
    port.train()
    with torch.no_grad():
        out_t = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out_t, np.asarray(ref_t), rtol=RTOL, atol=ATOL)
    if new.get("batch_stats"):
        _assert_stats(port, new["batch_stats"], tree)


@pytest.mark.parametrize("kind", ["mnv3_minimal_tf", "effv2_tf"])
@pytest.mark.parametrize("img", [57, 30])
def test_tf_same_models_at_other_input_sizes_match_jax(kind, img):
    """TF 'SAME' padding follows the input's own size (57: odd at every
    stride; 30: an odd map after the first stride)."""
    cfg = _cls_cfg(_name(kind))
    jmodel = jax_get_model(cfg)
    tree = _random_tree(_init(jmodel), seed=57)
    x = _images(seed=2, batch=2, img=img)
    port = load_jax_params(get_model(cfg, device="cpu"), tree).eval()
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(_apply(jmodel, tree, x)), rtol=RTOL, atol=ATOL)


def _float64(model):
    """The model's parameters, buffers and every layer's compute dtype in
    float64 (the card-vs-CPU comparison's mode in ``chip_smoke.py``)."""
    model.double()
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    return model


@pytest.mark.parametrize("kind", ["convnext", "mnv3_se_hs", "effv2"])
def test_three_train_steps_match_jax(kind):
    """CE with label smoothing 0.05, pet_synth's hyp (SGD, clip, EMA), 2
    steps an epoch so the warm-up ends inside the run; the port and the JAX
    step both in float64 (see the module doc)."""
    cfg = _cls_cfg(_name(kind))
    tree = _random_tree(_init(jax_get_model(cfg)), seed=100 + len(kind))
    port = _float64(load_jax_params(get_model(cfg, device="cpu"), tree))
    theta0 = {k: v.clone() for k, v in port.state_dict().items()}
    tx = build_tx(HYP, 2, True)
    state = create_train_state(port, tx)
    step = make_train_step(port, tx, create_lossfn("ce", label_smooth=0.05), StepConfig(),
                           torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    batches = [{"image": rng.integers(0, 256, size=(4, IMG, IMG, 3), dtype=np.uint8),
                "label": rng.integers(0, CLASSES, size=4).astype(np.int32)} for _ in range(3)]
    with jax.enable_x64(True):
        jmodel = jax_get_model(cfg, dtype=jnp.float64)
        fake = SimpleNamespace(hyp_cfg=HYP, opt_name="sgd", layer_wise=False, model_cfg={})
        jtx = CenterProcessor._build_tx(fake, 2, True)
        jstate = jax_create_train_state(
            {t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), _unflatten(flat))
             for t, flat in tree.items() if flat}, jtx)
        jstep = jax_make_train_step(jmodel, jtx, JL.create_lossfn("ce", label_smooth=0.05), JaxStepConfig(),
                                    jax.random.key(0), donate=False)
        for batch in batches:
            jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.float64(0.0))
            metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
            np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), rtol=1e-5)
        jax_trees = [(port, jstate.params, jstate.batch_stats, "update"),
                     (state.ema_model, jstate.ema_params, jstate.ema_batch_stats, "ema")]
        jax_trees = [(m, _stats_tree(p), _stats_tree(b or {}), w) for m, p, b, w in jax_trees]
    assert state.step == 3 and state.ema_updates == 3
    for module, params, stats, what in jax_trees:
        want = state_dict_from_jax(module, {"params": params, "batch_stats": stats})
        got = module.state_dict()
        for key, value in want.items():
            if key.endswith("num_batches_tracked"):
                continue
            if key.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got[key].numpy(), value.numpy(), rtol=RTOL, atol=ATOL,
                                           err_msg=f"{what} {key}")
                continue
            got_d, want_d = (got[key] - theta0[key]).double().numpy(), (value - theta0[key]).double().numpy()
            assert np.abs(want_d).max() > 0, (what, key)
            # the port's EMA shadow is f32 (init_ema), the float64 reference's is not
            spacing = np.sqrt(want_d.size) * np.spacing(np.float32(np.abs(theta0[key].numpy()).max()))
            err = np.linalg.norm(got_d - want_d)
            assert err <= 1e-3 * np.linalg.norm(want_d) + 3 * spacing, (what, key, err, np.linalg.norm(want_d))


@pytest.mark.parametrize("kind", ["mnv3_se_hs", "effv2_tf"])
def test_bn_eval_trains_on_the_running_statistics_as_jax(kind):
    """``bn_freeze: true`` (``bn_eval``): train mode normalises with the
    running statistics and leaves them as they are."""
    cfg = _cls_cfg(_name(kind), bn_freeze=True)
    jmodel = jax_get_model({**cfg, "kwargs": {"bn_eval": True}})
    tree = _random_tree(_init(jmodel), seed=5)
    x = _images()
    port = load_jax_params(get_model(cfg, device="cpu"), tree).train()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    ref, _ = _apply(jmodel, tree, x, train=True)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=RTOL, atol=ATOL)
    for key, value in port.state_dict().items():
        assert torch.equal(value, before[key]), key


def _jax_layer_wise_heads(params) -> set:
    """The flax paths the JAX ``layer_wise`` transform boosts: an SGD at lr 1
    on unit gradients moves them by −10, the rest by −1."""
    tx = jax_layer_wise(lambda s: optax.sgd(s), lambda t: 1.0, params)
    updates = jax.jit(lambda p: tx.update(jax.tree_util.tree_map(jnp.ones_like, p), tx.init(p), p)[0])(params)
    return {p for p, u in _flatten(dict(updates)).items() if np.all(np.asarray(u) == -10.0)}


@pytest.mark.parametrize("bare", [False, True], ids=["vision_model", "bare_backbone"])
@pytest.mark.parametrize("kind", ["convnext", "mnv3_se_hs", "effv2"])
def test_freeze_masks_and_layer_wise_labels_are_the_jax_ones(kind, bare):
    """``backbone_freeze`` (MobileNetV3's ``pre_head`` and ``fc`` are head;
    ConvNeXt's ``head_norm`` is backbone), ``bn_freeze_affine`` and the
    layer-wise lr boost, on the classification model and on the bare
    backbone, as the JAX masks label the JAX tree."""
    if bare:
        jmodel, port = JAX_BACKBONES.create(_name(kind), num_classes=CLASSES), BACKBONES.create(
            _name(kind), num_classes=CLASSES, img_size=IMG)
    else:
        jmodel, port = jax_get_model(_cls_cfg(_name(kind))), get_model(_cls_cfg(_name(kind)), device="cpu")
    params = _init(jmodel)["params"]
    paths = param_paths(port)
    assert set(paths.values()) == set(_flatten(dict(params)))
    lr = lambda c: 1.0  # noqa: E731
    for opts in ({"backbone_freeze": True}, {"bn_freeze_affine": True}):
        labels = jax_freeze_mask(**opts)(params)
        want = {p for p, lab in _flatten(dict(labels)).items() if lab == "frozen"}
        trainable = create_optimizer("sgd", lr, 0.0, lr, **opts).labels(port)
        assert {paths[n] for n in paths if n not in trainable} == want, opts
        assert want or (kind == "convnext" and "bn_freeze_affine" in opts)  # ConvNeXt has no BatchNorm
    boosted = create_optimizer("sgd", lr, 0.0, lr, layer_wise_lr=True).labels(port)
    assert {paths[n] for n, m in boosted.items() if m == 10.0} == _jax_layer_wise_heads(params)
    heads = {p.split("/")[-2] for p, lab in _flatten(dict(jax_freeze_mask(backbone_freeze=True)(params))).items()
             if lab == "train"}
    assert heads == {"convnext": {"head"}, "mnv3_se_hs": {"pre_head", "fc"}, "effv2": {"fc"}}[kind]


@pytest.mark.parametrize("kind", ["convnext", "mnv3_se_hs"])
def test_embedding_neck_on_the_map_matches_jax(kind):
    """The CNN-map neck on an unpooled ConvNeXt / MobileNetV3: BatchNorm
    over the NHWC map, flatten in NHWC order, Dense, BatchNorm1d;
    embeddings in eval and train mode, and the running statistics."""
    cfg = {"task": "cbir", "backbone": {_name(kind): {"feat_dim": 16, "image_size": 64}}}
    jmodel = jax_get_model(cfg)
    tree = _random_tree(_init(jmodel, img=64, method=jmodel.embed), seed=9)
    x = _images(batch=6, img=64)
    port = load_jax_params(get_model(cfg, device="cpu"), tree)
    assert port.backbone.feature_shape == {"convnext": (8, 8, 16), "mnv3_se_hs": (8, 8, 48)}[kind]
    port.eval()
    with torch.no_grad():
        out = port.embed(torch.from_numpy(x)).numpy()
    ref = _apply(jmodel, tree, x, method=jmodel.embed)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=RTOL, atol=ATOL)
    ref_t, new = _apply(jmodel, tree, x, train=True, method=jmodel.embed)
    port.train()
    with torch.no_grad():
        out_t = port.embed(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out_t, np.asarray(ref_t), rtol=RTOL, atol=ATOL)
    _assert_stats(port, new["batch_stats"], tree)


@pytest.mark.parametrize("name", [n for names in REGISTERED.values() for n in names])
def test_bridge_is_strict_both_ways_on_every_registered_name(name, monkeypatch):
    """Every registered name builds through ``get_model(device="cpu")``
    (random draws replaced by ``_pattern_init``); its state dict goes
    through the JAX package's ``convert_state_dict`` strictly (timm names
    and shapes) and gives the JAX model's tree, whose paths and shapes
    ``jax.eval_shape`` gives; that tree goes back through the port's
    bridge, strictly, to the same state dict; the optimizer's flax paths
    are the tree's."""
    family = next(f for f, names in REGISTERED.items() if name in names)
    cfg = _cls_cfg(name)
    monkeypatch.setattr(factory, "init_params", _pattern_init)
    port = get_model(cfg, device="cpu")
    assert isinstance(port.backbone, FAMILIES[family])
    shapes = jax.eval_shape(lambda: _init(jax_get_model(cfg)))
    sd = {k[len("backbone."):]: v for k, v in port.state_dict().items()}
    back = convert_state_dict(sd, name, strict=True)
    for t in ("params", "batch_stats"):
        want = {p: tuple(v.shape) for p, v in _flatten(dict(shapes.get(t, {}))).items()}
        assert {f"backbone/{p}": tuple(v.shape) for p, v in back[t].items()} == want, t
    tree = {t: {f"backbone/{p}": v for p, v in flat.items()} for t, flat in back.items()}
    again = state_dict_from_jax(port, tree)
    for key, value in port.state_dict().items():
        assert torch.equal(again[key], value), key
    assert set(param_paths(port).values()) == set(tree["params"])


def test_model_structure_and_feature_shapes():
    """Widths, depths and the unpooled map of the full-size models (built
    on the meta device), the 'minimal' and TF 'SAME' settings, and the
    timm grouping of MobileNetV3's blocks."""
    with torch.device("meta"):
        cnx = BACKBONES.create("convnext_base", num_classes=0, unpooled=True, img_size=224)
        mnv3 = BACKBONES.create("mobilenetv3_large_100", num_classes=0, unpooled=True, img_size=224)
        minimal = BACKBONES.create("tf_mobilenetv3_large_minimal_100", num_classes=3, img_size=224)
        eff = BACKBONES.create("tf_efficientnetv2_s", num_classes=0, unpooled=True, img_size=224)
    assert cnx.feature_shape == (7, 7, 1024) and cnx.head is None
    assert [len(s.blocks) for s in cnx.stages] == [3, 3, 27, 3]
    assert cnx.stages[0].blocks[0].norm.eps == 1e-6 and cnx.stages[1].downsample[0].eps == 1e-6
    assert mnv3.feature_shape == (7, 7, 960) and mnv3.conv_head is None
    assert [len(g) for g in mnv3.blocks] == [1, 2, 3, 4, 2, 3, 1]
    assert minimal.bn1.eps == 1e-3 and minimal.conv_stem.tf_same and minimal.act is F.relu
    assert all(m.se is None for g in minimal.blocks[:-1] for m in g)
    assert eff.feature_shape == (7, 7, 1280) and eff.bn1.eps == 1e-3
    assert [len(g) for g in eff.blocks] == [2, 4, 4, 6, 9, 15]
