"""The port's class-activation maps (``visiondk_tpu_torch/utils/cam.py``)
against the JAX package's ``ClassActivationMaper``.

Four tiny classification models are registered in both packages: a ViT with
a class token (its norm1 token map), a Swin (a square token map), a ResNet
with BatchNorm (an NCHW map in ``channels_last`` memory) and a MobileNetV3
with SE blocks (whose 1×1 SE convolutions and ``conv_head`` are JAX Dense
layers, outside FullGrad's set). Every JAX tensor is re-drawn from a numpy
seed and carried into the port by the weight bridge; both sides see the same
numpy-seeded input and a fixed class index. For each of the ten methods the
heat map that goes into the overlay is held to the JAX one within 1e-4 of
its largest value (1e-3 for ``ablationcam``, ``scorecam`` and ``fullgrad``:
the port runs each 64-channel sweep as one batched forward and FullGrad sums
one resized term a layer), and the uint8 overlay within 1 LSB on at least
99% of its pixels. ``gradcampp`` is held at 1e-3 too: its weights
g²/(2g² + Σ A·g³) cancel in the denominator, and on the tiny ViT a gradient
that agrees with JAX's to 7e-7 of its largest entry gives maps 6e-4 apart
(``test_injected_gradient_matches_jax`` holds the gradient itself at 1e-5).
One JAX maper per model serves the nine target-layer methods (its jitted
passes do not depend on the method), one more FullGrad.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import visiondk_tpu.utils.cam as jax_cam
from visiondk_tpu.models import get_model as jax_get_model
from visiondk_tpu.models.backbones import BACKBONES as JAX_BACKBONES
from visiondk_tpu.models.backbones import mobilenet as jax_mobilenet
from visiondk_tpu.models.backbones.resnet import _resnet as jax_resnet
from visiondk_tpu.models.backbones.swin import _swin as jax_swin
from visiondk_tpu.models.backbones.vit import _vit as jax_vit
from visiondk_tpu.models.convert import _flatten, _unflatten
from visiondk_tpu_torch.models import BACKBONES, get_model
from visiondk_tpu_torch.models.backbones.mobilenet import _mnv3
from visiondk_tpu_torch.models.backbones.resnet import _resnet
from visiondk_tpu_torch.models.backbones.swin import _swin
from visiondk_tpu_torch.models.backbones.vit import _vit
from visiondk_tpu_torch.models.convert import load_jax_params
from visiondk_tpu_torch.utils import cam as port_cam

CLASSES = 5
CLASS_IDX = 3
DISPLAY = (40, 36)  # the display image's (h, w): the heat map is resized to it
PERTURB_TOL = 1e-3
GRAD_TOL = 1e-4
_MNV3_SE_HS = [(3, 16, 16, True, False, 2), (5, 32, 24, True, True, 2), (3, 48, 24, True, True, 1)]
# kind → (registered name, JAX factory, port factory, image size)
TINY = {
    "vit": ("vit_tiny_port_cam_test", jax_vit(8, 64, 2, 4), _vit(8, 64, 2, 4), 32),
    "swin": ("swin_tiny_port_cam_test", jax_swin(16, (2, 2), (2, 4), window_size=4),
             _swin(16, (2, 2), (2, 4), window_size=4), 32),
    "resnet": ("resnet_tiny_port_cam_test", jax_resnet([1, 1, 1, 1], "basic"), _resnet([1, 1, 1, 1], "basic"), 64),
    "mobilenet": ("mobilenetv3_tiny_port_cam_test", jax_mobilenet._mnv3(_MNV3_SE_HS, 48, head_width=32),
                  _mnv3(_MNV3_SE_HS, 48, head_width=32), 32),
}


@pytest.fixture(scope="module", autouse=True)
def tiny_models_registered():
    for name, jax_factory, port_factory, _ in TINY.values():
        JAX_BACKBONES.register(jax_factory, name=name)
        BACKBONES.register(port_factory, name=name)
    yield
    for name, *_ in TINY.values():
        del JAX_BACKBONES._store[name]
        del BACKBONES._store[name]


def _random_tree(variables, seed):
    """Every JAX tensor re-drawn from a numpy seed: kernels at lecun scale,
    norm scales near 1, running variances positive, the rest small."""
    rng = np.random.default_rng(seed)
    tree = {}
    for t in ("params", "batch_stats"):
        flat = {p: np.zeros(v.shape, np.float32) for p, v in _flatten(dict(variables.get(t, {}))).items()}
        for p, v in flat.items():
            if p.endswith("/kernel"):
                flat[p] = (rng.normal(size=v.shape) / np.sqrt(np.prod(v.shape[:-1]))).astype(np.float32)
            elif p.endswith("/var"):
                flat[p] = (0.5 + rng.random(v.shape)).astype(np.float32)
            elif p.endswith("/scale"):
                flat[p] = (1.0 + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
            else:
                flat[p] = (0.3 * rng.normal(size=v.shape)).astype(np.float32)
        tree[t] = flat
    return tree


_MODELS: dict = {}


def _models(kind):
    """(JAX model, its variables, the bridged port model, example, input,
    display image), built once per kind."""
    if kind not in _MODELS:
        name, _, _, img = TINY[kind]
        cfg = {"task": "classification", "name": name, "num_classes": CLASSES, "image_size": img}
        jmodel = jax_get_model(cfg)
        example = jnp.zeros((1, img, img, 3), jnp.float32)
        # shapes only (nothing compiled): every tensor is drawn again from the seed
        variables = jax.eval_shape(lambda x: jmodel.init(jax.random.key(0), x, train=False), example)
        tree = _random_tree(variables, seed=7)
        jvars = {t: jax.tree_util.tree_map(jnp.asarray, _unflatten(flat)) for t, flat in tree.items() if flat}
        port = load_jax_params(get_model(cfg, device="cpu"), tree).eval()
        rng = np.random.default_rng(11)
        x = rng.normal(size=(1, img, img, 3)).astype(np.float32)
        image = rng.integers(0, 256, (*DISPLAY, 3), dtype=np.uint8)
        _MODELS[kind] = (jmodel, jvars, port, np.array(example), x, image)
    return _MODELS[kind]


_JAX_MAPERS: dict = {}


def _traced(fn):
    """A JAX CAM helper (``find_target_path``, ``discover_bias_layers``) with
    its forward traced abstractly over the example (its interceptor records
    paths, shapes and the concrete parameters while tracing) rather than run
    op by op."""

    def traced(model, variables, example, *args, **kwargs):
        found = []
        jax.eval_shape(lambda x: found.append(fn(model, variables, x, *args, **kwargs)) or x, example)
        return found[0]

    return traced


def _jax_maper(kind, method):
    key = (kind, method == "fullgrad")
    if key not in _JAX_MAPERS:
        jmodel, jvars, _, example, _, _ = _models(kind)
        with pytest.MonkeyPatch.context() as mp:
            for helper in ("find_target_path", "discover_bias_layers"):
                mp.setattr(jax_cam, helper, _traced(getattr(jax_cam, helper)))
            _JAX_MAPERS[key] = jax_cam.ClassActivationMaper(
                jmodel, "fullgrad" if method == "fullgrad" else "gradcam", jvars, jnp.asarray(example),
                backbone_name=TINY[kind][0])
    maper = _JAX_MAPERS[key]
    maper.method = method
    return maper


def _jax_heat_and_overlay(kind, method, monkeypatch):
    """The JAX maper's heat map (what ``_finish`` hands to ``overlay_cam``) and overlay."""
    _, _, _, _, x, image = _models(kind)
    seen = []
    real = jax_cam.overlay_cam

    def record(img, cam, *a, **k):
        seen.append(np.asarray(cam))
        return real(img, cam, *a, **k)

    monkeypatch.setattr(jax_cam, "overlay_cam", record)
    overlay = _jax_maper(kind, method)(image=image, input_tensor=x, class_idx=CLASS_IDX)
    return seen[0], overlay


@pytest.mark.parametrize("kind", list(TINY))
@pytest.mark.parametrize("method", port_cam.CAM_METHODS)
def test_cam_matches_jax(kind, method, monkeypatch):
    _, _, port, example, x, image = _models(kind)
    want_heat, want_overlay = _jax_heat_and_overlay(kind, method, monkeypatch)
    maper = port_cam.ClassActivationMaper(port, method, example, backbone_name=TINY[kind][0])
    heat = maper.heatmap(DISPLAY, x, class_idx=CLASS_IDX)
    overlay = port_cam.overlay_cam(image, heat)
    assert heat.shape == DISPLAY and overlay.shape == image.shape and overlay.dtype == np.uint8
    tol = PERTURB_TOL if method in ("ablationcam", "scorecam", "fullgrad", "gradcampp") else GRAD_TOL
    scale = max(float(np.abs(want_heat).max()), 1e-12)
    assert float(np.abs(heat - want_heat).max()) <= tol * scale, (kind, method, np.abs(heat - want_heat).max())
    lsb = np.abs(overlay.astype(np.int16) - want_overlay.astype(np.int16))
    assert lsb.max() <= 255 and (lsb <= 1).mean() >= 0.99, (kind, method, (lsb <= 1).mean())
    if method == "gradcam":  # __call__ is heatmap + overlay_cam
        np.testing.assert_array_equal(maper(image, x, class_idx=CLASS_IDX), overlay)


@pytest.mark.parametrize("kind", list(TINY))
def test_injected_gradient_matches_jax(kind):
    """The captured map and d(score)/d(map) in JAX's layout, against the JAX
    maper's jitted passes (the port's ViT holds 197 tokens where the JAX one
    holds 200: the rows they share)."""
    _, _, port, example, x, _ = _models(kind)
    jm = _jax_maper(kind, "gradcam")
    fj = jm._capture(jm.variables, jnp.asarray(x))
    gj = np.asarray(jm._grad(jm.variables, fj, jnp.asarray(x), jnp.asarray([CLASS_IDX], jnp.int32)))[0]
    fj = np.asarray(fj)[0]
    maper = port_cam.ClassActivationMaper(port, "gradcam", example, backbone_name=TINY[kind][0])
    fp = maper._capture(torch.from_numpy(x))
    gp = port_cam._jax_layout(maper._grad(fp, torch.from_numpy(x), CLASS_IDX))[0]
    fp = port_cam._jax_layout(fp)[0]
    n = len(fp)
    assert fp.shape[1:] == fj.shape[1:] and gp.shape == fp.shape
    np.testing.assert_allclose(fp, fj[:n], rtol=0, atol=1e-5 * np.abs(fj).max())
    np.testing.assert_allclose(gp, gj[:n], rtol=0, atol=1e-5 * np.abs(gj).max())


@pytest.mark.parametrize("kind", list(TINY))
def test_target_path_is_the_jax_one(kind):
    _, _, port, example, _, _ = _models(kind)
    want = _jax_maper(kind, "gradcam").target_path
    assert port_cam.find_target_path(port, torch.from_numpy(example), TINY[kind][0]) == want
    pattern = {"vit": r"block1/norm1$", "swin": r"stage1_block1/norm1$", "resnet": r"stage4_block1$",
               "mobilenet": r"stage\d+_block1$"}[kind]
    assert re.search(pattern, want), want


@pytest.mark.parametrize("kind", list(TINY))
def test_fullgrad_layer_set_is_the_jax_one(kind):
    jmodel, jvars, port, example, _, _ = _models(kind)
    want = _traced(jax_cam.discover_bias_layers)(jmodel, jvars, jnp.asarray(example))
    got = port_cam.discover_bias_layers(port, torch.from_numpy(example))
    assert list(got) == list(want)  # the same layers, in the same call order
    for path, (shape, bias) in want.items():
        assert got[path][0] == shape, path
        np.testing.assert_allclose(got[path][1], bias, rtol=1e-5, atol=1e-6, err_msg=path)
    if kind in ("vit", "swin"):  # the patch-embedding convolution is in, as in JAX
        assert any("patch_embed" in p for p in got)
    if kind == "mobilenet":  # SE's 1×1 convs and conv_head have biases and 4-D outputs, but are JAX Dense
        se = [n for n, m in port.named_modules() if n.endswith(("conv_reduce", "conv_expand", "conv_head"))]
        assert se and all(m.dense for n, m in port.named_modules() if n in se)
        assert not [p for p in got if "/se/" in p or p.endswith("pre_head")]


@pytest.mark.parametrize("src,dst", [((300, 250), (224, 224)), ((7, 7), (224, 224)), ((14, 14), (40, 36))])
@pytest.mark.parametrize("channels", [None, 3])
def test_resize_matches_jax_image_resize(src, dst, channels):
    shape = src if channels is None else (*src, channels)
    arr = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(arr), dst + shape[2:], method="bilinear"))
    got = port_cam.resize_bilinear(arr, dst)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_to_spatial_takes_the_same_grid_from_197_and_200_tokens():
    rng = np.random.default_rng(2)
    tokens = rng.normal(size=(197, 8)).astype(np.float32)
    padded = np.concatenate([tokens, rng.normal(size=(3, 8)).astype(np.float32)])  # the JAX ViT's pad rows
    got = port_cam._to_spatial(tokens, drop_cls=True)
    assert got.shape == (14, 14, 8)
    np.testing.assert_array_equal(got, jax_cam._to_spatial(padded, drop_cls=True))
    np.testing.assert_array_equal(got, tokens[1:].reshape(14, 14, 8))
    square = rng.normal(size=(256, 4)).astype(np.float32)  # So400m: no class token, a 16×16 grid taken whole
    np.testing.assert_array_equal(port_cam._to_spatial(square, drop_cls=True), square.reshape(16, 16, 4))
    np.testing.assert_array_equal(port_cam._to_spatial(square, drop_cls=True),
                                  jax_cam._to_spatial(square, drop_cls=True))


def test_gradient_reaches_the_injected_map_through_the_fused_attention(monkeypatch):
    """The CAM backward runs the attention's autograd Function (the stash
    forward and the backward from P): on the card K1s and K1b."""
    from visiondk_tpu_torch.ops import attention

    calls = {"stash": 0, "bwd": 0}
    stash, bwd = attention.fused_qkv_attention_fwd_stash, attention.fused_qkv_attention_bwd_from_p

    def counted_stash(*a, **k):
        calls["stash"] += 1
        return stash(*a, **k)

    def counted_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(attention, "fused_qkv_attention_fwd_stash", counted_stash)
    monkeypatch.setattr(attention, "fused_qkv_attention_bwd_from_p", counted_bwd)
    _, _, port, example, x, _ = _models("vit")
    flags = [p.requires_grad for p in port.parameters()]
    maper = port_cam.ClassActivationMaper(port, "gradcam", example, backbone_name=TINY["vit"][0])
    maper.cam(x, class_idx=CLASS_IDX)
    # the target is the last block's norm1: one attention after it
    assert calls == {"stash": 1, "bwd": 1}
    assert [p.requires_grad for p in port.parameters()] == flags  # the parameters are given back as they were
    with pytest.raises(ValueError):
        port_cam.ClassActivationMaper(port, "gradcam_typo", example)
