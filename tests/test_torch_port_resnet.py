"""The port's ResNet family (``visiondk_tpu_torch/models/backbones/resnet.py``)
and its CNN layers against the JAX package's.

Setup: one tiny ResNet per block kind, ``stage_sizes`` [1, 1, 1, 1] (basic;
bottleneck with groups 2 and base width 32; bottleneck with SE; bottleneck
with the resnet-d deep stem and avg-down shortcut; ResNeSt with radix 4,
cardinality 2, width 40 and the deep stem), registered in both packages'
registries by this file, at 32×32 with 5 classes. Every JAX tensor is drawn
from a numpy seed (conv and dense kernels at lecun scale, BN scales near 1,
running variances positive) and carried into the port by the weight bridge;
inputs are numpy-seeded too. One full registry model (resnet18) runs its
eval forward. The bridge is checked strictly (both ways, every shape) on all
ten registered names through ``jax.eval_shape``.

Tolerances (f32 on both sides, other summation orders): forward logits,
embeddings and BN running statistics rtol 1e-3, atol 3e-4, as the other
model tests. Three train steps, the port in f32 against the JAX step run
in float64 (``jax.enable_x64``, the JAX model at ``dtype`` float64): the
loss of every step within 1e-5 relative; every update and EMA update
within 1e-3 of its tensor's norm (‖Δ − Δ_ref‖ ≤ 1e-3·‖Δ_ref‖, plus one f32
spacing of the tensor a step and entry: the port rounds θ to f32 at every
step, the float64 reference does not, and an update of a BN scale near 1
resolves no finer; entry by entry, BN at 4 samples a channel leaves single
entries several spacings off); running statistics at the forward bars. The JAX reference runs in float64 because its f32 run on the
CPU is the less exact of the two: ResNeSt's step-3 loss 5.4e-4 from
float64 (the port's f32 1.9e-6), and gradients behind a grouped
convolution up to 9% of a tensor's largest entry (the port's 2e-4).
BatchNorm2d alone: f32 rtol 1e-5, atol 1e-5; with bf16 inputs its output
within one bf16 ulp (2⁻⁷ relative) and its statistics within 1e-5.
"""

from types import SimpleNamespace

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visiondk_tpu.engine.optim import freeze_mask as jax_freeze_mask
from visiondk_tpu.engine.state import create_train_state as jax_create_train_state
from visiondk_tpu.engine.steps import StepConfig as JaxStepConfig
from visiondk_tpu.engine.steps import make_train_step as jax_make_train_step
from visiondk_tpu.engine.trainer import CenterProcessor
from visiondk_tpu.losses import losses as JL
from visiondk_tpu.models import get_model as jax_get_model
from visiondk_tpu.models.backbones import BACKBONES as JAX_BACKBONES
from visiondk_tpu.models.backbones.resnet import _resnet as jax_resnet
from visiondk_tpu.models.convert import _flatten, _unflatten
from visiondk_tpu.models.layers import SqueezeExcite as JaxSqueezeExcite
from visiondk_tpu_torch.engine.optim import create_optimizer
from visiondk_tpu_torch.engine.state import create_train_state
from visiondk_tpu_torch.engine.steps import StepConfig, make_train_step
from visiondk_tpu_torch.engine.trainer import build_tx
from visiondk_tpu_torch.losses import create_lossfn
from visiondk_tpu_torch.models import BACKBONES, get_model
from visiondk_tpu_torch.models.backbones.resnet import ResNet, _resnet
from visiondk_tpu_torch.models.convert import load_jax_params, param_paths, state_dict_from_jax
from visiondk_tpu_torch.models.layers import BatchNorm2d, SqueezeExcite

RTOL, ATOL = 1e-3, 3e-4
IMG, CLASSES = 32, 5
# block kind → the ResNet arguments of its tiny variant
KINDS = {
    "basic": ("basic", {}),
    "bottleneck_groups": ("bottleneck", {"groups": 2, "base_width": 32}),
    "se": ("bottleneck", {"use_se": True}),
    "deep_stem_avg_down": ("bottleneck", {"deep_stem": True, "avg_down": True}),
    "resnest": ("resnest", {"radix": 4, "groups": 2, "base_width": 40, "deep_stem": True}),
}
REGISTERED = ["resnet18", "resnet34", "resnet50", "resnet101", "resnet152", "resnet50d", "wide_resnet101_2",
              "resnext50_32x4d", "legacy_seresnet50", "resnest50d_4s2x40d"]
# the optimizer fields of the `hyp:` section of configs/classification/multilabel_csv.yaml
HYP = {"epochs": 20, "lr0": 0.01, "lrf_ratio": None, "momentum": 0.937, "weight_decay": 0.0005,
       "warmup_momentum": 0.8, "warm_ep": 1, "optimizer": ["sgd", False], "scheduler": "cosine_with_warm"}


def _name(kind):
    return f"resnet_tiny_{kind}_port_test"


@pytest.fixture(scope="module", autouse=True)
def tiny_resnets_registered():
    for kind, (block, kw) in KINDS.items():
        JAX_BACKBONES.register(jax_resnet([1, 1, 1, 1], block, **kw), name=_name(kind))
        BACKBONES.register(_resnet([1, 1, 1, 1], block, **kw), name=_name(kind))
    yield
    for kind in KINDS:
        del JAX_BACKBONES._store[_name(kind)]
        del BACKBONES._store[_name(kind)]


def _cls_cfg(name, kwargs=None, **extra):
    return {"task": "classification", "name": name, "num_classes": CLASSES, "image_size": IMG,
            "kwargs": dict(kwargs or {}), **extra}


def _init(jmodel, *args, **kwargs):
    return jmodel.init(jax.random.key(0), *args, train=False, **kwargs)


def _random_tree(variables, seed):
    """Every JAX tensor re-drawn from a numpy seed: kernels at lecun scale
    (fan-in of an HWIO conv or an [in, out] dense), BN scales near 1,
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


def _images(seed=1, batch=4):
    return np.random.default_rng(seed).normal(size=(batch, IMG, IMG, 3)).astype(np.float32)


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_batchnorm2d_matches_flax(dtype, train):
    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 2.0, size=(4, 5, 6, 8)).astype(np.float32)  # NHWC
    scale = (1 + 0.1 * rng.normal(size=8)).astype(np.float32)
    bias = (0.1 * rng.normal(size=8)).astype(np.float32)
    mean, var = (0.1 * rng.normal(size=8)).astype(np.float32), (0.5 + rng.random(8)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    bn = fnn.BatchNorm(use_running_average=not train, momentum=0.9, dtype=jdt)
    jx = jnp.asarray(x).astype(jdt)
    ref, new = bn.apply({"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean, "var": var}},
                        jx, mutable=["batch_stats"])
    port = BatchNorm2d(8, dtype=tdt)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
        port.running_mean.copy_(torch.from_numpy(mean))
        port.running_var.copy_(torch.from_numpy(var))
    port.train(train)
    with torch.no_grad():
        out = port(torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 2.0**-7
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)), rtol=tol, atol=tol)
    for buf, key in ((port.running_mean, "mean"), (port.running_var, "var")):
        assert buf.dtype == torch.float32
        np.testing.assert_allclose(buf.numpy(), np.asarray(new["batch_stats"][key]), rtol=1e-5, atol=1e-5)


def test_batchnorm2d_bn_eval_uses_and_keeps_the_running_statistics():
    bn = BatchNorm2d(3, bn_eval=True).train()
    with torch.no_grad():
        bn.running_var.fill_(4.0)
        x = torch.randn(2, 3, 4, 4, generator=torch.Generator().manual_seed(0))
        out = bn(x)
    torch.testing.assert_close(out, x / np.sqrt(4.0 + 1e-5), rtol=1e-6, atol=1e-6)
    assert bn.running_mean.abs().max() == 0 and (bn.running_var == 4.0).all() and bn.num_batches_tracked == 0


def test_squeeze_excite_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 4, 4, 32)).astype(np.float32)
    se = JaxSqueezeExcite()
    tree = _random_tree(se.init(jax.random.key(0), jnp.asarray(x)), seed=3)
    ref = se.apply(_jax_vars(tree), jnp.asarray(x))
    port = load_jax_params(SqueezeExcite(32), tree)
    with torch.no_grad():
        out = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------- models


@pytest.mark.parametrize("kind", list(KINDS))
def test_tiny_resnet_forward_and_batch_stats_match_jax(kind):
    """Eval-mode logits; train-mode logits (batch statistics) and the
    running statistics that forward leaves, against JAX's ``batch_stats``."""
    cfg = _cls_cfg(_name(kind))
    jmodel = jax_get_model(cfg)
    tree = _random_tree(_init(jmodel, jnp.zeros((1, IMG, IMG, 3))), seed=len(kind))
    x = _images()
    port = load_jax_params(get_model(cfg, device="cpu"), tree)
    port.eval()
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    ref = np.asarray(jmodel.apply(_jax_vars(tree), jnp.asarray(x), train=False))
    assert out.shape == (4, CLASSES) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)

    ref_t, new = jmodel.apply(_jax_vars(tree), jnp.asarray(x), train=True, mutable=["batch_stats"],
                              rngs={"dropout": jax.random.key(0)})
    port.train()
    with torch.no_grad():
        out_t = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out_t, np.asarray(ref_t), rtol=RTOL, atol=ATOL)
    _assert_stats(port, new["batch_stats"], tree)


def test_resnet18_from_the_registry_matches_jax():
    cfg = _cls_cfg("resnet18")
    jmodel = jax_get_model(cfg)
    tree = _random_tree(_init(jmodel, jnp.zeros((1, IMG, IMG, 3))), seed=18)
    x = _images(batch=2)
    port = load_jax_params(get_model(cfg, device="cpu"), tree).eval()
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jmodel.apply(_jax_vars(tree), jnp.asarray(x), train=False)),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", list(KINDS))
def test_three_train_steps_match_jax(kind):
    """BCE on multi-hot targets, the multilabel_csv hyp (SGD, clip, EMA), 2
    steps an epoch so the warm-up ends inside the run; the port in f32, the
    JAX step in float64 (see the module doc)."""
    cfg = _cls_cfg(_name(kind))
    tree = _random_tree(_init(jax_get_model(cfg), jnp.zeros((1, IMG, IMG, 3))), seed=100 + len(kind))
    port = load_jax_params(get_model(cfg, device="cpu"), tree)
    theta0 = {k: v.clone() for k, v in port.state_dict().items()}
    tx = build_tx(HYP, 2, True)
    state = create_train_state(port, tx)
    step = make_train_step(port, tx, create_lossfn("bce"), StepConfig(), torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    batches = [{"image": rng.integers(0, 256, size=(4, IMG, IMG, 3), dtype=np.uint8),
                "label": (rng.random((4, CLASSES)) < 0.4).astype(np.float32)} for _ in range(3)]
    with jax.enable_x64(True):
        jmodel = jax_get_model(cfg, dtype=jnp.float64)
        fake = SimpleNamespace(hyp_cfg=HYP, opt_name="sgd", layer_wise=False, model_cfg={})
        jtx = CenterProcessor._build_tx(fake, 2, True)
        jstate = jax_create_train_state(
            {t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), _unflatten(flat))
             for t, flat in tree.items()}, jtx)
        jstep = jax_make_train_step(jmodel, jtx, JL.create_lossfn("bce"), JaxStepConfig(), jax.random.key(0),
                                    donate=False)
        for batch in batches:
            jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.float64(0.0))
            metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
            np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), rtol=1e-5)
        jax_trees = [(port, jstate.params, jstate.batch_stats, "update"),
                     (state.ema_model, jstate.ema_params, jstate.ema_batch_stats, "ema")]
        jax_trees = [(m, _stats_tree(p), _stats_tree(b), w) for m, p, b, w in jax_trees]
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
            # the port rounds θ to f32 at each of the 3 steps, the float64 reference never
            spacing = np.sqrt(want_d.size) * np.spacing(np.abs(theta0[key].numpy()).max())
            err = np.linalg.norm(got_d - want_d)
            assert err <= 1e-3 * np.linalg.norm(want_d) + 3 * spacing, (what, key, err, np.linalg.norm(want_d))


def test_bn_eval_trains_on_the_running_statistics_as_jax():
    """``bn_freeze: true`` (``bn_eval``): train mode normalises with the
    running statistics and leaves them as they are."""
    cfg = _cls_cfg(_name("deep_stem_avg_down"), bn_freeze=True)
    jmodel = jax_get_model({**cfg, "kwargs": {"bn_eval": True}})
    tree = _random_tree(_init(jmodel, jnp.zeros((1, IMG, IMG, 3))), seed=5)
    x = _images()
    port = load_jax_params(get_model(cfg, device="cpu"), tree).train()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    ref, new = jmodel.apply(_jax_vars(tree), jnp.asarray(x), train=True, mutable=["batch_stats"])
    np.testing.assert_allclose(out, np.asarray(ref), rtol=RTOL, atol=ATOL)
    for key, value in port.state_dict().items():
        assert torch.equal(value, before[key]), key
    np.testing.assert_allclose(out, port.eval()(torch.from_numpy(x)).detach().numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["se", "deep_stem_avg_down", "resnest"])
def test_bn_freeze_affine_freezes_what_the_jax_mask_freezes(kind):
    cfg = _cls_cfg(_name(kind))
    variables = _init(jax_get_model(cfg), jnp.zeros((1, IMG, IMG, 3)))
    labels = jax_freeze_mask(bn_freeze_affine=True)(variables["params"])
    want = {p for p, lab in _flatten(dict(labels)).items() if lab == "frozen"}
    port = get_model(cfg, device="cpu")
    spec = create_optimizer("sgd", lambda c: 0.1, 0.0, lambda c: 0.9, bn_freeze_affine=True)
    paths = param_paths(port)
    got = {paths[n] for n in paths if n not in spec.labels(port)}
    assert got == want
    assert any("/stem_bn" in p for p in got) and any("/down_bn/" in p for p in got)
    if kind == "resnest":
        assert any("/bn0/" in p for p in got)


def test_embedding_neck_on_a_cnn_map_matches_jax():
    """The CNN-map branch: BatchNorm over the NHWC map, flatten in NHWC order,
    Dense, BatchNorm1d; embeddings in eval and train mode, and both BNs'
    running statistics after the train-mode forward."""
    cfg = {"task": "cbir", "backbone": {_name("basic"): {"feat_dim": 16, "image_size": IMG}}}
    jmodel = jax_get_model(cfg)
    tree = _random_tree(_init(jmodel, jnp.zeros((1, IMG, IMG, 3)), method=jmodel.embed), seed=9)
    x = _images(batch=6)
    port = load_jax_params(get_model(cfg, device="cpu"), tree)
    assert port.backbone.feature_shape == (1, 1, 512)
    port.eval()
    with torch.no_grad():
        out = port.embed(torch.from_numpy(x)).numpy()
    ref = jmodel.apply(_jax_vars(tree), jnp.asarray(x), train=False, method=jmodel.embed)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=RTOL, atol=ATOL)
    ref_t, new = jmodel.apply(_jax_vars(tree), jnp.asarray(x), train=True, method=jmodel.embed,
                              mutable=["batch_stats"], rngs={"dropout": jax.random.key(0)})
    port.train()
    with torch.no_grad():
        out_t = port.embed(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out_t, np.asarray(ref_t), rtol=RTOL, atol=ATOL)
    _assert_stats(port, new["batch_stats"], tree)
    assert "neck.norm.running_var" in port.state_dict()


def test_embedding_neck_flattens_a_larger_cnn_map_in_nhwc_order():
    """At 64² the map is 2×2: the Dense kernel's rows follow NHWC order."""
    cfg = {"task": "cbir", "backbone": {_name("basic"): {"feat_dim": 8, "image_size": 64}}}
    jmodel = jax_get_model(cfg)
    tree = _random_tree(_init(jmodel, jnp.zeros((1, 64, 64, 3)), method=jmodel.embed), seed=11)
    x = np.random.default_rng(3).normal(size=(2, 64, 64, 3)).astype(np.float32)
    port = load_jax_params(get_model(cfg, device="cpu"), tree).eval()
    assert port.backbone.feature_shape == (2, 2, 512)
    with torch.no_grad():
        out = port.embed(torch.from_numpy(x)).numpy()
    ref = jmodel.apply(_jax_vars(tree), jnp.asarray(x), train=False, method=jmodel.embed)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", REGISTERED)
def test_bridge_is_strict_on_every_registered_resnet(name):
    """Every port tensor has a JAX source of its shape and every JAX tensor
    a port target (state_dict_from_jax raises otherwise); the optimizer's
    flax paths are the JAX tree's."""
    cfg = _cls_cfg(name)
    jmodel = jax_get_model(cfg)
    shapes = jax.eval_shape(lambda: _init(jmodel, jnp.zeros((1, IMG, IMG, 3))))
    tree = {t: {p: np.zeros(v.shape, np.float32) for p, v in _flatten(dict(shapes[t])).items()} for t in shapes}
    port = get_model(cfg, device="cpu")
    assert isinstance(port.backbone, ResNet)
    state_dict_from_jax(port, tree)
    assert set(param_paths(port).values()) == set(tree["params"])
