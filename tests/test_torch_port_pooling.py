"""The port's attention pools against the JAX package: ViT's ``pool="map"``
(SigLIP's ``AttentionPoolLatent``, head dim 72 as in
vit_so400m_patch14_siglip_224) and ``VisionModel(attention_pool=True)``
(``AttentionPooling`` over a ViT's token map with its CLS row, a Swin's token
map and a ResNet's NHWC map), and the weight bridge's rules for them.

Both packages build each model from the same ``model:`` config dict; the
JAX parameters, re-drawn from a numpy seed, are carried into the port by
``load_jax_params``, and both see the same numpy-seeded images. Logits are
compared in f32 at rtol 1e-3, atol 3e-4 (the JAX package's pretrained-import
golden tolerance, as ``test_torch_port_vit.py``). Bridge round trips,
freeze labels and layer-wise labels are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from visiondk_tpu.engine.optim import freeze_mask as jax_freeze_mask
from visiondk_tpu.engine.optim import layer_wise as jax_layer_wise
from visiondk_tpu.models import get_model as jax_get_model
from visiondk_tpu.models.backbones import BACKBONES as JAX_BACKBONES
from visiondk_tpu.models.backbones.resnet import _resnet as jax_resnet
from visiondk_tpu.models.backbones.swin import _swin as jax_swin
from visiondk_tpu.models.backbones.vit import _vit as jax_vit
from visiondk_tpu.models.convert import _flatten, _unflatten, convert_vit
from visiondk_tpu_torch.engine.optim import create_optimizer
from visiondk_tpu_torch.models import BACKBONES, get_model
from visiondk_tpu_torch.models.backbones.resnet import _resnet
from visiondk_tpu_torch.models.backbones.swin import _swin
from visiondk_tpu_torch.models.backbones.vit import _vit
from visiondk_tpu_torch.models.convert import load_jax_params, param_paths, state_dict_from_jax
from visiondk_tpu_torch.models.layers import AttentionPooling, AttentionPoolLatent, init_params

RTOL, ATOL = 1e-3, 3e-4
CLASSES = 6
SO400M_RATIO = 4304 / 1152
# name → (JAX factory, port factory, image size): a tiny SigLIP-style ViT (no CLS,
# map pooling, width 144 over 2 heads: head dim 72), a tiny CLS ViT, a tiny Swin
# and a tiny ResNet
TINY = {
    "map_vit": ("vit_tiny_map_port_pool_test", (4, 144, 2, 2), dict(mlp_ratio=SO400M_RATIO, class_token=False,
                                                                    pool="map"), 16),
    "vit": ("vit_tiny_port_pool_test", (8, 64, 2, 4), {}, 32),
    "swin": ("swin_tiny_port_pool_test", (16, (2, 2), (2, 4)), dict(window_size=4), 32),
    "resnet": ("resnet_tiny_port_pool_test", ([1, 1, 1, 1], "basic"), {}, 64),
}
_FACTORIES = {"map_vit": (jax_vit, _vit), "vit": (jax_vit, _vit), "swin": (jax_swin, _swin),
              "resnet": (jax_resnet, _resnet)}


@pytest.fixture(scope="module", autouse=True)
def tiny_models_registered():
    for kind, (name, args, kwargs, _) in TINY.items():
        jax_factory, port_factory = _FACTORIES[kind]
        JAX_BACKBONES.register(jax_factory(*args, **kwargs), name=name)
        BACKBONES.register(port_factory(*args, **kwargs), name=name)
    yield
    for name, *_ in TINY.values():
        del JAX_BACKBONES._store[name]
        del BACKBONES._store[name]


def _cfg(kind, attention_pool=False):
    name, _, _, img = TINY[kind]
    return {"task": "classification", "name": name, "num_classes": CLASSES, "image_size": img,
            "attention_pool": attention_pool}


def _images(img, seed=0, batch=3):
    return np.random.default_rng(seed).normal(size=(batch, img, img, 3)).astype(np.float32)


def _random_tree(variables, seed):
    """Every JAX tensor re-drawn from a numpy seed (norm scales near 1, BN
    variances positive), as flat "/"-path trees."""
    rng = np.random.default_rng(seed)
    tree = {}
    for t in ("params", "batch_stats"):
        flat = {p: np.asarray(v) for p, v in _flatten(dict(variables.get(t, {}))).items()}
        for p, v in flat.items():
            if p.endswith("/var"):
                flat[p] = (0.5 + rng.random(v.shape)).astype(np.float32)
            elif p.endswith("/scale"):
                flat[p] = (1.0 + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
            else:
                flat[p] = (0.3 * rng.normal(size=v.shape)).astype(np.float32)
        tree[t] = flat
    return tree


def _jax_vars(tree):
    return {t: jax.tree_util.tree_map(jnp.asarray, _unflatten(flat)) for t, flat in tree.items() if flat}


def _both(cfg, seed=0):
    jmodel = jax_get_model(cfg)
    img = cfg["image_size"]
    variables = jax.jit(lambda x: jmodel.init(jax.random.key(0), x, train=False))(jnp.zeros((1, img, img, 3)))
    tree = _random_tree(variables, seed)
    port = load_jax_params(get_model(cfg, device="cpu"), tree)
    return jmodel, tree, port


def _logits_match(cfg, seed):
    jmodel, tree, port = _both(cfg, seed)
    x = _images(cfg["image_size"], seed=seed)
    ref = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(_jax_vars(tree), jnp.asarray(x)))
    port.eval()
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    assert out.shape == (3, CLASSES) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    return port


def test_map_pool_vit_logits_match_jax():
    """SigLIP's layout at a tiny size: no CLS row, 16 patch tokens, the
    latent query over 2 heads of 72, the MLP width int(144 · 4304/1152)."""
    port = _logits_match(_cfg("map_vit"), seed=1)
    bb = port.backbone
    assert bb.cls_token is None and isinstance(bb.attn_pool, AttentionPoolLatent)
    assert bb.blocks[0].attn.qkv.weight.shape == (3 * 144, 144) and 144 // bb.attn_pool.num_heads == 72
    assert bb.attn_pool.mlp.fc1.weight.shape == (int(144 * SO400M_RATIO), 144)


@pytest.mark.parametrize("kind", ["vit", "swin", "resnet"])
def test_attention_pool_logits_match_jax(kind):
    """``attention_pool``: the unpooled backbone (ViT's CLS row kept, a Swin's
    token map, a ResNet's NHWC map flattened), ``pool`` in the compute dtype
    and ``fc`` in f32."""
    port = _logits_match(_cfg(kind, attention_pool=True), seed=2)
    assert isinstance(port.pool, AttentionPooling) and port.backbone.num_classes == 0
    assert getattr(port.backbone, "head", None) is None and getattr(port.backbone, "fc", None) is None


# ---------------------------------------------------------------- the bridge


@pytest.mark.parametrize("case", ["map_vit", "map_vit_features", "map_vit_unpooled", "vit_attention_pool",
                                  "swin_attention_pool", "resnet_attention_pool"])
def test_param_paths_are_the_jax_tree(case):
    """The port's parameters map one to one onto the JAX tree's (strictly
    both ways): ``attn_pool/...`` exists only where the flax module creates it
    (not under ``num_classes=0, unpooled=True``), ``pool/...`` and ``fc``
    are the attention pool's top-level keys."""
    kind = case.split("_attention_pool")[0].replace("_features", "").replace("_unpooled", "")
    name, _, _, img = TINY[kind]
    if case.endswith("attention_pool"):
        cfg = _cfg(kind, attention_pool=True)
        jmodel, port = jax_get_model(cfg), get_model(cfg, device="cpu")
    else:
        kwargs = {"map_vit": {}, "map_vit_features": {"num_classes": 0},
                  "map_vit_unpooled": {"num_classes": 0, "unpooled": True}}[case]
        n = kwargs.pop("num_classes", CLASSES)
        jmodel = JAX_BACKBONES.create(name, num_classes=n, **kwargs)
        port = BACKBONES.create(name, num_classes=n, img_size=img, **kwargs)
    variables = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, img, img, 3)), train=False))
    want = set(_flatten(dict(variables["params"])))
    assert set(param_paths(port).values()) == want
    has_pool = any(p.startswith("attn_pool/") for p in want)
    assert has_pool == (case in ("map_vit", "map_vit_features"))
    assert (getattr(port, "attn_pool", None) is not None) == has_pool
    if case.endswith("attention_pool"):
        assert {p.split("/")[0] for p in want} == {"backbone", "pool", "fc"}


@pytest.mark.parametrize("kind", ["map_vit", "vit_attention_pool"])
def test_bridge_round_trip(kind):
    """JAX tree → port state dict → JAX tree, bit for bit; and the JAX
    ``convert_vit`` reads the port ViT's state dict (timm's ``attn_pool.*``
    names) back to the same tree."""
    cfg = _cfg("map_vit") if kind == "map_vit" else _cfg("vit", attention_pool=True)
    _, tree, port = _both(cfg, seed=4)
    sd = port.state_dict()
    paths = param_paths(port)
    assert set(paths.values()) == set(tree["params"])
    pooled = [k for k in paths if k.split(".")[0] in ("pool", "fc") or k.startswith("backbone.attn_pool.")]
    assert pooled
    for k in pooled:  # a Dense kernel [in, out] is the Linear weight transposed; the rest as they are
        v, src = sd[k].numpy(), tree["params"][paths[k]]
        np.testing.assert_array_equal(v.T if paths[k].endswith("/kernel") else v, src, err_msg=k)
    if kind == "map_vit":
        conv = convert_vit(port.backbone.state_dict())
        want = {p[len("backbone/"):]: v for p, v in tree["params"].items()}
        assert sorted(conv["params"]) == sorted(want)
        assert any(p.startswith("attn_pool/") for p in want)
        for p, v in want.items():
            np.testing.assert_array_equal(conv["params"][p], v, err_msg=p)
    again = state_dict_from_jax(port, tree)
    assert all(torch.equal(again[k], v) for k, v in sd.items())


def _jax_layer_wise_heads(params) -> set:
    """The flax paths the JAX ``layer_wise`` transform boosts: an SGD at lr 1
    on unit gradients moves them by −10, the rest by −1."""
    tx = jax_layer_wise(lambda s: optax.sgd(s), lambda t: 1.0, params)
    updates = jax.jit(lambda p: tx.update(jax.tree_util.tree_map(jnp.ones_like, p), tx.init(p), p)[0])(params)
    return {p for p, u in _flatten(dict(updates)).items() if np.all(np.asarray(u) == -10.0)}


@pytest.mark.parametrize("case", ["map_vit", "vit_attention_pool", "resnet_attention_pool"])
def test_freeze_and_layer_wise_labels_are_the_jax_ones(case):
    """``backbone_freeze`` keeps ``pool`` and ``head`` trainable and freezes
    ``attn_pool`` (not a head key); the layer-wise boost takes ``fc`` and a
    backbone's ``head`` only where they are top-level keys: as the JAX masks
    label the JAX tree."""
    cfg = _cfg("map_vit") if case == "map_vit" else _cfg(case.split("_")[0], attention_pool=True)
    jmodel, port = jax_get_model(cfg), get_model(cfg, device="cpu")
    img = cfg["image_size"]
    params = jax.jit(lambda x: jmodel.init(jax.random.key(0), x, train=False))(jnp.zeros((1, img, img, 3)))["params"]
    paths = param_paths(port)
    lr = lambda c: 1.0  # noqa: E731
    labels = jax_freeze_mask(backbone_freeze=True)(params)
    frozen = {p for p, lab in _flatten(dict(labels)).items() if lab == "frozen"}
    trainable = create_optimizer("sgd", lr, 0.0, lr, backbone_freeze=True).labels(port)
    assert {paths[n] for n in paths if n not in trainable} == frozen
    train_keys = {p.split("/")[1] if p.startswith("backbone/") else p.split("/")[0] for p in set(paths.values()) - frozen}
    assert train_keys == ({"head"} if case == "map_vit" else {"pool", "fc"})
    assert any("/attn_pool/" in p for p in frozen) == (case == "map_vit")
    boosted = create_optimizer("sgd", lr, 0.0, lr, layer_wise_lr=True).labels(port)
    heads = _jax_layer_wise_heads(params)
    assert {paths[n] for n, m in boosted.items() if m == 10.0} == heads
    assert heads == (set() if case == "map_vit" else {"fc/kernel", "fc/bias"})


def test_init_draws_the_pools_as_jax_does():
    """``latent`` ~ N(0, C^-1/2), ``probe`` ~ N(0, 0.02), the projections
    lecun-normal with zero biases (the JAX initializers)."""
    model = get_model({**_cfg("vit", attention_pool=True), "num_classes": 3}, device="cpu",
                      generator=torch.Generator().manual_seed(5))
    assert 0.01 < model.pool.probe.std().item() < 0.03 and torch.count_nonzero(model.pool.q.bias) == 0
    latent = AttentionPoolLatent(1152, 16, SO400M_RATIO)
    init_params(latent, torch.Generator().manual_seed(0))
    assert abs(latent.latent.std().item() - 1152**-0.5) < 0.15 * 1152**-0.5
    assert latent.mlp.fc1.weight.shape == (int(1152 * SO400M_RATIO), 1152)
