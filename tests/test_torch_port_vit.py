"""visiondk_tpu_torch's ViT, factory and weight bridge against the JAX package.

A tiny ViT (patch 8, width 64, depth 2, 4 heads) on 32×32 images has
N = 16 + 1 = 17 tokens; the JAX model pads them to 24 and masks the pad keys,
the port runs 17. Both packages build it from the same ``model:`` config dict
through their own ``get_model``; the JAX parameters, re-drawn from a numpy
seed, are bridged into the port, and both see the same inputs. Logits and
embeddings are compared in f32 at rtol 1e-3, atol 3e-4 (the tolerance of the
JAX package's pretrained-import goldens).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visiondk_tpu.models import get_model as jax_get_model
from visiondk_tpu.models.backbones import BACKBONES as JAX_BACKBONES
from visiondk_tpu.models.backbones.vit import _vit as jax_vit
from visiondk_tpu.models.convert import _flatten, _unflatten, convert_vit, save_converted
from visiondk_tpu_torch.models import BACKBONES, VisionModel, get_model
from visiondk_tpu_torch.models.backbones.vit import VisionTransformer, _vit
from visiondk_tpu_torch.models.convert import load_converted, load_jax_params, state_dict_from_jax

TINY = "vit_tiny_patch8_port_test"
IMG = 32
RTOL, ATOL = 1e-3, 3e-4
VARIANTS = {
    "cls": {},
    "mean_pool": {"pool": "mean"},
    "layerscale": {"init_values": 0.1},
    "no_class_token": {"class_token": False},
}


@pytest.fixture(scope="module", autouse=True)
def tiny_vit_registered():
    """Register the tiny ViT in both registries for this module only."""
    JAX_BACKBONES.register(jax_vit(8, 64, 2, 4), name=TINY)
    BACKBONES.register(_vit(8, 64, 2, 4), name=TINY)
    yield
    del JAX_BACKBONES._store[TINY]
    del BACKBONES._store[TINY]


def _cls_cfg(kwargs):
    return {"task": "classification", "name": TINY, "num_classes": 10, "image_size": IMG,
            "kwargs": dict(kwargs)}


def _cbir_cfg():
    return {"task": "cbir", "backbone": {TINY: {"feat_dim": 16, "image_size": IMG}}}


def _images(seed=0, batch=3):
    return np.random.default_rng(seed).normal(size=(batch, IMG, IMG, 3)).astype(np.float32)


def _random_tree(variables, seed):
    """Every JAX tensor re-drawn from a numpy seed (LayerNorm/BN scales near 1,
    BN variances positive), as flat "/"-path trees."""
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
                flat[p] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
        tree[t] = flat
    return tree


def _jax_vars(tree):
    return {t: jax.tree_util.tree_map(jnp.asarray, _unflatten(flat)) for t, flat in tree.items() if flat}


def _jax_classifier(kwargs, seed=0):
    model = jax_get_model(_cls_cfg(kwargs))
    variables = model.init(jax.random.key(0), jnp.zeros((1, IMG, IMG, 3)), train=False)
    return model, _random_tree(variables, seed)


def _jax_embedder(seed=0):
    model = jax_get_model(_cbir_cfg())
    x = jnp.zeros((1, IMG, IMG, 3))
    variables = model.init(jax.random.key(0), x, train=False, method=model.embed)
    return model, _random_tree(variables, seed)


def _port_out(model, x, method=None):
    model.eval()
    with torch.inference_mode():
        fn = model if method is None else getattr(model, method)
        return fn(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_vision_model_logits_match_jax(variant):
    jmodel, tree = _jax_classifier(VARIANTS[variant])
    x = _images()
    ref = np.asarray(jmodel.apply(_jax_vars(tree), jnp.asarray(x), train=False))
    port = load_jax_params(get_model(_cls_cfg(VARIANTS[variant]), device="cpu"), tree)
    out = _port_out(port, x)
    assert out.shape == (3, 10) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_embedding_model_features_match_jax():
    jmodel, tree = _jax_embedder()
    x = _images(1)
    ref = np.asarray(
        jmodel.apply(_jax_vars(tree), jnp.asarray(x), train=False, method=jmodel.embed)
    )
    port = load_jax_params(get_model(_cbir_cfg(), device="cpu"), tree)
    out = _port_out(port, x, method="embed")
    assert out.shape == (3, 16) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_unpooled_token_map_matches_jax():
    from visiondk_tpu.models.backbones.vit import VisionTransformer as JaxViT

    jmodel = JaxViT(patch_size=8, embed_dim=64, depth=2, num_heads=4, num_classes=0, unpooled=True)
    variables = jmodel.init(jax.random.key(0), jnp.zeros((1, IMG, IMG, 3)))
    tree = _random_tree(variables, 2)
    x = _images(2)
    ref = np.asarray(jmodel.apply(_jax_vars(tree), jnp.asarray(x)))
    port = VisionTransformer(patch_size=8, embed_dim=64, depth=2, num_heads=4, num_classes=0,
                             unpooled=True, img_size=IMG)
    out = _port_out(load_jax_params(port, tree), x)
    assert ref.shape == out.shape == (3, 17, 64)  # the JAX pad rows are cropped
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_convert_vit_reads_port_state_dict_back_to_the_jax_tree(variant):
    _, tree = _jax_classifier(VARIANTS[variant], seed=3)
    port = load_jax_params(get_model(_cls_cfg(VARIANTS[variant]), device="cpu"), tree)
    back = convert_vit(port.backbone.state_dict())
    want = {p[len("backbone/"):]: v for p, v in tree["params"].items()}
    assert sorted(back["params"]) == sorted(want)
    for p, v in want.items():
        np.testing.assert_array_equal(back["params"][p], v, err_msg=p)
    assert back["batch_stats"] == {}


def test_bridge_reads_the_jax_npz(tmp_path):
    jmodel, tree = _jax_embedder(seed=4)
    path = str(tmp_path / "embed.npz")
    save_converted(tree, path)
    port = load_jax_params(get_model(_cbir_cfg(), device="cpu"), load_converted(path))
    x = _images(4)
    ref = np.asarray(
        jmodel.apply(_jax_vars(tree), jnp.asarray(x), train=False, method=jmodel.embed)
    )
    np.testing.assert_allclose(_port_out(port, x, method="embed"), ref, rtol=RTOL, atol=ATOL)


def test_bridge_raises_on_a_missing_tensor():
    _, tree = _jax_classifier({})
    del tree["params"]["backbone/block1/mlp/fc2/bias"]
    with pytest.raises(KeyError, match="block1/mlp/fc2/bias"):
        state_dict_from_jax(get_model(_cls_cfg({}), device="cpu"), tree)


def test_bridge_raises_on_an_extra_tensor():
    _, tree = _jax_classifier({})
    tree["params"]["backbone/block0/ls1"] = np.ones(64, np.float32)  # LayerScale the port lacks
    with pytest.raises(ValueError, match="map to no port tensor"):
        state_dict_from_jax(get_model(_cls_cfg({}), device="cpu"), tree)


def test_bridge_raises_on_a_shape_mismatch():
    _, tree = _jax_classifier({})
    tree["params"]["backbone/pos_embed"] = np.zeros((1, 24, 64), np.float32)  # a padded grid
    with pytest.raises(ValueError, match="pos_embed"):
        state_dict_from_jax(get_model(_cls_cfg({}), device="cpu"), tree)


def test_get_model_init_follows_the_jax_initializers():
    a = get_model(_cls_cfg({}), generator=torch.Generator().manual_seed(7), device="cpu")
    b = get_model(_cls_cfg({}), generator=torch.Generator().manual_seed(7), device="cpu")
    c = get_model(_cls_cfg({}), generator=torch.Generator().manual_seed(8), device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["backbone.pos_embed"], sc["backbone.pos_embed"])
    bb = a.backbone
    assert torch.count_nonzero(bb.cls_token) == 0
    assert abs(bb.pos_embed.std().item() - 0.02) < 0.004
    # lecun_normal: std 1/sqrt(fan_in), cut at two of its (pre-scale) deviations
    w = bb.blocks[0].mlp.fc2.weight  # fan_in 256
    assert abs(w.std().item() - 256**-0.5) < 0.1 * 256**-0.5
    assert w.abs().max().item() <= 2 * 256**-0.5 / 0.87962566103423978
    assert torch.equal(bb.blocks[1].norm2.weight, torch.ones(64))
    assert torch.count_nonzero(bb.blocks[1].attn.qkv.bias) == 0
    assert bb.blocks[0].norm1.eps == 1e-6


def test_get_model_builds_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """get_model's default device is the card: without CUDA it raises and
    tells the caller to pass device='cpu', and never falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model(_cls_cfg({}))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model(_cls_cfg({}), device="cuda:0")
    model = get_model(_cls_cfg({}), device="cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())


def test_pet_synth_model_structure():
    cfg = {"task": "classification", "name": "vit_base_patch16_224", "image_size": 224,
           "kwargs": {}, "num_classes": 35, "attention_pool": False, "bn_freeze": False}
    with torch.device("meta"):
        model = VisionModel("vit_base_patch16_224", 35, backbone_kwargs={"img_size": 224})
    sd = model.state_dict()
    assert len(model.backbone.blocks) == 12
    assert model.backbone.blocks[0].attn.num_heads == 12
    assert sd["backbone.pos_embed"].shape == (1, 197, 768)
    assert sd["backbone.blocks.11.attn.qkv.weight"].shape == (2304, 768)
    assert sd["backbone.head.weight"].shape == (35, 768)
    assert sum(v.numel() for v in model.parameters()) == 85_825_571
    assert cfg["name"] in BACKBONES


@pytest.mark.parametrize(
    "build",
    [
        lambda: get_model({"task": "classification", "name": TINY, "num_classes": 3,
                           "attention_pool": True}, device="cpu"),
        lambda: get_model({"task": "cbir", "backbone": {TINY: {}},
                           "head": {"arcface": {"s": 64}}}, device="cpu"),
        lambda: get_model({"task": "classification", "num_classes": 3,
                           "name": "vit_so400m_patch14_siglip_224"}, device="cpu"),
    ],
    ids=["attention_pool", "margin_head", "map_pool"],
)
def test_unported_options_raise(build):
    with pytest.raises(NotImplementedError):
        build()
