"""visiondk_tpu_torch's Swin Transformer, its bridge and its train step against the JAX package.

A tiny Swin (patch 4, embed 16, depths (2, 2), heads (2, 4), window 4, MLP
ratio 2, stochastic depth 0) is registered in both packages' registries and
built by each package's own ``get_model`` from the same config dict; the
JAX parameters, re-drawn from a numpy seed, are bridged into the port, and
both see the same inputs. On 32×32 images stage 0 is 8×8 (shifted windows)
and stage 1 4×4 (one unshifted window); on 48×48 stage 1 is 6×6, which pads
to 8×8 and shifts by 2. Outputs are compared in f32 at rtol 1e-3, atol 3e-4
(the tolerance of the JAX package's pretrained-import goldens); three train
steps at PR 2's bars (loss 1e-5 relative; updates and EMA 1e-3 relative plus
1e-3 of the tensor's largest update), plus one f32 spacing of the tensor's
largest |θ|: θₖ is stored as θ₀ + Δ rounded to f32, and the EMA's moves on
LayerNorm scales near 1 are a few hundred spacings. The JAX Swin runs its
XLA window path on the CPU; the port runs the plain versions of its window
kernels. A shifted block hands its shift to the window op; on the padded
48×48 map it gives what the block gave rolling the padded map around the
op (``rolled_window_attention``, the JAX block's order), as the reference.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from visiondk_tpu.engine.state import create_train_state as jax_create_train_state
from visiondk_tpu.engine.steps import StepConfig as JaxStepConfig
from visiondk_tpu.engine.steps import make_train_step as jax_make_train_step
from visiondk_tpu.engine.trainer import CenterProcessor
from visiondk_tpu.losses import losses as JL
from visiondk_tpu.models import get_model as jax_get_model
from visiondk_tpu.models.backbones import BACKBONES as JAX_BACKBONES
from visiondk_tpu.models.backbones.swin import _swin as jax_swin
from visiondk_tpu.models.backbones.swin import relative_position_index as jax_relative_position_index
from visiondk_tpu.models.backbones.swin import window_region_ids as jax_window_region_ids
from visiondk_tpu.models.convert import _flatten, _unflatten, convert_swin
from visiondk_tpu_torch.engine.optim import create_optimizer
from visiondk_tpu_torch.engine.state import create_train_state
from visiondk_tpu_torch.engine.steps import StepConfig, make_train_step
from visiondk_tpu_torch.engine.trainer import build_tx
from visiondk_tpu_torch.losses import create_lossfn
from visiondk_tpu_torch.models import BACKBONES, VisionModel, get_model
from visiondk_tpu_torch.models.backbones import swin as swin_module
from visiondk_tpu_torch.models.backbones.swin import (
    SwinTransformer, WindowAttention, _swin, relative_position_index, window_region_ids,
)
from visiondk_tpu_torch.ops.window_attention import fused_window_attention
from visiondk_tpu_torch.models.convert import (
    load_converted, load_jax_params, param_paths, state_dict_from_jax,
)

TINY = "swin_tiny_port_test"
RTOL, ATOL = 1e-3, 3e-4
KWARGS = {"mlp_ratio": 2.0, "stochastic_depth_prob": 0.0}
FIXTURE = "tests/fixtures/swin_golden.npz"
# the optimizer fields of the `hyp:` section of configs/classification/pet.yaml
PET_HYP = {
    "epochs": 15, "lr0": 0.006, "lrf_ratio": None, "momentum": 0.937, "weight_decay": 0.0005,
    "warmup_momentum": 0.8, "warm_ep": 1, "optimizer": ["sgd", False], "scheduler": "cosine_with_warm",
}


@pytest.fixture(scope="module", autouse=True)
def tiny_swin_registered():
    """Register the tiny Swin in both registries for this module only."""
    JAX_BACKBONES.register(jax_swin(16, (2, 2), (2, 4), window_size=4), name=TINY)
    BACKBONES.register(_swin(16, (2, 2), (2, 4), window_size=4), name=TINY)
    yield
    del JAX_BACKBONES._store[TINY]
    del BACKBONES._store[TINY]


def _cls_cfg(img=32, classes=5):
    return {"task": "classification", "name": TINY, "num_classes": classes, "image_size": img,
            "kwargs": dict(KWARGS)}


def _cbir_cfg(img=32):
    return {"task": "cbir", "backbone": {TINY: {"feat_dim": 16, "image_size": img, **KWARGS}}}


def _images(img=32, seed=0, batch=3):
    return np.random.default_rng(seed).normal(size=(batch, img, img, 3)).astype(np.float32)


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


def _port_out(model, x, method=None):
    model.eval()
    with torch.inference_mode():
        fn = model if method is None else getattr(model, method)
        return fn(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("img", [32, 48], ids=["32px", "48px_padded_shift"])
def test_tiny_swin_logits_match_jax(img):
    jmodel = jax_get_model(_cls_cfg(img))
    variables = jmodel.init(jax.random.key(0), jnp.zeros((1, img, img, 3)), train=False)
    tree = _random_tree(variables, seed=img)
    x = _images(img, seed=1)
    ref = np.asarray(jmodel.apply(_jax_vars(tree), jnp.asarray(x), train=False))
    port = load_jax_params(get_model(_cls_cfg(img), device="cpu"), tree)
    out = _port_out(port, x)
    assert out.shape == (3, 5) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_golden_fixture_logits_through_the_bridge_alone():
    """The committed golden (a timm-layout Swin's real torch forward, converted
    to the JAX tree) read by the port's numpy-only bridge: no JAX runs."""
    data = np.load(FIXTURE)
    model = SwinTransformer(patch_size=4, embed_dim=16, depths=(2, 2), num_heads=(2, 4), window_size=4,
                            mlp_ratio=2.0, num_classes=5, stochastic_depth_prob=0.0, img_size=32)
    load_jax_params(model, load_converted(FIXTURE))
    out = _port_out(model, data["__input__"])
    np.testing.assert_allclose(out, data["__logits__"], rtol=RTOL, atol=ATOL)


def test_embedding_model_matches_jax():
    jmodel = jax_get_model(_cbir_cfg())
    x = jnp.zeros((1, 32, 32, 3))
    variables = jmodel.init(jax.random.key(0), x, train=False, method=jmodel.embed)
    tree = _random_tree(variables, seed=2)
    images = _images(seed=3)
    ref = np.asarray(jmodel.apply(_jax_vars(tree), jnp.asarray(images), train=False, method=jmodel.embed))
    port = load_jax_params(get_model(_cbir_cfg(), device="cpu"), tree)
    assert port.backbone.feature_shape == (16, 32)  # 8×8 → 4×4 tokens, 2·embed
    out = _port_out(port, images, method="embed")
    assert out.shape == (3, 16) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_three_train_steps_match_jax():
    cfg = _cls_cfg(classes=7)
    jmodel = jax_get_model(cfg)
    variables = jmodel.init(jax.random.key(1), jnp.zeros((1, 32, 32, 3)), train=False)
    params = _random_tree(variables, seed=6)["params"]
    port = load_jax_params(get_model(cfg, device="cpu"), {"params": params})
    theta0 = {k: v.clone() for k, v in port.state_dict().items()}

    fake = SimpleNamespace(hyp_cfg=PET_HYP, opt_name="sgd", layer_wise=False, model_cfg={})
    jtx = CenterProcessor._build_tx(fake, 2, True)
    jstate = jax_create_train_state({"params": jax.tree_util.tree_map(jnp.asarray, _unflatten(params))}, jtx)
    jstep = jax_make_train_step(jmodel, jtx, JL.create_lossfn("ce", label_smooth=0.05), JaxStepConfig(),
                                jax.random.key(0), donate=False)
    tx = build_tx(PET_HYP, 2, True)
    state = create_train_state(port, tx)
    step = make_train_step(port, tx, create_lossfn("ce", label_smooth=0.05), StepConfig(),
                           torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    for _ in range(3):
        batch = {"image": rng.integers(0, 256, size=(4, 32, 32, 3), dtype=np.uint8),
                 "label": rng.integers(0, 7, size=4).astype(np.int32)}
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.float32(0.0))
        metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), rtol=1e-5)
    assert state.step == 3 and state.ema_updates == 3 and state.optimizer.count == 3

    def check_moved(module, jtree, what):
        want = state_dict_from_jax(module, {"params": {p: np.asarray(v) for p, v in _flatten(dict(jtree)).items()}})
        for key, value in module.state_dict().items():
            got_d = (value - theta0[key]).numpy()
            want_d = (want[key] - theta0[key]).numpy()
            assert np.abs(want_d).max() > 0, (what, key)  # every tensor moved, the bias tables too
            spacing = np.spacing(np.abs(want[key].numpy()).max())
            np.testing.assert_allclose(got_d, want_d, rtol=1e-3, atol=1e-3 * np.abs(want_d).max() + spacing,
                                       err_msg=f"{what} {key}")

    check_moved(port, jstate.params, "update")
    check_moved(state.ema_model, jstate.ema_params, "ema")


def test_convert_swin_reads_the_port_state_dict_back_strictly():
    jmodel = jax_get_model(_cls_cfg())
    variables = jmodel.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False)
    tree = _random_tree(variables, seed=4)
    port = load_jax_params(get_model(_cls_cfg(), device="cpu"), tree)
    back = convert_swin(port.backbone.state_dict())  # strict: every port tensor maps
    want = {p[len("backbone/"):]: v for p, v in tree["params"].items()}
    assert sorted(back["params"]) == sorted(want)
    for p, v in want.items():
        np.testing.assert_array_equal(back["params"][p], v, err_msg=p)
    # and the converted tree loads back into a fresh port model, strictly
    again = load_jax_params(get_model(_cls_cfg(), device="cpu"), {"params": {f"backbone/{p}": v for p, v in back["params"].items()}})
    for key, value in port.state_dict().items():
        assert torch.equal(again.state_dict()[key], value), key


def test_param_paths_are_the_jax_tree_and_label_by_its_top_level_keys():
    jmodel = jax_get_model(_cls_cfg())
    variables = jmodel.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False)
    port = get_model(_cls_cfg(), device="cpu")
    paths = param_paths(port)
    assert sorted(paths.values()) == sorted(_flatten(dict(variables["params"])))
    bare = param_paths(port.backbone)
    assert bare["layers.0.blocks.1.attn.qkv.weight"] == "stage0_block1/attn/qkv/kernel"
    assert bare["layers.0.downsample.reduction.weight"] == "merge0/reduction/kernel"
    assert bare["patch_embed.proj.weight"] == "patch_embed/kernel"
    assert bare["patch_embed.norm.weight"] == "patch_norm/scale"
    assert {p.split("/")[0] for p in bare.values()} == {
        "patch_embed", "patch_norm", "stage0_block0", "stage0_block1", "stage1_block0", "stage1_block1",
        "merge0", "norm", "head"}
    # layer-wise lr boosts the bare Swin's own head, as the JAX labels of its tree do
    lr = lambda c: 1.0  # noqa: E731
    labels = create_optimizer("sgd", lr, 0.0, lr, layer_wise_lr=True).labels(port.backbone)
    assert {n for n, m in labels.items() if m == 10.0} == {"head.weight", "head.bias"}
    frozen = create_optimizer("sgd", lr, 0.0, lr, backbone_freeze=True).labels(port)
    assert set(frozen) == {"backbone.head.weight", "backbone.head.bias"}


@pytest.mark.parametrize("what", ["missing", "extra"])
def test_bridge_is_strict_both_ways_for_swin(what):
    jmodel = jax_get_model(_cls_cfg())
    variables = jmodel.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False)
    tree = _random_tree(variables, seed=5)
    if what == "missing":
        del tree["params"]["backbone/stage1_block1/attn/relative_position_bias_table"]
        with pytest.raises(KeyError, match="relative_position_bias_table"):
            state_dict_from_jax(get_model(_cls_cfg(), device="cpu"), tree)
    else:
        tree["params"]["backbone/merge1/norm/scale"] = np.ones(64, np.float32)  # a merge the port lacks
        with pytest.raises(ValueError, match="map to no port tensor"):
            state_dict_from_jax(get_model(_cls_cfg(), device="cpu"), tree)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_kernel_path_and_plain_path_modules_agree_on_cpu(train):
    """use_fused routes through fused_window_attention (the kernels' plain
    versions on the CPU, its autograd Function in training); use_fused off
    runs the plain forward differentiated by autograd."""
    x = torch.from_numpy(_images(48, seed=8))
    outs, grads = [], []
    for fused in (True, False):
        model = get_model(_cls_cfg(48), generator=torch.Generator().manual_seed(3), device="cpu")
        for m in model.modules():
            if isinstance(m, WindowAttention):
                m.use_fused = fused
        model.train(train)
        with torch.set_grad_enabled(train):
            out = model(x)
        if train:
            out.square().sum().backward()
            grads.append({n: p.grad for n, p in model.named_parameters()})
        outs.append(out.detach())
    assert torch.equal(outs[0], outs[1])
    for n in grads[0] if train else ():
        np.testing.assert_allclose(grads[0][n].numpy(), grads[1][n].numpy(), rtol=1e-5, atol=1e-6, err_msg=n)


def rolled_window_attention(attn, y, ws, shift):
    """A block's window attention as the blocks ran it before the op took the
    shift, the JAX block's order: zero-pad bottom and right, roll the padded
    map by −shift, attention over the rolled map (the op unshifted, the ids
    of the shifted frame), roll back by +shift, crop."""
    _, hh, ww, _ = y.shape
    y = F.pad(y, (0, 0, 0, (-ww) % ws, 0, (-hh) % ws))
    y = torch.roll(attn(torch.roll(y, (-shift, -shift), dims=(1, 2)), shift), (shift, shift), dims=(1, 2))
    return y[:, :hh, :ww]


def use_rolled_blocks(monkeypatch, module) -> None:
    """Route ``module``'s blocks through ``rolled_window_attention``, with its
    window op dropping the shift it is handed."""
    monkeypatch.setattr(module, "padded_window_attention", rolled_window_attention)
    monkeypatch.setattr(module, "fused_window_attention",
                        lambda qkv, bias, ids, heads, scale=None, shift=0:
                        fused_window_attention(qkv, bias, ids, heads, scale))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_shift_in_the_op_gives_the_rolled_blocks_result_on_a_padded_map(train, monkeypatch):
    """At 48×48, stage 1's 6×6 map pads to 8×8 and shifts by 2: the model
    whose shifted blocks hand the shift to the op gives the logits (and
    parameter gradients) of the same model rolling the padded map around
    the op."""
    x = torch.from_numpy(_images(48, seed=9))
    outs, grads = [], []
    for rolled in (False, True):
        if rolled:
            use_rolled_blocks(monkeypatch, swin_module)
        model = get_model(_cls_cfg(48), generator=torch.Generator().manual_seed(5), device="cpu")
        assert model.backbone.layers[1].blocks[1].shift == 2
        model.train(train)
        with torch.set_grad_enabled(train):
            out = model(x)
        if train:
            out.square().sum().backward()
            grads.append({n: p.grad for n, p in model.named_parameters()})
        outs.append(out.detach())
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), rtol=1e-6, atol=1e-6)
    for n in grads[0] if train else ():
        ref = grads[1][n].numpy()
        np.testing.assert_allclose(grads[0][n].numpy(), ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max(), err_msg=n)


def test_static_tables_match_jax():
    for ws in (2, 4, 7):
        np.testing.assert_array_equal(relative_position_index(ws), jax_relative_position_index(ws))
    for hh, ww, ws, shift in ((8, 8, 4, 2), (14, 14, 7, 3), (56, 56, 7, 3), (8, 8, 4, 0)):
        np.testing.assert_array_equal(window_region_ids(hh, ww, ws, shift), jax_window_region_ids(hh, ww, ws, shift))


def test_swin_b_structure():
    with torch.device("meta"):
        model = VisionModel("swin_base_patch4_window7_224", 35, backbone_kwargs={"img_size": 224})
    bb = model.backbone
    blocks = [b for stage in bb.layers for b in stage.blocks]
    assert len(blocks) == 24 and [len(s.blocks) for s in bb.layers] == [2, 2, 18, 2]
    assert [b.attn.num_heads for b in blocks[:4]] == [4, 4, 8, 8] and blocks[-1].attn.num_heads == 32
    assert [b.shift for b in blocks[:4]] == [0, 3, 0, 3] and [b.shift for b in blocks[-2:]] == [0, 0]
    assert all(b.window_size == 7 for b in blocks) and blocks[0].norm1.eps == 1e-5
    assert bb.feature_shape == (49, 1024)
    sd = model.state_dict()
    assert sd["backbone.layers.0.blocks.0.attn.relative_position_bias_table"].shape == (169, 4)
    assert sd["backbone.layers.2.downsample.reduction.weight"].shape == (1024, 2048)
    assert not any("relative_position_index" in k for k in sd)  # static, never a buffer
    # timm's swin_base_patch4_window7_224 has 87,768,224 parameters with its
    # 1000-class head; this one has a 35-class head
    assert sum(p.numel() for p in model.parameters()) == 87_768_224 - 1024 * 965 - 965


def test_unported_swin_options_raise():
    model = get_model(_cls_cfg(), device="cpu")
    with pytest.raises(ValueError, match="built for 32"):
        model(torch.zeros((1, 48, 48, 3)))
