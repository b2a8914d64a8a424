"""visiondk_tpu_torch's Swin Transformer V2, its bridge and its train step against the JAX package.

A tiny SwinV2 (patch 4, embed 16, depths (2, 2), heads (2, 4), MLP ratio 2,
stochastic depth 0) with window 4, and the same with window 8, are
registered in both packages' registries and built by each package's own
``get_model`` from the same config dict; the JAX parameters, re-drawn from
a numpy seed, are bridged into the port, and both see the same inputs. The
JAX model runs its non-fused XLA path on the CPU (scores, logit scale, CPB
bias and shift mask in f32); the port runs ``fused_window_attention`` with
the scale folded into q, whose plain versions run on CPU tensors. Window 4
on 32×32 images: stage 0 is 8×8 (unshifted and shifted blocks), stage 1 4×4
(one window, no shift); on 40×40 stage 0 is 10×10, padded to 12×12 and
shifted by 2, the merge pads the odd edge (5×5 after it), and stage 1 pads
5×5 to 8×8 and shifts. A shifted block hands its shift to the window op;
on the padded 40×40 maps it gives what the block gave rolling the padded
map around the op (``test_torch_port_swin.rolled_window_attention``). Window 8 on 64×64: stage 0 16×16 with ws 8 and shift
4, stage 1 8×8 in one window. Window 16 on 128×128 (the windows of
swinv2_large_window12to16_192to256's stages 0-2, N = 256): stage 0 32×32
with ws 16 and shift 8, stage 1 16×16 in one window.

Tolerances: outputs and gradients in f32 at rtol 1e-3, atol 3e-4 (of the
tensor's largest entry for a gradient), the model tests' bar (measured
worst: 1.4e-6 on the logits, 1.7e-4 of a gradient's largest entry at 40×40);
the port's fused path against its plain path on the same folded inputs:
outputs equal, gradients within rtol 1e-5 plus 1e-6 of the tensor's
largest entry (measured worst 2.8e-6 of the largest entry, on an entry that
its own 1e-5 covers); three train steps with the port and
the JAX step both in float64 (``jax.enable_x64``): each step's loss within
1e-5 relative (measured 2.4e-7), every update and EMA update within 1e-3 of
its tensor's norm plus three f32 spacings (measured worst update 8.9e-6 of
its norm; the port's EMA shadow is f32), the bars of
``test_torch_port_resnet.py``; the static tables exactly.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from visiondk_tpu.engine.optim import freeze_mask as jax_freeze_mask
from visiondk_tpu.engine.optim import layer_wise as jax_layer_wise
from visiondk_tpu.engine.state import create_train_state as jax_create_train_state
from visiondk_tpu.engine.steps import StepConfig as JaxStepConfig
from visiondk_tpu.engine.steps import make_train_step as jax_make_train_step
from visiondk_tpu.engine.trainer import CenterProcessor
from visiondk_tpu.losses import losses as JL
from visiondk_tpu.models import get_model as jax_get_model
from visiondk_tpu.models.backbones import BACKBONES as JAX_BACKBONES
from visiondk_tpu.models.backbones import swinv2 as jax_swinv2
from visiondk_tpu.models.convert import _flatten, _unflatten, convert_state_dict
from visiondk_tpu_torch.engine.optim import create_optimizer
from visiondk_tpu_torch.engine.state import create_train_state
from visiondk_tpu_torch.engine.steps import StepConfig, make_train_step
from visiondk_tpu_torch.engine.trainer import build_tx
from visiondk_tpu_torch.losses import create_lossfn
from visiondk_tpu_torch.models import BACKBONES, VisionModel, factory, get_model
from visiondk_tpu_torch.models.backbones import swinv2 as swinv2_module
from visiondk_tpu_torch.models.backbones.swin import window_region_ids
from visiondk_tpu_torch.models.backbones.swinv2 import (
    PatchMergingV2, SwinTransformerV2, WindowAttentionV2, _swinv2, log_relative_coords,
)
from visiondk_tpu_torch.models.convert import load_jax_params, param_paths, state_dict_from_jax

RTOL, ATOL = 1e-3, 3e-4
KWARGS = {"mlp_ratio": 2.0, "stochastic_depth_prob": 0.0}
TINY = {4: "swinv2_tiny_w4_port_test", 8: "swinv2_tiny_w8_port_test", 16: "swinv2_tiny_w16_port_test"}
REGISTERED = ["swinv2_tiny_window8_256", "swinv2_small_window8_256", "swinv2_base_window8_256",
              "swinv2_large_window12to16_192to256"]
# the optimizer fields of the `hyp:` section of configs/classification/pet.yaml
PET_HYP = {"epochs": 15, "lr0": 0.006, "lrf_ratio": None, "momentum": 0.937, "weight_decay": 0.0005,
           "warmup_momentum": 0.8, "warm_ep": 1, "optimizer": ["sgd", False], "scheduler": "cosine_with_warm"}


@torch.no_grad()
def _pattern_init(module, generator):
    """A cheap stand-in for ``init_params`` in the bridge tests: every tensor
    a distinct arange pattern (torch's CPU ``trunc_normal_`` draws take
    seconds a full-size model), so the round trip checks every transpose."""
    for i, t in enumerate(module.state_dict().values()):
        t.copy_(((torch.arange(t.numel()) + 7 * i) % 251).reshape(t.shape).to(t.dtype))
    return module


@pytest.fixture(scope="module", autouse=True)
def tiny_swinv2_registered():
    for ws, name in TINY.items():
        JAX_BACKBONES.register(jax_swinv2._swinv2(16, (2, 2), (2, 4), window_size=ws), name=name)
        BACKBONES.register(_swinv2(16, (2, 2), (2, 4), window_size=ws), name=name)
    yield
    for name in TINY.values():
        del JAX_BACKBONES._store[name]
        del BACKBONES._store[name]


def _cls_cfg(img=32, ws=4, classes=5):
    return {"task": "classification", "name": TINY[ws], "num_classes": classes, "image_size": img,
            "kwargs": dict(KWARGS)}


def _images(img=32, seed=0, batch=3):
    return np.random.default_rng(seed).normal(size=(batch, img, img, 3)).astype(np.float32)


_INITS: dict = {}


def _init(jmodel, img, method=None):
    """The JAX model's variables, initialised under ``jax.jit``, once per configuration."""
    key = (repr(jmodel), img, getattr(method, "__name__", None))
    if key not in _INITS:
        init = jax.jit(lambda x: jmodel.init(jax.random.key(0), x, train=False, method=method))
        _INITS[key] = init(jnp.zeros((1, img, img, 3)))
    return _INITS[key]


def _random_tree(variables, seed):
    """Every JAX tensor re-drawn from a numpy seed: kernels at lecun scale,
    LayerNorm scales near 1, logit scales around log 10, the rest small."""
    rng = np.random.default_rng(seed)
    tree = {}
    for t in ("params", "batch_stats"):
        flat = {p: np.asarray(v) for p, v in _flatten(dict(variables.get(t, {}))).items()}
        for p, v in flat.items():
            if p.endswith("/kernel"):
                flat[p] = (rng.normal(size=v.shape) / np.sqrt(np.prod(v.shape[:-1]))).astype(np.float32)
            elif p.endswith("/logit_scale"):
                flat[p] = (np.log(10.0) + 0.3 * rng.normal(size=v.shape)).astype(np.float32)
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


def _apply(jmodel, tree, x, method=None):
    return jax.jit(lambda v, x: jmodel.apply(v, x, train=False, method=method))(_jax_vars(tree), jnp.asarray(x))


def _bridged(cfg, img, seed):
    """(JAX model, its numpy-seeded tree, the port model with that tree)."""
    jmodel = jax_get_model(cfg)
    tree = _random_tree(_init(jmodel, img), seed)
    return jmodel, tree, load_jax_params(get_model(cfg, device="cpu"), tree)


def _float64(model):
    """The model's parameters, buffers and every layer's compute dtype in float64."""
    model.double()
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    return model


# ---------------------------------------------------------------- pieces


def test_static_tables_match_jax():
    for ws in (2, 4, 7, 8, 16):  # the JAX table is float64 numpy; its model reads it as f32 (the CPB Dense's dtype)
        np.testing.assert_array_equal(log_relative_coords(ws), jax_swinv2.log_relative_coords(ws).astype(np.float32))
    for hh, ww, ws, shift in ((12, 12, 4, 2), (8, 8, 4, 2), (64, 64, 8, 4), (8, 8, 8, 0)):
        np.testing.assert_array_equal(window_region_ids(hh, ww, ws, shift),
                                      jax_swinv2.window_region_ids(hh, ww, ws, shift))


@pytest.mark.parametrize("res", [(5, 5), (6, 7)], ids=["odd", "odd_width"])
def test_patch_merging_v2_matches_jax(res):
    """Odd edges zero-padded, the 2×2 concat, the reduction, then LayerNorm."""
    c = 8
    x = np.random.default_rng(1).normal(size=(2, res[0] * res[1], c)).astype(np.float32)
    jmerge = jax_swinv2.PatchMergingV2(res, c)
    tree = _random_tree(jmerge.init(jax.random.key(0), jnp.asarray(x)), seed=2)["params"]
    port = PatchMergingV2(res, c)
    with torch.no_grad():
        port.reduction.weight.copy_(torch.from_numpy(tree["reduction/kernel"].T.copy()))
        port.norm.weight.copy_(torch.from_numpy(tree["norm/scale"]))
        port.norm.bias.copy_(torch.from_numpy(tree["norm/bias"]))
        out = port(torch.from_numpy(x)).numpy()
    ref = jmerge.apply({"params": _unflatten(tree)}, jnp.asarray(x))
    assert out.shape == (2, -(-res[0] // 2) * -(-res[1] // 2), 2 * c)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------- the model


@pytest.mark.parametrize("img,ws", [(32, 4), (40, 4), (64, 8), (128, 16)],
                         ids=["32px", "40px_padded_odd_merge", "64px_ws8", "128px_ws16"])
def test_tiny_swinv2_logits_match_jax(img, ws):
    cfg = _cls_cfg(img, ws)
    jmodel, tree, port = _bridged(cfg, img, seed=img)
    x = _images(img)
    with torch.inference_mode():
        out = port.eval()(torch.from_numpy(x)).numpy()
    assert out.shape == (3, 5) and out.dtype == np.float32
    np.testing.assert_allclose(out, np.asarray(_apply(jmodel, tree, x)), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("img", [32, 40], ids=["32px", "40px_padded_odd_merge"])
def test_gradients_of_every_parameter_match_jax(img):
    """d(Σ logits·r)/dθ in eval mode: the port through the window op's
    autograd Function (its dbias into the CPB MLP), JAX by ``jax.grad``;
    ``logit_scale`` and both CPB layers of every block included."""
    cfg = _cls_cfg(img)
    jmodel, tree, port = _bridged(cfg, img, seed=3 + img)
    x = _images(img, seed=4)
    r = np.random.default_rng(5).normal(size=(3, 5)).astype(np.float32)
    params = _jax_vars(tree)["params"]
    grads = jax.jit(jax.grad(lambda p: jnp.sum(jmodel.apply({"params": p}, jnp.asarray(x), train=False) * r)))(params)
    want = state_dict_from_jax(port, {"params": {p: np.asarray(v) for p, v in _flatten(dict(grads)).items()}})
    port.eval()
    (port(torch.from_numpy(x)) * torch.from_numpy(r)).sum().backward()
    names = [n for n, _ in port.named_parameters()]
    assert sum(n.endswith(("attn.logit_scale", "attn.cpb_mlp.0.weight", "attn.cpb_mlp.2.weight")) for n in names) == 12
    for n, p in port.named_parameters():
        assert p.grad is not None and np.abs(want[n].numpy()).max() > 0, n
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(), rtol=RTOL,
                                   atol=ATOL * np.abs(want[n].numpy()).max(), err_msg=n)


def test_embedding_model_matches_jax():
    """The unpooled token map through the LayerNorm neck."""
    cfg = {"task": "cbir", "backbone": {TINY[4]: {"feat_dim": 16, "image_size": 40, **KWARGS}}}
    jmodel = jax_get_model(cfg)
    tree = _random_tree(_init(jmodel, 40, method=jmodel.embed), seed=8)
    port = load_jax_params(get_model(cfg, device="cpu"), tree).eval()
    assert port.backbone.feature_shape == (25, 32)
    x = _images(40, seed=9, batch=4)
    with torch.inference_mode():
        out = port.embed(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(_apply(jmodel, tree, x, method=jmodel.embed)), rtol=RTOL, atol=ATOL)


def test_three_train_steps_match_jax():
    """CE with label smoothing 0.05, pet.yaml's hyp (SGD, clip, EMA), 2
    steps an epoch; the port and the JAX step both in float64 (window ops'
    plain versions in float64 on the port's side)."""
    _three_train_steps(40, 4)


def test_three_train_steps_match_jax_at_window_16():
    """The same at window 16 on 128×128: stage 0 shifted at ws 16, stage 1
    one unshifted window."""
    _three_train_steps(128, 16)


def _three_train_steps(img, ws):
    cfg = _cls_cfg(img, ws, classes=7)
    _, tree, port = _bridged(cfg, img, seed=6)
    port = _float64(port)
    theta0 = {k: v.clone() for k, v in port.state_dict().items()}
    tx = build_tx(PET_HYP, 2, True)
    state = create_train_state(port, tx)
    step = make_train_step(port, tx, create_lossfn("ce", label_smooth=0.05), StepConfig(),
                           torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    batches = [{"image": rng.integers(0, 256, size=(4, img, img, 3), dtype=np.uint8),
                "label": rng.integers(0, 7, size=4).astype(np.int32)} for _ in range(3)]
    with jax.enable_x64(True):
        jmodel = jax_get_model(cfg, dtype=jnp.float64)
        fake = SimpleNamespace(hyp_cfg=PET_HYP, opt_name="sgd", layer_wise=False, model_cfg={})
        jtx = CenterProcessor._build_tx(fake, 2, True)
        jstate = jax_create_train_state(
            {"params": jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), _unflatten(tree["params"]))},
            jtx)
        jstep = jax_make_train_step(jmodel, jtx, JL.create_lossfn("ce", label_smooth=0.05), JaxStepConfig(),
                                    jax.random.key(0), donate=False)
        for batch in batches:
            jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.float64(0.0))
            metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
            np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), rtol=1e-5)
        jax_trees = [(port, jstate.params, "update"), (state.ema_model, jstate.ema_params, "ema")]
        jax_trees = [(m, {p: np.asarray(v) for p, v in _flatten(dict(t)).items()}, w) for m, t, w in jax_trees]
    assert state.step == 3 and state.ema_updates == 3
    for module, params, what in jax_trees:
        want = state_dict_from_jax(module, {"params": params})
        got = module.state_dict()
        for key, value in want.items():
            got_d, want_d = (got[key] - theta0[key]).double().numpy(), (value - theta0[key]).double().numpy()
            assert np.abs(want_d).max() > 0, (what, key)  # every tensor moved, logit scales and CPB MLPs too
            # the port's EMA shadow is f32 (init_ema), the float64 reference's is not
            spacing = np.sqrt(want_d.size) * np.spacing(np.float32(np.abs(theta0[key].numpy()).max()))
            err = np.linalg.norm(got_d - want_d)
            assert err <= 1e-3 * np.linalg.norm(want_d) + 3 * spacing, (what, key, err, np.linalg.norm(want_d))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_shift_in_the_op_gives_the_rolled_blocks_result_on_a_padded_map(train, monkeypatch):
    """At 40×40 both stages pad and shift (10×10 to 12×12, 5×5 to 8×8, by 2):
    the model whose shifted blocks hand the shift to the op gives the logits
    (and parameter gradients) of the same model rolling the padded maps
    around the op."""
    from tests.test_torch_port_swin import use_rolled_blocks

    x = torch.from_numpy(_images(40, seed=9))
    outs, grads = [], []
    for rolled in (False, True):
        if rolled:
            use_rolled_blocks(monkeypatch, swinv2_module)
        model = get_model(_cls_cfg(40), generator=torch.Generator().manual_seed(5), device="cpu")
        assert [b.shift for b in model.backbone.layers[1].blocks] == [0, 2]
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


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_kernel_path_and_plain_path_modules_agree_on_cpu(train):
    """use_fused routes through fused_window_attention (the kernels' plain
    versions on the CPU, its autograd Function in training); use_fused off
    runs fused_window_attention_plain on the same folded inputs,
    differentiated by autograd: one function."""
    x = torch.from_numpy(_images(40, seed=8))
    outs, grads = [], []
    for fused in (True, False):
        model = get_model(_cls_cfg(40), generator=torch.Generator().manual_seed(3), device="cpu")
        for m in model.modules():
            if isinstance(m, WindowAttentionV2):
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
        ref = grads[1][n].numpy()
        np.testing.assert_allclose(grads[0][n].numpy(), ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max(), err_msg=n)


def _jax_layer_wise_heads(params) -> set:
    """The flax paths the JAX ``layer_wise`` transform boosts (×10 on an SGD step at lr 1)."""
    tx = jax_layer_wise(lambda s: optax.sgd(s), lambda t: 1.0, params)
    updates = jax.jit(lambda p: tx.update(jax.tree_util.tree_map(jnp.ones_like, p), tx.init(p), p)[0])(params)
    return {p for p, u in _flatten(dict(updates)).items() if np.all(np.asarray(u) == -10.0)}


@pytest.mark.parametrize("bare", [False, True], ids=["vision_model", "bare_backbone"])
def test_freeze_masks_and_layer_wise_labels_are_the_jax_ones(bare):
    if bare:
        jmodel = JAX_BACKBONES.create(TINY[4], num_classes=5, **KWARGS)
        port = BACKBONES.create(TINY[4], num_classes=5, img_size=32, **KWARGS)
    else:
        jmodel, port = jax_get_model(_cls_cfg()), get_model(_cls_cfg(), device="cpu")
    params = _init(jmodel, 32)["params"]
    paths = param_paths(port)
    assert set(paths.values()) == set(_flatten(dict(params)))
    lr = lambda c: 1.0  # noqa: E731
    labels = jax_freeze_mask(backbone_freeze=True)(params)
    want = {p for p, lab in _flatten(dict(labels)).items() if lab == "frozen"}
    trainable = create_optimizer("sgd", lr, 0.0, lr, backbone_freeze=True).labels(port)
    assert {paths[n] for n in paths if n not in trainable} == want and len(trainable) == 2  # the head
    affine = create_optimizer("sgd", lr, 0.0, lr, bn_freeze_affine=True).labels(port)
    assert set(affine) == set(paths)  # no BatchNorm: nothing frozen, as the JAX mask
    assert not {p for p, lab in _flatten(dict(jax_freeze_mask(bn_freeze_affine=True)(params))).items()
                if lab == "frozen"}
    boosted = create_optimizer("sgd", lr, 0.0, lr, layer_wise_lr=True).labels(port)
    assert {paths[n] for n, m in boosted.items() if m == 10.0} == _jax_layer_wise_heads(params)
    bare_paths = param_paths(port if bare else port.backbone)
    assert bare_paths["layers.0.blocks.1.attn.logit_scale"] == "stage0_block1/attn/logit_scale"
    assert bare_paths["layers.0.blocks.1.attn.cpb_mlp.0.weight"] == "stage0_block1/attn/cpb_fc1/kernel"
    assert bare_paths["layers.0.blocks.1.attn.cpb_mlp.2.weight"] == "stage0_block1/attn/cpb_fc2/kernel"
    assert bare_paths["layers.0.downsample.norm.weight"] == "merge0/norm/scale"


@pytest.mark.parametrize("name", REGISTERED)
def test_bridge_is_strict_both_ways_on_every_registered_name(name, monkeypatch):
    """Every registered SwinV2 builds through ``get_model(device="cpu")``
    (at 64×64: the parameters do not depend on the image size; random draws
    replaced by ``_pattern_init``); its state dict goes through the JAX
    package's ``convert_swinv2`` strictly (one 3C ``qkv.bias``) and gives
    the JAX model's tree, paths and shapes as ``jax.eval_shape`` gives
    them; that tree goes back through the port's bridge, strictly, to the
    same state dict."""
    cfg = {"task": "classification", "name": name, "num_classes": 5, "image_size": 64, "kwargs": {}}
    monkeypatch.setattr(factory, "init_params", _pattern_init)
    port = get_model(cfg, device="cpu")
    assert isinstance(port.backbone, SwinTransformerV2)
    shapes = jax.eval_shape(lambda: jax_get_model(cfg).init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
                                                            train=False))
    back = convert_state_dict({k[len("backbone."):]: v for k, v in port.state_dict().items()}, name, strict=True)
    want = {p: tuple(v.shape) for p, v in _flatten(dict(shapes["params"])).items()}
    assert {f"backbone/{p}": tuple(v.shape) for p, v in back["params"].items()} == want
    assert not back["batch_stats"]
    tree = {"params": {f"backbone/{p}": v for p, v in back["params"].items()}}
    again = state_dict_from_jax(port, tree)
    for key, value in port.state_dict().items():
        assert torch.equal(again[key], value), key


def test_swinv2_structure():
    """SwinV2-B and -L at 256² (built on the meta device): depths, heads,
    windows and shifts, the token map, and no buffers."""
    with torch.device("meta"):
        base = VisionModel("swinv2_base_window8_256", 35, backbone_kwargs={"img_size": 256}).backbone
        large = VisionModel("swinv2_large_window12to16_192to256", 35, backbone_kwargs={"img_size": 256}).backbone
    blocks = [b for stage in base.layers for b in stage.blocks]
    assert len(blocks) == 24 and [len(s.blocks) for s in base.layers] == [2, 2, 18, 2]
    assert [b.attn.num_heads for b in blocks[:4]] == [4, 4, 8, 8] and blocks[-1].attn.num_heads == 32
    assert all(b.window_size == 8 for b in blocks) and [b.shift for b in blocks[:4]] == [0, 4, 0, 4]
    assert [b.shift for b in blocks[-2:]] == [0, 0] and blocks[0].norm1.eps == 1e-5
    assert base.feature_shape == (64, 1024) and not list(base.buffers())
    assert tuple(blocks[0].attn.logit_scale.shape) == (4, 1, 1)
    assert tuple(blocks[0].attn.qkv.bias.shape) == (384,)
    large_blocks = [b for stage in large.layers for b in stage.blocks]
    assert [b.window_size for b in large_blocks] == [16] * 22 + [8] * 2  # N = 256 in stages 0-2


def test_unported_swinv2_options_raise():
    model = get_model(_cls_cfg(), device="cpu")
    with pytest.raises(ValueError, match="built for 32"):
        model(torch.zeros((1, 40, 40, 3)))
    with pytest.raises(TypeError):  # no BatchNorm: bn_freeze has nothing to act on, as in the JAX model
        get_model({**_cls_cfg(), "bn_freeze": True}, device="cpu")
