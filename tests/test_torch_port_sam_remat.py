"""The port's SAM step and ``remat`` against the JAX package.

SAM: ``sam_perturb`` against the JAX one; train steps with ``StepConfig(sam=
SAMConfig())`` against the JAX ``make_train_step`` with no published mesh
(the single-device, global-ε branch of ``steps.py``): plain, with mixup and
OHEM (the port's ``mixup_permutation`` patched to the JAX step's
permutation, the same λ), with ``accumulate: 2`` (``optax.MultiSteps``), on
a tiny BatchNorm ResNet (the running statistics are the first pass's), and
an embedding step with an ArcFace head; and a ``run_classifier`` with
``optimizer: [sam, False]`` against the JAX trainer on a one-device mesh.
``remat``: one step with ``remat: true`` bit-identical to one without on the
CPU (DropPath on, so the recompute must draw the same masks), and its loss
against the JAX model's ``remat=True`` step, on ViT, Swin and SwinV2.

Inputs come from numpy seeds; weights are carried across by the bridge.
Tolerances, each the bar of the test file that holds the same step without
SAM: ``sam_perturb`` 1e-6 absolute (values O(1); the same f32 formula with
the norm summed in another order); ViT/Swin/SwinV2 steps, the loss within
1e-5 relative and every parameter's and EMA tensor's move from θ₀ within
1e-3 of its largest entry (``test_torch_port_train.py``); the ResNet step
against the JAX step in float64, the updates within 1e-3 of their norm plus
f32 spacings and the running statistics at rtol 1e-3, atol 3e-4
(``test_torch_port_resnet.py``); the embedding step's updates within 1e-5
of their largest entry plus one spacing (``test_torch_port_embedding.py``);
the run, train and val loss within 1e-4 relative and top1 within one image
(``test_torch_port_run.py``).
"""

import itertools
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import visiondk_tpu.data.native as jax_native
import visiondk_tpu.engine.trainer as jax_trainer
import visiondk_tpu_torch.data.native as port_native
from visiondk_tpu.config.loader import yaml_load as jax_yaml_load
from visiondk_tpu.engine.optim import SAMConfig as JaxSAMConfig
from visiondk_tpu.engine.optim import sam_perturb as jax_sam_perturb
from visiondk_tpu.engine.state import create_train_state as jax_create_train_state
from visiondk_tpu.engine.steps import OHEMConfig as JaxOHEMConfig
from visiondk_tpu.engine.steps import StepConfig as JaxStepConfig
from visiondk_tpu.engine.steps import make_train_step as jax_make_train_step
from visiondk_tpu.engine.trainer import CenterProcessor as JaxCenterProcessor
from visiondk_tpu.losses import losses as JL
from visiondk_tpu.models import get_model as jax_get_model
from visiondk_tpu.models.backbones import BACKBONES as JAX_BACKBONES
from visiondk_tpu.models.backbones import swinv2 as jax_swinv2
from visiondk_tpu.models.backbones.resnet import _resnet as jax_resnet
from visiondk_tpu.models.backbones.swin import _swin as jax_swin
from visiondk_tpu.models.backbones.vit import _vit as jax_vit
from visiondk_tpu.models.convert import _flatten, _unflatten, save_converted
from visiondk_tpu.parallel import build_mesh
from visiondk_tpu.utils.metrics_writer import MetricsWriter as JaxMetricsWriter
from visiondk_tpu_torch.config import check
from visiondk_tpu_torch.engine import steps as port_steps
from visiondk_tpu_torch.engine.optim import SAMConfig, sam_perturb
from visiondk_tpu_torch.engine.state import create_train_state
from visiondk_tpu_torch.engine.steps import OHEMConfig, StepConfig, make_train_step
from visiondk_tpu_torch.engine.trainer import CenterProcessor, build_tx
from visiondk_tpu_torch.losses import create_lossfn
from visiondk_tpu_torch.models import BACKBONES, get_model
from visiondk_tpu_torch.models.backbones.resnet import _resnet
from visiondk_tpu_torch.models.backbones.swin import _swin
from visiondk_tpu_torch.models.backbones.swinv2 import _swinv2
from visiondk_tpu_torch.models.backbones.vit import _vit
from visiondk_tpu_torch.models.convert import load_jax_params, state_dict_from_jax

IMG = 32
CLASSES = 7
# the hyp: section of configs/classification/pet_synth.yaml (optimizer fields), with SAM
SAM_HYP = {
    "epochs": 6, "lr0": 0.01, "lrf_ratio": None, "momentum": 0.937, "weight_decay": 0.0005,
    "warmup_momentum": 0.8, "warm_ep": 1, "optimizer": ["sam", False], "scheduler": "cosine_with_warm",
}
LOSS = ("ce", {"label_smooth": 0.05})
# name → (JAX factory, port factory): tiny models of each family, no stochastic depth by default
TINY = {
    "vit": ("vit_tiny_port_sam_test", jax_vit(8, 64, 2, 4), _vit(8, 64, 2, 4)),
    "swin": ("swin_tiny_port_sam_test", jax_swin(16, (2, 2), (2, 4), window_size=4),
             _swin(16, (2, 2), (2, 4), window_size=4)),
    "swinv2": ("swinv2_tiny_port_sam_test", jax_swinv2._swinv2(16, (2, 2), (2, 4), window_size=4),
               _swinv2(16, (2, 2), (2, 4), window_size=4)),
    "resnet": ("resnet_tiny_port_sam_test", jax_resnet([1, 1, 1, 1], "basic"), _resnet([1, 1, 1, 1], "basic")),
}


@pytest.fixture(scope="module", autouse=True)
def tiny_models_registered():
    for name, jax_factory, port_factory in TINY.values():
        JAX_BACKBONES.register(jax_factory, name=name)
        BACKBONES.register(port_factory, name=name)
    yield
    for name, *_ in TINY.values():
        del JAX_BACKBONES._store[name]
        del BACKBONES._store[name]


def _f(x) -> float:
    return float(np.asarray(x))


def _cfg(kind, **kwargs):
    return {"task": "classification", "name": TINY[kind][0], "num_classes": CLASSES, "image_size": IMG,
            "kwargs": kwargs}


def _batches(n, b=4, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 256, size=(b, IMG, IMG, 3), dtype=np.uint8),
             "label": rng.integers(0, CLASSES, size=b).astype(np.int32)} for _ in range(n)]


def _params(variables, seed=6):
    rng = np.random.default_rng(seed)
    return {p: (0.1 * rng.normal(size=np.shape(v))).astype(np.float32) if not p.endswith("scale")
            else (1.0 + 0.1 * rng.normal(size=np.shape(v))).astype(np.float32)
            for p, v in _flatten(dict(variables["params"])).items()}


def _both(cfg):
    """The JAX model, its initial params (numpy-drawn) and the port model holding them."""
    jmodel = jax_get_model(cfg)
    variables = jax.jit(lambda x: jmodel.init(jax.random.key(1), x, train=False))(jnp.zeros((1, IMG, IMG, 3)))
    params = _params(variables)
    return jmodel, params, load_jax_params(get_model(cfg, device="cpu"), {"params": params})


def _jax_tx(hyp, spe=2, discrete=True):
    fake = SimpleNamespace(hyp_cfg=hyp, opt_name="sgd", layer_wise=bool(hyp["optimizer"][1]), model_cfg={})
    return JaxCenterProcessor._build_tx(fake, spe, discrete)


def _check_moved(module, jtree, theta0, what):
    want = state_dict_from_jax(module, {"params": {p: np.asarray(v) for p, v in _flatten(dict(jtree)).items()}})
    for key, value in module.state_dict().items():
        got_d = (value - theta0[key]).numpy()
        want_d = (want[key] - theta0[key]).numpy()
        assert np.abs(want_d).max() > 0, (what, key)
        spacing = np.spacing(np.abs(want[key].numpy()).max())
        np.testing.assert_allclose(got_d, want_d, rtol=1e-3, atol=1e-3 * np.abs(want_d).max() + spacing,
                                   err_msg=f"{what} {key}")


# ---------------------------------------------------------------- sam_perturb


@pytest.mark.parametrize("adaptive", [True, False], ids=["adaptive", "plain"])
def test_sam_perturb_matches_jax(adaptive):
    """w + e(w) against the JAX ``sam_perturb`` over a tree of several
    tensors (the norm over all of them)."""
    rng = np.random.default_rng(11)
    shapes = {"a/kernel": (5, 3), "a/bias": (3,), "b/scale": (7,), "c/kernel": (2, 2, 3, 4)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = {k: (0.3 * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()}
    cfg = SAMConfig(rho=0.05, adaptive=adaptive)
    want = jax_sam_perturb({k: jnp.asarray(v) for k, v in params.items()},
                           {k: jnp.asarray(v) for k, v in grads.items()}, JaxSAMConfig(rho=0.05, adaptive=adaptive))
    keys = list(shapes)
    e = sam_perturb([torch.from_numpy(params[k]) for k in keys], [torch.from_numpy(grads[k]) for k in keys], cfg)
    for k, ek in zip(keys, e):
        assert ek.dtype == torch.float32 and ek.shape == shapes[k]
        np.testing.assert_allclose((torch.from_numpy(params[k]) + ek).numpy(), np.asarray(want[k]), rtol=0,
                                   atol=1e-6, err_msg=k)
    # ‖e‖ is ρ for the plain form; the adaptive form scales each entry by |p|
    scaled = [ek / (torch.from_numpy(params[k]).abs() if adaptive else 1.0) for k, ek in zip(keys, e)]
    norm = torch.sqrt(sum((s**2).sum() for s in scaled)).item()
    assert abs(norm - 0.05) < 1e-6


# ---------------------------------------------------------------- SAM steps of a tiny ViT


def _jax_perm(base_rng, step, b):
    perm_rng, _ = jax.random.split(jax.random.fold_in(base_rng, step))
    return np.array(jax.random.permutation(perm_rng, b))


SAM_STEP_CASES = {
    # name: (hyp changes, step options (mixup, OHEM), steps)
    "plain": ({}, {}, 3),
    "mixup_ohem": ({}, {"mixup": True, "ohem": (2, 0.1, 255)}, 3),
    "accumulate_2": ({"accumulate": 2}, {}, 4),
}


@pytest.mark.parametrize("case", list(SAM_STEP_CASES))
def test_sam_train_steps_match_jax(case, monkeypatch):
    """SAM steps of the tiny ViT against the JAX step (no published mesh:
    the global ε of a one-device run). With OHEM the mask comes from the
    clean parameters; with accumulation each mini-step's second gradients
    join the round's mean."""
    hyp_extra, opts, n_steps = SAM_STEP_CASES[case]
    hyp = {**SAM_HYP, **hyp_extra}
    jmodel, params, port = _both(_cfg("vit"))
    theta0 = {k: v.clone() for k, v in port.state_dict().items()}
    ohem = opts.get("ohem")
    jtx = _jax_tx(hyp)
    jstate = jax_create_train_state({"params": jax.tree_util.tree_map(jnp.asarray, _unflatten(params))}, jtx)
    base_rng = jax.random.key(0)
    jstep = jax_make_train_step(
        jmodel, jtx, JL.create_lossfn(LOSS[0], **LOSS[1]),
        JaxStepConfig(mixup=opts.get("mixup", False), sam=JaxSAMConfig(),
                      ohem=None if ohem is None else JaxOHEMConfig(*ohem)), base_rng, donate=False)
    tx = build_tx(hyp, 2, True)
    assert tx.name == "sam" and tx.accumulate == hyp.get("accumulate", 1)
    state = create_train_state(port, tx)
    step = make_train_step(port, tx, create_lossfn(LOSS[0], **LOSS[1]),
                           StepConfig(mixup=opts.get("mixup", False), sam=SAMConfig(),
                                      ohem=None if ohem is None else OHEMConfig(*ohem)),
                           torch.Generator().manual_seed(0))
    count = itertools.count()
    monkeypatch.setattr(port_steps, "mixup_permutation",
                        lambda b, generator: torch.from_numpy(_jax_perm(base_rng, next(count), b)))
    for i, batch in enumerate(_batches(n_steps)):
        lam = float(np.random.default_rng([0, 1, i]).beta(0.2, 0.2)) if opts.get("mixup") else 0.0
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.float32(lam))
        metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, lam)
        np.testing.assert_allclose(metrics["loss"].item(), _f(jmetrics["loss"]), rtol=1e-5)
    applied = n_steps // tx.accumulate
    assert (state.step, state.optimizer.count, state.ema_updates) == (n_steps, applied, applied)
    _check_moved(port, jstate.params, theta0, "update")
    _check_moved(state.ema_model, jstate.ema_params, theta0, "ema")


def test_sam_second_pass_sees_the_first_pass_draws(monkeypatch):
    """The second pass runs with the first pass's dropout and DropPath seed:
    with a zero ascent the second forward gives the first one's loss, and
    the SAM step's update is the plain step's, bit for bit."""
    cfg = _cfg("vit", stochastic_depth_prob=0.5, dropout=0.2)
    batch = {k: torch.from_numpy(v) for k, v in _batches(1, seed=3)[0].items()}
    losses = []
    monkeypatch.setattr(port_steps, "sam_perturb", lambda params, grads, sam_cfg: [torch.zeros_like(p) for p in params])
    real_loss = create_lossfn("ce")

    def loss_spy(logits, labels, *rest):
        loss = real_loss(logits, labels, *rest)
        losses.append(loss.item())
        return loss

    out = {}
    for sam in (None, SAMConfig()):
        model = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        tx = build_tx(SAM_HYP, 2, True)
        state = create_train_state(model, tx)
        make_train_step(model, tx, loss_spy, StepConfig(sam=sam), torch.Generator().manual_seed(4))(state, batch)
        out[sam is None] = {k: v.clone() for k, v in model.state_dict().items()}
    assert len(losses) == 3 and losses[1] == losses[2] == losses[0]  # the same draws at the same weights
    for key, value in out[True].items():
        assert torch.equal(value, out[False][key]), key


def test_sam_step_restores_the_clean_weights_bit_for_bit():
    """With a real ascent the step's update starts from the clean weights,
    not from (w + e) − e: θ₁ equals the SGD update applied to the copy."""
    cfg = _cfg("vit")
    batch = {k: torch.from_numpy(v) for k, v in _batches(1, seed=5)[0].items()}
    model = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    theta0 = [p.detach().clone() for p in model.parameters()]
    tx = build_tx({**SAM_HYP, "weight_decay": 0.0}, 2, True)
    state = create_train_state(model, tx)
    make_train_step(model, tx, create_lossfn("ce"), StepConfig(sam=SAMConfig()), torch.Generator().manual_seed(0))(
        state, batch)
    # one SGD step from zero momentum: θ₁ = θ₀ − lr·ĝ, ĝ the clipped second gradient left in .grad
    params = list(model.parameters())
    want = torch._foreach_add(theta0, [p.grad for p in params], alpha=-tx.lr_schedule(0))
    for p, w in zip(params, want):
        assert torch.equal(p.detach(), w)


# ---------------------------------------------------------------- SAM on a BatchNorm ResNet and an embedding model


def test_sam_steps_on_a_batchnorm_resnet_match_jax():
    """Three SAM steps of a tiny BN ResNet, the JAX step in float64 (the JAX
    package's f32 ResNet gradients on the CPU are the less exact ones; see
    ``test_torch_port_resnet.py``): the running statistics are the first
    pass's, as the JAX step keeps them."""
    cfg = _cfg("resnet")
    jmodel = jax_get_model(cfg)
    variables = jax.jit(lambda x: jmodel.init(jax.random.key(0), x, train=False))(jnp.zeros((1, IMG, IMG, 3)))
    rng = np.random.default_rng(100)
    tree = {"params": _params(variables, seed=100),
            "batch_stats": {p: (0.5 + rng.random(np.shape(v))).astype(np.float32) if p.endswith("/var")
                            else (0.1 * rng.normal(size=np.shape(v))).astype(np.float32)
                            for p, v in _flatten(dict(variables["batch_stats"])).items()}}
    port = load_jax_params(get_model(cfg, device="cpu"), tree)
    theta0 = {k: v.clone() for k, v in port.state_dict().items()}
    tx = build_tx(SAM_HYP, 2, True)
    state = create_train_state(port, tx)
    step = make_train_step(port, tx, create_lossfn("ce"), StepConfig(sam=SAMConfig()),
                           torch.Generator().manual_seed(0))
    batches = _batches(3, seed=8)
    with jax.enable_x64(True):
        jmodel = jax_get_model(cfg, dtype=jnp.float64)
        jstate = jax_create_train_state(
            {t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), _unflatten(flat))
             for t, flat in tree.items()}, _jax_tx(SAM_HYP))
        jstep = jax_make_train_step(jmodel, _jax_tx(SAM_HYP), JL.create_lossfn("ce"),
                                    JaxStepConfig(sam=JaxSAMConfig()), jax.random.key(0), donate=False)
        for batch in batches:
            jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.float64(0.0))
            metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
            np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), rtol=1e-5)
        flat = lambda t: {p: np.asarray(v) for p, v in _flatten(dict(t)).items()}  # noqa: E731
        jax_trees = [(port, flat(jstate.params), flat(jstate.batch_stats), "update"),
                     (state.ema_model, flat(jstate.ema_params), flat(jstate.ema_batch_stats), "ema")]
    n_stats = 0
    for module, params, stats, what in jax_trees:
        want = state_dict_from_jax(module, {"params": params, "batch_stats": stats})
        got = module.state_dict()
        for key, value in want.items():
            if key.endswith("num_batches_tracked"):
                continue
            if key.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got[key].numpy(), value.numpy(), rtol=1e-3, atol=3e-4,
                                           err_msg=f"{what} {key}")
                n_stats += 1
                continue
            got_d, want_d = (got[key] - theta0[key]).double().numpy(), (value - theta0[key]).double().numpy()
            assert np.abs(want_d).max() > 0, (what, key)
            spacing = np.sqrt(want_d.size) * np.spacing(np.abs(theta0[key].numpy()).max())
            err = np.linalg.norm(got_d - want_d)
            assert err <= 1e-3 * np.linalg.norm(want_d) + 3 * spacing, (what, key, err, np.linalg.norm(want_d))
    assert n_stats > 0
    # three steps moved the running statistics three times, from the clean passes alone
    assert int(port.backbone.bn1.num_batches_tracked) == 3


EMBED_HYP = {**SAM_HYP, "optimizer": ["sam", True], "lr0": 0.006, "epochs": 5}


def test_sam_embedding_step_with_an_arcface_head_matches_jax():
    """One SAM step of the face task (tiny Swin, 16-d neck with its
    BatchNorm, ArcFace over 7 classes; the JAX head padded to 128 columns),
    the margin head and its aux through both passes."""
    name = TINY["swin"][0]
    cfg = {"task": "face", "image_size": IMG,
           "backbone": {name: {"feat_dim": 16, "image_size": IMG, "mlp_ratio": 2.0, "stochastic_depth_prob": 0.0}},
           "head": {"arcface": {"feat_dim": 16, "num_class": CLASSES, "margin_arc": 0.35, "margin_am": 0.0,
                                "scale": 32}}}
    jmodel = jax_get_model(cfg, class_pad_multiple=128)
    variables = jmodel.init(jax.random.key(1), jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1,), jnp.int32), train=False)
    rng = np.random.default_rng(6)
    tree = {"params": _params(variables),
            "batch_stats": {p: (0.5 + rng.random(np.shape(v))).astype(np.float32) if p.endswith("/var")
                            else (0.1 * rng.normal(size=np.shape(v))).astype(np.float32)
                            for p, v in _flatten(dict(variables["batch_stats"])).items()}}
    port = load_jax_params(get_model(cfg, device="cpu"), tree)
    theta0 = {k: v.clone() for k, v in port.state_dict().items()}
    jtx = _jax_tx(EMBED_HYP, discrete=False)
    jstate = jax_create_train_state({t: jax.tree_util.tree_map(jnp.asarray, _unflatten(f)) for t, f in tree.items()},
                                    jtx)
    jstep = jax_make_train_step(jmodel, jtx, JL.create_lossfn("ce", valid_class=CLASSES),
                                JaxStepConfig(task="embedding", sam=JaxSAMConfig()), jax.random.key(0), donate=False)
    tx = build_tx(EMBED_HYP, 2, False)
    state = create_train_state(port, tx)
    step = make_train_step(port, tx, create_lossfn("ce", valid_class=CLASSES),
                           StepConfig(task="embedding", sam=SAMConfig()), torch.Generator().manual_seed(0))
    batch = {"image": rng.integers(0, 256, size=(6, IMG, IMG, 3), dtype=np.uint8),
             "label": rng.integers(0, CLASSES, size=6).astype(np.int32)}
    jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.float32(0.0))
    metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), rtol=1e-5)
    flat = {"params": {p: np.asarray(v) for p, v in _flatten(dict(jstate.params)).items()},
            "batch_stats": {p: np.asarray(v) for p, v in _flatten(dict(jstate.batch_stats)).items()}}
    want = state_dict_from_jax(port, flat)
    for key, value in port.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        got_d, want_d = (value - theta0[key]).numpy(), (want[key] - theta0[key]).numpy()
        assert np.abs(want_d).max() > 0, key
        spacing = np.spacing(np.abs(want[key].numpy()).max())
        np.testing.assert_allclose(got_d, want_d, rtol=0, atol=1e-5 * np.abs(want_d).max() + spacing, err_msg=key)


# ---------------------------------------------------------------- remat


@pytest.mark.parametrize("kind", ["vit", "swin", "swinv2"])
def test_remat_step_is_bit_identical_and_matches_jax_remat(kind):
    """``kwargs: {remat: true}``: with DropPath and dropout on, one step
    recomputing each block in the backward gives the same loss, parameters
    and EMA bit for bit as one that keeps the activations (the recompute
    replays the RNG); without them, the remat step's loss against the JAX
    model's ``remat=True`` step at 1e-5."""
    drop = {"stochastic_depth_prob": 0.3} if kind != "vit" else {"stochastic_depth_prob": 0.3, "dropout": 0.1}
    batch = {k: torch.from_numpy(v) for k, v in _batches(1, seed=9)[0].items()}
    out = []
    for remat in (False, True):
        model = get_model(_cfg(kind, remat=remat, **drop), device="cpu", generator=torch.Generator().manual_seed(0))
        blocks = [m for m in model.modules() if type(m).__name__.endswith("Block")]
        assert blocks
        tx = build_tx({**SAM_HYP, "optimizer": ["sgd", False]}, 2, True)
        state = create_train_state(model, tx)
        step = make_train_step(model, tx, create_lossfn("ce"), StepConfig(), torch.Generator().manual_seed(2))
        losses = [step(state, batch)["loss"].item() for _ in range(2)]
        out.append((losses, model.state_dict(), state.ema_model.state_dict()))
    (l0, m0, e0), (l1, m1, e1) = out
    assert l0 == l1
    for key in m0:
        assert torch.equal(m0[key], m1[key]) and torch.equal(e0[key], e1[key]), key

    cfg = _cfg(kind, remat=True, stochastic_depth_prob=0.0)
    jmodel, params, port = _both(cfg)
    jtx = _jax_tx({**SAM_HYP, "optimizer": ["sgd", False]})
    jstate = jax_create_train_state({"params": jax.tree_util.tree_map(jnp.asarray, _unflatten(params))}, jtx)
    jstep = jax_make_train_step(jmodel, jtx, JL.create_lossfn(*LOSS[:1], **LOSS[1]), JaxStepConfig(),
                                jax.random.key(0), donate=False)
    tx = build_tx({**SAM_HYP, "optimizer": ["sgd", False]}, 2, True)
    state = create_train_state(port, tx)
    step = make_train_step(port, tx, create_lossfn(LOSS[0], **LOSS[1]), StepConfig(), torch.Generator().manual_seed(0))
    for batch in _batches(2, seed=10):
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.float32(0.0))
        metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(metrics["loss"].item(), _f(jmetrics["loss"]), rtol=1e-5)


def test_remat_acts_only_in_train_mode_with_grad():
    """Eval forwards and no-grad forwards (OHEM's) run the blocks directly:
    the same logits with and without ``remat``."""
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, IMG, IMG, 3)).astype(np.float32))
    a = get_model(_cfg("vit", remat=True), device="cpu", generator=torch.Generator().manual_seed(0))
    b = get_model(_cfg("vit"), device="cpu", generator=torch.Generator().manual_seed(0))
    assert a.backbone.remat and not b.backbone.remat
    for train in (False, True):
        a.train(train)
        b.train(train)
        with torch.no_grad():
            assert torch.equal(a(x), b(x))


# ---------------------------------------------------------------- a SAM run


SIZE = 32
N_TRAIN, N_VAL = 8, 4  # per class: 3 steps of 16 an epoch
EPOCHS = 2
LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True)
def pil_decode(monkeypatch):
    monkeypatch.setattr(jax_native, "native_available", lambda: False)
    monkeypatch.setattr(port_native, "native_available", lambda: False)


def _resized(augment):
    for item in augment:
        for params in item.values():
            if isinstance(params, dict):
                if "size" in params:
                    params["size"] = SIZE
                _resized(params.get("transforms", []))
    return augment


@pytest.fixture(scope="module")
def toy(tmp_path_factory, tiny_models_registered):
    """pet_synth.yaml cut to toy data (as ``test_torch_port_strategies.py``'s)
    with ``optimizer: [sam, False]``."""
    from PIL import Image

    root = tmp_path_factory.mktemp("toy_sam")
    rng = np.random.default_rng(0)
    for split, n in (("train", N_TRAIN), ("val", N_VAL)):
        for c in range(CLASSES):
            d = root / "data" / split / f"class_{c}"
            d.mkdir(parents=True)
            for i in range(n):
                h, w = (int(x) for x in rng.integers(30, 64, size=2))
                base = np.array([(37 * c) % 256, (91 * c + 40) % 256, 255 - 30 * c])
                arr = np.clip(rng.normal(base, 45, size=(h, w, 3)), 0, 255).astype(np.uint8)
                Image.fromarray(arr).save(d / f"{i}.jpg", quality=90)
    cfg = jax_yaml_load("configs/classification/pet_synth.yaml")
    cfg["model"].update(name=TINY["vit"][0], image_size=SIZE, num_classes=CLASSES)
    variables = jax_get_model(cfg["model"]).init(jax.random.key(3), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    npz = root / "init.npz"
    save_converted({"params": {p: np.asarray(v) for p, v in _flatten(dict(variables["params"]["backbone"])).items()}},
                   str(npz))
    cfg["model"]["convert_npz"] = str(npz)
    cfg["data"]["root"] = str(root / "data")
    cfg["data"]["nw"] = 2
    cfg["data"]["train"].update(bs=16, device_augment=False, aug_epoch=2)
    cfg["data"]["val"]["bs"] = 16
    _resized(cfg["data"]["train"]["augment"])
    _resized(cfg["data"]["val"]["augment"])
    cfg["hyp"]["epochs"] = EPOCHS
    cfg["hyp"]["optimizer"] = ["sam", False]
    check("classification", cfg)
    return cfg


def _metrics(project: Path) -> dict:
    out = {}
    for line in (project / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        out.setdefault(rec["tag"], {})[rec["step"]] = rec["value"]
    return out


def test_sam_run_matches_the_jax_trainer_on_one_device(toy, tmp_path, monkeypatch):
    """``run_classifier`` with ``optimizer: [sam, False]`` against the JAX
    trainer on a one-device mesh (where its per-device ε is the global ε)."""
    monkeypatch.setattr(jax_trainer, "MetricsWriter", lambda logdir: JaxMetricsWriter(logdir, use_tensorboard=False))
    mesh1 = build_mesh(devices=jax.devices()[:1])
    JaxCenterProcessor(json.loads(json.dumps(toy)), project=str(tmp_path / "jax"), train=True, mesh=mesh1,
                       compute_dtype=jnp.float32, seed=0).run_classifier()
    cp = CenterProcessor(json.loads(json.dumps(toy)), project=str(tmp_path / "port"), device="cpu",
                         compute_dtype=torch.float32, seed=0)
    assert cp.sam_cfg == SAMConfig(local_perturb=True) and cp.step_config().sam == cp.sam_cfg
    cp.run_classifier()
    got, want = _metrics(tmp_path / "port"), _metrics(tmp_path / "jax")
    for epoch in range(EPOCHS):
        for tag in ("Train_loss", "Val_v_loss"):
            a, b = got[tag][epoch], want[tag][epoch]
            assert abs(a - b) <= LOSS_RTOL * abs(b), (tag, epoch, a, b)
        assert abs(got["Val_top1"][epoch] - want["Val_top1"][epoch]) * N_VAL * CLASSES <= 1 + 1e-9, epoch
    steps = EPOCHS * (N_TRAIN * CLASSES // 16)
    state = cp.ckpt.read("last")
    assert (state["step"], state["opt_count"], state["ema_updates"]) == (steps, steps, steps)
