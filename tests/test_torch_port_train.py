"""visiondk_tpu_torch's training step and its parts against the JAX package.

Losses, schedules, the optimizer (clip, freeze, layer-wise lr), the EMA,
``build_tx`` and three whole train steps of a tiny ViT (patch 8, width 64,
depth 2, 32×32 images) each get the same inputs as their JAX counterparts:
arrays drawn from a numpy seed, weights carried across by the bridge
(``models/convert.py``), and results carried back through it, so both sides
are compared in the port's layout. All in f32.

Tolerances, each with its reason:
- losses and schedules: 1e-6 absolute (the same f32 formula, another
  library's kernels);
- optimizer, EMA and ``build_tx`` on a toy model: parameters to 1e-6
  absolute (the same update rule in f32; values are O(1)), 1e-5 for Adam,
  which divides by √v̂ with its bias corrections applied in another order
  (torch √v/√(1−β₂ᵗ), optax √(v/(1−β₂ᵗ))) on updates of lr·O(1) ≈ 0.1;
- the three train steps: the loss to 1e-5 relative; the update θₖ − θ₀ and
  the EMA's move from θ₀ to 1e-3 relative plus 1e-3 of the tensor's largest
  update. The two forwards differ in f32 summation order (the JAX ViT pads
  17 tokens to 24 and masks them; its attention is an einsum, the port's
  the fused op's plain version), which the backward and three updates carry
  through. Updates are compared, never θₖ alone: θ₀ dominates θₖ and would
  hide a wrong update.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from visiondk_tpu.engine.optim import create_optimizer as jax_create_optimizer
from visiondk_tpu.engine.schedules import create_scheduler as jax_create_scheduler
from visiondk_tpu.engine.schedules import momentum_schedule as jax_momentum_schedule
from visiondk_tpu.engine.state import create_train_state as jax_create_train_state
from visiondk_tpu.engine.steps import StepConfig as JaxStepConfig
from visiondk_tpu.engine.steps import make_train_step as jax_make_train_step
from visiondk_tpu.engine.trainer import CenterProcessor
from visiondk_tpu.losses import losses as JL
from visiondk_tpu.models import get_model as jax_get_model
from visiondk_tpu.models.backbones import BACKBONES as JAX_BACKBONES
from visiondk_tpu.models.backbones.vit import _vit as jax_vit
from visiondk_tpu.models.convert import _flatten, _unflatten
from visiondk_tpu.models.ema import init_ema as jax_init_ema
from visiondk_tpu.models.ema import update_ema as jax_update_ema
from visiondk_tpu_torch.engine.optim import create_optimizer
from visiondk_tpu_torch.engine.schedules import create_scheduler, momentum_schedule
from visiondk_tpu_torch.engine.state import create_train_state
from visiondk_tpu_torch.engine.steps import (
    OHEMConfig, StepConfig, device_preprocess, make_embed_step, make_eval_step, make_train_step,
)
from visiondk_tpu_torch.engine.optim import SAMConfig
from visiondk_tpu_torch.engine.trainer import build_tx
from visiondk_tpu_torch.losses import create_lossfn, list_lossfns
from visiondk_tpu_torch.losses import losses as L
from visiondk_tpu_torch.models import BACKBONES, get_model
from visiondk_tpu_torch.models.backbones.vit import _vit
from visiondk_tpu_torch.models.convert import load_jax_params, state_dict_from_jax
from visiondk_tpu_torch.models.ema import init_ema, update_ema

TINY = "vit_tiny_patch8_port_train_test"
IMG = 32
# the hyp: section of configs/classification/pet_synth.yaml (optimizer fields)
PET_SYNTH_HYP = {
    "epochs": 6, "lr0": 0.01, "lrf_ratio": None, "momentum": 0.937, "weight_decay": 0.0005,
    "warmup_momentum": 0.8, "warm_ep": 1, "optimizer": ["sgd", False], "scheduler": "cosine_with_warm",
}


@pytest.fixture(scope="module", autouse=True)
def tiny_vit_registered():
    JAX_BACKBONES.register(jax_vit(8, 64, 2, 4), name=TINY)
    BACKBONES.register(_vit(8, 64, 2, 4), name=TINY)
    yield
    del JAX_BACKBONES._store[TINY]
    del BACKBONES._store[TINY]


def _f(x) -> float:
    return float(np.asarray(x))


# ---------------------------------------------------------------- losses


def _logits(b=16, c=7, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, c)).astype(np.float32), rng.integers(0, c, size=b)


@pytest.mark.parametrize("smooth", [0.0, 0.05, 0.2])
@pytest.mark.parametrize("soft", [False, True])
def test_ce_matches_jax(smooth, soft):
    logits, labels = _logits()
    targets = np.eye(7, dtype=np.float32)[labels] * 0.7 + 0.3 / 7 if soft else labels
    ref = JL.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(targets), smooth)
    out = L.softmax_cross_entropy(torch.from_numpy(logits), torch.as_tensor(targets), smooth)
    assert out.dtype == torch.float32
    assert abs(out.item() - _f(ref)) < 1e-6


def test_ce_upcasts_bf16_logits_and_smooths_over_valid_classes_only():
    logits, labels = _logits(b=8, c=5, seed=3)
    padded = np.concatenate([logits, np.full((8, 3), -1e9, np.float32)], axis=1)
    for smooth in (0.05, 0.2):
        ref = JL.softmax_cross_entropy(jnp.asarray(padded), jnp.asarray(labels), smooth, valid_class=5)
        out = L.softmax_cross_entropy(torch.from_numpy(padded), torch.from_numpy(labels), smooth, valid_class=5)
        assert abs(out.item() - _f(ref)) < 1e-6 and out.item() < 10
    bf = torch.from_numpy(logits).bfloat16()
    out = L.softmax_cross_entropy(bf, torch.from_numpy(labels), 0.05)
    ref = JL.softmax_cross_entropy(jnp.asarray(bf.float().numpy()), jnp.asarray(labels), 0.05)
    assert out.dtype == torch.float32 and abs(out.item() - _f(ref)) < 1e-6


@pytest.mark.parametrize("weights", ["mask", "zeros"])
def test_sample_weight_is_a_masked_mean_with_denominator_at_least_one(weights):
    logits, labels = _logits()
    w = np.zeros(16, np.float32)
    if weights == "mask":
        w[:4] = 1.0
    ref = JL.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 0.05, jnp.asarray(w))
    out = L.softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), 0.05, torch.from_numpy(w))
    assert abs(out.item() - _f(ref)) < 1e-6


def test_bce_focal_and_distill_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(8, 5)).astype(np.float32)
    targets = (rng.random((8, 5)) > 0.5).astype(np.float32)
    teacher = rng.normal(size=(8, 5)).astype(np.float32)
    w = (rng.random(8) > 0.3).astype(np.float32)
    lt, tt = torch.from_numpy(logits), torch.from_numpy(targets)
    pairs = [
        (L.sigmoid_binary_cross_entropy(lt, tt), JL.sigmoid_binary_cross_entropy(logits, targets)),
        (L.sigmoid_binary_cross_entropy(lt, tt, torch.from_numpy(w)),
         JL.sigmoid_binary_cross_entropy(logits, targets, jnp.asarray(w))),
        (L.sigmoid_focal(lt, tt, 0.25, 1.5), JL.sigmoid_focal(logits, targets, 0.25, 1.5)),
        (L.distill_kl(lt, torch.from_numpy(teacher)), JL.distill_kl(logits, teacher)),
    ]
    for out, ref in pairs:
        assert abs(out.item() - _f(ref)) < 1e-6


def test_loss_registry_matches_jax():
    assert list_lossfns() == JL.list_lossfns()
    logits, labels = _logits()
    out = create_lossfn("ce", label_smooth=0.05)(torch.from_numpy(logits), torch.from_numpy(labels))
    ref = JL.create_lossfn("ce", label_smooth=0.05)(jnp.asarray(logits), jnp.asarray(labels))
    assert abs(out.item() - _f(ref)) < 1e-6


# ---------------------------------------------------------------- schedules


@pytest.mark.parametrize("name", ["linear", "cosine", "linear_with_warm", "cosine_with_warm"])
@pytest.mark.parametrize("warm", [0, 2])
def test_schedules_match_jax(name, warm):
    ref = jax_create_scheduler(name, warm, 12, 0.006, None)
    out = create_scheduler(name, warm, 12, 0.006, None)
    for t in [0, 0.5, 1, 1.99, 2, 2.5, 7, 11.75, 12, 15]:
        assert abs(out(t) - _f(ref(jnp.float32(t)))) < 1e-9, t
    mom, mom_ref = momentum_schedule(warm, 0.937, 0.8), jax_momentum_schedule(warm, 0.937, 0.8)
    for t in [0, 1, 1.5, 2, 3]:
        assert abs(mom(t) - _f(mom_ref(jnp.float32(t)))) < 1e-6


# ---------------------------------------------------------------- optimizer, EMA, build_tx


class Toy(nn.Module):
    """Top-level keys ``backbone``, ``bn`` and ``head``: the layer-wise and
    freeze labels of the JAX package tell them apart."""

    def __init__(self):
        super().__init__()
        self.backbone = nn.Linear(4, 3)
        self.bn = nn.BatchNorm1d(3)
        self.head = nn.Linear(3, 2)


_TOY_SHAPES = {"backbone/kernel": (4, 3), "backbone/bias": (3,), "bn/scale": (3,), "bn/bias": (3,),
               "head/kernel": (3, 2), "head/bias": (2,)}


def _toy_params(rng, scale=1.0):
    return {p: (scale * rng.normal(size=s)).astype(np.float32) for p, s in _TOY_SHAPES.items()}


def _toy_stats(rng):
    return {"bn/mean": rng.normal(size=3).astype(np.float32),
            "bn/var": (0.5 + rng.random(3)).astype(np.float32)}


def _port_layout(model, params, stats):
    """A JAX-layout tree in the port's state-dict layout, through the bridge."""
    return state_dict_from_jax(model, {"params": params, "batch_stats": stats})


def _set_grads(model, grads, stats):
    sd = _port_layout(model, grads, stats)
    for name, p in model.named_parameters():
        p.grad = sd[name].clone()


def _assert_params_close(model, jax_params, stats, atol=1e-6):
    want = _port_layout(model, {p: np.asarray(v) for p, v in jax_params.items()}, stats)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=atol, rtol=0, err_msg=name)


def _run_both(jtx, spec, steps, grad_scale, seed=0):
    """``steps`` updates of the same gradients through a JAX transform and the
    port's spec on the toy model; returns (port model, JAX params, stats)."""
    rng = np.random.default_rng(seed)
    params, stats = _toy_params(rng), _toy_stats(rng)
    model = load_jax_params(Toy(), {"params": params, "batch_stats": stats})
    state = create_train_state(model, spec)
    # the JAX labels read the nested tree (top-level keys, path parts)
    jparams = jax.tree_util.tree_map(jnp.asarray, _unflatten(params))
    opt_state = jtx.init(jparams)
    for _ in range(steps):
        grads = _toy_params(rng, grad_scale)
        jgrads = jax.tree_util.tree_map(jnp.asarray, _unflatten(grads))
        updates, opt_state = jtx.update(jgrads, opt_state, jparams)
        jparams = jax.tree_util.tree_map(lambda a, u: a + u, jparams, updates)
        _set_grads(model, grads, stats)
        spec.update(state.optimizer)
    assert state.optimizer.count == steps
    return model, _flatten(jparams), stats


OPT_CASES = {
    # name: (optimizer, options, gradient scale); the toy has 29 parameters, so
    # unit-normal gradients ×0.5 have a global norm of about 2.7 (no clip) and
    # ×10 of about 54 (the clip triggers)
    "sgd": ("sgd", {}, 0.5),
    "sgd_clipped": ("sgd", {}, 10.0),
    "adam_clipped": ("adam", {}, 10.0),
    "layer_wise": ("sgd", {"layer_wise_lr": True}, 0.5),
    "backbone_freeze_clipped": ("sgd", {"backbone_freeze": True}, 10.0),
    "bn_freeze_affine": ("sgd", {"bn_freeze_affine": True}, 0.5),
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_create_optimizer_matches_jax(case):
    name, opts, gscale = OPT_CASES[case]
    lr = lambda count: 0.05 * (1.0 + count)  # noqa: E731 — one formula for ints and traced counts
    jtx = jax_create_optimizer(name, lr, 5e-3, lambda c: jnp.where(c < 2, 0.8, 0.937),
                               params_example=None, **opts)
    spec = create_optimizer(name, lr, 5e-3, lambda c: 0.8 if c < 2 else 0.937, **opts)
    model, jparams, stats = _run_both(jtx, spec, steps=4, grad_scale=gscale)
    _assert_params_close(model, jparams, stats, atol=1e-5 if name == "adam" else 1e-6)
    if "freeze" in case:
        trainable = set(spec.labels(model))
        assert trainable < {n for n, _ in model.named_parameters()}  # some are left out


def test_frozen_parameters_get_zero_update_but_count_in_the_clip():
    rng = np.random.default_rng(7)
    params, stats = _toy_params(rng), _toy_stats(rng)
    model = load_jax_params(Toy(), {"params": params, "batch_stats": stats})
    spec = create_optimizer("sgd", lambda c: 0.1, 0.0, lambda c: 0.0, backbone_freeze=True)
    state = create_train_state(model, spec)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    grads = _toy_params(rng, 0.0)
    grads["backbone/kernel"][:] = 100.0  # only a frozen gradient is large
    grads["head/bias"][:] = 1.0
    _set_grads(model, grads, stats)
    spec.update(state.optimizer)
    for n, p in model.named_parameters():
        if not n.startswith("head"):
            assert torch.equal(p.detach(), before[n]), n
    norm = np.sqrt(12 * 100.0**2 + 2 * 1.0)
    np.testing.assert_allclose((before["head.bias"] - model.head.bias.detach()).numpy(), 0.1 * 10.0 / norm, rtol=1e-5)


def test_layer_wise_labels_by_top_level_flax_key():
    lr = lambda c: 1.0  # noqa: E731
    spec = create_optimizer("sgd", lr, 0.0, lr, layer_wise_lr=True)
    assert spec.labels(Toy()) == {"backbone.weight": 1.0, "backbone.bias": 1.0, "bn.weight": 1.0,
                                  "bn.bias": 1.0, "head.weight": 10.0, "head.bias": 10.0}
    # a VisionModel's top-level key is `backbone`: its own `head` is not boosted
    vit = get_model({"task": "classification", "name": TINY, "num_classes": 7, "image_size": IMG}, device="cpu")
    labels = spec.labels(vit)
    assert "backbone.head.weight" in labels and set(labels.values()) == {1.0}


def test_ema_matches_jax():
    rng = np.random.default_rng(2)
    params, stats = _toy_params(rng), _toy_stats(rng)
    model = load_jax_params(Toy(), {"params": params, "batch_stats": stats})
    ema = init_ema(model)
    assert not any(p.requires_grad for p in ema.parameters())
    jtree = {"params": {p: jnp.asarray(v) for p, v in params.items()},
             "batch_stats": {p: jnp.asarray(v) for p, v in stats.items()}}
    jema = jax_init_ema(jtree)
    for k in range(1, 4):
        live = {"params": _toy_params(rng), "batch_stats": _toy_stats(rng)}
        load_jax_params(model, live)
        model.bn.num_batches_tracked.fill_(k)
        update_ema(ema, model, k, decay=0.9, tau=3.0)  # a fast ramp, so every update moves the EMA
        jema = jax_update_ema(jema, jax.tree_util.tree_map(jnp.asarray, live), jnp.int32(k), 0.9, 3.0)
    want = _port_layout(model, {p: np.asarray(v) for p, v in jema["params"].items()},
                        {p: np.asarray(v) for p, v in jema["batch_stats"].items()})
    got = ema.state_dict()
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            assert got[key].item() == 3  # non-float buffers are copied
            continue
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), atol=1e-6, rtol=0, err_msg=key)


BUILD_TX_CASES = {
    "pet_synth_discrete": (PET_SYNTH_HYP, 2, True, {}),
    "pet_synth_per_batch": (PET_SYNTH_HYP, 3, False, {}),
    "layer_wise_head": ({**PET_SYNTH_HYP, "optimizer": ["sgd", True]}, 2, True, {}),
    "backbone_freeze": (PET_SYNTH_HYP, 2, True, {"backbone_freeze": True}),
    "adam_linear": ({**PET_SYNTH_HYP, "optimizer": ["adam"], "scheduler": "linear_with_warm"}, 2, True, {}),
}


@pytest.mark.parametrize("case", list(BUILD_TX_CASES))
def test_build_tx_matches_the_jax_trainer(case):
    hyp, spe, discrete, model_cfg = BUILD_TX_CASES[case]
    opt = hyp["optimizer"]
    fake = SimpleNamespace(hyp_cfg=hyp, opt_name=opt[0], layer_wise=len(opt) > 1 and bool(opt[1]),
                           model_cfg=model_cfg)
    jtx = CenterProcessor._build_tx(fake, spe, discrete)
    spec = build_tx(hyp, spe, discrete, model_cfg)
    for count in range(8):
        assert abs(spec.lr_schedule(count) - _f(fake._lr_fn(count))) < 1e-9
    # 6 updates cross the warm-up (lr ×10, momentum 0.8 → 0.937) at epoch 1
    model, jparams, stats = _run_both(jtx, spec, steps=6, grad_scale=0.5, seed=4)
    _assert_params_close(model, jparams, stats, atol=1e-5 if opt[0] == "adam" else 1e-6)


@pytest.mark.parametrize("hyp", [{**PET_SYNTH_HYP, "accumulate": 2}, {**PET_SYNTH_HYP, "optimizer": ["sam", False]}])
def test_build_tx_raises_for_what_is_not_ported(hyp):
    with pytest.raises(NotImplementedError):
        build_tx(hyp, 2, True)


# ---------------------------------------------------------------- the train step


def _cls_cfg(kwargs=None):
    return {"task": "classification", "name": TINY, "num_classes": 7, "image_size": IMG,
            "kwargs": dict(kwargs or {})}


def _batches(n, b=4, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 256, size=(b, IMG, IMG, 3), dtype=np.uint8),
             "label": rng.integers(0, 7, size=b).astype(np.int32)} for _ in range(n)]


def test_three_train_steps_match_jax():
    cfg = _cls_cfg()
    jmodel = jax_get_model(cfg)
    variables = jmodel.init(jax.random.key(1), jnp.zeros((1, IMG, IMG, 3)), train=False)
    rng = np.random.default_rng(6)
    params = {p: (0.1 * rng.normal(size=np.shape(v))).astype(np.float32) if not p.endswith("scale")
              else (1.0 + 0.1 * rng.normal(size=np.shape(v))).astype(np.float32)
              for p, v in _flatten(dict(variables["params"])).items()}
    port = load_jax_params(get_model(cfg, device="cpu"), {"params": params})
    theta0 = {k: v.clone() for k, v in port.state_dict().items()}

    fake = SimpleNamespace(hyp_cfg=PET_SYNTH_HYP, opt_name="sgd", layer_wise=False, model_cfg={})
    jtx = CenterProcessor._build_tx(fake, 2, True)
    jstate = jax_create_train_state({"params": jax.tree_util.tree_map(jnp.asarray, _unflatten(params))}, jtx)
    lossfn = "ce", {"label_smooth": 0.05}
    jstep = jax_make_train_step(jmodel, jtx, JL.create_lossfn(lossfn[0], **lossfn[1]), JaxStepConfig(),
                                jax.random.key(0), donate=False)

    tx = build_tx(PET_SYNTH_HYP, 2, True)
    state = create_train_state(port, tx)
    step = make_train_step(port, tx, create_lossfn(lossfn[0], **lossfn[1]), StepConfig(),
                           torch.Generator().manual_seed(0))
    for batch in _batches(3):
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.float32(0.0))
        metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert metrics["loss"].dtype == torch.float32
        np.testing.assert_allclose(metrics["loss"].item(), _f(jmetrics["loss"]), rtol=1e-5)
    assert state.step == 3 and state.ema_updates == 3 and state.optimizer.count == 3

    def check_moved(module, jtree, what):
        want = state_dict_from_jax(module, {"params": {p: np.asarray(v) for p, v in _flatten(dict(jtree)).items()}})
        for key, value in module.state_dict().items():
            got_d = (value - theta0[key]).numpy()
            want_d = (want[key] - theta0[key]).numpy()
            assert np.abs(want_d).max() > 0, (what, key)  # every tensor moved
            np.testing.assert_allclose(got_d, want_d, rtol=1e-3, atol=1e-3 * np.abs(want_d).max(),
                                       err_msg=f"{what} {key}")

    check_moved(port, jstate.params, "update")
    check_moved(state.ema_model, jstate.ema_params, "ema")


def test_train_step_then_eval_runs_in_eval_mode():
    """The serving steps set eval mode on every call, not once when built: a
    train step in between would leave DropPath and dropout on."""
    cfg = _cls_cfg({"stochastic_depth_prob": 0.5, "dropout": 0.2})
    model = get_model(cfg, device="cpu")
    eval_step = make_eval_step(model, StepConfig())
    tx = build_tx(PET_SYNTH_HYP, 2, True)
    state = create_train_state(model, tx)
    step = make_train_step(model, tx, create_lossfn("ce"), StepConfig(), torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    step(state, batch)
    assert model.training
    logits = eval_step({"image": batch["image"]})
    with torch.no_grad():
        ref = model.eval()(device_preprocess(batch["image"], StepConfig().mean, StepConfig().std))
    assert torch.equal(logits, ref)


def test_train_step_dropout_draws_follow_the_generator():
    """DropPath and dropout draw from a seed the generator gives each step:
    the same generator state gives the same run, another state another one."""
    batch = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}

    def losses(seed):
        model = get_model(_cls_cfg({"stochastic_depth_prob": 0.5, "dropout": 0.2}), device="cpu")
        tx = build_tx(PET_SYNTH_HYP, 2, True)
        state = create_train_state(model, tx)
        step = make_train_step(model, tx, create_lossfn("ce"), StepConfig(), torch.Generator().manual_seed(seed))
        return [step(state, batch)["loss"].item() for _ in range(2)]

    assert losses(0) == losses(0) != losses(1)


@pytest.mark.parametrize("kind", ["eval", "embed"])
def test_serving_steps_are_deterministic_after_model_train(kind):
    if kind == "eval":
        model = get_model(_cls_cfg({"stochastic_depth_prob": 0.5, "dropout": 0.2}), device="cpu")
        serve = make_eval_step(model, StepConfig())
        forward = model
    else:
        model = get_model({"task": "cbir", "backbone": {
            TINY: {"feat_dim": 16, "image_size": IMG, "stochastic_depth_prob": 0.5, "dropout": 0.2}}}, device="cpu")
        serve = make_embed_step(model, StepConfig())

        def forward(x):
            f = model.embed(x)
            return f / torch.linalg.vector_norm(f, dim=1, keepdim=True).clamp_min(1e-12)
    images = torch.from_numpy(_batches(1, b=6, seed=3)[0]["image"])
    buffers = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()
    a = serve({"image": images})
    model.train()
    b = serve({"image": images})
    assert torch.equal(a, b) and not model.training
    for k, v in model.state_dict().items():
        assert torch.equal(v, buffers[k]), k  # no BatchNorm statistics updated
    with torch.no_grad():
        ref = forward(device_preprocess(images, StepConfig().mean, StepConfig().std))
    assert torch.equal(a, ref)


@pytest.mark.parametrize("cfg", [
    StepConfig(task="embedding"), StepConfig(mixup=True), StepConfig(sam=SAMConfig()),
    StepConfig(ohem=OHEMConfig()),
], ids=["embedding", "mixup", "sam", "ohem"])
def test_train_step_variants_not_ported_raise(cfg):
    model = get_model(_cls_cfg(), device="cpu")
    with pytest.raises(NotImplementedError):
        make_train_step(model, build_tx(PET_SYNTH_HYP, 2, True), create_lossfn("ce"), cfg,
                        torch.Generator().manual_seed(0))
