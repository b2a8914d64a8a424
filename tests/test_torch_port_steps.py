"""visiondk_tpu_torch.engine.steps against the JAX package's serving steps.

The JAX ``make_eval_step`` / ``make_embed_step`` run over
``create_train_state(variables, optax.sgd(0.0))`` with ``use_ema=False``; the
port's steps run the same weights (bridged) on the same uint8 batch, drawn
from a numpy seed. f32 compute; rtol 1e-3, atol 3e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from visiondk_tpu.engine.state import create_train_state
from visiondk_tpu.engine.steps import StepConfig as JaxStepConfig
from visiondk_tpu.engine.steps import device_preprocess as jax_device_preprocess
from visiondk_tpu.engine.steps import make_embed_step as jax_make_embed_step
from visiondk_tpu.engine.steps import make_eval_step as jax_make_eval_step
from visiondk_tpu.models import get_model as jax_get_model
from visiondk_tpu.models.backbones import BACKBONES as JAX_BACKBONES
from visiondk_tpu.models.backbones.vit import _vit as jax_vit
from visiondk_tpu.models.convert import _flatten
from visiondk_tpu_torch.engine.steps import (
    StepConfig, device_preprocess, make_embed_step, make_eval_step,
)
from visiondk_tpu_torch.models import BACKBONES, EmbeddingNeck, get_model
from visiondk_tpu_torch.models.backbones.vit import _vit
from visiondk_tpu_torch.models.convert import load_jax_params

TINY = "vit_tiny_patch8_port_steps_test"
IMG = 32
RTOL, ATOL = 1e-3, 3e-4


@pytest.fixture(scope="module", autouse=True)
def tiny_vit_registered():
    JAX_BACKBONES.register(jax_vit(8, 64, 2, 4), name=TINY)
    BACKBONES.register(_vit(8, 64, 2, 4), name=TINY)
    yield
    del JAX_BACKBONES._store[TINY]
    del BACKBONES._store[TINY]


def _batch(seed=0, n=4):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(n, IMG, IMG, 3), dtype=np.uint8)


def _jax_and_port(cfg, embed):
    """A JAX model with initialised variables, and the port model carrying
    the same weights (BatchNorm statistics re-drawn so they are not trivial)."""
    jmodel = jax_get_model(cfg)
    x = jnp.zeros((1, IMG, IMG, 3))
    kw = {"method": jmodel.embed} if embed else {}
    variables = jmodel.init(jax.random.key(1), x, train=False, **kw)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    rng = np.random.default_rng(5)
    if "batch_stats" in variables:
        variables["batch_stats"] = jax.tree_util.tree_map(
            lambda v: (0.5 + rng.random(v.shape)).astype(np.float32), variables["batch_stats"]
        )
    tree = {t: _flatten(dict(v)) for t, v in variables.items()}
    port = load_jax_params(get_model(cfg, device="cpu"), tree)
    state = create_train_state(jax.tree_util.tree_map(jnp.asarray, variables), optax.sgd(0.0))
    return jmodel, state, port


def test_device_preprocess_matches_jax():
    images = _batch(0)
    ref = np.asarray(jax_device_preprocess(jnp.asarray(images), JaxStepConfig().mean, JaxStepConfig().std))
    cfg = StepConfig()
    out = device_preprocess(torch.from_numpy(images), cfg.mean, cfg.std)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_eval_step_matches_jax():
    cfg = {"task": "classification", "name": TINY, "num_classes": 7, "image_size": IMG}
    jmodel, state, port = _jax_and_port(cfg, embed=False)
    images = _batch(1)
    ref = np.asarray(jax_make_eval_step(jmodel, JaxStepConfig(), use_ema=False)(
        state, {"image": jnp.asarray(images)}
    ))
    logits = make_eval_step(port, StepConfig())({"image": torch.from_numpy(images)})
    assert logits.dtype == torch.float32 and logits.shape == (4, 7)
    assert logits.is_inference() and not port.training
    np.testing.assert_allclose(logits.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_embed_step_matches_jax():
    cfg = {"task": "cbir", "backbone": {TINY: {"feat_dim": 16, "image_size": IMG}}}
    jmodel, state, port = _jax_and_port(cfg, embed=True)
    images = _batch(2)
    ref = np.asarray(jax_make_embed_step(jmodel, JaxStepConfig(), use_ema=False)(
        state, {"image": jnp.asarray(images)}
    ))
    feats = make_embed_step(port, StepConfig())({"image": torch.from_numpy(images)})
    assert feats.dtype == torch.float32 and feats.shape == (4, 16)
    np.testing.assert_allclose(torch.linalg.vector_norm(feats, dim=1).numpy(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(feats.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_embed_step_keeps_a_zero_embedding_finite():
    cfg = {"task": "cbir", "backbone": {TINY: {"feat_dim": 16, "image_size": IMG}}}
    port = get_model(cfg, device="cpu")
    with torch.no_grad():
        port.neck.bn_out.weight.zero_()
        port.neck.bn_out.bias.zero_()
    feats = make_embed_step(port, StepConfig())({"image": torch.from_numpy(_batch(3))})
    assert torch.equal(feats, torch.zeros_like(feats))  # x / max(‖x‖, 1e-12), not NaN


def test_embedding_neck_batchnorm_updates_stats_as_flax():
    """The neck's bn_out in train mode against flax ``nn.BatchNorm`` (momentum
    0.9, eps 1e-5) over three steps from the same scale, bias and statistics:
    outputs and ``batch_stats``. flax updates the running variance with the
    biased batch variance; torch's own BatchNorm1d takes the unbiased one, 8/7
    of it at batch 8."""
    rng = np.random.default_rng(9)
    feat = 16
    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    params = {"scale": (1 + 0.1 * rng.normal(size=feat)).astype(np.float32),
              "bias": (0.1 * rng.normal(size=feat)).astype(np.float32)}
    stats = {"mean": rng.normal(size=feat).astype(np.float32),
             "var": (0.5 + rng.random(feat)).astype(np.float32)}
    bn = EmbeddingNeck((4, 8), feat).bn_out.train()
    with torch.no_grad():
        for name, value in (("weight", params["scale"]), ("bias", params["bias"]),
                            ("running_mean", stats["mean"]), ("running_var", stats["var"])):
            getattr(bn, name).copy_(torch.from_numpy(value))
    for _ in range(3):
        x = (1.0 + 2.0 * rng.normal(size=(8, feat))).astype(np.float32)
        ref, updated = flax_bn.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                     mutable=["batch_stats"])
        stats = jax.tree_util.tree_map(np.asarray, dict(updated["batch_stats"]))
        out = bn(torch.from_numpy(x))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(), stats["var"], rtol=1e-6, atol=1e-6)
    assert bn.num_batches_tracked.item() == 3
