"""Train, eval and embed steps (counterpart of ``visiondk_tpu/engine/steps.py``).

``make_train_step`` returns ``step(state, batch, lam=0.0)`` for
``{"image": uint8 [B, H, W, 3], "label": int [B] or f32 [B, C]}``: the JAX
step's chain, uint8 batch → the device-augment stage where one is given →
normalise on the device → forward in train mode
→ loss → backward → clip → optimizer → EMA, run eagerly and in place on the
state (see ``make_train_step``). Ported: the plain classification variant
and the embedding task (``task="embedding"``: the model's margin head gives
``(logits, aux)`` and the loss is ``lossfn(logits, labels) + aux``). Mixup,
SAM and OHEM raise ``NotImplementedError``.

``make_eval_step`` and ``make_embed_step`` return callables ``step(batch)``
that take ``{"image": uint8 [B, H, W, 3]}``, normalise it on the model's
device and run the forward in eval mode under ``torch.inference_mode()``.
The module carries its own weights, so where the JAX steps choose
``state.params`` or ``state.ema_params`` (``use_ema``), the caller passes
the module it wants served (``state.model`` or ``state.ema_model``). int8
serving is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from visiondk_tpu_torch.engine.optim import OptimizerSpec, SAMConfig
from visiondk_tpu_torch.engine.state import TrainState
from visiondk_tpu_torch.models.ema import update_ema


@dataclasses.dataclass(frozen=True)
class OHEMConfig:
    min_kept: int = 8
    thresh: float = 0.7
    ignore_index: int = 255


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Static configuration of a step variant."""

    task: str = "classification"        # "classification" | "embedding"
    mixup: bool = False
    sam: Optional[SAMConfig] = None
    ohem: Optional[OHEMConfig] = None
    ema_decay: float = 0.9999
    ema_tau: float = 2000.0
    mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: Tuple[float, float, float] = (0.229, 0.224, 0.225)


def device_preprocess(images: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """uint8 NHWC → normalised f32 NHWC, on the images' device."""
    if images.dtype == torch.uint8:
        images = images.to(torch.float32) / 255.0
    mean_t = torch.as_tensor(mean, dtype=torch.float32, device=images.device)
    std_t = torch.as_tensor(std, dtype=torch.float32, device=images.device)
    return (images - mean_t) / std_t


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def make_train_step(
    model: nn.Module,
    tx: OptimizerSpec,
    lossfn: Callable,
    cfg: StepConfig,
    generator: torch.Generator,
    device_augment: Optional[Callable[[int, torch.Tensor], torch.Tensor]] = None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build ``step(state, batch, lam=0.0) -> {"loss": f32 scalar tensor}``.

    Each call, on ``state.model`` (which must be ``model``): train mode,
    normalise the uint8 batch on the model's device, forward, ``lossfn``,
    backward, then ``tx.update`` (clip, schedules, optimizer step) and the
    EMA update, and ``state.step += 1`` (for ``task="embedding"`` the
    forward is ``model(images, labels)``, the margin head's ``(logits, aux)``,
    and the loss ``lossfn(logits, labels) + aux``). The state is updated in place; the
    clipped gradients stay in ``.grad`` until the next call clears them.
    Dropout and DropPath draw from a seed taken from ``generator`` (a CPU
    ``torch.Generator``) on every call (the JAX step folds the step into its
    key), so two runs from the same generator state draw the same masks.
    ``device_augment`` (``ops/device_augment.make_device_augment``) runs on
    the uint8 batch on the model's device before normalisation, seeded by a
    second draw from ``generator`` after the dropout seed's: a checkpoint
    carries the generator, so a resumed run draws the same augments.
    ``lam`` is the mixup weight, unused until mixup is ported.
    """
    for what, on in (("mixup", cfg.mixup), ("SAM", cfg.sam is not None), ("OHEM", cfg.ohem is not None)):
        if on:
            raise NotImplementedError(f"{what} in the train step is not ported yet")
    device = _device(model)

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor], lam: float = 0.0):
        if state.model is not model:
            raise ValueError("the state holds another model than the one this step was built for")
        model.train()
        images = batch["image"].to(device, non_blocking=True)
        labels = batch["label"].to(device, non_blocking=True)
        seed = int(torch.randint(0, 2**62, (), generator=generator))
        if device_augment is not None:
            images = device_augment(int(torch.randint(0, 2**62, (), generator=generator)), images)
        images = device_preprocess(images, cfg.mean, cfg.std)
        for p in model.parameters():
            p.grad = None
        with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
            torch.manual_seed(seed)
            if cfg.task == "embedding":
                logits, aux = model(images, labels)
                loss = lossfn(logits, labels) + aux
            else:
                loss = lossfn(model(images), labels)
        loss.backward()
        apply_update(state, tx, cfg)
        return {"loss": loss.detach()}

    return step_fn


def apply_update(state: TrainState, tx: OptimizerSpec, cfg: StepConfig) -> None:
    """The end of every train step, from the gradients in ``.grad``: the
    optimizer update (clip, schedules, step), the EMA update, step += 1."""
    tx.update(state.optimizer)
    state.ema_updates += 1
    update_ema(state.ema_model, state.model, state.ema_updates, cfg.ema_decay, cfg.ema_tau)
    state.step += 1


def make_eval_step(model: nn.Module, cfg: StepConfig) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
    """Classification eval: batch → f32 logits [B, num_classes]. Puts
    ``model`` in eval mode on every call (BatchNorm running stats, no
    dropout or DropPath), as the JAX step passes ``train=False``: a train
    step on the same model may have left it in train mode."""
    device = _device(model)

    def eval_fn(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            images = device_preprocess(batch["image"].to(device, non_blocking=True), cfg.mean, cfg.std)
            return model(images).to(torch.float32)

    return eval_fn


def make_embed_step(model: nn.Module, cfg: StepConfig) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
    """Embedding extraction: batch → L2-normalised f32 [B, feat_dim],
    ``x / max(‖x‖, 1e-12)``. Puts ``model`` in eval mode on every call."""
    device = _device(model)

    def embed_fn(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            images = device_preprocess(batch["image"].to(device, non_blocking=True), cfg.mean, cfg.std)
            feats = model.embed(images).to(torch.float32)
            norm = torch.linalg.vector_norm(feats, dim=1, keepdim=True)
            return feats / norm.clamp_min(1e-12)

    return embed_fn
