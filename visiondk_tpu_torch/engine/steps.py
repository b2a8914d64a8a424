"""Serving steps (counterpart of ``visiondk_tpu/engine/steps.py``).

``make_eval_step`` and ``make_embed_step`` return callables ``step(batch)``
that take ``{"image": uint8 [B, H, W, 3]}``, normalise it on the model's
device and run the forward under ``torch.inference_mode()``. The module
carries its own weights, so where the JAX steps choose ``state.params`` or
``state.ema_params`` (``use_ema``), the caller here passes the module it
wants served. Training steps, EMA and int8 serving are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence, Tuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Static configuration of a step. Only the fields serving reads are
    ported; task, mixup/SAM/OHEM/EMA arrive with the training steps."""

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


def make_eval_step(model: nn.Module, cfg: StepConfig) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
    """Classification eval: batch → f32 logits [B, num_classes]. Puts
    ``model`` in eval mode (BatchNorm running stats, no dropout)."""
    model.eval()
    device = _device(model)

    def eval_fn(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.inference_mode():
            images = device_preprocess(batch["image"].to(device, non_blocking=True), cfg.mean, cfg.std)
            return model(images).to(torch.float32)

    return eval_fn


def make_embed_step(model: nn.Module, cfg: StepConfig) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
    """Embedding extraction: batch → L2-normalised f32 [B, feat_dim],
    ``x / max(‖x‖, 1e-12)``. Puts ``model`` in eval mode."""
    model.eval()
    device = _device(model)

    def embed_fn(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.inference_mode():
            images = device_preprocess(batch["image"].to(device, non_blocking=True), cfg.mean, cfg.std)
            feats = model.embed(images).to(torch.float32)
            norm = torch.linalg.vector_norm(feats, dim=1, keepdim=True)
            return feats / norm.clamp_min(1e-12)

    return embed_fn
