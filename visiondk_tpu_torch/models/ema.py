"""Exponential moving average of a model (counterpart of ``visiondk_tpu/models/ema.py``).

An f32 shadow of every floating-point parameter and buffer (BatchNorm
statistics included), with the ramped decay
``d(updates) = decay · (1 − e^(−updates/tau))`` so early updates track the
model closely; non-float buffers are copied from the live model. The shadow
is a copy of the module (``init_ema``), so eval serves it as it serves the
live model; ``update_ema`` updates it in place.
"""

from __future__ import annotations

import copy
import itertools
import math
from typing import List

import torch
from torch import nn


def _float_tensors(model: nn.Module) -> List[torch.Tensor]:
    return [t for t in itertools.chain(model.parameters(), model.buffers()) if t.is_floating_point()]


def _other_buffers(model: nn.Module) -> List[torch.Tensor]:
    return [b for b in model.buffers() if not b.is_floating_point()]


def init_ema(model: nn.Module) -> nn.Module:
    """A copy of ``model`` with f32 float tensors, no gradients, in eval mode."""
    ema = copy.deepcopy(model).requires_grad_(False).eval()
    with torch.no_grad():
        for t in _float_tensors(ema):
            t.grad = None
            t.data = t.data.float()
    return ema


def ema_decay(updates: int, decay: float = 0.9999, tau: float = 2000.0) -> float:
    return decay * (1.0 - math.exp(-updates / tau))


@torch.no_grad()
def update_ema(
    ema_model: nn.Module, model: nn.Module, updates: int, decay: float = 0.9999, tau: float = 2000.0
) -> None:
    """One EMA step in place: ``e ← d·e + (1 − d)·m``. ``updates`` is the
    count after the increment (the reference increments before computing d)."""
    d = ema_decay(updates, decay, tau)
    live = [t.float() for t in _float_tensors(model)]
    torch._foreach_lerp_(_float_tensors(ema_model), live, 1.0 - d)
    for e, m in zip(_other_buffers(ema_model), _other_buffers(model)):
        e.copy_(m)
