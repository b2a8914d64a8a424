"""LR / momentum schedules as plain functions of a float epoch ``t``
(counterpart of ``visiondk_tpu/engine/schedules.py``).

- ``linear``            lr(t) = lr0 · (1 + (r−1)·min(t,T)/T)
- ``cosine``            lr(t) = eta_min + (lr0−eta_min)·(1+cos(π·t/T))/2
- ``linear_with_warm``  linear 0.1→1 over warm_ep, then linear 1→r over T−warm
- ``cosine_with_warm``  linear 0.1→1 over warm_ep, then cosine over T−warm
  with r = lrf_ratio (default 0.1), eta_min = r·lr0.

The JAX schedules run inside the jitted step on traced values; here ``t`` is
a Python float computed on the host from the count of applied updates
(``engine/trainer.py::build_tx``), so no device value is read.

Also here: the warm-up momentum swap (``warmup_momentum`` during the warm
epochs, the nominal momentum after).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

from visiondk_tpu_torch.registry import Registry

SCHEDULER = Registry("scheduler")


def _r(lrf_ratio: Optional[float]) -> float:
    return 0.1 if lrf_ratio is None else lrf_ratio


def _clip01(x: float) -> float:
    return min(max(x, 0.0), 1.0)


@SCHEDULER.register(name="linear")
def linear(warm_ep: int, epochs: int, lr0: float, lrf_ratio: Optional[float] = None) -> Callable:
    r = _r(lrf_ratio)

    def fn(t: float) -> float:
        return lr0 * (1.0 + (r - 1.0) * _clip01(t / epochs))

    return fn


@SCHEDULER.register(name="cosine")
def cosine(warm_ep: int, epochs: int, lr0: float, lrf_ratio: Optional[float] = None) -> Callable:
    eta_min = _r(lrf_ratio) * lr0

    def fn(t: float) -> float:
        return eta_min + (lr0 - eta_min) * 0.5 * (1.0 + math.cos(math.pi * _clip01(t / epochs)))

    return fn


def _warm(warm_ep: int, lr0: float, main: Callable) -> Callable:
    def fn(t: float) -> float:
        if t < warm_ep:
            return lr0 * (0.1 + 0.9 * _clip01(t / max(warm_ep, 1e-8)))
        return main(t)

    return fn


@SCHEDULER.register(name="linear_with_warm")
def linear_with_warm(warm_ep: int, epochs: int, lr0: float, lrf_ratio: Optional[float] = None) -> Callable:
    r = _r(lrf_ratio)

    def main(t: float) -> float:
        return lr0 * (1.0 + (r - 1.0) * _clip01((t - warm_ep) / max(epochs - warm_ep, 1e-8)))

    return _warm(warm_ep, lr0, main)


@SCHEDULER.register(name="cosine_with_warm")
def cosine_with_warm(warm_ep: int, epochs: int, lr0: float, lrf_ratio: Optional[float] = None) -> Callable:
    eta_min = _r(lrf_ratio) * lr0

    def main(t: float) -> float:
        frac = _clip01((t - warm_ep) / max(epochs - warm_ep, 1e-8))
        return eta_min + (lr0 - eta_min) * 0.5 * (1.0 + math.cos(math.pi * frac))

    return _warm(warm_ep, lr0, main)


def create_scheduler(
    name: str, warm_ep: int, epochs: int, lr0: float, lrf_ratio: Optional[float] = None
) -> Callable:
    return SCHEDULER.create(name, warm_ep, epochs, lr0, lrf_ratio)


def momentum_schedule(warm_ep: int, momentum: float, warmup_momentum: float) -> Callable:
    """Discrete swap at the warm-up boundary: ``warmup_momentum`` for t <
    warm_ep, ``momentum`` from then on."""

    def fn(t: float) -> float:
        return warmup_momentum if t < warm_ep else momentum

    return fn
