"""Optimizers: sgd / adam with clip, freeze and layer-wise lr
(counterpart of ``visiondk_tpu/engine/optim.py``).

``create_optimizer`` returns an ``OptimizerSpec``, the counterpart of the
optax chain the JAX package builds::

    clip_by_global_norm(10) → [freeze mask] → [layer-wise lr] → sgd | adam

and, like an optax transform, it knows no parameters until ``init(model)``
binds it to a model's. ``update(state)`` then applies one update in place
from the gradients in ``.grad``:

- **Clip** as optax does: with g the global norm of *all* gradients (frozen
  parameters' included: the clip wraps the freeze), every gradient becomes
  ``t / g * max_norm`` when ``g ≥ max_norm`` and stays as it is otherwise,
  with no epsilon (``torch.nn.utils.clip_grad_norm_`` adds 1e-6).
- **Freeze**: frozen parameters are left out of the torch optimizer, so
  they get exactly zero update, no weight decay either (optax
  ``set_to_zero``).
- **Layer-wise lr**: parameters whose *top-level flax key* is ``head`` or
  ``fc`` get lr × ``head_multiplier``. The flax path comes from the weight
  bridge (``models/convert.py::param_paths``); for a ``VisionModel`` the top
  key is ``backbone``, so nothing is boosted, as in the JAX package.
- **Schedules**: lr and momentum are evaluated at the count of updates
  applied so far, before it is incremented (optax ``inject_hyperparams``),
  and set on the param groups before every step.
- torch ``SGD`` (g ← g + wd·p; v ← μ·v + g; p ← p − lr·v) and ``Adam`` with
  L2-coupled weight decay are the optax chains' math; both run ``foreach``.

Not ported yet: SAM (``sam_perturb`` and its two-pass step; ``create_optimizer``
raises for ``sam``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import torch
from torch import nn

from visiondk_tpu_torch.models.convert import param_paths
from visiondk_tpu_torch.registry import Registry

OPTIMIZER = Registry("optimizer")

GRAD_CLIP_NORM = 10.0
_HEAD_KEYS = ("fc", "head", "pool", "neck", "pre_head")


@dataclasses.dataclass(frozen=True)
class SAMConfig:
    """SAM's settings, as the JAX package's; the SAM step is not ported yet."""

    rho: float = 0.05
    adaptive: bool = True
    local_perturb: bool = True


# --- registry entries: factory(param_groups, weight_decay) -> torch.optim.Optimizer ---


@OPTIMIZER.register(name="sgd")
def sgd(param_groups: List[dict], weight_decay: float) -> torch.optim.Optimizer:
    # lr and momentum are set from the schedules before every step
    return torch.optim.SGD(param_groups, lr=0.0, momentum=0.0, weight_decay=weight_decay, foreach=True)


@OPTIMIZER.register(name="adam")
def adam(param_groups: List[dict], weight_decay: float) -> torch.optim.Optimizer:
    return torch.optim.Adam(
        param_groups, lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay, foreach=True
    )


def freeze_mask(
    backbone_freeze: bool = False, bn_freeze_affine: bool = False, head_keys=_HEAD_KEYS
) -> Callable[[str], str]:
    """flax path → ``"frozen"`` or ``"train"``, as the JAX ``freeze_mask``
    labels its tree: with ``backbone_freeze`` everything outside the head keys
    is frozen; with ``bn_freeze_affine`` the scale and bias of modules whose
    name contains ``bn``."""

    def label(path: str) -> str:
        parts = path.split("/")
        if backbone_freeze and not any(p in head_keys for p in parts):
            return "frozen"
        if bn_freeze_affine and len(parts) >= 2 and "bn" in parts[-2] and parts[-1] in ("scale", "bias"):
            return "frozen"
        return "train"

    return label


def layer_wise_label(path: str) -> str:
    """``"head"`` for a flax path whose top-level key is ``head`` or ``fc``,
    else ``"backbone"`` (the JAX ``layer_wise`` label function)."""
    return "head" if path.split("/")[0] in ("head", "fc") else "backbone"


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place: ``t / g * max_norm`` for every
    gradient when the global norm g ≥ ``max_norm``, unchanged otherwise.
    Decided on the device (no host sync). Returns g."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(keep, 1.0, max_norm))
    return norm


@dataclasses.dataclass
class OptState:
    """A bound optimizer: the torch optimizer over the trainable parameters,
    every parameter of the model (the clip's norm includes frozen ones), and
    the count of updates applied."""

    optimizer: torch.optim.Optimizer
    params: List[nn.Parameter]
    count: int = 0


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """What ``create_optimizer`` returns (see module doc). The schedules take
    the count of applied updates."""

    name: str
    lr_schedule: Callable[[int], float]
    weight_decay: float
    momentum_schedule: Callable[[int], float]
    layer_wise_lr: bool = False
    head_multiplier: float = 10.0
    backbone_freeze: bool = False
    bn_freeze_affine: bool = False

    def labels(self, model: nn.Module) -> Dict[str, float]:
        """Trainable parameter name → its lr multiplier; frozen ones absent."""
        frozen = freeze_mask(self.backbone_freeze, self.bn_freeze_affine)
        out = {}
        for name, path in param_paths(model).items():
            if frozen(path) == "frozen":
                continue
            boosted = self.layer_wise_lr and layer_wise_label(path) == "head"
            out[name] = self.head_multiplier if boosted else 1.0
        return out

    def init(self, model: nn.Module) -> OptState:
        mults = self.labels(model)
        groups: Dict[float, List[nn.Parameter]] = {}
        for name, p in model.named_parameters():
            if name in mults:
                groups.setdefault(mults[name], []).append(p)
        param_groups = [{"params": ps, "lr_mult": m} for m, ps in groups.items()]
        optimizer = OPTIMIZER.create(self.name, param_groups, self.weight_decay)
        return OptState(optimizer=optimizer, params=list(model.parameters()))

    def update(self, state: OptState) -> None:
        """One update, in place, from the gradients in ``.grad`` (a parameter
        without one gets a zero gradient, as every leaf of a JAX gradient
        tree exists): clip, set lr and momentum at ``state.count``, step,
        count += 1."""
        for p in state.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        clip_by_global_norm_([p.grad for p in state.params], GRAD_CLIP_NORM)
        lr = self.lr_schedule(state.count)
        momentum = self.momentum_schedule(state.count)
        for group in state.optimizer.param_groups:
            group["lr"] = lr * group["lr_mult"]
            if "momentum" in group:
                group["momentum"] = momentum
        state.optimizer.step()
        state.count += 1


def create_optimizer(
    name: str,
    lr_schedule: Callable[[int], float],
    weight_decay: float,
    momentum_schedule: Callable[[int], float],
    layer_wise_lr: bool = False,
    head_multiplier: float = 10.0,
    backbone_freeze: bool = False,
    bn_freeze_affine: bool = False,
) -> OptimizerSpec:
    """The JAX ``create_optimizer``: base optimizer, clip, freezes and
    layer-wise lr. An unknown name raises, and so does ``sam`` (not ported)."""
    if name == "sam":
        raise NotImplementedError("the SAM optimizer (sam_perturb and its two-pass step) is not ported yet")
    OPTIMIZER.get(name)
    return OptimizerSpec(
        name, lr_schedule, weight_decay, momentum_schedule, layer_wise_lr, head_multiplier,
        backbone_freeze, bn_freeze_affine,
    )


def list_optimizers():
    return OPTIMIZER.keys()
