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
- ``SGD`` below (g ← g + wd·p; v ← μ·v + g; p ← p − lr·v, the trace kept
  through μ = 0 steps as optax's) and torch ``Adam`` with L2-coupled weight
  decay are the optax chains' math; both run ``foreach``.
- **Gradient accumulation** (``accumulate`` = k > 1, ``optax.MultiSteps``
  around the chain): each ``update`` folds the gradients into the running
  mean of this round's, ``acc ← acc + (g − acc) / (n + 1)`` (optax's Welford
  form), and only the k-th applies it, as one update through the whole chain
  (clip included) at the count of applied updates; the buffer and the
  mini-step count live in ``OptState`` and in checkpoints.

- **SAM** (``sam``): the base optimizer is this SGD (the JAX ``sam``
  entry); the perturbation is the train step's (``engine/steps.py``), which
  calls ``sam_perturb`` between its two passes.
- **A class-sharded margin head** (``--model_parallel`` > 1): the clip's
  global norm, and ``sam_perturb``'s, count each head column once: the
  shard's squares are summed over the model group, then the replicated
  tensors' are added once (``OptState.sum_of_squares``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from visiondk_tpu_torch.models.convert import param_paths
from visiondk_tpu_torch.models.heads import MarginHead
from visiondk_tpu_torch.registry import Registry

OPTIMIZER = Registry("optimizer")

GRAD_CLIP_NORM = 10.0
_HEAD_KEYS = ("fc", "head", "pool", "neck", "pre_head")


@dataclasses.dataclass(frozen=True)
class SAMConfig:
    """SAM's settings, as the JAX package's. ``local_perturb`` asks for a
    perturbation from each rank's own gradient (m-sharpness); in a
    single-process run the rank's gradient is the global one, so both forms
    are the same step."""

    rho: float = 0.05
    adaptive: bool = True
    local_perturb: bool = True


# --- registry entries: factory(param_groups, weight_decay) -> torch.optim.Optimizer ---


class SGD(torch.optim.Optimizer):
    """The optax chain [add_decayed_weights(wd), trace(μ), scale_by_learning_rate(lr)]
    with foreach ops: g ← g + wd·p; v ← μ·v + g; p ← p − lr·v. The trace v
    starts at 0 and is kept through steps with μ = 0, as optax keeps it
    (``torch.optim.SGD`` keeps no buffer while μ = 0 and restarts it at v = g
    when μ turns non-zero)."""

    def __init__(self, param_groups: List[dict], weight_decay: float):
        super().__init__(param_groups, {"lr": 0.0, "momentum": 0.0, "weight_decay": weight_decay})

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:  # the foreach ops take no empty lists
                continue
            for p in params:
                if "momentum_buffer" not in self.state[p]:
                    self.state[p]["momentum_buffer"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            trace = [self.state[p]["momentum_buffer"] for p in params]
            grads = [p.grad for p in params]
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params, alpha=group["weight_decay"])
            torch._foreach_mul_(trace, group["momentum"])
            torch._foreach_add_(trace, grads)
            torch._foreach_add_(params, trace, alpha=-group["lr"])


@OPTIMIZER.register(name="sgd")
def sgd(param_groups: List[dict], weight_decay: float) -> torch.optim.Optimizer:
    # lr and momentum are set from the schedules before every step
    return SGD(param_groups, weight_decay)


@OPTIMIZER.register(name="sam")
def sam(param_groups: List[dict], weight_decay: float) -> torch.optim.Optimizer:
    # SAM's base optimizer; the perturbation pass is the train step's
    return SGD(param_groups, weight_decay)


@OPTIMIZER.register(name="adam")
def adam(param_groups: List[dict], weight_decay: float) -> torch.optim.Optimizer:
    return torch.optim.Adam(
        param_groups, lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay, foreach=True
    )


@torch.no_grad()
def sam_perturb(params: List[torch.Tensor], grads: List[torch.Tensor], cfg: SAMConfig,
                state: Optional["OptState"] = None) -> List[torch.Tensor]:
    """SAM's ascent e(w), one tensor a parameter (the JAX ``sam_perturb``
    returns w + e): e = ρ·(p² if adaptive)·g / (‖(|p| if adaptive)·g‖₂ +
    1e-12), the norm over every parameter given (frozen ones included, as the
    JAX tree's). The squares are summed parameter by parameter in f32, as
    the JAX sum over the tree's leaves, and the division happens on the
    device (no host read). With ``state`` (the ``OptState`` over the same
    parameters) a class-sharded head's squares count once over its model
    group."""
    sq = torch.stack([torch.sum(torch.square(p.abs() * g if cfg.adaptive else g)) for p, g in zip(params, grads)])
    total = torch.sum(sq) if state is None else state.sum_of_squares(sq)
    scale = cfg.rho / (torch.sqrt(total) + 1e-12)
    return [(p * p * g if cfg.adaptive else g) * scale for p, g in zip(params, grads)]


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
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         state: Optional["OptState"] = None) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place: ``t / g * max_norm`` for every
    gradient when the global norm g ≥ ``max_norm``, unchanged otherwise.
    Decided on the device (no host sync). With ``state`` (the ``OptState``
    over the same tensors) g counts a class-sharded head once. Returns g."""
    norms = torch.stack(torch._foreach_norm(grads))
    if state is None or state.mesh is None:
        norm = torch.linalg.vector_norm(norms)
    else:
        norm = torch.sqrt(state.sum_of_squares(torch.square(norms)))
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
    # gradient accumulation: the running mean of this round's gradients (None
    # before its first mini-step) and how many it holds
    acc_grads: Optional[List[torch.Tensor]] = None
    mini_step: int = 0
    # a class-sharded margin head: which of ``params`` are shards, and the
    # MeshContext whose model group holds the other shards (None: no shard)
    sharded: Optional[List[bool]] = None
    mesh: Optional[object] = None

    def sum_of_squares(self, sq: torch.Tensor) -> torch.Tensor:
        """The global sum of per-tensor squares ``sq`` [len(params)]: the
        replicated tensors' once, the shards' summed over the model group."""
        if self.mesh is None:
            return torch.sum(sq)
        mask = torch.tensor(self.sharded, device=sq.device)
        return torch.sum(torch.where(mask, 0.0, sq)) + self.mesh.model_sum(torch.sum(torch.where(mask, sq, 0.0)))


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
    accumulate: int = 1  # mini-steps an applied update averages (optax.MultiSteps' every_k)

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
        state = OptState(optimizer=optimizer, params=list(model.parameters()))
        heads = [m for m in model.modules() if isinstance(m, MarginHead) and m.mesh is not None]
        if heads:
            shards = {id(h.weight) for h in heads}
            state.sharded = [id(p) in shards for p in state.params]
            state.mesh = heads[0].mesh
        return state

    def update(self, state: OptState) -> bool:
        """One update, in place, from the gradients in ``.grad`` (a parameter
        without one gets a zero gradient, as every leaf of a JAX gradient
        tree exists): clip, set lr and momentum at ``state.count``, step,
        count += 1. With ``accumulate`` = k > 1 the gradients first join the
        round's running mean, and only the k-th mini-step of a round applies
        that mean (in ``.grad``) as the update. Returns whether an update was
        applied."""
        for p in state.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.accumulate > 1:
            grads = [p.grad for p in state.params]
            if state.acc_grads is None:
                state.acc_grads = [torch.zeros_like(g) for g in grads]
            with torch.no_grad():
                step = torch._foreach_sub(grads, state.acc_grads)
                torch._foreach_div_(step, float(state.mini_step + 1))
                torch._foreach_add_(state.acc_grads, step)
            if state.mini_step + 1 < self.accumulate:
                state.mini_step += 1
                return False
            for p, acc in zip(state.params, state.acc_grads):
                p.grad = acc
            state.acc_grads, state.mini_step = None, 0
        clip_by_global_norm_([p.grad for p in state.params], GRAD_CLIP_NORM, state)
        lr = self.lr_schedule(state.count)
        momentum = self.momentum_schedule(state.count)
        for group in state.optimizer.param_groups:
            group["lr"] = lr * group["lr_mult"]
            if "momentum" in group:
                group["momentum"] = momentum
        state.optimizer.step()
        state.count += 1
        return True


def create_optimizer(
    name: str,
    lr_schedule: Callable[[int], float],
    weight_decay: float,
    momentum_schedule: Callable[[int], float],
    layer_wise_lr: bool = False,
    head_multiplier: float = 10.0,
    backbone_freeze: bool = False,
    bn_freeze_affine: bool = False,
    accumulate: int = 1,
) -> OptimizerSpec:
    """The JAX ``create_optimizer``: base optimizer, clip, freezes and
    layer-wise lr; ``accumulate`` > 1 wraps it as ``optax.MultiSteps`` does.
    An unknown name raises. ``sam`` is SGD here; its ascent is the train
    step's (``StepConfig.sam``)."""
    OPTIMIZER.get(name)
    if accumulate < 1:
        raise ValueError(f"accumulate must be at least 1, got {accumulate}")
    return OptimizerSpec(
        name, lr_schedule, weight_decay, momentum_schedule, layer_wise_lr, head_multiplier,
        backbone_freeze, bn_freeze_affine, accumulate,
    )


def list_optimizers():
    return OPTIMIZER.keys()
