"""Train state (counterpart of ``visiondk_tpu/engine/state.py``).

The JAX ``TrainState`` is an immutable pytree threaded through a jitted
step. Here the state holds the live objects and the train step updates them
in place: ``model`` (f32 parameters; BatchNorm statistics are its buffers),
``optimizer`` (a bound ``OptState``), ``ema_model`` (an f32 copy of the
module, which eval serves for ``use_ema``), the counters, and ``generator``,
the CPU ``torch.Generator`` the train step draws its dropout seeds from (the
JAX step folds the step count into a fixed key instead; here the generator's
state is what a checkpoint must carry for a resumed run to draw the same
masks).

Class sharding (the JAX ``_spec_for_path`` / ``state_shardings`` /
``place_state``): with ``--model_parallel`` m > 1 the margin head's weight
[feat_dim, num_class] is the one class-sharded parameter. Each rank of a
model group holds its columns (``shard_head``), and so do the parameter's
optimizer slots, gradient-accumulation buffer and EMA copy, because each is
made from the live shard. Everything else is replicated. ``gather_head``
joins the shards back into the full weight (checkpoints hold it whole).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
from torch import nn

from visiondk_tpu_torch.engine.optim import OptimizerSpec, OptState
from visiondk_tpu_torch.models.ema import init_ema
from visiondk_tpu_torch.models.heads import MarginHead
from visiondk_tpu_torch.parallel.mesh import MeshContext, shard_ranges


@dataclasses.dataclass
class TrainState:
    step: int              # optimizer updates so far
    model: nn.Module
    optimizer: OptState
    ema_model: nn.Module
    ema_updates: int       # EMA update count (resumable)
    generator: Optional[torch.Generator] = None


def create_train_state(model: nn.Module, tx: OptimizerSpec,
                       generator: Optional[torch.Generator] = None) -> TrainState:
    return TrainState(step=0, model=model, optimizer=tx.init(model), ema_model=init_ema(model),
                      ema_updates=0, generator=generator)


def sharded_heads(model: nn.Module) -> Dict[str, MarginHead]:
    """``model``'s class-sharded margin heads (split over a model group of
    more than one rank) by the state-dict key of their weight."""
    return {f"{name}.weight" if name else "weight": module for name, module in model.named_modules()
            if isinstance(module, MarginHead) and module.mesh is not None}


def class_sharded_names(model: nn.Module) -> List[str]:
    """The state-dict keys of ``model``'s class-sharded parameters."""
    return list(sharded_heads(model))


def shard_head(full: torch.Tensor, mesh: MeshContext) -> torch.Tensor:
    """This rank's columns of a full head weight [feat_dim, num_class] (or a
    tensor of its shape: an optimizer slot, an accumulated gradient)."""
    lo, hi = shard_ranges(full.shape[1], mesh.n_model)[mesh.model_index]
    return full[:, lo:hi].clone()


def gather_head(shard: torch.Tensor, num_class: int, mesh: MeshContext) -> torch.Tensor:
    """The full [feat_dim, num_class] weight from the model group's shards
    (a collective: every rank of the group calls it)."""
    return mesh.model_cat(shard, [hi - lo for lo, hi in shard_ranges(num_class, mesh.n_model)])


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every class-sharded weight gathered whole:
    the same dict at every world size and model-parallel size (a collective
    where the model holds a shard)."""
    sd = model.state_dict()
    for key, head in sharded_heads(model).items():
        sd[key] = gather_head(sd[key], head.num_class, head.mesh)
    return sd


def load_full_state_dict(model: nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """Load a ``full_state_dict`` (whole head weights) into ``model``, each
    class-sharded weight taking this rank's columns."""
    sd = dict(sd)
    for key, head in sharded_heads(model).items():
        sd[key] = shard_head(sd[key], head.mesh)
    model.load_state_dict(sd)
