"""Train state (counterpart of ``visiondk_tpu/engine/state.py``).

The JAX ``TrainState`` is an immutable pytree threaded through a jitted
step. Here the state holds the live objects and the train step updates them
in place: ``model`` (f32 parameters; BatchNorm statistics are its buffers),
``optimizer`` (a bound ``OptState``), ``ema_model`` (an f32 copy of the
module, which eval serves for ``use_ema``), and the counters. The sharding
functions of the JAX module belong to distributed training and are not
ported.
"""

from __future__ import annotations

import dataclasses

from torch import nn

from visiondk_tpu_torch.engine.optim import OptimizerSpec, OptState
from visiondk_tpu_torch.models.ema import init_ema


@dataclasses.dataclass
class TrainState:
    step: int              # optimizer updates so far
    model: nn.Module
    optimizer: OptState
    ema_model: nn.Module
    ema_updates: int       # EMA update count (resumable)


def create_train_state(model: nn.Module, tx: OptimizerSpec) -> TrainState:
    return TrainState(step=0, model=model, optimizer=tx.init(model), ema_model=init_ema(model),
                      ema_updates=0)
