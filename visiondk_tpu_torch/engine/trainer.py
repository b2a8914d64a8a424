"""The trainer (counterpart of ``visiondk_tpu/engine/trainer.py``).

Ported so far: ``build_tx``, the optimizer a run trains with (the JAX
``Trainer._build_tx``). The run loops, checkpoints and metrics are not
ported yet.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

from visiondk_tpu_torch.config.checks import normalize_accumulate
from visiondk_tpu_torch.engine.optim import OptimizerSpec, create_optimizer
from visiondk_tpu_torch.engine.schedules import create_scheduler, momentum_schedule


def build_tx(
    hyp: Dict[str, Any],
    steps_per_epoch: int,
    discrete_per_epoch: bool,
    model_cfg: Optional[Dict[str, Any]] = None,
) -> OptimizerSpec:
    """The optimizer of a config's ``hyp:`` section (and the freeze flags of
    its ``model:`` section). The schedules run on epochs ``count /
    steps_per_epoch`` of the applied-update count, floored when
    ``discrete_per_epoch`` (classification steps its schedule per epoch,
    the embedding tasks per batch). ``hyp.accumulate > 1`` and the ``sam``
    optimizer raise: neither is ported yet."""
    if normalize_accumulate(hyp) > 1:
        raise NotImplementedError("hyp.accumulate > 1 (optax.MultiSteps) is not ported yet")
    optimizer = hyp["optimizer"]
    opt_name = optimizer[0]
    layer_wise = bool(optimizer[1]) if isinstance(optimizer, (list, tuple)) and len(optimizer) > 1 else False
    epoch_sched = create_scheduler(
        hyp["scheduler"], hyp["warm_ep"], hyp["epochs"], hyp["lr0"], hyp.get("lrf_ratio")
    )
    mom_sched = momentum_schedule(
        hyp["warm_ep"], hyp["momentum"], hyp.get("warmup_momentum", hyp["momentum"])
    )

    def to_epochs(count: int) -> float:
        t = count / steps_per_epoch
        return math.floor(t) if discrete_per_epoch else t

    model_cfg = model_cfg or {}
    return create_optimizer(
        opt_name,
        lambda count: epoch_sched(to_epochs(count)),
        hyp["weight_decay"],
        lambda count: mom_sched(to_epochs(count)),
        layer_wise_lr=layer_wise,
        backbone_freeze=bool(model_cfg.get("backbone_freeze")),
        bn_freeze_affine=bool(model_cfg.get("bn_freeze_affine")),
    )
