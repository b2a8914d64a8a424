from visiondk_tpu_torch.losses.losses import (
    LOSS,
    binary_cross_entropy,
    create_lossfn,
    cross_entropy,
    distill_kl,
    focal_loss,
    list_lossfns,
)

__all__ = [
    "LOSS",
    "create_lossfn",
    "list_lossfns",
    "cross_entropy",
    "binary_cross_entropy",
    "focal_loss",
    "distill_kl",
]
