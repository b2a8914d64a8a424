from visiondk_tpu_torch.engine.steps import (
    OHEMConfig,
    StepConfig,
    device_preprocess,
    make_embed_step,
    make_eval_step,
    make_train_step,
)

__all__ = [
    "OHEMConfig",
    "StepConfig",
    "device_preprocess",
    "make_eval_step",
    "make_embed_step",
    "make_train_step",
]
