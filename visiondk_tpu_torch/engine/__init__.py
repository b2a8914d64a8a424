from visiondk_tpu_torch.engine import cbir_eval, face_eval
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
    "cbir_eval",
    "device_preprocess",
    "face_eval",
    "make_eval_step",
    "make_embed_step",
    "make_train_step",
]
