from visiondk_tpu_torch.engine.steps import (
    StepConfig,
    device_preprocess,
    make_embed_step,
    make_eval_step,
)

__all__ = ["StepConfig", "device_preprocess", "make_eval_step", "make_embed_step"]
