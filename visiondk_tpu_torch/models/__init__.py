from visiondk_tpu_torch.models.backbones import BACKBONES
from visiondk_tpu_torch.models.factory import EmbeddingModel, EmbeddingNeck, VisionModel, get_model

__all__ = [
    "get_model",
    "VisionModel",
    "EmbeddingModel",
    "EmbeddingNeck",
    "BACKBONES",
]
