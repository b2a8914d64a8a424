from visiondk_tpu_torch.models import heads
from visiondk_tpu_torch.models.backbones import BACKBONES
from visiondk_tpu_torch.models.factory import EmbeddingModel, EmbeddingNeck, VisionModel, get_model
from visiondk_tpu_torch.models.heads import build_head

__all__ = [
    "get_model",
    "VisionModel",
    "EmbeddingModel",
    "EmbeddingNeck",
    "BACKBONES",
    "build_head",
    "heads",
]
