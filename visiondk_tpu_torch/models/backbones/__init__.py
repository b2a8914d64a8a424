"""Backbone registry (counterpart of ``visiondk_tpu/models/backbones/__init__.py``).

Each entry is ``name -> factory(num_classes, dtype, **kwargs)`` returning an
``nn.Module`` that maps an NHWC image batch to logits or, with
``num_classes=0``, to features. Ported so far: the ViT family, Swin V1
(tiny, small, base) and the ResNet family (resnet18 … 152, resnet50d,
wide_resnet101_2, resnext50_32x4d, legacy_seresnet50, resnest50d_4s2x40d).
"""

from visiondk_tpu_torch.registry import Registry

BACKBONES = Registry("backbone")

# Import for registration side effects.
from visiondk_tpu_torch.models.backbones import resnet, swin, vit  # noqa: E402,F401

__all__ = ["BACKBONES"]
