"""Backbone registry (counterpart of ``visiondk_tpu/models/backbones/__init__.py``).

Each entry is ``name -> factory(num_classes, dtype, **kwargs)`` returning an
``nn.Module`` that maps an NHWC image batch to logits or, with
``num_classes=0``, to features. Every name of the JAX registry is here:
the ViT family, Swin V1 (tiny, small, base), SwinV2 (tiny, small, base,
large), the ResNet family (resnet18 … 152, resnet50d, wide_resnet101_2,
resnext50_32x4d, legacy_seresnet50, resnest50d_4s2x40d), ConvNeXt (tiny,
small, base, large), MobileNetV3 (large, small, large_075,
tf_…_large_minimal) and EfficientNetV2 (s, m, l, tf_s, tf_l).
"""

from visiondk_tpu_torch.registry import Registry

BACKBONES = Registry("backbone")

# Import for registration side effects.
from visiondk_tpu_torch.models.backbones import (  # noqa: E402,F401
    convnext, efficientnet, mobilenet, resnet, swin, swinv2, vit,
)

__all__ = ["BACKBONES"]
