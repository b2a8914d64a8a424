"""EfficientNetV2 (counterpart of ``visiondk_tpu/models/backbones/efficientnet.py``).

efficientnetv2_s, _m, _l and the TF-origin tf_efficientnetv2_s and
tf_efficientnetv2_l (TF 'SAME' padding, BN eps 1e-3). Fused-MBConv in the
early stages, MBConv with squeeze-excite (silu and a plain sigmoid gate,
reduced from the block's input width) later; BN + SiLU. NHWC in and out,
NCHW ``channels_last`` views inside, flax BatchNorm, as in ``resnet.py``.

Module and parameter names are timm's: ``conv_stem``, ``bn1``,
``blocks.{s}.{b}`` with one group per row of the stage table, each block a
``ConvBnAct`` (``conv``, ``bn1``: a fused stage without expansion), an
``EdgeResidual`` (``conv_exp``, ``bn1``, ``conv_pwl``, ``bn2``: fused with
expansion) or an ``InvertedResidual`` (``mobilenet.py``), then ``conv_head``,
``bn2`` and the ``classifier``. The weight bridge maps them onto the JAX
tree's ``stage{s+1}_block{b+1}``, ``head_conv``, ``head_bn`` and ``fc``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from visiondk_tpu_torch.models.backbones import BACKBONES
from visiondk_tpu_torch.models.backbones.mobilenet import ConvBnAct, InvertedResidual, _norm, _spatial_conv
from visiondk_tpu_torch.models.layers import Conv2d, Linear, SEBlock, global_avg_pool, make_divisible


class EdgeResidual(nn.Module):
    """Fused-MBConv with expansion: k×k expand (stride) → BN → SiLU → 1×1
    project → BN [+ x]."""

    def __init__(self, in_ch: int, mid_ch: int, out_ch: int, kernel: int, stride: int, bn_eval: bool = False,
                 tf_same: bool = False, bn_eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.has_skip = stride == 1 and in_ch == out_ch
        self.conv_exp = _spatial_conv(in_ch, mid_ch, kernel, stride, 1, tf_same, dtype)
        self.bn1 = _norm(mid_ch, bn_eval, bn_eps, dtype)
        self.conv_pwl = Conv2d(mid_ch, out_ch, 1, bias=False, dtype=dtype)
        self.bn2 = _norm(out_ch, bn_eval, bn_eps, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn2(self.conv_pwl(F.silu(self.bn1(self.conv_exp(x)))))
        return y + x if self.has_skip else y


# (block type, repeats, kernel, stride, expand, out_ch) — the JAX package's tables
_V2_S = [
    ("fused", 2, 3, 1, 1, 24),
    ("fused", 4, 3, 2, 4, 48),
    ("fused", 4, 3, 2, 4, 64),
    ("mb", 6, 3, 2, 4, 128),
    ("mb", 9, 3, 1, 6, 160),
    ("mb", 15, 3, 2, 6, 256),
]
_V2_M = [
    ("fused", 3, 3, 1, 1, 24),
    ("fused", 5, 3, 2, 4, 48),
    ("fused", 5, 3, 2, 4, 80),
    ("mb", 7, 3, 2, 4, 160),
    ("mb", 14, 3, 1, 6, 176),
    ("mb", 18, 3, 2, 6, 304),
    ("mb", 5, 3, 1, 6, 512),
]
_V2_L = [
    ("fused", 4, 3, 1, 1, 32),
    ("fused", 7, 3, 2, 4, 64),
    ("fused", 7, 3, 2, 4, 96),
    ("mb", 10, 3, 2, 4, 192),
    ("mb", 19, 3, 1, 6, 224),
    ("mb", 25, 3, 2, 6, 384),
    ("mb", 7, 3, 1, 6, 640),
]


class EfficientNetV2(nn.Module):
    """EfficientNetV2 on NHWC images of ``img_size``²: the 3×3/2 stem, the
    stages of ``stages`` (the first block of a row strided), the 1×1
    ``head_ch`` conv + BN + SiLU, the mean over H, W in the compute dtype
    and the f32 ``classifier``. ``num_classes=0`` returns the pooled f32
    features, or with ``unpooled`` the f32 NHWC map, whose shape
    ``feature_shape`` gives. ``tf_same`` pads every spatial conv TF 'SAME'
    from its input's size."""

    def __init__(self, stages: Sequence[tuple] = tuple(_V2_S), stem_ch: int = 24, head_ch: int = 1280,
                 num_classes: int = 1000, unpooled: bool = False, bn_eval: bool = False, tf_same: bool = False,
                 bn_eps: float = 1e-5, img_size: int = 224, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.unpooled = unpooled
        self.compute_dtype = dtype
        common = dict(bn_eval=bn_eval, tf_same=tf_same, bn_eps=bn_eps, dtype=dtype)
        self.conv_stem = _spatial_conv(3, stem_ch, 3, 2, 1, tf_same, dtype)
        self.bn1 = _norm(stem_ch, bn_eval, bn_eps, dtype)
        size, in_ch = -(-img_size // 2), stem_ch
        groups = []
        for kind, reps, k, s, e, out in stages:
            blocks = []
            for b in range(reps):
                stride = s if b == 0 else 1
                if kind == "fused" and e == 1:
                    blocks.append(ConvBnAct(in_ch, out, k, stride, act=F.silu, **common))
                elif kind == "fused":
                    blocks.append(EdgeResidual(in_ch, in_ch * e, out, k, stride, **common))
                else:
                    se = SEBlock(in_ch * e, make_divisible(in_ch // 4), act=F.silu, gate=torch.sigmoid, dtype=dtype)
                    blocks.append(InvertedResidual(in_ch, in_ch * e, out, k, stride, F.silu, se, **common))
                in_ch = out
                size = -(-size // stride)
            groups.append(nn.Sequential(*blocks))
        self.blocks = nn.Sequential(*groups)
        self.conv_head = Conv2d(in_ch, head_ch, 1, bias=False, dtype=dtype)
        self.bn2 = _norm(head_ch, bn_eval, bn_eps, dtype)
        self.feature_shape = (size, size, head_ch)
        self.classifier = Linear(head_ch, num_classes) if num_classes else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)  # NHWC → NCHW view, channels_last memory
        x = self.blocks(F.silu(self.bn1(self.conv_stem(x))))
        x = F.silu(self.bn2(self.conv_head(x)))
        if self.num_classes == 0 and self.unpooled:
            return x.permute(0, 2, 3, 1).float()  # [B, H', W', C]
        feats = global_avg_pool(x).float()
        return feats if self.classifier is None else self.classifier(feats)


def _effv2(stages, stem_ch, **defaults):
    def factory(num_classes: int = 1000, dtype: torch.dtype = torch.float32, **kwargs):
        cfg = dict(defaults)
        cfg.update(kwargs)
        return EfficientNetV2(stages=tuple(stages), stem_ch=stem_ch, num_classes=num_classes, dtype=dtype, **cfg)

    return factory


BACKBONES.register(_effv2(_V2_S, 24), name="efficientnetv2_s")
BACKBONES.register(_effv2(_V2_M, 24), name="efficientnetv2_m")
BACKBONES.register(_effv2(_V2_L, 32), name="efficientnetv2_l")
# TF-origin checkpoints: TF 'SAME' padding + BN eps 1e-3
BACKBONES.register(_effv2(_V2_L, 32, tf_same=True, bn_eps=1e-3), name="tf_efficientnetv2_l")
BACKBONES.register(_effv2(_V2_S, 24, tf_same=True, bn_eps=1e-3), name="tf_efficientnetv2_s")
