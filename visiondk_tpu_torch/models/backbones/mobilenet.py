"""MobileNetV3 (counterpart of ``visiondk_tpu/models/backbones/mobilenet.py``).

mobilenetv3_large_100, mobilenetv3_small_100, mobilenetv3_large_075 and
tf_mobilenetv3_large_minimal_100 (depthwise kernels all 3, no squeeze-excite,
relu everywhere, TF 'SAME' padding and BN eps 1e-3). NHWC in and out, NCHW
``channels_last`` views inside, flax BatchNorm (``layers.BatchNorm2d``), as
in ``resnet.py``. The activations are the JAX package's formulas
(``layers.hard_swish``, ``layers.hard_sigmoid``), not torch's built-ins.

Module and parameter names are timm's: ``conv_stem``, ``bn1``,
``blocks.{s}.{b}`` with timm's stage grouping (a new group where the output
width changes), whose first block is a ``DepthwiseSeparableConv``
(``conv_dw``, ``bn1``, ``se``, ``conv_pw``, ``bn2``) and whose others are
``InvertedResidual`` blocks (``conv_pw``, ``bn1``, ``conv_dw``, ``bn2``,
``se.conv_reduce``, ``se.conv_expand``, ``conv_pwl``, ``bn3``), the last
group one 1×1 ``ConvBnAct`` (``conv``, ``bn1``), then the post-pool 1×1
``conv_head`` and the ``classifier``. The weight bridge maps them onto the
JAX tree's flat ``stage{i}_block1`` blocks, ``head_conv``/``head_bn``,
``pre_head`` and ``fc``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from visiondk_tpu_torch.models.backbones import BACKBONES
from visiondk_tpu_torch.models.layers import (
    BatchNorm2d, Conv2d, Linear, SEBlock, global_avg_pool, hard_swish, make_divisible,
)


def _norm(channels: int, bn_eval: bool, bn_eps: float, dtype) -> BatchNorm2d:
    # flax BatchNorm(momentum=0.9, epsilon=bn_eps) ↔ torch momentum 0.1
    return BatchNorm2d(channels, eps=bn_eps, bn_eval=bn_eval, dtype=dtype)


def _spatial_conv(in_ch: int, out_ch: int, kernel: int, stride: int, groups: int, tf_same: bool, dtype) -> Conv2d:
    """A k×k conv without bias: symmetric k//2 padding, or TF 'SAME'."""
    return Conv2d(in_ch, out_ch, kernel, stride=stride, padding=0 if tf_same else kernel // 2, groups=groups,
                  bias=False, tf_same=tf_same, dtype=dtype)


class ConvBnAct(nn.Module):
    """conv (k×k, stride) → BN → act, with the residual where the stride is
    1 and the width unchanged (timm's ``ConvBnAct``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 1, stride: int = 1, act: Callable = F.relu,
                 bn_eval: bool = False, tf_same: bool = False, bn_eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = act
        self.has_skip = stride == 1 and in_ch == out_ch
        self.conv = _spatial_conv(in_ch, out_ch, kernel, stride, 1, tf_same, dtype)
        self.bn1 = _norm(out_ch, bn_eval, bn_eps, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.act(self.bn1(self.conv(x)))
        return y + x if self.has_skip else y


class DepthwiseSeparableConv(nn.Module):
    """MobileNetV3's block without expansion: depthwise k×k → BN → act [→
    SE] → 1×1 → BN [+ x]."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int, act: Callable,
                 se: Optional[SEBlock] = None, bn_eval: bool = False, tf_same: bool = False,
                 bn_eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = act
        self.has_skip = stride == 1 and in_ch == out_ch
        self.conv_dw = _spatial_conv(in_ch, in_ch, kernel, stride, in_ch, tf_same, dtype)
        self.bn1 = _norm(in_ch, bn_eval, bn_eps, dtype)
        self.se = se
        self.conv_pw = Conv2d(in_ch, out_ch, 1, bias=False, dtype=dtype)
        self.bn2 = _norm(out_ch, bn_eval, bn_eps, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.act(self.bn1(self.conv_dw(x)))
        if self.se is not None:
            y = self.se(y)
        y = self.bn2(self.conv_pw(y))
        return y + x if self.has_skip else y


class InvertedResidual(nn.Module):
    """1×1 expand → BN → act → depthwise k×k → BN → act [→ SE] → 1×1
    project → BN [+ x] (MobileNetV3's and EfficientNetV2's MBConv)."""

    def __init__(self, in_ch: int, mid_ch: int, out_ch: int, kernel: int, stride: int, act: Callable,
                 se: Optional[SEBlock] = None, bn_eval: bool = False, tf_same: bool = False,
                 bn_eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = act
        self.has_skip = stride == 1 and in_ch == out_ch
        self.conv_pw = Conv2d(in_ch, mid_ch, 1, bias=False, dtype=dtype)
        self.bn1 = _norm(mid_ch, bn_eval, bn_eps, dtype)
        self.conv_dw = _spatial_conv(mid_ch, mid_ch, kernel, stride, mid_ch, tf_same, dtype)
        self.bn2 = _norm(mid_ch, bn_eval, bn_eps, dtype)
        self.se = se
        self.conv_pwl = Conv2d(mid_ch, out_ch, 1, bias=False, dtype=dtype)
        self.bn3 = _norm(out_ch, bn_eval, bn_eps, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.act(self.bn1(self.conv_pw(x)))
        y = self.act(self.bn2(self.conv_dw(y)))
        if self.se is not None:
            y = self.se(y)
        y = self.bn3(self.conv_pwl(y))
        return y + x if self.has_skip else y


# (kernel, exp, out, SE, HS, stride) per block — the JAX package's tables (MobileNetV3 paper tables 1/2)
_V3_LARGE = [
    (3, 16, 16, False, False, 1),
    (3, 64, 24, False, False, 2),
    (3, 72, 24, False, False, 1),
    (5, 72, 40, True, False, 2),
    (5, 120, 40, True, False, 1),
    (5, 120, 40, True, False, 1),
    (3, 240, 80, False, True, 2),
    (3, 200, 80, False, True, 1),
    (3, 184, 80, False, True, 1),
    (3, 184, 80, False, True, 1),
    (3, 480, 112, True, True, 1),
    (3, 672, 112, True, True, 1),
    (5, 672, 160, True, True, 2),
    (5, 960, 160, True, True, 1),
    (5, 960, 160, True, True, 1),
]
_V3_SMALL = [
    (3, 16, 16, True, False, 2),
    (3, 72, 24, False, False, 2),
    (3, 88, 24, False, False, 1),
    (5, 96, 40, True, True, 2),
    (5, 240, 40, True, True, 1),
    (5, 240, 40, True, True, 1),
    (5, 120, 48, True, True, 1),
    (5, 144, 48, True, True, 1),
    (5, 288, 96, True, True, 2),
    (5, 576, 96, True, True, 1),
    (5, 576, 96, True, True, 1),
]
# timm's 'minimal' arch: the large table with every depthwise kernel at 3, no SE, relu everywhere
_V3_LARGE_MINIMAL = [(3, exp, out, False, False, s) for (_k, exp, out, _se, _hs, s) in _V3_LARGE]


class MobileNetV3(nn.Module):
    """MobileNetV3 on NHWC images of ``img_size``²: the 3×3/2 stem, the
    blocks of ``blocks`` (widths × ``width_mult``, rounded by
    ``make_divisible``), the 1×1 ``last_exp`` ConvBnAct, the mean over H, W
    in the compute dtype, then in f32 the ``head_width`` 1×1 ``conv_head``
    (bias), the activation and the ``classifier``. ``num_classes=0``
    returns the pooled f32 features (before ``conv_head``), or with
    ``unpooled`` the f32 NHWC map, whose shape ``feature_shape`` gives.
    ``tf_same`` pads every spatial conv TF 'SAME' from its input's size;
    ``relu_act`` puts relu in place of hard-swish around the blocks."""

    def __init__(self, blocks: Sequence[tuple] = tuple(_V3_LARGE), last_exp: int = 960,
                 width_mult: float = 1.0, num_classes: int = 1000, head_width: int = 1280,
                 unpooled: bool = False, bn_eval: bool = False, tf_same: bool = False, bn_eps: float = 1e-5,
                 relu_act: bool = False, img_size: int = 224, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.unpooled = unpooled
        self.compute_dtype = dtype
        self.act = F.relu if relu_act else hard_swish
        common = dict(bn_eval=bn_eval, tf_same=tf_same, bn_eps=bn_eps, dtype=dtype)
        in_ch = make_divisible(16 * width_mult)
        self.conv_stem = _spatial_conv(3, in_ch, 3, 2, 1, tf_same, dtype)
        self.bn1 = _norm(in_ch, bn_eval, bn_eps, dtype)
        size = -(-img_size // 2)
        groups, group, last_out = [], [], None
        for k, exp, out, se, hs, s in blocks:
            exp_ch, out_ch = make_divisible(exp * width_mult), make_divisible(out * width_mult)
            if group and out_ch != last_out:  # timm's stage groups: a new one where the width changes
                groups.append(nn.Sequential(*group))
                group = []
            act = hard_swish if hs else F.relu
            se_block = SEBlock(exp_ch, make_divisible(exp_ch // 4), dtype=dtype) if se else None
            if exp_ch == in_ch:
                group.append(DepthwiseSeparableConv(in_ch, out_ch, k, s, act, se_block, **common))
            else:
                group.append(InvertedResidual(in_ch, exp_ch, out_ch, k, s, act, se_block, **common))
            in_ch, last_out = out_ch, out_ch
            size = -(-size // s)
        groups.append(nn.Sequential(*group))
        head_ch = make_divisible(last_exp * width_mult)
        groups.append(nn.Sequential(ConvBnAct(in_ch, head_ch, act=self.act, **common)))
        self.blocks = nn.Sequential(*groups)
        self.feature_shape = (size, size, head_ch)
        self.conv_head = Conv2d(head_ch, head_width, 1, dense=True) if num_classes else None
        self.classifier = Linear(head_width, num_classes) if num_classes else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)  # NHWC → NCHW view, channels_last memory
        x = self.blocks(self.act(self.bn1(self.conv_stem(x))))
        if self.num_classes == 0 and self.unpooled:
            return x.permute(0, 2, 3, 1).float()  # [B, H', W', C]
        feats = global_avg_pool(x).float()
        if self.num_classes == 0:
            return feats
        feats = self.act(self.conv_head(feats[:, :, None, None])).flatten(1)
        return self.classifier(feats)


def _mnv3(blocks, last_exp, **defaults):
    def factory(num_classes: int = 1000, dtype: torch.dtype = torch.float32, **kwargs):
        cfg = dict(defaults)
        cfg.update(kwargs)
        return MobileNetV3(blocks=tuple(blocks), last_exp=last_exp, num_classes=num_classes, dtype=dtype, **cfg)

    return factory


BACKBONES.register(_mnv3(_V3_LARGE, 960), name="mobilenetv3_large_100")
# small's conv_head is 576→1024 (MobileNetV3 paper table 2), not large's 1280
BACKBONES.register(_mnv3(_V3_SMALL, 576, head_width=1024), name="mobilenetv3_small_100")
BACKBONES.register(_mnv3(_V3_LARGE, 960, width_mult=0.75), name="mobilenetv3_large_075")
BACKBONES.register(_mnv3(_V3_LARGE_MINIMAL, 960, tf_same=True, bn_eps=1e-3, relu_act=True),
                   name="tf_mobilenetv3_large_minimal_100")
