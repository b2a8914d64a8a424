"""ResNet family (counterpart of ``visiondk_tpu/models/backbones/resnet.py``).

resnet18/34/50/101/152, resnet50d (deep stem, avg-down shortcut),
wide_resnet101_2, resnext50_32x4d, legacy_seresnet50 and ResNeSt
(resnest50d_4s2x40d). The input is NHWC, as for every port backbone, and so
is the ``unpooled`` feature map; inside, the NHWC batch is an NCHW view in
``torch.channels_last`` memory format, and every convolution casts its
weight to that format (``layers.Conv2d``), so cuDNN runs NHWC convolutions
without layout transposes. BatchNorm is flax's (``layers.BatchNorm2d``:
statistics in f32, biased running variance, momentum 0.9 in flax's terms);
the port's single-process batch is the global batch that the JAX package's
sharded BN reduces over. Average pools count padded cells, as flax's
``avg_pool`` does; max-pool pads with −inf.

Module and parameter names are timm's (``conv1``/``bn1`` stem, the deep
stem's ``conv1.{0,1,3,4,6}`` and ``bn1``, ``layer{s}.{b}``, ``downsample``,
``se.fc1``/``se.fc2``, the split-attention ``conv``, ``bn0``, ``fc1``,
``bn1``, ``fc2``, and ``fc``); the weight bridge (``models/convert.py``)
maps them onto the JAX tree (``stem_conv``, ``stage{s}_block{b+1}``,
``down_conv``/``down_bn``, ...).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from visiondk_tpu_torch.models.backbones import BACKBONES
from visiondk_tpu_torch.models.layers import BatchNorm2d, Conv2d, Linear, SqueezeExcite, global_avg_pool


def _halved(size: int) -> int:
    """Spatial size after a 3×3/2 conv or pool with padding 1 (or the 7×7/2 stem)."""
    return (size - 1) // 2 + 1


def _downsample(in_ch: int, out_ch: int, stride: int, avg_down: bool, bn_eval: bool, dtype) -> nn.Sequential:
    """The shortcut's projection: a strided 1×1 conv and BN, or with
    ``avg_down`` a 2×2/2 average pool (Identity at stride 1), a 1×1 conv and
    BN (timm's ``downsample_avg`` layout)."""
    if avg_down:
        pool = nn.AvgPool2d(2, 2) if stride > 1 else nn.Identity()
        return nn.Sequential(pool, Conv2d(in_ch, out_ch, 1, bias=False, dtype=dtype),
                             BatchNorm2d(out_ch, bn_eval=bn_eval, dtype=dtype))
    return nn.Sequential(Conv2d(in_ch, out_ch, 1, stride=stride, bias=False, dtype=dtype),
                         BatchNorm2d(out_ch, bn_eval=bn_eval, dtype=dtype))


class BasicBlock(nn.Module):
    """3×3 → BN → ReLU → 3×3 → BN [→ SE] + shortcut → ReLU."""

    expansion = 1

    def __init__(self, in_ch: int, filters: int, stride: int = 1, use_se: bool = False, avg_down: bool = False,
                 bn_eval: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_ch, filters, 3, stride=stride, padding=1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(filters, bn_eval=bn_eval, dtype=dtype)
        self.conv2 = Conv2d(filters, filters, 3, padding=1, bias=False, dtype=dtype)
        self.bn2 = BatchNorm2d(filters, bn_eval=bn_eval, dtype=dtype)
        self.se = SqueezeExcite(filters, dtype=dtype) if use_se else None
        needs = in_ch != filters or stride != 1
        self.downsample = _downsample(in_ch, filters, stride, avg_down, bn_eval, dtype) if needs else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.se is not None:
            y = self.se(y)
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(residual + y)


class Bottleneck(nn.Module):
    """1×1 → BN → ReLU → 3×3 (groups) → BN → ReLU → 1×1 → BN [→ SE] +
    shortcut → ReLU; internal width ``int(filters·base_width/64)·groups``,
    output ``4·filters``."""

    expansion = 4

    def __init__(self, in_ch: int, filters: int, stride: int = 1, groups: int = 1, base_width: int = 64,
                 use_se: bool = False, avg_down: bool = False, bn_eval: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        width = int(filters * (base_width / 64.0)) * groups
        out_ch = filters * 4
        self.conv1 = Conv2d(in_ch, width, 1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(width, bn_eval=bn_eval, dtype=dtype)
        self.conv2 = Conv2d(width, width, 3, stride=stride, padding=1, groups=groups, bias=False, dtype=dtype)
        self.bn2 = BatchNorm2d(width, bn_eval=bn_eval, dtype=dtype)
        self.conv3 = Conv2d(width, out_ch, 1, bias=False, dtype=dtype)
        self.bn3 = BatchNorm2d(out_ch, bn_eval=bn_eval, dtype=dtype)
        self.se = SqueezeExcite(out_ch, dtype=dtype) if use_se else None
        needs = in_ch != out_ch or stride != 1
        self.downsample = _downsample(in_ch, out_ch, stride, avg_down, bn_eval, dtype) if needs else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.se is not None:
            y = self.se(y)
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(residual + y)


class SplitAttnConv(nn.Module):
    """ResNeSt split-attention 3×3 conv, channels radix-major (timm's
    ``SplAtConv2d`` layout): conv (groups ``cardinality·radix``) → BN → ReLU,
    the radix splits summed and pooled → 1×1 ``fc1`` → BN → ReLU → 1×1
    ``fc2`` → softmax over the radix per cardinal group in f32 (rSoftMax) →
    the splits weighted and summed."""

    def __init__(self, in_ch: int, width: int, radix: int = 2, cardinality: int = 1, bn_eval: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.width, self.radix, self.cardinality = width, radix, cardinality
        inter = max(width * radix // 4, 32)
        self.conv = Conv2d(in_ch, width * radix, 3, padding=1, groups=cardinality * radix, bias=False, dtype=dtype)
        self.bn0 = BatchNorm2d(width * radix, bn_eval=bn_eval, dtype=dtype)
        self.fc1 = Conv2d(width, inter, 1, groups=cardinality, dtype=dtype)
        self.bn1 = BatchNorm2d(inter, bn_eval=bn_eval, dtype=dtype)
        self.fc2 = Conv2d(inter, width * radix, 1, groups=cardinality, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, r, card = self.width, self.radix, self.cardinality
        y = F.relu(self.bn0(self.conv(x)))
        b = y.shape[0]
        ys = y.unflatten(1, (r, w))                            # [B, r, w, H, W], radix-major splits
        gap = ys.sum(dim=1).mean(dim=(2, 3))                   # [B, w]
        a = F.relu(self.bn1(self.fc1(gap[:, :, None, None])))
        a = self.fc2(a).reshape(b, card, r, w // card).transpose(1, 2)  # [B, r, card, w/card]
        a = torch.softmax(a.float(), dim=1).to(y.dtype).reshape(b, r, w)
        return (ys * a[:, :, :, None, None]).sum(dim=1)        # [B, w, H, W]


class ResNestBottleneck(nn.Module):
    """ResNeSt bottleneck: 1×1 → BN → ReLU → [3×3/2 average pool, padded
    cells counted (timm's avd_first)] → split-attention 3×3 → 1×1 → BN +
    avg-down shortcut → ReLU."""

    expansion = 4

    def __init__(self, in_ch: int, filters: int, stride: int = 1, radix: int = 2, cardinality: int = 1,
                 base_width: int = 64, bn_eval: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        width = int(filters * (base_width / 64.0)) * cardinality
        out_ch = filters * 4
        self.conv1 = Conv2d(in_ch, width, 1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(width, bn_eval=bn_eval, dtype=dtype)
        self.avd_first = nn.AvgPool2d(3, stride, 1, count_include_pad=True) if stride > 1 else None
        self.conv2 = SplitAttnConv(width, width, radix=radix, cardinality=cardinality, bn_eval=bn_eval, dtype=dtype)
        self.conv3 = Conv2d(width, out_ch, 1, bias=False, dtype=dtype)
        self.bn3 = BatchNorm2d(out_ch, bn_eval=bn_eval, dtype=dtype)
        needs = in_ch != out_ch or stride != 1
        self.downsample = _downsample(in_ch, out_ch, stride, True, bn_eval, dtype) if needs else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        if self.avd_first is not None:
            y = self.avd_first(y)
        y = self.bn3(self.conv3(self.conv2(y)))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(residual + y)


class ResNet(nn.Module):
    """ResNet on NHWC images of ``img_size``²: the 7×7/2 stem (or with
    ``deep_stem`` three 3×3 convs, the first strided), max-pool 3/2/1, four
    stages (the first block of stages 2–4 strided), global average pool in
    the compute dtype, f32 ``fc``. ``num_classes=0`` returns the pooled f32
    features, or with ``unpooled`` the f32 NHWC map, whose shape
    ``feature_shape`` gives as (H', W', C)."""

    def __init__(self, stage_sizes: Sequence[int], block: str = "bottleneck", num_classes: int = 1000,
                 groups: int = 1, base_width: int = 64, radix: int = 2, use_se: bool = False,
                 deep_stem: bool = False, avg_down: bool = False, unpooled: bool = False, bn_eval: bool = False,
                 img_size: int = 224, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.unpooled = unpooled
        self.compute_dtype = dtype
        norm = lambda c: BatchNorm2d(c, bn_eval=bn_eval, dtype=dtype)  # noqa: E731
        if deep_stem:
            self.conv1 = nn.Sequential(
                Conv2d(3, 32, 3, stride=2, padding=1, bias=False, dtype=dtype), norm(32), nn.ReLU(),
                Conv2d(32, 32, 3, padding=1, bias=False, dtype=dtype), norm(32), nn.ReLU(),
                Conv2d(32, 64, 3, padding=1, bias=False, dtype=dtype),
            )
        else:
            self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False, dtype=dtype)
        self.bn1 = norm(64)
        self.deep_stem = deep_stem
        size = _halved(_halved(img_size))  # stem, max-pool
        in_ch = 64
        for stage, n_blocks in enumerate(stage_sizes):
            blocks = []
            for b in range(n_blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                filters = 64 * 2**stage
                if block == "basic":
                    blk = BasicBlock(in_ch, filters, stride, use_se=use_se, avg_down=avg_down, bn_eval=bn_eval,
                                     dtype=dtype)
                elif block == "bottleneck":
                    blk = Bottleneck(in_ch, filters, stride, groups=groups, base_width=base_width, use_se=use_se,
                                     avg_down=avg_down, bn_eval=bn_eval, dtype=dtype)
                elif block == "resnest":
                    blk = ResNestBottleneck(in_ch, filters, stride, radix=radix, cardinality=groups,
                                            base_width=base_width, bn_eval=bn_eval, dtype=dtype)
                else:
                    raise ValueError(f"unknown ResNet block {block!r}")
                blocks.append(blk)
                in_ch = filters * blk.expansion
                if stride > 1:
                    size = _halved(size)
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)
        self.feature_shape = (size, size, in_ch)
        self.fc = Linear(in_ch, num_classes, dtype=torch.float32) if num_classes else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)  # NHWC → NCHW view, channels_last memory
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        if self.num_classes == 0 and self.unpooled:
            return x.permute(0, 2, 3, 1).float()  # [B, H', W', C]
        feats = global_avg_pool(x).float()
        return feats if self.fc is None else self.fc(feats)


def _resnet(stage_sizes, block, **defaults):
    def factory(num_classes: int = 1000, dtype: torch.dtype = torch.float32, **kwargs):
        cfg = dict(defaults)
        cfg.update(kwargs)
        return ResNet(stage_sizes=stage_sizes, block=block, num_classes=num_classes, dtype=dtype, **cfg)

    return factory


BACKBONES.register(_resnet([2, 2, 2, 2], "basic"), name="resnet18")
BACKBONES.register(_resnet([3, 4, 6, 3], "basic"), name="resnet34")
BACKBONES.register(_resnet([3, 4, 6, 3], "bottleneck"), name="resnet50")
BACKBONES.register(_resnet([3, 4, 23, 3], "bottleneck"), name="resnet101")
BACKBONES.register(_resnet([3, 8, 36, 3], "bottleneck"), name="resnet152")
BACKBONES.register(_resnet([3, 4, 6, 3], "bottleneck", deep_stem=True, avg_down=True), name="resnet50d")
BACKBONES.register(_resnet([3, 4, 23, 3], "bottleneck", base_width=128), name="wide_resnet101_2")
BACKBONES.register(_resnet([3, 4, 6, 3], "bottleneck", groups=32, base_width=4), name="resnext50_32x4d")
BACKBONES.register(_resnet([3, 4, 6, 3], "bottleneck", use_se=True), name="legacy_seresnet50")
BACKBONES.register(
    # radix 4, cardinality 2, width 40 (the reference's recommended list, pet.yaml:18)
    _resnet([3, 4, 6, 3], "resnest", radix=4, groups=2, base_width=40, deep_stem=True),
    name="resnest50d_4s2x40d",
)
