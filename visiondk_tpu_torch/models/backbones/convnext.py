"""ConvNeXt (counterpart of ``visiondk_tpu/models/backbones/convnext.py``).

convnext_tiny, small, base and large. The input is NHWC, as for every port
backbone, and so is the ``unpooled`` feature map; inside, the map is an
NCHW view in ``torch.channels_last`` memory, which is the NHWC layout
itself, so the 7×7 depthwise convolution runs on cuDNN's NHWC path and the
LayerNorm and the two pointwise Linear layers of a block run on the same
memory through permuted views. LayerNorm eps is flax's default 1e-6; GELU is
erf in f32 and tanh in bf16 (``layers.gelu``); the LayerScale ``gamma``
starts at 1e-6.

Module and parameter names are timm's (``stem.0``/``stem.1``,
``stages.{s}.downsample.{0,1}`` for s ≥ 1, ``stages.{s}.blocks.{b}.{conv_dw,
norm,mlp.fc1,mlp.fc2,gamma}``, ``head.norm``, ``head.fc``), so
``visiondk_tpu.models.convert.convert_convnext`` reads a port state dict as
it reads a timm one; the weight bridge (``models/convert.py``) maps them onto
the JAX tree (``stem_conv``, ``downsample_norm{s}``, ``stage{s}_block{b}/
{dwconv,norm,pwconv1,pwconv2,gamma}``, ``head_norm``, ``head``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from visiondk_tpu_torch.models.backbones import BACKBONES
from visiondk_tpu_torch.models.layers import (
    Conv2d, DropPath, LayerNorm, LayerNorm2d, Linear, Mlp, global_avg_pool,
)


class ConvNeXtBlock(nn.Module):
    """7×7 depthwise conv → LayerNorm → Linear(4C) → GELU → Linear(C) →
    ×gamma → DropPath residual, on an NCHW ``channels_last`` map."""

    def __init__(self, dim: int, drop_path: float = 0.0, layer_scale_init: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layer_scale_init = layer_scale_init
        self.conv_dw = Conv2d(dim, dim, 7, padding=3, groups=dim, dtype=dtype)
        self.norm = LayerNorm(dim, dtype=dtype)
        self.mlp = Mlp(dim, 4 * dim, dtype=dtype)
        self.gamma = nn.Parameter(torch.full((dim,), float(layer_scale_init)))
        self.drop_path = DropPath(drop_path)

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.gamma.fill_(self.layer_scale_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.mlp(self.norm(self.conv_dw(x).permute(0, 2, 3, 1)))  # NHWC view of channels_last memory
        y = y * self.gamma.to(y.dtype)
        return x + self.drop_path(y.permute(0, 3, 1, 2))


class ConvNeXtStage(nn.Module):
    """timm's stage: the downsample (LayerNorm, 2×2/2 conv; none for stage 0),
    then the blocks."""

    def __init__(self, downsample: Optional[nn.Sequential], blocks: Sequence[ConvNeXtBlock]):
        super().__init__()
        self.downsample = downsample
        self.blocks = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample is not None:
            x = self.downsample(x)
        return self.blocks(x)


class ConvNeXtHead(nn.Module):
    """timm's ``NormMlpClassifierHead`` without its MLP: the pooled f32
    features → LayerNorm → ``fc`` (none with ``num_classes=0``)."""

    def __init__(self, dim: int, num_classes: int):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.fc = Linear(dim, num_classes) if num_classes else None

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        feats = self.norm(feats)
        return feats if self.fc is None else self.fc(feats)


class ConvNeXt(nn.Module):
    """ConvNeXt on NHWC images of ``img_size``²: the 4×4/4 stem conv and
    LayerNorm, four stages, the mean over H, W in the compute dtype, the
    f32 head. ``num_classes=0`` returns the normalised pooled f32 features,
    or with ``unpooled`` the f32 NHWC map (no head norm), whose shape
    ``feature_shape`` gives as (H', W', C)."""

    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3), dims: Sequence[int] = (96, 192, 384, 768),
                 num_classes: int = 1000, stochastic_depth_prob: float = 0.0, unpooled: bool = False,
                 img_size: int = 224, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.unpooled = unpooled
        self.compute_dtype = dtype
        self.stem = nn.Sequential(Conv2d(3, dims[0], 4, stride=4, dtype=dtype), LayerNorm2d(dims[0], dtype=dtype))
        total, bidx = sum(depths), 0
        size = img_size // 4
        stages = []
        for s, depth in enumerate(depths):
            downsample = None
            if s > 0:
                downsample = nn.Sequential(LayerNorm2d(dims[s - 1], dtype=dtype),
                                           Conv2d(dims[s - 1], dims[s], 2, stride=2, dtype=dtype))
                size //= 2
            blocks = []
            for _ in range(depth):
                blocks.append(ConvNeXtBlock(dims[s], drop_path=stochastic_depth_prob * bidx / max(total - 1, 1),
                                            dtype=dtype))
                bidx += 1
            stages.append(ConvNeXtStage(downsample, blocks))
        self.stages = nn.Sequential(*stages)
        self.feature_shape = (size, size, dims[-1])
        self.head = None if num_classes == 0 and unpooled else ConvNeXtHead(dims[-1], num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)  # NHWC → NCHW view, channels_last memory
        x = self.stages(self.stem(x))
        if self.head is None:
            return x.permute(0, 2, 3, 1).float()  # [B, H', W', C]
        return self.head(global_avg_pool(x).float())


def _convnext(depths, dims):
    def factory(num_classes: int = 1000, dtype: torch.dtype = torch.float32, **kwargs):
        return ConvNeXt(depths=depths, dims=dims, num_classes=num_classes, dtype=dtype, **kwargs)

    return factory


BACKBONES.register(_convnext((3, 3, 9, 3), (96, 192, 384, 768)), name="convnext_tiny")
BACKBONES.register(_convnext((3, 3, 27, 3), (96, 192, 384, 768)), name="convnext_small")
BACKBONES.register(_convnext((3, 3, 27, 3), (128, 256, 512, 1024)), name="convnext_base")
BACKBONES.register(_convnext((3, 3, 27, 3), (192, 384, 768, 1536)), name="convnext_large")
