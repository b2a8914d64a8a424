"""Swin Transformer V2 (counterpart of ``visiondk_tpu/models/backbones/swinv2.py``).

swinv2_tiny_window8_256, small, base and swinv2_large_window12to16_192to256.
V2 against V1 (``swin.py``, whose window machinery it reuses):

- post-norm residual blocks (LayerNorm after attention and after the MLP);
- scaled cosine attention: q and k L2-normalised per head (norms in f32),
  the learned per-head ``logit_scale`` clamped at log 100 and
  exponentiated, then folded into q outside the attention core and q
  rounded to the compute dtype, so the core runs at scale 1.0;
- a continuous log-spaced relative-position bias (CPB): an MLP 2 → 512 →
  heads over the [N, N, 2] log-scaled coordinates of every token pair,
  16·sigmoid of it, f32. It is evaluated on the pairs directly, so there is
  no index gather and no atomic sum in its gradient;
- ``PatchMergingV2``: the 2×2 concat, the reduction, then LayerNorm.

Attention runs ``ops.window_attention.fused_window_attention(qkv2, bias,
ids, heads, 1.0)`` (``use_fused``, the default): the CUDA kernels on the
card, their plain versions on the CPU; the bias gradient reaches the CPB MLP
through the kernels' dbias; a shifted block hands its shift to the op, as
Swin V1's does. With ``use_fused`` off it runs
``fused_window_attention_plain`` on the same folded inputs, differentiated
by autograd, so both paths compute one function. There is no fallback: a
window the kernels do not take (swinv2_large's 16×16, N = 256) raises on
the card. The window is ``min(window_size, H, W)``, unshifted when it covers
the map; maps that are not window multiples are zero-padded bottom/right
before attention and cropped after. The relative coordinates and the
shift-region ids are static numpy, never buffers. LayerNorm eps is 1e-5.

Module and parameter names are timm's (``patch_embed.{proj,norm}``,
``layers.{s}.blocks.{b}.attn.{qkv,logit_scale,cpb_mlp.0,cpb_mlp.2,proj}``,
``norm1``, ``mlp.fc1``, ``mlp.fc2``, ``norm2``,
``layers.{s}.downsample.{reduction,norm}`` at the end of stage s, ``norm``,
``head``), with one trainable 3C ``qkv.bias`` as the JAX model has (timm
splits it into ``q_bias``/``v_bias`` and keeps k's part at zero);
``visiondk_tpu.models.convert.convert_swinv2`` reads it. ``remat``
recomputes each block's forward in the backward, as Swin V1's does.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from visiondk_tpu_torch.models.backbones import BACKBONES
from visiondk_tpu_torch.models.backbones.swin import (
    SwinPatchEmbed, SwinStage, _region_ids, _static_tensor, padded_window_attention,
)
from visiondk_tpu_torch.models.layers import DropPath, LayerNorm, Linear, Mlp
from visiondk_tpu_torch.ops.window_attention import fused_window_attention, fused_window_attention_plain

_LN_EPS = 1e-5
_CPB_HIDDEN = 512
_LOGIT_SCALE_MAX = math.log(100.0)


def log_relative_coords(ws: int) -> np.ndarray:
    """[ws², ws², 2] log-spaced signed relative coordinates (SwinV2 eq. 4)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1).astype(np.float32)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)  # [n, n, 2]
    rel = rel / max(ws - 1, 1) * 8.0
    return (np.sign(rel) * np.log2(np.abs(rel) + 1.0) / np.log2(8.0)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _relative_coords(ws: int, device: torch.device) -> torch.Tensor:
    return _static_tensor(lambda: log_relative_coords(ws), device)


def _l2_normalize(t: torch.Tensor) -> torch.Tensor:
    """t / max(‖t‖, 1e-6) over the last dim, the norm taken in f32 and
    rounded to t's dtype before the division (the JAX ``_l2n``)."""
    norm = torch.linalg.vector_norm(t.float(), dim=-1, keepdim=True)
    return t / norm.clamp_min(1e-6).to(t.dtype)


class WindowAttentionV2(nn.Module):
    """Scaled-cosine window MSA over a [B, H, W, C] map (H, W multiples of
    the window): qkv Linear → q, k normalised → q × exp(min(logit_scale,
    log 100)) → softmax(q·kᵀ + CPB bias [+ shift mask])·v per window and
    head → proj Linear."""

    def __init__(self, dim: int, num_heads: int, window_size: int, qkv_bias: bool = True,
                 use_fused: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.use_fused = use_fused
        self.compute_dtype = dtype
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        self.logit_scale = nn.Parameter(torch.full((num_heads, 1, 1), math.log(10.0)))
        self.cpb_mlp = nn.Sequential(Linear(2, _CPB_HIDDEN), nn.ReLU(), Linear(_CPB_HIDDEN, num_heads, bias=False))
        self.proj = Linear(dim, dim, dtype=dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.logit_scale.fill_(math.log(10.0))

    def bias(self) -> torch.Tensor:
        """The CPB bias [heads, N, N], f32: 16·sigmoid(MLP(log coords))."""
        cpb = self.cpb_mlp(_relative_coords(self.window_size, self.logit_scale.device))  # [N, N, heads]
        return (16.0 * torch.sigmoid(cpb.permute(2, 0, 1))).contiguous()

    def forward(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        """x [B, H, W, C] (not rolled); the windows tile it rolled by
        (−shift, −shift) (0: W-MSA), the op's shift."""
        b, hh, ww, c = x.shape
        h = self.num_heads
        q, k, v = self.qkv(x).reshape(b, hh, ww, 3, h, c // h).unbind(dim=3)
        scale = torch.exp(torch.clamp(self.logit_scale, max=_LOGIT_SCALE_MAX))[:, 0]  # [h, 1] f32
        q = (_l2_normalize(q).float() * scale).to(self.compute_dtype)
        qkv2 = torch.stack([q, _l2_normalize(k), v], dim=3).reshape(b, hh, ww, 3 * c)
        ids = _region_ids(hh, ww, self.window_size, shift, x.device)
        attend = fused_window_attention if self.use_fused else fused_window_attention_plain
        return self.proj(attend(qkv2, self.bias(), ids, h, 1.0, shift))


class SwinV2Block(nn.Module):
    """Post-norm SwinV2 block on [B, H·W, C] tokens: window attention shifted
    by ``shift`` (``padded_window_attention``) → LayerNorm → DropPath
    residual; then Mlp → LayerNorm → DropPath residual."""

    def __init__(self, dim: int, num_heads: int, input_resolution: Tuple[int, int], window_size: int = 8,
                 shift: int = 0, mlp_ratio: float = 4.0, drop_path: float = 0.0, use_fused: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hh, ww = input_resolution
        self.input_resolution = (hh, ww)
        self.window_size = min(window_size, hh, ww)
        self.shift = shift if self.window_size < min(hh, ww) else 0
        self.attn = WindowAttentionV2(dim, num_heads, self.window_size, use_fused=use_fused, dtype=dtype)
        self.norm1 = LayerNorm(dim, eps=_LN_EPS, dtype=dtype)
        self.drop_path1 = DropPath(drop_path)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)
        self.norm2 = LayerNorm(dim, eps=_LN_EPS, dtype=dtype)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hh, ww = self.input_resolution
        b, n, c = x.shape
        y = padded_window_attention(self.attn, x.reshape(b, hh, ww, c), self.window_size, self.shift)
        x = x + self.drop_path1(self.norm1(y.reshape(b, n, c)))
        return x + self.drop_path2(self.norm2(self.mlp(x)))


class PatchMergingV2(nn.Module):
    """2×2 merge: [B, H·W, C] → [B, ⌈H/2⌉·⌈W/2⌉, 2C]; concat order x00,
    x10, x01, x11 (odd edges zero-padded), Linear without bias, then
    LayerNorm (V1 normalises before the reduction)."""

    def __init__(self, input_resolution: Tuple[int, int], dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_resolution = tuple(input_resolution)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False, dtype=dtype)
        self.norm = LayerNorm(2 * dim, eps=_LN_EPS, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hh, ww = self.input_resolution
        b, _, c = x.shape
        x = x.reshape(b, hh, ww, c)
        if hh % 2 or ww % 2:
            x = F.pad(x, (0, 0, 0, ww % 2, 0, hh % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.norm(self.reduction(x.reshape(b, -1, 4 * c)))


class SwinTransformerV2(nn.Module):
    """SwinV2 on NHWC images of ``img_size``² (the blocks' window sizes,
    shifts and paddings follow from it). ``num_classes=0`` returns pooled
    f32 features, or with ``unpooled`` the f32 token map (``feature_shape``
    gives it as (N, C))."""

    def __init__(self, patch_size: int = 4, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 8, mlp_ratio: float = 4.0,
                 num_classes: int = 1000, stochastic_depth_prob: float = 0.1, unpooled: bool = False,
                 remat: bool = False, img_size: int = 256, use_fused: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if img_size % patch_size:
            raise ValueError(f"img_size {img_size} is not a multiple of patch_size {patch_size}")
        self.num_classes = num_classes
        self.unpooled = unpooled
        self.img_size = img_size
        self.patch_embed = SwinPatchEmbed(patch_size, embed_dim, dtype=dtype)
        total = sum(depths)
        res = (img_size // patch_size,) * 2
        dim, bidx = embed_dim, 0
        stages = []
        for s, depth in enumerate(depths):
            blocks = []
            for i in range(depth):
                blocks.append(SwinV2Block(
                    dim, num_heads[s], res, window_size=window_size,
                    shift=0 if i % 2 == 0 else window_size // 2, mlp_ratio=mlp_ratio,
                    drop_path=stochastic_depth_prob * bidx / max(total - 1, 1), use_fused=use_fused, dtype=dtype,
                ))
                bidx += 1
            last = s == len(depths) - 1
            stages.append(SwinStage(blocks, None if last else PatchMergingV2(res, dim, dtype=dtype), remat))
            if not last:
                res = (-(-res[0] // 2), -(-res[1] // 2))  # ceil: odd edges are padded
                dim *= 2
        self.layers = nn.ModuleList(stages)
        self.feature_shape = (res[0] * res[1], dim)
        self.norm = LayerNorm(dim, eps=_LN_EPS, dtype=dtype)
        self.head = Linear(dim, num_classes) if num_classes else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape[1:3]) != (self.img_size, self.img_size):
            raise ValueError(f"this SwinV2 was built for {self.img_size}² images, got {tuple(x.shape[1:3])}")
        x = self.patch_embed(x)
        for stage in self.layers:
            x = stage(x)
        x = self.norm(x)
        if self.num_classes == 0 and self.unpooled:
            return x.float()
        feats = x.mean(dim=1).float()
        return feats if self.head is None else self.head(feats)


def _swinv2(embed_dim, depths, num_heads, window_size=8):
    def factory(num_classes: int = 1000, dtype: torch.dtype = torch.float32, **kwargs):
        return SwinTransformerV2(embed_dim=embed_dim, depths=depths, num_heads=num_heads, window_size=window_size,
                                 num_classes=num_classes, dtype=dtype, **kwargs)

    return factory


BACKBONES.register(_swinv2(96, (2, 2, 6, 2), (3, 6, 12, 24)), name="swinv2_tiny_window8_256")
BACKBONES.register(_swinv2(96, (2, 2, 18, 2), (3, 6, 12, 24)), name="swinv2_small_window8_256")
BACKBONES.register(_swinv2(128, (2, 2, 18, 2), (4, 8, 16, 32)), name="swinv2_base_window8_256")
# window 16 (fine-tuned from 12): N = 256 tokens a window, on the window kernels' tiled bodies
BACKBONES.register(_swinv2(192, (2, 2, 18, 2), (6, 12, 24, 48), window_size=16),
                   name="swinv2_large_window12to16_192to256")
