"""Swin Transformer V1 (counterpart of ``visiondk_tpu/models/backbones/swin.py``).

The reference's default backbone (``configs/classification/pet.yaml``:
``swin_base_patch4_window7_224``). Module and parameter names follow timm's
``SwinTransformer`` state dict in its old layout, where ``layers.{s}.downsample``
ends stage s (``patch_embed.proj``, ``patch_embed.norm``,
``layers.{s}.blocks.{b}.attn.qkv``, ``...attn.relative_position_bias_table``,
``layers.{s}.downsample.{norm,reduction}``, ``norm``, ``head``), so
``visiondk_tpu.models.convert.convert_swin`` reads a port state dict as it
reads a timm one. The JAX tree names these ``stage{s}_block{b}``,
``merge{s}``, ``patch_embed``, ``patch_norm``, ``norm`` and ``head``; the
weight bridge (``models/convert.py``) maps between the two.

Window attention runs ``ops.window_attention.fused_window_attention`` on the
QKV projection's [B, H, W, 3C] layout (``use_fused``, the default): the CUDA
kernels on the card, their plain versions on the CPU. With ``use_fused``
off it runs the plain forward, differentiated by autograd. There is no
fallback: a shape the kernels do not take raises. The window partition and
its reverse, which the plain path uses, live beside the kernels' plain
versions in ``ops/window_attention.py``. The relative-position index and
the shift-region ids are static numpy, never buffers (the bridge refuses
buffers it does not know). Tokens run in the compute dtype; LayerNorm
eps is 1e-5 (timm's, not the port's 1e-6 default); the pooled features and
the head are f32, the pool taken in the compute dtype as the JAX model takes
it. ``remat`` (activation checkpointing) is not ported and raises.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from visiondk_tpu_torch.models.backbones import BACKBONES
from visiondk_tpu_torch.models.layers import DropPath, LayerNorm, Linear, Mlp, PatchEmbed
from visiondk_tpu_torch.ops.window_attention import fused_window_attention, fused_window_attention_plain

_LN_EPS = 1e-5


def relative_position_index(ws: int) -> np.ndarray:
    """Static [ws², ws²] index into the (2ws−1)² relative-bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))  # [2, ws, ws]
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + np.array([ws - 1, ws - 1])
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int32)


def window_region_ids(hh: int, ww: int, ws: int, shift: int) -> np.ndarray:
    """Static per-window shift-region ids [nH·nW, ws²], windows row-major;
    tokens with different ids must not attend (SW-MSA). shift=0 → all zeros
    (W-MSA)."""
    if shift == 0:
        return np.zeros(((hh // ws) * (ww // ws), ws * ws), np.int32)
    img = np.zeros((hh, ww), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(hh // ws, ws, ww // ws, ws).transpose(0, 2, 1, 3)
    return win.reshape(-1, ws * ws).astype(np.int32)


def _static_tensor(make, device: torch.device) -> torch.Tensor:
    # made outside inference mode: autograd may save it (the bias gather's index)
    with torch.inference_mode(False):
        return torch.from_numpy(make()).to(device)


@functools.lru_cache(maxsize=None)
def _bias_index(ws: int, device: torch.device) -> torch.Tensor:
    return _static_tensor(lambda: relative_position_index(ws).reshape(-1).astype(np.int64), device)


@functools.lru_cache(maxsize=None)
def _region_ids(hh: int, ww: int, ws: int, shift: int, device: torch.device) -> Optional[torch.Tensor]:
    """The int32 region ids on ``device``, or None for unshifted windows."""
    if shift == 0:
        return None
    return _static_tensor(lambda: window_region_ids(hh, ww, ws, shift), device)


class WindowAttention(nn.Module):
    """Window MSA over a [B, H, W, C] map (H, W multiples of the window):
    qkv Linear → softmax(scale·QKᵀ + relative-position bias [+ shift
    mask])·V per window and head → proj Linear."""

    def __init__(self, dim: int, num_heads: int, window_size: int, qkv_bias: bool = True,
                 use_fused: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.use_fused = use_fused
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.proj = Linear(dim, dim, dtype=dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.relative_position_bias_table.normal_(0.0, 0.02, generator=generator)

    def bias(self) -> torch.Tensor:
        """The relative-position bias [heads, N, N], f32."""
        table = self.relative_position_bias_table
        n = self.window_size**2
        idx = _bias_index(self.window_size, table.device)
        return table.index_select(0, idx).reshape(n, n, -1).permute(2, 0, 1).contiguous()

    def forward(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        """x [B, H, W, C], already cyclically shifted by ``shift`` (0: W-MSA)."""
        _, hh, ww, _ = x.shape
        qkv = self.qkv(x)
        ids = _region_ids(hh, ww, self.window_size, shift, x.device)
        attend = fused_window_attention if self.use_fused else fused_window_attention_plain
        return self.proj(attend(qkv, self.bias(), ids, self.num_heads))


class SwinBlock(nn.Module):
    """Pre-norm Swin block on [B, H·W, C] tokens: LayerNorm → pad to window
    multiples → roll by −shift → window attention → roll by +shift → crop →
    DropPath residual; then LayerNorm → Mlp → DropPath residual. The window
    is ``min(window_size, H, W)``, unshifted when it covers the map."""

    def __init__(self, dim: int, num_heads: int, input_resolution: Tuple[int, int],
                 window_size: int = 7, shift: int = 0, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, use_fused: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        hh, ww = input_resolution
        self.input_resolution = (hh, ww)
        self.window_size = min(window_size, hh, ww)
        self.shift = shift if self.window_size < min(hh, ww) else 0
        self.norm1 = LayerNorm(dim, eps=_LN_EPS, dtype=dtype)
        self.attn = WindowAttention(dim, num_heads, self.window_size, use_fused=use_fused, dtype=dtype)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=_LN_EPS, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hh, ww = self.input_resolution
        b, n, c = x.shape
        ws, shift = self.window_size, self.shift
        y = self.norm1(x).reshape(b, hh, ww, c)
        pad_b, pad_r = (-hh) % ws, (-ww) % ws
        if pad_b or pad_r:  # zero-pad bottom and right before windowing, crop after (timm)
            y = F.pad(y, (0, 0, 0, pad_r, 0, pad_b))
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        y = self.attn(y, shift)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        if pad_b or pad_r:
            y = y[:, :hh, :ww]
        x = x + self.drop_path1(y.reshape(b, n, c))
        return x + self.drop_path2(self.mlp(self.norm2(x)))


class PatchMerging(nn.Module):
    """2×2 merge: [B, H·W, C] → [B, ⌈H/2⌉·⌈W/2⌉, 2C]; concat order x00, x10,
    x01, x11 (odd edges zero-padded), LayerNorm, Linear without bias."""

    def __init__(self, input_resolution: Tuple[int, int], dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_resolution = tuple(input_resolution)
        self.norm = LayerNorm(4 * dim, eps=_LN_EPS, dtype=dtype)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hh, ww = self.input_resolution
        b, _, c = x.shape
        x = x.reshape(b, hh, ww, c)
        if hh % 2 or ww % 2:
            x = F.pad(x, (0, 0, 0, ww % 2, 0, hh % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x.reshape(b, -1, 4 * c)))


class SwinStage(nn.Module):
    """The blocks of one stage, then (all but the last stage) a PatchMerging."""

    def __init__(self, blocks: Sequence[SwinBlock], downsample: Optional[PatchMerging]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x if self.downsample is None else self.downsample(x)


class SwinPatchEmbed(PatchEmbed):
    """Patch-embed conv on NHWC images, then LayerNorm (``patch_norm``)."""

    def __init__(self, patch_size: int, embed_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__(patch_size, embed_dim, dtype=dtype)
        self.norm = LayerNorm(embed_dim, eps=_LN_EPS, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(super().forward(x))


class SwinTransformer(nn.Module):
    """Swin V1 on NHWC images of ``img_size``² (the blocks' window sizes and
    shifts follow from it). ``num_classes=0`` returns pooled f32 features, or
    with ``unpooled`` the f32 token map [B, H/32·W/32, 8·embed_dim] (for four
    stages; ``feature_shape`` gives it)."""

    def __init__(self, patch_size: int = 4, embed_dim: int = 128,
                 depths: Sequence[int] = (2, 2, 18, 2), num_heads: Sequence[int] = (4, 8, 16, 32),
                 window_size: int = 7, mlp_ratio: float = 4.0, num_classes: int = 1000,
                 stochastic_depth_prob: float = 0.1, unpooled: bool = False, remat: bool = False,
                 img_size: int = 224, use_fused: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        if remat:
            raise NotImplementedError("remat (activation checkpointing) is not ported to visiondk_tpu_torch yet")
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
                blocks.append(SwinBlock(
                    dim, num_heads[s], res, window_size=window_size,
                    shift=0 if i % 2 == 0 else window_size // 2, mlp_ratio=mlp_ratio,
                    drop_path=stochastic_depth_prob * bidx / max(total - 1, 1),
                    use_fused=use_fused, dtype=dtype,
                ))
                bidx += 1
            last = s == len(depths) - 1
            stages.append(SwinStage(blocks, None if last else PatchMerging(res, dim, dtype=dtype)))
            if not last:
                res = (-(-res[0] // 2), -(-res[1] // 2))  # ceil: odd edges are padded
                dim *= 2
        self.layers = nn.ModuleList(stages)
        self.feature_shape = (res[0] * res[1], dim)
        self.norm = LayerNorm(dim, eps=_LN_EPS, dtype=dtype)
        self.head = Linear(dim, num_classes, dtype=torch.float32) if num_classes else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape[1:3]) != (self.img_size, self.img_size):
            raise ValueError(f"this Swin was built for {self.img_size}² images, got {tuple(x.shape[1:3])}")
        x = self.patch_embed(x)
        for stage in self.layers:
            x = stage(x)
        x = self.norm(x)
        if self.num_classes == 0 and self.unpooled:
            return x.float()
        feats = x.mean(dim=1).float()
        return feats if self.head is None else self.head(feats)


def _swin(embed_dim, depths, num_heads, window_size=7):
    def factory(num_classes: int = 1000, dtype: torch.dtype = torch.float32, **kwargs):
        return SwinTransformer(embed_dim=embed_dim, depths=depths, num_heads=num_heads,
                               window_size=window_size, num_classes=num_classes, dtype=dtype, **kwargs)

    return factory


BACKBONES.register(_swin(96, (2, 2, 6, 2), (3, 6, 12, 24)), name="swin_tiny_patch4_window7_224")
BACKBONES.register(_swin(96, (2, 2, 18, 2), (3, 6, 12, 24)), name="swin_small_patch4_window7_224")
BACKBONES.register(_swin(128, (2, 2, 18, 2), (4, 8, 16, 32)), name="swin_base_patch4_window7_224")
