"""Vision Transformer (counterpart of ``visiondk_tpu/models/backbones/vit.py``).

Module and parameter names follow timm's ``VisionTransformer`` state dict
(``patch_embed.proj``, ``blocks.{i}.attn.qkv``, ``blocks.{i}.ls1.gamma``,
``norm``, ``head``, ...), so ``visiondk_tpu.models.convert.convert_vit`` reads
a port state dict as it reads a timm one.

The JAX package pads the token count to a multiple of 8 (197 → 200) for the
TPU's sublane tiling and masks the pad keys; the port runs the real token
count, which gives the same valid-token outputs. Tokens run in the compute
dtype; pooled features, the head and the unpooled token map are f32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from visiondk_tpu_torch.models.backbones import BACKBONES
from visiondk_tpu_torch.models.layers import (
    Attention, DropPath, LayerNorm, LayerScale, Linear, Mlp, PatchEmbed,
)


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, drop_path: float = 0.0,
                 dropout: float = 0.0, attn_dropout: float = 0.0,
                 init_values: Optional[float] = None, dtype: torch.dtype = torch.float32,
                 use_fused: bool = True):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn = Attention(dim, num_heads, attn_drop=attn_dropout, proj_drop=dropout,
                              dtype=dtype, use_fused=use_fused)
        # timm LayerScale (dinov2: 1e-5); None = vanilla ViT, no gammas
        self.ls1 = nn.Identity() if init_values is None else LayerScale(dim, init_values)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dropout=dropout, dtype=dtype)
        self.ls2 = nn.Identity() if init_values is None else LayerScale(dim, init_values)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.drop_path1(self.ls1(self.attn(self.norm1(x))))
        return x + self.drop_path2(self.ls2(self.mlp(self.norm2(x))))


class VisionTransformer(nn.Module):
    """ViT on NHWC images of ``img_size``² (the positional embedding is sized
    for it). ``num_classes=0`` returns pooled f32 features, or with
    ``unpooled`` the f32 token map [B, N(+1), C]."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0, num_classes: int = 1000,
                 dropout: float = 0.0, attention_dropout: float = 0.0,
                 stochastic_depth_prob: float = 0.0, pool: str = "cls",
                 class_token: bool = True, init_values: Optional[float] = None,
                 unpooled: bool = False, img_size: int = 224,
                 dtype: torch.dtype = torch.float32, use_fused: bool = True):
        super().__init__()
        if pool == "map":
            raise NotImplementedError(
                "pool='map' (AttentionPoolLatent) is not ported to visiondk_tpu_torch yet"
            )
        if pool not in ("cls", "mean"):
            raise ValueError(f"unknown pool {pool!r}")
        if img_size % patch_size:
            raise ValueError(f"img_size {img_size} is not a multiple of patch_size {patch_size}")
        self.num_classes = num_classes
        self.pool = pool
        self.class_token = class_token
        self.unpooled = unpooled
        self.compute_dtype = dtype
        self.patch_embed = PatchEmbed(patch_size, embed_dim, dtype=dtype)
        n_tok = (img_size // patch_size) ** 2 + int(class_token)
        self.feature_shape = (n_tok, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim)) if class_token else None
        self.pos_embed = nn.Parameter(torch.zeros(1, n_tok, embed_dim))
        self.pos_drop = nn.Dropout(dropout)
        self.blocks = nn.ModuleList(
            ViTBlock(
                embed_dim, num_heads, mlp_ratio,
                drop_path=stochastic_depth_prob * i / max(depth - 1, 1),
                dropout=dropout, attn_dropout=attention_dropout, init_values=init_values,
                dtype=dtype, use_fused=use_fused,
            )
            for i in range(depth)
        )
        self.norm = LayerNorm(embed_dim, dtype=dtype)
        self.head = Linear(embed_dim, num_classes, dtype=torch.float32) if num_classes else None

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            if self.cls_token is not None:
                self.cls_token.zero_()
            self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        tokens = self.patch_embed(x)
        if self.class_token:
            cls = self.cls_token.to(dt).expand(tokens.shape[0], -1, -1)
            tokens = torch.cat([cls, tokens], dim=1)
        tokens = self.pos_drop(tokens + self.pos_embed.to(dt))
        for block in self.blocks:
            tokens = block(tokens)
        tokens = self.norm(tokens)
        if self.num_classes == 0 and self.unpooled:
            return tokens.float()
        if self.pool == "mean" or not self.class_token:
            patch_tokens = tokens[:, 1:] if self.class_token else tokens
            feats = patch_tokens.mean(dim=1)
        else:
            feats = tokens[:, 0]
        feats = feats.float()
        if self.head is None:
            return feats
        return self.head(feats)


def _vit(patch_size, embed_dim, depth, num_heads, **extra):
    def factory(num_classes: int = 1000, dtype: torch.dtype = torch.float32, **kwargs):
        cfg = dict(extra)
        cfg.update(kwargs)
        return VisionTransformer(
            patch_size=patch_size,
            embed_dim=embed_dim,
            depth=depth,
            num_heads=num_heads,
            num_classes=num_classes,
            dtype=dtype,
            **cfg,
        )

    return factory


BACKBONES.register(_vit(16, 384, 12, 6), name="vit_small_patch16_224")
BACKBONES.register(_vit(16, 768, 12, 12), name="vit_base_patch16_224")
BACKBONES.register(_vit(8, 768, 12, 12), name="vit_base_patch8_224")
BACKBONES.register(_vit(16, 1024, 24, 16), name="vit_large_patch16_224")
BACKBONES.register(_vit(14, 1280, 32, 16), name="vit_huge_patch14_224")
BACKBONES.register(
    _vit(14, 1024, 24, 16, init_values=1e-5, mlp_ratio=4.0),
    name="vit_large_patch14_dinov2",
)
# SigLIP so400m: no CLS token and 'map' pooling, which raises until ported
BACKBONES.register(
    _vit(14, 1152, 27, 16, mlp_ratio=4304 / 1152, class_token=False, pool="map"),
    name="vit_so400m_patch14_siglip_224",
)
