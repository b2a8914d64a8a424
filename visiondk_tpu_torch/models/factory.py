"""Model factory (counterpart of ``visiondk_tpu/models/factory.py``).

- classification → backbone with a ``num_classes``-way f32 linear head, or
  with ``attention_pool`` the backbone in unpooled mode → ``AttentionPooling``
  (``pool``, in the compute dtype) over its tokens (a CNN's or Swin's NHWC map
  flattened to [B, H·W, C]; ViT's token map keeps its CLS row) → an f32
  Linear (``fc``);
- face/cbir → backbone in unpooled mode → the neck: LayerNorm over a token
  map or BatchNorm over a CNN map → flatten → Linear(feat_dim) →
  BatchNorm1d (f32), whose output is the embedding, and the margin head
  (``models/heads.py``) that trains it.

``get_model`` takes the ``model:`` section of a YAML config as a dict and
returns a model initialised as the JAX package initialises one, drawn from an
explicit ``torch.Generator``, on the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from visiondk_tpu_torch.config.checks import canonical_model_name
from visiondk_tpu_torch.models.backbones import BACKBONES
from visiondk_tpu_torch.models.heads import build_head
from visiondk_tpu_torch.models.layers import (
    AttentionPooling, BatchNorm1d, BatchNorm2d, LayerNorm, Linear, init_params,
)


class EmbeddingNeck(nn.Module):
    """The JAX package's ``EmbeddingNeck``: a token map [B, N, C] gets
    LayerNorm, a CNN map [B, H, W, C] (NHWC) gets BatchNorm in the
    backbone's dtype; then flatten (NHWC order, so ``proj`` lines up with
    the JAX Dense) → Linear(feat_dim) → BatchNorm1d in f32. ``in_shape`` is
    the backbone's ``feature_shape``: (N, C) or (H, W, C)."""

    def __init__(self, in_shape: Tuple[int, ...], feat_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        *spatial, c = in_shape
        self.map_ndim = len(in_shape) + 1
        # flax BatchNorm(momentum=0.9, epsilon=1e-5) ↔ torch momentum 0.1
        self.norm = BatchNorm2d(c, dtype=dtype) if len(spatial) == 2 else LayerNorm(c, dtype=dtype)
        self.proj = Linear(math.prod(in_shape), feat_dim, dtype=dtype)
        self.bn_out = BatchNorm1d(feat_dim, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim != self.map_ndim:
            raise ValueError(f"this EmbeddingNeck takes a {self.map_ndim}-d map, got {tuple(x.shape)}")
        if x.ndim == 4:  # NHWC → NCHW view for the BatchNorm, and back
            x = self.norm(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        else:
            x = self.norm(x)
        x = self.proj(x.flatten(1))
        return self.bn_out(x.float())


class VisionModel(nn.Module):
    """Classification model: backbone(num_classes) → f32 logits, or with
    ``attention_pool`` backbone(0, unpooled) → ``pool`` → ``fc`` (the JAX
    ``VisionModel``'s two branches)."""

    def __init__(self, backbone_name: str, num_classes: int, attention_pool: bool = False,
                 backbone_kwargs: Optional[Dict[str, Any]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kwargs = dict(backbone_kwargs or {})
        self.attention_pool = attention_pool
        self.compute_dtype = dtype
        if attention_pool:
            self.backbone = BACKBONES.create(backbone_name, num_classes=0, dtype=dtype, unpooled=True, **kwargs)
            dim = self.backbone.feature_shape[-1]
            self.pool = AttentionPooling(dim, dtype=dtype)
            self.fc = Linear(dim, num_classes, dtype=torch.float32)
        else:
            self.backbone = BACKBONES.create(backbone_name, num_classes=num_classes, dtype=dtype, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.attention_pool:
            return self.backbone(x)
        fmap = self.backbone(x)
        if fmap.ndim == 4:  # NHWC → tokens
            fmap = fmap.flatten(1, 2)
        return self.fc(self.pool(fmap.to(self.compute_dtype)).float())


class EmbeddingModel(nn.Module):
    """Face/CBIR model: backbone(unpooled) → neck → [B, feat_dim] embedding.

    ``forward(x, labels)`` → (margin logits, aux loss) for training (the
    head's); ``embed(x)`` → the [B, feat_dim] embedding for extraction and
    evaluation. Without ``head_config`` the model only embeds."""

    def __init__(self, backbone_name: str, feat_dim: int,
                 head_config: Optional[Dict[str, Any]] = None,
                 backbone_kwargs: Optional[Dict[str, Any]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone = BACKBONES.create(
            backbone_name, num_classes=0, dtype=dtype, unpooled=True, **(backbone_kwargs or {})
        )
        self.neck = EmbeddingNeck(self.backbone.feature_shape, feat_dim, dtype=dtype)
        self.head = build_head(head_config) if head_config is not None else None

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        return self.neck(self.backbone(x))

    def forward(self, x: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.head is None:
            raise ValueError("this EmbeddingModel has no margin head (model.head); call embed()")
        return self.head(self.embed(x), labels)


def _image_size(kwargs: Dict[str, Any], image_size: Optional[int]) -> Dict[str, Any]:
    # the JAX models size the positional embedding from their first input;
    # the port sizes it from the config's image_size
    if image_size is not None:
        kwargs.setdefault("img_size", int(image_size))
    return kwargs


def get_model(
    model_cfg: Dict[str, Any],
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
    generator: Optional[torch.Generator] = None,
) -> nn.Module:
    """Task dispatch mirroring the JAX ``get_model``. Parameters are drawn on
    the CPU from ``generator`` (default: seed 0), so a seed gives the same
    weights on every device, then moved to ``device``: the card by default.
    Without CUDA that raises; a CPU caller passes ``device="cpu"``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"get_model: device {device} was asked for (the default) but CUDA is not available; "
            "pass device='cpu' to build the model on the CPU"
        )
    task = model_cfg["task"]
    if task == "classification":
        kwargs = dict(model_cfg.get("kwargs") or {})
        if model_cfg.get("bn_freeze"):
            kwargs["bn_eval"] = True
        cls, args = VisionModel, dict(
            backbone_name=canonical_model_name(model_cfg["name"]),
            num_classes=model_cfg["num_classes"],
            attention_pool=model_cfg.get("attention_pool", False),
            backbone_kwargs=_image_size(kwargs, model_cfg.get("image_size")),
        )
    elif task in ("face", "cbir"):
        (bb_name, bb_params), = model_cfg["backbone"].items()
        bb_params = dict(bb_params or {})
        extra = {
            k: v for k, v in bb_params.items() if k not in ("feat_dim", "image_size", "pretrained")
        }
        cls, args = EmbeddingModel, dict(
            backbone_name=canonical_model_name(bb_name),
            feat_dim=bb_params.get("feat_dim", 128),
            head_config=model_cfg.get("head"),
            backbone_kwargs=_image_size(extra, bb_params.get("image_size")),
        )
    else:
        raise ValueError(f"task {task!r} not supported")
    with torch.device("meta"):  # no memory and no random draws until init_params
        model = cls(**args, dtype=dtype)
    model = model.to_empty(device="cpu")
    init_params(model, generator if generator is not None else torch.Generator().manual_seed(0))
    return model.to(device)
