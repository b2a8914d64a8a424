"""Model factory (counterpart of ``visiondk_tpu/models/factory.py``).

- classification → backbone with a ``num_classes``-way f32 linear head;
- face/cbir → backbone in unpooled token-map mode → LayerNorm → flatten →
  Linear(feat_dim) → BatchNorm1d neck (f32), whose output is the embedding.

Ported so far: the serving side. ``VisionModel(attention_pool=True)`` and the
margin heads of ``EmbeddingModel`` (``head_config``) raise
``NotImplementedError`` until they are ported.

``get_model`` takes the ``model:`` section of a YAML config as a dict and
returns a model initialised as the JAX package initialises one, drawn from an
explicit ``torch.Generator``, on the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from visiondk_tpu_torch.config.checks import canonical_model_name
from visiondk_tpu_torch.models.backbones import BACKBONES
from visiondk_tpu_torch.models.layers import LayerNorm, Linear, init_params


class EmbeddingNeck(nn.Module):
    """Token map [B, N, C] → LayerNorm → flatten → Linear(feat_dim) →
    BatchNorm1d in f32 (the JAX package's ``EmbeddingNeck`` for token maps;
    its CNN-map branch arrives with the CNN backbones)."""

    def __init__(self, in_shape: Tuple[int, int], feat_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        n, c = in_shape
        self.norm = LayerNorm(c, dtype=dtype)
        self.proj = Linear(n * c, feat_dim, dtype=dtype)
        # flax BatchNorm(momentum=0.9, epsilon=1e-5) ↔ torch momentum 0.1
        self.bn_out = nn.BatchNorm1d(feat_dim, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim != 3:
            raise ValueError(f"EmbeddingNeck takes a [B, N, C] token map, got {tuple(x.shape)}")
        x = self.proj(self.norm(x).flatten(1))
        return self.bn_out(x.float())


class VisionModel(nn.Module):
    """Classification model: backbone(num_classes) → f32 logits."""

    def __init__(self, backbone_name: str, num_classes: int, attention_pool: bool = False,
                 backbone_kwargs: Optional[Dict[str, Any]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if attention_pool:
            raise NotImplementedError("attention_pool is not ported to visiondk_tpu_torch yet")
        self.backbone = BACKBONES.create(
            backbone_name, num_classes=num_classes, dtype=dtype, **(backbone_kwargs or {})
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.backbone(x)


class EmbeddingModel(nn.Module):
    """Face/CBIR model: backbone(unpooled) → neck → [B, feat_dim] embedding.
    ``forward`` is ``embed``; the margin heads of training are not ported yet."""

    def __init__(self, backbone_name: str, feat_dim: int,
                 head_config: Optional[Dict[str, Any]] = None,
                 backbone_kwargs: Optional[Dict[str, Any]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if head_config is not None:
            raise NotImplementedError("margin heads are not ported to visiondk_tpu_torch yet")
        self.backbone = BACKBONES.create(
            backbone_name, num_classes=0, dtype=dtype, unpooled=True, **(backbone_kwargs or {})
        )
        self.neck = EmbeddingNeck(self.backbone.feature_shape, feat_dim, dtype=dtype)

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        return self.neck(self.backbone(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.embed(x)


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
