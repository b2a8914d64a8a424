"""Margin heads (counterpart of ``visiondk_tpu/models/heads.py``): ArcFace,
MagFace, CircleLoss and MV-Softmax as modules over the ops of
``ops/margin_heads.py``, built by ``build_head`` from the same config keys
(``{head_type: {feat_dim, num_class, ...}}``).

Each head holds ``weight`` [feat_dim, num_class] in the reference layout
(not transposed) and returns ``(logits, aux_loss)``. The port holds exactly
``num_class`` columns: the JAX heads pad the class dim to a multiple of 128
and mask the pad logits to −1e9, a TPU lane and mesh layout that changes
neither the loss nor the gradients (the weight bridge takes the first
``num_class`` columns of a padded JAX weight).
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch
from torch import nn

from visiondk_tpu_torch.ops import margin_heads as ops
from visiondk_tpu_torch.parallel.mesh import shard_ranges


class MarginHead(nn.Module):
    """Base: the [feat_dim, num_class] weight and the op's options (the
    subclass's ``defaults``; an unknown option raises ``TypeError``, as the
    JAX dataclass modules do)."""

    op: Callable = None
    defaults: Dict[str, Any] = {}

    def __init__(self, feat_dim: int, num_class: int, **options):
        super().__init__()
        unknown = sorted(set(options) - set(self.defaults))
        if unknown:
            raise TypeError(f"{type(self).__name__} got unexpected options {unknown}")
        self.feat_dim, self.num_class = int(feat_dim), int(num_class)
        self.options = {**self.defaults, **options}
        self.weight = nn.Parameter(torch.empty(self.feat_dim, self.num_class))
        self.mesh = None  # the MeshContext of a class-sharded head (``shard``)
        self.class_offset = 0

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.copy_(ops.init_margin_weight(generator, self.feat_dim, self.num_class))

    def shard(self, mesh) -> None:
        """Keep this rank's class shard of the (full, initialised) weight;
        ``mesh.n_model`` must be more than 1."""
        lo, hi = shard_ranges(self.num_class, mesh.n_model)[mesh.model_index]
        self.weight = nn.Parameter(self.weight.detach()[:, lo:hi].clone())
        self.mesh, self.class_offset = mesh, lo

    def forward(self, feats: torch.Tensor, labels: torch.Tensor):
        if self.mesh is None:
            return type(self).op(self.weight, feats, labels, **self.options)
        feats = self.mesh.model_rows(feats)
        labels = self.mesh.model_rows(labels) - self.class_offset
        return type(self).op(self.weight, feats, labels, **self.options, **self.sharded_options())

    def sharded_options(self) -> Dict[str, Any]:
        return {}

    def extra_repr(self) -> str:
        shard = "" if self.mesh is None else (
            f", shard=[{self.class_offset}, {self.class_offset + self.weight.shape[1]})")
        return f"feat_dim={self.feat_dim}, num_class={self.num_class}{shard}, " + ", ".join(
            f"{k}={v}" for k, v in self.options.items())


class ArcFaceHead(MarginHead):
    op = staticmethod(ops.arcface_logits)
    defaults = {"margin_arc": 0.35, "margin_am": 0.0, "scale": 32.0}


class MagFaceHead(MarginHead):
    op = staticmethod(ops.magface_logits)
    defaults = {"margin_am": 0.0, "scale": 32.0, "l_a": 10.0, "u_a": 110.0, "l_margin": 0.45, "u_margin": 0.8,
                "lamda": 20.0}


class CircleLossHead(MarginHead):
    op = staticmethod(ops.circle_logits)
    defaults = {"margin": 0.25, "gamma": 256.0}


class MVSoftmaxHead(MarginHead):
    op = staticmethod(ops.mv_softmax_logits)
    defaults = {"is_am": False, "margin": 0.35, "mv_weight": 1.12, "scale": 32.0}

    def sharded_options(self) -> Dict[str, Any]:
        return {"class_sum": self.mesh.model_sum}


def build_head(head_config: dict) -> MarginHead:
    """head_config = {head_type: params} — the reference's head_def schema."""
    (head_type, params), = head_config.items()
    params = dict(params or {})
    feat_dim = params.pop("feat_dim")
    num_class = params.pop("num_class")
    if head_type == "arcface":
        return ArcFaceHead(feat_dim, num_class, **params)
    if head_type == "magface":
        return MagFaceHead(feat_dim, num_class, **params)
    if head_type == "circleloss":
        return CircleLossHead(feat_dim, num_class, **params)
    if head_type in ("mv-softmax", "mv_softmax"):
        return MVSoftmaxHead(feat_dim, num_class, **params)
    raise ValueError(
        f"head {head_type!r} not supported (arcface, magface, circleloss, mv-softmax)"
    )
