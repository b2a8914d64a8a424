"""Margin-softmax logit ops: ArcFace, MagFace, CircleLoss, MV-Softmax
(counterpart of ``visiondk_tpu/ops/margin_heads.py``).

Plain PyTorch functions of a weight ``[feat_dim, num_class]`` (the
reference's layout), features ``[B, feat_dim]`` and int labels ``[B]``,
each returning ``(logits [B, num_class], aux_loss)``: normalise, the cosine
product, then the margin rewrite on the target column through a one-hot
mask (``torch.where``), in the JAX expression order (clip, then sqrt) so that
autograd gives the JAX gradients. ``aux_loss`` is 0 except for MagFace's
norm regulariser λ·mean g(‖x‖).

The cosine is taken in at least f32 (f32 for f32 or bf16 inputs, f64 for
f64 inputs) from features and weight normalised in that dtype; their
product runs in float64 and is rounded back. The JAX op asks for
``Precision.HIGHEST``: TF32's ~1e-3 relative error times the scale would
flip ``cos > min_cos`` and MV-Softmax's hard mask, and whether an f32
product may use TF32 is a process-wide setting of the caller's (legacy
``allow_tf32`` or the newer ``fp32_precision``, which PyTorch refuses to
have read once both were used). No setting reaches a float64 product, and
its f32 rounding is at least as close to the exact sum as JAX's f32
accumulation.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

_EPS = 1e-12

Pair = Tuple[torch.Tensor, torch.Tensor]


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = _EPS) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(torch.square(x), dim=dim, keepdim=True))
    return x / torch.clamp_min(norm, eps)


def cosine_logits(weight: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """cos θ between L2-normalised features [B, D] and class weights [D, C]."""
    dtype = torch.promote_types(feats.dtype, torch.float32)
    w = l2_normalize(weight.to(dtype), dim=0)
    f = l2_normalize(feats.to(dtype), dim=1)
    return torch.clamp((f.double() @ w.double()).to(dtype), -1.0, 1.0)


def _one_hot_mask(labels: torch.Tensor, num_class: int) -> torch.Tensor:
    return torch.arange(num_class, device=labels.device) == labels.reshape(-1, 1)


def _zero(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=like.dtype, device=like.device)


def arcface_logits(weight: torch.Tensor, feats: torch.Tensor, labels: torch.Tensor, margin_arc: float = 0.35,
                   margin_am: float = 0.0, scale: float = 32.0) -> Pair:
    """Additive angular margin: cos(θ+m) on the target class, the AM
    fallback cos − m_am where θ > π − m."""
    cos = cosine_logits(weight, feats)
    sin = torch.sqrt(torch.clamp(1.0 - torch.square(cos), 0.0, 1.0))
    cos_m = cos * math.cos(margin_arc) - sin * math.sin(margin_arc)
    min_cos = math.cos(math.pi - margin_arc)
    cos_m = torch.where(cos > min_cos, cos_m, cos - margin_am)
    mask = _one_hot_mask(labels, cos.shape[1])
    return torch.where(mask, cos_m, cos) * scale, _zero(cos)


def magface_logits(weight: torch.Tensor, feats: torch.Tensor, labels: torch.Tensor, margin_am: float = 0.0,
                   scale: float = 32.0, l_a: float = 10.0, u_a: float = 110.0, l_margin: float = 0.45,
                   u_margin: float = 0.8, lamda: float = 20.0) -> Pair:
    """Feature-norm-adaptive margin m(‖x‖), aux = λ·mean over the batch of
    g(‖x‖) = ‖x‖/u_a² + 1/‖x‖."""
    x = feats.to(torch.promote_types(feats.dtype, torch.float32))
    x_norm = torch.clamp(torch.sqrt(torch.sum(torch.square(x), dim=1, keepdim=True)), l_a, u_a)  # [B, 1]
    ada_m = (u_margin - l_margin) / (u_a - l_a) * (x_norm - l_a) + l_margin
    cos_ada, sin_ada = torch.cos(ada_m), torch.sin(ada_m)
    loss_g = x_norm / (u_a**2) + 1.0 / x_norm

    cos = cosine_logits(weight, feats)
    sin = torch.sqrt(torch.clamp(1.0 - torch.square(cos), 0.0, 1.0))
    cos_m = cos * cos_ada - sin * sin_ada
    min_cos = torch.cos(math.pi - ada_m)
    cos_m = torch.where(cos > min_cos, cos_m, cos - margin_am)
    mask = _one_hot_mask(labels, cos.shape[1])
    return torch.where(mask, cos_m, cos) * scale, lamda * torch.mean(loss_g)


def circle_logits(weight: torch.Tensor, feats: torch.Tensor, labels: torch.Tensor, margin: float = 0.25,
                  gamma: float = 256.0) -> Pair:
    """Classification-form circle loss; the α re-weighting factors are
    detached (the JAX ``stop_gradient``)."""
    cos = cosine_logits(weight, feats)
    o_p, o_n = 1.0 + margin, -margin
    delta_p, delta_n = 1.0 - margin, margin
    cos_sg = cos.detach()
    alpha_p = torch.clamp_min(o_p - cos_sg, 0.0)
    alpha_n = torch.clamp_min(cos_sg - o_n, 0.0)
    logit_p = alpha_p * (cos - delta_p)
    logit_n = alpha_n * (cos - delta_n)
    mask = _one_hot_mask(labels, cos.shape[1])
    return torch.where(mask, logit_p, logit_n) * gamma, _zero(cos)


def mv_softmax_logits(weight: torch.Tensor, feats: torch.Tensor, labels: torch.Tensor, is_am: bool = False,
                      margin: float = 0.35, mv_weight: float = 1.12, scale: float = 32.0,
                      class_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> Pair:
    """Mis-classified-vector guided softmax: hard negatives (cos above the
    margin-adjusted target) re-weighted by ``mv_weight``; the target column
    takes an AM (``is_am``) or Arc margin. For a weight that holds one shard
    of the classes, ``class_sum`` sums the ground-truth cosine over the
    shards (a label outside this shard matches no column here)."""
    cos = cosine_logits(weight, feats)
    mask_gt = _one_hot_mask(labels, cos.shape[1])
    gt = torch.sum(torch.where(mask_gt, cos, 0.0), dim=1, keepdim=True)  # [B, 1]
    if class_sum is not None:
        gt = class_sum(gt)
    if is_am:
        hard_mask = cos > (gt - margin)
        final_gt = torch.where(gt > margin, gt - margin, gt)
    else:
        sin_gt = torch.sqrt(torch.clamp(1.0 - torch.square(gt), 0.0, 1.0))
        cos_gt_m = gt * math.cos(margin) - sin_gt * math.sin(margin)
        hard_mask = cos > cos_gt_m
        final_gt = torch.where(gt > 0.0, cos_gt_m, gt)
    reweighted = torch.where(hard_mask, mv_weight * cos + (mv_weight - 1.0), cos)
    return torch.where(mask_gt, final_gt, reweighted) * scale, _zero(cos)


def init_margin_weight(generator: torch.Generator, feat_dim: int, num_class: int) -> torch.Tensor:
    """U(−1, 1) with every class column renormalised to unit L2 (the
    reference's ``uniform_(-1, 1).renorm_(2, 1, 1e-5).mul_(1e5)``), drawn on
    the generator's device."""
    w = torch.empty((feat_dim, num_class), device=generator.device).uniform_(-1.0, 1.0, generator=generator)
    norm = torch.sqrt(torch.sum(torch.square(w), dim=0, keepdim=True))
    return w / torch.clamp_min(norm, _EPS)


MARGIN_OPS = {
    "arcface": arcface_logits,
    "magface": magface_logits,
    "circleloss": circle_logits,
    "mv_softmax": mv_softmax_logits,
}
