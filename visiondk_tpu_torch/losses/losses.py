"""Loss registry: ce (label smoothing), bce, focal, distill-KL
(counterpart of ``visiondk_tpu/losses/losses.py``).

- ``ce``    ≡ ``torch.nn.CrossEntropyLoss(label_smoothing=s)`` — int labels,
  mean over batch. Also accepts soft/one-hot targets (the mixup path).
- ``bce``   ≡ ``torch.nn.BCEWithLogitsLoss`` — mean over all elements.
- ``focal`` ≡ the TF-style focal loss around BCE: bce · alpha_factor ·
  (1 − p_t)^gamma, mean.
- ``distill_kl`` ≡ KL(student‖teacher) · T² / B.

Every loss computes in f32 (logits are upcast) and optionally takes a
``sample_weight`` [B] mask: a masked mean whose denominator is at least 1
(the OHEM form of the JAX package).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from visiondk_tpu_torch.registry import Registry

LOSS = Registry("loss")


def _weighted_mean(per_sample: torch.Tensor, sample_weight: Optional[torch.Tensor]) -> torch.Tensor:
    if sample_weight is None:
        return per_sample.mean()
    w = sample_weight.to(per_sample.dtype)
    return (per_sample * w).sum() / w.sum().clamp_min(1.0)


def softmax_cross_entropy(
    logits: torch.Tensor,
    targets: torch.Tensor,
    label_smooth: float = 0.0,
    sample_weight: Optional[torch.Tensor] = None,
    valid_class: Optional[int] = None,
) -> torch.Tensor:
    """CE with label smoothing. ``targets`` is int [B] or soft [B, C].

    ``valid_class``: the number of real classes when the logit width is padded
    (pad columns masked to −1e9): the smoothing mass is spread over the real
    classes only."""
    logits = logits.float()
    num_class = logits.shape[-1]
    if targets.dim() == logits.dim() - 1:
        q = F.one_hot(targets.long(), num_class).float()
    else:
        q = targets.float()
    if label_smooth > 0.0:
        if valid_class is not None and valid_class < num_class:
            real = (torch.arange(num_class, device=logits.device) < valid_class).float()
            q = (1.0 - label_smooth) * q + (label_smooth / valid_class) * real
        else:
            q = (1.0 - label_smooth) * q + label_smooth / num_class
    per_sample = -(q * F.log_softmax(logits, dim=-1)).sum(dim=-1)
    return _weighted_mean(per_sample, sample_weight)


def class_sharded_cross_entropy(
    logits: torch.Tensor,
    targets: torch.Tensor,
    num_class: int,
    class_offset: int,
    mesh,
    label_smooth: float = 0.0,
) -> torch.Tensor:
    """``softmax_cross_entropy`` of int ``targets`` over logits whose classes
    are split over ``mesh``'s model group: ``logits`` [R, C_j] are the model
    group's R rows against this rank's shard of the ``num_class`` classes,
    which starts at ``class_offset``; ``targets`` are this rank's rows (the
    group's are gathered here). Per row, the maximum, the sum of
    exponentials, the target logit and (for smoothing, over all
    ``num_class`` classes) the sum of logits are reduced over the group:
    ``lse − (1 − s)·z_y − (s/C)·Σ z``, the mean over the R rows. Every rank
    of the group returns the same value."""
    logits = logits.float()
    labels = mesh.model_rows(targets).long() - class_offset
    in_shard = (labels >= 0) & (labels < logits.shape[1])
    row_max = mesh.model_max(logits.max(dim=1).values)
    lse = row_max + torch.log(mesh.model_sum(torch.exp(logits - row_max[:, None]).sum(dim=1)))
    picked = logits.gather(1, labels.clamp(0, logits.shape[1] - 1)[:, None])[:, 0]
    target = mesh.model_sum(torch.where(in_shard, picked, 0.0))
    per_row = lse - (1.0 - label_smooth) * target
    if label_smooth > 0.0:
        per_row = per_row - (label_smooth / num_class) * mesh.model_sum(logits.sum(dim=1))
    return per_row.mean()


def _bce_elements(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    # log(1 + e^-|x|), the stable form
    return logits.clamp_min(0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def _per_sample(per_elem: torch.Tensor) -> torch.Tensor:
    return per_elem.mean(dim=tuple(range(1, per_elem.dim()))) if per_elem.dim() > 1 else per_elem


def sigmoid_binary_cross_entropy(
    logits: torch.Tensor, targets: torch.Tensor, sample_weight: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """BCE-with-logits, mean over all elements (per-sample mean over classes
    first, so ``sample_weight`` masks whole rows)."""
    logits, targets = logits.float(), targets.float()
    return _weighted_mean(_per_sample(_bce_elements(logits, targets)), sample_weight)


def sigmoid_focal(
    logits: torch.Tensor,
    targets: torch.Tensor,
    alpha: float = 0.25,
    gamma: float = 1.5,
    sample_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """TF-addons-style focal loss over BCE elements."""
    logits, targets = logits.float(), targets.float()
    p = torch.sigmoid(logits)
    p_t = targets * p + (1.0 - targets) * (1.0 - p)
    alpha_factor = targets * alpha + (1.0 - targets) * (1.0 - alpha)
    per_elem = _bce_elements(logits, targets) * alpha_factor * torch.pow(1.0 - p_t, gamma)
    return _weighted_mean(_per_sample(per_elem), sample_weight)


def distill_kl(
    student_logits: torch.Tensor, teacher_logits: torch.Tensor, temperature: float = 4.0
) -> torch.Tensor:
    """KL(student ‖ teacher) at temperature T, scaled by T²/B."""
    t = temperature
    log_p_s = F.log_softmax(student_logits.float() / t, dim=1)
    p_t = F.softmax(teacher_logits.float() / t, dim=1)
    kl = (p_t * (torch.log(p_t.clamp_min(1e-12)) - log_p_s)).sum()
    return kl * (t**2) / student_logits.shape[0]


# --- registry entries: factory(params) -> fn(logits, targets, sample_weight=None) ---


@LOSS.register(name="ce")
def cross_entropy(label_smooth: float = 0.0, valid_class: Optional[int] = None) -> Callable:
    def fn(logits, targets, sample_weight=None):
        return softmax_cross_entropy(logits, targets, label_smooth, sample_weight, valid_class)

    return fn


@LOSS.register(name="bce")
def binary_cross_entropy() -> Callable:
    def fn(logits, targets, sample_weight=None):
        return sigmoid_binary_cross_entropy(logits, targets, sample_weight)

    return fn


@LOSS.register(name="focal")
def focal_loss(gamma: float = 1.5, alpha: float = 0.25) -> Callable:
    def fn(logits, targets, sample_weight=None):
        return sigmoid_focal(logits, targets, alpha, gamma, sample_weight)

    return fn


def create_lossfn(name: str, **kwargs) -> Callable:
    return LOSS.create(name, **kwargs)


def list_lossfns():
    return LOSS.keys()
