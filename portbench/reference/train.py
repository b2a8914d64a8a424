"""The reference train step, plain float32: the model's loss and gradients
(computed in blocks of rows), then the optimizer of the configuration's
``hyp``, frozen here from the trainer's math:

- clip by the global norm of all gradients at 10 (``t · 10 / g`` when
  g ≥ 10);
- SGD: g ← g + wd·p; v ← μ·v + g; p ← p − lr·v, the trace starting at 0;
  with the layer-wise option the margin head's lr ×10;
- lr and μ at the count of updates applied so far: ``cosine_with_warm``
  (linear 0.1 → 1 over the warm epochs, then a cosine to lrf_ratio · lr0,
  lrf_ratio 0.1 by default) and the warm-up momentum before ``warm_ep``, at
  epoch t = count / steps_per_epoch in float32 (floored for classification,
  which steps its schedule per epoch);
- EMA of every parameter: e ← d·e + (1 − d)·p with d = 0.9999·(1 − e^(−u/2000))
  after the u-th update.

Each step draws its seed as the train step does: one
``torch.randint(0, 2**62)`` from a CPU generator seeded with the step seed;
stochastic depth then draws its masks after ``torch.manual_seed`` of it.

Blocks: the rows part of the model (row-independent) runs once without
gradients over every block of rows to give z for the whole batch; the batch
part (which may couple rows, as BatchNorm does) runs on all of z and gives the
loss, the gradients of its own parameters and dL/dz; then each block's rows
part runs again with gradients and is back-propagated from its rows of dL/dz.
The gradients are those of the whole batch's loss.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from portbench.reference.common import Precision, split_rows

CLIP_NORM = 10.0
EMA_DECAY, EMA_TAU = 0.9999, 2000.0
HEAD_MULTIPLIER = 10.0


def schedule(hyp: Dict, count: int, steps_per_epoch: int, discrete: bool) -> Tuple[float, float]:
    """(lr, momentum) at ``count`` applied updates."""
    t = float(np.float32(count) / np.float32(steps_per_epoch))
    if discrete:
        t = math.floor(t)
    warm, epochs, lr0 = hyp["warm_ep"], hyp["epochs"], hyp["lr0"]
    r = 0.1 if hyp.get("lrf_ratio") is None else hyp["lrf_ratio"]
    if hyp["scheduler"] != "cosine_with_warm":
        raise ValueError(f"the reference has no schedule {hyp['scheduler']!r}")
    if t < warm:
        lr = lr0 * (0.1 + 0.9 * min(max(t / max(warm, 1e-8), 0.0), 1.0))
    else:
        frac = min(max((t - warm) / max(epochs - warm, 1e-8), 0.0), 1.0)
        lr = r * lr0 + (lr0 - r * lr0) * 0.5 * (1.0 + math.cos(math.pi * frac))
    momentum = hyp["warmup_momentum"] if t < warm else hyp["momentum"]
    return lr, momentum


def rank_seed(seed: int, rank: int) -> int:
    """The seed rank ``rank`` of a data-parallel step draws its masks from (rank 0 keeps the step's)."""
    return (seed + rank * 0x9E3779B97F4A7C15) % 2**62


def step_masks(model, arch: Dict, rows: int, seed: int, world: int, device):
    """The keep masks of a step over ``rows`` rows split evenly over ``world``
    ranks, each rank's rows drawn from its own seed; None without stochastic depth."""
    per_rank = [model.drop_masks(arch, rows // world, rank_seed(seed, r), device) for r in range(world)]
    if per_rank[0] is None:
        return None
    return [tuple(None if branch[0] is None else torch.cat(list(branch))
                  for branch in zip(*(ranks[k] for ranks in per_rank)))
            for k in range(len(per_rank[0]))]


def step_seeds(step_seed: int, steps: int) -> List[int]:
    gen = torch.Generator().manual_seed(step_seed)
    return [int(torch.randint(0, 2**62, (), generator=gen)) for _ in range(steps)]


def loss_and_grads(model, params: Dict[str, torch.Tensor], buffers: Dict, images: torch.Tensor,
                   labels: torch.Tensor, arch: Dict, cfg: Dict, prec: Precision, masks,
                   block_rows: int) -> Tuple[float, Dict[str, torch.Tensor]]:
    """The whole batch's loss and every parameter's gradient (see the module doc)."""
    rows = images.shape[0]
    blocks = split_rows(rows, block_rows)

    def block_masks(sl):
        if masks is None:
            return None
        return [tuple(None if m is None else m[sl] for m in pair) for pair in masks]

    with torch.no_grad():
        z = torch.cat([model.rows_forward(params, images[sl], arch, cfg, prec, block_masks(sl)) for sl in blocks])
    z.requires_grad_(True)
    batch_names = set(model.batch_params(arch))
    loss = model.batch_loss(params, buffers, z, labels, arch, cfg, prec)
    head = [params[n] for n in batch_names]
    got = torch.autograd.grad(loss, [z] + head)
    dz = got[0]
    grads = {n: g for n, g in zip(batch_names, got[1:])}
    rest = [n for n in params if n not in batch_names]
    acc = {n: torch.zeros_like(params[n]) for n in rest}
    for sl in blocks:
        zb = model.rows_forward(params, images[sl], arch, cfg, prec, block_masks(sl))
        gb = torch.autograd.grad(zb, [params[n] for n in rest], dz[sl], allow_unused=True)
        for n, g in zip(rest, gb):
            if g is not None:
                acc[n] += g
        del zb, gb
    grads.update(acc)
    return float(loss.detach()), grads


def train_steps(model, arch: Dict, cfg: Dict, weights: Dict[str, torch.Tensor], buffers: Dict,
                batches: Sequence[Tuple[torch.Tensor, torch.Tensor]], step_seed: int,
                prec: Precision, block_rows: int, world: int = 1) -> Dict:
    """Runs len(batches) reference steps from ``weights``. Returns the loss of
    each step, each leaf's first clipped gradient, and each leaf's change and
    its EMA's change after the last step, all on ``weights``' names. With
    ``world`` > 1 each batch is the global batch of that many ranks, and each
    rank's rows draw their stochastic-depth masks from that rank's seed."""
    hyp = cfg["hyp"]
    discrete = cfg["model"]["task"] == "classification"
    layer_wise = bool(hyp["optimizer"][1]) if len(hyp["optimizer"]) > 1 else False
    params = {n: w.clone().requires_grad_(True) for n, w in weights.items()}
    trace = {n: torch.zeros_like(w) for n, w in weights.items()}
    ema = {n: w.clone() for n, w in weights.items()}
    losses, first_grads = [], None
    seeds = step_seeds(step_seed, len(batches))
    for count, ((images, labels), seed) in enumerate(zip(batches, seeds)):
        masks = step_masks(model, arch, images.shape[0], seed, world, images.device)
        loss, grads = loss_and_grads(model, params, buffers, images, labels, arch, cfg, prec, masks, block_rows)
        losses.append(loss)
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            factor = torch.where(norm < CLIP_NORM, 1.0, CLIP_NORM / norm)
            grads = {n: g * factor for n, g in grads.items()}
            if first_grads is None:
                first_grads = {n: g.clone() for n, g in grads.items()}
            lr, momentum = schedule(hyp, count, cfg["steps_per_epoch"], discrete)
            decay = EMA_DECAY * (1.0 - math.exp(-(count + 1) / EMA_TAU))
            for n, p in params.items():
                trace[n].mul_(momentum).add_(grads[n] + hyp["weight_decay"] * p)
                mult = HEAD_MULTIPLIER if layer_wise and n.startswith("head.") else 1.0
                p.sub_(lr * mult * trace[n])
                ema[n].lerp_(p, 1.0 - decay)
        del grads
    with torch.no_grad():
        return {
            "losses": losses,
            "first_grad": {n: g for n, g in first_grads.items()},
            "change": {n: params[n].detach() - weights[n] for n in weights},
            "ema_change": {n: ema[n] - weights[n] for n in weights},
        }
