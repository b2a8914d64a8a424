"""The numbers that decide ``correct``, from the program's readings and the
reference's.

Training (three steps from the same weights and batches):

- ``loss_gap``: the largest |L − L_ref| / |L_ref| over the three steps;
- ``grad_gap``: over the leaves, the largest |‖g‖ − ‖g_ref‖| / max(‖g_ref‖,
  the median leaf's ‖g_ref‖), g the first step's gradient as the optimizer
  got it (clipped; the program's worked out from its SGD trace after one
  step: trace − wd·θ₀);
- ``change_gap``: the same of each leaf's change θ₃ − θ₀ after three steps;
- ``ema_change_gap``: the same of each leaf's EMA change after three steps.

Leaves whose reference gradient is under a thousandth of the median leaf's
(nought to rounding, as a key projection's bias under softmax) move under the
optimizer by round-off and weight decay alone; they are left out of all three
leaf numbers by that rule on the reference's gradient, never by name.

Embedding: ``row_gap``, the largest ‖e − e_ref‖₂ over the sampled rows of unit
embeddings.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

import torch

TINY_SHARE = 1e-3


def norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(leaves)
    values = torch.stack([torch.linalg.vector_norm(leaves[n].float()) for n in names]).tolist()
    return dict(zip(names, values))


def counted(ref_grad: Dict[str, float]) -> List[str]:
    """Leaves whose reference gradient is at least a thousandth of the median leaf's."""
    median = statistics.median(ref_grad.values())
    return [n for n, v in ref_grad.items() if v >= TINY_SHARE * median]


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], names: List[str]) -> Tuple[float, str]:
    """(largest |prog − ref| / max(ref, median ref), its leaf) over ``names``."""
    median = statistics.median(ref[n] for n in names)
    worst, where = 0.0, ""
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30)
        if gap > worst:
            worst, where = gap, n
    return worst, where


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, Tuple[float, str]]:
    """``prog`` and ``ref``: {"losses": [...], "first_grad", "change",
    "ema_change": {leaf: norm}}. Returns {number: (value, where)}."""
    if set(prog["first_grad"]) != set(ref["first_grad"]):
        raise ValueError("the program's leaves are not the reference's")
    loss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]):
        loss = float("inf")
    names = counted(ref["first_grad"])
    out = {"loss_gap": (loss, f"steps 1-{len(ref['losses'])}")}
    for key in ("first_grad", "change", "ema_change"):
        label = {"first_grad": "grad_gap", "change": "change_gap", "ema_change": "ema_change_gap"}[key]
        out[label] = leaf_gap(prog[key], ref[key], names)
    return out


def row_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest L2 distance between matching rows."""
    return float(torch.linalg.vector_norm(prog.float() - ref.float(), dim=1).max())


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[Tuple[str, float, float]]]:
    """(every number within its limit, [(name, value, limit)]). A number
    without a limit, a limit without a number, or a NaN is not correct."""
    rows = [(name, numbers.get(name, float("nan")), float(limit)) for name, limit in limits.items()]
    ok = bool(rows) and all(v == v and v <= lim for _, v, lim in rows) and set(numbers) <= set(limits)
    return ok, rows
