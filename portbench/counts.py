"""The yardstick's arithmetic: the H100's peaks, a call's least time, and the
operations and bytes of the models and their attention, from shapes alone.
What is particular to an architecture kind (its blocks, the products of its
forward, its attention calls) is in ``portbench/shapes/<kind>.py``, found by
the configuration's ``arch["kind"]``; this module holds what every kind
shares.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit: 3.35 TB/s
of HBM and 989 TFLOP/s of dense bf16 tensor-core products. A bound is
``max(bytes / HBM rate, FLOPs / peak)``, each input read once and each output
written once.

The attention counts are of the op's interface, whatever implements it:

- bytes: read qkv (and the relative-position bias and dO), write O (and
  dqkv and dbias), each once, in the dtype they cross the interface in;
- FLOPs: 4·B·H·N²·d for the forward (QKᵀ and PV), 8·B·H·N²·d more for the
  backward (dV, dP, dQ, dK): 12·B·H·N²·d for a train step.

The probabilities P that the port's stash forwards write and its backwards
read back are not counted, nor is a recomputed P. Those are choices of one
implementation: a flash-style backward that recomputes P and never writes it
moves fewer bytes for the same op, and a yardstick that counted the stash
would read that change as a loss of roofline share where the op got faster.

Model FLOPs count the products only (linear layers, convolutions, attention),
2 per multiply-add, of one image. A train step is 3× the forward (the
backward twice the forward's products); recomputation is not counted, nor
is other work that does not grow with the batch.
"""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Dict, Iterator, List, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOP_PER_S = 989e12

BF16_BYTES = 2
F32_BYTES = 4


def bound_s(nbytes: float, flops: float) -> float:
    """The least seconds the card could take: bytes at the HBM rate or
    products at the bf16 peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOP_PER_S)


# ------------------------------------------------------------------ attention


def qkv_attention(b: int, n: int, heads: int, d: int, train: bool) -> Tuple[float, float]:
    """(bytes, FLOPs) of one global attention call on the packed [B, N, 3C]
    bf16 buffer: forward, or forward plus backward with ``train``."""
    c = heads * d
    qkv, o = b * n * 3 * c * BF16_BYTES, b * n * c * BF16_BYTES
    nbytes = qkv + o + ((o + qkv) if train else 0)  # + read dO, write dqkv
    flops = (12 if train else 4) * b * heads * n * n * d
    return float(nbytes), float(flops)


def window_attention(b: int, hh: int, ww: int, heads: int, d: int, ws: int, shifted: bool,
                     train: bool) -> Tuple[float, float]:
    """(bytes, FLOPs) of one window-attention call over a [B, H, W, 3C] bf16
    map in ws×ws windows: qkv, O (and dO, dqkv), the f32 bias [heads, N, N]
    read (and its gradient written), and for shifted windows the int32 region
    ids [nW, N]."""
    c, n = heads * d, ws * ws
    windows = (hh // ws) * (ww // ws)
    qkv, o = b * hh * ww * 3 * c * BF16_BYTES, b * hh * ww * c * BF16_BYTES
    bias = heads * n * n * F32_BYTES
    ids = windows * n * 4 if shifted else 0
    nbytes = qkv + o + bias + ids + ((o + qkv + bias) if train else 0)
    flops = (12 if train else 4) * b * windows * heads * n * n * d
    return float(nbytes), float(flops)


def attention_calls(arch: Dict, b: int, train: bool) -> List[Tuple[float, float]]:
    """(bytes, FLOPs) of each attention call of one step of ``arch`` at batch ``b``."""
    return shapes(arch).attention_calls(arch, b, train)


def attention_bound_s(arch: Dict, b: int, train: bool) -> float:
    """Σ over one step's attention calls of each call's bound."""
    return sum(bound_s(nb, fl) for nb, fl in attention_calls(arch, b, train))


# ------------------------------------------------------------------ models


def shapes(arch: Dict) -> ModuleType:
    """``portbench/shapes/<kind>.py``: the counts of ``arch``'s kind, found by name."""
    module = f"portbench.shapes.{arch['kind']}"
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise ValueError(f"no counts for arch kind {arch['kind']!r}: "
                         f"portbench/shapes/{arch['kind']}.py is missing") from None


def linear(tokens: int, fan_in: int, fan_out: int) -> float:
    """Products of a dense layer over ``tokens`` rows, 2 a multiply-add."""
    return 2.0 * tokens * fan_in * fan_out


def forward_flops(arch: Dict) -> float:
    """Products of one image's forward through ``arch``, FLOPs."""
    return shapes(arch).forward_flops(arch)


def swin_blocks(arch: Dict) -> Iterator[Tuple[int, int, int, int, int]]:
    """``blocks`` of ``arch``'s kind (``shapes/swin.py``), under its former name."""
    return shapes(arch).blocks(arch)


def step_flops(arch: Dict, images: int, train: bool) -> float:
    """Model FLOPs of ``images`` images: 3× the forward for a train step."""
    return (3.0 if train else 1.0) * forward_flops(arch) * images
