"""Int8 serving of the dense layers (counterpart of ``visiondk_tpu/ops/quant.py``).

Every dense layer of a model, ``models/layers.py::Linear`` and the 1×1
convolutions on a pooled map that the JAX package builds as ``nn.Dense``
(``Conv2d(dense=True)``: SE's ``conv_reduce``/``conv_expand``, MobileNetV3's
``conv_head``), computes

    y = (round(x/sx)·int8 @ round(W/sw)·int8) · (sx·sw) + b

with a dynamic per-tensor activation scale ``sx = absmax(x)/127`` and a static
per-output-channel weight scale ``sw``, in the JAX order: the scales in f32
(``max(absmax, 1e-12) / 127`` by a true division), the codes
``clip(round(x / scale), -127, 127)`` rounding half to even, the int32
product, then ``acc · (sx·sw)``, ``+ bias`` in f32 and the cast to the
layer's compute dtype. Everything else (norms, softmax, the attention
kernels, the other convolutions) stays in the model's dtype.

The int8 product is ``torch._int_mm``, cuBLASLt's int8 tensor-core GEMM with
an int32 result on the card. Its CUDA shape rules (``int_mm_shape``) are met
by zero rows and columns added after the scales are taken, which leave an
int32 sum unchanged, and the result is sliced back; the CPU runs the same
padded call. A shape it still refuses raises: nothing falls back to a float
product.

``quantized(model, weight_cache)`` is the JAX ``quantized_apply``: within it
every dense layer of ``model`` runs the int8 path (its ``forward`` replaced
on the instance, restored on exit). ``build_weight_cache(model)`` quantizes
the weights once, keyed by each layer's flax path (the weight bridge's
``_path_mapper``), so its keys are the JAX cache's; a cache that lacks a
layer raises ``KeyError`` and one whose entry has another shape
``ValueError``, as the JAX interceptor does.
"""

from __future__ import annotations

import contextlib
from functools import partial
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# torch._int_mm's CUDA rules: more than 16 rows, K and N multiples of 8
INT_MM_MIN_ROWS = 17
INT_MM_MULTIPLE = 8


def quantize_tensor(x: torch.Tensor, axis: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization: ``(q, scale)`` with x ≈ q·scale; the
    scale per tensor (``axis=None``, a 0-d tensor) or per slice along
    ``axis`` (kept broadcastable). The scale is divided on ``x``'s device as
    a tensor: a CUDA division by a host scalar multiplies by its reciprocal,
    which may move the last bit."""
    xf = x.float()
    if axis is None:
        amax = xf.abs().amax()
    else:
        amax = xf.abs().amax(dim=tuple(i for i in range(x.ndim) if i != axis), keepdim=True)
    scale = torch.clamp_min(amax, 1e-12) / torch.tensor(127.0, device=x.device)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def int_mm_shape(m: int, k: int, n: int) -> Tuple[int, int, int]:
    """The padded (M, K, N) of an [M, K] @ [K, N] product that ``torch._int_mm``
    takes on the card. A traced M (``torch.export`` with a dynamic batch)
    takes 16 zero rows more, which meets the rule at every batch the program
    may be called with, where a maximum would guard on the traced batch."""
    up = lambda v: -(-v // INT_MM_MULTIPLE) * INT_MM_MULTIPLE  # noqa: E731
    if isinstance(m, torch.SymInt):
        return m + INT_MM_MIN_ROWS - 1, up(k), up(n)
    return max(m, INT_MM_MIN_ROWS), up(k), up(n)


class Int8Weight(NamedTuple):
    """A dense layer's quantized weight: ``q`` the int8 codes [N, K] (the JAX
    kernel's codes, transposed), ``scale`` f32 [N], and ``padded`` the same
    codes zero-padded to ``int_mm_shape``'s [Np, Kp] (``q`` is a view into
    it; an exported program holds ``padded`` whole as its constant)."""

    q: torch.Tensor
    scale: torch.Tensor
    padded: torch.Tensor

    @property
    def mm(self) -> torch.Tensor:
        """The [Kp, Np] column-major operand of ``torch._int_mm``."""
        return self.padded.t()


def quantize_weight(weight: torch.Tensor) -> Int8Weight:
    """Per-output-channel codes of a [N, K] weight (a [N, K, 1, 1] dense
    convolution's taken as [N, K])."""
    w = weight.detach().reshape(weight.shape[0], -1)
    n, k = w.shape
    q, scale = quantize_tensor(w, axis=0)
    _, kp, np_ = int_mm_shape(INT_MM_MIN_ROWS, k, n)
    padded = F.pad(q, (0, kp - k, 0, np_ - n))  # zeros after the scales are taken
    return Int8Weight(padded[:n, :k], scale.reshape(n), padded)


def int8_matmul(xq: torch.Tensor, w: Int8Weight) -> torch.Tensor:
    """int8 [M, K] @ the layer's codes → exact int32 [M, N] through
    ``torch._int_mm`` on the padded shapes."""
    m, k = xq.shape
    n = w.q.shape[0]
    mp, kp, _ = int_mm_shape(m, k, n)
    if (mp, kp) != (m, k):
        xq = F.pad(xq, (0, kp - k, 0, mp - m))
    return torch._int_mm(xq.contiguous(), w.mm)[:m, :n]


def int8_dense_prequant(x: torch.Tensor, w: Int8Weight, bias: Optional[torch.Tensor],
                        out_dtype: torch.dtype) -> torch.Tensor:
    """x [..., K] @ prequantized codes with a dynamic per-tensor activation
    scale and the f32 dequant: ``acc·(sx·sw) + bias`` → ``out_dtype``."""
    lead = x.shape[:-1]
    xq, sx = quantize_tensor(x.reshape(-1, x.shape[-1]))
    y = int8_matmul(xq, w).float() * (sx * w.scale)
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype).reshape(*lead, w.q.shape[0])


def int8_dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
               out_dtype: torch.dtype) -> torch.Tensor:
    """x [..., K] @ weight [N, K]ᵀ in int8, quantizing the weight in the call."""
    return int8_dense_prequant(x, quantize_weight(weight), bias, out_dtype)


def is_dense(module: nn.Module) -> bool:
    """A layer the JAX package builds as a 2-D ``nn.Dense``: a ``Linear``, or
    a ``Conv2d`` marked ``dense`` (a 1×1 convolution on a pooled map)."""
    from visiondk_tpu_torch.models.layers import Conv2d, Linear

    return isinstance(module, Linear) or (isinstance(module, Conv2d) and module.dense)


def dense_layers(model: nn.Module) -> List[Tuple[str, nn.Module]]:
    """(flax path, module) of every dense layer of ``model``, in module order."""
    from visiondk_tpu_torch.models.convert import _path_mapper

    flax_path = _path_mapper(model)
    return [(flax_path(name), m) for name, m in model.named_modules() if is_dense(m)]


def build_weight_cache(model: nn.Module) -> Dict[str, Int8Weight]:
    """Quantize every dense layer's weight once, keyed by its flax path. Build
    it from the module the step serves (``state.ema_model`` under ``--ema``);
    training-time evaluation passes no cache (the weights move every epoch)."""
    return {path: quantize_weight(m.weight) for path, m in dense_layers(model)}


def _cached(module: nn.Module, path: str, weight_cache: Optional[Dict[str, Int8Weight]]) -> Int8Weight:
    if weight_cache is None:
        return quantize_weight(module.weight)
    # a provided cache is a contract: a missing key or another shape means it
    # was built from another model or tree
    entry = weight_cache.get(path)
    if entry is None:
        raise KeyError(f"int8 weight cache has no entry for dense layer {path!r}; build_weight_cache must run "
                       "over the module the step serves (ema_model under --ema)")
    want = (module.weight.shape[0], module.weight[0].numel())
    if tuple(entry.q.shape) != want:
        raise ValueError(f"int8 weight cache entry {path!r} has shape {tuple(entry.q.shape)}, the layer's weight "
                         f"is {want}: cache built from another model")
    return entry


def _int8_forward(module: nn.Module, path: str, weight_cache, x: torch.Tensor) -> torch.Tensor:
    w = _cached(module, path, weight_cache)
    if x.ndim == 4 and isinstance(module, nn.Conv2d):  # a dense conv on a pooled [B, C, 1, 1] map
        if x.shape[2:] != (1, 1):
            raise ValueError(f"dense conv {path!r} takes a pooled [B, C, 1, 1] map, got {tuple(x.shape)}")
        return int8_dense_prequant(x.flatten(1), w, module.bias, module.compute_dtype)[:, :, None, None]
    return int8_dense_prequant(x, w, module.bias, module.compute_dtype)


@contextlib.contextmanager
def quantized(model: nn.Module, weight_cache: Optional[Dict[str, Int8Weight]] = None,
              layers: Optional[List[Tuple[str, nn.Module]]] = None) -> Iterator[nn.Module]:
    """Within, every dense layer of ``model`` computes in int8 (the JAX
    ``quantized_apply``); ``weight_cache`` skips the per-call weight
    quantization. ``layers`` is ``dense_layers(model)`` where the caller
    keeps it."""
    layers = dense_layers(model) if layers is None else layers
    for path, m in layers:
        m.forward = partial(_int8_forward, m, path, weight_cache)
    try:
        yield model
    finally:
        for _, m in layers:
            m.__dict__.pop("forward", None)


VALID = (None, "int8")


def check_quant(quant: Optional[str]) -> Optional[str]:
    if quant in ("", "none", "None"):
        quant = None
    if quant not in VALID:
        raise ValueError(f"inference quant must be one of {VALID}, got {quant!r}")
    return quant
