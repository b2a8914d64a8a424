"""Plain PyTorch pieces the reference models share: the precision of their
products, layers, the parameter spec and the weights made from a seed.

Every product (linear, convolution, the attention's QKᵀ and PV) goes through
a ``Precision``. ``"f32"`` is the reference itself: float32 on the CUDA cores,
TF32 off (``f32_products``). ``"fp8"`` is the control, the step below the
bf16 the configurations compute in: each operand of each product rounded to
float8 e4m3 with a per-tensor scale from its largest magnitude (as fp8
training scales its operands), the rounding passed straight through in the
backward.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


@contextlib.contextmanager
def f32_products():
    """float32 products in float32: TF32 off for matmuls and convolutions."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Precision:
    """Where the operands of a product are rounded: ``"f32"`` (not at all) or
    ``"fp8"`` (e4m3, per-tensor scale, straight-through gradient)."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "f32":
            return x
        held = x.detach()
        scale = held.abs().amax().clamp_min(1e-30) / E4M3_MAX
        rounded = (held / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
        return x + (rounded - held)

    def linear(self, x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
        return F.linear(self(x), self(w), b)

    def conv(self, x: torch.Tensor, w: torch.Tensor, b, stride: int) -> torch.Tensor:
        return F.conv2d(self(x), self(w), b, stride=stride)

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self(a), self(b))


def layer_norm(x: torch.Tensor, p: Dict[str, torch.Tensor], name: str, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], eps)


def linear(prec: Precision, x: torch.Tensor, p: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    return prec.linear(x, p[f"{name}.weight"], p.get(f"{name}.bias"))


def mlp(prec: Precision, x: torch.Tensor, p: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    """fc1 → exact (erf) GELU → fc2."""
    return linear(prec, F.gelu(linear(prec, x, p, f"{name}.fc1")), p, f"{name}.fc2")


def drop_path(x: torch.Tensor, keep_mask, rate: float) -> torch.Tensor:
    """A residual branch per sample: dropped, or scaled by 1 / (1 − rate)."""
    if keep_mask is None:
        return x
    return torch.where(keep_mask, x / (1.0 - rate), torch.zeros_like(x))


def normalize_images(images: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 NHWC → f32 NHWC, (x / 255 − mean) / std."""
    x = images.to(torch.float32) / 255.0
    return (x - torch.tensor(mean, device=x.device)) / torch.tensor(std, device=x.device)


# ------------------------------------------------------------------ spec and weights

# how a leaf is drawn from one N(0, 1) sample z
INITS = ("fan_in", "small", "scale", "unit")


def leaf(shape, init: str) -> Tuple[Tuple[int, ...], str]:
    if init not in INITS:
        raise ValueError(f"unknown init {init!r}")
    return tuple(int(s) for s in shape), init


def dense_spec(spec: Dict, name: str, fan_in: int, fan_out: int, bias: bool = True) -> None:
    spec[f"{name}.weight"] = leaf((fan_out, fan_in), "fan_in")
    if bias:
        spec[f"{name}.bias"] = leaf((fan_out,), "small")


def norm_spec(spec: Dict, name: str, dim: int) -> None:
    spec[f"{name}.weight"] = leaf((dim,), "scale")
    spec[f"{name}.bias"] = leaf((dim,), "small")


def make_weights(spec: Dict[str, Tuple[Tuple[int, ...], str]], seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of ``spec`` from ``seed``: one N(0, 1) draw on ``device``
    for all of them, cut into leaves in the spec's order and scaled by each
    leaf's init: ``fan_in`` z/√fan_in, ``small`` 0.02·z, ``scale`` 1 + 0.02·z,
    ``unit`` z. The same seed gives the same weights on the same device."""
    sizes = [math.prod(shape) for shape, _ in spec.values()]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {}
    offset = 0
    for (name, (shape, init)), size in zip(spec.items(), sizes):
        z = flat[offset:offset + size].view(shape)
        offset += size
        if init == "fan_in":
            z = z * (1.0 / math.sqrt(math.prod(shape[1:])))
        elif init == "small":
            z = z * 0.02
        elif init == "scale":
            z = 1.0 + 0.02 * z
        out[name] = z.clone()
    return out


def split_rows(n: int, block: int) -> List[slice]:
    return [slice(i, min(i + block, n)) for i in range(0, n, block)]
