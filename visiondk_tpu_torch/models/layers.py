"""Common building blocks (counterpart of ``visiondk_tpu/models/layers.py``).

Dtype policy, as in the JAX package: parameters live in f32 and every layer
computes in its configured ``dtype`` (bf16 for serving), casting its weights
at the call. LayerNorm takes its statistics in f32, as flax's does. Public
image inputs stay NHWC.

Parameters are initialised as the JAX package initialises them (flax's
``lecun_normal`` kernels with zero biases, unit/zero norms) by
``init_params``, from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from visiondk_tpu_torch.ops.attention import fused_qkv_attention, fused_qkv_attention_plain

# flax's truncated_normal(stddev=1) is cut at ±2 and rescaled by this factor
# (the stddev of a unit normal truncated to [-2, 2])
_TRUNC_STD = 0.87962566103423978


class Linear(nn.Linear):
    """``nn.Linear`` that computes in ``dtype`` with f32 parameters (flax ``Dense``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.LayerNorm):
    """flax ``LayerNorm``: eps 1e-6 (torch's default is 1e-5), statistics and
    affine in f32, output in ``dtype``."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


class DropPath(nn.Module):
    """Stochastic depth: drop a residual branch per sample (timm semantics:
    survivors scaled by 1/keep_prob). Identity in eval mode."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = torch.empty(shape, device=x.device).bernoulli_(keep).bool()
        return torch.where(mask, x / keep, torch.zeros_like(x))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Dtype-aware GELU: erf-exact in f32, tanh approximation in half precision
    (the JAX package's choice; the two differ below bf16 rounding)."""
    return F.gelu(x, approximate="none" if x.dtype == torch.float32 else "tanh")


class Mlp(nn.Module):
    """Transformer MLP: fc → act → drop → fc → drop."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: Optional[int] = None,
                 act: Callable = gelu, dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Linear(in_dim, hidden_dim, dtype=dtype)
        self.act = act
        self.drop1 = nn.Dropout(dropout)
        self.fc2 = Linear(hidden_dim, out_dim or in_dim, dtype=dtype)
        self.drop2 = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop2(self.fc2(self.drop1(self.act(self.fc1(x)))))


class Attention(nn.Module):
    """Multi-head self-attention over the QKV projection's [B, N, 3C] layout.

    With ``use_fused``, no active attention dropout and head_dim ≤ 128 it calls
    ``fused_qkv_attention``, which is differentiable on every device: in
    training its autograd Function runs the P-stash forward and a backward
    kernel (CUDA tensor) or their plain versions (CPU tensor). Otherwise it
    calls the plain forward, differentiated by autograd, which also applies
    the attention dropout. Keys ≥ ``n_valid`` are masked."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, dtype: torch.dtype = torch.float32,
                 use_fused: bool = True, n_valid: Optional[int] = None):
        super().__init__()
        self.num_heads = num_heads
        self.attn_drop = attn_drop
        self.use_fused = use_fused
        self.n_valid = n_valid
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)
        self.proj_drop = nn.Dropout(proj_drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[1], x.shape[2]
        n_valid = n if self.n_valid is None else self.n_valid
        qkv = self.qkv(x)
        dropout_active = self.attn_drop > 0.0 and self.training
        if self.use_fused and not dropout_active and c // self.num_heads <= 128:
            out = fused_qkv_attention(qkv, self.num_heads, n_valid)
        else:
            out = fused_qkv_attention_plain(
                qkv, self.num_heads, n_valid, dropout_p=self.attn_drop if dropout_active else 0.0
            )
        return self.proj_drop(self.proj(out))


class PatchEmbed(nn.Module):
    """NHWC RGB image → [B, (H/p)·(W/p), C] patch tokens via a strided conv
    (row-major patch order, as the JAX package's NHWC reshape)."""

    def __init__(self, patch_size: int, embed_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = x.to(dt).permute(0, 3, 1, 2)  # NHWC → NCHW view
        x = F.conv2d(x, self.proj.weight.to(dt), self.proj.bias.to(dt), stride=self.proj.stride)
        return x.flatten(2).transpose(1, 2)


class LayerScale(nn.Module):
    """timm LayerScale: per-channel gammas on a residual branch."""

    def __init__(self, dim: int, init_values: float):
        super().__init__()
        self.init_values = init_values
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.gamma.fill_(self.init_values)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal``: truncated normal with variance 1/fan_in, where
    fan_in is everything but the output dim ([out, in] or [O, I, kh, kw])."""
    std = (1.0 / weight[0].numel()) ** 0.5 / _TRUNC_STD
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every parameter and buffer of ``module`` as the JAX package
    does, drawing from ``generator`` in module order. The tensors must lie on
    the generator's device."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.modules.batchnorm._BatchNorm)):
            m.reset_parameters()  # unit scale, zero bias, zero mean / unit var stats
        elif hasattr(m, "init_weights"):
            m.init_weights(generator)
    return module
