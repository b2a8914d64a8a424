"""Common building blocks (counterpart of ``visiondk_tpu/models/layers.py``).

Dtype policy, as in the JAX package: parameters live in f32 and every layer
computes in its configured ``dtype`` (bf16 for serving), casting its weights
at the call. LayerNorm and BatchNorm take their statistics in f32, as flax's
do. Public image inputs stay NHWC; the CNN layers (``Conv2d``, with TF
'SAME' padding on request, ``BatchNorm2d``, ``LayerNorm2d``,
``SqueezeExcite``, ``SEBlock``) take NCHW views in ``torch.channels_last``
memory format, which is the NHWC layout itself. ``hard_sigmoid``,
``hard_swish`` and ``make_divisible`` are the JAX package's MobileNetV3
helpers.

Parameters are initialised as the JAX package initialises them (flax's
``lecun_normal`` kernels with zero biases, unit/zero norms) by
``init_params``, from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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


def tf_same_padding(h: int, w: int, kernel: int, stride: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """TF 'SAME' per-side padding ((top, bottom), (left, right)) of a
    ``kernel``×``kernel`` conv at ``stride`` on an h×w map: the output is
    ⌈n / stride⌉ and an odd total puts the extra pixel bottom/right."""

    def side(n: int) -> Tuple[int, int]:
        out = -(-n // stride)
        total = max((out - 1) * stride + kernel - n, 0)
        return total // 2, total - total // 2

    return side(h), side(w)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in ``dtype`` with f32 parameters (flax
    ``Conv``): input and weight are cast at the call, the weight into
    ``channels_last`` so that cuDNN runs an NHWC convolution without layout
    transposes. With ``tf_same`` the padding is TF 'SAME'
    (``tf_same_padding``), computed at each call from the input's own H and
    W: the symmetric part is the convolution's padding, and only an odd
    pixel bottom/right is padded ahead of it (``F.pad`` keeps the
    ``channels_last`` layout). ``dense`` marks a 1×1 convolution on a pooled
    [B, C, 1, 1] map that the JAX package builds as ``nn.Dense``: int8
    serving quantizes it (``ops/quant.py``) and FullGrad leaves it out
    (``utils/cam.py``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, groups: int = 1, bias: bool = True, tf_same: bool = False,
                 dense: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=padding,
                         groups=groups, bias=bias)
        self.tf_same = tf_same
        self.dense = dense
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        weight = self.weight.to(dtype=dt, memory_format=torch.channels_last)
        bias = None if self.bias is None else self.bias.to(dt)
        padding = self.padding
        if self.tf_same:
            (top, bottom), (left, right) = tf_same_padding(x.shape[2], x.shape[3], self.kernel_size[0],
                                                           self.stride[0])
            if bottom > top or right > left:
                x = F.pad(x, (0, right - left, 0, bottom - top))
            padding = (top, left)
        return F.conv2d(x.to(dt), weight, bias, self.stride, padding, self.dilation, self.groups)


class LayerNorm(nn.LayerNorm):
    """flax ``LayerNorm``: eps 1e-6 (torch's default is 1e-5), statistics and
    affine in f32 (the parameters' dtype; float64 where the input or the
    model is float64), output in ``dtype``."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, self.weight.dtype))
        y = F.layer_norm(x, self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


def _synced(bn: nn.Module) -> bool:
    """Whether a train-mode BatchNorm takes the global batch's moments: in a
    process group of more than one rank, unless ``local_batch_moments`` is on."""
    return not bn.local_moments and dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def _global_batch_norm(bn: nn.Module, x: torch.Tensor, dims: Tuple[int, ...]) -> torch.Tensor:
    """SyncBN: normalise ``x`` (channels at dim 1) with the mean and biased
    variance of the global batch, E[x²] − E[x]² from sums over every rank
    (flax's ``use_fast_variance`` form, which batch-sharded flax BatchNorm
    computes over the whole mesh), reduced by an all-reduce whose backward
    sums the gradient over the ranks; the running statistics take the same
    moments. In at least f32, whatever ``x``'s dtype."""
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    count = x.numel() // x.shape[1] * dist.get_world_size()
    sums = dist_fn.all_reduce(torch.cat([x.sum(dims), torch.square(x).sum(dims)]))
    mean, mean_sq = (sums / count).chunk(2)
    var = torch.clamp_min(mean_sq - torch.square(mean), 0.0)
    with torch.no_grad():
        bn.running_mean.lerp_(mean.to(bn.running_mean.dtype), bn.momentum)
        bn.running_var.lerp_(var.to(bn.running_var.dtype), bn.momentum)
        bn.num_batches_tracked.add_(1)
    shape = [1, -1] + [1] * (x.ndim - 2)
    scale = (torch.rsqrt(var + bn.eps) * bn.weight).reshape(shape)
    return (x - mean.reshape(shape)) * scale + bn.bias.reshape(shape)


@contextlib.contextmanager
def local_batch_moments(model: nn.Module):
    """Within, every BatchNorm of ``model`` takes its rank's own batch
    moments in train mode (the JAX step's ``shard_map`` body: SAM's
    per-rank pass)."""
    norms = [m for m in model.modules() if isinstance(m, (BatchNorm1d, BatchNorm2d))]
    for m in norms:
        m.local_moments = True
    try:
        yield
    finally:
        for m in norms:
            m.local_moments = False


class BatchNorm1d(nn.BatchNorm1d):
    """flax ``BatchNorm`` over [B, C]: in train mode it normalises with the
    batch's biased variance, as torch does, and also updates ``running_var``
    with that biased variance (torch's own uses the unbiased one, × n/(n−1)).
    ``momentum`` is torch's (flax momentum 0.9 ↔ 0.1); the state-dict keys are
    torch's, so the weight bridge maps it unchanged. In a process group of
    more than one rank the batch is the global one (``_global_batch_norm``)."""

    local_moments = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if _synced(self):
            return _global_batch_norm(self, x, (0,))
        with torch.no_grad():
            mean = x.mean(dim=0)
            var = x.var(dim=0, unbiased=False)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class BatchNorm2d(nn.BatchNorm2d):
    """flax ``BatchNorm`` over an NCHW map (statistics per channel over N, H
    and W), output in ``dtype``. In train mode it normalises with the batch's
    biased variance and updates ``running_var`` with that same biased
    variance, as flax does (torch's own takes the unbiased one for the
    update). The statistics are reduced in f32 whatever the input dtype;
    scale and bias stay f32 (flax promotes ``x − mean`` to f32 and rounds the
    result to ``dtype``). ``momentum`` is torch's (flax 0.9 ↔ 0.1). With
    ``bn_eval`` it always normalises with the running statistics and never
    updates them (the JAX ``use_running_average=(not train) or bn_eval``).
    In a process group of more than one rank the batch is the global one
    (``_global_batch_norm``)."""

    local_moments = False

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1,
                 bn_eval: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.bn_eval = bn_eval
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # normalised in the input's dtype (f32 arithmetic), rounded to ``dtype`` after, as flax
        if not self.training or self.bn_eval:
            y = F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)
            return y.to(self.compute_dtype)
        if _synced(self):
            return _global_batch_norm(self, x, (0, 2, 3)).to(self.compute_dtype)
        # momentum 1 writes the batch's mean and unbiased variance into the scratch buffers
        mean, var = torch.zeros_like(self.running_mean), torch.ones_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var * ((n - 1) / n), self.momentum)
            self.num_batches_tracked.add_(1)
        return y.to(self.compute_dtype)


class SqueezeExcite(nn.Module):
    """SE channel attention on an NCHW map: mean over H, W → Linear →
    ReLU → Linear → sigmoid in f32 → scale the map (the JAX
    ``SqueezeExcite``; ``fc1``/``fc2`` are its Dense layers)."""

    def __init__(self, channels: int, reduction: int = 16, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Linear(channels, max(channels // reduction, 8), dtype=dtype)
        self.fc2 = Linear(max(channels // reduction, 8), channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.fc2(F.relu(self.fc1(x.mean(dim=(2, 3)))))
        s = torch.sigmoid(s.float()).to(x.dtype)
        return x * s[:, :, None, None]


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """clip(x/6 + 0.5, 0, 1) in x's dtype, as the JAX package writes it
    (``F.hardsigmoid`` rounds differently)."""
    return torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * hard_sigmoid(x)


def make_divisible(v: float, divisor: int = 8) -> int:
    """The nearest multiple of ``divisor`` at or above ``divisor``, raised by
    one step when rounding lost more than 10% (timm's and the JAX package's
    ``_make_divisible``)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class SEBlock(nn.Module):
    """The JAX ``SEBlock`` on an NCHW map: mean over H, W → 1×1 conv to
    ``reduce_ch`` → ``act`` → 1×1 conv back → ``gate`` in f32 → scale the
    map. MobileNetV3 uses relu and ``hard_sigmoid``, EfficientNetV2 silu
    and sigmoid. The 1×1 convs (timm's ``conv_reduce``/``conv_expand``)
    compute on the pooled [B, C, 1, 1] map what the JAX Dense layers
    compute on [B, C]."""

    def __init__(self, channels: int, reduce_ch: int, act: Callable = F.relu,
                 gate: Callable = hard_sigmoid, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act, self.gate = act, gate
        self.conv_reduce = Conv2d(channels, reduce_ch, 1, dense=True, dtype=dtype)
        self.conv_expand = Conv2d(reduce_ch, channels, 1, dense=True, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.conv_expand(self.act(self.conv_reduce(x.mean(dim=(2, 3), keepdim=True))))
        return x * self.gate(s.float()).to(x.dtype)


class LayerNorm2d(LayerNorm):
    """``LayerNorm`` over the channels of an NCHW map in ``channels_last``
    memory (the NHWC layout, so the permutes are views)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NCHW map → [B, C], the mean in the map's dtype (f32 accumulation)."""
    return x.mean(dim=(2, 3))


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


def run_blocks(blocks, x: torch.Tensor, remat: bool) -> torch.Tensor:
    """``x`` through ``blocks`` in turn. With ``remat`` and grad enabled, each
    block runs under non-reentrant ``torch.utils.checkpoint`` (the JAX
    ``nn.remat`` of a block): its activations are dropped after the forward
    and recomputed in the backward, with the CPU and CUDA RNG states replayed
    so that dropout and DropPath draw the same masks again."""
    remat = remat and torch.is_grad_enabled()
    for block in blocks:
        x = checkpoint(block, x, use_reentrant=False, preserve_rng_state=True) if remat else block(x)
    return x


class AttentionPooling(nn.Module):
    """Learned-query attention pooling [B, N, C] → [B, C] (the JAX
    ``AttentionPooling``): a ``probe`` query [1, 1, C] against the
    LayerNorm'd tokens through separate ``q``/``k``/``v`` projections, scores
    in f32 (q scaled by hd^-0.5), softmax in f32 rounded to the compute
    dtype, then ·V and ``proj``. Plain ``torch.matmul``, as the JAX module's
    einsums, so it rounds where they round."""

    def __init__(self, dim: int, num_heads: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.compute_dtype = dtype
        self.probe = nn.Parameter(torch.zeros(1, 1, dim))
        self.norm = LayerNorm(dim, dtype=dtype)
        self.q = Linear(dim, dim, dtype=dtype)
        self.k = Linear(dim, dim, dtype=dtype)
        self.v = Linear(dim, dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.probe.normal_(0.0, 0.02, generator=generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        b, _, c = tokens.shape
        x = self.norm(tokens)
        q = self.q(self.probe.to(self.compute_dtype).expand(b, -1, -1))
        out = _latent_attention(q, self.k(x), self.v(x), self.num_heads)
        return self.proj(out)[:, 0]


class AttentionPoolLatent(nn.Module):
    """timm's ``AttentionPoolLatent``, SigLIP's ``pool="map"`` head (the JAX
    ``AttentionPoolLatent``): a learned ``latent`` query [1, 1, C] through
    ``q``, keys and values from the fused ``kv`` [C → 2C] of the tokens,
    scores in f32 (q scaled by hd^-0.5), softmax in f32 rounded to the
    compute dtype, ·V, ``proj``, then ``out + mlp(norm(out))``. Plain
    ``torch.matmul``, as the JAX module's einsums."""

    def __init__(self, dim: int, num_heads: int = 8, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.compute_dtype = dtype
        self.latent = nn.Parameter(torch.zeros(1, 1, dim))
        self.q = Linear(dim, dim, dtype=dtype)
        self.kv = Linear(dim, 2 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)
        self.norm = LayerNorm(dim, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.latent.normal_(0.0, self.latent.shape[-1] ** -0.5, generator=generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        b, n, c = tokens.shape
        q = self.q(self.latent.to(self.compute_dtype).expand(b, -1, -1))
        k, v = self.kv(tokens).reshape(b, n, 2, c).unbind(2)
        out = self.proj(_latent_attention(q, k, v, self.num_heads))
        out = out + self.mlp(self.norm(out))
        return out[:, 0]


def _latent_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """One query row against N tokens: q [B, 1, C], k and v [B, N, C] →
    [B, 1, C]. The scores (q·hd^-0.5)·kᵀ and their softmax in f32, P rounded
    to v's dtype before P·V (the JAX einsums' ``preferred_element_type``)."""
    b, n, c = k.shape
    d = c // heads
    qh = (q * d**-0.5).reshape(b, 1, heads, d).transpose(1, 2)
    kh = k.reshape(b, n, heads, d).transpose(1, 2)
    vh = v.reshape(b, n, heads, d).transpose(1, 2)
    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(p, vh).transpose(1, 2).reshape(b, 1, c)


class PatchEmbed(nn.Module):
    """NHWC RGB image → [B, (H/p)·(W/p), C] patch tokens via a strided conv
    (row-major patch order, as the JAX package's NHWC reshape). ``proj`` is
    called as a module, so a hook sees its 4-D map (FullGrad's bias layers)."""

    def __init__(self, patch_size: int, embed_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = Conv2d(3, embed_dim, patch_size, stride=patch_size, dtype=dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.proj(x.permute(0, 3, 1, 2))  # NHWC → NCHW view
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
