"""Fused QKV attention (counterpart of ``visiondk_tpu/ops/pallas/attention.py``).

``fused_qkv_attention(qkv [B, N, 3C], heads, n_valid)`` → ``[B, N, C]`` reads
q, k and v out of the packed QKV-projection buffer and writes O straight
into ``[B, N, C]``: no ``[B, H, N, D]`` transposes. On a CUDA tensor it
launches the hand-written kernel ``csrc/fused_qkv_attention.cu`` (or
raises); on a CPU tensor it runs ``fused_qkv_attention_plain``, the same
math in PyTorch. Only the forward is ported: training's probability-stashing
forward and the two backward kernels come with the training slice.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from visiondk_tpu_torch.ops import _build

_NEG_INF = -1e30  # the reference's key mask value
_LOG2E = 1.4426950408889634
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL = "fused_qkv_attention"


def _head_dim(qkv: torch.Tensor, heads: int) -> int:
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be [B, N, 3C], got shape {tuple(qkv.shape)}")
    w = qkv.shape[-1]
    if heads < 1 or w % (3 * heads):
        raise ValueError(f"qkv width {w} is not 3 * heads * head_dim for heads={heads}")
    return w // (3 * heads)


def _check_n_valid(n: int, n_valid: Optional[int]) -> int:
    n_valid = n if n_valid is None else int(n_valid)
    if not 1 <= n_valid <= n:
        raise ValueError(f"n_valid must be in [1, {n}], got {n_valid}")
    return n_valid


def fused_qkv_attention_plain(
    qkv: torch.Tensor, heads: int, n_valid: Optional[int] = None, dropout_p: float = 0.0
) -> torch.Tensor:
    """The kernel's math in PyTorch, on any device, with the reference
    kernel's arithmetic (``attention.py:229-253``): log2-domain scores in f32
    with scale·log2(e) folded into q (q, k upcast), keys ≥ ``n_valid`` set to
    −1e30, P = exp2(S − rowmax) · (1 / rowsum) in f32, cast to the input dtype
    before P·V. ``dropout_p`` drops probabilities after that cast (the module's
    training path; the kernel has no dropout)."""
    d = _head_dim(qkv, heads)
    b, n, _ = qkv.shape
    n_valid = _check_n_valid(n, n_valid)
    c = heads * d
    q, k, v = qkv.reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)  # each [B, H, N, D]
    s = torch.matmul(q.float() * (d**-0.5 * _LOG2E), k.float().transpose(-1, -2))
    if n_valid < n:
        s[..., n_valid:] = _NEG_INF
    e = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    p = (e * (1.0 / e.sum(dim=-1, keepdim=True))).to(qkv.dtype)
    if dropout_p > 0.0:
        p = torch.nn.functional.dropout(p, dropout_p, training=True)
    o = torch.matmul(p, v)  # [B, H, N, D]
    return o.transpose(1, 2).reshape(b, n, c)


def _lib() -> ctypes.CDLL:
    lib = _build.build(_KERNEL).lib
    fn = lib.vdk_fused_qkv_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,  # qkv, out
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # b n heads d n_valid
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,  # q_mul, dtype, stream
        ]
        fn.restype = ctypes.c_int
        lib.vdk_cuda_error_string.argtypes = [ctypes.c_int]
        lib.vdk_cuda_error_string.restype = ctypes.c_char_p
    return lib


def fused_qkv_attention(
    qkv: torch.Tensor, heads: int, n_valid: Optional[int] = None
) -> torch.Tensor:
    """Attention straight from the QKV projection: [B, N, 3C] → [B, N, C].

    ``n_valid < N`` masks the trailing key columns; output rows ≥ ``n_valid``
    are finite values that callers never read. A CUDA tensor (float32 or
    bfloat16, contiguous, head_dim ≤ 128) launches the CUDA kernel, built at
    first use, and counts the launch in ``fused_qkv_attention.launches``; a
    CPU tensor runs ``fused_qkv_attention_plain``. Anything else raises.
    """
    d = _head_dim(qkv, heads)
    b, n, _ = qkv.shape
    n_valid = _check_n_valid(n, n_valid)
    if qkv.device.type == "cpu":
        return fused_qkv_attention_plain(qkv, heads, n_valid)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_qkv_attention runs on cuda or cpu tensors, got {qkv.device}")
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_qkv_attention kernel takes float32 or bfloat16, got {qkv.dtype}")
    if d > 128:
        raise ValueError(f"fused_qkv_attention kernel takes head_dim <= 128, got {d}")
    if not qkv.is_contiguous():
        raise ValueError("fused_qkv_attention kernel needs a contiguous qkv")
    if not 1 <= b <= 65535 or heads > 65535:
        raise ValueError(f"fused_qkv_attention kernel takes 1 <= B, heads <= 65535: B={b}, heads={heads}")
    out = torch.empty((b, n, heads * d), dtype=qkv.dtype, device=qkv.device)
    lib = _lib()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.vdk_fused_qkv_attention_fwd(
            qkv.data_ptr(), out.data_ptr(), b, n, heads, d, n_valid,
            d**-0.5 * _LOG2E, _DTYPE_CODES[qkv.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused_qkv_attention kernel launch failed: "
            f"{lib.vdk_cuda_error_string(err).decode()} (cuda error {err})"
        )
    fused_qkv_attention.launches += 1
    return out


fused_qkv_attention.launches = 0
