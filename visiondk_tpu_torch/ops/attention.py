"""Fused attention (counterpart of ``visiondk_tpu/ops/pallas/attention.py``):
``fused_qkv_attention`` on the packed QKV buffer and ``vision_attention`` on
``[B, H, N, D]`` operands.

``fused_qkv_attention(qkv [B, N, 3C], heads, n_valid)`` → ``[B, N, C]`` reads
q, k and v out of the packed QKV-projection buffer and writes O straight
into ``[B, N, C]``: no ``[B, H, N, D]`` transposes. It is differentiable,
as the JAX op is (``jax.custom_vjp``, ``attention.py:514``): with grad mode
on and ``qkv.requires_grad`` it runs the autograd Function
``FusedQKVAttention``, whose forward stashes the probabilities P for the
backward, or, with ``VDK_ATTN_NO_PCACHE=1`` (read at each call, as the JAX
package's ``_p_cache_enabled`` reads it), saves only qkv and recomputes P in
the backward. Without grad it runs the no-stash forward.

Four kernels, each behind a wrapper with its own launch count
(``<wrapper>.launches``, counted only where the kernel is launched):

- ``fused_qkv_attention_fwd``: no-stash forward (``csrc/fused_qkv_attention.cu``), the registered
  operator ``torch.ops.vdk.fused_qkv_attention`` (one node of a ``torch.export`` program);
- ``fused_qkv_attention_fwd_stash``: the same kernel, also writing P;
- ``fused_qkv_attention_bwd_from_p``: backward from the stashed P
  (``csrc/fused_qkv_attention_bwd.cu``);
- ``fused_qkv_attention_bwd_recompute``: backward that recomputes P in f32.

``vision_attention(q, k, v)`` (``[B, H, N, D]`` → ``[B, H, N, D]``, the JAX
op at ``attention.py:533``) runs the same CUDA kernels through other entry
points: q, k and v are read through their strides (a strided view of a
packed buffer costs no copy) and the outputs are contiguous. Two more
wrappers: ``vision_attention_fwd`` (no stash) and ``vision_attention_bwd``
(recompute backward: dq, dk, dv), behind the autograd Function
``VisionAttention``, as ``_vision_attention_padded``'s custom VJP saves q,
k, v and recomputes P. The JAX wrapper pads N up to a multiple of 128 and
masks the padded keys; the port computes exactly N, the same result.

On a CUDA tensor a wrapper launches its kernel (or raises); on a CPU tensor
it runs the kernel's plain PyTorch version (``*_plain``), which has the
reference kernel's arithmetic. In bfloat16 the kernels run every product on
the tensor cores (bf16 operands, f32 sums); the backwards split dS and the
recomputed P into bf16 hi + lo operands so that they keep about 16 bits (see
the notes in ``csrc/``). In float32 they run on CUDA cores. So the Functions run the same hand-derived
backwards on both devices. The plain versions compute in f32, or in f64 for
f64 inputs (which ``torch.autograd.gradcheck`` uses on the CPU).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from visiondk_tpu_torch.ops import _build

_NEG_INF = -1e30  # the reference's key mask value
_LOG2E = 1.4426950408889634
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FWD_LIB = "fused_qkv_attention"
_BWD_LIB = "fused_qkv_attention_bwd"


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


def _p_cache_enabled() -> bool:
    """Stash the forward's probabilities for the backward (the JAX package's
    switch, ``attention.py:427``): off with ``VDK_ATTN_NO_PCACHE=1``."""
    return os.environ.get("VDK_ATTN_NO_PCACHE", "0") != "1"


# ---------------------------------------------------------------- plain versions


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _split_heads(qkv: torch.Tensor, heads: int):
    b, n, w = qkv.shape
    return qkv.reshape(b, n, 3, heads, w // (3 * heads)).permute(2, 0, 3, 1, 4)  # q, k, v [B, H, N, D]


def _probs(q2: torch.Tensor, k: torch.Tensor, n_valid: int) -> torch.Tensor:
    """P = exp2(S − rowmax) · (1 / rowsum) of the log2-domain scores S = q2·kᵀ,
    keys ≥ ``n_valid`` at −1e30 (``attention.py:229-253``), unrounded."""
    s = torch.matmul(q2, k.transpose(-1, -2))
    if n_valid < s.shape[-1]:
        s[..., n_valid:] = _NEG_INF
    e = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    return e * (1.0 / e.sum(dim=-1, keepdim=True))


def _forward_plain(qkv: torch.Tensor, heads: int, n_valid: Optional[int], dropout_p: float = 0.0):
    d = _head_dim(qkv, heads)
    b, n, _ = qkv.shape
    n_valid = _check_n_valid(n, n_valid)
    acc = _acc(qkv.dtype)
    q, k, v = _split_heads(qkv, heads)
    p = _probs(q.to(acc) * (d**-0.5 * _LOG2E), k.to(acc), n_valid).to(qkv.dtype)
    p_used = torch.nn.functional.dropout(p, dropout_p, training=True) if dropout_p > 0.0 else p
    o = torch.matmul(p_used, v)  # [B, H, N, D]
    return o.transpose(1, 2).reshape(b, n, heads * d), p


def fused_qkv_attention_plain(
    qkv: torch.Tensor, heads: int, n_valid: Optional[int] = None, dropout_p: float = 0.0
) -> torch.Tensor:
    """The no-stash forward in PyTorch, on any device, with the reference
    kernel's arithmetic (``attention.py:229-253``): log2-domain scores in f32
    with scale·log2(e) folded into q (q, k upcast), keys ≥ ``n_valid`` set to
    −1e30, P = exp2(S − rowmax) · (1 / rowsum) in f32, cast to the input dtype
    before P·V. ``dropout_p`` drops probabilities after that cast (the module's
    training path; the kernel has no dropout). Differentiable by autograd."""
    return _forward_plain(qkv, heads, n_valid, dropout_p)[0]


def fused_qkv_attention_fwd_stash_plain(
    qkv: torch.Tensor, heads: int, n_valid: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, P): ``fused_qkv_attention_plain`` and the probabilities it
    multiplied V with, [B, H, N, N] in the input dtype (0 at masked keys)."""
    return _forward_plain(qkv, heads, n_valid)


def _grads_to_qkv(dq, dk, dv, dtype: torch.dtype) -> torch.Tensor:
    b, h, n, d = dq.shape
    return torch.stack((dq, dk, dv)).permute(1, 3, 0, 2, 4).reshape(b, n, 3 * h * d).to(dtype)


def _bwd_core(p, dout, v, k_dq, q_dk):
    """dV = Pᵀ·dO, dP = dO·Vᵀ, δ = rowsum(P∘dP), dS = P∘(dP − δ),
    dQ = dS·k_dq, dK = dSᵀ·q_dk (``attention.py:301-315, 349-364``)."""
    dv = torch.matmul(p.transpose(-1, -2), dout)
    dp = torch.matmul(dout, v.transpose(-1, -2))
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    return torch.matmul(ds, k_dq), torch.matmul(ds.transpose(-1, -2), q_dk), dv


def fused_qkv_attention_bwd_from_p_plain(
    qkv: torch.Tensor, p: torch.Tensor, dout: torch.Tensor, heads: int
) -> torch.Tensor:
    """dqkv [B, N, 3C] from the stashed P, as ``_fused_bwd_from_p_kernel``
    (``attention.py:323-369``): every operand upcast to f32, the key mask
    implicit in P, dQ = dS·(k·scale), dK = dSᵀ·(q·scale)."""
    d = _head_dim(qkv, heads)
    b, n, _ = qkv.shape
    acc = _acc(qkv.dtype)
    scale = d**-0.5
    q, k, v = (t.to(acc) for t in _split_heads(qkv, heads))
    do = dout.reshape(b, n, heads, d).transpose(1, 2).to(acc)
    dq, dk, dv = _bwd_core(p.to(acc), do, v, k * scale, q * scale)
    return _grads_to_qkv(dq, dk, dv, qkv.dtype)


def fused_qkv_attention_bwd_recompute_plain(
    qkv: torch.Tensor, dout: torch.Tensor, heads: int, n_valid: Optional[int] = None
) -> torch.Tensor:
    """dqkv [B, N, 3C] with P recomputed, as ``_fused_bwd_kernel``
    (``attention.py:263-320``): P in f32 and not rounded, dQ = dS·(k·scale),
    dK = (dSᵀ·q2) / log2(e) with q2 = q·scale·log2(e)."""
    d = _head_dim(qkv, heads)
    b, n, _ = qkv.shape
    n_valid = _check_n_valid(n, n_valid)
    acc = _acc(qkv.dtype)
    scale = d**-0.5
    q, k, v = (t.to(acc) for t in _split_heads(qkv, heads))
    do = dout.reshape(b, n, heads, d).transpose(1, 2).to(acc)
    q2 = q * (scale * _LOG2E)
    dq, dk, dv = _bwd_core(_probs(q2, k, n_valid), do, v, k * scale, q2)
    return _grads_to_qkv(dq, dk * (1.0 / _LOG2E), dv, qkv.dtype)


# ---------------------------------------------------------------- kernel wrappers


def _runs_kernel(qkv: torch.Tensor, heads: int, op: str) -> bool:
    """True for a CUDA tensor the kernels take, False for a CPU tensor (the
    plain version runs); raises for anything else."""
    if qkv.device.type == "cpu":
        return False
    if qkv.device.type != "cuda":
        raise ValueError(f"{op} runs on cuda or cpu tensors, got {qkv.device}")
    d = qkv.shape[-1] // (3 * heads)
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"{op} kernel takes float32 or bfloat16, got {qkv.dtype}")
    if d > 128:
        raise ValueError(f"{op} kernel takes head_dim <= 128, got {d}")
    if not qkv.is_contiguous():
        raise ValueError(f"{op} kernel needs a contiguous qkv")
    check_grid_rows(qkv.shape[0], heads, op)
    return True


def check_grid_rows(b, heads: int, op: str) -> None:
    """1 ≤ B ≤ 65535 and heads ≤ 65535 (the launch grid's y and z), as a
    ``torch._check``: a traced batch (``torch.export``) takes the bound as a
    runtime assertion and a range of the exported ``Dim`` instead of a guard."""
    for ok in (b >= 1, b <= 65535, heads <= 65535):
        torch._check_with(ValueError, ok, lambda: f"{op} kernel takes 1 <= B, heads <= 65535: B={b}, heads={heads}")


def _check_operand(t: torch.Tensor, like: torch.Tensor, shape, what: str) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype != like.dtype or t.device != like.device:
        raise TypeError(f"{what} must be {like.dtype} on {like.device}, got {t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _lib(name: str, fn_name: str, argtypes) -> ctypes.CDLL:
    lib = _build.build(name).lib
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.vdk_cuda_error_string.argtypes = [ctypes.c_int]
        lib.vdk_cuda_error_string.restype = ctypes.c_char_p
    return lib


_I, _F, _P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
_FWD_ARGS = [_P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P]  # qkv out p | b n heads d n_valid | q_mul dtype stream
_BWD_ARGS = [_P, _P, _P, _P, _P, _P, _P,  # qkv p dout dqkv delta row_m row_il
             _I, _I, _I, _I, _I, _F, _F, _F, _I, _P]  # b n heads d n_valid | q_mul scale inv_log2e | dtype stream
_L = ctypes.c_int64
_STRIDED = [_P, _L, _L, _L]  # pointer, then the element strides of batch row, head and token
_VIS_FWD_ARGS = [*_STRIDED * 3, _P, _I, _I, _I, _I, _F, _I, _P]  # q k v | out b n heads d q_mul dtype stream
_VIS_BWD_ARGS = [*_STRIDED * 4, _P, _P, _P, _P, _P, _P,  # q k v dout | dq dk dv delta row_m row_il
                 _I, _I, _I, _I, _F, _F, _F, _I, _P]  # b n heads d | q_mul scale inv_log2e | dtype stream


def _check_err(lib: ctypes.CDLL, err: int, op: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{op} kernel launch failed: {lib.vdk_cuda_error_string(err).decode()} (cuda error {err})"
        )


def _launch_fwd(qkv: torch.Tensor, heads: int, n_valid: int, stash: bool):
    b, n, w = qkv.shape
    d = w // (3 * heads)
    out = torch.empty((b, n, heads * d), dtype=qkv.dtype, device=qkv.device)
    p = torch.empty((b, heads, n, n), dtype=qkv.dtype, device=qkv.device) if stash else None
    lib = _lib(_FWD_LIB, "vdk_fused_qkv_attention_fwd", _FWD_ARGS)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.vdk_fused_qkv_attention_fwd(
            qkv.data_ptr(), out.data_ptr(), None if p is None else p.data_ptr(),
            b, n, heads, d, n_valid, d**-0.5 * _LOG2E, _DTYPE_CODES[qkv.dtype], stream,
        )
    _check_err(lib, err, "fused_qkv_attention forward")
    return out, p


def _launch_bwd(qkv: torch.Tensor, p: Optional[torch.Tensor], dout: torch.Tensor, heads: int,
                n_valid: int) -> torch.Tensor:
    b, n, w = qkv.shape
    d = w // (3 * heads)
    dqkv = torch.empty_like(qkv)
    stats = torch.empty((3 if p is None else 1, b, heads, n), dtype=torch.float32, device=qkv.device)
    delta = stats[0]
    row_m, row_il = (stats[1].data_ptr(), stats[2].data_ptr()) if p is None else (None, None)
    lib = _lib(_BWD_LIB, "vdk_fused_qkv_attention_bwd", _BWD_ARGS)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.vdk_fused_qkv_attention_bwd(
            qkv.data_ptr(), None if p is None else p.data_ptr(), dout.data_ptr(), dqkv.data_ptr(),
            delta.data_ptr(), row_m, row_il, b, n, heads, d, n_valid,
            d**-0.5 * _LOG2E, d**-0.5, 1.0 / _LOG2E, _DTYPE_CODES[qkv.dtype], stream,
        )
    _check_err(lib, err, "fused_qkv_attention backward")
    return dqkv


def fused_qkv_attention_fwd(
    qkv: torch.Tensor, heads: int, n_valid: Optional[int] = None
) -> torch.Tensor:
    """No-stash forward: [B, N, 3C] → [B, N, C]. ``n_valid < N`` masks the
    trailing key columns; output rows ≥ ``n_valid`` are finite values that
    callers never read. A CUDA tensor (float32 or bfloat16, contiguous,
    head_dim ≤ 128) launches the kernel, built at first use; a CPU tensor runs
    ``fused_qkv_attention_plain``. Anything else raises. Both go through the
    registered operator ``torch.ops.vdk.fused_qkv_attention``, which
    ``torch.export`` records as one node."""
    _head_dim(qkv, heads)
    n_valid = _check_n_valid(qkv.shape[1], n_valid)
    return torch.ops.vdk.fused_qkv_attention(qkv, heads, n_valid)


@torch.library.custom_op("vdk::fused_qkv_attention", mutates_args=())
def _fused_qkv_attention_op(qkv: torch.Tensor, heads: int, n_valid: int) -> torch.Tensor:
    if not _runs_kernel(qkv, heads, "fused_qkv_attention_fwd"):
        return fused_qkv_attention_plain(qkv, heads, n_valid)
    out, _ = _launch_fwd(qkv, heads, n_valid, stash=False)
    fused_qkv_attention_fwd.launches += 1
    return out


@_fused_qkv_attention_op.register_fake
def _(qkv: torch.Tensor, heads: int, n_valid: int) -> torch.Tensor:
    _runs_kernel(qkv, heads, "fused_qkv_attention_fwd")  # raises at trace time what the kernel would
    b, n, w = qkv.shape
    return qkv.new_empty((b, n, w // 3))


def fused_qkv_attention_fwd_stash(
    qkv: torch.Tensor, heads: int, n_valid: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward: (O [B, N, C], P [B, H, N, N]) in the input dtype. O
    is bit-for-bit ``fused_qkv_attention_fwd``'s; P is the rounded value that
    multiplied V, 0 at masked keys. Same devices and checks."""
    _head_dim(qkv, heads)
    n_valid = _check_n_valid(qkv.shape[1], n_valid)
    if not _runs_kernel(qkv, heads, "fused_qkv_attention_fwd_stash"):
        return fused_qkv_attention_fwd_stash_plain(qkv, heads, n_valid)
    out, p = _launch_fwd(qkv, heads, n_valid, stash=True)
    fused_qkv_attention_fwd_stash.launches += 1
    return out, p


def fused_qkv_attention_bwd_from_p(
    qkv: torch.Tensor, p: torch.Tensor, dout: torch.Tensor, heads: int
) -> torch.Tensor:
    """dqkv [B, N, 3C] from qkv, the forward's stash P [B, H, N, N] and dO
    [B, N, C], all of qkv's dtype and contiguous. Same devices and checks."""
    d = _head_dim(qkv, heads)
    b, n, _ = qkv.shape
    _check_operand(p, qkv, (b, heads, n, n), "P")
    _check_operand(dout, qkv, (b, n, heads * d), "dO")
    if not _runs_kernel(qkv, heads, "fused_qkv_attention_bwd_from_p"):
        return fused_qkv_attention_bwd_from_p_plain(qkv, p, dout, heads)
    dqkv = _launch_bwd(qkv, p, dout, heads, n)
    fused_qkv_attention_bwd_from_p.launches += 1
    return dqkv


def fused_qkv_attention_bwd_recompute(
    qkv: torch.Tensor, dout: torch.Tensor, heads: int, n_valid: Optional[int] = None
) -> torch.Tensor:
    """dqkv [B, N, 3C] from qkv and dO [B, N, C], with P recomputed in f32.
    Same devices and checks."""
    d = _head_dim(qkv, heads)
    b, n, _ = qkv.shape
    n_valid = _check_n_valid(n, n_valid)
    _check_operand(dout, qkv, (b, n, heads * d), "dO")
    if not _runs_kernel(qkv, heads, "fused_qkv_attention_bwd_recompute"):
        return fused_qkv_attention_bwd_recompute_plain(qkv, dout, heads, n_valid)
    dqkv = _launch_bwd(qkv, None, dout, heads, n_valid)
    fused_qkv_attention_bwd_recompute.launches += 1
    return dqkv


# ---------------------------------------------------------------- vision_attention


def _check_bhnd(op: str, q: torch.Tensor, **others: torch.Tensor) -> None:
    """q is [B, H, N, D]; every other operand has q's shape, dtype and device."""
    if q.dim() != 4:
        raise ValueError(f"{op} takes [B, H, N, D] operands, got q of shape {tuple(q.shape)}")
    for what, t in others.items():
        if t.shape != q.shape:
            raise ValueError(f"{op}: {what} has shape {tuple(t.shape)}, q {tuple(q.shape)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{op}: {what} is {t.dtype} on {t.device}, q {q.dtype} on {q.device}")


def _runs_vision_kernel(tensors, op: str) -> bool:
    """True for CUDA tensors the kernels take, False for CPU tensors (the
    plain version runs); raises for anything else. ``tensors`` agree in
    shape, dtype and device (``_check_bhnd``)."""
    q = tensors[0]
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{op} runs on cuda or cpu tensors, got {q.device}")
    b, h, _, d = q.shape
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{op} kernel takes float32 or bfloat16, got {q.dtype}")
    if d > 128:
        raise ValueError(f"{op} kernel takes head_dim <= 128, got {d}")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError(f"{op} kernel needs a unit-stride head dim, got strides {[t.stride() for t in tensors]}")
    check_grid_rows(b, h, op)
    return True


def vision_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q·kᵀ·D^-½)·v for [B, H, N, D] operands, with the reference
    kernel's arithmetic (``_fwd_kernel``, ``attention.py:41-65``): scores of
    the upcast q and k, scaled, P = exp(S − rowmax) / rowsum, cast to v's
    dtype before P·V, which sums in f32 (f64 for f64 inputs) and rounds to
    q's dtype."""
    acc = _acc(q.dtype)
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * q.shape[-1] ** -0.5
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (e / e.sum(dim=-1, keepdim=True)).to(v.dtype)
    return torch.matmul(p.to(acc), v.to(acc)).to(q.dtype)


def vision_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) with P recomputed, as ``_bwd_kernel`` (``attention.py:68-92``):
    every operand upcast, P in f32 (f64 for f64 inputs) and not rounded,
    dV = Pᵀ·dO, dP = dO·Vᵀ, dS = P∘(dP − rowsum(P∘dP))·scale, dQ = dS·k,
    dK = dSᵀ·q, each rounded to q's dtype."""
    dtype, acc = q.dtype, _acc(q.dtype)
    scale = q.shape[-1] ** -0.5
    q, k, v, do = (t.to(acc) for t in (q, k, v, dout))
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    dq, dk, dv = _bwd_core(e / e.sum(dim=-1, keepdim=True), do, v, k * scale, q * scale)
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def _strided(t: torch.Tensor):
    return (t.data_ptr(), t.stride(0), t.stride(1), t.stride(2))


def _launch_vision_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    b, h, n, d = q.shape
    out = torch.empty((b, h, n, d), dtype=q.dtype, device=q.device)
    lib = _lib(_FWD_LIB, "vdk_vision_attention_fwd", _VIS_FWD_ARGS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.vdk_vision_attention_fwd(
            *_strided(q), *_strided(k), *_strided(v), out.data_ptr(),
            b, n, h, d, d**-0.5 * _LOG2E, _DTYPE_CODES[q.dtype], stream,
        )
    _check_err(lib, err, "vision_attention forward")
    return out


def _launch_vision_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor):
    b, h, n, d = q.shape
    grads = torch.empty((3, b, h, n, d), dtype=q.dtype, device=q.device)
    stats = torch.empty((3, b, h, n), dtype=torch.float32, device=q.device)  # delta, row max, 1 / row sum
    lib = _lib(_BWD_LIB, "vdk_vision_attention_bwd", _VIS_BWD_ARGS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.vdk_vision_attention_bwd(
            *_strided(q), *_strided(k), *_strided(v), *_strided(dout),
            *(g.data_ptr() for g in grads), *(t.data_ptr() for t in stats),
            b, n, h, d, d**-0.5 * _LOG2E, d**-0.5, 1.0 / _LOG2E, _DTYPE_CODES[q.dtype], stream,
        )
    _check_err(lib, err, "vision_attention backward")
    return tuple(grads.unbind(0))


def vision_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """O [B, H, N, D] (contiguous) from q, k, v [B, H, N, D] of one shape,
    dtype and device. A CUDA tensor (float32 or bfloat16, D ≤ 128, unit
    stride in D, any other strides, B and H ≤ 65535) launches the kernel
    (``vdk_vision_attention_fwd``, K1's kernel), built at first use; a CPU
    tensor runs ``vision_attention_plain``. Anything else raises."""
    _check_bhnd("vision_attention_fwd", q, k=k, v=v)
    if not _runs_vision_kernel((q, k, v), "vision_attention_fwd"):
        return vision_attention_plain(q, k, v)
    out = _launch_vision_fwd(q, k, v)
    vision_attention_fwd.launches += 1
    return out


def vision_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv), each [B, H, N, D] contiguous in q's dtype, from q, k, v
    and dO [B, H, N, D] of one shape, dtype and device, P recomputed in f32
    (``vdk_vision_attention_bwd``, K1r's kernels). Same devices and checks
    as ``vision_attention_fwd``; dO too is read through its strides."""
    _check_bhnd("vision_attention_bwd", q, k=k, v=v, dout=dout)
    if not _runs_vision_kernel((q, k, v, dout), "vision_attention_bwd"):
        return vision_attention_bwd_plain(q, k, v, dout)
    grads = _launch_vision_bwd(q, k, v, dout)
    vision_attention_bwd.launches += 1
    return grads


KERNELS = (
    fused_qkv_attention_fwd,
    fused_qkv_attention_fwd_stash,
    fused_qkv_attention_bwd_from_p,
    fused_qkv_attention_bwd_recompute,
    vision_attention_fwd,
    vision_attention_bwd,
)
for _k in KERNELS:
    _k.launches = 0


# ---------------------------------------------------------------- the op


class FusedQKVAttention(torch.autograd.Function):
    """The counterpart of ``_fused_attention_padded.defvjp(_fused_vjp_fwd,
    _fused_vjp_bwd)``: forward with the P stash (or none, with
    ``VDK_ATTN_NO_PCACHE=1``), backward from P (or recomputing it). Its
    backward is not itself differentiable."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, heads: int, n_valid: int) -> torch.Tensor:
        if _p_cache_enabled():
            out, p = fused_qkv_attention_fwd_stash(qkv, heads, n_valid)
            ctx.save_for_backward(qkv, p)
        else:
            out = fused_qkv_attention_fwd(qkv, heads, n_valid)
            ctx.save_for_backward(qkv)
        ctx.heads, ctx.n_valid = heads, n_valid
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout: torch.Tensor):
        qkv, *stash = ctx.saved_tensors
        dout = dout.to(qkv.dtype).contiguous()  # F.linear's backward may hand over f32 or strided
        if stash:
            dqkv = fused_qkv_attention_bwd_from_p(qkv, stash[0], dout, ctx.heads)
        else:
            dqkv = fused_qkv_attention_bwd_recompute(qkv, dout, ctx.heads, ctx.n_valid)
        return dqkv, None, None


def fused_qkv_attention(
    qkv: torch.Tensor, heads: int, n_valid: Optional[int] = None
) -> torch.Tensor:
    """Attention straight from the QKV projection: [B, N, 3C] → [B, N, C],
    differentiable. With grad mode on and ``qkv.requires_grad`` it runs
    ``FusedQKVAttention``; otherwise ``fused_qkv_attention_fwd``. Kernels on a
    CUDA tensor, their plain versions on a CPU tensor (see module doc)."""
    _head_dim(qkv, heads)
    n_valid = _check_n_valid(qkv.shape[1], n_valid)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return FusedQKVAttention.apply(qkv, heads, n_valid)
    return fused_qkv_attention_fwd(qkv, heads, n_valid)


class VisionAttention(torch.autograd.Function):
    """The counterpart of ``_vision_attention_padded.defvjp(_vjp_fwd,
    _vjp_bwd)``: the no-stash forward, saving q, k and v, and the recompute
    backward. Its backward is not itself differentiable."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(q, k, v)
        return vision_attention_fwd(q, k, v)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout: torch.Tensor):
        q, k, v = ctx.saved_tensors
        dout = dout.to(q.dtype)  # autograd may hand over f32 or strided
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        return vision_attention_bwd(q, k, v, dout)


def vision_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q·kᵀ/√D)·v for [B, H, N, D] inputs (N arbitrary, D ≤ 128 on the
    card), differentiable. With grad mode on and any input requiring grad it
    runs ``VisionAttention``; otherwise ``vision_attention_fwd``. Kernels on
    CUDA tensors, their plain versions on CPU tensors (see module doc)."""
    _check_bhnd("vision_attention", q, k=k, v=v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return VisionAttention.apply(q, k, v)
    return vision_attention_fwd(q, k, v)
