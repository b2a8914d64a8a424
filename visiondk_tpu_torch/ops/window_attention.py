"""Fused window attention (counterpart of ``visiondk_tpu/ops/pallas/window_attention.py``).

``fused_window_attention(qkv, bias, ids, heads, scale=None)`` is Swin's
attention core: softmax(scale·QKᵀ + bias [+ shift mask])·V over ws×ws
windows, straight from the QKV projection's layout, with the JAX op's
contract (``window_attention.py:33-38``):

- ``qkv``  [B, H, W, 3C] with H % ws == 0 and W % ws == 0;
- ``bias`` [heads, ws², ws²] f32, the relative-position bias per head;
- ``ids``  [nH·nW, ws²] int32 shift-region ids (row-major over windows), or
  None for the unshifted case (W-MSA); tokens of different regions do not
  attend (mask −100 before the softmax);
- returns [B, H, W, C].

``scale`` defaults to 1/√head_dim (Swin V1; SwinV2 passes 1.0). The window
partition and its reverse happen inside the kernels: row r of window
(wy, wx) is pixel (wy·ws + r // ws, wx·ws + r % ws).

It is differentiable in qkv and in bias, as the JAX ``custom_vjp`` is: with
grad mode on and either input requiring grad it runs the autograd Function
``FusedWindowAttention``, whose forward stashes the probabilities P
[B, nW, heads, N, N] (N = ws², nW = nH·nW) for the backward, or, with
``VDK_ATTN_NO_PCACHE=1`` (read at each call, as the JAX package's
``_p_cache_enabled`` reads it), saves qkv and bias and recomputes P in the
backward. The bias gradient is the sum of dS over every window and batch row.
Without grad it runs the no-stash forward.

Four kernels, each behind a wrapper with its own launch count
(``<wrapper>.launches``, counted only where the kernel is launched, and
``<wrapper>.large_launches``, the launches on windows of N > 64, which the
kernels' tiled bodies take):

- ``fused_window_attention_fwd``: no-stash forward (``csrc/fused_window_attention.cu``, K2), the
  registered operator ``torch.ops.vdk.fused_window_attention`` (one node of a ``torch.export`` program);
- ``fused_window_attention_fwd_stash``: the same kernel, also writing P (K2s);
- ``fused_window_attention_bwd_from_p``: backward from the stashed P
  (``csrc/fused_window_attention_bwd.cu``, K2b);
- ``fused_window_attention_bwd_recompute``: backward that recomputes P in f32 (K2r).

On a CUDA tensor a wrapper launches its kernel (or raises); on a CPU tensor
it runs the kernel's plain PyTorch version (``*_plain``), which has the
Pallas kernel's arithmetic: log2-domain scores with scale·log2(e) folded into
q and log2(e) into the bias, the region mask at −100·log2(e) (not −∞),
P = exp2(S − rowmax) · (1 / rowsum) in f32, rounded to v's dtype before P·V.
The plain versions compute in f32, or in f64 for f64 inputs (which
``torch.autograd.gradcheck`` uses on the CPU). The JAX package's window
pairing and VMEM planner are TPU layout machinery and have no counterpart:
with the default ``VDK_WATTN_PAIR=1`` the math is the unpaired kernel's.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from visiondk_tpu_torch.ops.attention import (
    _DTYPE_CODES, _LOG2E, _acc, _check_err, _check_operand, _lib, _p_cache_enabled, check_grid_rows,
)
from visiondk_tpu_torch.utils.spans import span

_MASK_VALUE = -100.0 * _LOG2E  # the reference's region mask, in the log2 domain
_FWD_LIB = "fused_window_attention"
_BWD_LIB = "fused_window_attention_bwd"
_MAX_WS = 16
_SMALL_N = 64  # ws <= 8: a window's rows in one block; above it the tiled bodies
_MAX_HEAD_DIM = 64
# The backward's blocks, and the bf16 forward's, each take a fixed run of
# windows for one head; the runs are as short as keep every head's blocks
# within one wave on an H100's 132 SMs at this many blocks an SM. Backward,
# by (dtype, recompute): about 8 for the f32 CUDA-core kernel; for the bf16
# tensor-core kernel the 3 (from P) or 2 (recomputing) an SM holds, so that
# each block's loads of its next window overlap its products. Forward: the 4
# an SM holds at head dim 32 (the f32 forward takes one window a block).
_SMS = 132
_BWD_BLOCKS_PER_SM = {(torch.float32, False): 8, (torch.float32, True): 8,
                      (torch.bfloat16, False): 3, (torch.bfloat16, True): 2}
_FWD_BLOCKS_PER_SM = 4
# Windows of N > 64 (ws 9 to 16) take the tiled bf16 bodies: a block takes one
# head, one run of up to _TILED_ROWS query rows (forward, dq) or keys (dkv) and
# a fixed run of windows, sized so that one wave of blocks covers the call at
# the blocks an SM their shared memory allows (tiled_smem_bytes, as the kernels
# compute it: two at head dim 32, one at 64). The f32 tiled bodies take one
# window a block in the forward and in dkv, and the dq kernel's runs.
_TILED_ROWS = 64
_SM_SHARED_BYTES = 233_472  # an H100 SM's shared memory (228 KB)
_BLOCK_RESERVED = 1_024  # the runtime's own shared memory a block
_TILED_MAX_BLOCKS_PER_SM = 2  # __launch_bounds__(128, 2)


def tiled_smem_bytes(kernel: str, head_dim: int, masked: bool, variant: bool) -> int:
    """Dynamic shared memory of one block of a tiled bf16 kernel (N > 64), as
    ``csrc/fused_window_attention.cu`` (``kernel`` "fwd"; ``variant``: the
    stash) and ``csrc/fused_window_attention_bwd.cu`` ("dq", "dkv"; ``variant``:
    recompute) compute it. A block is 4 warps of 16 rows; every window takes
    256 keys (past N zeros), so no size depends on N. bf16 tiles [rows][DP]
    unpadded (DP = 32 or 64); the bias (and dq's dbias sum) in f32 fragment
    order, 64 KB; a table of 256 ints for the rows' pixel offsets, and one for
    the region ids where they are read. ``chip_smoke.py`` holds these figures
    to the kernels' own on the card."""
    dp = 32 if head_dim <= 32 else 64
    rows, keys, frag, table = _TILED_ROWS, 256, 65_536, 1_024
    if kernel == "fwd":  # q rows, K, V
        return frag + 2 * (rows + 2 * keys) * dp + table * (2 if masked else 1)
    if kernel == "dq":  # K, V, dO rows (and q rows)
        return frag + 2 * (2 * keys + (2 if variant else 1) * rows) * dp + table * (2 if masked and variant else 1)
    if kernel == "dkv":  # q and dO of every query, the block's v (and k) rows, the query stats
        tiles = 2 * (2 * keys + (2 if variant else 1) * rows) * dp + 4 * (3 if variant else 1) * keys
        if variant:  # recomputing: the bias of the block's keys in fragment order
            return frag + tiles + table * (2 if masked else 1)
        return tiles + 2 * keys * (rows + 8) + table  # the stash's columns, rows padded by 8
    raise ValueError(f"unknown tiled kernel {kernel!r}")


def tiled_row_blocks(n: int) -> int:
    """Blocks a window's rows (or keys) split over in the tiled kernels: runs
    of 64 (4 warps of 16)."""
    return -(-n // _TILED_ROWS)


def tiled_blocks_per_sm(kernel: str, head_dim: int, masked: bool, variant: bool) -> int:
    """Blocks of a tiled bf16 kernel an H100 SM holds by its shared memory,
    at most the two of its launch bounds."""
    need = tiled_smem_bytes(kernel, head_dim, masked, variant) + _BLOCK_RESERVED
    return max(1, min(_TILED_MAX_BLOCKS_PER_SM, _SM_SHARED_BYTES // need))


def _window_size(bias: torch.Tensor, heads: int) -> int:
    """ws² = N of a bias [heads, N, N] whose N is a square; raises otherwise."""
    n = bias.shape[-1] if bias.dim() == 3 else 0
    ws = math.isqrt(n)
    if bias.dim() != 3 or tuple(bias.shape) != (heads, n, n) or ws < 1 or ws * ws != n:
        raise ValueError(f"bias must be [heads={heads}, ws², ws²], got shape {tuple(bias.shape)}")
    return n


def _layout(qkv: torch.Tensor, heads: int, n: int, ids: Optional[torch.Tensor] = None):
    """(B, H, W, C, head_dim, ws, nW) of a valid call with N = ``n`` tokens
    per window; raises ValueError on shapes that break the layout contract."""
    if qkv.dim() != 4:
        raise ValueError(f"qkv must be [B, H, W, 3C], got shape {tuple(qkv.shape)}")
    b, hh, ww, c3 = qkv.shape
    if heads < 1 or c3 % (3 * heads):
        raise ValueError(f"qkv width {c3} is not 3 * heads * head_dim for heads={heads}")
    ws = math.isqrt(n)
    if ws < 1 or ws * ws != n:
        raise ValueError(f"a window holds ws² tokens, got {n}")
    if hh % ws or ww % ws:
        raise ValueError(f"H={hh} and W={ww} must be multiples of the window size {ws}")
    n_win = (hh // ws) * (ww // ws)
    if ids is not None and tuple(ids.shape) != (n_win, n):
        raise ValueError(f"ids must be [nH·nW={n_win}, ws²={n}], got shape {tuple(ids.shape)}")
    return b, hh, ww, c3 // 3, c3 // (3 * heads), ws, n_win


def _scale(head_dim: int, scale: Optional[float]) -> float:
    return head_dim**-0.5 if scale is None else float(scale)


# ---------------------------------------------------------------- plain versions


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, K] → [B, nH·nW, ws², K], windows row-major."""
    b, hh, ww, k = x.shape
    x = x.reshape(b, hh // ws, ws, ww // ws, ws, k).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (hh // ws) * (ww // ws), ws * ws, k)


def window_reverse(windows: torch.Tensor, ws: int, hh: int, ww: int) -> torch.Tensor:
    """[B, nH·nW, ws², K] → [B, H, W, K]."""
    b, _, _, k = windows.shape
    x = windows.reshape(b, hh // ws, ww // ws, ws, ws, k).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hh, ww, k)


def _split(x: torch.Tensor, ws: int, heads: int, head_dim: int):
    """[B, H, W, m·heads·d] → m tensors [B, nW, heads, N, d] (window partition)."""
    win = window_partition(x, ws)
    b, n_win, n, width = win.shape
    return win.reshape(b, n_win, n, width // (heads * head_dim), heads, head_dim).permute(3, 0, 1, 4, 2, 5)


def _merge(parts, ws: int, hh: int, ww: int, dtype: torch.dtype) -> torch.Tensor:
    """m tensors [B, nW, heads, N, d] → [B, H, W, m·heads·d] in ``dtype``."""
    x = torch.stack(parts, dim=3)  # [B, nW, heads, m, N, d]
    b, n_win, heads, m, n, d = x.shape
    x = x.permute(0, 1, 4, 3, 2, 5).reshape(b, n_win, n, m * heads * d)
    return window_reverse(x.to(dtype), ws, hh, ww)


def _probs(q: torch.Tensor, k: torch.Tensor, bias: torch.Tensor, ids: Optional[torch.Tensor],
           q_mul: float) -> torch.Tensor:
    """P = exp2(S − rowmax) · (1 / rowsum), unrounded, of the log2-domain
    scores S = (q·q_mul)·kᵀ + bias·log2(e) [+ −100·log2(e) across regions]
    (``_scores``, ``window_attention.py:224-243``). q, k [B, nW, heads, N, d]
    in the accumulation dtype."""
    s = torch.matmul(q * q_mul, k.transpose(-1, -2)) + bias.to(q.dtype) * _LOG2E
    if ids is not None:
        apart = ids[:, :, None] != ids[:, None, :]  # [nW, N, N]
        s = s + torch.where(apart, _MASK_VALUE, 0.0).to(s.dtype)[None, :, None]
    e = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    return e * (1.0 / e.sum(dim=-1, keepdim=True))


def fused_window_attention_fwd_stash_plain(
    qkv: torch.Tensor, bias: torch.Tensor, ids: Optional[torch.Tensor], heads: int,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O [B, H, W, C], P [B, nW, heads, N, N]) in the input dtype, with the
    Pallas kernel's arithmetic (``_wattn_fwd_kernel``, ``window_attention.py:
    246-290``): P rounded to the input dtype, then P·V accumulated in f32.
    Differentiable by autograd."""
    _, hh, ww, _, d, ws, _ = _layout(qkv, heads, _window_size(bias, heads), ids)
    acc = _acc(qkv.dtype)
    q, k, v = _split(qkv, ws, heads, d)
    p = _probs(q.to(acc), k.to(acc), bias, ids, _scale(d, scale) * _LOG2E).to(qkv.dtype)
    o = torch.matmul(p.to(acc), v.to(acc))
    return _merge([o], ws, hh, ww, qkv.dtype), p


def fused_window_attention_plain(
    qkv: torch.Tensor, bias: torch.Tensor, ids: Optional[torch.Tensor], heads: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The no-stash forward in PyTorch, on any device: O [B, H, W, C] (see
    ``fused_window_attention_fwd_stash_plain``). Differentiable by autograd."""
    return fused_window_attention_fwd_stash_plain(qkv, bias, ids, heads, scale)[0]


def _bwd_core(p, q, k, v, do, scale: float):
    """dV = Pᵀ·dO, dP = dO·Vᵀ, δ = rowsum(P∘dP), dS = P∘(dP − δ), dbias =
    Σ dS over batch rows and windows, dQ = dS·k·scale, dK = dSᵀ·q·scale with
    the unscaled q (``window_attention.py:329-346, 378-395``)."""
    dv = torch.matmul(p.transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    return dq, dk, dv, ds.sum(dim=(0, 1))


def fused_window_attention_bwd_from_p_plain(
    qkv: torch.Tensor, p: torch.Tensor, dout: torch.Tensor, heads: int,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dqkv [B, H, W, 3C] in qkv's dtype, dbias [heads, N, N] f32) from the
    stashed P, as ``_wattn_bwd_from_p_kernel`` (``window_attention.py:350-396``):
    every operand upcast to f32, the region mask implicit in P."""
    _, hh, ww, _, d, ws, _ = _layout(qkv, heads, p.shape[-1])
    acc = _acc(qkv.dtype)
    q, k, v = (t.to(acc) for t in _split(qkv, ws, heads, d))
    do = _split(dout, ws, heads, d)[0].to(acc)
    dq, dk, dv, dbias = _bwd_core(p.to(acc), q, k, v, do, _scale(d, scale))
    return _merge([dq, dk, dv], ws, hh, ww, qkv.dtype), dbias


def fused_window_attention_bwd_recompute_plain(
    qkv: torch.Tensor, bias: torch.Tensor, ids: Optional[torch.Tensor], dout: torch.Tensor,
    heads: int, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dqkv, dbias) with P recomputed in f32 and not rounded, as
    ``_wattn_bwd_kernel`` (``window_attention.py:293-347``)."""
    _, hh, ww, _, d, ws, _ = _layout(qkv, heads, _window_size(bias, heads), ids)
    acc = _acc(qkv.dtype)
    q, k, v = (t.to(acc) for t in _split(qkv, ws, heads, d))
    do = _split(dout, ws, heads, d)[0].to(acc)
    sc = _scale(d, scale)
    dq, dk, dv, dbias = _bwd_core(_probs(q, k, bias, ids, sc * _LOG2E), q, k, v, do, sc)
    return _merge([dq, dk, dv], ws, hh, ww, qkv.dtype), dbias


# ---------------------------------------------------------------- kernel wrappers


def _runs_kernel(qkv: torch.Tensor, heads: int, n: int, bias: Optional[torch.Tensor],
                 ids: Optional[torch.Tensor], op: str) -> bool:
    """True for CUDA tensors the kernels take, False for CPU tensors (the
    plain version runs); raises for anything else."""
    tensors = [t for t in (qkv, bias, ids) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return False
    if qkv.device.type != "cuda" or any(t.device != qkv.device for t in tensors):
        raise ValueError(f"{op} runs on cuda or cpu tensors, all on one device; got "
                         f"{[str(t.device) for t in tensors]}")
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"{op} kernel takes float32 or bfloat16, got {qkv.dtype}")
    if bias is not None and bias.dtype != torch.float32:
        raise TypeError(f"{op} kernel takes a float32 bias, got {bias.dtype}")
    if ids is not None and ids.dtype != torch.int32:
        raise TypeError(f"{op} kernel takes int32 region ids, got {ids.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{op} kernel needs contiguous qkv, bias and ids")
    d = qkv.shape[-1] // (3 * heads)
    if n > _MAX_WS**2 or d > _MAX_HEAD_DIM:
        raise ValueError(f"{op} kernel takes ws <= {_MAX_WS} and head_dim <= {_MAX_HEAD_DIM}, "
                         f"got ws² = {n}, head_dim = {d}")
    check_grid_rows(qkv.shape[0], heads, op)
    return True


_I, _F, _P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
_FWD_ARGS = [_P, _P, _P, _P, _P,  # qkv bias ids out p
             _I, _I, _I, _I, _I, _I, _I, _F, _I, _P]  # b h w heads d ws per_chunk | q_mul dtype stream
_BWD_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _P,  # qkv bias ids p dout dqkv dbias_part dbias stats
             _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P]  # b h w heads d ws per_chunk | q_mul scale dtype stream


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_fwd(qkv, bias, ids, heads, scale, stash: bool):
    n = bias.shape[-1]
    b, hh, ww, c, d, ws, n_win = _layout(qkv, heads, n, ids)
    out = torch.empty((b, hh, ww, c), dtype=qkv.dtype, device=qkv.device)
    p = torch.empty((b, n_win, heads, n, n), dtype=qkv.dtype, device=qkv.device) if stash else None
    lib = _lib(_FWD_LIB, "vdk_fused_window_attention_fwd", _FWD_ARGS)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.vdk_fused_window_attention_fwd(
            qkv.data_ptr(), bias.data_ptr(), _ptr(ids), out.data_ptr(), _ptr(p),
            b, hh, ww, heads, d, ws, forward_windows_per_chunk(b, n_win, heads, n, d),
            _scale(d, scale) * _LOG2E, _DTYPE_CODES[qkv.dtype], stream,
        )
    _check_err(lib, err, "fused_window_attention forward")
    return out, p


def _windows_per_run(windows: int, heads: int, blocks_per_sm: int) -> int:
    """Windows a block takes so that ``windows`` × ``heads`` fill one wave of
    ``blocks_per_sm`` blocks on every SM (at least one)."""
    runs = max(1, _SMS * blocks_per_sm // heads)
    return -(-windows // runs)


def windows_per_chunk(batch: int, n_win: int, heads: int, dtype: torch.dtype, recompute: bool,
                      n: int = _SMALL_N, head_dim: int = 32) -> int:
    """Windows each backward block takes, in a fixed order, for one head (and,
    for N > 64, one run of rows: the dq kernel's blocks, which carry dbias,
    and the bf16 dkv kernel's, on the same grid; the shift regions never
    change how many blocks an SM holds)."""
    if n > _SMALL_N:
        per_sm = (tiled_blocks_per_sm("dq", head_dim, True, recompute) if dtype == torch.bfloat16
                  else _TILED_MAX_BLOCKS_PER_SM)
        return _windows_per_run(batch * n_win, heads * tiled_row_blocks(n), per_sm)
    return _windows_per_run(batch * n_win, heads, _BWD_BLOCKS_PER_SM[dtype, recompute])


def forward_windows_per_chunk(batch: int, n_win: int, heads: int, n: int = _SMALL_N, head_dim: int = 32) -> int:
    """Windows each bf16 forward block takes, in a fixed order, for one head
    (and, for N > 64, one run of query rows; neither the shift regions nor the
    stash change how many blocks an SM holds); the f32 forward ignores it: one
    window a block."""
    if n > _SMALL_N:
        per_sm = tiled_blocks_per_sm("fwd", head_dim, True, True)
        return _windows_per_run(batch * n_win, heads * tiled_row_blocks(n), per_sm)
    return _windows_per_run(batch * n_win, heads, _FWD_BLOCKS_PER_SM)


def backward_plan(batch: int, n_win: int, heads: int, n: int, dtype: torch.dtype, recompute: bool,
                  head_dim: int = 32) -> Tuple[int, Tuple[int, int, int, int]]:
    """(windows a run, shape of dbias_part) of a backward call: the runs of
    windows in batch-row-major order that the dbias-carrying blocks take, and
    their partial sums [runs, heads, N, N] that the fixed-order sum adds."""
    per_chunk = windows_per_chunk(batch, n_win, heads, dtype, recompute, n, head_dim)
    return per_chunk, (-(-batch * n_win // per_chunk), heads, n, n)


def _launch_bwd(qkv, n, bias, ids, p, dout, heads, scale):
    """The backward kernels (from P when ``p`` is given, else recomputing it
    from bias and ids), then the fixed-order sum of their dbias partials.
    For N > 64 the row statistics the dq kernel hands the dkv kernel (delta,
    and recomputing the row max and 1 / sum) go through ``stats``."""
    b, hh, ww, _, d, ws, n_win = _layout(qkv, heads, n, ids)
    per_chunk, part_shape = backward_plan(b, n_win, heads, n, qkv.dtype, p is None, d)
    dqkv = torch.empty_like(qkv)
    dbias_part = torch.empty(part_shape, dtype=torch.float32, device=qkv.device)
    dbias = torch.empty((heads, n, n), dtype=torch.float32, device=qkv.device)
    stats = (torch.empty((3, b * n_win, heads, n), dtype=torch.float32, device=qkv.device)
             if n > _SMALL_N else None)
    lib = _lib(_BWD_LIB, "vdk_fused_window_attention_bwd", _BWD_ARGS)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.vdk_fused_window_attention_bwd(
            qkv.data_ptr(), _ptr(bias), _ptr(ids), _ptr(p), dout.data_ptr(), dqkv.data_ptr(),
            dbias_part.data_ptr(), dbias.data_ptr(), _ptr(stats), b, hh, ww, heads, d, ws, per_chunk,
            _scale(d, scale) * _LOG2E, _scale(d, scale), _DTYPE_CODES[qkv.dtype], stream,
        )
    _check_err(lib, err, "fused_window_attention backward")
    return dqkv, dbias


def _count(wrapper, n: int) -> None:
    """One launch of ``wrapper``'s kernel on windows of N tokens."""
    wrapper.launches += 1
    if n > _SMALL_N:
        wrapper.large_launches += 1


def fused_window_attention_fwd(
    qkv: torch.Tensor, bias: torch.Tensor, ids: Optional[torch.Tensor], heads: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """No-stash forward: qkv [B, H, W, 3C] → O [B, H, W, C]. CUDA tensors
    (qkv float32 or bfloat16, bias float32, ids int32, all contiguous, ws ≤ 16,
    head_dim ≤ 64) launch the kernel, built at first use; CPU tensors run
    ``fused_window_attention_plain``. Anything else raises. Both go through
    the registered operator ``torch.ops.vdk.fused_window_attention``, which
    ``torch.export`` records as one node."""
    _layout(qkv, heads, _window_size(bias, heads), ids)
    return torch.ops.vdk.fused_window_attention(qkv, bias, ids, heads, scale)


@torch.library.custom_op("vdk::fused_window_attention", mutates_args=())
def _fused_window_attention_op(qkv: torch.Tensor, bias: torch.Tensor, ids: Optional[torch.Tensor], heads: int,
                               scale: Optional[float]) -> torch.Tensor:
    n = bias.shape[-1]
    if not _runs_kernel(qkv, heads, n, bias, ids, "fused_window_attention_fwd"):
        return fused_window_attention_plain(qkv, bias, ids, heads, scale)
    out, _ = _launch_fwd(qkv, bias, ids, heads, scale, stash=False)
    _count(fused_window_attention_fwd, n)
    return out


@_fused_window_attention_op.register_fake
def _(qkv: torch.Tensor, bias: torch.Tensor, ids: Optional[torch.Tensor], heads: int,
      scale: Optional[float]) -> torch.Tensor:
    _runs_kernel(qkv, heads, bias.shape[-1], bias, ids, "fused_window_attention_fwd")  # raises at trace time
    b, hh, ww, c3 = qkv.shape
    return qkv.new_empty((b, hh, ww, c3 // 3))


def fused_window_attention_fwd_stash(
    qkv: torch.Tensor, bias: torch.Tensor, ids: Optional[torch.Tensor], heads: int,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward: (O [B, H, W, C], P [B, nW, heads, N, N]) in the input
    dtype. O is bit-for-bit ``fused_window_attention_fwd``'s; P is the rounded
    value that multiplied V. Same devices and checks."""
    n = _window_size(bias, heads)
    _layout(qkv, heads, n, ids)
    if not _runs_kernel(qkv, heads, n, bias, ids, "fused_window_attention_fwd_stash"):
        return fused_window_attention_fwd_stash_plain(qkv, bias, ids, heads, scale)
    out, p = _launch_fwd(qkv, bias, ids, heads, scale, stash=True)
    _count(fused_window_attention_fwd_stash, n)
    return out, p


def fused_window_attention_bwd_from_p(
    qkv: torch.Tensor, p: torch.Tensor, dout: torch.Tensor, heads: int,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dqkv [B, H, W, 3C], dbias [heads, N, N] f32) from qkv, the forward's
    stash P [B, nW, heads, N, N] and dO [B, H, W, C], all of qkv's dtype and
    contiguous. dbias is the same bits on every run. Same devices and checks."""
    if p.dim() != 5:
        raise ValueError(f"P must be [B, nW, heads, N, N], got shape {tuple(p.shape)}")
    n = p.shape[-1]
    b, hh, ww, c, _, _, n_win = _layout(qkv, heads, n)
    _check_operand(p, qkv, (b, n_win, heads, n, n), "P")
    _check_operand(dout, qkv, (b, hh, ww, c), "dO")
    if not _runs_kernel(qkv, heads, n, None, None, "fused_window_attention_bwd_from_p"):
        return fused_window_attention_bwd_from_p_plain(qkv, p, dout, heads, scale)
    dqkv, dbias = _launch_bwd(qkv, n, None, None, p, dout, heads, scale)
    _count(fused_window_attention_bwd_from_p, n)
    return dqkv, dbias


def fused_window_attention_bwd_recompute(
    qkv: torch.Tensor, bias: torch.Tensor, ids: Optional[torch.Tensor], dout: torch.Tensor,
    heads: int, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dqkv, dbias) from qkv, bias, ids and dO, with P recomputed in f32.
    Same devices and checks."""
    n = _window_size(bias, heads)
    b, hh, ww, c, _, _, _ = _layout(qkv, heads, n, ids)
    _check_operand(dout, qkv, (b, hh, ww, c), "dO")
    if not _runs_kernel(qkv, heads, n, bias, ids, "fused_window_attention_bwd_recompute"):
        return fused_window_attention_bwd_recompute_plain(qkv, bias, ids, dout, heads, scale)
    dqkv, dbias = _launch_bwd(qkv, n, bias, ids, None, dout, heads, scale)
    _count(fused_window_attention_bwd_recompute, n)
    return dqkv, dbias


KERNELS = (
    fused_window_attention_fwd,
    fused_window_attention_fwd_stash,
    fused_window_attention_bwd_from_p,
    fused_window_attention_bwd_recompute,
)
for _k in KERNELS:
    _k.launches = _k.large_launches = 0


# ---------------------------------------------------------------- the op


class FusedWindowAttention(torch.autograd.Function):
    """The counterpart of ``fused_window_attention.defvjp(_wattn_vjp_fwd,
    _wattn_vjp_bwd)``: forward with the P stash (or none, with
    ``VDK_ATTN_NO_PCACHE=1``), backward from P (or recomputing it), giving
    dqkv and dbias. Its backward is not itself differentiable."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, bias: torch.Tensor, ids: Optional[torch.Tensor],
                heads: int, scale: Optional[float]) -> torch.Tensor:
        ctx.stash = _p_cache_enabled()
        if ctx.stash:
            out, p = fused_window_attention_fwd_stash(qkv, bias, ids, heads, scale)
            ctx.save_for_backward(qkv, p)
        else:
            out = fused_window_attention_fwd(qkv, bias, ids, heads, scale)
            ctx.save_for_backward(qkv, bias)
        ctx.ids, ctx.heads, ctx.scale, ctx.bias_dtype = ids, heads, scale, bias.dtype
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout: torch.Tensor):
        qkv, saved = ctx.saved_tensors
        with span("vdk.attention.backward"):
            dout = dout.to(qkv.dtype).contiguous()  # F.linear's backward may hand over f32 or strided
            if ctx.stash:
                dqkv, dbias = fused_window_attention_bwd_from_p(qkv, saved, dout, ctx.heads, ctx.scale)
            else:
                dqkv, dbias = fused_window_attention_bwd_recompute(
                    qkv, saved, ctx.ids, dout, ctx.heads, ctx.scale)
            return (dqkv if ctx.needs_input_grad[0] else None,
                    dbias.to(ctx.bias_dtype) if ctx.needs_input_grad[1] else None, None, None, None)


def fused_window_attention(
    qkv: torch.Tensor, bias: torch.Tensor, ids: Optional[torch.Tensor], heads: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Window attention straight from the QKV projection: [B, H, W, 3C] →
    [B, H, W, C], differentiable in qkv and bias. With grad mode on and qkv
    or bias requiring grad it runs ``FusedWindowAttention``; otherwise
    ``fused_window_attention_fwd``. Kernels on CUDA tensors, their plain
    versions on CPU tensors (see module doc)."""
    _layout(qkv, heads, _window_size(bias, heads), ids)
    with span("vdk.attention"):
        if torch.is_grad_enabled() and (qkv.requires_grad or bias.requires_grad):
            return FusedWindowAttention.apply(qkv, bias, ids, heads, scale)
        return fused_window_attention_fwd(qkv, bias, ids, heads, scale)
