"""visiondk_tpu_torch.ops.window_attention against the JAX package.

The port's window-attention forward, its P-stash forward and its two
backwards (what the CUDA kernels compute, and what their wrappers run for
CPU tensors) are compared with the JAX ``fused_window_attention``, its
``_wattn_vjp_fwd`` and ``jax.vjp`` through its ``custom_vjp``, run by the
Pallas kernels in interpret mode, as tests/test_pallas_attention.py runs
them. Inputs, biases and cotangents come from a numpy seed and go to both
frameworks as the same arrays. Shapes: the JAX kernel test's B=4, 8×8, ws 4,
2 heads, C=32, unshifted and shifted by 2; Swin's ws 7 at 14×14, head dim
32, shifted by 3; SwinV2's ws 8 with scale 1.0.

Tolerances. f32: 1e-4, the JAX kernel test's (the algorithm is the same;
only f32 summation order differs). bf16: O within 1.6e-2 (about two bf16
ulps at |o| ≈ 1), P within 2**-8 (one bf16 ulp at p ≤ 1, where the two exp2s
land on either side of a rounding boundary), dqkv within 2e-2 (the bound the
JAX package holds its own bf16 backward to, tests/test_pallas_attention.py:
419-470) absolute and relative: with scale 1.0 entries reach |dqkv| ≈ 5,
where one bf16 ulp is 2**-5. dbias is f32 in both dtypes: its
terms are f32 functions of the bf16 operands, so in bf16 it moves only where
a stashed P entry rounds the other way (one ulp, 2**-9 · p, on a few
entries, times |dP − δ|); 2e-3 absolute, against |dbias| of about 1-10 here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visiondk_tpu.models.backbones.swin import window_region_ids
from visiondk_tpu.ops.pallas import force_interpret
from visiondk_tpu.ops.pallas import fused_window_attention as jax_fused_window_attention
from visiondk_tpu.ops.pallas.window_attention import _wattn_vjp_fwd
from visiondk_tpu_torch.ops import window_attention as W
from visiondk_tpu_torch.ops.window_attention import (
    KERNELS,
    FusedWindowAttention,
    fused_window_attention,
    fused_window_attention_bwd_from_p,
    fused_window_attention_bwd_from_p_plain,
    fused_window_attention_bwd_recompute,
    fused_window_attention_bwd_recompute_plain,
    fused_window_attention_fwd,
    fused_window_attention_fwd_stash,
    fused_window_attention_plain,
)

# name: (B, H, W, heads, C, ws, shift, scale)
SHAPES = {
    "jax_test_unshifted": (4, 8, 8, 2, 32, 4, 0, None),
    "jax_test_shifted": (4, 8, 8, 2, 32, 4, 2, None),
    "swin_ws7_shifted": (2, 14, 14, 2, 64, 7, 3, None),
    "swinv2_ws8_scale1": (2, 16, 16, 2, 64, 8, 4, 1.0),
}
DTYPES = ["float32", "bfloat16"]
O_TOL = {"float32": 1e-4, "bfloat16": 1.6e-2}
P_TOL = {"float32": 1e-4, "bfloat16": 2.0**-8}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DBIAS_TOL = {"float32": 1e-4, "bfloat16": 2e-3}


def _arrays(shape, seed: int):
    b, hh, ww, heads, c, ws, shift, _ = shape
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(b, hh, ww, 3 * c)).astype(np.float32)
    bias = (0.5 * rng.normal(size=(heads, ws * ws, ws * ws))).astype(np.float32)
    cot = rng.normal(size=(b, hh, ww, c)).astype(np.float32)
    ids = window_region_ids(hh, ww, ws, shift) if shift else None
    return qkv, bias, cot, ids


def _torch(a, dtype: str = "float32"):
    return None if a is None else torch.from_numpy(a).to(getattr(torch, dtype))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t.astype(jnp.float32))


def _set_pcache(monkeypatch, pcache: bool) -> None:
    if pcache:
        monkeypatch.delenv("VDK_ATTN_NO_PCACHE", raising=False)  # the JAX op reads it too
    else:
        monkeypatch.setenv("VDK_ATTN_NO_PCACHE", "1")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_stash_forward_matches_jax_vjp_fwd(shape, dtype, monkeypatch):
    _set_pcache(monkeypatch, True)
    b, hh, ww, heads, c, ws, _, scale = SHAPES[shape]
    qkv, bias, _, ids = _arrays(SHAPES[shape], 0)
    with force_interpret():
        o_ref, (_, _, _, p_ref) = _wattn_vjp_fwd(
            jnp.asarray(qkv, dtype=getattr(jnp, dtype)), jnp.asarray(bias),
            None if ids is None else jnp.asarray(ids), heads, scale)
    x = _torch(qkv, dtype)
    o, p = fused_window_attention_fwd_stash(x, _torch(bias), _torch(ids), heads, scale)
    n_win = (hh // ws) * (ww // ws)
    assert o.shape == (b, hh, ww, c) and p.shape == (b, n_win, heads, ws * ws, ws * ws)
    assert o.dtype == p.dtype == getattr(torch, dtype)
    assert p_ref.shape == p.shape  # the JAX layout with pairing off
    np.testing.assert_allclose(_np(p), _np(p_ref), atol=P_TOL[dtype], rtol=0)
    np.testing.assert_allclose(_np(o), _np(o_ref), atol=O_TOL[dtype], rtol=O_TOL[dtype])
    # the stash changes nothing in O, and the no-stash wrapper gives the same O
    assert torch.equal(o, fused_window_attention_plain(x, _torch(bias), _torch(ids), heads, scale))
    assert torch.equal(o, fused_window_attention_fwd(x, _torch(bias), _torch(ids), heads, scale))


@pytest.mark.parametrize("pcache", [True, False], ids=["from_p", "recompute"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_dqkv_and_dbias_match_jax_vjp(shape, dtype, pcache, monkeypatch):
    _set_pcache(monkeypatch, pcache)
    heads, scale = SHAPES[shape][3], SHAPES[shape][7]
    qkv, bias, cot, ids = _arrays(SHAPES[shape], 1)
    jdt = getattr(jnp, dtype)
    jids = None if ids is None else jnp.asarray(ids)
    with force_interpret():
        _, vjp = jax.vjp(lambda x, bb: jax_fused_window_attention(x, bb, jids, heads, scale),
                         jnp.asarray(qkv, dtype=jdt), jnp.asarray(bias))
        dqkv_ref, dbias_ref = vjp(jnp.asarray(cot, dtype=jdt))
    x = _torch(qkv, dtype).requires_grad_(True)
    bb = _torch(bias).requires_grad_(True)
    out = fused_window_attention(x, bb, _torch(ids), heads, scale)
    assert type(out.grad_fn).__name__ == "FusedWindowAttentionBackward"
    out.backward(_torch(cot, dtype))
    assert x.grad.dtype == x.dtype and x.grad.shape == x.shape
    assert bb.grad.dtype == torch.float32 and bb.grad.shape == bb.shape
    got = _np(x.grad)
    assert np.isfinite(got).all()
    tol = GRAD_TOL[dtype]
    np.testing.assert_allclose(got, _np(dqkv_ref), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(bb.grad), _np(dbias_ref), atol=DBIAS_TOL[dtype],
                               rtol=DBIAS_TOL[dtype] if dtype == "float32" else 0)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_backward_plain_versions_agree_in_f32(shape):
    """From P and recompute are the same gradient in f32 (the JAX package's
    own check, test_no_pcache_fallback_grads_match, holds them to 1e-5)."""
    heads, scale = SHAPES[shape][3], SHAPES[shape][7]
    qkv, bias, cot, ids = _arrays(SHAPES[shape], 2)
    x, bb, g, tids = _torch(qkv), _torch(bias), _torch(cot), _torch(ids)
    _, p = fused_window_attention_fwd_stash(x, bb, tids, heads, scale)
    a, da = fused_window_attention_bwd_from_p_plain(x, p, g, heads, scale)
    b, db = fused_window_attention_bwd_recompute_plain(x, bb, tids, g, heads, scale)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(da.numpy(), db.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shift", [0, 1], ids=["unshifted", "shifted"])
@pytest.mark.parametrize("pcache", [True, False], ids=["from_p", "recompute"])
def test_autograd_function_gradcheck_f64(pcache, shift, monkeypatch):
    """The hand-derived backward (dqkv and dbias) against finite differences,
    in float64: B=2, 4×4, ws 2, 2 heads, head dim 3."""
    _set_pcache(monkeypatch, pcache)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 4, 4, 3 * 2 * 3), generator=gen, dtype=torch.float64, requires_grad=True)
    bb = (0.5 * torch.randn((2, 4, 4), generator=gen, dtype=torch.float64)).requires_grad_(True)
    ids = torch.from_numpy(window_region_ids(4, 4, 2, shift)) if shift else None
    assert torch.autograd.gradcheck(lambda t, b: FusedWindowAttention.apply(t, b, ids, 2, None), (x, bb))


def test_gradient_reaches_bias_alone_and_qkv_alone():
    """Either input may be the only one that requires grad; the other gets none."""
    qkv, bias, cot, ids = _arrays(SHAPES["jax_test_shifted"], 5)
    heads = SHAPES["jax_test_shifted"][3]
    for grad_qkv in (True, False):
        x = _torch(qkv).requires_grad_(grad_qkv)
        bb = _torch(bias).requires_grad_(not grad_qkv)
        fused_window_attention(x, bb, _torch(ids), heads).backward(_torch(cot))
        assert (x.grad is not None) == grad_qkv and (bb.grad is not None) != grad_qkv
        assert (x.grad if grad_qkv else bb.grad).abs().sum() > 0


def test_no_grad_runs_the_no_stash_forward():
    qkv, bias, _, ids = _arrays(SHAPES["swin_ws7_shifted"], 3)
    heads = SHAPES["swin_ws7_shifted"][3]
    x = _torch(qkv).requires_grad_(True)
    with torch.no_grad():
        out = fused_window_attention(x, _torch(bias), _torch(ids), heads)
    assert out.grad_fn is None
    np.testing.assert_array_equal(
        out.numpy(), fused_window_attention_plain(x.detach(), _torch(bias), _torch(ids), heads).numpy())


def test_cpu_wrappers_run_plain_versions_without_counting():
    heads = SHAPES["jax_test_shifted"][3]
    qkv, bias, cot, ids = (_torch(a) for a in _arrays(SHAPES["jax_test_shifted"], 4))
    before = [k.launches for k in KERNELS]
    out = fused_window_attention(qkv.clone().requires_grad_(True), bias.clone().requires_grad_(True), ids, heads)
    out.backward(cot)
    _, p = fused_window_attention_fwd_stash(qkv, bias, ids, heads)
    for got, want in ((fused_window_attention_bwd_from_p(qkv, p, cot, heads),
                       fused_window_attention_bwd_from_p_plain(qkv, p, cot, heads)),
                      (fused_window_attention_bwd_recompute(qkv, bias, ids, cot, heads),
                       fused_window_attention_bwd_recompute_plain(qkv, bias, ids, cot, heads))):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert [k.launches for k in KERNELS] == before


def test_window_partition_and_reverse_are_inverse_and_row_major():
    x = torch.arange(2 * 8 * 12 * 3, dtype=torch.float32).reshape(2, 8, 12, 3)
    win = W.window_partition(x, 4)
    assert win.shape == (2, 6, 16, 3)
    # window 4 is (wy=1, wx=1); its row 5 is pixel (1·4 + 1, 1·4 + 1)
    assert torch.equal(win[1, 4, 5], x[1, 5, 5])
    assert torch.equal(W.window_reverse(win, 4, 8, 12), x)


def test_backward_blocks_take_fixed_runs_of_windows():
    """Every backward block takes a fixed run of windows for one head, about
    eight blocks on each of an H100's SMs, never less than one window."""
    assert W.windows_per_chunk(80, 64, 4) == 20  # Swin-B stage 0 at bs 80: 256 runs × 4 heads
    assert W.windows_per_chunk(80, 4, 16) == 5
    assert W.windows_per_chunk(4, 4, 2) == 1


_B, _H, _W, _HEADS, _C, _WS = 2, 8, 8, 2, 16, 4
_N = _WS * _WS


@pytest.mark.parametrize(
    "call,err",
    [
        (lambda z: fused_window_attention_fwd(z((_B, _H, _W * 3 * _C)), z((_HEADS, _N, _N)), None, _HEADS),
         ValueError),  # qkv not [B, H, W, 3C]
        (lambda z: fused_window_attention_fwd(z((_B, _H, _W, 3 * _C + 1)), z((_HEADS, _N, _N)), None, _HEADS),
         ValueError),  # width not 3 · heads · head_dim
        (lambda z: fused_window_attention_fwd(z((_B, 6, _W, 3 * _C)), z((_HEADS, _N, _N)), None, _HEADS),
         ValueError),  # H not a multiple of the window
        (lambda z: fused_window_attention_fwd(z((_B, _H, _W, 3 * _C)), z((_HEADS, 15, 15)), None, _HEADS),
         ValueError),  # N not a square
        (lambda z: fused_window_attention_fwd(z((_B, _H, _W, 3 * _C)), z((_HEADS + 1, _N, _N)), None, _HEADS),
         ValueError),  # bias of other heads
        (lambda z: fused_window_attention_fwd(z((_B, _H, _W, 3 * _C)), z((_HEADS, _N, _N)),
                                              torch.zeros((3, _N), dtype=torch.int32), _HEADS),
         ValueError),  # ids not [nW, N]
        (lambda z: fused_window_attention_bwd_from_p(z((_B, _H, _W, 3 * _C)), z((_B, 4, _HEADS, _N, _N - 1)),
                                                     z((_B, _H, _W, _C)), _HEADS),
         ValueError),  # P not [B, nW, heads, N, N]
        (lambda z: fused_window_attention_bwd_from_p(z((_B, _H, _W, 3 * _C)), z((_B, 4, _HEADS, _N, _N)),
                                                     z((_B, _H, _W, _C + 1)), _HEADS),
         ValueError),  # dO not [B, H, W, C]
        (lambda z: fused_window_attention_bwd_from_p(z((_B, _H, _W, 3 * _C)),
                                                     z((_B, 4, _HEADS, _N, _N)).double(),
                                                     z((_B, _H, _W, _C)), _HEADS),
         TypeError),  # P of another dtype
        (lambda z: fused_window_attention_bwd_recompute(z((_B, _H, _W, 3 * _C)), z((_HEADS, _N, _N)), None,
                                                        z((_B, _H, _W, _C)).bfloat16(), _HEADS),
         TypeError),  # dO of another dtype
    ],
    ids=["qkv_rank", "qkv_width", "h_not_multiple", "n_not_square", "bias_heads", "ids_shape",
         "p_shape", "do_shape", "p_dtype", "do_dtype"],
)
def test_wrappers_reject_what_the_kernels_do_not_take(call, err):
    with pytest.raises(err):
        call(torch.zeros)


def test_wrappers_reject_a_device_that_is_neither_cuda_nor_cpu():
    z = lambda shape: torch.zeros(shape, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_window_attention_fwd(z((_B, _H, _W, 3 * _C)), z((_HEADS, _N, _N)), None, _HEADS)
    with pytest.raises(ValueError, match="cuda or cpu"):  # mixed devices
        fused_window_attention_fwd_stash(torch.zeros((_B, _H, _W, 3 * _C)), z((_HEADS, _N, _N)), None, _HEADS)
