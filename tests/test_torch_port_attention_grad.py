"""The training side of visiondk_tpu_torch.ops.attention against the JAX package.

The port's P-stash forward and its two backwards (what the CUDA kernels
compute, and what their wrappers run for a CPU tensor) are compared with the
JAX ``custom_vjp`` of ``fused_qkv_attention`` run through its Pallas kernels
in interpret mode, as tests/test_pallas_attention.py runs them. Inputs and
cotangents come from a numpy seed and go to both frameworks as the same
arrays, at B=2, N=37 (unaligned), H=4, d=32, with and without a key mask.

Tolerances. f32: 1e-4, the JAX kernel test's (the algorithm is the same;
only f32 summation order differs). bf16: O and P round to bf16 in both, P by
at most one bf16 ulp at |p| ≤ 1 (2**-8) where the two exp2s land on either
side of a rounding boundary; O within 1.6e-2 (about two bf16 ulps at
|o| ≈ 1); dqkv within 2e-2 absolute, the bound the JAX package holds its own
bf16 backward to (tests/test_pallas_attention.py:419-470, BASELINE.md
"bf16 p-cache backward deviation").
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visiondk_tpu.ops.pallas import force_interpret
from visiondk_tpu.ops.pallas import fused_qkv_attention as jax_fused_qkv_attention
from visiondk_tpu.ops.pallas.attention import _fused_vjp_fwd
from visiondk_tpu_torch.models.layers import Attention
from visiondk_tpu_torch.ops.attention import (
    KERNELS,
    FusedQKVAttention,
    fused_qkv_attention,
    fused_qkv_attention_bwd_from_p,
    fused_qkv_attention_bwd_from_p_plain,
    fused_qkv_attention_bwd_recompute,
    fused_qkv_attention_bwd_recompute_plain,
    fused_qkv_attention_fwd_stash,
    fused_qkv_attention_plain,
)

B, N, H, D = 2, 37, 4, 32
C = H * D
N_VALID = [None, 29]
DTYPES = ["float32", "bfloat16"]
O_TOL = {"float32": 1e-4, "bfloat16": 1.6e-2}
P_TOL = {"float32": 1e-4, "bfloat16": 2.0**-8}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _arrays(seed: int):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, N, 3 * C)).astype(np.float32)
    cot = rng.normal(size=(B, N, C)).astype(np.float32)
    return qkv, cot


def _torch(a: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t.astype(jnp.float32))


@pytest.mark.parametrize("n_valid", N_VALID)
@pytest.mark.parametrize("dtype", DTYPES)
def test_stash_forward_matches_jax_vjp_fwd(dtype, n_valid, monkeypatch):
    monkeypatch.delenv("VDK_ATTN_NO_PCACHE", raising=False)  # the JAX forward reads it too
    qkv, _ = _arrays(0)
    with force_interpret():
        o_ref, (_, p_ref) = _fused_vjp_fwd(
            jnp.asarray(qkv, dtype=getattr(jnp, dtype)), H, D, N if n_valid is None else n_valid
        )
    o, p = fused_qkv_attention_fwd_stash(_torch(qkv, dtype), H, n_valid)
    assert o.shape == (B, N, C) and p.shape == (B, H, N, N)
    assert o.dtype == p.dtype == getattr(torch, dtype)
    p_ref = _np(p_ref)
    assert p_ref.shape[-1] >= N  # JAX pads N to a multiple of 8; the port does not
    np.testing.assert_allclose(_np(p), p_ref[:, :, :N, :N], atol=P_TOL[dtype], rtol=0)
    rows = slice(None) if n_valid is None else slice(0, n_valid)
    np.testing.assert_allclose(_np(o)[:, rows], _np(o_ref)[:, rows], atol=O_TOL[dtype], rtol=O_TOL[dtype])
    if n_valid is not None:
        assert not _np(p)[..., n_valid:].any()  # masked keys hold 0
    # the stash changes nothing in O
    assert torch.equal(o, fused_qkv_attention_plain(_torch(qkv, dtype), H, n_valid))


@pytest.mark.parametrize("pcache", [True, False], ids=["from_p", "recompute"])
@pytest.mark.parametrize("n_valid", N_VALID)
@pytest.mark.parametrize("dtype", DTYPES)
def test_dqkv_matches_jax_vjp(dtype, n_valid, pcache, monkeypatch):
    if pcache:
        monkeypatch.delenv("VDK_ATTN_NO_PCACHE", raising=False)
    else:
        monkeypatch.setenv("VDK_ATTN_NO_PCACHE", "1")
    qkv, cot = _arrays(1)
    jdt = getattr(jnp, dtype)
    with force_interpret():
        _, vjp = jax.vjp(
            lambda x: jax_fused_qkv_attention(x, H, n_valid=n_valid), jnp.asarray(qkv, dtype=jdt)
        )
        (ref,) = vjp(jnp.asarray(cot, dtype=jdt))
    x = _torch(qkv, dtype).requires_grad_(True)
    out = fused_qkv_attention(x, H, n_valid)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "FusedQKVAttentionBackward"
    out.backward(_torch(cot, dtype))
    assert x.grad.dtype == x.dtype and x.grad.shape == x.shape
    got, ref = _np(x.grad), _np(ref)
    assert np.isfinite(got).all()
    tol = GRAD_TOL[dtype]
    np.testing.assert_allclose(got, ref, atol=tol, rtol=tol if dtype == "float32" else 0)


@pytest.mark.parametrize("n_valid", N_VALID)
def test_backward_plain_versions_agree_in_f32(n_valid):
    """From P and recompute are the same gradient in f32 (the JAX package's
    own check, test_no_pcache_fallback_grads_match, holds them to 1e-5)."""
    qkv, cot = _arrays(2)
    x, g = torch.from_numpy(qkv), torch.from_numpy(cot)
    _, p = fused_qkv_attention_fwd_stash(x, H, n_valid)
    a = fused_qkv_attention_bwd_from_p_plain(x, p, g, H)
    b = fused_qkv_attention_bwd_recompute_plain(x, g, H, n_valid)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("pcache", [True, False], ids=["from_p", "recompute"])
@pytest.mark.parametrize("n_valid", [None, 4])
def test_autograd_function_gradcheck_f64(n_valid, pcache, monkeypatch):
    if pcache:
        monkeypatch.delenv("VDK_ATTN_NO_PCACHE", raising=False)
    else:
        monkeypatch.setenv("VDK_ATTN_NO_PCACHE", "1")
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 6, 3 * 2 * 4), generator=gen, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda t: FusedQKVAttention.apply(t, 2, n_valid or 6), (x,))


def test_no_grad_runs_the_no_stash_forward():
    qkv, _ = _arrays(3)
    x = torch.from_numpy(qkv).requires_grad_(True)
    with torch.no_grad():
        out = fused_qkv_attention(x, H)
    assert out.grad_fn is None
    np.testing.assert_array_equal(out.numpy(), fused_qkv_attention_plain(x.detach(), H).numpy())


def test_attention_module_gradient_reaches_the_qkv_projection():
    """The fused branch is differentiable on every device: the qkv weight gets
    a gradient through the attention core, not only via a residual path."""
    torch.manual_seed(0)
    mod = Attention(C, H).train()
    x = torch.randn(B, N, C, requires_grad=True)
    mod(x).square().sum().backward()
    g = mod.qkv.weight.grad
    assert g is not None and torch.isfinite(g).all() and g.abs().sum() > 0
    # the q and k rows of the projection get gradient only through the softmax
    assert g[: 2 * C].abs().sum() > 0


def test_cpu_wrappers_run_plain_versions_without_counting():
    qkv, cot = _arrays(4)
    x, g = torch.from_numpy(qkv), torch.from_numpy(cot)
    before = [k.launches for k in KERNELS]
    out = fused_qkv_attention(x.clone().requires_grad_(True), H, n_valid=30)
    out.backward(g)
    _, p = fused_qkv_attention_fwd_stash(x, H, 30)
    np.testing.assert_array_equal(
        fused_qkv_attention_bwd_from_p(x, p, g, H).numpy(),
        fused_qkv_attention_bwd_from_p_plain(x, p, g, H).numpy(),
    )
    np.testing.assert_array_equal(
        fused_qkv_attention_bwd_recompute(x, g, H, 30).numpy(),
        fused_qkv_attention_bwd_recompute_plain(x, g, H, 30).numpy(),
    )
    assert [k.launches for k in KERNELS] == before


@pytest.mark.parametrize(
    "p_shape,do_shape,p_dtype,err",
    [
        ((B, H, N, N - 1), (B, N, C), torch.float32, ValueError),  # P not [B, H, N, N]
        ((B, H, N, N), (B, N, C + 1), torch.float32, ValueError),  # dO not [B, N, C]
        ((B, H, N, N), (B, N, C), torch.float64, TypeError),       # P of another dtype
    ],
)
def test_backward_wrappers_reject_what_the_kernels_do_not_take(p_shape, do_shape, p_dtype, err):
    x = torch.zeros((B, N, 3 * C))
    with pytest.raises(err):
        fused_qkv_attention_bwd_from_p(x, torch.zeros(p_shape, dtype=p_dtype), torch.zeros(do_shape), H)
    if do_shape != (B, N, C):
        with pytest.raises(err):
            fused_qkv_attention_bwd_recompute(x, torch.zeros(do_shape), H)
