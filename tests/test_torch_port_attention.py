"""visiondk_tpu_torch.ops.attention against the JAX package's fused attention.

The port's plain ``fused_qkv_attention`` (what the wrapper runs for a CPU
tensor, and what the CUDA kernel is held to on the card) is compared with the
JAX ``fused_qkv_attention`` run through its Pallas kernel in interpret mode,
as tests/test_pallas_attention.py runs it. The port's ``Attention`` module is
compared with the JAX ``Attention`` module's einsum path on bridged weights.
Inputs come from a numpy seed and go to both frameworks as the same arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visiondk_tpu.models.layers import Attention as JaxAttention
from visiondk_tpu.ops.pallas import force_interpret
from visiondk_tpu.ops.pallas import fused_qkv_attention as jax_fused_qkv_attention
from visiondk_tpu_torch.models.convert import load_jax_params
from visiondk_tpu_torch.models.layers import Attention
from visiondk_tpu_torch.ops.attention import (
    fused_qkv_attention, fused_qkv_attention_fwd, fused_qkv_attention_plain,
)

B, N, H, D = 2, 37, 4, 32  # N deliberately unaligned
C = H * D

# f32: the algorithm, compared at 1e-4 (the JAX kernel test's tolerance).
# bf16: P and O round to bf16 in both; 1.6e-2 is about two bf16 ulps at |o| ≈ 1.
TOL = {"float32": 1e-4, "bfloat16": 1.6e-2}


def _qkv(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(B, N, 3 * C)).astype(np.float32)


def _jax_fused(qkv: np.ndarray, dtype: str, n_valid=None) -> np.ndarray:
    with force_interpret():
        o = jax_fused_qkv_attention(jnp.asarray(qkv, dtype=getattr(jnp, dtype)), H, n_valid=n_valid)
    return np.asarray(o.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_fused_kernel(dtype):
    qkv = _qkv(0)
    ref = _jax_fused(qkv, dtype)
    out = fused_qkv_attention_plain(torch.from_numpy(qkv).to(getattr(torch, dtype)), H)
    assert out.shape == (B, N, C) and out.dtype == getattr(torch, dtype)
    tol = TOL[dtype]
    np.testing.assert_allclose(out.float().numpy(), ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_fused_kernel_n_valid(dtype):
    n_valid = 29
    qkv = _qkv(1)
    ref = _jax_fused(qkv, dtype, n_valid=n_valid)
    out = fused_qkv_attention_plain(torch.from_numpy(qkv).to(getattr(torch, dtype)), H, n_valid)
    tol = TOL[dtype]
    # rows >= n_valid are finite values no caller reads
    assert torch.isfinite(out.float()).all()
    np.testing.assert_allclose(out[:, :n_valid].float().numpy(), ref[:, :n_valid], atol=tol, rtol=tol)


def test_masked_keys_do_not_reach_valid_rows():
    n_valid = 29
    qkv = _qkv(2)
    base = fused_qkv_attention_plain(torch.from_numpy(qkv), H, n_valid)
    noisy = qkv.copy()
    noisy[:, n_valid:, C:] = 1e3  # garbage in the masked keys and values
    out = fused_qkv_attention_plain(torch.from_numpy(noisy), H, n_valid)
    np.testing.assert_array_equal(out[:, :n_valid].numpy(), base[:, :n_valid].numpy())


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    qkv = torch.from_numpy(_qkv(3))
    before = fused_qkv_attention_fwd.launches
    out = fused_qkv_attention(qkv, H, n_valid=30)
    np.testing.assert_array_equal(out.numpy(), fused_qkv_attention_plain(qkv, H, 30).numpy())
    assert fused_qkv_attention_fwd.launches == before


@pytest.mark.parametrize(
    "shape,heads,n_valid,err",
    [
        ((B, N, 3 * C + 1), H, None, ValueError),  # width not 3·heads·d
        ((B, 3 * C), H, None, ValueError),          # not [B, N, 3C]
        ((B, N, 3 * C), H, 0, ValueError),          # n_valid < 1
        ((B, N, 3 * C), H, N + 1, ValueError),      # n_valid > N
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(shape, heads, n_valid, err):
    with pytest.raises(err):
        fused_qkv_attention(torch.zeros(shape), heads, n_valid)


def test_wrapper_rejects_devices_other_than_cuda_and_cpu():
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_qkv_attention(torch.zeros((B, N, 3 * C), device="meta"), H)


@pytest.mark.parametrize("n_valid", [None, 29])
def test_attention_module_matches_jax_einsum_path(n_valid):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    jax_mod = JaxAttention(H, n_valid=n_valid)
    variables = jax_mod.init(jax.random.key(0), jnp.asarray(x))
    # non-trivial biases: re-draw every parameter from the numpy seed
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(0.1 * rng.normal(size=p.shape).astype(np.float32)), variables["params"]
    )
    ref = np.asarray(jax_mod.apply({"params": params}, jnp.asarray(x)))

    tree = {"params": {f"{m}/{k}": np.asarray(v) for m in params for k, v in params[m].items()}}
    port = load_jax_params(Attention(C, H, n_valid=n_valid), tree).eval()
    with torch.inference_mode():
        out = port(torch.from_numpy(x)).numpy()
    rows = slice(None) if n_valid is None else slice(0, n_valid)
    np.testing.assert_allclose(out[:, rows], ref[:, rows], atol=1e-4, rtol=1e-4)
