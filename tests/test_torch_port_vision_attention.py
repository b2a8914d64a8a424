"""visiondk_tpu_torch.ops.attention.vision_attention against the JAX package.

The port's ``vision_attention`` (q, k, v [B, H, N, D] → [B, H, N, D]) and its
two wrappers (what the CUDA kernels compute, and what the wrappers run for a
CPU tensor) are compared with the JAX op ``vision_attention`` run through its
Pallas kernels in interpret mode, as tests/test_pallas_attention.py runs
them. Inputs and cotangents come from a numpy seed and go to both frameworks
as the same arrays. The JAX wrapper pads N up to a multiple of 128 and masks
the padded keys; the port computes exactly N, which is the same result.

Tolerances. f32: 1e-4, the JAX kernel test's (the algorithm is the same;
only f32 summation order differs). bf16: O within 1.6e-2 (P and O round to
bf16 in both; about two bf16 ulps at |o| ≈ 1); dq, dk, dv within 2e-2
absolute, the bound the JAX package holds its own bf16 backward to
(tests/test_pallas_attention.py:419-470, BASELINE.md "bf16 p-cache backward
deviation").
"""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visiondk_tpu.ops.pallas import force_interpret
from visiondk_tpu.ops.pallas import vision_attention as jax_vision_attention
from visiondk_tpu_torch.losses import create_lossfn
from visiondk_tpu_torch.models import BACKBONES, get_model
from visiondk_tpu_torch.models.backbones.vit import _vit
from visiondk_tpu_torch.ops import vision_attention
from visiondk_tpu_torch.ops.attention import (
    KERNELS,
    VisionAttention,
    vision_attention_bwd,
    vision_attention_bwd_plain,
    vision_attention_fwd,
    vision_attention_plain,
)

SHAPES = [(2, 3, 50, 32), (2, 4, 128, 64), (1, 2, 197, 64), (1, 2, 37, 128)]
DTYPES = ["float32", "bfloat16"]
O_TOL = {"float32": 1e-4, "bfloat16": 1.6e-2}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TINY = "vit_tiny_patch8_port_vision_test"
IMG = 32


def _chip_smoke():
    """The repository's chip_smoke.py, whose helper routes a ViT's attention
    cores through vision_attention (it runs nothing when imported)."""
    if "chip_smoke" not in sys.modules:
        path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
        spec = importlib.util.spec_from_file_location("chip_smoke", path)
        module = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke"] = module  # its dataclass resolves annotations through it
        spec.loader.exec_module(module)
    return sys.modules["chip_smoke"]


def _arrays(seed: int, shape, count: int):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(count)]


def _torch(a: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t.astype(jnp.float32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_forward_matches_jax(shape, dtype):
    q, k, v = _arrays(0, shape, 3)
    jdt = getattr(jnp, dtype)
    with force_interpret():
        ref = jax_vision_attention(*(jnp.asarray(a, dtype=jdt) for a in (q, k, v)))
    out = vision_attention(*(_torch(a, dtype) for a in (q, k, v)))
    assert out.shape == shape and out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(out), _np(ref), atol=O_TOL[dtype], rtol=O_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_grads_match_jax_vjp(shape, dtype):
    q, k, v, cot = _arrays(1, shape, 4)
    jdt = getattr(jnp, dtype)
    with force_interpret():
        _, vjp = jax.vjp(jax_vision_attention, *(jnp.asarray(a, dtype=jdt) for a in (q, k, v)))
        refs = vjp(jnp.asarray(cot, dtype=jdt))
    xs = [_torch(a, dtype).requires_grad_(True) for a in (q, k, v)]
    out = vision_attention(*xs)
    assert type(out.grad_fn).__name__ == "VisionAttentionBackward"
    out.backward(_torch(cot, dtype))
    tol = GRAD_TOL[dtype]
    for x, ref, what in zip(xs, refs, ("dq", "dk", "dv")):
        assert x.grad.dtype == x.dtype and x.grad.shape == shape, what
        got = _np(x.grad)
        assert np.isfinite(got).all(), what
        np.testing.assert_allclose(got, _np(ref), atol=tol, rtol=tol if dtype == "float32" else 0, err_msg=what)


def test_autograd_function_gradcheck_f64():
    gen = torch.Generator().manual_seed(3)
    xs = [torch.randn((2, 2, 6, 4), generator=gen, dtype=torch.float64, requires_grad=True) for _ in range(3)]
    assert torch.autograd.gradcheck(VisionAttention.apply, xs)


def test_strided_packed_views_equal_contiguous_copies():
    """q, k, v as views of one packed [B, N, 3C] buffer (no copy) and dO as
    the [B, H, N, D] view of [B, N, C] give what contiguous copies give."""
    b, n, h, d = 2, 37, 3, 16
    qkv_np, cot_np = _arrays(2, (b, n, 3 * h * d), 1)[0], _arrays(3, (b, n, h, d), 1)[0]
    qkv = torch.from_numpy(qkv_np)
    q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
    dout = torch.from_numpy(cot_np).transpose(1, 2)
    assert not q.is_contiguous() and q.data_ptr() == qkv.data_ptr() and not dout.is_contiguous()
    copies = [t.contiguous() for t in (q, k, v, dout)]
    torch.testing.assert_close(vision_attention_fwd(q, k, v), vision_attention_fwd(*copies[:3]), rtol=1e-6, atol=1e-6)
    for g, g_ref in zip(vision_attention_bwd(q, k, v, dout), vision_attention_bwd(*copies)):
        torch.testing.assert_close(g, g_ref, rtol=1e-6, atol=1e-6)
    # through autograd, the gradient lands in the packed buffer
    leaf = qkv.clone().requires_grad_(True)
    out = vision_attention(*leaf.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4))
    out.backward(dout)
    want = torch.stack(vision_attention_bwd(*copies)).permute(1, 3, 0, 2, 4).reshape(b, n, 3 * h * d)
    torch.testing.assert_close(leaf.grad, want, rtol=1e-6, atol=1e-6)


def test_no_grad_runs_the_no_grad_forward():
    xs = [torch.from_numpy(a).requires_grad_(True) for a in _arrays(4, (2, 3, 20, 8), 3)]
    with torch.no_grad():
        out = vision_attention(*xs)
    assert out.grad_fn is None
    np.testing.assert_array_equal(out.numpy(), vision_attention_plain(*(x.detach() for x in xs)).numpy())
    out = vision_attention(*(x.detach() for x in xs))  # grad mode on, nothing requires grad
    assert out.grad_fn is None


def test_cpu_wrappers_run_plain_versions_without_counting():
    q, k, v, dout = (torch.from_numpy(a) for a in _arrays(5, (2, 3, 20, 8), 4))
    before = [kk.launches for kk in KERNELS]
    out = vision_attention(*(t.clone().requires_grad_(True) for t in (q, k, v)))
    out.backward(dout)
    np.testing.assert_array_equal(vision_attention_fwd(q, k, v).numpy(), vision_attention_plain(q, k, v).numpy())
    for g, g_ref in zip(vision_attention_bwd(q, k, v, dout), vision_attention_bwd_plain(q, k, v, dout)):
        np.testing.assert_array_equal(g.numpy(), g_ref.numpy())
    assert [kk.launches for kk in KERNELS] == before
    assert vision_attention_fwd in KERNELS and vision_attention_bwd in KERNELS


@pytest.mark.parametrize(
    "k_shape,k_dtype,err",
    [
        ((2, 3, 20, 9), torch.float32, ValueError),   # k of another shape
        ((2, 3, 20, 8), torch.float64, TypeError),    # k of another dtype
        ((6, 20, 8), torch.float32, ValueError),      # not [B, H, N, D]
    ],
)
def test_wrappers_reject_what_the_kernels_do_not_take(k_shape, k_dtype, err):
    q = torch.zeros((2, 3, 20, 8)) if len(k_shape) == 4 else torch.zeros(k_shape)
    k = torch.zeros(k_shape, dtype=k_dtype)
    for call in (lambda: vision_attention_fwd(q, k, q), lambda: vision_attention_bwd(q, k, q, q),
                 lambda: vision_attention(q, k, q)):
        with pytest.raises(err):
            call()


def test_backward_wrapper_rejects_a_mismatched_cotangent_and_device():
    q = torch.zeros((2, 3, 20, 8))
    with pytest.raises(ValueError):
        vision_attention_bwd(q, q, q, torch.zeros((2, 3, 20, 7)))
    with pytest.raises(TypeError):
        vision_attention_bwd(q, q, q, torch.zeros((2, 3, 20, 8), dtype=torch.bfloat16))
    meta = torch.zeros((2, 3, 20, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        vision_attention_fwd(meta, meta, meta)


@pytest.fixture()
def tiny_vit():
    BACKBONES.register(_vit(8, 64, 2, 4), name=TINY)
    yield {"task": "classification", "name": TINY, "num_classes": 7, "image_size": IMG}
    del BACKBONES._store[TINY]


def test_tiny_vit_through_vision_attention_matches_the_k1_path(tiny_vit):
    """A tiny ViT (patch 8, width 64, depth 2, 32×32) whose attention cores go
    through vision_attention by chip_smoke.py's own helper gives the K1
    path's loss and gradients in f32: the loss within 1e-5 relative and
    every gradient within 1e-3 of its tensor's largest entry, chip_smoke.py's
    bars (the paths differ in f32 rounding only)."""
    chip_smoke = _chip_smoke()
    rng = np.random.default_rng(6)
    images = torch.from_numpy(rng.normal(size=(4, IMG, IMG, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 7, size=4))
    lossfn = create_lossfn("ce", label_smooth=0.05)
    before = [kk.launches for kk in KERNELS]
    sides = {}
    for name, set_path in (chip_smoke.KERNEL_PATH, chip_smoke.VISION_PATH):
        model = get_model(tiny_vit, device="cpu", generator=torch.Generator().manual_seed(0))
        set_path(model)
        loss = lossfn(model(images), labels)
        loss.backward()
        sides[name] = (loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()})
    (lk, gk), (lv, gv) = sides["kernel"], sides["vision"]
    assert abs(lv - lk) <= 1e-5 * abs(lk)
    assert gv.keys() == gk.keys()
    for n in gk:
        assert torch.isfinite(gv[n]).all(), n
        assert (gv[n] - gk[n]).abs().max() <= 1e-3 * gk[n].abs().max(), n
    assert all(gv[n].abs().sum() > 0 for n in gv if n.endswith("attn.qkv.weight"))
    # the helper really replaced the attention core, and gives the block its own forward back
    model = get_model(tiny_vit, device="cpu", generator=torch.Generator().manual_seed(0))
    chip_smoke.set_vision(model, True)
    attns = [m for m in model.modules() if isinstance(m, chip_smoke.Attention)]
    assert len(attns) == 2 and all("forward" in m.__dict__ for m in attns)
    chip_smoke.set_vision(model, False)
    assert not any("forward" in m.__dict__ for m in attns)
    assert [kk.launches for kk in KERNELS] == before


@pytest.mark.parametrize("op", ["fused_qkv", "window", "window_shifted"])
def test_library_yardstick_of_the_stash_forwards_returns_o_and_p(op):
    """The one PyTorch call chip_smoke.py times beside the P-stash forwards
    (SDPA's math backend) computes their function: O and P equal the plain
    versions' in f32 within 1e-5, on the views and windows chip_smoke.py
    gives it."""
    chip_smoke = _chip_smoke()
    rng = np.random.default_rng(7)
    if op == "fused_qkv":
        b, n, h, d = 2, 37, 3, 16
        qkv = torch.from_numpy(rng.normal(size=(b, n, 3 * h * d)).astype(np.float32))
        o, p = chip_smoke.math_attention(*chip_smoke.heads_view(qkv, h), transpose_to=(b, n, h * d))
        o_ref, p_ref = chip_smoke.fused_qkv_attention_fwd_stash_plain(qkv, h)
    else:
        b, hw, h, d, ws = 2, 8, 2, 8, 4
        shift = 2 if op == "window_shifted" else 0
        qkv = torch.from_numpy(rng.normal(size=(b, hw, hw, 3 * h * d)).astype(np.float32))
        dout = torch.from_numpy(rng.normal(size=(b, hw, hw, h * d)).astype(np.float32))
        bias = torch.from_numpy(rng.normal(size=(h, ws * ws, ws * ws)).astype(np.float32))
        ids = torch.from_numpy(chip_smoke.window_region_ids(hw, hw, ws, shift)) if shift else None
        library, _ = chip_smoke.window_library(qkv, bias, ids, dout, h, ws, None)
        o, p = library[chip_smoke.wattn.fused_window_attention_fwd_stash][0]()
        o_win, p_win = chip_smoke.wattn.fused_window_attention_fwd_stash_plain(qkv, bias, ids, h)
        n = ws * ws
        o_ref = chip_smoke.wattn.window_partition(o_win, ws).reshape(-1, n, h, d).transpose(1, 2)
        p_ref = p_win.reshape(-1, h, n, n)
    assert o.shape == o_ref.shape and p.shape == p_ref.shape
    assert (o - o_ref).abs().max() <= 1e-5
    assert (p - p_ref).abs().max() <= 1e-5
