"""The rounding points of the bf16 tensor-core attention kernels, modelled in
plain PyTorch and held to a quarter of chip_smoke.py's bf16 bars.

``csrc/fused_qkv_attention{,_bwd}.cu`` run their products on the tensor cores
with bf16 operands and f32 accumulation. That rounds some values the plain
versions (``ops/attention.py``, the reference kernel's arithmetic) keep in
f32. The model below rounds at exactly the kernels' points:

- forward: S is the f32 product of the bf16 q and k, scaled by
  scale·log2(e) after the product (the plain version scales the upcast q
  first); P = exp2(S − rowmax)·(1 / rowsum) is rounded to bf16 before P·V,
  as the plain version does; O accumulates in f32 and rounds to bf16;
- backward: dS, and the recomputed P, are split into bf16 hi + lo = bf16(x −
  hi) before their products (dQ = dS·k, dK = dSᵀ·q, dV = Pᵀ·dO), so each
  product carries them to about 16 bits; the stashed P is bf16 already;
  scale multiplies dQ and dK after the sum over keys or queries.

It runs at ViT-B/16's head shape (N = 197, d = 64), at N = 37 with
``n_valid`` = 29, and at d = 80, against the plain versions, with chip_smoke's
error measures: O max |err| ≤ 1.6e-2 / 4, P ≤ 2⁻⁸ / 4, dqkv |err| ≤ 1.6e-2 / 4
· max(1, |plain|). A rounding choice that could fail the card's check fails
here first: one bf16 operand for dS instead of the split does (last test).
"""

import math

import numpy as np
import pytest
import torch

from visiondk_tpu_torch.ops.attention import (
    fused_qkv_attention_bwd_from_p_plain,
    fused_qkv_attention_bwd_recompute_plain,
    fused_qkv_attention_fwd_stash_plain,
    fused_qkv_attention_plain,
)

LOG2E = 1.4426950408889634
BF16 = torch.bfloat16
# a quarter of chip_smoke.py's bf16 bars: TOL (O, dqkv scaled) and P_TOL
O_TOL = 1.6e-2 / 4
P_TOL = 2.0**-8 / 4

# (name, B, N, heads, head_dim, n_valid)
CASES = [
    ("vit_b16_head", 2, 197, 3, 64, None),
    ("n37_masked", 4, 37, 4, 32, 29),
    ("hd80", 2, 65, 2, 80, 60),
]


def _inputs(b, n, h, d, seed):
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.normal(size=(b, n, 3 * h * d)).astype(np.float32)).to(BF16)
    dout = torch.from_numpy(rng.normal(size=(b, n, h * d)).astype(np.float32)).to(BF16)
    return qkv, dout


def _heads(qkv, h):
    b, n, w = qkv.shape
    q, k, v = qkv.float().reshape(b, n, 3, h, w // (3 * h)).permute(2, 0, 3, 1, 4)
    return q, k, v


def _bf(x):
    return x.to(BF16).float()


def _product(a, b, split: bool):
    """a · b with a as the kernel's bf16 A operand: one bf16 rounding, or
    hi + lo (two products)."""
    hi = _bf(a)
    if not split:
        return hi @ b
    return hi @ b + _bf(a - hi) @ b


def _scores(q, k, n_valid):
    """log2-domain scores as the kernel forms them: f32 product, then scaled."""
    s = (q @ k.transpose(-1, -2)) * (q.shape[-1] ** -0.5 * LOG2E)
    s[..., n_valid:] = -1e30
    return s


def _softmax2(s):
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp2(s - m)
    return e * (1.0 / e.sum(dim=-1, keepdim=True))


def _to_qkv(dq, dk, dv):
    b, h, n, d = dq.shape
    return torch.stack((dq, dk, dv)).permute(1, 3, 0, 2, 4).reshape(b, n, 3 * h * d).to(BF16)


def model_forward(qkv, h, n_valid):
    """(O [B, N, C], P [B, H, N, N]) in bf16, rounded where the kernel rounds."""
    q, k, v = _heads(qkv, h)
    b, _, n, d = q.shape
    p = _softmax2(_scores(q, k, n_valid)).to(BF16)
    o = (p.float() @ v).to(BF16)
    return o.transpose(1, 2).reshape(b, n, h * d), p


def model_backward(qkv, dout, h, n_valid, p_stash=None, split=True):
    """dqkv [B, N, 3C] in bf16: recompute (``p_stash`` None) or from the stash."""
    q, k, v = _heads(qkv, h)
    b, _, n, d = q.shape
    scale = d**-0.5
    do = dout.float().reshape(b, n, h, d).transpose(1, 2)
    if p_stash is None:
        p = _softmax2(_scores(q, k, n_valid))  # f32, not rounded
        dv = _product(p.transpose(-1, -2), do, split)
    else:
        p = p_stash.float()
        dv = p.transpose(-1, -2) @ do  # bf16 values: no rounding in the operand
    dp = do @ v.transpose(-1, -2)
    delta = (p * dp).sum(dim=-1, keepdim=True)  # from the same P, never rowsum(dO o O)
    ds = p * (dp - delta)
    dq = _product(ds, k, split) * scale
    dk = _product(ds.transpose(-1, -2), q, split) * scale
    return _to_qkv(dq, dk, dv)


def _scaled_err(out, ref):
    out, ref = out.float(), ref.float()
    return ((out - ref).abs() / ref.abs().clamp_min(1.0)).max().item()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_forward_rounding_within_a_quarter_of_the_bars(case):
    _, b, n, h, d, n_valid = case
    rows = n if n_valid is None else n_valid
    qkv, _ = _inputs(b, n, h, d, seed=n)
    o, p = model_forward(qkv, h, n if n_valid is None else n_valid)
    o_ref = fused_qkv_attention_plain(qkv, h, n_valid)
    o_plain, p_ref = fused_qkv_attention_fwd_stash_plain(qkv, h, n_valid)
    assert torch.equal(o_plain, o_ref)
    o_err = (o[:, :rows].float() - o_ref[:, :rows].float()).abs().max().item()
    p_err = (p.float() - p_ref.float()).abs().max().item()
    assert o_err <= O_TOL, f"O {o_err} > {O_TOL}"
    assert p_err <= P_TOL, f"P {p_err} > {P_TOL}"
    if n_valid is not None:
        assert not p[..., n_valid:].any()  # exactly 0 at masked keys


@pytest.mark.parametrize("variant", ["recompute", "from_p"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_backward_rounding_within_a_quarter_of_the_bar(case, variant):
    _, b, n, h, d, n_valid = case
    qkv, dout = _inputs(b, n, h, d, seed=n + 1)
    nv = n if n_valid is None else n_valid
    if variant == "recompute":
        out = model_backward(qkv, dout, h, nv)
        ref = fused_qkv_attention_bwd_recompute_plain(qkv, dout, h, n_valid)
    else:
        _, p = fused_qkv_attention_fwd_stash_plain(qkv, h, n_valid)
        out = model_backward(qkv, dout, h, nv, p_stash=p)
        ref = fused_qkv_attention_bwd_from_p_plain(qkv, p, dout, h)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert torch.isfinite(out.float()).all()
    err = _scaled_err(out, ref)
    assert err <= O_TOL, f"dqkv {err} > {O_TOL} of max(1, |plain|)"


def test_split_keeps_dS_to_sixteen_bits():
    x = torch.randn(64, 64) * 3
    hi = _bf(x)
    lo = _bf(x - hi)
    rel = ((hi + lo - x).abs() / x.abs()).max().item()
    assert rel <= 2.0**-16 and ((hi - x).abs() / x.abs()).max().item() > 2.0**-10


def test_single_bf16_operand_would_exceed_the_quarter_bar():
    """The reason for the split: with dS and the recomputed P rounded once to
    bf16, the backward at N = 37 lands above a quarter of the bar."""
    _, b, n, h, d, n_valid = CASES[1]
    errs = []
    for seed in range(3):
        qkv, dout = _inputs(b, n, h, d, seed=100 + seed)
        ref = fused_qkv_attention_bwd_recompute_plain(qkv, dout, h, n_valid)
        errs.append(_scaled_err(model_backward(qkv, dout, h, n_valid, split=False), ref))
    assert max(errs) > O_TOL and math.isfinite(max(errs))
