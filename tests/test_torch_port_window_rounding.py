"""The rounding points of the bf16 tensor-core window kernels, modelled in
plain PyTorch and held to a quarter of chip_smoke.py's bf16 bars.

``csrc/fused_window_attention.cu`` (the forward) and
``csrc/fused_window_attention_bwd.cu`` (the backward) run their products on
the tensor cores with bf16 operands and f32 accumulation. The forward rounds
where the plain version (``ops/window_attention.py``, the reference kernel's
arithmetic) rounds, but scales the scores after the product:

- S is the f32 sum of the bf16 products q·kᵀ, times scale·log2(e), plus
  bias·log2(e) and the −100·log2(e) region mask (the plain version scales q
  first: a last-bit difference in S);
- P = exp2(S − rowmax) · (1 / rowsum) is rounded once to bf16;
- O is the f32 sum of the bf16 P times the bf16 V, then rounded.

A last-bit difference in S flips P's bf16 rounding by one ulp now and then;
P's bar is 2⁻⁸, one ulp at p ≤ 1, and O is held to a quarter of its bar
before its last rounding (the same half-bar flips as below) and to the full
bar after it.

The backward rounds some values the plain versions keep in f32. The model
below rounds at exactly the kernel's points:

- q, k, v and dO are the bf16 inputs; every product sums in f32;
- the stashed P is bf16 already and multiplies as it is;
- the recomputed P (S = the f32 product q·kᵀ, scaled by scale·log2(e) after
  it, plus bias·log2(e) and the −100·log2(e) region mask) and dS are split
  into bf16 hi + lo = bf16(x − hi) before their products (dV = Pᵀ·dO,
  dQ = dS·k, dK = dSᵀ·q), so each product carries them to about 16 bits;
- scale multiplies dQ and dK after the sum; dbias sums dS in f32.

The kernels' tiled bodies for 8 < ws ≤ 16 round at the same points: S, P,
O, dS and the split are formed the same way; only the row sum of exp2 runs
over tiles of keys (a running max per thread, rescaled), another f32 order.

It runs at Swin's window (N = 49, d = 32) unshifted and shifted, at ws 8
with d 64 and scale 1.0 (SwinV2's call), and at ws 16 (N = 256, d 32,
shifted by 8, scale 1.0: swinv2_large_window12to16_192to256's stage 0, on the
tiled bodies), against the plain versions, with
chip_smoke's error measures. The bars are a quarter of chip_smoke's: dqkv
1.6e-2 / 4 of max(1, |plain|), dbias 1e-4 / 4 of max(1, max |plain|). The
dqkv bar holds the f32 values before the last rounding to bf16: that
rounding flips one bf16 ulp wherever the two f32 sums straddle a rounding
point, which is up to 2⁻⁷ of max(1, |plain|) (half the bar) at |x| just
above 2 whatever the operands' rounding (7.8e-3 in chip_smoke's phase 3w on
an H100), so the rounded outputs are held to chip_smoke's full bar. A single
bf16 rounding of dS and the recomputed P instead of the split would not
hold: it breaks the quarter bar at N = 49 and the full bar at ws 8 (last
test).
"""

import numpy as np
import pytest
import torch

from visiondk_tpu_torch.models.backbones.swin import window_region_ids
from visiondk_tpu_torch.ops import window_attention as W

LOG2E = 1.4426950408889634
BF16 = torch.bfloat16
TOL = 1.6e-2  # chip_smoke.py's bf16 bar on O (absolute) and on dqkv (of max(1, |plain|))
P_TOL = 2.0**-8  # chip_smoke.py's bf16 bar on P
DQKV_TOL = TOL / 4
DBIAS_TOL = 1e-4 / 4  # of max(1, max |plain|)

# (name, B, H = W, heads, C, ws, shift, scale)
CASES = [
    ("swin_n49", 4, 14, 2, 64, 7, 0, None),
    ("swin_n49_shifted", 4, 14, 2, 64, 7, 3, None),
    ("ws8_scale1", 2, 16, 2, 128, 8, 4, 1.0),
    ("ws16_n256_shifted_scale1", 1, 32, 2, 64, 16, 8, 1.0),
]


def _inputs(case):
    _, b, hw, heads, c, ws, shift, _ = case
    n = ws * ws
    rng = np.random.default_rng(hw + shift)
    qkv = torch.from_numpy(rng.normal(size=(b, hw, hw, 3 * c)).astype(np.float32)).to(BF16)
    dout = torch.from_numpy(rng.normal(size=(b, hw, hw, c)).astype(np.float32)).to(BF16)
    bias = torch.from_numpy((0.5 * rng.normal(size=(heads, n, n))).astype(np.float32))
    ids = torch.from_numpy(window_region_ids(hw, hw, ws, shift)) if shift else None
    return qkv, dout, bias, ids


def _bf(x):
    return x.to(BF16).float()


def _product(a, b, split: bool):
    """a · b with a as the kernel's bf16 A operand: one bf16 rounding, or
    hi + lo (two products)."""
    hi = _bf(a)
    if not split:
        return hi @ b
    return hi @ b + _bf(a - hi) @ b


def _kernel_probs(q, k, bias, ids, sc):
    """P in f32, not rounded, from S = the f32 product q·kᵀ scaled after the
    sum, + bias·log2(e) [+ the region mask], as both kernels form it."""
    s = (q @ k.transpose(-1, -2)) * (sc * LOG2E) + bias * LOG2E
    if ids is not None:
        apart = ids[:, :, None] != ids[:, None, :]
        s = s + torch.where(apart, -100.0 * LOG2E, 0.0)[None, :, None]
    e = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    return e * (1.0 / e.sum(dim=-1, keepdim=True))


def model_forward(qkv, bias, ids, heads, scale=None, out_dtype=BF16):
    """(O [B, H, W, C] in ``out_dtype``, P [B, nW, heads, N, N] bf16), rounded
    where the tensor-core forward rounds: P once to bf16, O after its f32 sum."""
    n = bias.shape[-1]
    _, hh, ww, _, d, ws, _ = W._layout(qkv, heads, n, ids)
    q, k, v = (t.float() for t in W._split(qkv, ws, heads, d))
    p = _kernel_probs(q, k, bias, ids, d**-0.5 if scale is None else scale).to(BF16)
    return W._merge([p.float() @ v], ws, hh, ww, out_dtype), p


def model_backward(qkv, dout, bias, ids, heads, scale=None, p_stash=None, split=True, out_dtype=BF16):
    """(dqkv [B, H, W, 3C] in ``out_dtype``, dbias [heads, N, N] f32), rounded
    where the kernel rounds: recompute (``p_stash`` None) or from the stash."""
    n = bias.shape[-1]
    _, hh, ww, _, d, ws, _ = W._layout(qkv, heads, n, ids)
    q, k, v = (t.float() for t in W._split(qkv, ws, heads, d))
    do = W._split(dout, ws, heads, d)[0].float()
    sc = d**-0.5 if scale is None else scale
    if p_stash is None:
        p = _kernel_probs(q, k, bias, ids, sc)  # f32, not rounded
        dv = _product(p.transpose(-1, -2), do, split)
    else:
        p = p_stash.float()
        dv = p.transpose(-1, -2) @ do  # bf16 values: no rounding in the operand
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = _product(ds, k, split) * sc
    dk = _product(ds.transpose(-1, -2), q, split) * sc
    return W._merge([dq, dk, dv], ws, hh, ww, out_dtype), ds.sum(dim=(0, 1))


def _plain(variant, qkv, dout, bias, ids, heads, scale, p):
    """The plain version's (dqkv, dbias); with f32 inputs holding the same
    bf16 values it gives its dqkv before the last rounding."""
    if variant == "recompute":
        return W.fused_window_attention_bwd_recompute_plain(qkv, bias, ids, dout, heads, scale)
    return W.fused_window_attention_bwd_from_p_plain(qkv, p, dout, heads, scale)


def _scaled_err(out, ref):
    out, ref = out.float(), ref.float()
    return ((out - ref).abs() / ref.abs().clamp_min(1.0)).max().item()


def _both(case, variant, split=True):
    """The model's and the plain version's results: dqkv in bf16 and in f32
    before the last rounding, and dbias."""
    _, _, _, heads, _, _, _, scale = case
    qkv, dout, bias, ids = _inputs(case)
    p = None
    if variant == "from_p":
        _, p = W.fused_window_attention_fwd_stash_plain(qkv, bias, ids, heads, scale)
    ref, ref_db = _plain(variant, qkv, dout, bias, ids, heads, scale, p)
    ref32, _ = _plain(variant, qkv.float(), dout.float(), bias, ids, heads, scale, None if p is None else p.float())
    assert torch.equal(ref32.to(BF16), ref)  # the f32 plain version is the bf16 one before its last rounding
    out, out_db = model_backward(qkv, dout, bias, ids, heads, scale, p, split)
    out32, _ = model_backward(qkv, dout, bias, ids, heads, scale, p, split, torch.float32)
    return (out, out32, out_db), (ref, ref32, ref_db)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_forward_rounding_within_a_quarter_of_the_bars(case):
    """O and P of the model against the plain stash forward: P within 2⁻⁸, O
    before its last rounding within a quarter of the bar, O within the bar."""
    _, _, hh, heads, _, ws, _, scale = case
    qkv, _, bias, ids = _inputs(case)
    ref, ref_p = W.fused_window_attention_fwd_stash_plain(qkv, bias, ids, heads, scale)
    v = W._split(qkv, ws, heads, qkv.shape[-1] // (3 * heads))[2].float()
    ref32 = W._merge([ref_p.float() @ v], ws, hh, hh, torch.float32)
    assert torch.equal(ref32.to(BF16), ref)  # the plain version's O before its last rounding
    out, p = model_forward(qkv, bias, ids, heads, scale)
    out32, _ = model_forward(qkv, bias, ids, heads, scale, torch.float32)
    assert out.shape == ref.shape and out.dtype == ref.dtype and p.shape == ref_p.shape and p.dtype == BF16
    assert torch.isfinite(out32).all()
    p_err = (p.float() - ref_p.float()).abs().max().item()
    assert p_err <= P_TOL, f"P {p_err} > {P_TOL}"
    err32 = (out32 - ref32).abs().max().item()
    assert err32 <= TOL / 4, f"O before rounding {err32} > {TOL / 4}"
    assert (out.float() - ref.float()).abs().max().item() <= TOL


@pytest.mark.parametrize("variant", ["recompute", "from_p"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_backward_rounding_within_a_quarter_of_the_bars(case, variant):
    (out, out32, out_db), (ref, ref32, ref_db) = _both(case, variant)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert torch.isfinite(out32).all() and torch.isfinite(out_db).all()
    err32 = _scaled_err(out32, ref32)
    assert err32 <= DQKV_TOL, f"dqkv before rounding {err32} > {DQKV_TOL} of max(1, |plain|)"
    assert _scaled_err(out, ref) <= TOL
    db_err = (out_db - ref_db).abs().max().item() / max(1.0, ref_db.abs().max().item())
    assert db_err <= DBIAS_TOL, f"dbias {db_err} > {DBIAS_TOL} of max(1, |plain|)"


def test_rounded_outputs_flip_by_up_to_half_the_bar():
    """Why the quarter bar holds the values before the last rounding: one
    ulp at |x| just above 2 is 2⁻⁶, 2⁻⁷ of |x|, and such flips occur here."""
    (out, _, _), (ref, _, _) = _both(CASES[2], "from_p")
    assert 2.0**-8 < _scaled_err(out, ref) <= 2.0**-7


@pytest.mark.parametrize("case", [CASES[0], CASES[2]], ids=[CASES[0][0], CASES[2][0]])
def test_single_bf16_operand_would_not_hold(case):
    """The reason for the split: with dS and the recomputed P rounded once to
    bf16, the values before the last rounding land above a quarter of the
    bar at N = 49, and at ws 8 with scale 1.0 the outputs break the full
    bar."""
    (out, out32, _), (ref, ref32, _) = _both(case, "recompute", split=False)
    assert _scaled_err(out32, ref32) > DQKV_TOL
    if case[5] == 8:
        assert _scaled_err(out, ref) > TOL
