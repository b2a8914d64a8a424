"""The window kernels' shift on the card (``-m card``; each test skips without
a CUDA card, decided inside it). Run on a machine with the card, from the root
of a checkout, with

    python3 -m pytest --noconftest -p no:cacheprovider -q -m card tests/test_torch_port_window_shift_card.py

(``--noconftest``: the tests directory's conftest sets up JAX's CPU mesh; this
file imports neither JAX nor the JAX package.)

- Each of K2, K2s, K2b and K2r handed a shift s reads and writes the rolled
  map in place: its result is, bit for bit, the same kernel's on the map
  rolled by −s, rolled back by +s (the same windows, the same arithmetic),
  and within ``chip_smoke.py``'s bars of its plain version (which rolls). At
  Swin-B's stage shapes (ws 7 shifted by 3), head dim 12 (element-by-element
  loads and stores), the tiled bodies at ws 16 shifted by 8 (one window a
  block, and runs of four across images) and ws 9 (the stash's rows not
  16-byte aligned), in f32 and bf16.
- The op through autograd, with and without ``VDK_ATTN_NO_PCACHE=1``: K2s and
  K2b, or K2 and K2r, each counted once in ``shifted_launches``.
- A Swin-B bs-2 bf16 forward and backward under ``torch.profiler``: no roll
  kernel, 11 shifted K2s and 11 shifted K2b launches (stage 0 1, stage 1 1,
  stage 2 9 of its 24 blocks); its eval logits bit-identical to the same
  model rolling the maps around the op, as the blocks did before the op took
  the shift.
- The exported Swin-B embedding program bit-identical to the eager forward,
  with 11 of its 24 K2 launches shifted.
"""

import contextlib
import re

import pytest
import torch
import torch.nn.functional as F

import chip_smoke as cs
from visiondk_tpu_torch.models import get_model
from visiondk_tpu_torch.models.backbones import swin as swin_module
from visiondk_tpu_torch.models.backbones.swin import window_region_ids
from visiondk_tpu_torch.ops import window_attention as wattn

# (name, B, H=W, heads, C, ws, shift, scale)
CASES = [
    ("swin_b_stage0_shifted", 4, 56, 4, 128, 7, 3, None),
    ("swin_b_stage2_shifted", 8, 14, 16, 512, 7, 3, None),
    ("hd12_unaligned", 2, 14, 2, 24, 7, 3, None),
    ("ws16_shifted_tiled", 2, 32, 2, 64, 16, 8, 1.0),
    ("ws16_shifted_runs", 8, 64, 2, 64, 16, 8, 1.0),  # runs of 4 windows a block, across images
    ("ws9_unaligned_p", 2, 18, 2, 64, 9, 4, None),
]
SWIN_B = {"task": "classification", "name": "swin_base_patch4_window7_224", "num_classes": 35, "image_size": 224}
SWIN_B_CBIR = {"task": "cbir", "backbone": {"swin_base_patch4_window7_224": {"image_size": 224, "feat_dim": 128}}}
SHIFTED_BLOCKS = 11  # Swin-B at 224²: one of stage 0's two blocks, one of stage 1's, 9 of stage 2's 18


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)


def _roll(x: torch.Tensor, s: int) -> torch.Tensor:
    return torch.roll(x, (s, s), dims=(1, 2))


def _shifted(k) -> int:
    torch.cuda.synchronize()
    return k.shifted_launches


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_each_kernel_handed_a_shift_is_the_kernel_on_the_rolled_map(case, dtype):
    dev = _card()
    name, b, hw, h, c, ws, s, scale = case
    n = ws * ws
    gen = torch.Generator(device=dev).manual_seed(23)
    qkv = torch.randn((b, hw, hw, 3 * c), generator=gen, device=dev).to(dtype)
    dout = torch.randn((b, hw, hw, c), generator=gen, device=dev).to(dtype)
    bias = 0.5 * torch.randn((h, n, n), generator=gen, device=dev)
    ids = torch.from_numpy(window_region_ids(hw, hw, ws, s)).to(dev)
    kf, ks, kb, kr = wattn.KERNELS
    before = [k.shifted_launches for k in wattn.KERNELS]

    out = kf(qkv, bias, ids, h, scale, s)
    o_s, p_s = ks(qkv, bias, ids, h, scale, s)
    g_p, db_p = kb(qkv, p_s, dout, h, scale, s)
    g_r, db_r = kr(qkv, bias, ids, dout, h, scale, s)
    assert [_shifted(k) - n0 for k, n0 in zip(wattn.KERNELS, before)] == [1, 1, 1, 1]

    # the kernels on the map rolled by −s (the op unshifted), rolled back
    q0, d0 = _roll(qkv, -s).contiguous(), _roll(dout, -s).contiguous()
    o_s0, p_s0 = ks(q0, bias, ids, h, scale)
    g_p0, db_p0 = kb(q0, p_s0, d0, h, scale)
    g_r0, db_r0 = kr(q0, bias, ids, d0, h, scale)
    assert torch.equal(out, _roll(kf(q0, bias, ids, h, scale), s)), f"{name}: K2"
    assert torch.equal(o_s, _roll(o_s0, s)) and torch.equal(p_s, p_s0), f"{name}: K2s"
    assert torch.equal(g_p, _roll(g_p0, s)) and torch.equal(db_p, db_p0), f"{name}: K2b"
    assert torch.equal(g_r, _roll(g_r0, s)) and torch.equal(db_r, db_r0), f"{name}: K2r"

    # against the plain versions, at chip_smoke.py's bars
    o_r, p_r = wattn.fused_window_attention_fwd_stash_plain(qkv, bias, ids, h, scale, s)
    g_p_ref, db_p_ref = wattn.fused_window_attention_bwd_from_p_plain(qkv, p_s, dout, h, scale, s)
    g_r_ref, db_r_ref = wattn.fused_window_attention_bwd_recompute_plain(qkv, bias, ids, dout, h, scale, s)
    assert torch.equal(o_s, out)
    assert cs.o_bar_ratio(out, o_r, dtype) <= 1.0
    assert cs.max_err(p_s, p_r) <= cs.P_TOL[dtype]
    for g, g_ref in ((g_p, g_p_ref), (g_r, g_r_ref)):
        assert cs.max_err(g, g_ref, scaled=True) <= cs.TOL[dtype]
    for db, db_ref in ((db_p, db_p_ref), (db_r, db_r_ref)):
        assert cs.max_err(db, db_ref) / max(1.0, db_ref.abs().max().item()) <= cs.DBIAS_TOL


@pytest.mark.card
@pytest.mark.parametrize("pcache", [True, False], ids=["from_p", "recompute"])
def test_the_op_through_autograd_counts_its_shifted_launches(pcache, monkeypatch):
    dev = _card()
    if pcache:
        monkeypatch.delenv("VDK_ATTN_NO_PCACHE", raising=False)
    else:
        monkeypatch.setenv("VDK_ATTN_NO_PCACHE", "1")
    b, hw, h, c, ws, s = 4, 14, 16, 512, 7, 3
    gen = torch.Generator(device=dev).manual_seed(24)
    qkv = torch.randn((b, hw, hw, 3 * c), generator=gen, device=dev).to(torch.bfloat16).requires_grad_(True)
    bias = (0.5 * torch.randn((h, ws * ws, ws * ws), generator=gen, device=dev)).requires_grad_(True)
    ids = torch.from_numpy(window_region_ids(hw, hw, ws, s)).to(dev)
    before = [k.shifted_launches for k in wattn.KERNELS]
    out = wattn.fused_window_attention(qkv, bias, ids, h, None, s)
    out.backward(torch.randn(out.shape, generator=gen, device=dev).to(out.dtype))
    want = [0, 1, 1, 0] if pcache else [1, 0, 0, 1]  # K2, K2s, K2b, K2r
    assert [_shifted(k) - n0 for k, n0 in zip(wattn.KERNELS, before)] == want
    assert torch.isfinite(qkv.grad.float()).all() and bias.grad.abs().sum() > 0


def _rolled_window_attention(attn, y, ws, shift):
    # the blocks before the op took the shift: pad, roll by −shift, attention
    # with the op unshifted, roll back, crop
    _, hh, ww, _ = y.shape
    y = F.pad(y, (0, 0, 0, (-ww) % ws, 0, (-hh) % ws))
    y = torch.roll(attn(torch.roll(y, (-shift, -shift), dims=(1, 2)), shift), (shift, shift), dims=(1, 2))
    return y[:, :hh, :ww]


@pytest.mark.card
def test_a_swin_b_step_launches_no_roll_and_eleven_shifted_kernels_a_pass(monkeypatch):
    dev = _card()
    monkeypatch.delenv("VDK_ATTN_NO_PCACHE", raising=False)
    model = get_model(SWIN_B, dtype=torch.bfloat16, device=dev, generator=torch.Generator().manual_seed(25))
    x = torch.randn((2, 224, 224, 3), generator=torch.Generator(device=dev).manual_seed(26), device=dev)
    model.train()
    model(x).float().square().mean().backward()  # builds the kernels and warms up
    torch.cuda.synchronize()
    before = [k.shifted_launches for k in wattn.KERNELS]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        model(x).float().square().mean().backward()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    assert any("window_attention" in k for k in names), names  # the profiler saw the card's kernels
    assert not [k for k in names if re.search(r"(?<![a-z])roll", k)], names  # roll_cuda_kernel, not "unrolled"
    assert [_shifted(k) - n0 for k, n0 in zip(wattn.KERNELS, before)] == [0, SHIFTED_BLOCKS, SHIFTED_BLOCKS, 0]

    model.eval()
    logits = []
    for rolled in (False, True):
        with contextlib.ExitStack() as stack:
            if rolled:
                patch = stack.enter_context(pytest.MonkeyPatch.context())
                patch.setattr(swin_module, "padded_window_attention", _rolled_window_attention)
                patch.setattr(swin_module, "fused_window_attention",
                              lambda qkv, bias, ids, heads, scale=None, shift=0:
                              wattn.fused_window_attention(qkv, bias, ids, heads, scale))
            with torch.inference_mode():
                logits.append(model(x))
    assert torch.equal(logits[0], logits[1])


@pytest.mark.card
def test_the_exported_swin_b_embedding_program_is_the_eager_forward():
    from visiondk_tpu_torch.engine.steps import ServingModel, StepConfig
    from visiondk_tpu_torch.export import export_program

    dev = _card()
    model = get_model(SWIN_B_CBIR, dtype=torch.bfloat16, device=dev, generator=torch.Generator().manual_seed(27))
    model.eval()
    cfg = StepConfig()
    program = export_program(model, cfg, embed=True, imgsz=224, batch=-1).module()
    served = ServingModel(model, cfg, embed=True).eval()
    x = torch.randint(0, 256, (3, 224, 224, 3), generator=torch.Generator(device=dev).manual_seed(28), device=dev,
                      dtype=torch.uint8)
    with torch.inference_mode():
        want = served(x)
        before = _shifted(wattn.fused_window_attention_fwd), wattn.fused_window_attention_fwd.launches
        got = program(x)
        after = _shifted(wattn.fused_window_attention_fwd), wattn.fused_window_attention_fwd.launches
    assert torch.equal(got, want)
    assert (after[0] - before[0], after[1] - before[1]) == (SHIFTED_BLOCKS, 24)
