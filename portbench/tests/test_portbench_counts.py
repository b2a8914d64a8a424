"""The yardstick's counts against numbers worked out by hand."""

import json

import pytest

from portbench import counts
from portbench.tests.tiny import PORTBENCH


def arch(name):
    return json.loads((PORTBENCH / "configs" / f"{name}.json").read_text())["arch"]


def test_vit_b16_attention_call_at_bs128():
    # one layer, forward plus backward: 12·B·H·N²·d and qkv + O + dO + dqkv in bf16
    nbytes, flops = counts.qkv_attention(128, 197, 12, 64, train=True)
    assert flops == pytest.approx(45.78e9, rel=1e-3)
    assert nbytes == pytest.approx(309.9e6, rel=1e-3)
    assert counts.bound_s(nbytes, flops) == pytest.approx(309.854208e6 / 3.35e12)
    assert counts.attention_bound_s(arch("vit_b16_pet"), 128, train=True) == pytest.approx(12 * nbytes / 3.35e12)


def test_vit_b16_forward_flops():
    # 17.56 G multiply-adds an image (35.1 GFLOP), 105.4 GFLOP a train step's image
    assert counts.forward_flops(arch("vit_b16_pet")) == pytest.approx(35.126e9, rel=1e-4)
    assert counts.step_flops(arch("vit_b16_pet"), 1, train=True) == pytest.approx(105.38e9, rel=1e-4)


def test_swin_b_attention_interface_bytes_an_image():
    # qkv + O + dO + dqkv of the 24 window calls: 49.8 MB an image once the per-call bias is shared
    swin = arch("swin_b_cbir")
    per_image = counts.attention_bound_s(swin, 256, train=True) * counts.HBM_BYTES_PER_S / 256
    assert per_image == pytest.approx(49.8e6, rel=2e-3)
    assert len(counts.attention_calls(swin, 1, train=False)) == 24


def test_swin_b_blocks_and_flops():
    blocks = list(counts.swin_blocks(arch("swin_b_cbir")))
    assert [b[0] for b in blocks] == [56] * 2 + [28] * 2 + [14] * 18 + [7] * 2
    assert [b[4] for b in blocks[:4]] == [0, 3, 0, 3]
    assert all(b[4] == 0 for b in blocks[-2:])  # one window covers the 7×7 map: no shift
    # 15.4 G multiply-adds for the backbone (Swin-B at 224²), plus the neck and the margin head
    assert counts.forward_flops(arch("swin_b_cbir")) == pytest.approx(30.874e9, rel=1e-4)


def test_bound_is_the_larger_of_bytes_and_flops():
    assert counts.bound_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert counts.bound_s(0.0, 989e12) == pytest.approx(1.0)
    assert counts.bound_s(3.35e12, 2 * 989e12) == pytest.approx(2.0)
