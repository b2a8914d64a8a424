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


# The counts of the benchmark's configurations, pinned exactly: the values the
# yardstick gave before the per-kind arithmetic moved to ``portbench/shapes``.
VIT_FORWARD = 35126174208.0
SWIN_FORWARD = 30873970688.0
VIT_CALL_BS128_TRAIN = (309854208.0, 45780959232.0)
SWIN_CALLS_BS256 = {  # (stage 0, its shifted block, stage 1, shifted, stage 2, shifted, stage 3)
    True: [(1644244000.0, 60423143424.0), (1644256544.0, 60423143424.0), (822237248.0, 30211571712.0),
           (822240384.0, 30211571712.0), (411349120.0, 15105785856.0), (411349904.0, 15105785856.0),
           (206135552.0, 7552892928.0)],
    False: [(822122000.0, 20141047808.0), (822134544.0, 20141047808.0), (411118624.0, 10070523904.0),
            (411121760.0, 10070523904.0), (205674560.0, 5035261952.0), (205675344.0, 5035261952.0),
            (103067776.0, 2517630976.0)],
}
SWIN_BOUND_BS256 = {True: 0.003805832983880597, False: 0.0019029198853731343}


@pytest.mark.parametrize("name,forward,train,one,batch,images", [
    ("vit_b16_pet", VIT_FORWARD, True, 105378522624.0, 128, 13488450895872.0),
    ("vit_b16_pet", VIT_FORWARD, False, 35126174208.0, 128, 4496150298624.0),
    ("swin_b_cbir", SWIN_FORWARD, True, 92621912064.0, 256, 23711209488384.0),
    ("swin_b_cbir", SWIN_FORWARD, False, 30873970688.0, 256, 7903736496128.0),
])
def test_model_flops_are_pinned(name, forward, train, one, batch, images):
    assert counts.forward_flops(arch(name)) == forward
    assert counts.step_flops(arch(name), 1, train) == one
    assert counts.step_flops(arch(name), batch, train) == images


def test_vit_b16_attention_calls_are_pinned_at_bs128():
    assert counts.attention_calls(arch("vit_b16_pet"), 128, True) == [VIT_CALL_BS128_TRAIN] * 12
    assert counts.attention_bound_s(arch("vit_b16_pet"), 128, True) == 0.0011099255211940297


@pytest.mark.parametrize("train", [True, False])
def test_swin_b_attention_calls_are_pinned_at_bs256(train):
    s0, s0s, s1, s1s, s2, s2s, s3 = SWIN_CALLS_BS256[train]
    want = [s0, s0s, s1, s1s] + [s2, s2s] * 9 + [s3, s3]
    assert counts.attention_calls(arch("swin_b_cbir"), 256, train) == want
    assert counts.attention_bound_s(arch("swin_b_cbir"), 256, train) == SWIN_BOUND_BS256[train]


def test_a_kind_without_a_shapes_file_names_the_file():
    with pytest.raises(ValueError, match="portbench/shapes/swinv2.py"):
        counts.forward_flops({**arch("swin_b_cbir"), "kind": "swinv2"})
    with pytest.raises(ValueError, match="portbench/shapes/swinv2.py"):
        counts.attention_calls({**arch("swin_b_cbir"), "kind": "swinv2"}, 1, False)
