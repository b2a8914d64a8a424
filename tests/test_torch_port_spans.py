"""The port's spans (``visiondk_tpu_torch/utils/spans.py``) on the CPU, at tiny shapes.

With no profiler recording a span is one shared no-op that never enters
``record_function``. Under a CPU profiler a ViT train step gives one
``vdk.train.step`` root holding its phases, one ``vdk.attention`` per block
under the forward and one ``vdk.attention.backward`` per block under the
backward (opened on the autograd engine's side, parented to the open
backward phase), and the same names appear in the exported trace as
``user_annotation`` events; a Swin train step and an embed call give their
roots and attention spans. The summary lists each span's device seconds
and whether the card led it, and takes a span's self time as its time less
the union of its children's. The spans change no number: losses, parameters
and embeddings are bit-identical with them on and off. The record keeps
``MAX_ROOTS`` roots, ``dump`` writes JSON, and ``main --trace`` dumps the
spans beside its trace.
"""

import contextlib
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from visiondk_tpu_torch import main as port_main
from visiondk_tpu_torch.engine.state import create_train_state
from visiondk_tpu_torch.engine.steps import StepConfig, make_embed_step, make_train_step
from visiondk_tpu_torch.engine.trainer import build_tx
from visiondk_tpu_torch.losses import create_lossfn
from visiondk_tpu_torch.models import BACKBONES, get_model
from visiondk_tpu_torch.models.backbones.swin import _swin
from visiondk_tpu_torch.models.backbones.vit import _vit
from visiondk_tpu_torch.utils import spans

VIT = "vit_tiny_port_spans_test"
SWIN = "swin_tiny_port_spans_test"
IMG = 32
VIT_DEPTH = 2
SWIN_DEPTHS = (2, 2)
HYP = {"epochs": 6, "lr0": 0.01, "lrf_ratio": None, "momentum": 0.937, "weight_decay": 0.0005,
       "warmup_momentum": 0.8, "warm_ep": 1, "label_smooth": 0.05, "optimizer": ["sgd", False],
       "scheduler": "cosine_with_warm"}
HEAD = {"arcface": {"feat_dim": 8, "num_class": 10, "margin_arc": 0.35, "margin_am": 0.0, "scale": 32}}
PHASES = ("vdk.train.preprocess", "vdk.train.forward", "vdk.train.backward", "vdk.train.update")


@pytest.fixture(scope="module", autouse=True)
def tiny_models_registered():
    BACKBONES.register(_vit(8, 32, VIT_DEPTH, 2), name=VIT)
    BACKBONES.register(_swin(16, SWIN_DEPTHS, (2, 4), window_size=4), name=SWIN)
    yield
    del BACKBONES._store[VIT]
    del BACKBONES._store[SWIN]


@pytest.fixture(autouse=True)
def empty_record():
    spans.clear()
    yield
    spans.clear()


def _batch(seed, n=4, classes=5):
    g = torch.Generator().manual_seed(seed)
    return {"image": torch.randint(0, 256, (n, IMG, IMG, 3), dtype=torch.uint8, generator=g),
            "label": torch.randint(0, classes, (n,), generator=g)}


def _vit_step():
    model = get_model({"task": "classification", "name": VIT, "num_classes": 5, "image_size": IMG}, device="cpu")
    tx = build_tx(HYP, 2, discrete_per_epoch=True)
    state = create_train_state(model, tx, torch.Generator().manual_seed(1))
    return state, make_train_step(model, tx, create_lossfn("ce", label_smooth=0.05), StepConfig(), state.generator)


def _swin_model():
    backbone = {SWIN: {"image_size": IMG, "feat_dim": 8, "stochastic_depth_prob": 0.0}}
    return get_model({"task": "cbir", "backbone": backbone, "head": HEAD}, device="cpu")


def _swin_step(model):
    tx = build_tx({**HYP, "optimizer": ["sgd", True]}, 2, discrete_per_epoch=False, model_cfg={"task": "cbir"})
    state = create_train_state(model, tx, torch.Generator().manual_seed(1))
    cfg = StepConfig(task="embedding")
    return state, make_train_step(model, tx, create_lossfn("ce", valid_class=10), cfg, state.generator)


def _names(root):
    return [s.name for s in root.children]


def _under(root, name):
    """The parent names of ``root``'s spans called ``name``."""
    return [s.parent.name for s in root.children if s.name == name]


def test_without_a_profiler_a_span_is_the_shared_noop(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert spans.span("vdk.train.step", rows=4) is spans.span("vdk.attention") is spans._OFF
    state, step = _vit_step()
    step(state, _batch(0))
    make_embed_step(_swin_model(), StepConfig())(_batch(1))
    assert spans.summary() == []


def test_a_vit_train_step_gives_one_root_with_its_phases_and_attention_spans(tmp_path):
    state, step = _vit_step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, _batch(0))
    (root,) = spans.RECORD.roots()
    assert root.name == "vdk.train.step" and root.rows == 4 and root.parent is None
    assert all(_under(root, p) == ["vdk.train.step"] for p in PHASES)
    assert _under(root, "vdk.train.ema") == ["vdk.train.update"]
    assert _under(root, "vdk.attention") == ["vdk.train.forward"] * VIT_DEPTH
    assert _under(root, "vdk.attention.backward") == ["vdk.train.backward"] * VIT_DEPTH
    assert "vdk.train.sam" not in _names(root)
    # the summary: self time is the span's time less its children's
    (summary,) = spans.summary()
    rows = summary["spans"]
    assert rows["vdk.attention"]["count"] == VIT_DEPTH and rows["vdk.train.step"]["device_s"] is None
    forward = rows["vdk.train.forward"]
    assert forward["self_host_s"] == pytest.approx(forward["host_s"] - rows["vdk.attention"]["host_s"], abs=1e-6)
    assert 0 < rows["vdk.train.step"]["self_host_s"] < rows["vdk.train.step"]["host_s"]
    # the same names in the exported trace, as user annotations
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    annotated = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    for name in ("vdk.train.step", "vdk.train.ema", *PHASES):
        assert annotated.count(name) == 1, name
    assert annotated.count("vdk.attention") == annotated.count("vdk.attention.backward") == VIT_DEPTH


def test_a_swin_train_step_and_an_embed_call_give_their_roots_and_attention_spans():
    model = _swin_model()
    state, step = _swin_step(model)
    embed = make_embed_step(model, StepConfig())
    with profile(activities=[ProfilerActivity.CPU]):
        step(state, _batch(0, classes=10))
        embed(_batch(1))
    train, serve = spans.RECORD.roots()
    blocks = sum(SWIN_DEPTHS)
    assert train.name == "vdk.train.step" and train.rows == 4
    assert _under(train, "vdk.attention") == ["vdk.train.forward"] * blocks
    assert _under(train, "vdk.attention.backward") == ["vdk.train.backward"] * blocks
    assert serve.name == "vdk.serve.step" and serve.rows == 4
    assert _names(serve) == ["vdk.serve.step"] + ["vdk.attention"] * blocks


def test_the_summary_lists_each_spans_device_seconds_and_whether_the_card_led_it():
    record = spans.SpanRecord()
    root, first, second, update = (spans.Span(record, name, 4 if i == 0 else None, None) for i, name in
                                   enumerate(("vdk.train.step", "vdk.attention", "vdk.attention", "vdk.train.update")))
    root.children = [root, first, second, update]
    for s, host, device, led in ((root, (0, 100), (0.0, 10.0), False), (first, (10, 20), (1.0, 3.0), True),
                                 (second, (30, 40), (2.5, 4.5), False), (update, (50, 90), (6.0, 9.0), True)):
        if s is not root:
            s.parent, s.root = root, root
        s.host, s.device_s, s.led = list(host), device, led
    summary = spans._root_summary(root)
    assert summary["name"] == "vdk.train.step" and summary["rows"] == 4
    attention = summary["spans"]["vdk.attention"]
    assert attention["count"] == 2 and attention["device_each"] == [2.0, 2.0] and attention["led_each"] == [True, False]
    assert attention["device_s"] == 4.0 and attention["host_s"] == pytest.approx(20e-9)
    step = summary["spans"]["vdk.train.step"]
    # the children cover 1.0-4.5 and 6.0-9.0 of the root's 10 device seconds (the two attention spans overlap)
    assert step["self_device_s"] == pytest.approx(10.0 - 3.5 - 3.0)
    assert step["self_host_s"] == pytest.approx((100 - 60) * 1e-9)
    assert summary["spans"]["vdk.train.update"]["led_each"] == [True]


def test_the_spans_change_no_number():
    def run(traced):
        vit_state, vit_step = _vit_step()
        model = _swin_model()
        swin_state, swin_step = _swin_step(model)
        embed = make_embed_step(model, StepConfig())
        with profile(activities=[ProfilerActivity.CPU]) if traced else contextlib.nullcontext():
            losses = [vit_step(vit_state, _batch(i))["loss"] for i in range(2)]
            losses += [swin_step(swin_state, _batch(i, classes=10))["loss"] for i in range(2)]
        with profile(activities=[ProfilerActivity.CPU]) if traced else contextlib.nullcontext():
            out = embed(_batch(5))
        params = [p.detach().clone() for s in (vit_state, swin_state) for p in (*s.model.parameters(),
                                                                                  *s.ema_model.parameters())]
        return losses, params, out

    off, on = run(False), run(True)
    assert len(spans.summary()) == 5  # four steps and a call recorded on, none off
    for a, b in zip(off[0] + off[1] + [off[2]], on[0] + on[1] + [on[2]]):
        assert torch.equal(a, b)


def test_the_record_keeps_its_cap_of_roots():
    calls = spans.MAX_ROOTS + 8
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(calls):
            with spans.span("vdk.serve.step", rows=i):
                with spans.span("vdk.attention"):
                    pass
    kept = spans.summary()
    assert len(kept) == spans.MAX_ROOTS
    assert [r["rows"] for r in kept] == list(range(8, calls))


def test_dump_writes_json_that_reads_back(tmp_path):
    state, step = _vit_step()
    with profile(activities=[ProfilerActivity.CPU]):
        step(state, _batch(0))
    spans.dump(tmp_path / "spans.json")
    data = json.loads((tmp_path / "spans.json").read_text())
    (root,) = data["roots"]
    assert data["max_roots"] == spans.MAX_ROOTS and root["name"] == "vdk.train.step" and root["rows"] == 4
    order = root["spans_in_order"]
    assert order[0]["parent"] is None and order[0]["name"] == "vdk.train.step"
    assert all(order[s["parent"]]["name"] == "vdk.train.forward" for s in order if s["name"] == "vdk.attention")
    assert root["spans"]["vdk.attention.backward"]["count"] == VIT_DEPTH


def test_main_trace_dumps_the_spans_beside_the_trace(tmp_path, monkeypatch):
    from visiondk_tpu_torch import config
    from visiondk_tpu_torch.engine import trainer

    class Processor:
        def __init__(self, cfgs, project, train, device, seed, mesh):
            self.device = device

        def run_classifier(self, resume=None):
            with spans.span("vdk.serve.step", rows=2):
                pass
            return "trained"

    dumped = []
    dump = spans.dump
    monkeypatch.setattr(config, "yaml_load", lambda path: {"model": {"task": "classification"}})
    monkeypatch.setattr(config, "check", lambda task, cfg: None)
    monkeypatch.setattr(trainer, "CenterProcessor", Processor)
    monkeypatch.setattr(spans, "dump", lambda path: (dumped.append(path), dump(path)))
    opt = port_main.parse_opt(["--cfgs", "unused.yaml", "--project", str(tmp_path / "exp"), "--device", "cpu",
                               "--trace"])
    assert port_main.main(opt) == "trained"
    (path,) = dumped
    assert path.parent == tmp_path / "exp" / "trace" and path.name == "spans.json"
    assert (path.parent / "trace.json").is_file()
    assert [r["name"] for r in json.loads(path.read_text())["roots"]] == ["vdk.serve.step"]
