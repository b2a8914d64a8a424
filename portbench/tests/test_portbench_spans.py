"""The readers of the port's spans (``metrics/_spans.py`` and the three
metrics on it): None with an empty record, as in the small cells, whose
traffic kinds trace only on a card, and None on a record made under a CPU
profiler around small calls (no CUDA events). On a made-up record, a call's
seconds are the median of the calls of its shape that the card led, the
least of them where it led none. On the card (``-m card``), a traced run of
each one-card cell reports its span metrics beside the ones read from kernel
names, and a step holds as many attention spans as the launch counters
count kernel launches."""

import json
import subprocess
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import inputs, port, run
from portbench.cell import Cell
from portbench.tests import tiny

SPAN_METRICS = {"train": ("attn_op_roofline.train", "update_ms.train"),
                "embed": ("attn_op_roofline.embed",)}
READERS = [m for names in SPAN_METRICS.values() for m in names]
BENCH = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
KINDS = {"vit_b16_pet.train": "train", "swin_b_cbir.train": "train", "swin_b_cbir.embed": "embed"}


@pytest.fixture(autouse=True)
def empty_record():
    from visiondk_tpu_torch.utils import spans

    spans.clear()
    yield
    spans.clear()


def _small_cell(cfg, traffic):
    return Cell(name="small", cfg=cfg, traffic=traffic, limits={}, seed=1, seconds=0.0, trace_on=True,
                device=torch.device("cpu"))


@pytest.mark.parametrize("metric", READERS)
def test_a_reader_finds_nothing_in_an_empty_record(metric):
    cell = _small_cell(tiny.VIT_S if metric.endswith(".train") else tiny.SWIN_T,
                       tiny.TRAIN if metric.endswith(".train") else tiny.EMBED)
    assert run.reader(metric)(cell) is None


def test_on_a_cpu_record_the_readers_find_no_device_seconds():
    from visiondk_tpu_torch.utils import spans

    dev = torch.device("cpu")
    model = port.build_model(tiny.SWIN_T, {**inputs.weights(tiny.SWIN_T, 3, dev), **inputs.buffers(tiny.SWIN_T, dev)},
                             dev)
    embed = port.embed_step(tiny.SWIN_T, model)
    vit = port.build_model(tiny.VIT_S, {**inputs.weights(tiny.VIT_S, 3, dev), **inputs.buffers(tiny.VIT_S, dev)},
                           dev)
    state, step = port.train_step(tiny.VIT_S, vit, 5)
    batches = inputs.pool(tiny.VIT_S, tiny.TRAIN, 3, dev)
    with profile(activities=[ProfilerActivity.CPU]):
        for images, _ in inputs.pool(tiny.SWIN_T, tiny.EMBED, 3, dev) * 2:
            embed({"image": images})
        step(state, {"image": batches[0][0], "label": batches[0][1]})
    assert [r["name"] for r in spans.summary()] == ["vdk.serve.step"] * 2 * tiny.EMBED["pool"] + ["vdk.train.step"]
    assert run.reader("attn_op_roofline.embed")(_small_cell(tiny.SWIN_T, tiny.EMBED)) is None
    train_cell = _small_cell(tiny.VIT_S, tiny.TRAIN)
    assert run.reader("attn_op_roofline.train")(train_cell) is None
    assert run.reader("update_ms.train")(train_cell) is None


def _root(name, span, each, led):
    return {"name": name, "rows": 4,
            "spans": {span: {"count": len(each), "device_each": each, "led_each": led}}}


def test_a_call_reads_the_calls_of_its_shape_that_the_card_led(monkeypatch):
    from portbench.metrics import _spans
    from visiondk_tpu_torch.utils import spans

    record = [_root("vdk.train.step", "vdk.attention", [1.0, 9.0, 5.0], [True, False, False]),
              _root("vdk.train.step", "vdk.attention", [3.0, 2.0, 7.0], [True, True, False]),
              _root("vdk.train.step", "vdk.attention", [8.0, 4.0, 6.0], [False, True, False]),
              _root("vdk.serve.step", "vdk.attention", [0.5], [True])]
    monkeypatch.setattr(spans, "summary", lambda: record)
    # calls 0 and 1 have one shape: the median of the led 1, 3, 2, 4; call 2 never led: the least
    assert _spans.per_call("vdk.train.step", "vdk.attention", ["a", "a", "b"]) == [2.5, 2.5, 5.0]
    # each call a shape of its own
    assert _spans.per_call("vdk.train.step", "vdk.attention", ["a", "b", "c"]) == [2.0, 3.0, 5.0]
    # another count of calls than of shapes, a span no root holds, a root no record holds
    assert _spans.per_call("vdk.train.step", "vdk.attention", ["a", "a"]) is None
    assert _spans.per_call("vdk.train.step", "vdk.train.update", [None]) is None
    assert _spans.per_call("vdk.other.step", "vdk.attention", ["a"]) is None
    assert _spans.per_call("vdk.serve.step", "vdk.attention", ["a"]) == [0.5]


CARD_RUNNER = """
import json, torch
from portbench import run
from visiondk_tpu_torch.utils import spans
run.cache_dirs()
bench = run.benchmark()
cell = run.make_cell(bench, {cell!r}, {seed!r}, 3.0, True, torch.device("cuda", 0))
result = run.run_cell(bench, cell)
names = ("vdk.attention", "vdk.attention.backward")
counts = [[r["spans"].get(n, {{}}).get("count", 0) for n in names] for r in spans.summary()]
print(json.dumps({{"result": result, "launches": cell.launches, "counts": counts}}))
"""


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"] if w["chips"] == 1])
def test_a_traced_run_on_the_card_reports_the_span_metrics(cell):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    proc = subprocess.run([sys.executable, "-c", CARD_RUNNER.format(cell=cell, seed=2**32 + 29)], cwd=tiny.REPO,
                          capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    metrics = {k: v["value"] for k, v in out["result"]["metrics"].items()}
    kind = KINDS[cell]
    assert out["result"]["correct"] is True
    assert set(SPAN_METRICS[kind]) <= set(metrics), metrics
    # the op's spans hold its kernels and more; the update phase holds the foreach kernels and more
    assert metrics[f"attn_op_roofline.{kind}"] <= 1.02 * metrics[f"attn_roofline.{kind}"]
    if kind == "train":
        assert metrics["update_ms.train"] >= 0.98 * metrics["optim_ms.train"]
    # one span an attention call: as many as the launch counters count a call
    forward = sum(n for name, n in out["launches"].items() if "bwd" not in name)
    backward = sum(n for name, n in out["launches"].items() if "bwd" in name)
    want = [forward, backward]
    assert forward > 0 and (backward > 0) == (kind == "train")
    assert out["counts"] and all(c == want for c in out["counts"]), (out["counts"], out["launches"])
