"""The harness on the CPU, past its look for a card: small cells added to a
copy of the benchmark as files run and come out correct; an architecture
kind added as files is counted, and one without its counts' file fails by
naming it; each fault planted under the timed path, and the fp8 control in
the program's place, comes out not correct; the last line's keys; the import
check; and a checkout with nothing but the benchmark fails without a result."""

import json
import os
import subprocess
import sys
import types

import pytest

from portbench import compare, counts, run
from portbench.tests import tiny

RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "checks"}


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    root = tmp_path_factory.mktemp("portbench-copy")
    tiny.copy_benchmark(root)
    tiny.add_tiny_cells(root)
    return root


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_a_cell_added_as_files_runs_and_is_correct(copy, cell):
    result = tiny.run_on_cpu(copy, cell)
    assert set(result) == RESULT_KEYS and list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    train = ".train" in cell
    want = {"setup_s", "train_img_per_s"} if train else {"setup_s", "embed_img_per_s", "embed_p95_ms"}
    assert set(result["metrics"]) == want
    assert all(v["value"] > 0 for v in result["metrics"].values())


@pytest.mark.parametrize("cell,fault", [("tiny_vit.train", "unchanged"), ("tiny_vit.train", "half_batch"),
                                        ("tiny_swin.train", "unchanged"), ("tiny_swin.train", "half_batch"),
                                        ("tiny_swin.embed", "altered_row"),
                                        ("tiny_swin.train_ddp", "no_exchange")])
def test_a_fault_under_the_timed_path_is_not_correct(copy, cell, fault):
    result = tiny.run_on_cpu(copy, cell, fault=fault)
    assert result["correct"] is False
    assert any(row["value"] > row["limit"] for row in result["checks"].values())


def test_a_metric_added_as_a_file_is_read(copy, tmp_path):
    (copy / "portbench/metrics/calls_per_s.py").write_text(
        "def read(cell):\n    return cell.attempted / cell.window_s\n")
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "calls_per_s", "unit": "1/s", "better": "higher", "source": "host_clock",
                               "layer": "steps", "moves": "embed_img_per_s", "workloads": ["tiny_swin.embed"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    result = tiny.run_on_cpu(copy, "tiny_swin.embed", trace=True)
    assert result["metrics"]["calls_per_s"]["value"] > 0
    # the device readers find no device trace on the CPU and are left out, never 0
    assert "attn_roofline.embed" not in result["metrics"] and "idle_share.embed" not in result["metrics"]


NEW_KIND = "vit_as_files"


@pytest.mark.parametrize("with_shapes", [True, False], ids=["counted", "no_shapes_file"])
def test_an_architecture_kind_added_as_files_is_counted(tmp_path, with_shapes):
    # a kind that is ViT under another name: its reference and its counts re-export ViT's
    tiny.copy_benchmark(tmp_path)
    pb = tmp_path / "portbench"
    (pb / f"reference/{NEW_KIND}.py").write_text("from portbench.reference.vit import *  # noqa: F401,F403\n")
    if with_shapes:
        (pb / f"shapes/{NEW_KIND}.py").write_text(
            "from portbench.shapes.vit import attention_calls, forward_flops  # noqa: F401\n")
    cell = "tiny_as_files.train"
    cfg = {**tiny.VIT_S, "name": "tiny_as_files", "arch": {**tiny.VIT_S["arch"], "kind": NEW_KIND}}
    tiny.write_json(pb / "configs/tiny_as_files.json", cfg)
    tiny.write_json(pb / "traffic/tiny_train.json", tiny.TRAIN)
    tiny.write_json(pb / f"workloads/{cell}.json", {"limits": tiny.LIMITS_TRAIN})
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": cell, "config": "tiny_as_files", "traffic": "tiny_train", "chips": 1,
                               "why": "a small cell of a kind added as files"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("train_img_per_s", "mfu.train"):
            m["workloads"].append(cell)
    for probe in ("images", "window_s"):  # what mfu.train is worked out from
        (pb / f"metrics/probe_{probe}.py").write_text(f"def read(cell):\n    return cell.{probe}\n")
        bench["per_layer"].append({"name": f"probe_{probe}", "unit": "1", "better": "higher",
                                   "source": "host_clock", "layer": "train step", "moves": "train_img_per_s",
                                   "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    if not with_shapes:
        with pytest.raises(RuntimeError, match=f"ValueError: .*portbench/shapes/{NEW_KIND}.py is missing"):
            tiny.run_on_cpu(tmp_path, cell, trace=True)
        return
    result = tiny.run_on_cpu(tmp_path, cell, trace=True)
    assert result["correct"] is True
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    images, window = metrics["probe_images"], metrics["probe_window_s"]
    assert images > 0 and window > 0 and metrics["mfu.train"] > 0
    flops = counts.step_flops({**cfg["arch"], "kind": "vit"}, images, train=True)
    assert metrics["mfu.train"] == pytest.approx(100.0 * flops / window / counts.PEAK_BF16_FLOP_PER_S, rel=1e-12)


CONTROL = """
import json, sys, torch
sys.path.insert(0, {root!r})
from portbench import calibrate, run
bench = run.benchmark()
cell = run.make_cell(bench, {cell!r}, 1, 0.0, False, torch.device("cpu"))
out = (calibrate.train_seed if cell.traffic["kind"] == "train" else calibrate.embed_seed)(cell, 2**31 + 11)
print(json.dumps(out))
"""


@pytest.mark.parametrize("cell,real", [("tiny_vit.train", "vit_b16_pet.train"),
                                       ("tiny_swin.train", "swin_b_cbir.train"),
                                       ("tiny_swin.embed", "swin_b_cbir.embed")])
def test_the_fp8_control_fails_the_cells_limits(copy, cell, real):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(copy), str(tiny.REPO)]), OMP_NUM_THREADS="4")
    proc = subprocess.run([sys.executable, "-c", CONTROL.format(root=str(copy), cell=cell)], cwd=copy, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    limits = json.loads((tiny.PORTBENCH / "workloads" / f"{real}.json").read_text())["limits"]

    def numbers(side):
        return {k: (v[0] if isinstance(v, list) else v) for k, v in out[side].items()}

    assert compare.verdict(numbers("program"), limits)[0] is True
    assert compare.verdict(numbers("control"), limits)[0] is False


def test_the_import_check_on_a_real_import_of_the_harness():
    code = ("import sys, importlib\n"
            "from portbench import run, port, calibrate\n"
            "from portbench.traffic import train, embed\n"
            "for p in sorted(run.HERE.joinpath('metrics').glob('[a-z]*.py')):\n"
            "    run.reader(p.stem)\n"
            "print(run.loaded_forbidden())\n")
    env = dict(os.environ, PYTHONPATH=str(tiny.REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tiny.REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_the_import_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "visiondk_tpu_torch_like", types.ModuleType("visiondk_tpu_torch_like"))
    assert "visiondk_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "visiondk_tpu.ops", types.ModuleType("visiondk_tpu.ops"))
    assert "visiondk_tpu" in run.loaded_forbidden()


def test_a_checkout_of_the_benchmark_alone_fails_without_a_result(tmp_path):
    tiny.copy_benchmark(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "vit_b16_pet.train", "--seed", "1",
                           "--seconds", "1"], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert not proc.stdout.strip()


def test_no_card_no_result():
    # this machine's torch has no CUDA: the command refuses before any set-up
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "swin_b_cbir.embed", "--seed",
                           str(2**33 + 5), "--seconds", "1"], cwd=tiny.REPO, capture_output=True, text=True,
                          timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert proc.returncode != 0 and not proc.stdout.strip()
