"""The port's benchmark: one run of one cell.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name. ``BENCHMARK.json`` (at the root of the checkout)
gives the cell's configuration, traffic mix and chips and lists the metrics;
``portbench/configs/<config>.json`` holds the configuration,
``portbench/traffic/<mix>.json`` the mix's parameters and its ``kind``, whose
code is ``portbench/traffic/<kind>.py``; ``portbench/workloads/<cell>.json``
holds the limits of the numbers that decide ``correct``; and each metric is
read by ``portbench/metrics/<metric>.py`` (``read(cell)``, None where it finds
nothing to read, and then left out).

The run fails, printing no result, without a CUDA card (or with fewer than
the cell asks for), and when a module of JAX, flax, optax or the JAX package
is loaded once the window has closed. Its last line on standard output is one
JSON object; the numbers compared, each with its limit, are the last lines on
standard error and the last key of that object.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "visiondk_tpu")


def cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the port
    builds its CUDA libraries into ``visiondk_tpu_torch/_build``); no library
    that the port uses loads JAX."""
    cache = HERE / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def benchmark() -> Dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")


def load_json(kind: str, name: str) -> Dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def reader(name: str):
    """``portbench/metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The cell's end-to-end metrics (trace 0) or per-layer metrics (trace 1)."""
    listed = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in listed if "workloads" not in m or cell in m["workloads"]]


def make_cell(bench: Dict, name: str, seed: int, seconds: float, trace: bool, device, fault=None,
              started: Optional[float] = None):
    from portbench.cell import Cell

    w = workload(bench, name)
    limits_file = HERE / "workloads" / f"{name}.json"
    limits = json.loads(limits_file.read_text())["limits"] if limits_file.exists() else {}
    cell = Cell(name=name, cfg=load_json("configs", w["config"]), traffic=load_json("traffic", w["traffic"]),
                limits=limits, seed=seed, seconds=seconds, trace_on=trace, device=device, chips=w["chips"],
                fault=fault)
    if started is not None:
        cell.started = started
    return cell


def run_cell(bench: Dict, cell) -> Dict:
    """Runs ``cell`` on its device and returns the result object (without the
    ``device`` key, which needs the card)."""
    from portbench import compare
    from portbench.trace import breakdown

    kind = importlib.import_module(f"portbench.traffic.{cell.traffic['kind']}")
    kind.run(cell)
    correct, rows = compare.verdict(cell.numbers, cell.limits)
    correct = correct and cell.failed == 0 and cell.attempted > 0
    metrics = {}
    for m in metrics_of(bench, cell.name, cell.trace_on):
        value = reader(m["name"])(cell)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": cell.attempted, "failed": cell.failed, "metrics": metrics}
    if cell.trace_on and cell.trace is not None:
        result["breakdown"] = breakdown(cell.trace)
    result["checks"] = {name: {"value": value if math.isfinite(value) else repr(value), "limit": limit,
                               "where": cell.where.get(name, "")} for name, value, limit in rows}
    return result


def card(chips: int) -> Dict:
    """The card's name and power limit; the run's peak memory is the traffic kind's reading."""
    import torch

    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
                               check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "not read"
    return {"platform": "gpu", "kind": name, "count": chips, "power_limit": limit}


def loaded_forbidden() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cache_dirs()
    sys.path.insert(0, str(ROOT))
    bench = benchmark()
    chips = workload(bench, args.workload)["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA card(s), this machine has {count}; no result",
              file=sys.stderr)
        return 2
    cell = make_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                     started=STARTED)
    result = run_cell(bench, cell)
    device = card(chips)
    device["memory_peak_bytes"] = cell.memory_peak_bytes
    if cell.trace_on:
        device["busy_s"] = cell.trace.busy_s
        device["window_s"] = cell.trace.window_s
    checks = result.pop("checks")
    result["device"] = device
    result["checks"] = checks
    found = loaded_forbidden()
    if found:
        print(f"portbench: modules of JAX or the JAX package are loaded: {found}; no result", file=sys.stderr)
        return 3
    print(f"portbench: {cell.name} seed {cell.seed}: {cell.attempted} calls, {cell.images} images in "
          f"{cell.window_s:.3f} s, setup {cell.setup_s:.3f} s {cell.phases}, launches a call {cell.launches}",
          file=sys.stderr)
    for name, row in checks.items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r} ({row['where']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
