"""Small cells for the CPU tests: a copy of the benchmark in a temporary
directory with ViT-S/16 at 32² and Swin-T at 56² (full published widths,
small images and batches, float32 compute) added as files, and a runner that
drives a cell there on the CPU, past the harness's look for a card."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, Optional

HERE = Path(__file__).resolve().parent
PORTBENCH = HERE.parent
REPO = PORTBENCH.parent

VIT_S = {
    "name": "tiny_vit", "source": "https://arxiv.org/abs/2010.11929",
    "model": {"task": "classification", "name": "vit_small_patch16_224", "image_size": 32, "kwargs": {},
              "num_classes": 5, "attention_pool": False},
    "hyp": {"epochs": 6, "lr0": 0.01, "lrf_ratio": None, "momentum": 0.937, "weight_decay": 0.0005,
            "warmup_momentum": 0.8, "warm_ep": 1, "label_smooth": 0.05, "optimizer": ["sgd", False],
            "scheduler": "cosine_with_warm"},
    "arch": {"kind": "vit", "img_size": 32, "patch_size": 16, "embed_dim": 384, "depth": 12, "num_heads": 6,
             "mlp_ratio": 4.0, "num_classes": 5},
    "mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225],
    "steps_per_epoch": 2, "compute_dtype": "float32", "reduced": [], "assumed": {},
}
SWIN_T = {
    "name": "tiny_swin", "source": "https://arxiv.org/abs/2103.14030",
    "model": {"task": "cbir", "image_size": 56,
              "backbone": {"swin_tiny_patch4_window7_224": {"pretrained": False, "image_size": 56, "feat_dim": 16}},
              "head": {"arcface": {"feat_dim": 16, "num_class": 50, "margin_arc": 0.35, "margin_am": 0.0,
                                   "scale": 32}}},
    "hyp": {"epochs": 25, "lr0": 0.006, "lrf_ratio": None, "momentum": 0.937, "weight_decay": 0.0005,
            "warmup_momentum": 0.8, "warm_ep": 1, "label_smooth": 0.0, "optimizer": ["sgd", True],
            "scheduler": "cosine_with_warm"},
    "arch": {"kind": "swin", "img_size": 56, "patch_size": 4, "embed_dim": 96, "depths": [2, 2, 6, 2],
             "num_heads": [3, 6, 12, 24], "window_size": 7, "mlp_ratio": 4.0, "drop_path": 0.1,
             "neck": {"feat_dim": 16, "num_class": 50, "margin_arc": 0.35, "margin_am": 0.0, "scale": 32.0}},
    "mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225],
    "steps_per_epoch": 3, "compute_dtype": "float32", "reduced": [], "assumed": {},
}
TRAIN = {"kind": "train", "batch": 4, "pool": 4, "compared_steps": 3, "block_rows": 3, "trace_calls": 2,
         "labelled_calls": 1}
DDP = {"kind": "train_ddp", "world": 4, "batch": 2, "pool": 4, "compared_steps": 3, "block_rows": 3,
       "trace_calls": 2, "labelled_calls": 1}
EMBED = {"kind": "embed", "batch": 4, "pool": 2, "warm_calls": 1, "sampled_calls": 3, "block_rows": 3,
         "trace_calls": 2, "labelled_calls": 1}
# float32 against float32: the gaps are rounding of the order of 1e-6
LIMITS_TRAIN = {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3, "ema_change_gap": 1e-3}
LIMITS_EMBED = {"row_gap": 1e-4}
CELLS = {
    "tiny_vit.train": ("tiny_vit", "tiny_train", LIMITS_TRAIN),
    "tiny_swin.train": ("tiny_swin", "tiny_train", LIMITS_TRAIN),
    "tiny_swin.embed": ("tiny_swin", "tiny_embed", LIMITS_EMBED),
    "tiny_swin.train_ddp": ("tiny_swin", "tiny_ddp", LIMITS_TRAIN),
}
KINDS = {"tiny_train": TRAIN, "tiny_embed": EMBED, "tiny_ddp": DDP}


# the kind of each of the benchmark's own cells, for listing a small cell under the metrics of its
# family's cells (a data-parallel train cell reports what a train cell reports)
CELL_KINDS = {"vit_b16_pet.train": "train", "swin_b_cbir.train": "train", "swin_b_cbir.embed": "embed",
              "swin_b_cbir.train_ddp4": "train_ddp"}
FAMILY = {"train": "train", "train_ddp": "train", "embed": "embed"}


def write_json(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def copy_benchmark(dest: Path) -> Path:
    """A copy of BENCHMARK.json and ``portbench/`` (without caches) under ``dest``."""
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(PORTBENCH, dest / "portbench", ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    return dest


def add_tiny_cells(dest: Path) -> None:
    """Adds the small configurations, mixes and cells to the copy, as files."""
    write_json(dest / "portbench/configs/tiny_vit.json", VIT_S)
    write_json(dest / "portbench/configs/tiny_swin.json", SWIN_T)
    for name, mix in KINDS.items():
        write_json(dest / f"portbench/traffic/{name}.json", mix)
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    for name, (config, traffic, limits) in CELLS.items():
        bench["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1,
                                   "why": "a small cell of the harness's CPU tests"})
        write_json(dest / f"portbench/workloads/{name}.json", {"limits": limits})
        family = FAMILY[KINDS[traffic]["kind"]]
        for m in bench["end_to_end"] + bench["per_layer"]:
            listed = [w for w in m.get("workloads", []) if w in CELL_KINDS]
            if any(FAMILY[CELL_KINDS[w]] == family for w in listed):
                m["workloads"].append(name)
    write_json(dest / "BENCHMARK.json", bench)


RUNNER = """
import json, sys, torch
sys.path.insert(0, {root!r})
from portbench import run
bench = run.benchmark()
cell = run.make_cell(bench, {cell!r}, {seed!r}, {seconds!r}, {trace!r}, torch.device("cpu"), fault={fault!r})
result = run.run_cell(bench, cell)
print(json.dumps(result))
"""


def run_on_cpu(root: Path, cell: str, seed: int = 12345678901, seconds: float = 0.5, trace: bool = False,
               fault: Optional[str] = None, timeout: float = 600) -> Dict:
    """Drives ``cell`` of the benchmark copy at ``root`` on the CPU in a fresh
    process; returns its result object."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root), str(REPO)]), OMP_NUM_THREADS="2")
    code = RUNNER.format(root=str(root), cell=cell, seed=seed, seconds=seconds, trace=trace, fault=fault)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"cell {cell} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])
