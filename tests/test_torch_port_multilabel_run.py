"""The port's multi-label run (``configs/classification/multilabel_csv.yaml``:
a CSV dataset, BCE, the focal swap after ``warm_ep``) against the JAX
package's, and the port's stdlib CSV read against the JAX package's pandas
read.

Setup: a tiny ResNet (basic blocks, ``stage_sizes`` [1, 1, 1, 1]) registered
in both packages' registries, 32×32 images, 3 label columns: a toy CSV over
seeded JPEGs of 7 colour classes, the labels the three bits of the class
index + 1 (at least one positive), 8 train and 3 val images a class.
multilabel_csv.yaml with the model and sizes cut (bs 16, which divides over
the conftest's 8 CPU devices; 3 epochs, ``warm_ep`` 1, so epochs 1 and 2
train with the focal loss), ``device_augment: false``, f32 on both sides.
Both trainers start from the same weights (the JAX model's init, parameters
and BN statistics, as a converted ``.npz`` under ``model.convert_npz``) and
read the same bytes (the native decode patched off on both sides).

Tolerances: per-epoch train loss and ``v_loss`` within 5e-3 relative. The
ViT run test holds 1e-4, but a ResNet's f32 gradients at random init are
ill-conditioned (BatchNorm's backward cancels most of the last stages'
gradients: one f32 step on the CPU loses 11–21% of their largest entry
against float64), so any two f32 runs in another summation order drift
apart over the 9 SGD steps: the port against itself at 1 and 8 CPU threads
differs by 4.3e-5, 3.9e-4 and 2.2e-3 in epochs 1–3 on this toy run, and by
as much from the JAX trainer; per-epoch precision, recall and F1 (each the
mean over the 3 classes) within 1 / (3 · the fewest val positives of a
class), what one image's decision moves a class's recall by, in the mean —
in practice equal. ``validate`` on the port's best checkpoint reproduces the
trainer's P/R/F1 exactly. The CSV reads agree exactly: rows, order, class
columns, ``train`` selection (bool and 0/1 forms) and f32 labels.
"""

import json
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import visiondk_tpu.data.native as jax_native
import visiondk_tpu.engine.trainer as jax_trainer
import visiondk_tpu_torch.data.native as port_native
from visiondk_tpu.config.checks import _check_num_classes as jax_check_num_classes
from visiondk_tpu.config.loader import yaml_load as jax_yaml_load
from visiondk_tpu.data.datasets import ImageDatasets as JaxImageDatasets
from visiondk_tpu.engine.trainer import CenterProcessor as JaxCenterProcessor
from visiondk_tpu.models import get_model as jax_get_model
from visiondk_tpu.models.backbones import BACKBONES as JAX_BACKBONES
from visiondk_tpu.models.backbones.resnet import _resnet as jax_resnet
from visiondk_tpu.models.convert import _flatten, save_converted
from visiondk_tpu.utils.metrics_writer import MetricsWriter as JaxMetricsWriter
from visiondk_tpu_torch.config import check, yaml_dump
from visiondk_tpu_torch.config.checks import _check_num_classes
from visiondk_tpu_torch.data.datasets import ImageDatasets, read_label_csv
from visiondk_tpu_torch.engine.trainer import CenterProcessor
from visiondk_tpu_torch.models import BACKBONES
from visiondk_tpu_torch.models.backbones.resnet import _resnet

TINY = "resnet_tiny_port_multilabel_test"
SIZE = 32
N_TRAIN, N_VAL, GROUPS = 8, 3, 7  # per colour class
COLUMNS = ("a", "b", "c")
EPOCHS = 3
LOSS_RTOL = 5e-3


def _resized(augment):
    for item in augment:
        for params in item.values():
            if isinstance(params, dict):
                if "size" in params:
                    params["size"] = SIZE
                _resized(params.get("transforms", []))
    return augment


@pytest.fixture(scope="module", autouse=True)
def tiny_resnet_registered():
    JAX_BACKBONES.register(jax_resnet([1, 1, 1, 1], "basic"), name=TINY)
    BACKBONES.register(_resnet([1, 1, 1, 1], "basic"), name=TINY)
    yield
    del JAX_BACKBONES._store[TINY]
    del BACKBONES._store[TINY]


@pytest.fixture(autouse=True)
def pil_decode(monkeypatch):
    monkeypatch.setattr(jax_native, "native_available", lambda: False)
    monkeypatch.setattr(port_native, "native_available", lambda: False)


def _labels(group: int):
    bits = group % 7 + 1
    return [(bits >> j) & 1 for j in range(3)]


@pytest.fixture(scope="module")
def toy(tmp_path_factory, tiny_resnet_registered):
    """(config dict, its YAML path) of the toy run; the CSV, the JPEGs and the
    initial weights live beside it."""
    root = tmp_path_factory.mktemp("toy_multilabel")
    rng = np.random.default_rng(0)
    rows = []
    for split, n in (("train", N_TRAIN), ("val", N_VAL)):
        for g in range(GROUPS):
            d = root / "img" / split / f"group_{g}"
            d.mkdir(parents=True)
            for i in range(n):
                h, w = (int(x) for x in rng.integers(30, 64, size=2))
                base = np.array([(37 * g) % 256, (91 * g + 40) % 256, 255 - 30 * g])
                arr = np.clip(rng.normal(base, 45, size=(h, w, 3)), 0, 255).astype(np.uint8)
                Image.fromarray(arr).save(d / f"{i}.jpg", quality=90)
                rows.append([str(d / f"{i}.jpg"), str(split == "train"), *map(str, _labels(g))])
    csv_path = root / "toy.csv"
    csv_path.write_text("\n".join(",".join(r) for r in [["image_path", "train", *COLUMNS], *rows]) + "\n")
    cfg = jax_yaml_load("configs/classification/multilabel_csv.yaml")
    cfg["model"].update(name=TINY, image_size=SIZE)
    variables = jax_get_model(cfg["model"]).init(jax.random.key(3), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    npz = root / "init.npz"
    save_converted({t: {p: np.asarray(v) for p, v in _flatten(dict(variables[t]["backbone"])).items()}
                    for t in ("params", "batch_stats")}, str(npz))
    cfg["model"]["convert_npz"] = str(npz)
    cfg["data"]["root"] = str(csv_path)
    cfg["data"]["nw"] = 2
    cfg["data"]["train"].update(bs=16, device_augment=False)
    cfg["data"]["val"]["bs"] = 16
    _resized(cfg["data"]["train"]["augment"])
    _resized(cfg["data"]["val"]["augment"])
    cfg["hyp"]["epochs"] = EPOCHS
    check("classification", cfg)
    path = root / "toy.yaml"
    yaml_dump(cfg, path)
    return cfg, path


def _metrics(project: Path) -> dict:
    out = {}
    for line in (project / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        out.setdefault(rec["tag"], {})[rec["step"]] = rec["value"]
    return out


@pytest.fixture(scope="module")
def port_run(toy, tmp_path_factory):
    project = tmp_path_factory.mktemp("port") / "run"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "native_available", lambda: False)
        mp.setattr(port_native, "native_available", lambda: False)
        cp = CenterProcessor(json.loads(json.dumps(toy[0])), project=str(project), device="cpu",
                             compute_dtype=torch.float32, seed=0)
        assert cp.focal_fn is not None and cp.thresh == 0.5
        cp.run_classifier()
    return project


def test_multilabel_run_matches_the_jax_trainer(toy, port_run, tmp_path, mesh8, monkeypatch):
    cfg, _ = toy
    monkeypatch.setattr(jax_trainer, "MetricsWriter", lambda logdir: JaxMetricsWriter(logdir, use_tensorboard=False))
    JaxCenterProcessor(json.loads(json.dumps(cfg)), project=str(tmp_path / "jax"), train=True, mesh=mesh8,
                       compute_dtype=jnp.float32, seed=0).run_classifier()
    got, want = _metrics(port_run), _metrics(tmp_path / "jax")
    # one image's decision in one class moves that class's recall by 1 / its positives
    fewest = min(N_VAL * sum(_labels(g)[j] for g in range(GROUPS)) for j in range(3))
    for epoch in range(EPOCHS):
        for tag in ("Train_loss", "Val_v_loss"):
            a, b = got[tag][epoch], want[tag][epoch]
            assert abs(a - b) <= LOSS_RTOL * abs(b), (tag, epoch, a, b)
        for tag in ("Val_precision", "Val_recall", "Val_f1score"):
            assert abs(got[tag][epoch] - want[tag][epoch]) <= 1 / (3 * fewest) + 1e-12, (tag, epoch)
        assert abs(got["Train_lr"][epoch] - want["Train_lr"][epoch]) <= 1e-9
    assert got["Train_loss"][2] < got["Train_loss"][0]  # it learns (and the focal loss is smaller than BCE)


def test_validate_reproduces_the_best_precision_recall_f1(port_run, capsys, monkeypatch):
    best = json.loads((port_run / "best" / "meta.json").read_text())["epoch"]
    logged = {k: _metrics(port_run)[f"Val_{k}"][best] for k in ("precision", "recall", "f1score")}
    monkeypatch.setattr(sys, "argv", ["validate", "--cfgs", str(port_run / "config.yaml"), "--weight",
                                      str(port_run / "best"), "--ema", "--device", "cpu"])
    capsys.readouterr()
    runpy.run_module("visiondk_tpu_torch.validate", run_name="__main__", alter_sys=True)
    line = next(ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{'precision'"))
    printed = eval(line)  # the printed metrics dict (floats)
    for key, value in logged.items():
        assert printed[key] == value, (key, printed[key], value)


def test_validate_on_the_native_decode_path_keeps_the_multi_hot_labels(port_run, capsys, monkeypatch):
    """Where the native decode is available, the val loader of a multi-label
    dataset still takes the PIL path (its native adapter emits int labels)."""
    monkeypatch.setattr(port_native, "native_available", lambda: True)
    best = json.loads((port_run / "best" / "meta.json").read_text())["epoch"]
    logged = _metrics(port_run)["Val_f1score"][best]
    monkeypatch.setattr(sys, "argv", ["validate", "--cfgs", str(port_run / "config.yaml"), "--weight",
                                      str(port_run / "best"), "--ema", "--device", "cpu"])
    capsys.readouterr()
    runpy.run_module("visiondk_tpu_torch.validate", run_name="__main__", alter_sys=True)
    line = next(ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{'precision'"))
    assert eval(line)["f1score"] == logged


# ---------------------------------------------------------------- the CSV read


def _write(path: Path, train_cells):
    lines = ["image_path,train,x,y"]
    for i, cell in enumerate(train_cells):
        lines.append(f"img_{i}.jpg,{cell},{i % 2},{0.5 * (i % 3)}")
    path.write_text("\n".join(lines) + "\n")
    return path


@pytest.mark.parametrize("cells", [
    ["True", "False", "True", "True", "False"],
    ["1", "0", "1", "1", "0"],
    ["TRUE", "false", "true", "FALSE", "True"],
    ["1", "0", "2", "1", "0"],  # a 2 is in neither split (pandas: 2 == True and 2 == False are both false)
], ids=["bool", "int", "bool_spellings", "int_outside"])
@pytest.mark.parametrize("mode", ["train", "val"])
def test_csv_read_matches_the_jax_pandas_read(tmp_path, cells, mode):
    path = _write(tmp_path / "labels.csv", cells)
    want = JaxImageDatasets(str(path), mode)
    got = ImageDatasets(str(path), mode)
    assert got.class_names == want.class_names == ["x", "y"]
    assert got.multi_label and want.multi_label
    assert got.images == list(want.images)
    assert len(got.labels) == len(want.labels) > 0
    for a, b in zip(got.labels, want.labels):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_csv_without_a_train_column_gives_every_split_every_row(tmp_path):
    path = tmp_path / "labels.csv"
    path.write_text("image_path,p,q,r\na.jpg,1,0,1\nb.jpg,0,0,1\n")
    for mode in ("train", "val"):
        got, want = ImageDatasets(str(path), mode), JaxImageDatasets(str(path), mode)
        assert got.images == list(want.images) == ["a.jpg", "b.jpg"]
        np.testing.assert_array_equal(np.stack(got.labels), np.stack(want.labels))


def test_the_class_count_check_reads_the_csv_header_without_pandas(tmp_path):
    path = _write(tmp_path / "labels.csv", ["True", "False"])
    _check_num_classes(2, str(path), "classification")
    jax_check_num_classes(2, str(path), "classification")
    with pytest.raises(AssertionError, match="dataset has 2"):
        _check_num_classes(3, str(path), "classification")


@pytest.mark.parametrize("body", [
    "image_path,train,x\na.jpg,True,yes\n",    # a label that is not a number
    "image_path,train,x\na.jpg,maybe,1\n",     # a train cell that is neither bool nor number
    "image_path,train,x\na.jpg,True\n",        # a short row
    "path,train,x\na.jpg,True,1\n",            # no image_path column
], ids=["label", "train", "short_row", "no_image_path"])
def test_a_csv_the_port_cannot_parse_raises_naming_the_file(tmp_path, body):
    path = tmp_path / "broken.csv"
    path.write_text(body)
    with pytest.raises(ValueError, match="broken.csv"):
        read_label_csv(str(path))
