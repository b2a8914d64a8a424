"""The port's classification run loop against the JAX package's, and its CLIs.

Setup: a tiny ViT (patch 8, width 64, depth 2, 4 heads, 32×32 images, 7
classes) on a toy folder dataset of seeded JPEGs, with pet_synth's augment
pipelines (sizes cut to 32) and hyp (3 epochs, ``warm_ep`` 1, ``aug_epoch``
2, so epoch 0 trains on the val augments, epoch 1 on the full pipeline and
epoch 2 on the weakened one), ``device_augment: false``, bs 16 (it divides
over the conftest's 8 CPU devices), f32 on both sides. Both trainers start
from the same weights, the JAX model's init written as a converted ``.npz``
that both honour through the config's ``model.convert_npz``, and both read
the same loaders' bytes (the native decode patched off on both sides, so
both take the PIL path).

Tolerances: per-epoch train loss and ``v_loss`` within 1e-4 relative and
val top1 within one image. Both sides run the same f32 math in another
summation order (the JAX ViT pads its 17 tokens to 24 and masks them, and
its batch is sharded over 8 devices), carried through 21 SGD steps: the
three-step test's 1e-5 (``test_torch_port_train.py``) grows with the steps.
A port run killed after its second epoch and resumed equals the
uninterrupted run to 1e-6 (the same process, the same ops: in practice
bit-equal). ``validate`` reproduces the trainer's best top1 exactly. A run
with ``device_augment: "auto"`` on deterministic lifted ops (hflip,
autocontrast, invert) is held to the JAX trainer's at the same bars.
"""

import json
import re
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
import visiondk_tpu_torch.data.native as port_native
from visiondk_tpu.config.loader import yaml_load as jax_yaml_load
import visiondk_tpu.engine.trainer as jax_trainer
from visiondk_tpu.engine.trainer import CenterProcessor as JaxCenterProcessor
from visiondk_tpu.models import get_model as jax_get_model
from visiondk_tpu.models.backbones import BACKBONES as JAX_BACKBONES
from visiondk_tpu.models.backbones.vit import _vit as jax_vit
from visiondk_tpu.models.convert import _flatten, save_converted
from visiondk_tpu.utils.metrics_writer import MetricsWriter as JaxMetricsWriter
from visiondk_tpu_torch.config import check, yaml_dump
from visiondk_tpu_torch.engine.trainer import CenterProcessor
from visiondk_tpu_torch.models import BACKBONES
from visiondk_tpu_torch.models.backbones.vit import _vit

TINY = "vit_tiny_patch8_port_run_test"
SIZE = 32
N_TRAIN, N_VAL, CLASSES = 16, 4, 7  # per class: 7 steps of 16 an epoch, 28 val images
EPOCHS = 3
LOSS_RTOL = 1e-4
RESUME_TOL = 1e-6


def _resized(augment):
    for item in augment:
        for params in item.values():
            if isinstance(params, dict):
                if "size" in params:
                    params["size"] = SIZE
                _resized(params.get("transforms", []))
    return augment


@pytest.fixture(scope="module", autouse=True)
def tiny_vit_registered():
    JAX_BACKBONES.register(jax_vit(8, 64, 2, 4), name=TINY)
    BACKBONES.register(_vit(8, 64, 2, 4), name=TINY)
    yield
    del JAX_BACKBONES._store[TINY]
    del BACKBONES._store[TINY]


@pytest.fixture(autouse=True)
def pil_decode(monkeypatch):
    monkeypatch.setattr(jax_native, "native_available", lambda: False)
    monkeypatch.setattr(port_native, "native_available", lambda: False)


@pytest.fixture(scope="module")
def toy(tmp_path_factory, tiny_vit_registered):
    """(config dict, its YAML path) of the toy run; the data and the initial
    weights live beside it."""
    root = tmp_path_factory.mktemp("toy_run")
    rng = np.random.default_rng(0)
    for split, n in (("train", N_TRAIN), ("val", N_VAL)):
        for c in range(CLASSES):
            d = root / "data" / split / f"class_{c}"
            d.mkdir(parents=True)
            for i in range(n):
                h, w = (int(x) for x in rng.integers(30, 64, size=2))
                base = np.array([(37 * c) % 256, (91 * c + 40) % 256, 255 - 30 * c])
                arr = np.clip(rng.normal(base, 45, size=(h, w, 3)), 0, 255).astype(np.uint8)
                Image.fromarray(arr).save(d / f"{i}.jpg", quality=90)
    cfg = jax_yaml_load("configs/classification/pet_synth.yaml")
    cfg["model"].update(name=TINY, image_size=SIZE, num_classes=CLASSES)
    variables = jax_get_model(cfg["model"]).init(jax.random.key(3), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    npz = root / "init.npz"
    save_converted({"params": {p: np.asarray(v) for p, v in _flatten(dict(variables["params"]["backbone"])).items()}},
                   str(npz))
    cfg["model"]["convert_npz"] = str(npz)
    cfg["data"]["root"] = str(root / "data")
    cfg["data"]["nw"] = 2
    cfg["data"]["train"].update(bs=16, device_augment=False, aug_epoch=2)
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


def _port_run(cfg, project, resume=None, stop_at=None):
    cp = CenterProcessor(json.loads(json.dumps(cfg)), project=str(project), device="cpu",
                         compute_dtype=torch.float32, seed=0)
    if stop_at is not None:  # a crash at the start of epoch ``stop_at``
        strategy = cp._epoch_strategy

        def crash(epoch, *args, **kwargs):
            if epoch == stop_at and kwargs.get("log", True):
                raise KeyboardInterrupt(f"killed at the start of epoch {stop_at}")
            return strategy(epoch, *args, **kwargs)

        cp._epoch_strategy = crash
        with pytest.raises(KeyboardInterrupt):
            cp.run_classifier()
        cp.ckpt.wait()  # the killed run's last write lands (the chip test kills one mid-write)
        return cp
    cp.run_classifier(resume=resume)
    return cp


@pytest.fixture(scope="module")
def port_run(toy, tmp_path_factory):
    project = tmp_path_factory.mktemp("port") / "run"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "native_available", lambda: False)
        mp.setattr(port_native, "native_available", lambda: False)
        cp = _port_run(toy[0], project)
    return project, cp


def test_run_classifier_matches_the_jax_trainer(toy, port_run, tmp_path, mesh8, monkeypatch):
    cfg, _ = toy
    project, _ = port_run
    # the JAX writer mirrors metrics.jsonl to TensorBoard where it imports; not needed here
    monkeypatch.setattr(jax_trainer, "MetricsWriter", lambda logdir: JaxMetricsWriter(logdir, use_tensorboard=False))
    JaxCenterProcessor(json.loads(json.dumps(cfg)), project=str(tmp_path / "jax"), train=True, mesh=mesh8,
                       compute_dtype=jnp.float32, seed=0).run_classifier()
    got, want = _metrics(project), _metrics(tmp_path / "jax")
    for epoch in range(EPOCHS):
        for tag in ("Train_loss", "Val_v_loss"):
            a, b = got[tag][epoch], want[tag][epoch]
            assert abs(a - b) <= LOSS_RTOL * abs(b), (tag, epoch, a, b)
        assert abs(got["Val_top1"][epoch] - want["Val_top1"][epoch]) * N_VAL * CLASSES <= 1 + 1e-9, epoch
        assert abs(got["Train_lr"][epoch] - want["Train_lr"][epoch]) <= 1e-9
    assert got["Train_loss"][2] < got["Train_loss"][0]  # it learns


def test_resumed_run_equals_the_uninterrupted_run(toy, port_run, tmp_path):
    cfg, _ = toy
    project, full = port_run
    _port_run(cfg, tmp_path / "run", stop_at=2)
    assert json.loads((tmp_path / "run" / "last" / "meta.json").read_text())["epoch"] == 1
    resumed = _port_run(cfg, tmp_path / "run", resume="last")
    got, want = _metrics(tmp_path / "run"), _metrics(project)
    for tag in ("Train_loss", "Val_v_loss", "Val_top1"):
        assert abs(got[tag][2] - want[tag][2]) <= RESUME_TOL * max(abs(want[tag][2]), 1.0), tag
    for got_m, want_m in ((resumed.model, full.model), (resumed.ckpt.read("last")["ema"], full.ckpt.read("last")["ema"])):
        got_sd = got_m if isinstance(got_m, dict) else got_m.state_dict()
        want_sd = want_m if isinstance(want_m, dict) else want_m.state_dict()
        for key, value in want_sd.items():
            assert torch.allclose(got_sd[key], value, rtol=0, atol=RESUME_TOL), key


def test_run_with_the_device_augment_stage_matches_the_jax_trainer(toy, port_run, tmp_path, mesh8, monkeypatch,
                                                                  capsys):
    """``device_augment: "auto"`` on a train pipeline whose lifted ops are
    deterministic (hflip, autocontrast and invert, each at p 1), before
    pet_synth's host geometry: both trainers run the stage in epoch 1 only,
    on the same host batches; the file's bars."""
    from visiondk_tpu_torch.ops.device_augment import make_device_augment

    cfg = json.loads(json.dumps(toy[0]))
    train = cfg["data"]["train"]
    train["augment"] = [{"random_horizonflip": {"p": 1.0}}, {"random_autocontrast": {"p": 1.0}},
                        {"random_invert": {"p": 1.0}}, *train["augment"][2:]]
    train["device_augment"] = "auto"
    monkeypatch.setattr(jax_trainer, "MetricsWriter", lambda logdir: JaxMetricsWriter(logdir, use_tensorboard=False))
    JaxCenterProcessor(json.loads(json.dumps(cfg)), project=str(tmp_path / "jax"), train=True, mesh=mesh8,
                       compute_dtype=jnp.float32, seed=0).run_classifier()
    cp = CenterProcessor(json.loads(json.dumps(cfg)), project=str(tmp_path / "port"), device="cpu",
                         compute_dtype=torch.float32, seed=0)
    calls = []
    strategy = cp._epoch_strategy

    def record(epoch, *args, **kwargs):
        calls.append(make_device_augment.calls)
        return strategy(epoch, *args, **kwargs)

    cp._epoch_strategy = record
    cp.run_classifier()
    calls.append(make_device_augment.calls)
    out = capsys.readouterr().out
    assert ("device augment split — host: [random_choice, to_tensor, normalize] | device: [random_horizonflip, "
            "random_autocontrast, random_invert]; data.train.device_augment_group_size 8 is not used") in out
    assert np.diff(calls).tolist() == [0, N_TRAIN * CLASSES // 16, 0]
    got, want = _metrics(tmp_path / "port"), _metrics(tmp_path / "jax")
    for epoch in range(EPOCHS):
        for tag in ("Train_loss", "Val_v_loss"):
            a, b = got[tag][epoch], want[tag][epoch]
            assert abs(a - b) <= LOSS_RTOL * abs(b), (tag, epoch, a, b)
        assert abs(got["Val_top1"][epoch] - want["Val_top1"][epoch]) * N_VAL * CLASSES <= 1 + 1e-9, epoch
    assert got["Train_loss"][1] != _metrics(port_run[0])["Train_loss"][1]  # the stage changed epoch 1's batches


def test_progressive_resize_rebuilds_the_device_stage(toy, tmp_path):
    """A lifted random_crop carries a static size: at each progressive-resize
    node the trainer rewrites it, rebuilds the stage and drops the cached
    steps that hold the old one (the JAX trainer's ``_epoch_strategy``)."""
    cfg = json.loads(json.dumps(toy[0]))
    normalize = cfg["data"]["train"]["augment"][-1]
    cfg["data"]["train"].update(device_augment="auto", augment=[
        {"resize_and_padding": {"size": SIZE, "training": True}}, {"random_horizonflip": {"p": 0.5}},
        {"random_crop": {"size": SIZE}}, "to_tensor", normalize])
    cfg["hyp"].update(epochs=9)
    cfg["hyp"]["strategy"]["prog_learn"] = True
    cp = CenterProcessor(cfg, project=str(tmp_path), device="cpu", compute_dtype=torch.float32, seed=0)
    dp = cp.data_processor
    assert dp.device_augment_cfg == [{"random_horizonflip": {"p": 0.5}}, {"random_crop": {"size": SIZE}}]
    assert cp.resize_chnodes == [1, 3, 5] and cp.imgsz_milestone == [16, 24, 32]
    for epoch, size in ((0, SIZE), (1, 16), (2, 16), (3, 24), (5, SIZE)):
        stage = cp.device_augment_fn
        cp._step_cache["cached"] = object()
        cp._epoch_strategy(epoch, cp.lossfn, aug_epoch=9)
        assert dp.device_augment_cfg[1] == {"random_crop": {"size": size}}, epoch
        assert (cp.device_augment_fn is not stage) == (epoch in (1, 3, 5)), epoch
        assert ("cached" in cp._step_cache) == (epoch not in (1, 3, 5)), epoch
        out = cp.device_augment_fn(epoch, torch.zeros((2, size + 4, size + 4, 3), dtype=torch.uint8))
        assert out.shape == (2, size, size, 3)


def _cli(module, argv):
    saved = sys.argv
    sys.argv = [module, *argv]
    try:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
    finally:
        sys.argv = saved


def test_cli_train_then_validate_reproduces_the_best_top1(toy, tmp_path, capsys):
    _, yaml_path = toy
    project = tmp_path / "exp"
    _cli("visiondk_tpu_torch.main", ["--cfgs", str(yaml_path), "--project", str(project), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "python -m visiondk_tpu_torch.validate" in out and "loaders: train PIL" in out
    assert (project / "last" / "state.pt").is_file() and (project / "config.yaml").is_file()
    best = json.loads((project / "best" / "meta.json").read_text())
    _cli("visiondk_tpu_torch.validate", ["--cfgs", str(project / "config.yaml"), "--weight", str(project / "best"),
                                         "--ema", "--device", "cpu"])
    out = capsys.readouterr().out
    top1 = float(re.search(r"'top1': ([0-9.e+-]+)", out).group(1))
    assert top1 == best["best_fitness"] == _metrics(project)["Val_top1"][best["epoch"]]


def test_cli_without_device_raises_without_a_gpu(toy, tmp_path):
    assert not torch.cuda.is_available()
    _, yaml_path = toy
    for module, argv in (("visiondk_tpu_torch.main", ["--cfgs", str(yaml_path), "--project", str(tmp_path / "x")]),
                         ("visiondk_tpu_torch.validate", ["--cfgs", str(yaml_path), "--weight", str(tmp_path / "b")])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _cli(module, argv)
    assert not (tmp_path / "x").exists()  # no run dir is made before the device check
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CenterProcessor(json.loads(json.dumps(toy[0])), project=str(tmp_path / "y"))


@pytest.mark.parametrize("flag", [["--distill"], ["--multihost"], ["--model_parallel", "2"]])
def test_cli_flags_of_unported_features_raise(toy, tmp_path, monkeypatch, flag):
    """A flag the run cannot honour raises before a run dir is made:
    ``--distill`` on a config without its student/teacher sections,
    ``--multihost`` with half a cluster environment (a bring-up that cannot
    complete never trains alone), ``--model_parallel 2`` in one process (it
    must divide the world size)."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "VDK_COORDINATOR_ADDRESS", "VDK_NUM_PROCESSES",
                "VDK_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError):
        _cli("visiondk_tpu_torch.main", ["--cfgs", str(toy[1]), "--project", str(tmp_path / "x"), "--device", "cpu",
                                         *flag])
    assert not (tmp_path / "x").exists()


