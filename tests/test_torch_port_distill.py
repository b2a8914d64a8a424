"""The port's distillation (``visiondk_tpu_torch/engine/distill.py``) against
the JAX package's (``visiondk_tpu/engine/distill.py``), the ``--distill``
CLI, ``EmbeddingDistillDataset``, and the fixed-order relative-position bias
gather of the Swin teacher (``models/backbones/swin.py::BiasGather``).

Setup: the student is a tiny ResNet (basic blocks, ``stage_sizes`` [1, 1, 1,
1]), the teacher a tiny Swin (patch 4, embed 16, depths (2, 2), heads (2,
4), window 4, MLP ratio 2, no stochastic depth), both registered in both
packages' registries, 32×32 images, 5 classes; on the CPU the port's
teacher runs the window kernels' plain versions and the JAX teacher its XLA
path. Weights are drawn from numpy seeds and carried across by the bridge;
inputs are numpy-seeded.

Tolerances: three distillation steps of the port in f32 against the JAX
step in float64 (``jax.enable_x64``, both models at ``dtype`` float64; the
JAX f32 run on the CPU is the less exact of the two, see
``test_torch_port_resnet.py``): the loss and its CE and KL terms within
1e-4 relative at the first step (the same weights; the KL at T 4 is a small
difference of the teacher's and the student's log-probabilities, and the
f32 teacher's rounding moves it 2.7e-5) and 1e-3 at the next two (at lr
0.05 and momentum 0.9 the tiny ResNet's f32 updates, through BatchNorm over
4 samples a channel, carry the f32 gradient's rounding into the next
losses: the embedding steps' 2nd and 3rd losses move 1.2e-4 and 2.9e-4 from
float64, the updates after three steps ~1% of their norm); the first
step's updates within 1e-3 of their tensor's norm (plus an f32 spacing an
entry); the embedding distillation steps (cosine, MSE; the tiny ResNet's
CNN-map neck) likewise. The 2-epoch
``DistillCenterProcessor`` run against the JAX one: per-epoch train loss
and ``v_loss`` within 5e-3 relative (the multi-label run test's bar: a
ResNet's f32 gradients drift with the summation order), val top1 within one
image. The bias gather's gradient equals ``index_select``'s within 1e-6 of
its largest entry, and is bit-identical across repeats.
"""

import json
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

import visiondk_tpu.data.native as jax_native
import visiondk_tpu.engine.trainer as jax_trainer
import visiondk_tpu_torch.data.native as port_native
from visiondk_tpu.config.loader import yaml_load as jax_yaml_load
from visiondk_tpu.data.datasets import EmbeddingDistillDataset as JaxEmbeddingDistillDataset
from visiondk_tpu.engine.checkpoint import CheckpointManager as JaxCheckpointManager
from visiondk_tpu.engine.distill import DistillCenterProcessor as JaxDistillCenterProcessor
from visiondk_tpu.engine.distill import make_distill_step as jax_make_distill_step
from visiondk_tpu.engine.distill import make_embed_distill_step as jax_make_embed_distill_step
from visiondk_tpu.engine.optim import create_optimizer as jax_create_optimizer
from visiondk_tpu.engine.state import create_train_state as jax_create_train_state
from visiondk_tpu.engine.steps import StepConfig as JaxStepConfig
from visiondk_tpu.losses import losses as JL
from visiondk_tpu.models import get_model as jax_get_model
from visiondk_tpu.models.backbones import BACKBONES as JAX_BACKBONES
from visiondk_tpu.models.backbones.resnet import _resnet as jax_resnet
from visiondk_tpu.models.backbones.swin import _swin as jax_swin
from visiondk_tpu.models.convert import _flatten, _unflatten, save_converted
from visiondk_tpu.utils.metrics_writer import MetricsWriter as JaxMetricsWriter
from visiondk_tpu_torch.config import check, yaml_dump
from visiondk_tpu_torch.data.datasets import EmbeddingDistillDataset
from visiondk_tpu_torch.engine.checkpoint import CheckpointManager
from visiondk_tpu_torch.engine.distill import DistillCenterProcessor, make_distill_step, make_embed_distill_step
from visiondk_tpu_torch.engine.optim import create_optimizer
from visiondk_tpu_torch.engine.state import create_train_state
from visiondk_tpu_torch.engine.steps import StepConfig
from visiondk_tpu_torch.losses import create_lossfn
from visiondk_tpu_torch.models import BACKBONES, get_model
from visiondk_tpu_torch.models.backbones.resnet import _resnet
from visiondk_tpu_torch.models.backbones.swin import BiasGather, _bias_index, _bias_readers, _swin, bias_readers
from visiondk_tpu_torch.models.convert import load_jax_params, state_dict_from_jax

STUDENT, TEACHER = "resnet_tiny_port_distill_test", "swin_tiny_port_distill_test"
IMG, CLASSES = 32, 5
SWIN_KWARGS = {"mlp_ratio": 2.0, "stochastic_depth_prob": 0.0}
DISTILL = {"cls_weight": 0.5, "kl_weight": 0.5, "temperature": 4.0}
N_TRAIN, N_VAL = 8, 3  # per class (the run tests)
EPOCHS = 2
STEP_RTOL = (1e-4, 1e-3, 1e-3)  # steps 1, 2, 3
RUN_RTOL = 5e-3


@pytest.fixture(scope="module", autouse=True)
def tiny_models_registered():
    JAX_BACKBONES.register(jax_resnet([1, 1, 1, 1], "basic"), name=STUDENT)
    BACKBONES.register(_resnet([1, 1, 1, 1], "basic"), name=STUDENT)
    JAX_BACKBONES.register(jax_swin(16, (2, 2), (2, 4), window_size=4), name=TEACHER)
    BACKBONES.register(_swin(16, (2, 2), (2, 4), window_size=4), name=TEACHER)
    yield
    for name in (STUDENT, TEACHER):
        del JAX_BACKBONES._store[name]
        del BACKBONES._store[name]


def _student_cfg():
    return {"task": "classification", "name": STUDENT, "num_classes": CLASSES, "image_size": IMG, "kwargs": {}}


def _teacher_cfg():
    return {"task": "classification", "name": TEACHER, "num_classes": CLASSES, "image_size": IMG,
            "kwargs": dict(SWIN_KWARGS)}


def _random_tree(variables, seed):
    """Every JAX tensor re-drawn from a numpy seed: kernels at lecun scale,
    norm scales near 1, running variances positive, the rest small."""
    rng = np.random.default_rng(seed)
    tree = {}
    for t in ("params", "batch_stats"):
        flat = {p: np.asarray(v) for p, v in _flatten(dict(variables.get(t, {}))).items()}
        for p, v in flat.items():
            if p.endswith("/kernel"):
                flat[p] = (rng.normal(size=v.shape) / np.sqrt(np.prod(v.shape[:-1]))).astype(np.float32)
            elif p.endswith("/var"):
                flat[p] = (0.5 + rng.random(v.shape)).astype(np.float32)
            elif p.endswith("/scale"):
                flat[p] = (1.0 + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
            else:
                flat[p] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
        tree[t] = flat
    return tree


def _jax_vars(tree):
    return {t: jax.tree_util.tree_map(jnp.asarray, _unflatten(flat)) for t, flat in tree.items() if flat}


def _init(cfg, seed, **kwargs):
    jmodel = jax_get_model(cfg)
    return jmodel, _random_tree(jmodel.init(jax.random.key(0), jnp.zeros((1, IMG, IMG, 3)), train=False, **kwargs),
                                seed)


def _flat(tree):
    return {p: np.asarray(v) for p, v in _flatten(dict(tree)).items()}


def _assert_updates(module, theta0, params, stats, rtol=1e-3):
    """The student's updates against JAX's (flat trees), by tensor norm, and its BN statistics."""
    want = state_dict_from_jax(module, {"params": params, "batch_stats": stats})
    got = module.state_dict()
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[key].numpy(), value.numpy(), rtol=1e-3, atol=3e-4, err_msg=key)
            continue
        got_d, want_d = (got[key] - theta0[key]).double().numpy(), (value - theta0[key]).double().numpy()
        spacing = np.sqrt(want_d.size) * np.spacing(np.abs(theta0[key].numpy()).max())
        assert np.linalg.norm(got_d - want_d) <= rtol * np.linalg.norm(want_d) + spacing, key


def _batches(n, labels=True, seed=0, feat_dim=None):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"image": rng.integers(0, 256, size=(4, IMG, IMG, 3), dtype=np.uint8)}
        if labels:
            b["label"] = rng.integers(0, CLASSES, size=4).astype(np.int32)
        if feat_dim:
            b["feature"] = rng.normal(size=(4, feat_dim)).astype(np.float32)
        out.append(b)
    return out


def _sgd():
    """SGD at lr 0.05, momentum 0.9, clip 10, on both sides."""
    return (jax_create_optimizer("sgd", lambda c: 0.05, 0.0, lambda c: 0.9),
            create_optimizer("sgd", lambda c: 0.05, 0.0, lambda c: 0.9))


# ---------------------------------------------------------------- the steps


def _f64(tree):
    return {t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), _unflatten(flat))
            for t, flat in tree.items() if flat}


def test_three_distill_steps_match_jax():
    stree = _init(_student_cfg(), seed=1)[1]
    ttree = _init(_teacher_cfg(), seed=2)[1]
    student = load_jax_params(get_model(_student_cfg(), device="cpu"), stree)
    teacher = load_jax_params(get_model(_teacher_cfg(), device="cpu"), ttree).requires_grad_(False)
    theta0 = {k: v.clone() for k, v in student.state_dict().items()}
    jtx, tx = _sgd()
    state = create_train_state(student, tx)
    step = make_distill_step(student, teacher, tx, create_lossfn("ce", label_smooth=0.05), StepConfig(),
                             torch.Generator().manual_seed(0), **DISTILL)
    with jax.enable_x64(True):
        jstate = jax_create_train_state(_f64(stree), jtx)
        jstep = jax_make_distill_step(jax_get_model(_student_cfg(), dtype=jnp.float64),
                                      jax_get_model(_teacher_cfg(), dtype=jnp.float64), _f64(ttree), jtx,
                                      JL.create_lossfn("ce", label_smooth=0.05), JaxStepConfig(), jax.random.key(0),
                                      **DISTILL)
        for i, (batch, rtol) in enumerate(zip(_batches(3), STEP_RTOL)):
            jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.float64(0.0))
            m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
            assert set(m) == {"loss", "loss_cls", "loss_kl"}
            for k in m:
                np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=rtol, err_msg=k)
            if i == 0:
                _assert_updates(student, theta0, _flat(jstate.params), _flat(jstate.batch_stats))
    assert state.step == 3 and state.ema_updates == 3
    assert not teacher.training and all(p.grad is None for p in teacher.parameters())


@pytest.mark.parametrize("loss_type", ["cosine", "mse"])
def test_embedding_distill_steps_match_jax(loss_type):
    cfg = {"task": "cbir", "backbone": {STUDENT: {"feat_dim": 16, "image_size": IMG}}}
    jmodel = jax_get_model(cfg)
    tree = _random_tree(jmodel.init(jax.random.key(0), jnp.zeros((1, IMG, IMG, 3)), train=False,
                                    method=jmodel.embed), seed=3)
    port = load_jax_params(get_model(cfg, device="cpu"), tree)
    theta0 = {k: v.clone() for k, v in port.state_dict().items()}
    jtx, tx = _sgd()
    state = create_train_state(port, tx)
    step = make_embed_distill_step(port, tx, StepConfig(task="embedding"), torch.Generator().manual_seed(0),
                                   loss_type)
    with jax.enable_x64(True):
        jstate = jax_create_train_state(_f64(tree), jtx)
        jstep = jax_make_embed_distill_step(jax_get_model(cfg, dtype=jnp.float64), jtx,
                                            JaxStepConfig(task="embedding"), jax.random.key(0), loss_type)
        for i, (batch, rtol) in enumerate(zip(_batches(3, labels=False, seed=4, feat_dim=16), STEP_RTOL)):
            jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.float64(0.0))
            m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
            np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=rtol)
            if i == 0:
                _assert_updates(port, theta0, _flat(jstate.params), _flat(jstate.batch_stats))


@pytest.mark.parametrize("kind", ["logits", "embedding"])
def test_distill_steps_tick_the_ema_at_every_mini_step_as_jax(kind):
    """``accumulate: 2`` (``optax.MultiSteps`` on the JAX side): the JAX
    distillation steps update the EMA and count ``ema_updates`` at every
    mini-step, the one that applies no update included, and so do the
    port's. After one round the parameters are JAX's (the first step's bar
    above), both counts are 2, and every EMA tensor is within 1e-5 of its
    largest entry (the update's f32 rounding, ~1e-3 of the update, moves
    entries near 0 by more than 1e-5 of themselves)."""
    if kind == "logits":
        cfg = _student_cfg()
        tree = _init(cfg, seed=5)[1]
        teacher_tree = _init(_teacher_cfg(), seed=6)[1]
        teacher = load_jax_params(get_model(_teacher_cfg(), device="cpu"), teacher_tree).requires_grad_(False)
        batches = _batches(2, seed=7)
    else:
        cfg = {"task": "cbir", "backbone": {STUDENT: {"feat_dim": 16, "image_size": IMG}}}
        jmodel = jax_get_model(cfg)
        tree = _random_tree(jmodel.init(jax.random.key(0), jnp.zeros((1, IMG, IMG, 3)), train=False,
                                        method=jmodel.embed), seed=5)
        batches = _batches(2, labels=False, seed=7, feat_dim=16)
    port = load_jax_params(get_model(cfg, device="cpu"), tree)
    theta0 = {k: v.clone() for k, v in port.state_dict().items()}
    jtx = optax.MultiSteps(jax_create_optimizer("sgd", lambda c: 0.05, 0.0, lambda c: 0.9), 2)
    tx = create_optimizer("sgd", lambda c: 0.05, 0.0, lambda c: 0.9, accumulate=2)
    state = create_train_state(port, tx)
    if kind == "logits":
        step = make_distill_step(port, teacher, tx, create_lossfn("ce", label_smooth=0.05), StepConfig(),
                                 torch.Generator().manual_seed(0), **DISTILL)
    else:
        step = make_embed_distill_step(port, tx, StepConfig(task="embedding"), torch.Generator().manual_seed(0))
    with jax.enable_x64(True):
        jstate = jax_create_train_state(_f64(tree), jtx)
        if kind == "logits":
            jstep = jax_make_distill_step(jax_get_model(cfg, dtype=jnp.float64),
                                          jax_get_model(_teacher_cfg(), dtype=jnp.float64), _f64(teacher_tree), jtx,
                                          JL.create_lossfn("ce", label_smooth=0.05), JaxStepConfig(),
                                          jax.random.key(0), **DISTILL)
        else:
            jstep = jax_make_embed_distill_step(jax_get_model(cfg, dtype=jnp.float64), jtx,
                                                JaxStepConfig(task="embedding"), jax.random.key(0))
        for i, batch in enumerate(batches):
            jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.float64(0.0))
            step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
            assert state.ema_updates == int(jstate.ema_updates) == i + 1
            assert state.optimizer.count == i  # the second mini-step applies the round
        params, stats = _flat(jstate.params), _flat(jstate.batch_stats)
        ema = state_dict_from_jax(port, {"params": _flat(jstate.ema_params),
                                         "batch_stats": _flat(jstate.ema_batch_stats)})
    assert state.step == 2
    _assert_updates(port, theta0, params, stats)
    for key, value in state.ema_model.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            want = ema[key].numpy()
            np.testing.assert_allclose(value.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max(), err_msg=key)


# ---------------------------------------------------------------- the run and the CLI


@pytest.fixture(autouse=True)
def pil_decode(monkeypatch):
    monkeypatch.setattr(jax_native, "native_available", lambda: False)
    monkeypatch.setattr(port_native, "native_available", lambda: False)


@pytest.fixture(scope="module")
def toy(tmp_path_factory, tiny_models_registered):
    """The distillation config (student: pet_synth.yaml cut to the tiny
    ResNet at 32 px, 2 epochs, ``device_augment: false``; the tiny Swin
    teacher) with the teacher's weights saved as a JAX and as a port
    checkpoint, and the student's initial weights as a converted npz."""
    root = tmp_path_factory.mktemp("toy_distill")
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
    student = jax_yaml_load("configs/classification/pet_synth.yaml")
    student["model"].update(name=STUDENT, image_size=IMG, num_classes=CLASSES)
    jstudent, stree = _init(student["model"], seed=5)
    save_converted({t: {p.removeprefix("backbone/"): v for p, v in flat.items()} for t, flat in stree.items()},
                   str(root / "student.npz"))
    student["model"]["convert_npz"] = str(root / "student.npz")
    student["data"].update(root=str(root / "data"), nw=2)
    student["data"]["train"] = {"bs": 16, "device_augment": False, "aug_epoch": 999, "class_aug": None,
                                "base_aug": None, "augment": [
                                    {"random_horizonflip": {"p": 0.5}},
                                    {"resize_and_padding": {"size": IMG, "training": True}},
                                    {"to_tensor": "no_params"},
                                    {"normalize": {"mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]}}]}
    student["data"]["val"]["bs"] = 16
    student["data"]["val"]["augment"][0]["resize_and_padding"]["size"] = IMG
    student["hyp"]["epochs"] = EPOCHS
    check("classification", student)

    jteacher, ttree = _init(_teacher_cfg(), seed=6)
    jstate = jax_create_train_state(_jax_vars(ttree), optax.sgd(0.1))
    jckpt = JaxCheckpointManager(root / "jax_teacher", async_save=False, writer=True)
    jckpt.save("best", jstate, 0, 0.0)
    jckpt.wait()
    model = load_jax_params(get_model(_teacher_cfg(), device="cpu"), ttree)
    ckpt = CheckpointManager(root / "port_teacher", writer=True)
    ckpt.save("best", create_train_state(model, _sgd()[1]), 0, 0.0)
    ckpt.wait()
    cfgs = {"student": student, "teacher": {"model": _teacher_cfg(), "ema": True}, "distill": dict(DISTILL)}
    return root, cfgs


def _metrics(project: Path) -> dict:
    out = {}
    for line in (project / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        out.setdefault(rec["tag"], {})[rec["step"]] = rec["value"]
    return out


def _with_weight(cfgs, weight):
    out = json.loads(json.dumps(cfgs))
    out["teacher"]["weight"] = str(weight)
    return out


def test_distill_run_matches_the_jax_processor(toy, tmp_path, mesh8, monkeypatch):
    root, cfgs = toy
    monkeypatch.setattr(jax_trainer, "MetricsWriter", lambda logdir: JaxMetricsWriter(logdir, use_tensorboard=False))
    JaxDistillCenterProcessor(_with_weight(cfgs, root / "jax_teacher" / "best"), project=str(tmp_path / "jax"),
                              train=True, mesh=mesh8, compute_dtype=jnp.float32, seed=0).run_classifier()
    cp = DistillCenterProcessor(_with_weight(cfgs, root / "port_teacher" / "best"), project=str(tmp_path / "port"),
                                device="cpu", compute_dtype=torch.float32, seed=0)
    cp.run_classifier()
    got, want = _metrics(tmp_path / "port"), _metrics(tmp_path / "jax")
    for epoch in range(EPOCHS):
        for tag in ("Train_loss", "Val_v_loss"):
            assert abs(got[tag][epoch] - want[tag][epoch]) <= RUN_RTOL * abs(want[tag][epoch]), (tag, epoch)
        assert abs(got["Val_top1"][epoch] - want["Val_top1"][epoch]) * N_VAL * CLASSES <= 1 + 1e-9, epoch


def test_teacher_restores_the_ema_or_the_live_weights_and_refuses_another_model(toy, tmp_path):
    root, cfgs = toy
    saved = CheckpointManager(root / "port_teacher").read("best")
    for ema in (True, False):
        c = _with_weight(cfgs, root / "port_teacher" / "best")
        c["teacher"]["ema"] = ema
        cp = DistillCenterProcessor(c, project=str(tmp_path / str(ema)), device="cpu", compute_dtype=torch.float32)
        want = saved["ema" if ema else "model"]
        for key, value in cp.teacher_model.state_dict().items():
            assert torch.equal(value, want[key].to(value.dtype)), key
        assert not any(p.requires_grad for p in cp.teacher_model.parameters())
    other = _with_weight(cfgs, root / "port_teacher" / "best")
    other["teacher"]["model"] = _student_cfg()
    with pytest.raises(RuntimeError, match="state_dict"):
        DistillCenterProcessor(other, project=str(tmp_path / "other"), device="cpu")


def test_distill_cli_trains_and_validate_reproduces_the_students_best(toy, tmp_path, monkeypatch, capsys):
    """``python -m visiondk_tpu_torch.main --distill`` (bf16 on the CPU) and
    ``validate`` on the student's best checkpoint."""
    root, cfgs = toy
    path = tmp_path / "distill.yaml"
    yaml_dump(_with_weight(cfgs, root / "port_teacher" / "best"), path)
    project = tmp_path / "run"
    for module, argv in (("visiondk_tpu_torch.main", ["--cfgs", str(path), "--distill", "--project", str(project)]),
                         ("visiondk_tpu_torch.validate", ["--cfgs", str(project / "config.yaml"), "--weight",
                                                          str(project / "best"), "--ema"])):
        monkeypatch.setattr(sys, "argv", [module, *argv, "--device", "cpu"])
        capsys.readouterr()
        runpy.run_module(module, run_name="__main__", alter_sys=True)
    out = capsys.readouterr().out
    best = json.loads((project / "best" / "meta.json").read_text())
    top1 = float(next(ln for ln in out.splitlines() if ln.startswith("{'top1'")).split(",")[0].split(": ")[1])
    assert top1 == _metrics(project)["Val_top1"][best["epoch"]] == best["best_fitness"]
    assert sorted(_metrics(project)["Train_loss"]) == list(range(EPOCHS))


def test_distill_cli_refuses_a_student_of_another_task(toy, tmp_path, monkeypatch):
    root, cfgs = toy
    bad = _with_weight(cfgs, root / "port_teacher" / "best")
    bad["student"]["model"]["task"] = "cbir"
    path = tmp_path / "bad.yaml"
    yaml_dump(bad, path)
    monkeypatch.setattr(sys, "argv", ["main", "--cfgs", str(path), "--distill", "--project", str(tmp_path / "x"),
                                      "--device", "cpu"])
    with pytest.raises(ValueError, match="classification student"):
        runpy.run_module("visiondk_tpu_torch.main", run_name="__main__", alter_sys=True)


# ---------------------------------------------------------------- the dataset


def test_embedding_distill_dataset_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    (tmp_path / "img").mkdir()
    (tmp_path / "feat").mkdir()
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, size=(20, 24, 3), dtype=np.uint8)).save(tmp_path / "img" / f"{i}.jpg")
        if i != 3:  # image 3 has no feature
            np.save(tmp_path / "feat" / f"{i}.npy", rng.normal(size=8))
    (tmp_path / "exclude.txt").write_text(f"{tmp_path / 'feat' / '1.npy'}\n")
    for exclude in (None, str(tmp_path / "exclude.txt")):
        got = EmbeddingDistillDataset(str(tmp_path / "img"), str(tmp_path / "feat"), exclude=exclude)
        want = JaxEmbeddingDistillDataset(str(tmp_path / "img"), str(tmp_path / "feat"), exclude=exclude)
        assert got.images == want.images and got.features == want.features and len(got) == (4 if exclude is None else 3)
        for i in range(len(got)):
            (a, fa), (b, fb) = got[i], want[i]
            np.testing.assert_array_equal(a, b)
            assert fa.dtype == fb.dtype == np.float32
            np.testing.assert_array_equal(fa, fb)


# ---------------------------------------------------------------- fault 6: the bias gather


@pytest.mark.parametrize("ws", [4, 7])
def test_bias_gather_gradient_is_index_selects_in_a_fixed_order(ws):
    rng = np.random.default_rng(ws)
    table = torch.from_numpy(rng.normal(size=((2 * ws - 1) ** 2, 3)).astype(np.float32)).requires_grad_()
    grad = torch.from_numpy(rng.normal(size=(ws**4, 3)).astype(np.float32))
    idx, readers = _bias_index(ws, table.device), _bias_readers(ws, table.device)
    out = BiasGather.apply(table, idx, readers)
    torch.testing.assert_close(out, table.index_select(0, idx), rtol=0, atol=0)  # the forward is the exact gather
    want, = torch.autograd.grad(table.index_select(0, idx), table, grad)
    got = [torch.autograd.grad(BiasGather.apply(table, idx, readers), table, grad)[0] for _ in range(3)]
    np.testing.assert_allclose(got[0].numpy(), want.numpy(), rtol=0, atol=1e-6 * want.abs().max().item())
    assert all(torch.equal(got[0], g) for g in got[1:])


@pytest.mark.parametrize("ws", [2, 4, 7])
def test_bias_readers_cover_every_position_once(ws):
    readers = bias_readers(ws)
    flat = readers[readers < ws**4]
    assert sorted(flat.tolist()) == list(range(ws**4))
    assert readers.shape == ((2 * ws - 1) ** 2, ws * ws)  # the centre offset is read by every token
