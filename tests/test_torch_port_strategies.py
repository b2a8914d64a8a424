"""The port's train-step strategies against the JAX package: OHEM, mixup and
gradient accumulation (``optax.MultiSteps``).

Inputs come from numpy seeds and go to both frameworks as the same arrays.
Where the JAX step draws a mixup permutation from its key, the port's
``mixup_permutation`` is patched to return that permutation, and both take
the same λ: the two sides then compute the same function.

Tolerances. ``ohem_mask`` is held exactly (a 0/1 weight from a sort).
Steps of the tiny ViT (patch 8, width 64, depth 2, 32×32, f32 on both
sides): the loss within 1e-5 relative, and every parameter's and EMA
tensor's move from the initial weights within 1e-3 of its largest entry, the
bars of ``test_torch_port_train.py``; a mini-step that applies no update
must leave parameters and EMA exactly as they were, on both sides. The
schedules' lr within 1e-9 (both evaluate the same f32 epoch). The run
against the JAX trainer holds ``test_torch_port_run.py``'s bars (train and
val loss 1e-4 relative, top1 within one image), and a run killed in the
middle of an accumulation round and resumed equals the uninterrupted one to
1e-6.
"""

import itertools
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import visiondk_tpu.data.native as jax_native
import visiondk_tpu.engine.trainer as jax_trainer
import visiondk_tpu_torch.data.native as port_native
from visiondk_tpu.config.loader import yaml_load as jax_yaml_load
from visiondk_tpu.engine.state import create_train_state as jax_create_train_state
from visiondk_tpu.engine.steps import OHEMConfig as JaxOHEMConfig
from visiondk_tpu.engine.steps import StepConfig as JaxStepConfig
from visiondk_tpu.engine.steps import make_train_step as jax_make_train_step
from visiondk_tpu.engine.steps import ohem_mask as jax_ohem_mask
from visiondk_tpu.engine.trainer import CenterProcessor as JaxCenterProcessor
from visiondk_tpu.losses import losses as JL
from visiondk_tpu.models import get_model as jax_get_model
from visiondk_tpu.models.backbones import BACKBONES as JAX_BACKBONES
from visiondk_tpu.models.backbones.vit import _vit as jax_vit
from visiondk_tpu.models.convert import _flatten, _unflatten, save_converted
from visiondk_tpu.utils.metrics_writer import MetricsWriter as JaxMetricsWriter
from visiondk_tpu_torch.config import check, yaml_dump
from visiondk_tpu_torch.engine import steps as port_steps
from visiondk_tpu_torch.engine.checkpoint import CheckpointManager
from visiondk_tpu_torch.engine.state import create_train_state
from visiondk_tpu_torch.engine.steps import OHEMConfig, StepConfig, make_train_step, ohem_mask
from visiondk_tpu_torch.engine.trainer import CenterProcessor, build_tx, logged_lr
from visiondk_tpu_torch.losses import create_lossfn
from visiondk_tpu_torch.models import BACKBONES, get_model
from visiondk_tpu_torch.models.backbones.vit import _vit
from visiondk_tpu_torch.models.convert import load_jax_params, state_dict_from_jax

TINY = "vit_tiny_patch8_port_strategies_test"
IMG = 32
CLASSES = 7
# the hyp: section of configs/classification/pet_synth.yaml (optimizer fields)
PET_SYNTH_HYP = {
    "epochs": 6, "lr0": 0.01, "lrf_ratio": None, "momentum": 0.937, "weight_decay": 0.0005,
    "warmup_momentum": 0.8, "warm_ep": 1, "optimizer": ["sgd", False], "scheduler": "cosine_with_warm",
}
LOSS = ("ce", {"label_smooth": 0.05})


@pytest.fixture(scope="module", autouse=True)
def tiny_vit_registered():
    JAX_BACKBONES.register(jax_vit(8, 64, 2, 4), name=TINY)
    BACKBONES.register(_vit(8, 64, 2, 4), name=TINY)
    yield
    del JAX_BACKBONES._store[TINY]
    del BACKBONES._store[TINY]


def _f(x) -> float:
    return float(np.asarray(x))


# ---------------------------------------------------------------- OHEM


OHEM_CASES = {
    # name: (config, labels of the 12-row batch; 255 is ignored)
    "pet_synth": (OHEMConfig(8, 0.7, 255), [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]),
    "kth_above_thresh": (OHEMConfig(3, 0.05, 255), [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 0, 1]),
    "ignore_index": (OHEMConfig(2, 0.05, 255), [0, 255, 2, 255, 4, 5, 255, 7, 8, 9, 0, 1]),
    "min_kept_at_least_batch": (OHEMConfig(12, 0.05, 255), [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 0, 1]),
    "min_kept_past_batch_ignored": (OHEMConfig(40, 0.01, 9), [9, 1, 2, 9, 4, 5, 6, 7, 8, 9, 0, 1]),
}


@pytest.mark.parametrize("case", list(OHEM_CASES))
def test_ohem_mask_matches_jax(case):
    cfg, labels = OHEM_CASES[case]
    rng = np.random.default_rng(5)
    logits = (3 * rng.normal(size=(len(labels), 10))).astype(np.float32)
    labels = np.asarray(labels, np.int32)
    want = np.asarray(jax_ohem_mask(jnp.asarray(logits), jnp.asarray(labels), JaxOHEMConfig(*(
        cfg.min_kept, cfg.thresh, cfg.ignore_index))))
    got = ohem_mask(torch.from_numpy(logits), torch.from_numpy(labels).long(), cfg)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # thresh 0.7 over 10 classes keeps every row; the other cases drop some
    assert 0 < want.sum() < len(labels) or case == "pet_synth"


# ---------------------------------------------------------------- steps of a tiny ViT


def _cls_cfg():
    return {"task": "classification", "name": TINY, "num_classes": CLASSES, "image_size": IMG, "kwargs": {}}


def _batches(n, b=4, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 256, size=(b, IMG, IMG, 3), dtype=np.uint8),
             "label": rng.integers(0, CLASSES, size=b).astype(np.int32)} for _ in range(n)]


def _both_models():
    """The JAX model, its initial params and the port model holding them."""
    cfg = _cls_cfg()
    jmodel = jax_get_model(cfg)
    variables = jmodel.init(jax.random.key(1), jnp.zeros((1, IMG, IMG, 3)), train=False)
    rng = np.random.default_rng(6)
    params = {p: (0.1 * rng.normal(size=np.shape(v))).astype(np.float32) if not p.endswith("scale")
              else (1.0 + 0.1 * rng.normal(size=np.shape(v))).astype(np.float32)
              for p, v in _flatten(dict(variables["params"])).items()}
    port = load_jax_params(get_model(cfg, device="cpu"), {"params": params})
    return jmodel, params, port


def _jax_tx(hyp, spe=2, discrete=True):
    fake = SimpleNamespace(hyp_cfg=hyp, opt_name="sgd", layer_wise=False, model_cfg={})
    return JaxCenterProcessor._build_tx(fake, spe, discrete), fake


def _check_moved(module, jtree, theta0, what):
    """Every tensor's move from theta0 against the JAX tree's: 1e-3 of its
    largest entry, so exactly 0 where the JAX tensor has not moved."""
    want = state_dict_from_jax(module, {"params": {p: np.asarray(v) for p, v in _flatten(dict(jtree)).items()}})
    for key, value in module.state_dict().items():
        got_d = (value - theta0[key]).numpy()
        want_d = (want[key] - theta0[key]).numpy()
        np.testing.assert_allclose(got_d, want_d, rtol=1e-3, atol=1e-3 * np.abs(want_d).max(),
                                   err_msg=f"{what} {key}")


def _jax_perm(base_rng, step, b):
    perm_rng, _ = jax.random.split(jax.random.fold_in(base_rng, step))
    return np.array(jax.random.permutation(perm_rng, b))


def test_mixup_and_ohem_train_steps_match_jax(monkeypatch):
    """Three steps with mixup and OHEM on (OHEM weights both mixed loss terms
    with the mask of the clean batch), at the λs a run would draw."""
    jmodel, params, port = _both_models()
    theta0 = {k: v.clone() for k, v in port.state_dict().items()}
    ohem = (2, 0.1, 255)  # keeps the rows least sure of their class, not all four
    jtx, _ = _jax_tx(PET_SYNTH_HYP)
    jstate = jax_create_train_state({"params": jax.tree_util.tree_map(jnp.asarray, _unflatten(params))}, jtx)
    base_rng = jax.random.key(0)
    jstep = jax_make_train_step(jmodel, jtx, JL.create_lossfn(LOSS[0], **LOSS[1]),
                                JaxStepConfig(mixup=True, ohem=JaxOHEMConfig(*ohem)), base_rng, donate=False)
    tx = build_tx(PET_SYNTH_HYP, 2, True)
    state = create_train_state(port, tx)
    step = make_train_step(port, tx, create_lossfn(LOSS[0], **LOSS[1]),
                           StepConfig(mixup=True, ohem=OHEMConfig(*ohem)), torch.Generator().manual_seed(0))
    count = itertools.count()
    monkeypatch.setattr(port_steps, "mixup_permutation",
                        lambda b, generator: torch.from_numpy(_jax_perm(base_rng, next(count), b)))
    masks = []
    real_mask = port_steps.ohem_mask
    monkeypatch.setattr(port_steps, "ohem_mask", lambda *a: masks.append(real_mask(*a)) or masks[-1])
    for i, batch in enumerate(_batches(3)):
        lam = float(np.random.default_rng([0, 1, i]).beta(0.2, 0.2))
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.float32(lam))
        metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, lam)
        np.testing.assert_allclose(metrics["loss"].item(), _f(jmetrics["loss"]), rtol=1e-5)
    assert len(masks) == 3 and all(0 < m.sum().item() < 4 for m in masks)  # the mask bites
    assert state.step == 3 and state.ema_updates == 3 and state.optimizer.count == 3
    _check_moved(port, jstate.params, theta0, "update")
    _check_moved(state.ema_model, jstate.ema_params, theta0, "ema")


def test_ohem_forward_leaves_batchnorm_statistics_alone():
    """The OHEM forward runs in train mode (batch statistics, the loss
    forward's dropout draws) but, as flax's ``mutable=False``, updates no
    running statistic: a step with OHEM leaves the same BatchNorm state as
    one without."""
    cfg = {"task": "classification", "name": "resnet18", "num_classes": 3, "image_size": 32}
    batch = {k: torch.from_numpy(v) for k, v in _batches(1, b=4, seed=2)[0].items()}
    batch["label"] = batch["label"] % 3
    buffers = []
    for ohem in (None, OHEMConfig(8, 0.7, 255)):
        model = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        tx = build_tx(PET_SYNTH_HYP, 2, True)
        state = create_train_state(model, tx)
        make_train_step(model, tx, create_lossfn("ce"), StepConfig(ohem=ohem), torch.Generator().manual_seed(0))(
            state, batch)
        buffers.append({k: v.clone() for k, v in model.named_buffers()})
    assert buffers[0].keys() == buffers[1].keys() and buffers[0]
    for key, value in buffers[0].items():
        assert torch.equal(value, buffers[1][key]), key


@pytest.mark.parametrize("k", [2, 3])
def test_accumulation_matches_optax_multisteps(k):
    """``hyp.accumulate`` = k through the trainers' optimizers
    (``optax.MultiSteps`` in the JAX package): 2k mini-steps, checked after
    each; parameters and EMA move only on every k-th."""
    hyp = {**PET_SYNTH_HYP, "accumulate": k}
    jmodel, params, port = _both_models()
    theta0 = {k_: v.clone() for k_, v in port.state_dict().items()}
    jtx, _ = _jax_tx(hyp)
    jstate = jax_create_train_state({"params": jax.tree_util.tree_map(jnp.asarray, _unflatten(params))}, jtx)
    jstep = jax_make_train_step(jmodel, jtx, JL.create_lossfn(LOSS[0], **LOSS[1]), JaxStepConfig(),
                                jax.random.key(0), donate=False)
    tx = build_tx(hyp, 2, True)
    assert tx.accumulate == k
    state = create_train_state(port, tx)
    step = make_train_step(port, tx, create_lossfn(LOSS[0], **LOSS[1]), StepConfig(), torch.Generator().manual_seed(0))
    for i, batch in enumerate(_batches(2 * k, seed=1)):
        jstate, jmetrics = jstep(jstate, {k_: jnp.asarray(v) for k_, v in batch.items()}, jnp.float32(0.0))
        metrics = step(state, {k_: torch.from_numpy(v) for k_, v in batch.items()})
        np.testing.assert_allclose(metrics["loss"].item(), _f(jmetrics["loss"]), rtol=1e-5)
        applied = (i + 1) // k
        assert (state.step, state.optimizer.count, state.ema_updates) == (i + 1, applied, applied)
        assert int(jstate.ema_updates) == applied and int(jstate.opt_state.mini_step) == state.optimizer.mini_step
        assert (state.optimizer.acc_grads is None) == ((i + 1) % k == 0)
        _check_moved(port, jstate.params, theta0, f"update after mini-step {i}")
        _check_moved(state.ema_model, jstate.ema_params, theta0, f"ema after mini-step {i}")


SCHEDULE_CASES = {
    # name: (steps per epoch, accumulate, discrete per epoch)
    "k2_discrete": (7, 2, True),
    "k3_fraction_of_two": (2, 3, True),
    "k4_per_batch": (10, 4, False),
    "k3_per_batch": (5, 3, False),
}


@pytest.mark.parametrize("case", list(SCHEDULE_CASES))
def test_schedules_run_on_applied_counts(case):
    """The schedules see the applied-update count over ``steps_per_epoch /
    k`` applied updates an epoch, kept fractional; the logged lr reads the
    mini-step count ``// k`` (the JAX trainer's ``_lr_fn``)."""
    spe, k, discrete = SCHEDULE_CASES[case]
    hyp = {**PET_SYNTH_HYP, "accumulate": k, "lrf_ratio": 0.1}
    _, fake = _jax_tx(hyp, spe, discrete)
    tx = build_tx(hyp, spe, discrete)
    jsched = fake._lr_fn
    for count in range(4 * spe):
        assert abs(tx.lr_schedule(count) - _f(jsched(count * k))) < 1e-9, count
    for mini in range(6 * spe):
        assert abs(logged_lr(tx, mini) - _f(jsched(mini))) < 1e-9, mini
    assert logged_lr(tx, 2 * k) == logged_lr(tx, 2 * k + k - 1)  # flat within a round


def test_accumulation_resumes_in_the_middle_of_a_round(tmp_path):
    """A checkpoint written between the mini-steps of a round holds the
    round's running mean and its count: the restored state takes the next
    mini-step to the same bits as the state that never stopped."""
    hyp = {**PET_SYNTH_HYP, "accumulate": 3}
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in _batches(5, seed=3)]

    def trainer():
        model = get_model(_cls_cfg(), device="cpu", generator=torch.Generator().manual_seed(0))
        tx = build_tx(hyp, 2, True)
        state = create_train_state(model, tx, torch.Generator().manual_seed(1))
        return state, make_train_step(model, tx, create_lossfn("ce"), StepConfig(), state.generator)

    state, step = trainer()
    for batch in batches[:4]:
        step(state, batch)
    assert state.optimizer.mini_step == 1 and state.optimizer.acc_grads is not None
    ckpt = CheckpointManager(tmp_path, writer=True)
    ckpt.save("last", state, epoch=0, best_fitness=0.0)
    ckpt.wait()
    for batch in batches[4:]:
        step(state, batch)

    resumed, step_r = trainer()
    resumed, _ = CheckpointManager(tmp_path).restore("last", resumed)
    assert resumed.optimizer.mini_step == 1
    for batch in batches[4:]:
        step_r(resumed, batch)
    assert (resumed.step, resumed.optimizer.count, resumed.ema_updates, resumed.optimizer.mini_step) == \
        (state.step, state.optimizer.count, state.ema_updates, state.optimizer.mini_step) == (5, 1, 1, 2)
    for got, want in ((resumed.model, state.model), (resumed.ema_model, state.ema_model)):
        for (key, a), b in zip(got.state_dict().items(), want.state_dict().values()):
            assert torch.equal(a, b), key
    for a, b in zip(resumed.optimizer.acc_grads, state.optimizer.acc_grads):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- the run loop

SIZE = 32
N_TRAIN, N_VAL = 16, 4  # per class: 7 steps of 16 an epoch
EPOCHS = 3
LOSS_RTOL = 1e-4
RESUME_TOL = 1e-6
MIX = {"ratio": 0.2, "duration": 1}


@pytest.fixture(autouse=True)
def pil_decode(monkeypatch):
    monkeypatch.setattr(jax_native, "native_available", lambda: False)
    monkeypatch.setattr(port_native, "native_available", lambda: False)


def _resized(augment):
    for item in augment:
        for params in item.values():
            if isinstance(params, dict):
                if "size" in params:
                    params["size"] = SIZE
                _resized(params.get("transforms", []))
    return augment


@pytest.fixture(scope="module")
def toy(tmp_path_factory, tiny_vit_registered):
    """pet_synth.yaml cut to the toy data (as ``test_torch_port_run.py``'s),
    with mixup in epoch 1 (ratio 0.2), OHEM on and ``hyp.accumulate: 2``."""
    from PIL import Image

    root = tmp_path_factory.mktemp("toy_strategies")
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
    cfg["hyp"]["accumulate"] = 2
    cfg["hyp"]["strategy"]["mixup"] = dict(MIX)
    cfg["hyp"]["strategy"]["ohem"] = [True, 8, 0.7, 255]
    check("classification", cfg)
    return cfg


def _metrics(project: Path) -> dict:
    out = {}
    for line in (project / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        out.setdefault(rec["tag"], {})[rec["step"]] = rec["value"]
    return out


def _jax_perms(seed: int, spe: int):
    """The JAX step's mixup permutations, in the order a run's mixup steps
    draw them: its key is fold_in(key(seed + 1), step), the window epoch 1."""
    step = itertools.count(spe)
    return lambda b, generator: torch.from_numpy(_jax_perm(jax.random.key(seed + 1), next(step), b))


def _port_run(cfg, project, monkeypatch, resume=None, stop_at=None):
    spe = N_TRAIN * CLASSES // 16
    monkeypatch.setattr(port_steps, "mixup_permutation", _jax_perms(0, spe))
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
        cp.ckpt.wait()
        return cp
    cp.run_classifier(resume=resume)
    return cp


def test_mixup_window_and_lambda(toy, tmp_path, capsys):
    """Mixup is live in [warm_ep, warm_ep + duration) with its start and end
    logged, and each step's λ is the JAX trainer's draw."""
    cp = CenterProcessor(json.loads(json.dumps(toy)), project=str(tmp_path), device="cpu",
                         compute_dtype=torch.float32, seed=4)
    live = [cp._epoch_strategy(e, cp.lossfn, aug_epoch=2)[1] for e in range(EPOCHS)]
    assert live == [False, True, False]
    out = capsys.readouterr().out
    assert "Mixup start up" in out and "Mixup end" in out
    for epoch, i in ((1, 0), (1, 6), (5, 123)):
        want = np.random.default_rng([4, epoch, i]).beta(0.2, 0.2)
        assert cp.mixup_lambda(epoch, i) == want
    assert cp.ohem_cfg == OHEMConfig(8, 0.7, 255)


def test_run_with_mixup_ohem_and_accumulation_matches_the_jax_trainer(toy, tmp_path, mesh8, monkeypatch):
    """pet_synth's toy run with the mixup window in epoch 1, OHEM and
    ``hyp.accumulate: 2`` (7 steps an epoch: rounds span epochs) against the
    JAX trainer, the mixup permutations JAX's."""
    monkeypatch.setattr(jax_trainer, "MetricsWriter", lambda logdir: JaxMetricsWriter(logdir, use_tensorboard=False))
    JaxCenterProcessor(json.loads(json.dumps(toy)), project=str(tmp_path / "jax"), train=True, mesh=mesh8,
                       compute_dtype=jnp.float32, seed=0).run_classifier()
    cp = _port_run(toy, tmp_path / "port", monkeypatch)
    got, want = _metrics(tmp_path / "port"), _metrics(tmp_path / "jax")
    for epoch in range(EPOCHS):
        for tag in ("Train_loss", "Val_v_loss"):
            a, b = got[tag][epoch], want[tag][epoch]
            assert abs(a - b) <= LOSS_RTOL * abs(b), (tag, epoch, a, b)
        assert abs(got["Val_top1"][epoch] - want["Val_top1"][epoch]) * N_VAL * CLASSES <= 1 + 1e-9, epoch
        assert abs(got["Train_lr"][epoch] - want["Train_lr"][epoch]) <= 1e-9
    steps = EPOCHS * N_TRAIN * CLASSES // 16
    state = cp.ckpt.read("last")
    assert (state["step"], state["opt_count"], state["ema_updates"], state["opt_mini_step"]) == \
        (steps, steps // 2, steps // 2, steps % 2)


def test_run_killed_in_the_middle_of_a_round_resumes_to_the_same_state(toy, tmp_path, monkeypatch):
    """Epoch 0's 7 mini-steps end in the middle of a round of 2: a run killed
    at the start of epoch 1 and resumed carries the half round in its
    checkpoint and ends where the uninterrupted run ends."""
    full = _port_run(toy, tmp_path / "full", monkeypatch)
    _port_run(toy, tmp_path / "run", monkeypatch, stop_at=1)
    saved = CheckpointManager(tmp_path / "run").read("last")
    assert saved["opt_mini_step"] == 1 and len(saved["opt_acc_grads"]) == len(list(full.model.parameters()))
    resumed = _port_run(toy, tmp_path / "run", monkeypatch, resume="last")
    got, want = _metrics(tmp_path / "run"), _metrics(tmp_path / "full")
    for epoch in (1, 2):
        for tag in ("Train_loss", "Val_v_loss", "Val_top1"):
            assert abs(got[tag][epoch] - want[tag][epoch]) <= RESUME_TOL * max(abs(want[tag][epoch]), 1.0), tag
    for got_m, want_m in ((resumed.model, full.model), (resumed.ckpt.read("last")["ema"], full.ckpt.read("last")["ema"])):
        got_sd = got_m if isinstance(got_m, dict) else got_m.state_dict()
        want_sd = want_m if isinstance(want_m, dict) else want_m.state_dict()
        for key, value in want_sd.items():
            assert torch.allclose(got_sd[key], value, rtol=0, atol=RESUME_TOL), key
