"""The port's embedding run loop (``run_embedding``) against the JAX trainer's, and its CLIs.

Setup: a tiny Swin (patch 4, embed 16, depths (2, 2), window 4, 32×32
images) with a 16-d neck and an ArcFace head over 4 identities, on toy
folder datasets of seeded JPEGs: face (``train/<id>/``, ``val/`` and a pair
file of 40 pairs, 4 a fold) and CBIR (``train/<id>/``, ``query/<id>/``,
``gallery/<id>/``: 8 queries, 16 gallery images). The configs are
``configs/faceX/face_synth.yaml`` and ``cbir_synth.yaml`` with the sizes cut
to 32, bs 16 (it divides over the conftest's 8 CPU devices), 3 epochs, f32
on both sides. Face runs its train augments on the host
(``device_augment: false``: the host pipelines are byte-identical); CBIR
lifts deterministic ops (hflip, invert, each at p 1) onto the
device-augment stage on both sides, which then runs in every epoch. Both
trainers start from the same weights: the JAX trainer's own initial state
(its head padded to 128 columns), carried into the port's model by the
bridge. The native decode is patched off on both sides.

Tolerances: per-epoch train loss within 1e-4 relative (the same f32 math in
another summation order, carried through 12 SGD steps: the three-step test's
1e-5 grows with the steps, as in ``test_torch_port_run.py``); the fitness
within one pair per fold (face: 1/4 of the mean) or one query (CBIR: 1/8 of
MRR@1). A port run killed in its second epoch's evaluation and resumed
equals the uninterrupted run to 1e-6 (in practice bit-equal). ``validate``
and ``cbir_eval`` reproduce the trainer's best metrics exactly.
"""

import json
import re
import runpy
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import visiondk_tpu.data.native as jax_native
import visiondk_tpu.engine.trainer as jax_trainer
import visiondk_tpu_torch.data.native as port_native
import visiondk_tpu_torch.engine.trainer as port_trainer
from visiondk_tpu.config.loader import yaml_load as jax_yaml_load
from visiondk_tpu.engine.trainer import CenterProcessor as JaxCenterProcessor
from visiondk_tpu.models.backbones import BACKBONES as JAX_BACKBONES
from visiondk_tpu.models.backbones.swin import _swin as jax_swin
from visiondk_tpu.models.convert import _flatten
from visiondk_tpu.utils.metrics_writer import MetricsWriter as JaxMetricsWriter
from visiondk_tpu_torch.config import check, yaml_dump
from visiondk_tpu_torch.engine.trainer import CenterProcessor
from visiondk_tpu_torch.models import BACKBONES
from visiondk_tpu_torch.models.backbones.swin import _swin
from visiondk_tpu_torch.models.convert import load_jax_params
from visiondk_tpu_torch.ops.device_augment import make_device_augment

TINY = "swin_tiny_port_embedding_run_test"
KWARGS = {"mlp_ratio": 2.0, "stochastic_depth_prob": 0.0}
SIZE, IDS, N_TRAIN, BS, EPOCHS = 32, 4, 16, 16, 3
STEPS = IDS * N_TRAIN // BS
N_PAIRS, N_QUERY = 40, 8
LOSS_RTOL, RESUME_TOL = 1e-4, 1e-6


@pytest.fixture(scope="module", autouse=True)
def tiny_swin_registered():
    JAX_BACKBONES.register(jax_swin(16, (2, 2), (2, 4), window_size=4), name=TINY)
    BACKBONES.register(_swin(16, (2, 2), (2, 4), window_size=4), name=TINY)
    yield
    del JAX_BACKBONES._store[TINY]
    del BACKBONES._store[TINY]


@pytest.fixture(autouse=True)
def pil_decode(monkeypatch):
    monkeypatch.setattr(jax_native, "native_available", lambda: False)
    monkeypatch.setattr(port_native, "native_available", lambda: False)
    # the JAX writer mirrors metrics.jsonl to TensorBoard where it imports; not needed here
    monkeypatch.setattr(jax_trainer, "MetricsWriter", lambda logdir: JaxMetricsWriter(logdir, use_tensorboard=False))


def _image(rng, ident):
    h, w = (int(x) for x in rng.integers(30, 64, size=2))
    base = np.array([(67 * ident) % 256, (91 * ident + 40) % 256, 255 - 50 * ident])
    return Image.fromarray(np.clip(rng.normal(base, 40, size=(h, w, 3)), 0, 255).astype(np.uint8))


def _write(d: Path, rng, ident, n, prefix=""):
    d.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        _image(rng, ident).save(d / f"{prefix}{i}.jpg", quality=90)


def _resized(augment):
    for item in augment:
        for params in item.values():
            if isinstance(params, dict):
                if "size" in params:
                    params["size"] = SIZE
                _resized(params.get("transforms", []))
    return augment


def _cut(cfg, root):
    """A synth recipe at the toy's size: the tiny Swin, 4 identities, bs 16, 3 epochs."""
    model = cfg["model"]
    model["image_size"] = SIZE
    model["backbone"] = {TINY: {"pretrained": False, "image_size": SIZE, "feat_dim": 16, **KWARGS}}
    model["head"]["arcface"].update(feat_dim=16, num_class=IDS)
    cfg["data"].update(root=str(root), nw=2)
    cfg["data"]["train"]["bs"] = BS
    cfg["data"]["val"]["bs"] = BS
    _resized(cfg["data"]["train"]["augment"])
    _resized(cfg["data"]["val"]["augment"])
    cfg["hyp"]["epochs"] = EPOCHS
    return cfg


@pytest.fixture(scope="module")
def toys(tmp_path_factory, tiny_swin_registered):
    """{"face": (cfg, yaml path), "cbir": (cfg, yaml path)} over seeded toy data."""
    base = tmp_path_factory.mktemp("toy_embedding")
    rng = np.random.default_rng(0)
    face, cbir = base / "face", base / "cbir"
    for ident in range(IDS):
        _write(face / "train" / f"id{ident}", rng, ident, N_TRAIN)
        _write(face / "val", rng, ident, 4, prefix=f"id{ident}_")
        _write(cbir / "train" / f"id{ident}", rng, ident, N_TRAIN)
        _write(cbir / "gallery" / f"id{ident}", rng, ident, 4)
        _write(cbir / "query" / f"id{ident}", rng, ident, N_QUERY // IDS)
    pairs = []
    for j in range(N_PAIRS):
        a, i = int(rng.integers(IDS)), int(rng.integers(4))
        b = a if j % 2 == 0 else int((a + 1 + rng.integers(IDS - 1)) % IDS)
        pairs.append(f"id{a}_{i}.jpg id{b}_{(i + 1 + int(rng.integers(3))) % 4}.jpg {int(a == b)}\n")
    (face / "pairs.txt").write_text("".join(pairs))

    face_cfg = _cut(jax_yaml_load("configs/faceX/face_synth.yaml"), face)
    face_cfg["data"]["train"]["device_augment"] = False
    face_cfg["data"]["val"]["pair_txt"] = str(face / "pairs.txt")
    cbir_cfg = _cut(jax_yaml_load("configs/faceX/cbir_synth.yaml"), cbir)
    train = cbir_cfg["data"]["train"]
    train["augment"] = [{"random_horizonflip": {"p": 1.0}}, {"random_invert": {"p": 1.0}}, *train["augment"][2:]]
    train["device_augment"] = "auto"
    out = {}
    for task, cfg in (("face", face_cfg), ("cbir", cbir_cfg)):
        check(task, cfg)
        path = base / f"{task}.yaml"
        yaml_dump(cfg, path)
        out[task] = (cfg, path)
    return out


def _metrics(project: Path) -> dict:
    out = {}
    for line in (project / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        out.setdefault(rec["tag"], {})[rec["step"]] = rec["value"]
    return out


def _copy(cfg):
    return json.loads(json.dumps(cfg))


@pytest.fixture(scope="module")
def runs(toys, tmp_path_factory, mesh8):
    """For each task: the JAX trainer's run (its initial state captured) and
    the port's run from that state, with the device-augment stage's calls
    counted at each evaluation (one an epoch)."""
    out, jax_init_state = {}, JaxCenterProcessor._init_state
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "native_available", lambda: False)
        mp.setattr(port_native, "native_available", lambda: False)
        mp.setattr(jax_trainer, "MetricsWriter", lambda logdir: JaxMetricsWriter(logdir, use_tensorboard=False))
        for task, (cfg, _) in toys.items():
            base = tmp_path_factory.mktemp(f"run_{task}")
            init = {}

            def capture(self, tx, example):
                state = jax_init_state(self, tx, example)
                init["tree"] = {t: {p: np.asarray(v) for p, v in _flatten(dict(tree)).items()}
                                for t, tree in (("params", state.params), ("batch_stats", state.batch_stats))}
                return state

            mp.setattr(JaxCenterProcessor, "_init_state", capture)
            JaxCenterProcessor(_copy(cfg), project=str(base / "jax"), train=True, mesh=mesh8,
                               compute_dtype=jnp.float32, seed=0).run_embedding(print_freq=STEPS)
            cp, calls = _port_run(mp, cfg, base / "port", init["tree"])
            out[task] = {"jax": base / "jax", "port": base / "port", "cp": cp, "init": init["tree"], "calls": calls}
    return out


def _port_run(mp, cfg, project, tree, resume=None, crash_at=None):
    """A port run from the JAX initial ``tree``; returns the processor and the
    device-augment stage's calls in each epoch it evaluated. ``crash_at``:
    die in that epoch's evaluation, before its checkpoints."""
    get_model = port_trainer.get_model
    mp.setattr(port_trainer, "get_model", lambda *a, **k: load_jax_params(get_model(*a, **k), tree))
    cp = CenterProcessor(_copy(cfg), project=str(project), device="cpu", compute_dtype=torch.float32, seed=0)
    marks, evaluate = [make_device_augment.calls], cp._eval_embedding

    def counted(embed_step):
        marks.append(make_device_augment.calls)
        if crash_at is not None and len(marks) - 1 == crash_at + 1:
            raise KeyboardInterrupt(f"killed in epoch {crash_at}'s evaluation")
        return evaluate(embed_step)

    cp._eval_embedding = counted
    if crash_at is not None:
        with pytest.raises(KeyboardInterrupt):
            cp.run_embedding(print_freq=STEPS)
        cp.ckpt.wait()
    else:
        cp.run_embedding(resume=resume, print_freq=STEPS)
    mp.setattr(port_trainer, "get_model", get_model)
    return cp, np.diff(marks).tolist()


def _fitness_close(task, got, want):
    if task == "face":
        return abs(got["Val_mean"] - want["Val_mean"]) <= 1 / (N_PAIRS // 10) + 1e-9
    return abs(got["Val_MRR@1"] - want["Val_MRR@1"]) <= 1 / N_QUERY + 1e-9


@pytest.mark.parametrize("task", ["face", "cbir"])
def test_run_embedding_matches_the_jax_trainer(runs, task):
    run = runs[task]
    got, want = _metrics(run["port"]), _metrics(run["jax"])
    for epoch in range(EPOCHS):
        end = (epoch + 1) * STEPS  # print_freq = an epoch: the running loss is the epoch's mean
        a, b = got["Train_epoch_loss"][epoch], want["Train_loss"][end]
        assert got["Train_loss"][end] == a
        assert abs(a - b) <= LOSS_RTOL * abs(b), (task, epoch, a, b)
        assert abs(got["Train_lr"][end] - want["Train_lr"][end]) <= 1e-9
        assert _fitness_close(task, {k: v[epoch] for k, v in got.items() if k.startswith("Val_")},
                              {k: v[epoch] for k, v in want.items() if k.startswith("Val_")}), (task, epoch)
    assert sorted(k for k in got if k.startswith("Val_")) == sorted(k for k in want if k.startswith("Val_"))
    assert got["Train_epoch_loss"][EPOCHS - 1] < got["Train_epoch_loss"][0]  # it learns
    # the stage runs in every epoch (CBIR lifts hflip + invert), never for face (device_augment: false)
    assert run["calls"] == [STEPS if task == "cbir" else 0] * EPOCHS
    project = run["port"]
    for e in range(1, EPOCHS + 1):
        meta = json.loads((project / f"Epoch_{e}" / "meta.json").read_text())
        assert meta["epoch"] == e - 1 and set(meta["fitness"]) == {
            k[len("Val_"):] for k in got if k.startswith("Val_")}
    best = json.loads((project / "best" / "meta.json").read_text())
    fit = "Val_mean" if task == "face" else "Val_MRR@1"
    assert best["best_fitness"] == max(got[fit].values()) == got[fit][best["epoch"]]
    assert json.loads((project / "last" / "meta.json").read_text())["epoch"] == EPOCHS - 1


def test_resumed_run_equals_the_uninterrupted_run(runs, toys, tmp_path):
    cfg, run = toys["cbir"][0], runs["cbir"]
    with pytest.MonkeyPatch.context() as mp:
        _port_run(mp, cfg, tmp_path / "run", run["init"], crash_at=1)
        assert json.loads((tmp_path / "run" / "last" / "meta.json").read_text())["epoch"] == 0
        resumed, calls = _port_run(mp, cfg, tmp_path / "run", run["init"], resume="last")
    assert calls == [STEPS] * (EPOCHS - 1)  # the stage in the redone epochs too
    got, want = _metrics(tmp_path / "run"), _metrics(run["port"])
    for tag in ("Train_epoch_loss", "Val_MRR@1", "Val_nDCG@5"):
        for epoch in range(1, EPOCHS):
            assert abs(got[tag][epoch] - want[tag][epoch]) <= RESUME_TOL * max(abs(want[tag][epoch]), 1.0), tag
    full = run["cp"]
    for got_sd, want_sd in ((resumed.model.state_dict(), full.model.state_dict()),
                            (resumed.ckpt.read("last")["ema"], full.ckpt.read("last")["ema"])):
        for key, value in want_sd.items():
            assert torch.allclose(got_sd[key].float(), value.float(), rtol=0, atol=RESUME_TOL), key


def _cli(module, argv):
    saved = sys.argv
    sys.argv = [module, *argv]
    try:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
    finally:
        sys.argv = saved


@pytest.mark.parametrize("task", ["face", "cbir"])
def test_validate_reproduces_the_trainers_best(runs, task, capsys):
    project = runs[task]["port"]
    best = json.loads((project / "best" / "meta.json").read_text())
    _cli("visiondk_tpu_torch.validate", ["--cfgs", str(project / "config.yaml"), "--weight", str(project / "best"),
                                         "--ema", "--device", "cpu"])
    out = capsys.readouterr().out
    printed = eval(re.search(r"^(\{.*\})$", out, re.M).group(1))  # the metrics dict, as printed
    fitness = json.loads((project / f"Epoch_{best['epoch'] + 1}" / "meta.json").read_text())["fitness"]
    assert printed == fitness
    assert (printed["mean"] if task == "face" else printed["MRR@1"]) == best["best_fitness"]


def test_cbir_eval_cli_reproduces_the_trainers_best(runs, capsys, tmp_path):
    project = runs["cbir"]["port"]
    best = json.loads((project / "best" / "meta.json").read_text())
    fitness = json.loads((project / f"Epoch_{best['epoch'] + 1}" / "meta.json").read_text())["fitness"]
    cache = str(tmp_path / "gallery.mm")
    for _ in range(2):  # the second call reads the gallery from the embedding cache
        _cli("visiondk_tpu_torch.cbir_eval", ["--cfgs", str(project / "config.yaml"), "--weight",
                                              str(project / "best"), "--ema", "--device", "cpu",
                                              "--embedding_cache", cache])
        out = capsys.readouterr().out
        printed = {k: float(v) for k, v in re.findall(r"^(\S+): (\S+)$", out, re.M)}
        assert printed == fitness
    assert Path(cache + ".meta.json").is_file()


# approximate search at two recall targets (the name is from when it raised, unported). The toy gallery
# fits one reduction tile (approx_reduction_size = G), so the approximate search is the exact one
@pytest.mark.parametrize("flag", [["--recall_target", "0.95"], ["--recall_target", "1.0"]])
def test_cbir_eval_flags_of_unported_features_raise(runs, flag, capsys):
    project = runs["cbir"]["port"]
    best = json.loads((project / "best" / "meta.json").read_text())
    fitness = json.loads((project / f"Epoch_{best['epoch'] + 1}" / "meta.json").read_text())["fitness"]
    _cli("visiondk_tpu_torch.cbir_eval", ["--cfgs", str(project / "config.yaml"), "--weight",
                                          str(project / "best"), "--ema", "--device", "cpu", *flag])
    printed = {k: float(v) for k, v in re.findall(r"^(\S+): (\S+)$", capsys.readouterr().out, re.M)}
    assert printed == fitness


def test_cbir_eval_quant_int8_embeds_through_the_int8_layers(runs, capsys, monkeypatch):
    """``cbir_eval --quant int8`` on the run's best: every dense layer of the
    served EMA model through the int8 path, the same metrics printed."""
    from visiondk_tpu_torch.ops import quant

    calls = []
    real = quant._int8_forward
    monkeypatch.setattr(quant, "_int8_forward", lambda m, path, *a: calls.append(path) or real(m, path, *a))
    project = runs["cbir"]["port"]
    _cli("visiondk_tpu_torch.cbir_eval", ["--cfgs", str(project / "config.yaml"), "--weight", str(project / "best"),
                                          "--ema", "--device", "cpu", "--quant", "int8"])
    printed = {k: float(v) for k, v in re.findall(r"^(\S+): (\S+)$", capsys.readouterr().out, re.M)}
    best = json.loads((project / "best" / "meta.json").read_text())
    fitness = json.loads((project / f"Epoch_{best['epoch'] + 1}" / "meta.json").read_text())["fitness"]
    assert set(printed) == set(fitness) and all(0.0 <= v <= 1.0 for v in printed.values())
    from visiondk_tpu_torch.config import yaml_load
    from visiondk_tpu_torch.models import get_model

    dense = {p for p, _ in quant.dense_layers(get_model(yaml_load(project / "config.yaml")["model"], device="cpu"))}
    assert dense and set(calls) == dense


def test_cbir_eval_without_device_raises_without_a_gpu(runs):
    assert not torch.cuda.is_available()
    project = runs["cbir"]["port"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _cli("visiondk_tpu_torch.cbir_eval", ["--cfgs", str(project / "config.yaml"), "--weight",
                                              str(project / "best")])


def test_main_trains_the_embedding_task_through_the_cli(toys, tmp_path, capsys):
    """``python -m visiondk_tpu_torch.main`` dispatches face to run_embedding,
    with --save_freq (Epoch_n every second epoch, and the last) and --print_freq."""
    _, yaml_path = toys["face"]
    project = tmp_path / "exp"
    _cli("visiondk_tpu_torch.main", ["--cfgs", str(yaml_path), "--project", str(project), "--device", "cpu",
                                     "--save_freq", "2", "--print_freq", "2"])
    out = capsys.readouterr().out
    assert "python -m visiondk_tpu_torch.validate" in out and f"epoch:1/{EPOCHS} batch:2 loss:" in out
    assert sorted(p.name for p in project.glob("Epoch_*")) == ["Epoch_2", "Epoch_3"]
    assert sorted(_metrics(project)["Train_loss"]) == list(range(2, EPOCHS * STEPS + 1, 2))


def test_load_from_grafts_a_head_only_with_exactly_num_class_columns(runs, toys, tmp_path):
    """load_from merges by key and shape: a checkpoint of the same task loads
    the head; one whose head has another class count keeps this run's head
    (the JAX ``head_classes`` rule) and loads the rest."""
    source = runs["face"]["port"] / "best"
    ema = runs["face"]["cp"].ckpt.read("best")["ema"]
    cfg = _copy(toys["face"][0])
    cfg["model"]["load_from"] = str(source)
    cp = CenterProcessor(_copy(cfg), project=str(tmp_path / "same"), device="cpu", compute_dtype=torch.float32)
    state = port_trainer.create_train_state(cp.model, port_trainer.build_tx(cfg["hyp"], 1, False))
    cp._apply_load_from(state, str(source))
    assert torch.equal(cp.model.head.weight.detach(), ema["head.weight"])
    cfg["model"]["head"]["arcface"]["num_class"] = IDS + 1
    other = CenterProcessor(_copy(cfg), project=str(tmp_path / "other"), device="cpu", compute_dtype=torch.float32)
    before = other.model.head.weight.detach().clone()
    state = port_trainer.create_train_state(other.model, port_trainer.build_tx(cfg["hyp"], 1, False))
    other._apply_load_from(state, str(source))
    assert torch.equal(other.model.head.weight.detach(), before)
    assert torch.equal(other.model.neck.proj.weight.detach(), ema["neck.proj.weight"])
