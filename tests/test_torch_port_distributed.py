"""The port's distributed training (``visiondk_tpu_torch/parallel/`` and the
distributed seams of the engine) on two gloo ranks on the CPU, against the
single-process JAX step on a 2-device mesh of the conftest's 8 CPU devices.

Setup: two rank processes (``tests/torch_dist_worker.py``, torch and the port
only) join one gloo group once for the whole file and serve the cases; each
case has its own timeout, so a hung collective fails the case instead of the
suite. The parent draws weights and batches from numpy seeds, carries the
weights into the port by the bridge, feeds the JAX step the global batch on
the mesh and each rank its half (rank r: rows [r·B/2, (r+1)·B/2)), and holds
the two. The tiny models are the port tests' own: a ViT (patch 8, width 64,
depth 2, 32×32) and a basic-block ResNet ([1, 1, 1, 1]), registered in both
packages. Multi-process JAX is not used (it hangs at HEAD; see ROADMAP).

Cases: the trainer's train-loader shards (disjoint, complete, byte-identical
to the JAX loader's ``process_index/process_count`` batches); two DDP ViT
steps (mesh data 2); a SyncBN ResNet step with its running statistics; mixup
+ OHEM on the global batch; SAM's per-rank ε (``local_perturb``: the JAX
step's ``shard_map`` branch under the published mesh) on the ViT and the
BatchNorm ResNet; ArcFace and MV-Softmax heads class-sharded over
``--model_parallel 2`` at 67 classes (shards of 34 and 33 columns; the JAX
head on a mesh with model 2, padded to 128); and a ``torch.distributed.run``
CLI run of 2 ranks with ``--model_parallel 2`` whose ``last`` checkpoint
resumes in one process with the layout of a one-process checkpoint.

Tolerances, the port-vs-JAX bars of PERF.md §2: ViT steps, the loss within
1e-5 relative and every parameter's and EMA tensor's move from θ₀ within
1e-3 of its largest entry; the ResNet steps against the JAX step in float64
(``test_torch_port_resnet.py``: f32 BatchNorm gradients at random init are
ill-conditioned), each update within 1e-3 of its norm plus f32 spacings, the
running statistics at rtol 1e-3, atol 3e-4; SAM's per-rank ε 1e-6 absolute
(``test_torch_port_sam_remat.py``'s ``sam_perturb`` bar); the sharded heads'
logits within 1e-4 absolute at scale 32 (chip_smoke's margin-head bar), the
loss and the clip's global norm within 1e-5 relative, every gradient (the
gathered head's against the JAX head's first 67 columns) within 1e-3 of its
largest entry (or 1e-6 of the largest gradient entry of the model, for the
neck LayerNorm's bias, whose gradient ahead of the BatchNorm is zero in exact
arithmetic and rounding noise on both sides). The two ranks must hold bit-identical replicated tensors.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import visiondk_tpu.data.native as jax_native
import visiondk_tpu_torch.data.native as port_native
from visiondk_tpu.config.loader import yaml_load as jax_yaml_load
from visiondk_tpu.data.dataprocessor import SmartDataProcessor as JaxSmartDataProcessor
from visiondk_tpu.engine.optim import SAMConfig as JaxSAMConfig
from visiondk_tpu.engine.optim import sam_perturb as jax_sam_perturb
from visiondk_tpu.engine.state import create_train_state as jax_create_train_state
from visiondk_tpu.engine.state import place_state
from visiondk_tpu.engine.steps import OHEMConfig as JaxOHEMConfig
from visiondk_tpu.engine.steps import StepConfig as JaxStepConfig
from visiondk_tpu.engine.steps import device_preprocess as jax_device_preprocess
from visiondk_tpu.engine.steps import make_train_step as jax_make_train_step
from visiondk_tpu.engine.trainer import CenterProcessor as JaxCenterProcessor
from visiondk_tpu.losses import losses as JL
from visiondk_tpu.models import get_model as jax_get_model
from visiondk_tpu.models.backbones import BACKBONES as JAX_BACKBONES
from visiondk_tpu.models.backbones.resnet import _resnet as jax_resnet
from visiondk_tpu.models.backbones.vit import _vit as jax_vit
from visiondk_tpu.models.convert import _flatten, _unflatten
from visiondk_tpu.parallel import build_mesh as jax_build_mesh
from visiondk_tpu.parallel.mesh import set_current_mesh
from visiondk_tpu_torch.config import yaml_dump
from visiondk_tpu_torch.engine.checkpoint import CheckpointManager
from visiondk_tpu_torch.models import BACKBONES, get_model
from visiondk_tpu_torch.models.convert import load_jax_params, state_dict_from_jax
from visiondk_tpu_torch.parallel import initialize_distributed, shard_ranges
from tests.torch_dist_worker import TINY_RESNET, TINY_VIT, Ranks, free_port, register_tiny_backbones

REPO = Path(__file__).resolve().parent.parent
IMG, CLASSES, WORLD = 32, 7, 2
# the hyp: section of configs/classification/pet_synth.yaml (optimizer fields)
PET_SYNTH_HYP = {
    "epochs": 6, "lr0": 0.01, "lrf_ratio": None, "momentum": 0.937, "weight_decay": 0.0005,
    "warmup_momentum": 0.8, "warm_ep": 1, "optimizer": ["sgd", False], "scheduler": "cosine_with_warm",
}
# the optimizer fields of configs/classification/multilabel_csv.yaml
ML_HYP = {**PET_SYNTH_HYP, "epochs": 20}
CE = ("ce", {"label_smooth": 0.05})


# ---------------------------------------------------------------- the ranks


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = Ranks(tmp_path_factory.mktemp("ranks"))
    yield pool
    pool.close()


@pytest.fixture(scope="module", autouse=True)
def tiny_registered():
    JAX_BACKBONES.register(jax_vit(8, 64, 2, 4), name=TINY_VIT)
    JAX_BACKBONES.register(jax_resnet([1, 1, 1, 1], "basic"), name=TINY_RESNET)
    register_tiny_backbones()
    yield
    for name in (TINY_VIT, TINY_RESNET):
        del JAX_BACKBONES._store[name]
        del BACKBONES._store[name]


@pytest.fixture(scope="module")
def mesh2():
    return jax_build_mesh(devices=jax.devices()[:WORLD])  # data 2, model 1


# ---------------------------------------------------------------- helpers


def _cls_cfg(name):
    return {"task": "classification", "name": name, "num_classes": CLASSES, "image_size": IMG, "kwargs": {}}


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
            elif p.endswith("head/weight"):
                flat[p] = rng.normal(size=v.shape).astype(np.float32)
            else:
                flat[p] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
        tree[t] = {p: v for p, v in flat.items()}
    return tree


def _setup(cfg, seed, **init_kwargs):
    """The JAX model, a numpy-seeded tree of its variables, and the port's
    (unsharded) model and numpy state dict holding them."""
    jmodel = jax_get_model(cfg, **init_kwargs)
    args = (jnp.zeros((1, IMG, IMG, 3)),) + ((jnp.zeros((1,), jnp.int32),) if cfg["task"] != "classification" else ())
    tree = _random_tree(jmodel.init(jax.random.key(0), *args, train=False), seed)
    port = load_jax_params(get_model(cfg, device="cpu"), tree)
    return jmodel, tree, port, {k: v.numpy() for k, v in port.state_dict().items()}


def _jax_state(tree, tx, mesh, dtype=jnp.float32):
    variables = {t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), _unflatten(flat))
                 for t, flat in tree.items() if flat}
    return place_state(mesh, jax_create_train_state(variables, tx))


def _jax_tx(hyp, spe=2, discrete=True):
    fake = SimpleNamespace(hyp_cfg=hyp, opt_name="sgd", layer_wise=False, model_cfg={})
    return JaxCenterProcessor._build_tx(fake, spe, discrete)


def _batches(n, b=8, seed=0, multilabel=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        label = ((rng.random((b, CLASSES)) < 0.4).astype(np.float32) if multilabel
                 else rng.integers(0, CLASSES, size=b).astype(np.int32))
        out.append({"image": rng.integers(0, 256, size=(b, IMG, IMG, 3), dtype=np.uint8), "label": label})
    return out


def _on_mesh(batch, mesh):
    return jax.device_put({k: jnp.asarray(v) for k, v in batch.items()}, mesh.batch)


def _flat(tree):
    return {p: np.asarray(v) for p, v in _flatten(dict(tree)).items()}


def _want(port, params, stats=None):
    tree = {"params": _flat(params)}
    if stats is not None:
        tree["batch_stats"] = _flat(stats)
    return {k: v.numpy() for k, v in state_dict_from_jax(port, tree).items()}


def _check_moved(got, want, theta0, what):
    """ViT bar: every tensor's move from θ₀ within 1e-3 of its largest entry."""
    for key, value in want.items():
        got_d, want_d = got[key] - theta0[key], value - theta0[key]
        np.testing.assert_allclose(got_d, want_d, rtol=1e-3, atol=1e-3 * np.abs(want_d).max(),
                                   err_msg=f"{what} {key}")


def _check_moved_by_norm(got, want, theta0, what):
    """ResNet bar (against float64): each update within 1e-3 of its norm plus
    f32 spacings; the running statistics at rtol 1e-3, atol 3e-4."""
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[key], value, rtol=1e-3, atol=3e-4, err_msg=f"{what} {key}")
            continue
        got_d, want_d = got[key].astype(np.float64) - theta0[key], value.astype(np.float64) - theta0[key]
        spacing = np.sqrt(want_d.size) * np.spacing(np.abs(theta0[key]).max())
        err = np.linalg.norm(got_d - want_d)
        assert err <= 1e-3 * np.linalg.norm(want_d) + 3 * spacing, (what, key, err, np.linalg.norm(want_d))


def _same_on_both_ranks(outs, *keys):
    for key in keys:
        for name, value in outs[0][key].items():
            assert np.array_equal(value, outs[1][key][name]), (key, name)


# ---------------------------------------------------------------- bring-up and layout


def test_initialize_distributed_without_a_cluster_is_single_process(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "VDK_COORDINATOR_ADDRESS",
                "VDK_NUM_PROCESSES", "VDK_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    said = []
    logger = SimpleNamespace(both=said.append)
    assert initialize_distributed(logger=logger) is False
    assert said == ["no cluster environment detected; running single-process"]
    with pytest.raises(ValueError, match="coordinator address"):
        initialize_distributed(num_processes=2, process_id=0)
    monkeypatch.setenv("VDK_NUM_PROCESSES", "2")
    monkeypatch.setenv("VDK_PROCESS_ID", "2")
    monkeypatch.setenv("VDK_COORDINATOR_ADDRESS", "127.0.0.1:1")
    with pytest.raises(ValueError, match="outside a world of 2"):
        initialize_distributed()


@pytest.mark.parametrize("num_class,m", [(67, 2), (58671, 2), (64, 4), (5, 3)])
def test_shard_ranges_are_tensor_split(num_class, m):
    cols = torch.tensor_split(torch.arange(num_class), m)
    assert shard_ranges(num_class, m) == [(int(c[0]), int(c[-1]) + 1) for c in cols]


# ---------------------------------------------------------------- the loader


@pytest.fixture(autouse=True)
def pil_decode(monkeypatch):
    monkeypatch.setattr(jax_native, "native_available", lambda: False)
    monkeypatch.setattr(port_native, "native_available", lambda: False)


@pytest.fixture(scope="module")
def face_toy(tmp_path_factory):
    """benchmarks/make_synth_face.py: 8 ids × 8 train, 2 val, 20 pairs; and
    a face_synth.yaml on it (resnet18 at 32 px, feat 16, bs 16, 2 epochs)."""
    root = tmp_path_factory.mktemp("face")
    subprocess.run([sys.executable, str(REPO / "benchmarks" / "make_synth_face.py"), "--root", str(root / "face"),
                    "--cbir-root", str(root / "cbir"), "--ids", "8", "--n-train", "8", "--n-val", "2",
                    "--pairs", "20"], check=True, capture_output=True, timeout=120)
    cfg = jax_yaml_load(str(REPO / "configs" / "faceX" / "face_synth.yaml"))
    cfg["model"]["image_size"] = IMG
    cfg["model"]["backbone"] = {"resnet18": {"pretrained": False, "image_size": IMG, "feat_dim": 16}}
    cfg["model"]["head"]["arcface"].update(feat_dim=16, num_class=8)
    cfg["data"].update(root=str(root / "face"), nw=2)
    cfg["data"]["val"]["pair_txt"] = str(root / "face" / "pairs.txt")
    cfg["data"]["train"]["bs"] = 16
    cfg["data"]["val"]["bs"] = 8
    for split in ("train", "val"):
        for item in cfg["data"][split]["augment"]:
            for params in item.values():
                if isinstance(params, dict):
                    for sub in [params] + [next(iter(t.values())) for t in params.get("transforms", [])]:
                        if isinstance(sub, dict) and "size" in sub:
                            sub["size"] = IMG
    cfg["hyp"]["epochs"] = 2
    return root, cfg


def test_loader_shards_are_disjoint_complete_and_the_jax_loaders(ranks, face_toy, tmp_path):
    """Rank r's train loader (the trainer's, bs 16 / 2) is the JAX loader's
    ``process_index=r, process_count=2`` shard, byte for byte, in epochs 0
    and 1; the shards are disjoint and cover the epoch."""
    _, cfg = face_toy
    outs = ranks.run("loader", {"cfgs": cfg, "project": str(tmp_path / "port")})
    ref = JaxSmartDataProcessor(json.loads(json.dumps(cfg["data"])), project=str(tmp_path / "jax"), task="face")
    n = len(ref.train_dataset)
    assert n % WORLD == 0
    for epoch in (0, 1):
        idx = [out["indices"][epoch] for out in outs]
        assert not set(idx[0]) & set(idx[1]) and sorted(np.concatenate(idx)) == list(range(n))
    for rank, out in enumerate(outs):
        assert out["bs"] == 8
        loader = ref.dataloader("train", 8, seed=0, process_index=rank, process_count=WORLD)
        for epoch in (0, 1):
            loader.set_epoch(epoch)
            want = list(loader)
            got = out["batches"][epoch]
            assert len(got) == len(want) == n // 16
            for a, b in zip(got, want):
                assert a.keys() == b.keys()
                for k in a:
                    assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (rank, epoch, k)


# ---------------------------------------------------------------- steps on a data mesh


def test_ddp_vit_steps_match_jax_on_a_data_mesh(ranks, mesh2):
    cfg = _cls_cfg(TINY_VIT)
    jmodel, tree, port, sd = _setup(cfg, seed=6)
    batches = _batches(2, seed=1)
    jtx = _jax_tx(PET_SYNTH_HYP)
    jstate = _jax_state(tree, jtx, mesh2)
    jstep = jax_make_train_step(jmodel, jtx, JL.create_lossfn(CE[0], **CE[1]), JaxStepConfig(), jax.random.key(0),
                                donate=False)
    jlosses = []
    for batch in batches:
        jstate, jm = jstep(jstate, _on_mesh(batch, mesh2), jnp.float32(0.0))
        jlosses.append(float(jm["loss"]))
    outs = ranks.run("step", {"model": cfg, "state": sd, "hyp": PET_SYNTH_HYP, "loss": CE, "batches": batches})
    _same_on_both_ranks(outs, "model", "ema")
    for out in outs:
        np.testing.assert_allclose(out["loss"], jlosses, rtol=1e-5)
        assert out["counts"] == (2, 2, 2)
    _check_moved(outs[0]["model"], _want(port, jstate.params), sd, "update")
    _check_moved(outs[0]["ema"], _want(port, jstate.ema_params), sd, "ema")


def test_syncbn_resnet_step_matches_jax_on_a_data_mesh(ranks, mesh2):
    """BCE on multi-hot targets (multilabel_csv's loss) through a BatchNorm
    ResNet: each rank normalises with the global batch's moments, and the
    running statistics are the global batch's."""
    cfg = _cls_cfg(TINY_RESNET)
    _, tree, port, sd = _setup(cfg, seed=11)
    batches = _batches(1, seed=2, multilabel=True)
    with jax.enable_x64(True):
        jtx = _jax_tx(ML_HYP)
        jstate = _jax_state(tree, jtx, mesh2, jnp.float64)
        jstep = jax_make_train_step(jax_get_model(cfg, dtype=jnp.float64), jtx, JL.create_lossfn("bce"),
                                    JaxStepConfig(), jax.random.key(0), donate=False)
        jstate, jm = jstep(jstate, _on_mesh(batches[0], mesh2), jnp.float64(0.0))
        want = _want(port, jstate.params, jstate.batch_stats)
        jloss = float(jm["loss"])
    outs = ranks.run("step", {"model": cfg, "state": sd, "hyp": ML_HYP, "loss": ("bce", {}), "batches": batches})
    _same_on_both_ranks(outs, "model", "ema")
    np.testing.assert_allclose(outs[0]["loss"][0], jloss, rtol=1e-5)
    assert any(k.endswith("running_var") for k in want)
    _check_moved_by_norm(outs[0]["model"], want, sd, "update")


def _jax_perm(base_rng, step, b):
    perm_rng, _ = jax.random.split(jax.random.fold_in(base_rng, step))
    return np.array(jax.random.permutation(perm_rng, b))


def test_ohem_and_mixup_on_the_global_batch_match_jax(ranks, mesh2):
    """Mixup permutes the global batch (rows cross ranks); OHEM's k-th
    smallest probability and its loss's denominator are the global batch's.
    The ranks take JAX's permutation and λ."""
    cfg = _cls_cfg(TINY_VIT)
    jmodel, tree, port, sd = _setup(cfg, seed=7)
    batches = _batches(2, seed=3)
    ohem = (2, 0.1, 255)
    base_rng = jax.random.key(0)
    lams = [float(np.random.default_rng([0, 1, i]).beta(0.2, 0.2)) for i in range(2)]
    jtx = _jax_tx(PET_SYNTH_HYP)
    jstate = _jax_state(tree, jtx, mesh2)
    jstep = jax_make_train_step(jmodel, jtx, JL.create_lossfn(CE[0], **CE[1]),
                                JaxStepConfig(mixup=True, ohem=JaxOHEMConfig(*ohem)), base_rng, donate=False)
    jlosses = []
    for batch, lam in zip(batches, lams):
        jstate, jm = jstep(jstate, _on_mesh(batch, mesh2), jnp.float32(lam))
        jlosses.append(float(jm["loss"]))
    perms = [_jax_perm(base_rng, i, 8) for i in range(2)]
    assert any((p[:4] >= 4).any() for p in perms)  # rows cross ranks
    outs = ranks.run("step", {"model": cfg, "state": sd, "hyp": PET_SYNTH_HYP, "loss": CE, "batches": batches,
                              "mixup": True, "ohem": ohem, "perms": perms, "lams": lams})
    _same_on_both_ranks(outs, "model", "ema")
    np.testing.assert_allclose(outs[0]["loss"], jlosses, rtol=1e-5)
    _check_moved(outs[0]["model"], _want(port, jstate.params), sd, "update")
    _check_moved(outs[0]["ema"], _want(port, jstate.ema_params), sd, "ema")


@pytest.mark.parametrize("name", [TINY_VIT, TINY_RESNET])
def test_sam_per_rank_epsilon_matches_the_jax_shard_map(ranks, mesh2, name):
    """``local_perturb`` with 2 ranks: e from each rank's own gradient
    (against JAX ``sam_perturb`` of the rank's rows' gradient), BatchNorm on
    each rank's own moments, the second gradients averaged: the JAX step
    under the published mesh (its ``_sam_local_grads``)."""
    cfg = _cls_cfg(name)
    resnet = name == TINY_RESNET
    dtype = jnp.float64 if resnet else jnp.float32
    _, tree, port, sd = _setup(cfg, seed=9)
    batches = _batches(1, seed=4)
    sam = {"rho": 0.05, "adaptive": True, "local_perturb": True}
    lossfn = JL.create_lossfn(CE[0], **CE[1])
    with jax.enable_x64(resnet):
        jmodel = jax_get_model(cfg, dtype=dtype)
        jtx = _jax_tx(PET_SYNTH_HYP)
        jstate = _jax_state(tree, jtx, mesh2, dtype)
        set_current_mesh(mesh2.mesh)
        jstep = jax_make_train_step(jmodel, jtx, lossfn, JaxStepConfig(sam=JaxSAMConfig(**sam)), jax.random.key(0),
                                    donate=False)
        params0 = jstate.params
        jstate, jm = jstep(jstate, _on_mesh(batches[0], mesh2), jnp.asarray(0.0, dtype))
        want = _want(port, jstate.params, jstate.batch_stats if resnet else None)
        jloss = float(jm["loss"])
        eps = []
        for rank in range(0 if resnet else WORLD):  # e of each rank from the gradient of its rows alone
            rows = {k: jnp.asarray(v[rank * 4:(rank + 1) * 4]) for k, v in batches[0].items()}
            images = jax_device_preprocess(rows["image"], (0.485, 0.456, 0.406), (0.229, 0.224, 0.225))

            def loss_of(p):
                variables = {"params": p, **({"batch_stats": jstate.batch_stats} if resnet else {})}
                logits = jmodel.apply(variables, images.astype(dtype), train=True, mutable=["batch_stats"])[0]
                return lossfn(logits, rows["label"], None)

            g1 = jax.grad(loss_of)(params0)
            moved = jax_sam_perturb(params0, g1, JaxSAMConfig(**sam))
            eps.append(_want(port, jax.tree_util.tree_map(lambda a, b: a - b, moved, params0)))
    outs = ranks.run("step", {"model": cfg, "state": sd, "hyp": PET_SYNTH_HYP, "loss": CE, "batches": batches,
                              "sam": sam, "record_eps": True})
    _same_on_both_ranks(outs, "model", "ema")
    np.testing.assert_allclose(outs[0]["loss"][0], jloss, rtol=1e-5)
    if not resnet:
        for rank, out in enumerate(outs):
            for key, value in eps[rank].items():
                np.testing.assert_allclose(out["eps"][key], value, rtol=0, atol=1e-6, err_msg=f"rank {rank} e {key}")
        assert not np.allclose(outs[0]["eps"][next(iter(eps[0]))], outs[1]["eps"][next(iter(eps[0]))])
        _check_moved(outs[0]["model"], want, sd, "update")
    else:
        _check_moved_by_norm(outs[0]["model"], want, sd, "update")


# ---------------------------------------------------------------- partial-FC


HEADS = {
    "arcface": {"margin_arc": 0.35, "margin_am": 0.0, "scale": 32.0},
    "mv-softmax": {"is_am": False, "margin": 0.35, "mv_weight": 1.12, "scale": 32.0},
}
NUM_CLASS = 67


@pytest.mark.parametrize("head", list(HEADS))
def test_class_sharded_heads_match_jax_on_a_model_mesh(ranks, head):
    """``--model_parallel 2`` at 67 classes: rank j holds columns
    ``tensor_split(67, 2)[j]`` (34 and 33). The gathered logits, the CE with
    label smoothing, the clip's global norm and every gradient (the head's
    gathered) against the JAX step on a mesh with model 2, whose head is
    padded to 128 columns."""
    cfg = {"task": "face", "backbone": {TINY_VIT: {"feat_dim": 16, "image_size": IMG}},
           "head": {head: {"feat_dim": 16, "num_class": NUM_CLASS, **HEADS[head]}}}
    jmodel, tree, port, sd = _setup(cfg, seed=12, class_pad_multiple=128)
    batch = _batches(1, seed=5)[0]
    batch["label"] = np.array([0, 66, 33, 34, 5, 40, 12, 60], np.int32)  # both shards, their edges
    loss = ("ce", {"label_smooth": 0.1, "valid_class": NUM_CLASS})
    lossfn = JL.create_lossfn(loss[0], **loss[1])
    mesh = jax_build_mesh(devices=jax.devices()[:WORLD], model=2)
    variables = {t: jax.tree_util.tree_map(jnp.asarray, _unflatten(flat)) for t, flat in tree.items() if flat}
    placed = place_state(mesh, jax_create_train_state(variables, optax.sgd(0.0)))
    assert placed.params["head"]["weight"].shape == (16, 128)

    def loss_of(params, images, labels):
        (logits, aux), _ = jmodel.apply({"params": params, "batch_stats": placed.batch_stats}, images, labels,
                                        train=True, mutable=["batch_stats"])
        return lossfn(logits, labels, None) + aux, logits

    images = jax_device_preprocess(jnp.asarray(batch["image"]), (0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
    (jloss, jlogits), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        placed.params, jax.device_put(images, mesh.batch), jax.device_put(jnp.asarray(batch["label"]), mesh.batch))
    norm = float(optax.global_norm(grads))
    flat = _flat(grads)
    assert np.abs(flat["head/weight"][:, NUM_CLASS:]).max() == 0  # the pad carries no gradient
    scale = min(1.0, 10.0 / norm)
    want = _want(port, {p: v * scale for p, v in flat.items()}, tree["batch_stats"])
    outs = ranks.run("step", {"model": cfg, "state": sd, "hyp": PET_SYNTH_HYP, "loss": loss, "batches": [batch],
                              "model_parallel": 2, "probe": True})
    for out in outs:
        np.testing.assert_allclose(out["logits"], np.asarray(jlogits)[:, :NUM_CLASS], rtol=0, atol=1e-4)
        np.testing.assert_allclose(out["loss"][0], float(jloss), rtol=1e-5)
        np.testing.assert_allclose(out["norm"], min(norm, 10.0), rtol=1e-5)
        assert out["grads"]["head.weight"].shape == (16, NUM_CLASS)
        floor = 1e-6 * max(np.abs(v).max() for v in want.values())
        for key, value in want.items():
            if key in out["grads"]:
                np.testing.assert_allclose(out["grads"][key], value, rtol=0,
                                           atol=max(1e-3 * np.abs(value).max(), floor), err_msg=key)
    _same_on_both_ranks(outs, "model", "ema")


# ---------------------------------------------------------------- the CLI under torchrun


def _metrics(project: Path) -> dict:
    out = {}
    for line in (project / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        out.setdefault(rec["tag"], []).append((rec["step"], rec["value"]))
    return out


def test_torchrun_cli_trains_writes_from_rank_0_and_resumes_in_one_process(face_toy, tmp_path, monkeypatch):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    visiondk_tpu_torch.main --multihost --model_parallel 2 --device cpu``
    on face_synth (resnet18 at 32 px, ArcFace over 8 ids: 4 columns a rank),
    2 epochs; then ``--resume`` in one process for a third epoch."""
    _, cfg = face_toy
    cfg_path = tmp_path / "face.yaml"
    yaml_dump(cfg, cfg_path)
    project = tmp_path / "run"
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2", "--master_addr", "127.0.0.1",
         "--master_port", str(free_port()), "-m", "visiondk_tpu_torch.main", "--multihost", "--model_parallel", "2",
         "--device", "cpu", "--cfgs", str(cfg_path), "--project", str(project)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    # rank 0 alone writes: one log, one metrics stream, the checkpoints; both evaluate the same pairs
    assert len(list(project.glob("log*.log"))) == 1
    metrics = _metrics(project)
    assert [s for s, _ in metrics["Val_mean"]] == [0, 1] and all(np.isfinite(v) for _, v in metrics["Train_epoch_loss"])
    rank1 = [eval(m) for m in re.findall(r"^\[rank 1\] (\{'mean'.*\})$", proc.stdout, re.M)]  # noqa: S307
    assert [r["mean"] for r in rank1] == [v for _, v in metrics["Val_mean"]]
    assert "[rank 1]" not in (project / next(project.glob("log*.log")).name).read_text()
    saved = CheckpointManager(project).read("last")
    assert saved["model"]["head.weight"].shape == (16, 8) and saved["ema"]["head.weight"].shape == (16, 8)

    # one process resumes the 2-rank checkpoint, and its own checkpoint has the same layout
    cfg["hyp"]["epochs"] = 3
    yaml_dump(cfg, cfg_path)
    from visiondk_tpu_torch import main as port_main

    port_main.main(port_main.parse_opt(["--cfgs", str(cfg_path), "--project", str(project), "--resume",
                                        "--device", "cpu"]))
    resumed = CheckpointManager(project).read("last")
    assert json.loads((project / "last" / "meta.json").read_text())["epoch"] == 2
    for part in ("model", "ema"):
        assert {k: v.shape for k, v in saved[part].items()} == {k: v.shape for k, v in resumed[part].items()}
    assert [g["params"] for g in saved["optimizer"]["param_groups"]] == \
        [g["params"] for g in resumed["optimizer"]["param_groups"]]
    assert {i: {k: tuple(v.shape) for k, v in s.items()} for i, s in saved["optimizer"]["state"].items()} == \
        {i: {k: tuple(v.shape) for k, v in s.items()} for i, s in resumed["optimizer"]["state"].items()}
    assert [s for s, _ in _metrics(project)["Val_mean"]] == [0, 1, 2]
