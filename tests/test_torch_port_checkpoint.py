"""The port's checkpoint manager (``visiondk_tpu_torch/engine/checkpoint.py``).

The eleven cases of ``tests/test_checkpoint_async.py`` on the port's
``torch.save`` manager with a tiny ViT's ``TrainState``: saves overlap the
next step on a background thread but go through a staging directory, so an
overwrite never leaves a moment with no complete checkpoint on disk. They
pin save → restore (same manager, an overwrite in flight, a fresh manager),
promoted directories that carry their own meta, the degraded meta of a
directory copied without it, construction-time recovery at every
interruption point, a reader that leaves in-flight temporaries alone, and
``load_from`` across optimizers. The round trip also restores the optimizer
state, the counters and the train step's generator.
"""

import json
import shutil

import pytest
import torch

from visiondk_tpu_torch.engine.checkpoint import CheckpointManager
from visiondk_tpu_torch.engine.state import create_train_state
from visiondk_tpu_torch.engine.steps import StepConfig, make_train_step
from visiondk_tpu_torch.engine.trainer import CenterProcessor, build_tx
from visiondk_tpu_torch.losses import create_lossfn
from visiondk_tpu_torch.models import BACKBONES, get_model
from visiondk_tpu_torch.models.backbones.vit import _vit

TINY = "vit_tiny_patch8_port_checkpoint_test"
HYP = {
    "epochs": 6, "lr0": 0.01, "lrf_ratio": None, "momentum": 0.937, "weight_decay": 0.0005,
    "warmup_momentum": 0.8, "warm_ep": 1, "optimizer": ["sgd", False], "scheduler": "cosine_with_warm",
}


@pytest.fixture(scope="module", autouse=True)
def tiny_vit_registered():
    BACKBONES.register(_vit(8, 64, 2, 4), name=TINY)
    yield
    del BACKBONES._store[TINY]


def _tiny_state(value: float, hyp=HYP):
    """A tiny ViT's train state with every parameter set to ``value``."""
    model = get_model({"task": "classification", "name": TINY, "num_classes": 7, "image_size": 32}, device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(value)
    return create_train_state(model, build_tx(hyp, 2, True), torch.Generator().manual_seed(0))


def _kernel(state):
    return state.model.backbone.head.weight.detach().clone()


def _full(value):
    return torch.full((7, 64), value)


def test_async_save_restore_roundtrip(tmp_path):
    state = _tiny_state(0.0)
    with torch.no_grad():
        for p in state.model.parameters():
            p.normal_(generator=torch.Generator().manual_seed(5))
    step = make_train_step(state.model, build_tx(HYP, 2, True), create_lossfn("ce"), StepConfig(), state.generator)
    batch = {"image": torch.randint(0, 256, (4, 32, 32, 3), dtype=torch.uint8,
                                    generator=torch.Generator().manual_seed(1)),
             "label": torch.arange(4)}
    step(state, batch)
    mgr = CheckpointManager(tmp_path)
    mgr.save("last", state, epoch=3, best_fitness=0.25)
    restored, meta = mgr.restore("last", _tiny_state(0.0))
    assert meta == {"epoch": 3, "best_fitness": 0.25}
    for got, want in ((restored.model, state.model), (restored.ema_model, state.ema_model)):
        for (k, a), b in zip(got.state_dict().items(), want.state_dict().values()):
            assert torch.equal(a, b), k
    momentum = [restored.optimizer.optimizer.state[p]["momentum_buffer"] for p in restored.model.parameters()]
    want = [state.optimizer.optimizer.state[p]["momentum_buffer"] for p in state.model.parameters()]
    assert all(torch.equal(a, b) for a, b in zip(momentum, want))
    assert (restored.step, restored.ema_updates, restored.optimizer.count) == (1, 1, 1)
    # the generator continues where the saved one was: the next dropout seeds agree
    assert torch.equal(torch.randint(0, 2**62, (3,), generator=restored.generator),
                       torch.randint(0, 2**62, (3,), generator=state.generator))


def test_async_overwrite_same_name(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save("last", _tiny_state(1.0), epoch=0, best_fitness=0.1)
    mgr.save("last", _tiny_state(2.0), epoch=1, best_fitness=0.2)
    restored, meta = mgr.restore("last", _tiny_state(0.0))
    assert meta["epoch"] == 1
    assert torch.equal(_kernel(restored), _full(2.0))


def test_overwrite_never_leaves_a_missing_checkpoint(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save("last", _tiny_state(1.0), epoch=0, best_fitness=0.1)
    mgr.wait()
    assert (tmp_path / "last").exists()
    mgr.save("last", _tiny_state(2.0), epoch=1, best_fitness=0.2)
    # in-flight window: the previous complete checkpoint must still be there
    assert (tmp_path / "last").exists()
    mgr.wait()
    _, meta = mgr.restore("last", _tiny_state(0.0))
    assert meta["epoch"] == 1


def test_fresh_manager_sees_committed_save(tmp_path):
    mgr1 = CheckpointManager(tmp_path)
    mgr1.save("best", _tiny_state(3.0), epoch=7, best_fitness=0.9)
    mgr1.wait()
    mgr2 = CheckpointManager(tmp_path)
    assert mgr2.exists("best")
    restored, meta = mgr2.restore("best", _tiny_state(0.0))
    assert meta["epoch"] == 7
    assert torch.equal(_kernel(restored), _full(3.0))


def test_promoted_dir_is_self_contained(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save("best", _tiny_state(2.5), epoch=4, best_fitness=0.8)
    mgr.wait()
    assert json.loads((tmp_path / "best" / "meta.json").read_text())["epoch"] == 4
    assert not (tmp_path / "best.meta.json").exists()  # sidecar consumed
    moved = tmp_path / "elsewhere"
    moved.mkdir()
    shutil.copytree(tmp_path / "best", moved / "best")
    restored, meta = CheckpointManager(moved).restore("best", _tiny_state(0.0))
    assert meta["epoch"] == 4
    assert torch.equal(_kernel(restored), _full(2.5))


def test_copied_dir_without_meta_degrades(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save("best", _tiny_state(1.0), epoch=2, best_fitness=0.5)
    mgr.wait()
    (tmp_path / "best" / "meta.json").unlink()
    restored, meta = mgr.restore("best", _tiny_state(0.0))
    assert meta["epoch"] == -1
    assert meta["best_fitness"] == 0.0 and meta["best_fitness"] == meta["best_fitness"]
    assert meta["meta_missing"] is True
    assert 0.7 > meta["best_fitness"]  # a real fitness still beats the degraded one
    assert torch.equal(_kernel(restored), _full(1.0))


def test_recovery_promotes_committed_staging(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save("last", _tiny_state(5.0), epoch=6, best_fitness=0.6)
    mgr.wait()
    # the disk as a crash after the write's commit and before the promote leaves it
    (tmp_path / "last").rename(tmp_path / ".last.staging")
    (tmp_path / ".last.staging" / "meta.json").unlink()
    (tmp_path / "last.meta.json").write_text(json.dumps({"epoch": 6, "best_fitness": 0.6}))
    mgr2 = CheckpointManager(tmp_path)
    assert (tmp_path / "last").exists()
    restored, meta = mgr2.restore("last", _tiny_state(0.0))
    assert meta["epoch"] == 6
    assert torch.equal(_kernel(restored), _full(5.0))


def test_recovery_restores_trashed_checkpoint(tmp_path):
    # a crash between the promote's two renames: the trashed dir is the only
    # complete checkpoint and must come back
    mgr = CheckpointManager(tmp_path)
    mgr.save("last", _tiny_state(7.0), epoch=1, best_fitness=0.1)
    mgr.wait()
    (tmp_path / "last").rename(tmp_path / ".last.trash")
    mgr2 = CheckpointManager(tmp_path)
    assert (tmp_path / "last").exists()
    restored, _ = mgr2.restore("last", _tiny_state(0.0))
    assert torch.equal(_kernel(restored), _full(7.0))


def test_recovery_drops_halfwritten_tmp(tmp_path):
    # only a writer (the resuming trainer) cleans up a half-written temporary
    (tmp_path / ".last.staging.tmp-123-0").mkdir(parents=True)
    CheckpointManager(tmp_path, writer=True)
    assert not (tmp_path / ".last.staging.tmp-123-0").exists()


def test_reader_leaves_inflight_tmp_alone(tmp_path):
    # a reader (validate opened on a live run dir) must not delete another
    # process's in-flight write
    tmp = tmp_path / ".last.staging.tmp-456-0"
    tmp.mkdir(parents=True)
    (tmp / "partial_data").write_text("in flight")
    CheckpointManager(tmp_path)  # default: reader
    assert tmp.exists()
    # a writer's save still commits afterwards
    mgr = CheckpointManager(tmp_path, writer=True)
    mgr.save("last", _tiny_state(9.0), epoch=0, best_fitness=0.1)
    mgr.wait()
    restored, _ = mgr.restore("last", _tiny_state(0.0))
    assert torch.equal(_kernel(restored), _full(9.0))


def test_load_from_across_optimizer_shapes(tmp_path):
    # load_from reads only the source's EMA weights, so the new run's
    # optimizer (here Adam, the source's SGD) need not match
    src = _tiny_state(6.0)
    mgr = CheckpointManager(tmp_path)
    mgr.save("best", src, epoch=0, best_fitness=1.0)
    mgr.wait()
    dst = _tiny_state(0.0, hyp={**HYP, "optimizer": ["adam"]})

    class _Logger:
        lines = []

        def both(self, *msgs):
            self.lines.extend(msgs)

    cp = object.__new__(CenterProcessor)
    cp.logger, cp.model = _Logger(), dst.model
    out = cp._apply_load_from(dst, str(tmp_path / "best"))
    assert torch.equal(_kernel(out), _full(6.0)) and torch.equal(out.ema_model.backbone.head.weight, _full(6.0))
    assert isinstance(out.optimizer.optimizer, torch.optim.Adam)
    n = len(dst.model.state_dict())
    assert f"ema load_from: loaded {n} tensors, missing 0, shape-mismatch 0, unexpected 0" in _Logger.lines
