"""Checkpoint / resume on ``torch.save`` / ``torch.load`` (counterpart of
``visiondk_tpu/engine/checkpoint.py``, which checkpoints through Orbax).

A checkpoint ``name`` (``last``, ``best``, the embedding loop's
``Epoch_{n}``) is a directory ``{name}/`` in the run directory holding
``state.pt`` and ``meta.json`` (``epoch``, ``best_fitness``, and what the
caller adds). ``state.pt`` holds everything a resumed run needs to
continue as the uninterrupted run would: the model's and the EMA module's
state dicts, the optimizer's state, ``step``, ``ema_updates``, the count of
applied updates, with gradient accumulation the round's running mean of
gradients and its mini-step count (a run killed in the middle of a round
resumes it), and the state of the train step's CPU generator (without it a
resumed run would draw other dropout masks).

In a distributed run every rank calls ``save``, ``wait`` and ``restore``
(the manager takes the run's ``MeshContext``): a class-sharded head's weight,
its optimizer slots and its accumulated gradient are gathered whole before the
write and split to each rank's columns on restore, so a checkpoint is the
same file at every world size and model-parallel size, and a run of W ranks
resumes in one process and the reverse. Only rank 0 writes, recovers the
directory at construction, and promotes; ``save`` starts with a barrier and
``wait`` ends with one, so every rank reads a checkpoint only after rank 0's
write of it has finished.

Saves are asynchronous: ``save`` copies every tensor of the state to host
memory before it returns (the next step may then update the live tensors),
and a background thread writes the copy into a fresh temporary directory
``.{name}.staging.tmp-<pid>-<n>`` and renames it to ``.{name}.staging``, so
a staging directory that exists is complete. ``wait()`` joins the writes.

Crash safety, as the JAX manager's: an overwrite never leaves a moment with
no complete checkpoint on disk. The ``{name}.meta.json`` sidecar is written
before the save; ``_promote`` — run at every join point (``wait()``, a later
save of the same name, any restore, and construction, for crash recovery) —
stamps the sidecar into the staging dir as ``meta.json`` and moves it into
place with two renames (old → ``.{name}.trash``, staging → ``{name}``).
At every instant a complete checkpoint exists under ``{name}``,
``.{name}.staging`` or ``.{name}.trash``, and construction recovers it. Only
a *writer* (the training run that owns the directory) deletes half-written
temporaries: a reader (validate) opened on a live run directory must not
delete the trainer's in-flight write.
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from visiondk_tpu_torch.engine.state import (
    TrainState, full_state_dict, gather_head, load_full_state_dict, shard_head, sharded_heads,
)

_STAGE = ".{}.staging"
_TRASH = ".{}.trash"
_TMP = ".tmp-"
_STATE = "state.pt"
_serial = itertools.count()


def _to_host(obj):
    """A copy of ``obj`` with every tensor copied to the CPU."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _per_parameter(state: TrainState, optimizer: Dict[str, Any], acc: Optional[list], fn) -> tuple:
    """An optimizer state dict and accumulated gradients of ``state``'s
    parameters with each 2-d tensor of a class-sharded parameter passed
    through ``fn(head, t)``."""
    heads = {id(h.weight): h for h in sharded_heads(state.model).values()}
    if not heads:
        return optimizer, acc
    order = [p for group in state.optimizer.optimizer.param_groups for p in group["params"]]

    def each(p, t):
        return fn(heads[id(p)], t) if id(p) in heads and torch.is_tensor(t) and t.ndim == 2 else t

    optimizer = {**optimizer, "state": {i: {k: each(order[i], v) for k, v in slots.items()}
                                        for i, slots in optimizer["state"].items()}}
    return optimizer, None if acc is None else [each(p, a) for p, a in zip(state.optimizer.params, acc)]


def _snapshot(state: TrainState) -> Dict[str, Any]:
    """The host copy of ``state`` that ``state.pt`` holds (class-sharded
    tensors gathered whole: a collective where the model holds a shard)."""
    optimizer, acc = _per_parameter(state, state.optimizer.optimizer.state_dict(), state.optimizer.acc_grads,
                                    lambda head, t: gather_head(t, head.num_class, head.mesh))
    return {
        "model": _to_host(full_state_dict(state.model)),
        "ema": _to_host(full_state_dict(state.ema_model)),
        "optimizer": _to_host(optimizer),
        "step": state.step,
        "ema_updates": state.ema_updates,
        "opt_count": state.optimizer.count,
        "opt_acc_grads": _to_host(acc),
        "opt_mini_step": state.optimizer.mini_step,
        "generator": None if state.generator is None else state.generator.get_state(),
    }


class CheckpointManager:
    def __init__(self, directory, writer: bool = False, mesh=None):
        """``writer``: this manager owns the run directory and may delete
        half-written temporaries at construction (see module doc). ``mesh``:
        the run's ``MeshContext`` in a distributed run; only its rank 0
        touches the directory."""
        self.directory = Path(directory).resolve()
        self._mesh = mesh
        self._primary = mesh is None or mesh.is_primary()
        if self._primary:
            self.directory.mkdir(parents=True, exist_ok=True)
        self._pool = ThreadPoolExecutor(1, thread_name_prefix="ckpt-write")
        self._futures: Dict[str, Future] = {}
        self._pending: set = set()
        self._writer = bool(writer)
        if self._primary:
            self._recover_staged()

    # -------------------------------------------------- staging / promotion

    def _stage_path(self, name: str) -> Path:
        return self.directory / _STAGE.format(name)

    def _recover_staged(self) -> None:
        """Crash recovery at construction: promote complete but unpromoted
        staging dirs, bring back a trashed checkpoint that is the only
        complete copy, drop leftover trash, and (writer only) drop
        half-written temporaries."""
        if self._writer:
            for p in self.directory.glob(f"{_STAGE.format('*')}{_TMP}*"):
                shutil.rmtree(p, ignore_errors=True)
        for p in self.directory.glob(_TRASH.format("*")):
            name = p.name[1: -len(".trash")]
            if not (self.directory / name).exists() and not self._stage_path(name).exists():
                # promote died between its two renames with no newer staged
                # copy left: the trashed dir is the only complete checkpoint
                p.rename(self.directory / name)
            else:
                shutil.rmtree(p, ignore_errors=True)
        for p in self.directory.glob(_STAGE.format("*")):
            if p.is_dir():
                self._promote(p.name[1: -len(".staging")])

    def _promote(self, name: str) -> None:
        """Move a complete staging dir into place: stamp meta inside (the dir
        becomes self-contained), rename old → trash, staging → final, drop
        trash. A crash between any two steps leaves a complete checkpoint
        under ``name``, ``.{name}.staging`` or ``.{name}.trash``."""
        staging = self._stage_path(name)
        self._pending.discard(name)
        if not staging.exists():
            return
        sidecar = self.directory / f"{name}.meta.json"
        if sidecar.exists():
            shutil.copyfile(sidecar, staging / "meta.json")
        final = self.directory / name
        trash = self.directory / _TRASH.format(name)
        shutil.rmtree(trash, ignore_errors=True)
        try:
            if final.exists():
                final.rename(trash)
            staging.rename(final)
        except OSError:
            # another manager on the same run dir promoted the same staged
            # data concurrently (a reader opened mid-train): nothing left to do
            return
        shutil.rmtree(trash, ignore_errors=True)
        sidecar.unlink(missing_ok=True)

    def _write(self, name: str, host_state: Dict[str, Any]) -> None:
        tmp = self.directory / f"{_STAGE.format(name)}{_TMP}{os.getpid()}-{next(_serial)}"
        tmp.mkdir()
        torch.save(host_state, tmp / _STATE)
        tmp.rename(self._stage_path(name))  # the commit: staging is complete once it exists

    def wait(self) -> None:
        """Join in-flight writes (raising any error they met) and promote
        them into place, then (distributed) wait for every rank. Called
        before any restore and by the trainer at the end of a run."""
        for name in sorted(self._futures):
            self._futures.pop(name).result()
        for name in sorted(self._pending):
            self._promote(name)
        if self._mesh is not None:
            self._mesh.barrier()

    # ------------------------------------------------------------ full state

    def save(
        self,
        name: str,
        state: TrainState,
        epoch: int,
        best_fitness: float,
        extra: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Save ``state`` as checkpoint ``name`` (asynchronously; see the
        module doc). ``meta.json`` holds ``epoch``, ``best_fitness`` and the
        entries of ``extra`` (the embedding loop's per-epoch ``fitness``)."""
        meta = {"epoch": epoch, "best_fitness": float(best_fitness), **(extra or {})}
        if self._mesh is not None:
            self._mesh.barrier()  # every rank enters the save at the same step
        host_state = _snapshot(state)
        if not self._primary:
            return
        if name in self._pending:
            # the previous save of this name: join and promote it, so the
            # staging slot is free and the promote bookkeeping one deep
            future = self._futures.pop(name, None)
            if future is not None:
                future.result()
            self._promote(name)
        shutil.rmtree(self._stage_path(name), ignore_errors=True)  # stale crash leftover
        # the meta sidecar BEFORE the save: recovery of a complete staging dir
        # can then always stamp the right meta into it
        with open(self.directory / f"{name}.meta.json", "w") as f:
            json.dump(meta, f)
        self._pending.add(name)
        self._futures[name] = self._pool.submit(self._write, name, host_state)

    def _read_meta(self, name: str) -> Dict[str, Any]:
        indir = self.directory / name / "meta.json"     # self-contained (promoted)
        sidecar = self.directory / f"{name}.meta.json"  # in-flight / recovery
        path = indir if indir.exists() else sidecar
        if not path.exists():
            # a checkpoint dir copied without its meta: degrade, don't crash.
            # best_fitness must stay comparable (NaN would make every later
            # `fitness > best_fitness` False and stop 'best' saves on resume);
            # "meta_missing" lets the resume path warn loudly.
            return {"epoch": -1, "best_fitness": 0.0, "meta_missing": True}
        with open(path) as f:
            return json.load(f)

    def read(self, name: str) -> Dict[str, Any]:
        """The saved state dict of checkpoint ``name``, on the CPU."""
        self.wait()
        return torch.load(self.directory / name / _STATE, map_location="cpu", weights_only=True)

    def restore(self, name: str, state: TrainState) -> Tuple[TrainState, Dict[str, Any]]:
        """Load checkpoint ``name`` into ``state`` in place (model, EMA,
        optimizer, counters, generator); returns ``(state, meta)``."""
        saved = self.read(name)
        load_full_state_dict(state.model, saved["model"])
        load_full_state_dict(state.ema_model, saved["ema"])
        optimizer, acc = _per_parameter(state, saved["optimizer"], saved.get("opt_acc_grads"),
                                        lambda head, t: shard_head(t, head.mesh))
        state.optimizer.optimizer.load_state_dict(optimizer)
        state.step, state.ema_updates = saved["step"], saved["ema_updates"]
        state.optimizer.count = saved["opt_count"]
        state.optimizer.acc_grads = None if acc is None else [
            a.to(p.device) for a, p in zip(acc, state.optimizer.params)]
        state.optimizer.mini_step = saved.get("opt_mini_step", 0)
        if state.generator is not None and saved["generator"] is not None:
            state.generator.set_state(saved["generator"])
        return state, self._read_meta(name)

    def exists(self, name: str) -> bool:
        self.wait()
        return (self.directory / name).exists()

    # ------------------------------------------------------------ fine-tune

    @staticmethod
    def load_from(
        target: Dict[str, torch.Tensor],
        source: Dict[str, torch.Tensor],
        logger=None,
        prefix: str = "",
    ) -> Dict[str, torch.Tensor]:
        """Non-strict merge of state dicts: every ``target`` entry whose key
        ``source`` has with the same shape takes the source's values (in the
        target's dtype); the rest keep theirs. Logs the counts of loaded,
        missing, shape-mismatched and unexpected entries."""
        loaded, missing, mismatched = [], [], []
        out: Dict[str, torch.Tensor] = {}
        for key, value in target.items():
            src = source.get(key)
            if src is not None and tuple(src.shape) == tuple(value.shape):
                out[key] = src.to(value.dtype)
                loaded.append(key)
            else:
                out[key] = value
                (mismatched if src is not None else missing).append(key)
        unexpected = [k for k in source if k not in target]
        if logger is not None:
            logger.both(
                f"{prefix}load_from: loaded {len(loaded)} tensors, "
                f"missing {len(missing)}, shape-mismatch {len(mismatched)}, "
                f"unexpected {len(unexpected)}"
            )
        return out
