"""One rank of the port's 2-process gloo tests (``test_torch_port_distributed.py``,
``test_torch_port_retrieval_approx.py``), and ``Ranks``, the test files' handle
on the two.

Started as ``python -m tests.torch_dist_worker <rank> <world> <port> <dir>``,
it joins a gloo process group on the CPU, then serves cases until its stdin
closes: a line ``<case> <n>`` names a case of ``CASES`` and the file
``<dir>/in_<n>.pt`` holding its inputs; the rank writes its result to
``<dir>/out_<n>_<rank>.pt`` and prints ``done <n>`` (``error <n>`` and the
traceback on stderr when the case raised). It imports torch and the port
only, never JAX.
"""

from __future__ import annotations

import os
import queue
import socket
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from visiondk_tpu_torch.data import native as port_native
from visiondk_tpu_torch.engine import steps as port_steps
from visiondk_tpu_torch.engine.optim import SAMConfig, sam_perturb
from visiondk_tpu_torch.engine.state import create_train_state, full_state_dict, gather_head, sharded_heads
from visiondk_tpu_torch.engine.steps import OHEMConfig, StepConfig, make_train_step, mixup_permutation
from visiondk_tpu_torch.engine.trainer import CenterProcessor, build_tx
from visiondk_tpu_torch.losses import create_lossfn
from visiondk_tpu_torch.losses.losses import class_sharded_cross_entropy
from visiondk_tpu_torch.models import BACKBONES, get_model
from visiondk_tpu_torch.models.backbones.resnet import _resnet
from visiondk_tpu_torch.models.backbones.vit import _vit
from visiondk_tpu_torch.ops import retrieval
from visiondk_tpu_torch.parallel import build_mesh, initialize_distributed

# the tiny backbones of the test file, under the names it registers in the JAX registry
TINY_VIT = "vit_tiny_patch8_port_distributed_test"
TINY_RESNET = "resnet_tiny_basic_port_distributed_test"


def register_tiny_backbones() -> None:
    if TINY_VIT not in BACKBONES._store:
        BACKBONES.register(_vit(8, 64, 2, 4), name=TINY_VIT)
    if TINY_RESNET not in BACKBONES._store:
        BACKBONES.register(_resnet([1, 1, 1, 1], "basic"), name=TINY_RESNET)


def _tensors(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)) for k, v in tree.items()}


def _numpy(sd: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def case_step(args: Dict[str, Any], rank: int) -> Dict[str, Any]:
    """Train steps of ``args["model"]`` on this rank's rows of each global
    batch; returns the losses, the full state dicts of the model and the EMA,
    and (``probe``) the first batch's logits over all classes and the last
    step's clipped gradients with their global norm."""
    mesh = build_mesh(model=args.get("model_parallel", 1))
    model = get_model(args["model"], device="cpu")
    model.load_state_dict(_tensors(args["state"]))
    embedding = args["model"]["task"] != "classification"
    if embedding and mesh.n_model > 1:
        model.head.shard(mesh)
    hyp = args["hyp"]
    tx = build_tx(hyp, args.get("steps_per_epoch", 2), not embedding)
    name, kwargs = args["loss"]
    lossfn = create_lossfn(name, **kwargs)
    if embedding and mesh.n_model > 1:
        head = model.head

        def lossfn(logits, targets, sample_weight=None):
            return class_sharded_cross_entropy(logits, targets, head.num_class, head.class_offset, mesh,
                                               kwargs.get("label_smooth", 0.0))

    cfg = StepConfig(task="embedding" if embedding else "classification", mixup=args.get("mixup", False),
                     ohem=OHEMConfig(*args["ohem"]) if args.get("ohem") else None,
                     sam=SAMConfig(**args["sam"]) if args.get("sam") is not None else None)
    perms = iter(args.get("perms", []))
    port_steps.mixup_permutation = lambda b, generator: torch.as_tensor(next(perms))
    recorded = []  # SAM's e of each call
    port_steps.sam_perturb = lambda *a, **k: recorded.append(sam_perturb(*a, **k)) or recorded[-1]
    try:
        return _steps(args, rank, mesh, model, tx, lossfn, cfg, embedding, recorded)
    finally:
        port_steps.mixup_permutation, port_steps.sam_perturb = mixup_permutation, sam_perturb


def _steps(args, rank, mesh, model, tx, lossfn, cfg, embedding, recorded) -> Dict[str, Any]:
    state = create_train_state(model, tx)
    step = make_train_step(model, tx, lossfn, cfg, torch.Generator().manual_seed(0), mesh=mesh)
    out: Dict[str, Any] = {"loss": []}
    for i, batch in enumerate(args["batches"]):
        rows = len(batch["label"]) // mesh.world
        mine = {k: torch.as_tensor(np.asarray(v)[rank * rows:(rank + 1) * rows]) for k, v in batch.items()}
        if args.get("probe") and i == 0 and embedding:
            with torch.no_grad(), port_steps._buffers_kept(model):
                model.train()
                logits, _ = model(port_steps.device_preprocess(mine["image"], cfg.mean, cfg.std), mine["label"])
            widths = [hi - lo for lo, hi in _ranges(model, mesh)]
            out["logits"] = mesh.model_cat(logits, widths).numpy() if mesh.n_model > 1 else logits.numpy()
        out["loss"].append(step(state, mine, args.get("lams", [0.0] * len(args["batches"]))[i])["loss"].item())
    out["model"] = _numpy(full_state_dict(model))
    out["ema"] = _numpy(full_state_dict(state.ema_model))
    out["counts"] = (state.step, state.optimizer.count, state.ema_updates)
    if recorded:
        out["eps"] = {name: e.numpy() for (name, _), e in zip(model.named_parameters(), recorded[0])}
    if args.get("probe"):
        heads = {id(h.weight): h for h in sharded_heads(model).values()}
        grads = {}
        for key, p in model.named_parameters():
            g = p.grad
            if id(p) in heads:
                g = gather_head(g, heads[id(p)].num_class, mesh)
            grads[key] = g.numpy()
        out["grads"] = grads
        norms = torch.stack(torch._foreach_norm([p.grad for p in state.optimizer.params]))
        out["norm"] = float(torch.sqrt(state.optimizer.sum_of_squares(torch.square(norms))))
    return out


def _ranges(model, mesh):
    from visiondk_tpu_torch.parallel import shard_ranges

    return shard_ranges(model.head.num_class, mesh.n_model)


def case_loader(args: Dict[str, Any], rank: int) -> Dict[str, Any]:
    """The trainer's train loader of this rank (``CenterProcessor._train_loader``
    on a process group of 2): its sample indices and batches, epochs 0 and 1,
    through the PIL decode (the test patches the JAX side's native decode off too)."""
    port_native.native_available = lambda: False
    cp = CenterProcessor(args["cfgs"], project=args["project"], device="cpu", mesh=build_mesh())
    loader = cp._train_loader()
    out = {"bs": loader.batch_size, "indices": [], "batches": []}
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        out["indices"].append(np.asarray(loader._indices()))
        out["batches"].append(list(loader))
    return out


def case_search(args: Dict[str, Any], rank: int) -> Dict[str, Any]:
    """``ops.retrieval.search`` of ``args`` with the gallery sharded over the
    ranks (``mesh=build_mesh()``)."""
    scores, idx = retrieval.search(args["queries"], args["gallery"], args["k"], query_chunk=args["chunk"],
                                   compute_dtype=getattr(torch, args["dtype"]),
                                   recall_target=args.get("recall_target"), device="cpu", mesh=build_mesh())
    return {"scores": scores, "idx": idx}


CASES = {"step": case_step, "loader": case_loader, "search": case_search}


# ---------------------------------------------------------------- the parent's side


REPO = Path(__file__).resolve().parent.parent
WORLD = 2
CASE_TIMEOUT_S = 150


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """Two rank processes serving ``torch_dist_worker.CASES``."""

    def __init__(self, folder: Path):
        self.folder, self.n, self.procs, self.lines = folder, 0, [], []
        port = free_port()
        env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}
        for rank in range(WORLD):
            proc = subprocess.Popen(
                [sys.executable, "-m", "tests.torch_dist_worker", str(rank), str(WORLD), str(port), str(folder)],
                cwd=REPO, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=open(folder / f"stderr_{rank}.log", "w"), text=True)
            lines: "queue.Queue[str]" = queue.Queue()
            threading.Thread(target=lambda p=proc, q=lines: [q.put(x.strip()) for x in p.stdout], daemon=True).start()
            self.procs.append(proc)
            self.lines.append(lines)
        self._expect("ready", 120)

    def _expect(self, word: str, timeout: float) -> None:
        """Wait for ``word`` from every rank (other printed lines, such as a
        trainer's log, are skipped)."""
        deadline = time.monotonic() + timeout
        for rank, lines in enumerate(self.lines):
            while True:
                try:
                    line = lines.get(timeout=max(deadline - time.monotonic(), 0.01))
                except queue.Empty:
                    self.close()
                    raise AssertionError(f"rank {rank} did not say {word!r} within {timeout} s; stderr:\n"
                                         + self.stderr(rank)) from None
                if line == word:
                    break
                if line.startswith("error "):
                    self.close()
                    raise AssertionError(f"rank {rank} failed; stderr:\n" + self.stderr(rank))

    def stderr(self, rank: int) -> str:
        return (self.folder / f"stderr_{rank}.log").read_text()[-4000:]

    def run(self, case: str, args: dict, timeout: float = CASE_TIMEOUT_S) -> list:
        """Each rank's result of ``case`` on ``args``."""
        assert all(p.poll() is None for p in self.procs), "a rank process has exited"
        self.n += 1
        torch.save(args, self.folder / f"in_{self.n}.pt")
        for proc in self.procs:
            proc.stdin.write(f"{case} {self.n}\n")
            proc.stdin.flush()
        self._expect(f"done {self.n}", timeout)
        return [torch.load(self.folder / f"out_{self.n}_{r}.pt", weights_only=False) for r in range(WORLD)]

    def close(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.stdin.close()
        for proc in self.procs:
            try:
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def main() -> None:
    rank, world, port, folder = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
    torch.set_num_threads(2)
    register_tiny_backbones()
    initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo")
    print("ready", flush=True)
    for line in sys.stdin:
        case, n = line.split()
        try:
            args = torch.load(folder / f"in_{n}.pt", weights_only=False)
            result = CASES[case](args, rank)
            torch.save(result, folder / f"out_{n}_{rank}.pt")
            print(f"done {n}", flush=True)
        except Exception:
            traceback.print_exc()
            print(f"error {n}", flush=True)


if __name__ == "__main__":
    main()
