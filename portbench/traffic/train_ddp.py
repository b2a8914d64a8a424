"""Traffic kind ``train_ddp``: the port's train step over ``world`` ranks,
one process a card, as ``main.py --multihost`` runs it: the process group
joined by ``initialize_distributed`` (NCCL on the cards), the step
``make_train_step(mesh=...)`` (DDP: every gradient averaged over the ranks,
the neck's BatchNorm on the global batch's moments).

Rank 0 is the process that runs the benchmark; it starts ranks 1 .. world−1
as processes of their own (spawned) and waits for each to end. Every rank
makes the same weights and the same pool of global batches of ``batch ×
world`` rows from the seed, and feeds its own ``batch`` rows of each. Set-up
drives the first ``compared_steps`` calls, as the ``train`` kind does; rank
0 reads them. In the window every rank calls the step until rank 0's host
clock passes ``--seconds``; after each call the ranks agree over a CPU (gloo)
group whether to go on, so every rank runs the same calls without a device
synchronisation. ``images`` counts the global batch of every call.

After the window the ranks free their programs and leave the group; rank 0
then runs the reference over the global batches (each rank's rows with its
own stochastic-depth seed) and compares, as the ``train`` kind does.

Parameters (``traffic/<mix>.json``): ``world`` and the ``train`` kind's.
"""

from __future__ import annotations

import multiprocessing
import os
import socket
import sys
import threading
import time
from typing import Dict

import torch
import torch.distributed as dist

from portbench import compare, inputs, port
from portbench.cell import Cell
from portbench.reference.common import Precision
from portbench.trace import profile_stretch
from portbench.traffic.train import planted as train_planted
from portbench.traffic.train import program_readings, reference_readings, release, sync

JOIN_TIMEOUT_S = 300
FAULTS = ("no_exchange", "half_batch")  # the planted faults a calibration reads


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_device(cell: Cell, rank: int):
    base = torch.device(cell.device)
    return torch.device("cuda", rank) if base.type == "cuda" else base


def planted(cell: Cell, mesh):
    """The mesh the step runs over: none with the ``no_exchange`` fault (each
    rank trains on its own rows, the gradients never exchanged)."""
    if cell.fault not in (None, "no_exchange", "half_batch"):
        raise ValueError(f"the train_ddp kind has no fault {cell.fault!r}")
    return None if cell.fault == "no_exchange" else mesh


def rank_setup(cell: Cell, rank: int, mesh):
    """(state, step, feed, the program's readings of the compared steps) of one rank."""
    cfg, tr = cell.cfg, cell.traffic
    world, rows = tr["world"], tr["batch"]
    dev = rank_device(cell, rank)
    weights = inputs.weights(cfg, cell.seed, dev)
    model = port.build_model(cfg, {**weights, **inputs.buffers(cfg, dev)}, dev)
    if dev.type == "cuda":
        port.deterministic_cudnn()
    state, step = port.train_step(cfg, model, inputs.derive(cell.seed, "steps"), mesh=planted(cell, mesh))
    if cell.fault == "half_batch":
        step = train_planted(cell, step)
    own = slice(rank * rows, (rank + 1) * rows)
    feed = [{"image": images[own], "label": labels[own]} for images, labels in global_pool(cell, dev)]
    if rank == 0:
        cell.phase("model, state and pool")
    prog = program_readings(cell, step, state, feed, weights)
    return state, step, feed, prog


def global_pool(cell: Cell, device):
    """The pool's global batches (``batch × world`` rows), the same on every rank."""
    tr = cell.traffic
    return inputs.pool(cell.cfg, {**tr, "batch": tr["batch"] * tr["world"]}, cell.seed, device)


def join(cell: Cell, rank: int, address: str):
    dev = rank_device(cell, rank)
    mesh = port.join_ranks(address, cell.traffic["world"], rank, dev)
    return dev, mesh, dist.new_group(backend="gloo")


def rank_run(cell: Cell, rank: int, address: str) -> Dict:
    """One rank's whole run; rank 0's return holds the program's readings."""
    tr = cell.traffic
    dev, mesh, control = join(cell, rank, address)
    if rank == 0:
        cell.phase("imports and process group")
    state, step, feed, prog = rank_setup(cell, rank, mesh)
    release(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    first = tr["compared_steps"]
    dist.barrier(group=control)
    if rank == 0:
        cell.phase("compared steps")
        cell.mark_setup()

    calls, stop = 0, torch.zeros(1)
    sync(dev)
    t0 = time.perf_counter()
    deadline = t0 + cell.seconds
    losses = []
    while not stop.item():
        losses.append(step(state, feed[(first + calls) % len(feed)])["loss"])
        calls += 1
        stop.fill_(float(rank == 0 and time.perf_counter() >= deadline))
        dist.all_reduce(stop, op=dist.ReduceOp.MAX, group=control)
    sync(dev)
    if rank == 0:
        cell.window_s = time.perf_counter() - t0
        cell.attempted = calls
        cell.failed = int((~torch.isfinite(torch.stack(losses).float())).sum())
        cell.images = calls * tr["batch"] * tr["world"]

    offset = first + calls
    if cell.trace_on and dev.type == "cuda":
        if rank == 0:
            cell.trace = profile_stretch(lambda i: step(state, feed[(offset + i) % len(feed)]),
                                         tr["trace_calls"], tr["labelled_calls"], lambda: sync(dev))
        else:
            for i in range(tr["trace_calls"] + tr["labelled_calls"]):
                step(state, feed[(offset + i) % len(feed)])
            sync(dev)
    peak = torch.tensor([float(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0.0])
    dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=control)
    if rank == 0:
        cell.memory_peak_bytes = int(peak.item())
    del state, step, feed, losses
    release(dev)
    dist.barrier(group=control)
    dist.destroy_process_group()
    return {"prog": prog} if rank == 0 else {}


def rank_calibrate(cell: Cell, rank: int, address: str, seeds) -> Dict:
    """For each seed, the program's readings, sound and with each of
    ``FAULTS`` planted, on every rank; then each rank works out the float32
    and fp8 references of its share of the seeds. Rank 0 returns every seed's."""
    world = cell.traffic["world"]
    dev, mesh, control = join(cell, rank, address)
    programs = {}
    for seed in seeds:
        for fault in (None, *FAULTS):
            cell.seed, cell.fault = seed, fault
            state, step, feed, prog = rank_setup(cell, rank, mesh)
            programs[(seed, fault)] = prog
            del state, step, feed
            release(dev)
            dist.barrier(group=control)
    mine = {}
    for seed in seeds[rank::world]:
        cell.seed = seed
        batches = global_pool(cell, dev)[:cell.traffic["compared_steps"]]
        mine[seed] = {prec: reference_readings(cell, batches, Precision(prec), world, device=dev)
                      for prec in ("f32", "fp8")}
        del batches
        release(dev)
    gathered = [None] * world if rank == 0 else None
    dist.gather_object(mine, gathered, dst=0, group=control)
    dist.destroy_process_group()
    if rank != 0:
        return {}
    refs = {seed: r for part in gathered for seed, r in part.items()}
    out = {}
    for seed in seeds:
        out[seed] = {"program": compare.train_numbers(programs[(seed, None)], refs[seed]["f32"]),
                     "control": compare.train_numbers(refs[seed]["fp8"], refs[seed]["f32"])}
        out[seed].update({fault: compare.train_numbers(programs[(seed, fault)], refs[seed]["f32"])
                          for fault in FAULTS})
        out[seed]["losses"] = {"program": programs[(seed, None)]["losses"], "reference": refs[seed]["f32"]["losses"]}
    return out


def _rank_main(bench_root: str, cell_args: Dict, rank: int, address: str, seeds) -> None:
    """Entry of a spawned rank: the same cell, rebuilt from the benchmark's files."""
    sys.path.insert(0, bench_root)
    from portbench import run

    cell = run.make_cell(run.benchmark(), **cell_args)
    if seeds is None:
        rank_run(cell, rank, address)
    else:
        rank_calibrate(cell, rank, address, seeds)


def _watch(ranks, done: threading.Event) -> None:
    """Ends this process if a rank fails while rank 0 may wait on it in a
    collective: a rank that dies would otherwise leave rank 0 waiting until
    the process group's timeout."""
    while not done.wait(1.0):
        failed = [p.exitcode for p in ranks if p.exitcode not in (None, 0)]
        if failed:
            print(f"portbench: a rank ended with exit code {failed[0]}; stopping the run", file=sys.stderr,
                  flush=True)
            for p in ranks:
                if p.is_alive():
                    p.kill()
                p.join()
            os._exit(1)


def with_ranks(cell: Cell, seeds=None) -> Dict:
    """Runs rank 0 here and ranks 1 .. world−1 as spawned processes, waits
    for every one, and returns rank 0's result (``rank_run``, or with
    ``seeds`` ``rank_calibrate``)."""
    from portbench import run as harness

    world = cell.traffic["world"]
    if torch.device(cell.device).type == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} ranks need {world} cards; this machine has {torch.cuda.device_count()}")
    address = f"localhost:{free_port()}"
    cell_args = {"name": cell.name, "seed": cell.seed, "seconds": cell.seconds, "trace": cell.trace_on,
                 "device": torch.device(cell.device).type, "fault": cell.fault}
    ctx = multiprocessing.get_context("spawn")
    ranks = [ctx.Process(target=_rank_main, args=(str(harness.ROOT), cell_args, r, address, seeds))
             for r in range(1, world)]
    for p in ranks:
        p.start()
    done = threading.Event()
    threading.Thread(target=_watch, args=(ranks, done), daemon=True).start()
    try:
        out = rank_run(cell, 0, address) if seeds is None else rank_calibrate(cell, 0, address, seeds)
    finally:
        done.set()
        for p in ranks:
            p.join(JOIN_TIMEOUT_S)
            if p.is_alive():
                p.kill()
                p.join()
    bad = [p.exitcode for p in ranks if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks ended with exit codes {bad}")
    return out


def run(cell: Cell) -> None:
    out = with_ranks(cell)
    world = cell.traffic["world"]
    batches = global_pool(cell, cell.device)[:cell.traffic["compared_steps"]]
    ref = reference_readings(cell, batches, Precision("f32"), world)
    numbers = compare.train_numbers(out["prog"], ref)
    cell.numbers = {k: v for k, (v, _) in numbers.items()}
    cell.where = {k: w for k, (_, w) in numbers.items()}
