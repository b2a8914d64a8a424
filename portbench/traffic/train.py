"""Traffic kind ``train``: the port's train step on a pool of distinct batches.

Set-up builds the model with the benchmark's weights, the train state and the
step (``portbench/port.py``), makes the pool, and drives that same step
through its first ``compared_steps`` calls on distinct batches, reading what
``correct`` compares: each step's loss, each leaf's first gradient as the
optimizer got it (from its SGD trace after one step), and each leaf's change
and its EMA's change after the last of them. Those calls are the warm-up: the
window's calls have the same shapes.

The window calls the step on the pool's batches in turn, dispatched ahead
with no synchronisation, until the host clock passes ``--seconds``, then
synchronises: ``images`` is every call's batch, ``window_s`` the time to that
synchronisation. A step whose loss is not finite counts as failed.

The reference (``portbench/reference``) then follows the same steps from the
same weights and batches, in float32 with TF32 off, in blocks of
``block_rows`` rows.

Parameters (``traffic/<mix>.json``): ``batch``, ``pool`` (distinct batches,
more than ``compared_steps``), ``compared_steps``, ``block_rows``,
``trace_calls`` and ``labelled_calls`` (the traced stretch after the window).
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict

import torch

from portbench import compare, inputs, port
from portbench.cell import Cell
from portbench.reference.common import Precision, f32_products
from portbench.reference.train import train_steps
from portbench.trace import profile_stretch


def sync(device) -> None:
    """Waits for the card's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def program_readings(cell: Cell, step: Callable, state, feed, theta0: Dict[str, torch.Tensor]) -> Dict:
    """The first ``compared_steps`` calls, and what they left."""
    wd = cell.cfg["hyp"]["weight_decay"]
    readings: Dict = {"losses": []}
    for i in range(cell.traffic["compared_steps"]):
        readings["losses"].append(float(step(state, feed[i % len(feed)])["loss"]))
        if i == 0:
            trace = port.momentum_buffers(state)
            readings["first_grad"] = compare.norms(
                {n: trace.get(n, torch.zeros_like(t)) - wd * t for n, t in theta0.items()})
    with torch.no_grad():
        live = dict(state.model.named_parameters())
        ema = port.ema_parameters(state)
        readings["change"] = compare.norms({n: live[n] - t for n, t in theta0.items()})
        readings["ema_change"] = compare.norms({n: ema[n] - t for n, t in theta0.items()})
    return readings


def planted(cell: Cell, step: Callable) -> Callable:
    """The step with the harness test's fault, if any."""
    if cell.fault == "unchanged":
        return lambda state, batch: {"loss": torch.zeros((), device=batch["image"].device)}
    if cell.fault == "half_batch":
        def half(state, batch):
            rows = batch["image"].shape[0] // 2
            return step(state, {k: v[:rows] for k, v in batch.items()})
        return half
    if cell.fault is not None:
        raise ValueError(f"the train kind has no fault {cell.fault!r}")
    return step


def setup(cell: Cell):
    """(state, step, feed, batches, the program's readings of the compared steps)."""
    cfg, tr, dev = cell.cfg, cell.traffic, cell.device
    if tr["pool"] <= tr["compared_steps"]:
        raise ValueError("the pool must hold more batches than the compared steps")
    cell.phase("imports")
    weights = inputs.weights(cfg, cell.seed, dev)
    model = port.build_model(cfg, {**weights, **inputs.buffers(cfg, dev)}, dev)
    if torch.device(dev).type == "cuda":
        port.deterministic_cudnn()
    state, step = port.train_step(cfg, model, inputs.derive(cell.seed, "steps"))
    step = planted(cell, step)
    batches = inputs.pool(cfg, tr, cell.seed, dev)
    feed = [{"image": images, "label": labels} for images, labels in batches]
    cell.phase("model, state and pool")
    prog = program_readings(cell, step, state, feed, weights)
    cell.phase("compared steps")
    return state, step, feed, batches, prog


def release(device) -> None:
    """Frees what the dropped references held, on the card too."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run(cell: Cell) -> None:
    tr, dev = cell.traffic, cell.device
    state, step, feed, batches, prog = setup(cell)
    release(dev)
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    first = tr["compared_steps"]
    before = port.kernel_launches()
    cell.mark_setup()

    losses = []
    sync(dev)
    t0 = time.perf_counter()
    deadline = t0 + cell.seconds
    while True:
        losses.append(step(state, feed[(first + len(losses)) % len(feed)])["loss"])
        if time.perf_counter() >= deadline:
            break
    sync(dev)
    cell.window_s = time.perf_counter() - t0
    cell.attempted = len(losses)
    cell.failed = int((~torch.isfinite(torch.stack(losses).float())).sum())
    cell.images = cell.attempted * tr["batch"] * cell.chips
    after = port.kernel_launches()
    cell.launches = {k: (after[k] - before[k]) // cell.attempted for k in after if after[k] > before[k]}

    if cell.trace_on and torch.device(dev).type == "cuda":  # the device trace: CUDA activity
        offset = first + cell.attempted
        cell.trace = profile_stretch(lambda i: step(state, feed[(offset + i) % len(feed)]),
                                     tr["trace_calls"], tr["labelled_calls"], lambda: sync(dev))
    if torch.device(dev).type == "cuda":
        cell.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev))

    compared = batches[:first]
    del state, step, feed, losses, batches
    release(dev)
    ref = reference_readings(cell, compared, Precision("f32"))
    numbers = compare.train_numbers(prog, ref)
    cell.numbers = {k: v for k, (v, _) in numbers.items()}
    cell.where = {k: w for k, (_, w) in numbers.items()}


def reference_readings(cell: Cell, batches, prec: Precision, world: int = 1, device=None) -> Dict:
    """The reference's readings of the same steps, from the same weights,
    batches (the global batches of ``world`` ranks) and step seed, on
    ``device`` (the cell's by default)."""
    cfg, dev = cell.cfg, (cell.device if device is None else device)
    model = inputs.reference_model(cfg)
    weights = inputs.weights(cfg, cell.seed, dev)
    with f32_products():
        out = train_steps(model, cfg["arch"], cfg, weights, inputs.buffers(cfg, dev), batches,
                          inputs.derive(cell.seed, "steps"), prec, cell.traffic["block_rows"], world)
    return {"losses": out["losses"], "first_grad": compare.norms(out["first_grad"]),
            "change": compare.norms(out["change"]), "ema_change": compare.norms(out["ema_change"])}
