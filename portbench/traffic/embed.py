"""Traffic kind ``embed``: gallery extraction through the port's embed step,
a closed loop of one caller.

Set-up builds the model with the benchmark's weights and ``make_embed_step``,
makes the pool of distinct batches, and warms the step with ``warm_calls``
calls. In the window the caller sends a batch, waits for its embeddings and
copies them to the host (as the CBIR evaluation's extraction does), then
sends the next, until the host clock passes ``--seconds``. Each call's
latency runs from its start to its embeddings on the host; its enqueue time
from its start to the step's return, before the copy. A call whose
embeddings are not finite counts as failed.

``correct``: once the window has closed, ``sampled_calls`` calls drawn from
the seed are compared row by row with the reference's embeddings of the same
batch (float32, TF32 off, in blocks of ``block_rows`` rows).

Parameters (``traffic/<mix>.json``): ``batch``, ``pool``, ``warm_calls``,
``sampled_calls``, ``block_rows``, ``trace_calls``, ``labelled_calls``.
"""

from __future__ import annotations

import gc
import random
import time
from typing import Callable, Dict, List

import torch

from portbench import compare, inputs, port
from portbench.cell import Cell
from portbench.reference.common import Precision, f32_products, split_rows
from portbench.trace import profile_stretch
from portbench.traffic.train import release, sync


def planted(cell: Cell, step: Callable) -> Callable:
    """The step with the harness test's fault, if any."""
    if cell.fault == "altered_row":
        def altered(batch):
            out = step(batch).clone()
            out[0] = -out[0]
            return out
        return altered
    if cell.fault is not None:
        raise ValueError(f"the embed kind has no fault {cell.fault!r}")
    return step


def run(cell: Cell) -> None:
    cfg, tr, dev = cell.cfg, cell.traffic, cell.device
    cell.phase("imports")
    model = port.build_model(cfg, {**inputs.weights(cfg, cell.seed, dev), **inputs.buffers(cfg, dev)}, dev)
    if torch.device(dev).type == "cuda":
        port.deterministic_cudnn()
    step = planted(cell, port.embed_step(cfg, model))
    batches = inputs.pool(cfg, tr, cell.seed, dev)
    feed = [{"image": images} for images, _ in batches]
    cell.phase("model and pool")
    for i in range(tr["warm_calls"]):
        step(feed[i % len(feed)]).cpu()
    cell.phase("warm calls")
    gc.collect()  # the allocator keeps its blocks: the window's calls reuse them
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = port.kernel_launches()
    cell.mark_setup()

    outputs: List[torch.Tensor] = []
    sync(dev)
    t0 = time.perf_counter()
    deadline = t0 + cell.seconds
    done = t0
    while done < deadline:
        start = time.perf_counter()
        out = step(feed[len(outputs) % len(feed)])
        returned = time.perf_counter()
        outputs.append(out.cpu())
        done = time.perf_counter()
        cell.latencies_s.append(done - start)
        cell.enqueue_s.append(returned - start)
    cell.window_s = done - t0
    cell.attempted = len(outputs)
    cell.failed = sum(int(not torch.isfinite(o).all()) for o in outputs)
    cell.images = cell.attempted * tr["batch"]
    after = port.kernel_launches()
    cell.launches = {k: (after[k] - before[k]) // cell.attempted for k in after if after[k] > before[k]}

    if cell.trace_on and torch.device(dev).type == "cuda":  # the device trace: CUDA activity
        cell.trace = profile_stretch(lambda i: step(feed[i % len(feed)]).cpu(),
                                     tr["trace_calls"], tr["labelled_calls"], lambda: sync(dev))
    if torch.device(dev).type == "cuda":
        cell.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev))

    rng = random.Random(inputs.derive(cell.seed, "sample"))
    sampled = sorted(rng.sample(range(len(outputs)), min(tr["sampled_calls"], len(outputs))))
    del model, step, feed
    release(dev)
    refs = reference_embeddings(cell, batches, {i % len(batches) for i in sampled}, Precision("f32"))
    cell.numbers = {"row_gap": max(compare.row_gap(outputs[i], refs[i % len(batches)]) for i in sampled)}
    cell.where = {"row_gap": f"{len(sampled)} sampled calls"}


def reference_embeddings(cell: Cell, batches, wanted, prec: Precision) -> Dict[int, torch.Tensor]:
    """The reference's unit embeddings (on the host) of the pool batches in ``wanted``."""
    cfg, dev = cell.cfg, cell.device
    model = inputs.reference_model(cfg)
    weights = inputs.weights(cfg, cell.seed, dev)
    buffers = inputs.buffers(cfg, dev)
    out = {}
    with torch.no_grad(), f32_products():
        for k in sorted(wanted):
            images = batches[k][0]
            out[k] = torch.cat([model.embed(weights, buffers, images[sl], cfg["arch"], cfg, prec).cpu()
                                for sl in split_rows(images.shape[0], cell.traffic["block_rows"])])
    return out
