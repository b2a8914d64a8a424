"""The readings that the limits of ``correct`` are set from, on the card at the
cell's own size, for several seeds in one process (the benchmark's runs do not
run this):

    python3 -m portbench.calibrate --workload <cell> --seeds 1 2 3 ...

For each seed it prints one JSON line of the numbers that decide ``correct``:

- ``program``: the port against the float32 reference (the lower reading);
- ``control``: the reference computed in fp8 (e4m3 operands, per-tensor
  scales) put in the program's place, against the float32 reference;
- ``half_batch`` (train cells): the port fed half of each batch, its loss the
  mean over those rows, against the reference on the whole batch;
- ``no_exchange`` (data-parallel cells): every rank's step without the
  process group, so no gradient crosses between the cards.

A state left unchanged reads 1 on ``change_gap`` and an altered embedding
row reads 2 on ``row_gap`` by their definitions; they need no run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import compare, inputs, port
from portbench.reference.common import Precision
from portbench.run import ROOT, benchmark, cache_dirs, make_cell


def train_seed(cell, seed: int) -> dict:
    from portbench.traffic import train

    out, timing = {}, {}
    cell.seed, cell.fault = seed, None
    t = time.perf_counter()
    state, step, feed, batches, prog = train.setup(cell)
    timing["program_s"] = time.perf_counter() - t
    compared = batches[:cell.traffic["compared_steps"]]
    del state, step, feed
    train.release(cell.device)
    t = time.perf_counter()
    ref = train.reference_readings(cell, compared, Precision("f32"))
    timing["reference_s"] = time.perf_counter() - t
    control = train.reference_readings(cell, compared, Precision("fp8"))
    out["program"] = compare.train_numbers(prog, ref)
    out["control"] = compare.train_numbers(control, ref)
    cell.fault = "half_batch"
    state, step, feed, batches, half = train.setup(cell)
    del state, step, feed, batches
    train.release(cell.device)
    out["half_batch"] = compare.train_numbers(half, ref)
    out["losses"] = {"program": prog["losses"], "reference": ref["losses"], "control": control["losses"]}
    out["timing"] = timing
    return out


def embed_seed(cell, seed: int) -> dict:
    from portbench.traffic import embed

    cell.seed = seed
    cfg, dev = cell.cfg, cell.device
    model = port.build_model(cfg, {**inputs.weights(cfg, seed, dev), **inputs.buffers(cfg, dev)}, dev)
    port.deterministic_cudnn()
    step = port.embed_step(cfg, model)
    batches = inputs.pool(cfg, cell.traffic, seed, dev)
    wanted = set(range(len(batches)))
    prog = {k: step({"image": batches[k][0]}).cpu() for k in wanted}
    del model, step
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = embed.reference_embeddings(cell, batches, wanted, Precision("f32"))
    ref_s = time.perf_counter() - t
    control = embed.reference_embeddings(cell, batches, wanted, Precision("fp8"))
    return {"program": {"row_gap": max(compare.row_gap(prog[k], ref[k]) for k in wanted)},
            "control": {"row_gap": max(compare.row_gap(control[k], ref[k]) for k in wanted)},
            "timing": {"reference_s": ref_s}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    cache_dirs()
    sys.path.insert(0, str(ROOT))
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    bench = benchmark()
    cell = make_cell(bench, args.workload, args.seeds[0], 0.0, False, torch.device("cuda", 0))
    if cell.traffic["kind"] == "train_ddp":
        from portbench.traffic import train_ddp

        t = time.perf_counter()
        for seed, out in train_ddp.with_ranks(cell, args.seeds).items():
            out.update({"workload": args.workload, "seed": seed, "seconds": time.perf_counter() - t})
            print(json.dumps(out), flush=True)
        return 0
    for seed in args.seeds:
        t = time.perf_counter()
        out = (train_seed if cell.traffic["kind"] == "train" else embed_seed)(cell, seed)
        out.update({"workload": args.workload, "seed": seed, "seconds": time.perf_counter() - t})
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
