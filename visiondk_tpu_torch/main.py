"""Train CLI (counterpart of the repo's ``main.py``), on the card by default::

    python -m visiondk_tpu_torch.main --cfgs configs/classification/pet_synth.yaml \
        [--project run/exp] [--resume [last]] [--load_from run/exp/best] [--seed 0] \
        [--device cuda|cpu] [--trace] [--distill]

Distributed, one process a card, launched by torchrun::

    python -m torch.distributed.run --nproc_per_node 8 -m visiondk_tpu_torch.main --multihost \
        [--model_parallel 2] [--dist_backend nccl|gloo] --cfgs configs/faceX/face.yaml

The same flags as ``main.py``, plus ``--device`` (default ``cuda``; without
a card that raises, so a CPU run asks for it with ``--device cpu``). The
port trains the classification task (``run_classifier``) and the face and
CBIR tasks (``run_embedding``, with ``--save_freq`` and ``--print_freq``),
with the device-augment stage where the config lifts the per-pixel random
ops off the host (``data.train.device_augment``, "auto" by default).
``--distill`` reads a config with ``student``, ``teacher`` and ``distill``
sections (``configs/classification/distill_example.yaml``) and trains the
classification student against the frozen teacher
(``engine/distill.py::DistillCenterProcessor``). ``--trace`` records a
``torch.profiler`` trace of the run into ``<project>/trace`` (rank 0's).

``--multihost`` joins the process group that torchrun describes
(``parallel.initialize_distributed``: ``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``; or the JAX package's
``VDK_COORDINATOR_ADDRESS`` / ``VDK_NUM_PROCESSES`` / ``VDK_PROCESS_ID``),
over NCCL on the card and gloo on the CPU unless ``--dist_backend`` says
otherwise; ``--device cuda`` then means ``cuda:LOCAL_RANK`` (a device with an
index is taken as given: two gloo ranks can share one card).
``data.train.bs`` is the global batch, split over the ranks.
``--model_parallel`` m (it must divide the world size) splits the face and
CBIR margin head's classes over groups of m ranks (partial-FC); it changes
nothing else. Rank 0 picks the run directory and alone writes to it.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path


def parse_opt(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cfgs", type=str, required=True, help="configs/*/*.yaml path")
    p.add_argument("--resume", nargs="?", const="last", default=None,
                   help="resume from checkpoint name in the run dir (default: last)")
    p.add_argument("--load_from", default=None, help="fine-tune init checkpoint")
    p.add_argument("--print_freq", type=int, default=50)
    p.add_argument("--save_freq", type=int, default=1, help="embedding eval/ckpt cadence")
    p.add_argument("--project", default="run/exp", help="run directory (auto-incremented)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--model_parallel", type=int, default=1,
                   help="ranks a margin head's classes are split over (partial-FC); must divide the world")
    p.add_argument("--distill", action="store_true",
                   help="config has student/teacher sections; train with KD")
    p.add_argument("--trace", action="store_true",
                   help="record a torch.profiler trace into <project>/trace")
    p.add_argument("--multihost", action="store_true", help="join torchrun's process group (DDP)")
    p.add_argument("--dist_backend", default=None, choices=("nccl", "gloo"),
                   help="with --multihost: the collectives' backend (default: nccl on cuda, gloo on cpu)")
    p.add_argument("--device", default="cuda", help="cuda (default; cuda:LOCAL_RANK under --multihost) or cpu")
    return p.parse_args(argv)


def main(opt):
    import torch
    import torch.distributed as dist

    from visiondk_tpu_torch.engine.trainer import resolve_device
    from visiondk_tpu_torch.parallel import build_mesh, initialize_distributed
    from visiondk_tpu_torch.utils.logger import SmartLogger

    device = resolve_device(opt.device)  # fail before any run dir is made
    joined = False
    if opt.multihost:
        if device.type == "cuda":
            if device.index is None:
                device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(device)
        joined = initialize_distributed(backend=opt.dist_backend or ("nccl" if device.type == "cuda" else "gloo"),
                                        logger=SmartLogger())
    mesh = build_mesh(model=opt.model_parallel)
    try:
        return _train(opt, device, mesh)
    finally:
        if joined:
            dist.destroy_process_group()


def _train(opt, device, mesh):
    import torch.distributed as dist

    from visiondk_tpu_torch.config import check, increment_path, yaml_load
    from visiondk_tpu_torch.engine.trainer import CenterProcessor

    cfgs = yaml_load(opt.cfgs)
    if opt.distill and not {"student", "teacher"} <= set(cfgs):
        raise ValueError(f"--distill needs a config with student and teacher sections; {opt.cfgs} has {sorted(cfgs)}")
    main_cfg = cfgs["student"] if opt.distill else cfgs
    task = main_cfg["model"]["task"]
    if opt.distill and task != "classification":
        raise ValueError(f"--distill trains a classification student; the student's task is {task!r}")
    check(task, main_cfg)
    if opt.load_from:
        main_cfg["model"]["load_from"] = opt.load_from
    # resume continues in the given run dir; a new run never clobbers one (rank 0 picks it)
    project = Path(opt.project) if opt.resume or not mesh.is_primary() else increment_path(Path(opt.project))
    if mesh.distributed and not opt.resume:
        chosen = [str(project)]
        dist.broadcast_object_list(chosen, src=0)
        project = Path(chosen[0])

    if opt.distill:
        from visiondk_tpu_torch.engine.distill import DistillCenterProcessor

        cp = DistillCenterProcessor(cfgs, project=str(project), train=True, device=device, seed=opt.seed, mesh=mesh)
    else:
        cp = CenterProcessor(cfgs, project=str(project), train=True, device=device, seed=opt.seed, mesh=mesh)

    def run():
        if task == "classification":
            return cp.run_classifier(resume=opt.resume)
        return cp.run_embedding(resume=opt.resume, save_freq=opt.save_freq, print_freq=opt.print_freq)

    if not opt.trace or not mesh.is_primary():
        return run()
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cp.device.type == "cuda" else [])
    with profile(activities=activities) as prof:
        result = run()
    (project / "trace").mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(project / "trace" / "trace.json"))
    return result


if __name__ == "__main__":
    main(parse_opt())
