"""Train CLI (counterpart of the repo's ``main.py``), on the card by default::

    python -m visiondk_tpu_torch.main --cfgs configs/classification/pet_synth.yaml \
        [--project run/exp] [--resume [last]] [--load_from run/exp/best] [--seed 0] \
        [--device cuda|cpu] [--trace] [--distill]

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
``torch.profiler`` trace of the run into ``<project>/trace``. ``--multihost``
and ``--model_parallel > 1`` raise ``NotImplementedError``: distributed
training is not ported yet.
"""

from __future__ import annotations

import argparse
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
                   help="model-parallel size for partial-FC head sharding (not ported)")
    p.add_argument("--distill", action="store_true",
                   help="config has student/teacher sections; train with KD")
    p.add_argument("--trace", action="store_true",
                   help="record a torch.profiler trace into <project>/trace")
    p.add_argument("--multihost", action="store_true", help="multi-host training (not ported)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(opt):
    from visiondk_tpu_torch.config import check, increment_path, yaml_load
    from visiondk_tpu_torch.engine.trainer import CenterProcessor, resolve_device

    for flag, on in (("--multihost", opt.multihost), ("--model_parallel > 1", opt.model_parallel > 1)):
        if on:
            raise NotImplementedError(f"{flag}: distributed training is not ported yet")
    resolve_device(opt.device)  # fail before any run dir is made

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
    # resume continues in the given run dir; a new run never clobbers one
    project = Path(opt.project) if opt.resume else increment_path(Path(opt.project))

    if opt.distill:
        from visiondk_tpu_torch.engine.distill import DistillCenterProcessor

        cp = DistillCenterProcessor(cfgs, project=str(project), train=True, device=opt.device, seed=opt.seed)
    else:
        cp = CenterProcessor(cfgs, project=str(project), train=True, device=opt.device, seed=opt.seed)

    def run():
        if task == "classification":
            return cp.run_classifier(resume=opt.resume)
        return cp.run_embedding(resume=opt.resume, save_freq=opt.save_freq, print_freq=opt.print_freq)

    if not opt.trace:
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
