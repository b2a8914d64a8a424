"""Frame-sampled video classification with the prediction drawn on each frame
(counterpart of the repo's ``tools/video_predict.py``), on the card by default::

    python -m visiondk_tpu_torch.tools.video_predict --video clip.mp4 --cfgs run/exp/config.yaml \
        --weight run/exp/best [--ema] [--sample 0.5] [--fps 25] [--seed 0] [--output] \
        [--quant int8] [--device cuda|cpu]

Each frame is kept when ``random.Random(seed)``'s next draw is at most
``--sample``; a kept frame goes through the val transforms and the eval step,
and its three most probable classes are written on it. ``--output`` writes
``<video>_new.mp4`` (the kept frames only) instead of displaying them. Video
is read and written with OpenCV (``cv2``), which must be installed: without
it the tool raises ``ImportError``.
"""

from __future__ import annotations

import argparse
import os
import random


def parse_opt(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--video", required=True, type=str)
    p.add_argument("--cfgs", required=True, type=str)
    p.add_argument("--weight", required=True, type=str)
    p.add_argument("--ema", action="store_true")
    p.add_argument("--output", action="store_true", help="write annotated mp4")
    p.add_argument("--sample", default=0.5, type=float, help="frame retain ratio")
    p.add_argument("--fps", default=25, type=int)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quant", type=str, default=None, choices=["int8"],
                   help="int8 dense inference (ops/quant.py)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def sampled_frames(cap, sample: float, seed: int):
    """The frames of an open ``cv2.VideoCapture`` that ``random.Random(seed)``
    keeps: one draw a frame, kept when it is at most ``sample``."""
    rng = random.Random(seed)
    success, frame = cap.read()
    while success:
        if rng.random() <= sample:
            yield frame
        success, frame = cap.read()


def frame_top3(frames, eval_step, transforms, names):
    """Each RGB uint8 frame's three most probable classes, [(name,
    probability)] by the softmax of ``eval_step``'s logits on the frame
    after ``transforms``."""
    import numpy as np
    import torch
    from PIL import Image

    tops = []
    for frame in frames:
        x = np.array(transforms(Image.fromarray(frame)))[None]
        logits = eval_step({"image": torch.from_numpy(x)})[0].cpu().numpy()
        e = np.exp(logits - logits.max())
        probs = e / e.sum()
        tops.append([(names[j] if j < len(names) else str(j), float(probs[j])) for j in np.argsort(-probs)[:3]])
    return tops


def main(opt):
    try:
        import cv2
    except ImportError as e:
        raise ImportError("video_predict reads and writes video with OpenCV (the cv2 module), which is not "
                          "installed here") from e
    from pathlib import Path

    from visiondk_tpu_torch.config import yaml_load
    from visiondk_tpu_torch.data.transforms import create_aug_transforms
    from visiondk_tpu_torch.engine.checkpoint import CheckpointManager
    from visiondk_tpu_torch.engine.state import create_train_state
    from visiondk_tpu_torch.engine.steps import make_eval_step
    from visiondk_tpu_torch.engine.trainer import CenterProcessor, build_tx, resolve_device
    from visiondk_tpu_torch.ops.quant import build_weight_cache

    resolve_device(opt.device)
    cfgs = yaml_load(opt.cfgs)
    weight = Path(opt.weight)
    cp = CenterProcessor(cfgs, project=str(weight.parent), train=False, device=opt.device)
    tx = build_tx(cfgs["hyp"], steps_per_epoch=1, discrete_per_epoch=True, model_cfg=cfgs["model"])
    state, _ = CheckpointManager(weight.parent).restore(weight.name, create_train_state(cp.model, tx))
    served = state.ema_model if opt.ema else state.model
    qcache = build_weight_cache(served) if opt.quant == "int8" else None
    eval_step = make_eval_step(served, cp.step_config(), quant=opt.quant, quant_cache=qcache)
    transforms = create_aug_transforms(cfgs["data"]["val"]["augment"])
    names = cp.data_processor.val_dataset.class_names

    cap = cv2.VideoCapture(opt.video)
    writer = None
    if opt.output:
        filename = f"{os.path.splitext(opt.video)[0]}_new.mp4"
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        writer = cv2.VideoWriter(filename, cv2.VideoWriter_fourcc(*"mp4v"), opt.fps, (w, h))
    tops = []
    try:
        for frame in sampled_frames(cap, opt.sample, opt.seed):
            (top,) = frame_top3([cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)], eval_step, transforms, names)
            tops.append(top)
            y = 50
            for name, p in top:
                cv2.putText(frame, f"{p:.2f} {name}", (5, y), cv2.FONT_HERSHEY_SIMPLEX, 0.75, (0, 0, 255), 2)
                y += 28
            if writer is not None:
                writer.write(frame)
            else:
                cv2.imshow("windows", frame)
                cv2.waitKey(int(1000 / opt.fps))
    finally:
        cap.release()
        if writer is not None:
            writer.release()
    if writer is not None:
        print(f"annotated video saved next to {opt.video}")
    return tops


if __name__ == "__main__":
    main(parse_opt())
