"""One-image inference (counterpart of the repo's ``tools/single_predict.py``),
on the card by default::

    python -m visiondk_tpu_torch.tools.single_predict --img x.jpg --cfgs run/exp/config.yaml \
        --weight run/exp/best [--ema] [--quant int8] [--device cuda|cpu]

Prints the five most probable classes, one ``<class> <probability>`` line
each: softmax for a CE model, sigmoid for a BCE one.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def parse_opt(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--img", required=True, type=str)
    p.add_argument("--cfgs", required=True, type=str, help="run config yaml")
    p.add_argument("--weight", required=True, type=str, help="checkpoint dir")
    p.add_argument("--ema", action="store_true")
    p.add_argument("--quant", type=str, default=None, choices=["int8"],
                   help="int8 dense inference (ops/quant.py)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(opt):
    import numpy as np
    import torch

    from visiondk_tpu_torch.config import yaml_load
    from visiondk_tpu_torch.data.datasets import read_image
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

    transforms = create_aug_transforms(cfgs["data"]["val"]["augment"])
    x = np.array(transforms(read_image(opt.img)))[None]
    qcache = build_weight_cache(served) if opt.quant == "int8" else None
    eval_step = make_eval_step(served, cp.step_config(), quant=opt.quant, quant_cache=qcache)
    logits = eval_step({"image": torch.from_numpy(x)})[0].cpu().numpy().astype(np.float64)
    if cp.loss_choice == "bce":
        probs = 1.0 / (1.0 + np.exp(-logits))
    else:
        e = np.exp(logits - logits.max())
        probs = e / e.sum()

    names = cp.data_processor.val_dataset.class_names
    top = []
    for j in np.argsort(-probs)[:5]:
        name = names[j] if j < len(names) else str(j)
        print(f"{name:<20} {probs[j]:.4f}")
        top.append((name, float(probs[j])))
    return top


if __name__ == "__main__":
    main(parse_opt())
