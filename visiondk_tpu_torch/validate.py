"""Evaluation CLI (counterpart of the repo's ``validate.py``), on the card by default::

    python -m visiondk_tpu_torch.validate --cfgs run/exp/config.yaml --weight run/exp/best \
        [--ema] [--eval_topk 5] [--thresh 0.5] [--quant int8] [--device cuda|cpu]

Classification: top-1/top-k (or multi-label precision/recall/F1), the
per-class table and, for ≤ 10 classes, a confusion-matrix PNG beside the
checkpoint. Face: the 10-fold pair accuracy ``{'mean', 'std'}``; CBIR: the
retrieval metrics dict. ``--ema`` serves the EMA weights, as the trainer's
validation does. ``--quant int8`` serves every dense layer in int8
(``ops/quant.py``), its weights quantized once from the served model.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def parse_opt(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cfgs", type=str, required=True)
    p.add_argument("--weight", type=str, required=True, help="checkpoint dir (e.g. run/exp/best)")
    p.add_argument("--ema", action="store_true", help="evaluate the EMA weights")
    p.add_argument("--eval_topk", type=int, default=5)
    p.add_argument("--thresh", type=float, default=None, help="multilabel threshold override")
    p.add_argument("--quant", type=str, default=None, choices=["int8"], help="int8 dense inference (ops/quant.py)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(opt):
    from visiondk_tpu_torch.config import yaml_load
    from visiondk_tpu_torch.engine import evaluation as cls_eval
    from visiondk_tpu_torch.engine.checkpoint import CheckpointManager
    from visiondk_tpu_torch.engine.state import create_train_state
    from visiondk_tpu_torch.engine.steps import make_embed_step, make_eval_step
    from visiondk_tpu_torch.engine.trainer import CenterProcessor, build_tx, resolve_device
    from visiondk_tpu_torch.ops.quant import build_weight_cache

    resolve_device(opt.device)
    cfgs = yaml_load(opt.cfgs)
    weight = Path(opt.weight)

    cp = CenterProcessor(cfgs, project=str(weight.parent), train=False, device=opt.device)
    # rebuild the state's shape and restore
    tx = build_tx(cfgs["hyp"], steps_per_epoch=1, discrete_per_epoch=True, model_cfg=cfgs["model"])
    state = create_train_state(cp.model, tx)
    state, meta = CheckpointManager(weight.parent).restore(weight.name, state)
    print(f"loaded {weight} (epoch {meta.get('epoch')}, best_fitness {meta.get('best_fitness')})")

    served = state.ema_model if opt.ema else state.model
    # serving weights are fixed: their int8 codes are taken once, not every batch
    quant = {"quant": opt.quant, "quant_cache": build_weight_cache(served) if opt.quant == "int8" else None}
    if cp.task != "classification":
        metrics = cp._eval_embedding(make_embed_step(served, cp.step_config(), **quant))
        print(metrics)
        return metrics
    eval_step = make_eval_step(served, cp.step_config(), **quant)
    loader = cp.data_processor.dataloader("val", cfgs["data"]["val"]["bs"])
    thresh = opt.thresh if opt.thresh is not None else (cp.thresh if cp.loss_choice == "bce" else None)
    names = cp.data_processor.val_dataset.class_names
    metrics = cls_eval.valuate(
        eval_step, loader, cfgs["model"]["num_classes"],
        thresh=thresh, lossfn=cp.lossfn, class_names=names,
        conm_path=weight.parent / "confusion_matrix.png", eval_topk=opt.eval_topk,
    )
    per_class = metrics.pop("per_class", [])
    print(metrics)
    for row in per_class:
        row = dict(row)
        row["class"] = names[row["class"]] if row["class"] < len(names) else row["class"]
        print(row)
    return metrics


if __name__ == "__main__":
    main(parse_opt())
