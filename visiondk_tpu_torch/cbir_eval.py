"""CBIR evaluation CLI (counterpart of the repo's ``cbir_eval.py``), on the card by default::

    python -m visiondk_tpu_torch.cbir_eval --cfgs run/exp/config.yaml --weight run/exp/best \
        [--ema] [--cutoffs 1 3 5] [--metrics mrr recall ...] [--root <query/gallery root>] \
        [--embedding_cache <path>] [--quant int8] [--device cuda|cpu]

Embeds the query and gallery sets with the checkpoint's model, searches the
gallery (``ops/retrieval.py``: the inner-product top-k of the reference's
faiss Flat index, or with ``--recall_target r`` the approximate top-k of the
JAX package's ``approx_max_k``) and prints MRR/Recall/Precision@k, AUC and
nDCG, one ``name: value`` line each. ``--device`` defaults to ``cuda``;
without a card that raises. ``--quant int8`` embeds with every dense layer
in int8 (``ops/quant.py``), its weights quantized once from the served
model. Where the process runs in a process group of several ranks, the
search shards the gallery over them (every rank gets the same metrics).
"""

from __future__ import annotations

import argparse
from pathlib import Path


def parse_opt(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cfgs", required=True)
    p.add_argument("--weight", required=True, help="checkpoint dir")
    p.add_argument("--ema", action="store_true")
    p.add_argument("--root", default=None, help="override data root")
    p.add_argument("--cutoffs", type=int, nargs="+", default=[1, 3, 5])
    p.add_argument("--metrics", nargs="+", default=["mrr", "recall", "precision", "auc", "ndcg"])
    p.add_argument("--embedding_cache", default=None,
                   help="memmap path for gallery embeddings: loaded when present and "
                        "row-consistent, written after extraction otherwise")
    p.add_argument("--recall_target", type=float, default=None,
                   help="approximate search: the recall target in (0, 1] of approx_max_k's "
                        "reduction (ops/retrieval.py); omit for exact search")
    p.add_argument("--quant", type=str, default=None, choices=["int8"],
                   help="int8 dense inference for embedding extraction (ops/quant.py)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(opt):
    from visiondk_tpu_torch.config import yaml_load
    from visiondk_tpu_torch.data.datasets import CBIRDatasets
    from visiondk_tpu_torch.data.transforms import create_aug_transforms
    from visiondk_tpu_torch.engine import cbir_eval
    from visiondk_tpu_torch.engine.checkpoint import CheckpointManager
    from visiondk_tpu_torch.engine.state import create_train_state
    from visiondk_tpu_torch.engine.steps import make_embed_step
    from visiondk_tpu_torch.engine.trainer import CenterProcessor, build_tx, resolve_device
    from visiondk_tpu_torch.ops.quant import build_weight_cache

    resolve_device(opt.device)
    cfgs = yaml_load(opt.cfgs)
    if opt.root:
        cfgs["data"]["root"] = opt.root
    weight = Path(opt.weight)
    cp = CenterProcessor(cfgs, project=str(weight.parent), train=False, device=opt.device)

    tx = build_tx(cfgs["hyp"], steps_per_epoch=1, discrete_per_epoch=True, model_cfg=cfgs["model"])
    state, _ = CheckpointManager(weight.parent).restore(weight.name, create_train_state(cp.model, tx))

    served = state.ema_model if opt.ema else state.model
    qcache = build_weight_cache(served) if opt.quant == "int8" else None
    embed_step = make_embed_step(served, cp.step_config(), quant=opt.quant, quant_cache=qcache)
    val_aug = create_aug_transforms(cfgs["data"]["val"]["augment"])
    query, gallery = CBIRDatasets.build(cfgs["data"]["root"], transforms=val_aug)
    metrics = cbir_eval.valuate(
        embed_step, query, gallery,
        batch_size=cfgs["data"]["val"]["bs"],
        metrics=opt.metrics,
        cutoffs=opt.cutoffs,
        gallery_cache=opt.embedding_cache,
        recall_target=opt.recall_target,
        device=cp.device,
        mesh=cp.mesh if cp.mesh.world > 1 else None,
    )
    for k, v in metrics.items():
        print(f"{k}: {v}")
    return metrics


if __name__ == "__main__":
    main(parse_opt())
