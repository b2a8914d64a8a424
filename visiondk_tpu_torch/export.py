"""Export a trained model as a saved ``torch.export`` program (counterpart of
the repo's ``export.py``), on the card by default::

    python -m visiondk_tpu_torch.export --cfgs run/exp/config.yaml --weight run/exp/best \
        [--out model.pt2] [--ema] [--batch 1 | -1] [--embed] [--quant int8] [--device cuda|cpu]

The program is ``engine.steps.ServingModel`` traced with the weights as its
constants: uint8 [B, H, W, 3] in, f32 logits (or L2-normalised embeddings:
``--embed``, always for face and CBIR) out. ``--batch -1`` exports a dynamic
batch (``torch.export.Dim`` of 1 to 65535, the attention kernels' grid
bound). The attention cores are the registered operators
``torch.ops.vdk.fused_qkv_attention`` and ``torch.ops.vdk.fused_window_attention``:
one node a block, which launch the kernels on the card and run their plain
versions on the CPU; ``tools.exported_predict`` loads the program with them
and no model code. ``--quant int8`` quantizes the dense layers' weights once
(``ops/quant.py``) and the program holds their int8 codes. The program keeps
the device it was exported on.
"""

from __future__ import annotations

import argparse
import contextlib
from pathlib import Path
from typing import Optional

MAX_BATCH = 65535  # the attention kernels' launch grid (ops.attention.check_grid_rows)


def parse_opt(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cfgs", required=True)
    p.add_argument("--weight", required=True, help="checkpoint dir")
    p.add_argument("--out", default="model.pt2")
    p.add_argument("--ema", action="store_true")
    p.add_argument("--batch", type=int, default=1, help="-1 = dynamic batch (1 to 65535)")
    p.add_argument("--embed", action="store_true",
                   help="export the embedding head (face/cbir) instead of logits")
    p.add_argument("--quant", type=str, default=None, choices=["int8"],
                   help="bake int8 dense inference into the exported program (ops/quant.py)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def export_program(served, cfg, embed: bool, imgsz: int, batch: int = -1, quant: Optional[str] = None):
    """``engine.steps.ServingModel(served, cfg, embed)`` traced by
    ``torch.export`` on ``served``'s device for uint8 [batch, imgsz, imgsz, 3]
    images (``batch`` -1: a dynamic batch of 1 to 65535), with ``served``'s
    weights (and with ``quant="int8"`` their int8 codes, taken once) as its
    constants. Traced under ``torch.no_grad()``, in which the attention
    cores call their registered operators."""
    import torch

    from visiondk_tpu_torch.engine.steps import ServingModel
    from visiondk_tpu_torch.ops.quant import build_weight_cache, check_quant, quantized

    if batch < 1 and batch != -1:
        raise ValueError(f"batch takes a positive size or -1 (dynamic), got {batch}")
    module = ServingModel(served, cfg, embed=embed).eval()
    dynamic = batch == -1
    device = next(served.parameters()).device
    # a dynamic batch is traced at 2: torch.export takes a traced size of 1 for a constant
    example = torch.zeros((2 if dynamic else batch, imgsz, imgsz, 3), dtype=torch.uint8, device=device)
    shapes = ({0: torch.export.Dim("batch", min=1, max=MAX_BATCH)},) if dynamic else None
    quant = quantized(served, build_weight_cache(served)) if check_quant(quant) else contextlib.nullcontext()
    with torch.no_grad(), quant:
        return torch.export.export(module, (example,), dynamic_shapes=shapes, strict=False)


def main(opt):
    import torch

    from visiondk_tpu_torch.config import yaml_load
    from visiondk_tpu_torch.engine.checkpoint import CheckpointManager
    from visiondk_tpu_torch.engine.state import create_train_state
    from visiondk_tpu_torch.engine.trainer import CenterProcessor, build_tx, resolve_device

    resolve_device(opt.device)
    cfgs = yaml_load(opt.cfgs)
    weight = Path(opt.weight)
    cp = CenterProcessor(cfgs, project=str(weight.parent), train=False, device=opt.device)
    tx = build_tx(cfgs["hyp"], steps_per_epoch=1, discrete_per_epoch=True, model_cfg=cfgs["model"])
    state, _ = CheckpointManager(weight.parent).restore(weight.name, create_train_state(cp.model, tx))
    served = state.ema_model if opt.ema else state.model
    use_embed = opt.embed or cfgs["model"]["task"] in ("face", "cbir")
    program = export_program(served, cp.step_config(), use_embed, cp.imgsz, opt.batch, opt.quant)
    torch.export.save(program, opt.out)
    kind = "embeddings" if use_embed else "logits"
    size = Path(opt.out).stat().st_size
    print(f"exported {kind} fn to {opt.out} ({size / 1e6:.1f} MB), input uint8 "
          f"{('batch' if opt.batch == -1 else opt.batch, cp.imgsz, cp.imgsz, 3)}")
    return program


if __name__ == "__main__":
    main(parse_opt())
