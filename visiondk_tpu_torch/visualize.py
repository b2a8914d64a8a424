"""Prediction, CAM and retrieval visualization CLI (counterpart of the repo's
``visualize.py``), on the card by default.

Classification::

    python -m visiondk_tpu_torch.visualize --cfgs run/exp/config.yaml --weight run/exp/best \
        --data data/pets/val [--ema] [--cam [--cam_method gradcam]] \
        [--badcase --target_class cat] [--remove_label] [--sampling 50] [--device cuda|cpu]

writes each image annotated with its top-5 classes (beside its CAM overlay
with ``--cam``), ``labels/<stem>.txt`` with ``--badcase`` or
``--remove_label``, and the misses of ``--target_class`` under ``bad_case/``.

CBIR and face::

    python -m visiondk_tpu_torch.visualize --cfgs run/exp/config.yaml --weight run/exp/best \
        [--max_rank 10] [--root <query/gallery root>] [--device cuda|cpu]

writes one query / ground-truth / top-k grid per query. Output goes to
``--show_path/--name`` (a new numbered directory where it exists).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path


def parse_opt(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cfgs", required=True, help="config yaml (run dir copy)")
    p.add_argument("--weight", required=True, help="checkpoint dir (e.g. run/exp/best)")

    # classification
    p.add_argument("--data", default=None, help="target data directory")
    p.add_argument("--target_class", type=str, default=None, help="class to check")
    p.add_argument("--remove_label", action="store_true", help="no top-left text")
    p.add_argument("--no_save_image", action="store_true")
    p.add_argument("--cam", action="store_true", help="CAM overlay")
    p.add_argument("--cam_method", default="gradcam",
                   help="gradcam|gradcampp|xgradcam|layercam|hirescam|eigencam|"
                        "eigengradcam|ablationcam|scorecam|fullgrad")
    p.add_argument("--ema", action="store_true", help="use EMA weights")
    p.add_argument("--class_json", default=None, help="class_indices.json path (defaults to run dir)")
    p.add_argument("--badcase", action="store_true", help="organize badcases")
    p.add_argument("--sampling", default=None, type=int)

    # CBIR
    p.add_argument("--max_rank", default=10, type=int, help="top-k retrieval grid")
    p.add_argument("--root", default=None, help="override cbir data root")

    p.add_argument("--show_path", default="visualization")
    p.add_argument("--name", default="exp")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(opt):
    import numpy as np
    import torch

    from visiondk_tpu_torch.config import increment_path, yaml_load
    from visiondk_tpu_torch.data.datasets import PredictImageDatasets, read_image
    from visiondk_tpu_torch.data.transforms import create_aug_transforms
    from visiondk_tpu_torch.engine.checkpoint import CheckpointManager
    from visiondk_tpu_torch.engine.state import create_train_state
    from visiondk_tpu_torch.engine.steps import device_preprocess, make_embed_step, make_eval_step
    from visiondk_tpu_torch.engine.trainer import CenterProcessor, build_tx, resolve_device
    from visiondk_tpu_torch.engine.visualizer import Visualizer
    from visiondk_tpu_torch.utils.plots import colorstr

    resolve_device(opt.device)
    visual_dir = increment_path(Path(opt.show_path) / opt.name)
    cfgs = yaml_load(opt.cfgs)
    task = cfgs["model"]["task"]
    weight = Path(opt.weight)

    cp = CenterProcessor(cfgs, project=str(weight.parent), train=False, device=opt.device)
    tx = build_tx(cfgs["hyp"], steps_per_epoch=1, discrete_per_epoch=True, model_cfg=cfgs["model"])
    state, _ = CheckpointManager(weight.parent).restore(weight.name, create_train_state(cp.model, tx))
    served = state.ema_model if opt.ema else state.model
    step_cfg = cp.step_config()
    val_aug = create_aug_transforms(cfgs["data"]["val"]["augment"])

    if task == "classification":
        if opt.badcase and opt.remove_label:
            raise ValueError("remove_label and badcase are mutually exclusive.")
        if opt.badcase and opt.target_class is None:
            raise ValueError("badcase needs --target_class for ground truth.")
        if opt.data is None:
            raise ValueError("--data is required for classification visualization")

        class_json = Path(opt.class_json or (weight.parent / "class_indices.json"))
        if class_json.is_file():
            with open(class_json, encoding="utf-8") as f:
                class_dict = {int(k): v for k, v in json.load(f).items()}
        else:
            class_dict = dict(enumerate(cp.data_processor.val_dataset.class_names))

        eval_step = make_eval_step(served, step_cfg)

        def forward(x):
            return eval_step({"image": torch.from_numpy(x)}).cpu().numpy()

        raw_ds = PredictImageDatasets(opt.data, transforms=None, sampling=opt.sampling,
                                      target_class=opt.target_class)

        class _TripletDataset:
            """(raw PIL image, transformed array, path)."""

            def __len__(self):
                return len(raw_ds)

            def __getitem__(self, i):
                path = raw_ds.images[i]
                img = read_image(path)
                return img, np.array(val_aug(img)), path

        cam = None
        if opt.cam:
            from visiondk_tpu_torch.utils.cam import ClassActivationMaper

            maper = ClassActivationMaper(served, method=opt.cam_method,
                                         example=np.zeros((1, cp.imgsz, cp.imgsz, 3), np.float32),
                                         backbone_name=cfgs["model"].get("name", ""))

            def cam(image, input_tensor):
                norm = device_preprocess(torch.from_numpy(input_tensor), step_cfg.mean, step_cfg.std)
                return maper(image=image, input_tensor=norm.numpy())

        t0 = time.time()
        Visualizer.predict_images(
            forward,
            _TripletDataset(),
            visual_dir,
            class_dict,
            cp.logger,
            thresh=cp.thresh,
            remove_label=opt.remove_label,
            save_image=not opt.no_save_image,
            badcase=opt.badcase,
            cam=cam,
            target_class=opt.target_class,
        )
        cp.logger.console(
            f"\nPredicting complete ({(time.time() - t0) / 60:.3f} minutes)"
            f"\nResults saved to {colorstr('bold', str(visual_dir))}"
        )
    elif task in ("face", "cbir"):
        from visiondk_tpu_torch.data.datasets import CBIRDatasets
        from visiondk_tpu_torch.engine import cbir_eval

        if opt.root is not None:
            cfgs["data"]["root"] = opt.root
        embed_step = make_embed_step(served, step_cfg)
        query, gallery = CBIRDatasets.build(cfgs["data"]["root"], transforms=val_aug)
        out = cbir_eval.valuate(embed_step, query, gallery, batch_size=cfgs["data"]["val"]["bs"],
                                cutoffs=[opt.max_rank], vis=True, device=cp.device)
        raw = out.pop("_raw")
        print(out)
        for qi, qpath in enumerate(raw["query_images"]):
            Visualizer.visualize_results(
                str(qpath),
                raw["preds"][qi],
                list(np.asarray(raw["scores"])[qi]),
                raw["labels"][qi],
                visual_dir,
                max_rank=opt.max_rank,
            )
        print(f"retrieval grids saved to {visual_dir}")
    else:
        raise ValueError(f"Unknown task {task}")
    return visual_dir


if __name__ == "__main__":
    main(parse_opt())
