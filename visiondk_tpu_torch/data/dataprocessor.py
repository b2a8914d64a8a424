"""SmartDataProcessor (counterpart of ``visiondk_tpu/data/dataprocessor.py``):
builds the train/val datasets with class-wise augmenters, hot-swaps the
augment pipelines mid-training (warm-up val augments, aug weakening,
progressive resize), and builds the loaders, taking the C++ decode pool
(``data/native.py``) where the pipeline allows it.

As in the JAX package, a training processor lifts the per-pixel random ops
of the train pipeline onto the device (``data.train.device_augment:
"auto"``, the default): ``ops/device_augment.split_device_pipeline`` leaves
the host decode and the geometry to the static size (``train_pipeline_cfg``)
and ``device_augment_cfg`` holds the lifted part, which the trainer compiles
into the device stage. Lifting stays off when ``device_augment`` is false or
"off", or a ``class_aug`` / ``base_aug`` pipeline is set (the device stage
is class-agnostic).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

from visiondk_tpu_torch.data.class_augmenter import ClassWiseAugmenter
from visiondk_tpu_torch.data.datasets import ImageDatasets, smooth_labels
from visiondk_tpu_torch.data.loader import DataLoader
from visiondk_tpu_torch.data.transforms import (
    Compose,
    create_aug_transforms,
    extract_normalization,
    set_pipeline_size,
)
from visiondk_tpu_torch.ops.device_augment import set_device_pipeline_size, split_device_pipeline


class SmartDataProcessor:
    def __init__(
        self,
        data_cfg: Dict[str, Any],
        project: Optional[str] = None,
        rank_is_primary: bool = True,
        training: bool = True,
        task: str = "classification",
    ):
        self.task = task
        self.data_cfg = data_cfg
        self.root = data_cfg["root"]
        self.project = project

        class_aug_cfg = data_cfg["train"].get("class_aug") or None
        base_aug_cfg = data_cfg["train"].get("base_aug") or data_cfg["train"].get("common_aug")

        self.device_augment_cfg: list = []
        full_train_cfg = data_cfg["train"]["augment"]
        dev_mode = data_cfg["train"].get("device_augment", "auto")
        if (
            training
            and dev_mode not in (False, "off", "false")
            and class_aug_cfg is None
            and base_aug_cfg is None
        ):
            host_cfg, device_cfg = split_device_pipeline(full_train_cfg)
            if device_cfg:
                self.device_augment_cfg = device_cfg
                full_train_cfg = host_cfg

        train_aug = create_aug_transforms(full_train_cfg)
        val_aug = create_aug_transforms(data_cfg["val"]["augment"])
        # the host part: restore_train_augment() / progressive resize rebuild
        # from this; the lifted device part lives in device_augment_cfg
        self.train_pipeline_cfg = full_train_cfg
        self.val_pipeline_cfg = data_cfg["val"]["augment"]
        # normalize is a marker: the device step applies it
        self.normalization = extract_normalization(train_aug)

        self.train_dataset = ImageDatasets(
            self.root, "train",
            transforms=ClassWiseAugmenter(train_aug, class_aug_cfg, base_aug_cfg),
            project=project, rank_is_primary=rank_is_primary, training=training,
        ) if training else None
        # Embedding tasks evaluate from pair_txt / query+gallery, not a val
        # class tree (reference vision_engine.py:456: no val dataloader).
        self.val_dataset = ImageDatasets(
            self.root, "val",
            transforms=ClassWiseAugmenter(val_aug, None, None),
            project=project, rank_is_primary=rank_is_primary, training=training,
        ) if task == "classification" else None

    # ------------------------------------------------------ augment control

    def set_augment(self, mode: str, transforms: Optional[Compose]) -> None:
        """Hot-swap the pipeline; ``None`` → use val augments (the reference's
        epoch-0 warmup behaviour, vision_engine.py:346-348)."""
        ds = self.train_dataset if mode == "train" else self.val_dataset
        if transforms is None:
            transforms = create_aug_transforms(self.val_pipeline_cfg)
        ds.transforms = ClassWiseAugmenter(
            transforms,
            self.data_cfg["train"].get("class_aug") if mode == "train" else None,
            None,
        )

    def restore_train_augment(self) -> None:
        self.set_augment("train", create_aug_transforms(self.train_pipeline_cfg))

    def auto_aug_weaken(self, epoch: int, milestone: int) -> None:
        """At the milestone epoch switch train augments to the (weaker) val
        pipeline (reference dataprocessor.py:30-39)."""
        if epoch == milestone:
            self.set_augment("train", None)

    def set_train_size(self, size: int) -> bool:
        """Progressive resolution: rewrite spatial sizes in the live pipeline,
        and the static sizes of lifted device ops (``random_crop``). Returns
        True when the device config changed: the trainer must then rebuild
        its device stage."""
        set_pipeline_size(self.train_dataset.transforms.base_transforms, size)
        return set_device_pipeline_size(self.device_augment_cfg, size)

    def set_label_smoothing(self, num_classes: int, label_smooth: float) -> None:
        """BCE path: dataset emits smoothed multi-hot targets
        (reference vision_engine.py:121-132)."""
        self.train_dataset.label_transforms = lambda l: smooth_labels(
            l, num_classes, label_smooth
        )
        self.val_dataset.label_transforms = lambda l: smooth_labels(l, num_classes, 0.0)

    # ------------------------------------------------------------- loaders

    def _native_val_loader(self, batch_size: int):
        """C++ decode fast path for the val loader: local single-label files,
        deterministic letterbox pipeline, no label transform. Returns None
        when any condition fails (PIL path covers the rest). A multi-label
        dataset (a CSV) never takes it: its adapter emits int labels. (The
        JAX package's guard lets a multi-hot vector through, since a numpy
        array has ``__int__``, and scores it against the image keys.)"""
        ds = self.val_dataset
        if ds is None or ds.multi_label or ds.label_transforms is not None or not len(ds):
            return None
        if ds._hf_dataset is not None or not isinstance(ds.images[0], str):
            return None
        if not all(isinstance(l, (int,)) or hasattr(l, "__int__") for l in ds.labels[:1]):
            return None
        try:
            import numpy as _np

            from visiondk_tpu_torch.data.loader import NativeEvalLoader
            from visiondk_tpu_torch.data.native import native_available
            from visiondk_tpu_torch.data.transforms import is_plain_letterbox

            if not native_available():
                return None
            base = getattr(ds.transforms, "base_transforms", ds.transforms)
            size = is_plain_letterbox(base)
            if size is None:
                return None
            inner = NativeEvalLoader(ds.images, list(ds.labels), size, batch_size)
        except Exception:
            return None

        class _LabeledAdapter:
            # the native eval path is deterministic, full-set and unsharded
            native = True
            shuffle = False
            process_count = 1

            def __len__(self):
                return len(inner)

            def __iter__(self):
                for b in inner:
                    yield {
                        "image": b["image"],
                        "label": _np.asarray(
                            b["keys"]
                            + [b["keys"][-1]] * (batch_size - len(b["keys"])),
                            _np.int32,
                        ),
                        "valid": b["valid"],
                    }

            def set_epoch(self, epoch):
                pass

        return _LabeledAdapter()

    def _native_train_loader(
        self, batch_size, num_workers, seed, process_index, process_count
    ):
        """C++ decode fast path for the TRAIN loader: local file-path dataset
        whose (post-device-split) host pipeline is plain letterbox, a single
        RandomResizedCrop, or the pet.yaml-style random_choice over the two
        — the native pool then owns the whole host stage (NativeTrainLoader
        falls back to the PIL path per-epoch whenever a hot-swap makes the
        live pipeline native-ineligible)."""
        ds = self.train_dataset
        if ds is None or not len(ds):
            return None
        if getattr(ds, "_hf_dataset", None) is not None or not isinstance(
            ds.images[0], str
        ):
            return None
        try:
            from visiondk_tpu_torch.data.loader import NativeTrainLoader
            from visiondk_tpu_torch.data.native import native_available
            from visiondk_tpu_torch.data.transforms import native_train_stage

            if not native_available():
                return None
            base = getattr(ds.transforms, "base_transforms", ds.transforms)
            if getattr(ds.transforms, "class_transforms", None):
                return None
            if native_train_stage(base) is None:
                return None
            return NativeTrainLoader(
                ds, batch_size, seed=seed, num_workers=num_workers or 8,
                process_index=process_index, process_count=process_count,
            )
        except Exception:
            return None

    def dataloader(
        self,
        mode: str,
        batch_size: int,
        num_workers: Optional[int] = None,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
    ) -> DataLoader:
        if num_workers is None:
            num_workers = min(self.data_cfg.get("nw") or 8, (os.cpu_count() or 8))
            num_workers = max(num_workers, 1)
        train = mode == "train"
        if not train:
            native = self._native_val_loader(batch_size)
            if native is not None:
                return native
        if train:
            native = self._native_train_loader(
                batch_size, num_workers, seed, process_index, process_count
            )
            if native is not None:
                if len(native) == 0:
                    raise ValueError(
                        f"train dataloader is empty: {len(self.train_dataset)} "
                        f"samples yield 0 complete batches at "
                        f"data.train.bs={batch_size} (drop_last, "
                        f"{process_count} process(es))."
                    )
                return native
        loader = DataLoader(
            self.train_dataset if train else self.val_dataset,
            batch_size=batch_size,
            shuffle=train,
            drop_last=train,
            num_workers=num_workers,
            seed=seed,
            process_index=process_index,
            process_count=process_count,
        )
        if train and len(loader) == 0:
            # drop_last + a dataset smaller than one global batch would
            # otherwise "train" for zero steps per epoch and still save
            # checkpoints — fail loudly instead.
            raise ValueError(
                f"train dataloader is empty: {len(self.train_dataset)} samples "
                f"yield 0 complete batches at data.train.bs={batch_size} "
                f"(drop_last, {process_count} process(es)). Lower data.train.bs "
                f"or add data."
            )
        return loader
