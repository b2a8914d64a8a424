"""Eager cross-field config validation (counterpart of ``visiondk_tpu/config/checks.py``).

``check(task, cfgs)``: one enabled loss, the optimizer and scheduler
vocabulary, warm-up/scheduler consistency, normalization required for
pretrained weights; for classification num_classes against the dataset
(folder, CSV, or a HuggingFace dataset where the ``datasets`` library is
installed) and mixup/OHEM/focal compatibility; for the embedding tasks
(``face``, ``cbir``) the margin head's num_class against the dataset, and
for face a pair file whose pair count is a multiple of 10. Model names are
native zoo names; ``timm-<name>.<tag>`` maps onto them.
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path
from typing import Any, Dict

VALID_OPTIMIZERS = {"sgd", "adam", "sam"}
VALID_SCHEDULERS = {"linear", "cosine", "linear_with_warm", "cosine_with_warm"}
VALID_TASKS = {"classification", "face", "cbir"}


def normalize_accumulate(hyp: Dict[str, Any]) -> int:
    """hyp.accumulate → int ≥ 1 (None or absent → 1); anything else but a
    positive int raises."""
    accum = hyp.get("accumulate", 1)
    accum = 1 if accum is None else accum
    if not isinstance(accum, int) or isinstance(accum, bool) or accum < 1:
        raise ValueError(f"hyp.accumulate must be a positive integer (got {accum!r})")
    return accum


def canonical_model_name(name: str) -> str:
    """Map ``timm-swin_base_patch4_window7_224.ms_in22k_ft_in1k`` → ``swin_base_patch4_window7_224``."""
    if name.startswith("timm-"):
        name = name[len("timm-"):]
    return name.split(".")[0]


def _find_normalize(augment_list):
    for augment in augment_list or []:
        if isinstance(augment, dict) and "normalize" in augment:
            return augment["normalize"]
    return None


def _backbone_entry(model_cfg: Dict[str, Any]):
    """(name, params) for the flat classification schema (model.name) or the
    nested face/cbir schema (model.backbone.{name: params})."""
    if "backbone" in model_cfg:
        name, params = next(iter(model_cfg["backbone"].items()))
        return name, dict(params or {})
    return model_cfg["name"], {
        "pretrained": model_cfg.get("pretrained", False),
        "image_size": model_cfg.get("image_size"),
    }


def check_cfgs_common(cfgs: Dict[str, Any]) -> None:
    hyp, data, model = cfgs["hyp"], cfgs["data"], cfgs["model"]

    n_losses = sum(
        int(v[0]) if isinstance(v, (list, tuple)) else int(v)
        for v in hyp["loss"].values()
    )
    assert n_losses == 1, (
        "Loss configuration error: exactly one loss must be enabled "
        "(set ce: true OR bce: [true, ...] in hyp.loss)"
    )

    opt = hyp["optimizer"][0] if isinstance(hyp["optimizer"], (list, tuple)) else hyp["optimizer"]
    assert opt in VALID_OPTIMIZERS, f"Invalid optimizer {opt!r}; choose from {sorted(VALID_OPTIMIZERS)}"

    normalize_accumulate(hyp)  # raises on non-int/bool/<1

    assert hyp["scheduler"] in VALID_SCHEDULERS, (
        f"Invalid scheduler {hyp['scheduler']!r}; supported: {sorted(VALID_SCHEDULERS)}"
    )
    warm_ep = hyp["warm_ep"]
    assert isinstance(warm_ep, int) and 0 <= warm_ep < hyp["epochs"], (
        f"warm_ep must be a non-negative integer < epochs ({hyp['epochs']})"
    )
    if warm_ep == 0:
        assert hyp["scheduler"] in {"linear", "cosine"}, (
            "warm_ep: 0 requires a scheduler without warmup (linear or cosine)"
        )
    else:
        assert hyp["scheduler"] in {"linear_with_warm", "cosine_with_warm"}, (
            "warm_ep > 0 requires linear_with_warm or cosine_with_warm"
        )

    train_norm = _find_normalize(data["train"]["augment"])
    val_norm = _find_normalize(data["val"]["augment"])

    bname, bparams = _backbone_entry(model)
    if bparams.get("pretrained", False):
        if train_norm is None or val_norm is None:
            raise ValueError(
                "Pretrained models require `normalize` in both train and val augment pipelines"
            )
        if train_norm["mean"] != val_norm["mean"] or train_norm["std"] != val_norm["std"]:
            raise ValueError(
                "Inconsistent normalization: train/val mean and std must be identical"
            )

    assert bparams.get("image_size") is not None, f"image_size must be specified for {bname}"
    assert bparams["image_size"] == model["image_size"], (
        f"Image size mismatch: backbone {bparams['image_size']} vs model {model['image_size']}"
    )


def _count_local_classes(root) -> int:
    return len(
        [x for x in os.listdir(Path(root) / "train") if not (x.startswith(".") or x.startswith("_"))]
    )


def _count_hf_classes(root: str, allow_unverified: bool):
    try:
        from datasets import load_dataset

        ds = load_dataset(root, split="train")
        return len(set(ds["label"]))
    except Exception as e:
        # a num_classes mismatch must fail loudly; a warning would scroll past
        if allow_unverified:
            warnings.warn(
                f"data.allow_unverified_classes: true — skipping num_classes "
                f"verification against HF dataset {root!r} ({e})"
            )
            return None
        raise ValueError(
            f"Cannot verify num_classes against HF dataset {root!r} ({e}). "
            f"The num_classes-vs-dataset check is mandatory; if the hub is "
            f"unreachable (offline), set data.allow_unverified_classes: true "
            f"to skip it explicitly."
        ) from e


def _check_num_classes(
    expected: int, data_root: str, what: str, allow_unverified: bool = False
) -> None:
    if os.path.isdir(data_root):
        n = _count_local_classes(data_root)
    elif str(data_root).endswith(".csv"):
        from visiondk_tpu_torch.data.datasets import read_label_csv

        n = len(read_label_csv(str(data_root))[0])
    else:
        n = _count_hf_classes(data_root, allow_unverified)
    if n is not None:
        assert expected == n, (
            f"{what}: num_classes mismatch — dataset has {n}, config says {expected}"
        )


def check_cfgs_classification(cfgs: Dict[str, Any]) -> None:
    check_cfgs_common(cfgs)
    model, data, hyp = cfgs["model"], cfgs["data"], cfgs["hyp"]

    root = str(data["root"])
    is_csv = root.endswith(".csv")
    if is_csv:
        if hyp["loss"].get("ce"):
            raise ValueError("Multi-label (CSV) tasks require BCE loss: set ce: false")
        if not hyp["loss"]["bce"][0]:
            raise ValueError("Multi-label (CSV) tasks require BCE loss: set bce: [true, ...]")
    else:
        if not hyp["loss"].get("ce"):
            raise ValueError("Single-label tasks require CE loss: set ce: true")
        if hyp["loss"].get("bce") and hyp["loss"]["bce"][0]:
            raise ValueError("Single-label tasks do not support BCE loss: set bce: [false, ...]")

    _check_num_classes(
        model["num_classes"], root, "classification",
        allow_unverified=bool(data.get("allow_unverified_classes", False)),
    )

    strategy = hyp.get("strategy", {})
    if strategy.get("focal", [False])[0]:
        assert hyp["loss"].get("bce"), "Focal loss requires BCE loss"
    if strategy.get("ohem", [False])[0]:
        assert not (hyp["loss"].get("bce") and hyp["loss"]["bce"][0]), (
            "OHEM is not compatible with BCE loss"
        )

    mix = strategy.get("mixup", {"ratio": 0.0, "duration": 0})
    if isinstance(mix, dict):
        mix_ratio, mix_duration = mix["ratio"], mix["duration"]
    else:
        mix_ratio, mix_duration = mix
    assert 0 <= mix_ratio <= 1, "mixup ratio must be in [0, 1]"
    if mix_ratio > 0:
        assert 0 < mix_duration <= hyp["epochs"], (
            f"mixup duration must be in (0, {hyp['epochs']}] when ratio > 0"
        )
    strategy["mixup"] = [mix_ratio, mix_duration]


def _check_embedding_head(cfgs: Dict[str, Any]) -> None:
    model, data = cfgs["model"], cfgs["data"]
    head_key = next(iter(model["head"]))
    expected = model["head"][head_key]["num_class"]
    root = str(data["root"])
    if os.path.isdir(root):
        n = _count_local_classes(root)
        assert expected == n, f"head num_class {expected} != dataset classes {n}"
    else:
        n = _count_hf_classes(
            root, bool(data.get("allow_unverified_classes", False))
        )
        if n is not None:
            assert expected == n, f"head num_class {expected} != dataset classes {n}"


def check_cfgs_face(cfgs: Dict[str, Any]) -> None:
    check_cfgs_common(cfgs)
    _check_embedding_head(cfgs)
    pair_txt = cfgs["data"]["val"].get("pair_txt")
    if not pair_txt or not os.path.isfile(pair_txt):
        raise ValueError(f"Pair text file not found at {pair_txt}")
    with open(pair_txt) as f:
        n_pairs = sum(1 for line in f if line.strip())
    if n_pairs % 10 != 0:
        raise ValueError(
            f"pair_txt must contain a multiple of 10 pairs (10-fold CV); got {n_pairs}"
        )


def check_cfgs_cbir(cfgs: Dict[str, Any]) -> None:
    check_cfgs_common(cfgs)
    _check_embedding_head(cfgs)


def check(task: str, cfgs: Dict[str, Any]) -> None:
    if task == "face":
        check_cfgs_face(cfgs)
    elif task == "cbir":
        check_cfgs_cbir(cfgs)
    elif task == "classification":
        check_cfgs_classification(cfgs)
    else:
        raise ValueError(f"task {task!r} is not supported (choose from {sorted(VALID_TASKS)})")
