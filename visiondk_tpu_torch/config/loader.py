"""YAML config loading and run-directory management (counterpart of
``visiondk_tpu/config/loader.py``).

``yaml_load`` / ``yaml_dump`` read and write a config (the three top-level
sections ``model`` / ``data`` / ``hyp``), ``increment_path`` versions run
directories (``runs/exp`` → ``runs/exp2`` ...) and ``get_imgsz`` takes the
model input size from the last spatial op of an augment pipeline.

PyYAML is imported when a YAML function is called, not at import: without it
those functions raise an ``ImportError`` that names the package.
"""

from __future__ import annotations

import glob
import re
from pathlib import Path
from typing import Any, Dict, Union

# Transforms that change spatial size; their `size` param defines the model input.
_SPATIAL_SIZE_KEYS = (
    "resize_and_padding",
    "random_crop_and_resize",
    "resize",
    "center_crop",
    "random_crop",
)


def _yaml():
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            "visiondk_tpu_torch reads and writes its YAML configs with PyYAML (the `yaml` module), "
            "which is not installed"
        ) from e
    return yaml


def yaml_load(path: Union[str, Path]) -> Dict[str, Any]:
    with open(path, errors="ignore") as f:
        return _yaml().safe_load(f)


def yaml_dump(obj: Dict[str, Any], path: Union[str, Path]) -> None:
    with open(path, "w") as f:
        _yaml().safe_dump(obj, f, sort_keys=False)


def increment_path(path: Union[str, Path], exist_ok: bool = False, sep: str = "") -> Path:
    """runs/exp → runs/exp{sep}2, runs/exp{sep}3, ... (never clobbers an existing run)."""
    path = Path(path)
    if path.exists() and not exist_ok:
        suffix = path.suffix
        path = path.with_suffix("")
        dirs = glob.glob(f"{path}{sep}*")
        matches = [re.search(rf"%s{sep}(\d+)" % re.escape(path.stem), d) for d in dirs]
        idx = [int(m.groups()[0]) for m in matches if m]
        n = max(idx) + 1 if idx else 2
        path = Path(f"{path}{sep}{n}{suffix}")
    return path


def get_imgsz(augment_cfg: list) -> int:
    """Extract the final model input size from an augment pipeline config:
    the last spatial transform's `size` wins."""
    size = None
    for item in augment_cfg:
        if not isinstance(item, dict):
            continue
        for name, params in item.items():
            if name in _SPATIAL_SIZE_KEYS and isinstance(params, dict) and "size" in params:
                size = params["size"]
            elif name == "random_choice" and isinstance(params, dict):
                inner = get_imgsz(params.get("transforms", []))
                if inner is not None:
                    size = inner
    if isinstance(size, (list, tuple)):
        size = max(size)
    return size
