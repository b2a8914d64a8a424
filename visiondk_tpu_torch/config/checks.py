"""Config helpers the ported slice needs (counterpart of ``visiondk_tpu/config/checks.py``).

Ported so far: ``canonical_model_name`` and ``normalize_accumulate``. The
ported slices take the sections of a YAML config as dicts, so they need no
YAML parser.
"""

from __future__ import annotations

from typing import Any, Dict


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
