"""Config helpers the ported slice needs (counterpart of ``visiondk_tpu/config/checks.py``).

Only ``canonical_model_name`` is ported so far: the serving path takes the
``model:`` section of a YAML config as a dict, so it needs no YAML parser.
"""

from __future__ import annotations


def canonical_model_name(name: str) -> str:
    """Map ``timm-swin_base_patch4_window7_224.ms_in22k_ft_in1k`` → ``swin_base_patch4_window7_224``."""
    if name.startswith("timm-"):
        name = name[len("timm-"):]
    return name.split(".")[0]
