from visiondk_tpu_torch.config.checks import canonical_model_name, check, normalize_accumulate
from visiondk_tpu_torch.config.loader import get_imgsz, increment_path, yaml_dump, yaml_load

__all__ = [
    "canonical_model_name",
    "check",
    "get_imgsz",
    "increment_path",
    "normalize_accumulate",
    "yaml_dump",
    "yaml_load",
]
