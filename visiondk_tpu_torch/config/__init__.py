from visiondk_tpu_torch.config.checks import canonical_model_name, normalize_accumulate

__all__ = ["canonical_model_name", "normalize_accumulate"]
