"""The port's operators. Importing this package registers the kernels'
``torch.library`` operators (``torch.ops.vdk.fused_qkv_attention``,
``torch.ops.vdk.fused_window_attention``), which a saved ``torch.export``
program needs before it loads."""

from visiondk_tpu_torch.ops.attention import (
    fused_qkv_attention,
    fused_qkv_attention_plain,
    vision_attention,
)
from visiondk_tpu_torch.ops.window_attention import fused_window_attention, fused_window_attention_plain

__all__ = ["fused_qkv_attention", "fused_qkv_attention_plain", "fused_window_attention",
           "fused_window_attention_plain", "vision_attention"]
