from visiondk_tpu_torch.ops.attention import (
    fused_qkv_attention,
    fused_qkv_attention_plain,
    vision_attention,
)

__all__ = ["fused_qkv_attention", "fused_qkv_attention_plain", "vision_attention"]
