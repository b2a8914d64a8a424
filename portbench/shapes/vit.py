"""Counts of the ``vit`` kind: a ViT with a class token (N = patches + 1)
and a linear head on it, global attention in every block."""

from __future__ import annotations

from typing import Dict, List, Tuple

from portbench.counts import linear, qkv_attention


def forward_flops(arch: Dict) -> float:
    """Products of one image's forward: patch embedding, blocks, head."""
    p, img = arch["patch_size"], arch["img_size"]
    patches = (img // p) ** 2
    flops = linear(patches, 3 * p * p, arch["embed_dim"])
    c, n = arch["embed_dim"], patches + 1
    hidden = int(c * arch["mlp_ratio"])
    per_block = (linear(n, c, 3 * c) + 4.0 * n * n * c + linear(n, c, c)
                 + linear(n, c, hidden) + linear(n, hidden, c))
    flops += arch["depth"] * per_block
    flops += linear(1, c, arch["num_classes"])
    return flops


def attention_calls(arch: Dict, b: int, train: bool) -> List[Tuple[float, float]]:
    """One global attention call a block, at batch ``b``."""
    n = (arch["img_size"] // arch["patch_size"]) ** 2 + 1
    d = arch["embed_dim"] // arch["num_heads"]
    return [qkv_attention(b, n, arch["num_heads"], d, train)] * arch["depth"]
