"""Counts of the ``swin`` kind: Swin V1, windowed attention with a
relative-position bias, shifted in every second block of a stage whose map
is wider than a window; patch merging between stages; an optional neck and
margin head on the flattened last map."""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

from portbench.counts import linear, window_attention


def blocks(arch: Dict) -> Iterator[Tuple[int, int, int, int, int]]:
    """(side, dim, heads, window, shift) of each Swin block in order."""
    side = arch["img_size"] // arch["patch_size"]
    dim = arch["embed_dim"]
    for s, (depth, heads) in enumerate(zip(arch["depths"], arch["num_heads"])):
        ws = min(arch["window_size"], side)
        for i in range(depth):
            shift = arch["window_size"] // 2 if i % 2 and ws < side else 0
            yield side, dim, heads, ws, shift
        if s < len(arch["depths"]) - 1:
            side, dim = -(-side // 2), dim * 2


def forward_flops(arch: Dict) -> float:
    """Products of one image's forward: patch embedding, blocks, patch
    merging, and the neck and head where the configuration has them."""
    p, img = arch["patch_size"], arch["img_size"]
    patches = (img // p) ** 2
    flops = linear(patches, 3 * p * p, arch["embed_dim"])
    for side, c, heads, ws, _ in blocks(arch):
        n = side * side
        hidden = int(c * arch["mlp_ratio"])
        flops += (linear(n, c, 3 * c) + 4.0 * n * ws * ws * c + linear(n, c, c)
                  + linear(n, c, hidden) + linear(n, hidden, c))
    side, dim = arch["img_size"] // p, arch["embed_dim"]
    for s in range(len(arch["depths"]) - 1):
        side = -(-side // 2)
        flops += linear(side * side, 4 * dim, 2 * dim)
        dim *= 2
    neck = arch.get("neck")
    if neck:
        flops += linear(1, side * side * dim, neck["feat_dim"])
        flops += linear(1, neck["feat_dim"], neck["num_class"])
    return flops


def attention_calls(arch: Dict, b: int, train: bool) -> List[Tuple[float, float]]:
    """One window-attention call a block, at batch ``b``."""
    calls = []
    for hh, dim, heads, ws, shift in blocks(arch):
        calls.append(window_attention(b, hh, hh, heads, dim // heads, ws, shift > 0, train))
    return calls
