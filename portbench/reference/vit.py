"""Plain float32 ViT classifier (arXiv:2010.11929), the model math of the
port's ``VisionModel`` over ``vit_base_patch16_224`` frozen here: a 16×16
patch convolution, a class token and learned positions, pre-norm blocks
(LayerNorm eps 1e-6, multi-head attention on the packed qkv projection, an
exact-GELU MLP), a final LayerNorm, the class token's features into a linear
head. No dropout or stochastic depth (the configuration has none).

The rows part (``rows_forward``: images → logits) is row-independent; the
batch part (``batch_loss``) is the label-smoothed cross entropy, its mean over
the batch. Parameter names are those of the port's state dict.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from portbench.reference.common import (
    Precision, dense_spec, layer_norm, leaf, linear, mlp, norm_spec, normalize_images,
)

PREFIX = "backbone."


def spec(arch: Dict) -> Dict:
    c, p = arch["embed_dim"], arch["patch_size"]
    n = (arch["img_size"] // p) ** 2 + 1
    out: Dict = {}
    out[f"{PREFIX}cls_token"] = leaf((1, 1, c), "small")
    out[f"{PREFIX}pos_embed"] = leaf((1, n, c), "small")
    out[f"{PREFIX}patch_embed.proj.weight"] = leaf((c, 3, p, p), "fan_in")
    out[f"{PREFIX}patch_embed.proj.bias"] = leaf((c,), "small")
    hidden = int(c * arch["mlp_ratio"])
    for i in range(arch["depth"]):
        b = f"{PREFIX}blocks.{i}"
        norm_spec(out, f"{b}.norm1", c)
        dense_spec(out, f"{b}.attn.qkv", c, 3 * c)
        dense_spec(out, f"{b}.attn.proj", c, c)
        norm_spec(out, f"{b}.norm2", c)
        dense_spec(out, f"{b}.mlp.fc1", c, hidden)
        dense_spec(out, f"{b}.mlp.fc2", hidden, c)
    norm_spec(out, f"{PREFIX}norm", c)
    dense_spec(out, f"{PREFIX}head", c, arch["num_classes"])
    return out


def buffers_spec(arch: Dict) -> Dict:
    return {}


def batch_params(arch: Dict):
    """Parameters the batch part reads (none: the head is row-wise)."""
    return ()


def drop_masks(arch: Dict, rows: int, seed: int, device) -> Optional[list]:
    return None


def attention(prec: Precision, x: torch.Tensor, p: Dict, name: str, heads: int) -> torch.Tensor:
    b, n, c = x.shape
    d = c // heads
    qkv = linear(prec, x, p, f"{name}.qkv").reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] * d**-0.5, qkv[1], qkv[2]
    probs = torch.softmax(prec.matmul(q, k.transpose(-1, -2)), dim=-1)
    out = prec.matmul(probs, v).transpose(1, 2).reshape(b, n, c)
    return linear(prec, out, p, f"{name}.proj")


def rows_forward(p: Dict, images: torch.Tensor, arch: Dict, cfg: Dict, prec: Precision,
                 masks=None, train: bool = True) -> torch.Tensor:
    """uint8 NHWC images → f32 logits [B, num_classes]."""
    x = normalize_images(images, cfg["mean"], cfg["std"]).permute(0, 3, 1, 2)
    t = prec.conv(x, p[f"{PREFIX}patch_embed.proj.weight"], p[f"{PREFIX}patch_embed.proj.bias"],
                  arch["patch_size"])
    t = t.flatten(2).transpose(1, 2)
    t = torch.cat([p[f"{PREFIX}cls_token"].expand(t.shape[0], -1, -1), t], dim=1) + p[f"{PREFIX}pos_embed"]
    for i in range(arch["depth"]):
        b = f"{PREFIX}blocks.{i}"
        t = t + attention(prec, layer_norm(t, p, f"{b}.norm1", 1e-6), p, f"{b}.attn", arch["num_heads"])
        t = t + mlp(prec, layer_norm(t, p, f"{b}.norm2", 1e-6), p, f"{b}.mlp")
    t = layer_norm(t, p, f"{PREFIX}norm", 1e-6)
    return linear(prec, t[:, 0], p, f"{PREFIX}head")


def batch_loss(p: Dict, buffers: Dict, z: torch.Tensor, labels: torch.Tensor, arch: Dict, cfg: Dict,
               prec: Precision) -> torch.Tensor:
    """Cross entropy of the logits with the labels smoothed by ``label_smooth``."""
    s = cfg["hyp"]["label_smooth"]
    q = F.one_hot(labels.long(), z.shape[1]).float() * (1.0 - s) + s / z.shape[1]
    return -(q * F.log_softmax(z, dim=-1)).sum(dim=-1).mean()
