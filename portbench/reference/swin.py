"""Plain float32 Swin-B embedding model with its ArcFace head
(arXiv:2103.14030, arXiv:1801.07698): the model math of the port's
``EmbeddingModel`` over ``swin_base_patch4_window7_224`` frozen here.

- Patch embedding: a 4×4 convolution, then LayerNorm.
- Four stages of pre-norm blocks (LayerNorm eps 1e-5). Each block attends in
  ws×ws windows (ws = min(7, side)); every second block's windows are shifted
  by ws // 2 (a cyclic roll, tokens of different regions kept apart by −100
  on their scores) unless one window covers the map. Each head's scores take
  a relative-position bias from a learned (2ws − 1)² table. An exact-GELU
  MLP follows. Stochastic depth drops a block's branches per sample at rate
  ``drop_path · i / (blocks − 1)``.
- Between stages, 2×2 patch merging: the four neighbours concatenated (x00,
  x10, x01, x11), LayerNorm, a linear map without bias to twice the width.
- A final LayerNorm, then the neck: LayerNorm (eps 1e-6) over the 7×7 token
  map, flattened, a linear map to the 128-d embedding, BatchNorm1d (eps 1e-5;
  the batch's biased moments in training, the running ones in eval).
- ArcFace: cos θ between the unit embedding and the unit class columns,
  cos(θ + m) on the target (cos − m_am past π − m), times s; cross entropy.

The rows part (``rows_forward``: images → the linear neck's output, before
BatchNorm) is row-independent; the batch part (``batch_loss``) is BatchNorm
over the batch, ArcFace and the cross entropy. Parameter names are those of
the port's state dict.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.common import (
    Precision, dense_spec, drop_path, layer_norm, leaf, linear, mlp, norm_spec, normalize_images,
)

BB = "backbone."
MASK = -100.0


def blocks(arch: Dict) -> List[Tuple[int, int, int, int, int, int]]:
    """(stage, block, side, dim, heads, window, shift) of every block."""
    out = []
    side, dim = arch["img_size"] // arch["patch_size"], arch["embed_dim"]
    for s, (depth, heads) in enumerate(zip(arch["depths"], arch["num_heads"])):
        ws = min(arch["window_size"], side)
        for i in range(depth):
            shift = arch["window_size"] // 2 if i % 2 and ws < side else 0
            out.append((s, i, side, dim, heads, ws, shift))
        if s < len(arch["depths"]) - 1:
            side, dim = -(-side // 2), dim * 2
    return out


def final_shape(arch: Dict) -> Tuple[int, int]:
    side, dim = arch["img_size"] // arch["patch_size"], arch["embed_dim"]
    for _ in arch["depths"][1:]:
        side, dim = -(-side // 2), dim * 2
    return side * side, dim


def spec(arch: Dict) -> Dict:
    out: Dict = {}
    c, p = arch["embed_dim"], arch["patch_size"]
    out[f"{BB}patch_embed.proj.weight"] = leaf((c, 3, p, p), "fan_in")
    out[f"{BB}patch_embed.proj.bias"] = leaf((c,), "small")
    norm_spec(out, f"{BB}patch_embed.norm", c)
    n_stages = len(arch["depths"])
    for s, i, side, dim, heads, ws, shift in blocks(arch):
        b = f"{BB}layers.{s}.blocks.{i}"
        norm_spec(out, f"{b}.norm1", dim)
        dense_spec(out, f"{b}.attn.qkv", dim, 3 * dim)
        out[f"{b}.attn.relative_position_bias_table"] = leaf(((2 * ws - 1) ** 2, heads), "small")
        dense_spec(out, f"{b}.attn.proj", dim, dim)
        norm_spec(out, f"{b}.norm2", dim)
        hidden = int(dim * arch["mlp_ratio"])
        dense_spec(out, f"{b}.mlp.fc1", dim, hidden)
        dense_spec(out, f"{b}.mlp.fc2", hidden, dim)
        if i == arch["depths"][s] - 1 and s < n_stages - 1:
            norm_spec(out, f"{BB}layers.{s}.downsample.norm", 4 * dim)
            dense_spec(out, f"{BB}layers.{s}.downsample.reduction", 4 * dim, 2 * dim, bias=False)
    tokens, dim = final_shape(arch)
    norm_spec(out, f"{BB}norm", dim)
    neck = arch["neck"]
    norm_spec(out, "neck.norm", dim)
    dense_spec(out, "neck.proj", tokens * dim, neck["feat_dim"])
    norm_spec(out, "neck.bn_out", neck["feat_dim"])
    out["head.weight"] = leaf((neck["feat_dim"], neck["num_class"]), "unit")
    return out


def buffers_spec(arch: Dict) -> Dict:
    """BatchNorm1d's running statistics, as they start: mean 0, variance 1."""
    f = arch["neck"]["feat_dim"]
    return {"neck.bn_out.running_mean": ((f,), 0.0), "neck.bn_out.running_var": ((f,), 1.0),
            "neck.bn_out.num_batches_tracked": ((), 0)}


def batch_params(arch: Dict):
    """Parameters the batch part reads."""
    return ("neck.bn_out.weight", "neck.bn_out.bias", "head.weight")


def drop_rates(arch: Dict) -> List[float]:
    total = sum(arch["depths"])
    return [arch["drop_path"] * k / max(total - 1, 1) for k in range(total)]


def drop_masks(arch: Dict, rows: int, seed: int, device) -> Optional[list]:
    """The keep masks of each block's two branches for a train step seeded by
    ``seed``: after ``torch.manual_seed(seed)``, one Bernoulli draw of shape
    [rows, 1, 1] on the device for each branch with a rate above 0, in the
    forward's order (a block's attention branch, then its MLP branch)."""
    torch.manual_seed(seed)
    masks = []
    for rate in drop_rates(arch):
        if rate == 0.0:
            masks.append((None, None))
            continue
        keep = 1.0 - rate
        pair = tuple(torch.empty((rows, 1, 1), device=device).bernoulli_(keep).bool() for _ in range(2))
        masks.append(pair)
    return masks


def relative_index(ws: int) -> torch.Tensor:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return torch.from_numpy((rel[..., 0] * (2 * ws - 1) + rel[..., 1]).reshape(-1).astype(np.int64))


def region_mask(side: int, ws: int, shift: int, device) -> torch.Tensor:
    """[nW, N, N] additive mask: −100 between tokens of different shift regions."""
    img = np.zeros((side, side), np.int64)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    ids = torch.from_numpy(img.reshape(side // ws, ws, side // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws))
    apart = ids[:, :, None] != ids[:, None, :]
    return torch.where(apart, MASK, 0.0).to(device)


def window_attention(prec: Precision, y: torch.Tensor, p: Dict, name: str, heads: int, ws: int,
                     shift: int) -> torch.Tensor:
    """y [B, H, W, C] (already rolled) → [B, H, W, C]."""
    b, hh, ww, c = y.shape
    d, n = c // heads, ws * ws
    qkv = linear(prec, y, p, f"{name}.qkv")
    win = qkv.reshape(b, hh // ws, ws, ww // ws, ws, 3 * c).permute(0, 1, 3, 2, 4, 5)
    win = win.reshape(b, -1, n, 3, heads, d).permute(3, 0, 1, 4, 2, 5)  # [3, B, nW, heads, N, d]
    q, k, v = win[0] * d**-0.5, win[1], win[2]
    table = p[f"{name}.relative_position_bias_table"]
    bias = table[relative_index(ws).to(table.device)].reshape(n, n, heads).permute(2, 0, 1)
    scores = prec.matmul(q, k.transpose(-1, -2)) + bias
    if shift:
        scores = scores + region_mask(hh, ws, shift, y.device)[None, :, None]
    out = prec.matmul(torch.softmax(scores, dim=-1), v)  # [B, nW, heads, N, d]
    out = out.permute(0, 1, 3, 2, 4).reshape(b, hh // ws, ww // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return linear(prec, out.reshape(b, hh, ww, c), p, f"{name}.proj")


def merge(prec: Precision, x: torch.Tensor, p: Dict, name: str, side: int) -> torch.Tensor:
    b, _, c = x.shape
    x = x.reshape(b, side, side, c)
    if side % 2:
        x = F.pad(x, (0, 0, 0, 1, 0, 1))
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
    x = layer_norm(x.reshape(b, -1, 4 * c), p, f"{name}.norm", 1e-5)
    return linear(prec, x, p, f"{name}.reduction")


def backbone(p: Dict, images: torch.Tensor, arch: Dict, cfg: Dict, prec: Precision, masks=None) -> torch.Tensor:
    """uint8 NHWC images → the final token map [B, 49, 1024] (after the last LayerNorm)."""
    x = normalize_images(images, cfg["mean"], cfg["std"]).permute(0, 3, 1, 2)
    x = prec.conv(x, p[f"{BB}patch_embed.proj.weight"], p[f"{BB}patch_embed.proj.bias"], arch["patch_size"])
    x = layer_norm(x.flatten(2).transpose(1, 2), p, f"{BB}patch_embed.norm", 1e-5)
    rates = drop_rates(arch)
    n_stages = len(arch["depths"])
    for k, (s, i, side, dim, heads, ws, shift) in enumerate(blocks(arch)):
        name = f"{BB}layers.{s}.blocks.{i}"
        keep = masks[k] if masks is not None else (None, None)
        b = x.shape[0]
        y = layer_norm(x, p, f"{name}.norm1", 1e-5).reshape(b, side, side, dim)
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        y = window_attention(prec, y, p, f"{name}.attn", heads, ws, shift)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + drop_path(y.reshape(b, side * side, dim), keep[0], rates[k])
        x = x + drop_path(mlp(prec, layer_norm(x, p, f"{name}.norm2", 1e-5), p, f"{name}.mlp"), keep[1], rates[k])
        if i == arch["depths"][s] - 1 and s < n_stages - 1:
            x = merge(prec, x, p, f"{BB}layers.{s}.downsample", side)
    return layer_norm(x, p, f"{BB}norm", 1e-5)


def rows_forward(p: Dict, images: torch.Tensor, arch: Dict, cfg: Dict, prec: Precision,
                 masks=None, train: bool = True) -> torch.Tensor:
    """images → the neck's linear output [B, feat_dim], before BatchNorm."""
    tokens = layer_norm(backbone(p, images, arch, cfg, prec, masks), p, "neck.norm", 1e-6)
    return linear(prec, tokens.flatten(1), p, "neck.proj")


def batch_norm(p: Dict, buffers: Dict, z: torch.Tensor, train: bool) -> torch.Tensor:
    if train:
        mean, var = z.mean(dim=0), z.var(dim=0, unbiased=False)
        with torch.no_grad():
            buffers["neck.bn_out.running_mean"].lerp_(mean, 0.1)
            buffers["neck.bn_out.running_var"].lerp_(var, 0.1)
    else:
        mean, var = buffers["neck.bn_out.running_mean"], buffers["neck.bn_out.running_var"]
    return (z - mean) / torch.sqrt(var + 1e-5) * p["neck.bn_out.weight"] + p["neck.bn_out.bias"]


def arcface_logits(w: torch.Tensor, feats: torch.Tensor, labels: torch.Tensor, neck: Dict) -> torch.Tensor:
    m, s = neck["margin_arc"], neck["scale"]
    cos = (F.normalize(feats, dim=1, eps=1e-12) @ F.normalize(w, dim=0, eps=1e-12)).clamp(-1.0, 1.0)
    sin = torch.sqrt((1.0 - cos * cos).clamp(0.0, 1.0))
    target = torch.where(cos > math.cos(math.pi - m), cos * math.cos(m) - sin * math.sin(m),
                         cos - neck["margin_am"])
    onehot = torch.arange(cos.shape[1], device=cos.device) == labels.reshape(-1, 1)
    return torch.where(onehot, target, cos) * s


def batch_loss(p: Dict, buffers: Dict, z: torch.Tensor, labels: torch.Tensor, arch: Dict, cfg: Dict,
               prec: Precision) -> torch.Tensor:
    """BatchNorm over the batch → ArcFace → cross entropy (smoothed by ``label_smooth``), mean."""
    feats = batch_norm(p, buffers, z, train=True)
    logits = arcface_logits(p["head.weight"], feats, labels, arch["neck"])
    s = cfg["hyp"]["label_smooth"]
    q = F.one_hot(labels.long(), logits.shape[1]).float() * (1.0 - s) + s / logits.shape[1]
    return -(q * F.log_softmax(logits, dim=-1)).sum(dim=-1).mean()


def embed(p: Dict, buffers: Dict, images: torch.Tensor, arch: Dict, cfg: Dict, prec: Precision) -> torch.Tensor:
    """Eval-mode embeddings, L2-normalised: x / max(‖x‖, 1e-12)."""
    feats = batch_norm(p, buffers, rows_forward(p, images, arch, cfg, prec, None, train=False), train=False)
    return F.normalize(feats, dim=1, eps=1e-12)
