"""JAX parameter tree → port state dict (the weight bridge).

The reverse of ``visiondk_tpu/models/convert.py::convert_vit``. The source is
the JAX package's variables as flat numpy trees, ``{"params": {path: arr},
"batch_stats": {path: arr}}`` with "/"-joined flax paths, which is the
format ``save_converted`` writes as ``{tree}::{path}`` npz keys. The mapping
follows the port module that owns each tensor:

- ``nn.Linear`` weight ← ``kernel`` [in, out] transposed to [out, in];
- ``nn.Conv2d`` weight ← ``kernel`` HWIO permuted to OIHW, or, for a 1×1
  conv on a pooled map (SE's ``conv_reduce``/``conv_expand``, MobileNetV3's
  ``conv_head``), the Dense ``kernel`` [in, out] as [out, in, 1, 1];
- LayerNorm / BatchNorm weight ← ``scale``; BatchNorm running_mean/var ←
  ``batch_stats`` ``mean``/``var``;
- LayerScale gamma ← the flax param named after the module (``block{i}/ls1``);
- a margin head's weight [feat_dim, num_class] ← ``head/weight``'s first
  ``num_class`` columns (the JAX head pads its class dim to a multiple of
  128; the port holds no pad columns);
- any other parameter (``cls_token``, ``pos_embed``) ← the same name;
- module paths, per family: ViT's torch ``blocks.{i}`` ↔ flax ``block{i}``;
  under a ``SwinTransformer``, ``layers.{s}.blocks.{b}`` ↔ ``stage{s}_block{b}``,
  ``layers.{s}.downsample`` ↔ ``merge{s}``, ``patch_embed.proj`` ↔
  ``patch_embed`` (the flax Conv) and ``patch_embed.norm`` ↔ ``patch_norm``;
  under a ``ResNet`` (timm names), ``layer{s}.{b}`` ↔ ``stage{s}_block{b+1}``
  (JAX counts blocks from 1), the stem's ``conv1``/``bn1`` ↔
  ``stem_conv``/``stem_bn`` (the deep stem's ``conv1.{0,1,3,4,6}`` and
  ``bn1`` ↔ ``stem_conv1``, ``stem_bn1``, ``stem_conv2``, ``stem_bn2``,
  ``stem_conv3``, ``stem_bn3``), a block's ``downsample`` conv and BN ↔
  ``down_conv``/``down_bn`` (with avg-down, ``downsample.0`` is the pool),
  and every other name (``se.fc1``, the split-attention ``conv``, ``bn0``,
  ``fc1``, ``bn1``, ``fc2``, ``fc``) unchanged; a ``SwinTransformerV2``
  takes Swin V1's rules, its ``attn.cpb_mlp.{0,2}`` ↔ ``attn/cpb_fc{1,2}``
  (``logit_scale`` keeps its name); under a ``ConvNeXt``, ``stem.{0,1}`` ↔
  ``stem_conv``/``stem_norm``, ``stages.{s}.downsample.{0,1}`` ↔
  ``downsample_norm{s}``/``downsample_conv{s}``, ``stages.{s}.blocks.{b}`` ↔
  ``stage{s}_block{b}`` with ``conv_dw``, ``mlp.fc1``, ``mlp.fc2`` ↔
  ``dwconv``, ``pwconv1``, ``pwconv2`` (``gamma`` is the block's own param),
  ``head.norm``/``head.fc`` ↔ ``head_norm``/``head``; under a
  ``MobileNetV3`` or ``EfficientNetV2``, ``conv_stem``/``bn1`` ↔
  ``stem``/``stem_bn``, block ``blocks.{s}.{b}`` ↔ ``stage{i}_block1``
  numbered flat across timm's groups (MobileNetV3; its trailing
  ``ConvBnAct`` ↔ ``head_conv``/``head_bn``) or ``stage{s+1}_block{b+1}``
  (EfficientNetV2), its timm leaves renamed by block type (``conv_pw``,
  ``conv_dw``, ``conv_pwl``, ``conv_exp``, ``conv``, ``bn1..3`` ↔
  ``expand``, ``dw``, ``project``, ``bn_expand``, ``bn_dw``,
  ``bn_project``; ``se.conv_reduce``/``se.conv_expand`` ↔ ``se/fc1``/
  ``se/fc2``), ``conv_head`` ↔ ``pre_head`` (MobileNetV3) or ``head_conv``
  with ``bn2`` ↔ ``head_bn`` (EfficientNetV2), ``classifier`` ↔ ``fc``;
  ``backbone.``/``neck.`` ↔ ``backbone/``/``neck/``; ViT's SigLIP pool
  ``attn_pool.{latent,q,kv,proj,norm,mlp.fc1,mlp.fc2}`` ↔
  ``attn_pool/...`` (timm's names, which the JAX ``convert_vit`` reads), and
  a ``VisionModel``'s attention pool and classifier ``pool.{probe,norm,q,k,v,
  proj}``, ``fc`` ↔ ``pool/...``, ``fc`` (flax's top-level keys, which the
  freeze mask and the layer-wise labels read) by the default rule.

The bridge is strict both ways: a port tensor with no source, a source tensor
nothing maps, or a shape that differs raises (a partial import would load
"successfully" and compute garbage). BatchNorm's ``num_batches_tracked`` has
no JAX counterpart and keeps the model's value. Needs numpy and torch only.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from visiondk_tpu_torch.models.backbones.convnext import ConvNeXt
from visiondk_tpu_torch.models.backbones.efficientnet import EdgeResidual, EfficientNetV2
from visiondk_tpu_torch.models.backbones.mobilenet import (
    ConvBnAct, DepthwiseSeparableConv, InvertedResidual, MobileNetV3,
)
from visiondk_tpu_torch.models.backbones.resnet import ResNet
from visiondk_tpu_torch.models.backbones.swin import SwinTransformer
from visiondk_tpu_torch.models.backbones.swinv2 import SwinTransformerV2
from visiondk_tpu_torch.models.heads import MarginHead
from visiondk_tpu_torch.models.layers import LayerScale

Tree = Dict[str, Dict[str, np.ndarray]]

_BLOCK = re.compile(r"(^|\.)blocks\.(\d+)(?=\.|$)")
_SWIN_RULES = (
    (re.compile(r"^layers\.(\d+)\.blocks\.(\d+)(?=\.|$)"), r"stage\1_block\2"),
    (re.compile(r"^layers\.(\d+)\.downsample(?=\.|$)"), r"merge\1"),
    (re.compile(r"^patch_embed\.proj$"), "patch_embed"),
    (re.compile(r"^patch_embed\.norm$"), "patch_norm"),
)
_RESNET_STEM = {"conv1": "stem_conv", "bn1": "stem_bn"}
_RESNET_DEEP_STEM = {"conv1.0": "stem_conv1", "conv1.1": "stem_bn1", "conv1.3": "stem_conv2",
                     "conv1.4": "stem_bn2", "conv1.6": "stem_conv3", "bn1": "stem_bn3"}
_RESNET_BLOCK = re.compile(r"^layer(\d+)\.(\d+)(?=\.|$)")
_RESNET_DOWN = re.compile(r"\.downsample\.\d+$")


def _swin_path(root: nn.Module, rel: str) -> str:
    for pattern, repl in _SWIN_RULES:
        rel = pattern.sub(repl, rel)
    return rel


_SWINV2_CPB = {".attn.cpb_mlp.0": ".attn.cpb_fc1", ".attn.cpb_mlp.2": ".attn.cpb_fc2"}


def _swinv2_path(root: nn.Module, rel: str) -> str:
    rel = _swin_path(root, rel)
    for suffix, flax_suffix in _SWINV2_CPB.items():
        if rel.endswith(suffix):
            return rel[:-len(suffix)] + flax_suffix
    return rel


def _resnet_path(root: nn.Module, rel: str) -> str:
    stem = _RESNET_DEEP_STEM if root.deep_stem else _RESNET_STEM
    if rel in stem:
        return stem[rel]
    down = _RESNET_DOWN.search(rel)
    if down:  # named by what it holds: timm's index moves with the avg-down pool
        sub = root.get_submodule(rel)
        if isinstance(sub, nn.Conv2d):
            rel = rel[:down.start()] + ".down_conv"
        elif isinstance(sub, nn.modules.batchnorm._BatchNorm):
            rel = rel[:down.start()] + ".down_bn"
    return _RESNET_BLOCK.sub(lambda m: f"stage{m[1]}_block{int(m[2]) + 1}", rel)


_CONVNEXT_RULES = (
    (re.compile(r"^stem\.0$"), "stem_conv"),
    (re.compile(r"^stem\.1$"), "stem_norm"),
    (re.compile(r"^stages\.(\d+)\.downsample\.0$"), r"downsample_norm\1"),
    (re.compile(r"^stages\.(\d+)\.downsample\.1$"), r"downsample_conv\1"),
    (re.compile(r"^stages\.(\d+)\.blocks\.(\d+)(?=\.|$)"), r"stage\1_block\2"),
    (re.compile(r"\.conv_dw$"), ".dwconv"),
    (re.compile(r"\.mlp\.fc1$"), ".pwconv1"),
    (re.compile(r"\.mlp\.fc2$"), ".pwconv2"),
    (re.compile(r"^head\.norm$"), "head_norm"),
    (re.compile(r"^head\.fc$"), "head"),
)


def _convnext_path(root: nn.Module, rel: str) -> str:
    for pattern, repl in _CONVNEXT_RULES:
        rel = pattern.sub(repl, rel)
    return rel


# timm's module names inside a MobileNetV3 / EfficientNetV2 block → the JAX block's
_SE_LEAVES = {"se.conv_reduce": "se.fc1", "se.conv_expand": "se.fc2"}  # 1×1 convs ↔ Dense
_BLOCK_LEAVES = {
    DepthwiseSeparableConv: {"conv_dw": "dw", "bn1": "bn_dw", "conv_pw": "project", "bn2": "bn_project",
                             **_SE_LEAVES},
    InvertedResidual: {"conv_pw": "expand", "bn1": "bn_expand", "conv_dw": "dw", "bn2": "bn_dw",
                       "conv_pwl": "project", "bn3": "bn_project", **_SE_LEAVES},
    EdgeResidual: {"conv_exp": "expand", "bn1": "bn_expand", "conv_pwl": "project", "bn2": "bn_project"},
    ConvBnAct: {"conv": "project", "bn1": "bn_project"},
}
_MBCONV_BLOCK = re.compile(r"^blocks\.(\d+)\.(\d+)(?:\.(.+))?$")


def _mbconv_path(root: nn.Module, rel: str, top: Dict[str, str], block_name: Callable[[int, int], str],
                 head_block: Dict[str, str]) -> str:
    """A MobileNetV3 / EfficientNetV2 path: ``top`` names the modules outside
    the blocks; block (s, b) is ``block_name(s, b)`` with its leaves renamed
    by its type, except that a ConvBnAct is named by ``head_block`` where
    one is given (MobileNetV3's trailing 1×1 ConvBnAct)."""
    if rel in top:
        return top[rel]
    m = _MBCONV_BLOCK.match(rel)
    if not m:
        return rel  # the containers ``blocks`` and ``blocks.{s}``
    s, b, leaf = int(m[1]), int(m[2]), m[3]
    block = root.blocks[s][b]
    if head_block and isinstance(block, ConvBnAct):
        return head_block.get(leaf, leaf or "")
    name = block_name(s, b)
    return name if leaf is None else f"{name}.{_BLOCK_LEAVES[type(block)].get(leaf, leaf)}"


def _mobilenet_path(root: nn.Module, rel: str) -> str:
    # the JAX tree enumerates the blocks flat across timm's groups, from stage1_block1
    def flat(s: int, b: int) -> str:
        return f"stage{sum(len(g) for g in root.blocks[:s]) + b + 1}_block1"

    return _mbconv_path(root, rel, {"conv_stem": "stem", "bn1": "stem_bn", "conv_head": "pre_head",
                                    "classifier": "fc"}, flat, {"conv": "head_conv", "bn1": "head_bn"})


def _efficientnet_path(root: nn.Module, rel: str) -> str:
    return _mbconv_path(root, rel, {"conv_stem": "stem", "bn1": "stem_bn", "conv_head": "head_conv",
                                    "bn2": "head_bn", "classifier": "fc"},
                        lambda s, b: f"stage{s + 1}_block{b + 1}", {})


# a family's root module type → (root, module path relative to it) → its flax path
_FAMILY_PATHS: Dict[type, Callable[[nn.Module, str], str]] = {
    SwinTransformer: _swin_path,
    SwinTransformerV2: _swinv2_path,
    ResNet: _resnet_path,
    ConvNeXt: _convnext_path,
    MobileNetV3: _mobilenet_path,
    EfficientNetV2: _efficientnet_path,
}


def _path_mapper(model: nn.Module) -> Callable[[str], str]:
    """Port module path → flax path: a family's mapping below its root
    module, ViT's ``blocks.{i}`` rule everywhere else."""
    roots = [(name, m, _FAMILY_PATHS[type(m)]) for name, m in model.named_modules() if type(m) in _FAMILY_PATHS]

    def flax_path(module_path: str) -> str:
        for root, module, family_path in roots:
            prefix = f"{root}." if root else ""
            if module_path != root and not module_path.startswith(prefix):
                continue
            rel = "" if module_path == root else family_path(module, module_path[len(prefix):])
            return ".".join(p for p in (root, rel) if p).replace(".", "/")
        return _BLOCK.sub(r"\1block\2", module_path).replace(".", "/")

    return flax_path


def _same(a: np.ndarray) -> np.ndarray:
    return a


def _dense(a: np.ndarray) -> np.ndarray:
    return a.T  # [in, out] → [out, in]


def _conv(a: np.ndarray) -> np.ndarray:
    if a.ndim == 2:  # the Dense kernel [in, out] of a 1×1 conv on a pooled map (SE, pre_head)
        return a.T[:, :, None, None]
    return a.transpose(3, 2, 0, 1)  # HWIO → OIHW


def _class_columns(num_class: int) -> Callable[[np.ndarray], np.ndarray]:
    return lambda a: a[:, :num_class]  # [feat_dim, padded] → [feat_dim, num_class]


def _sources(model: nn.Module) -> Dict[str, Tuple[str, str, Callable]]:
    """Port state-dict key → (source tree, flax path, array transform)."""
    out: Dict[str, Tuple[str, str, Callable]] = {}
    flax_path = _path_mapper(model)
    for mpath, m in model.named_modules():
        fpath = flax_path(mpath)

        def key(name: str) -> str:
            return f"{mpath}.{name}" if mpath else name

        def leaf(name: str) -> str:
            return f"{fpath}/{name}" if fpath else name

        params = [n for n, _ in m.named_parameters(recurse=False)]
        buffers = [n for n, b in m.named_buffers(recurse=False) if b is not None]
        for name in params + buffers:
            if isinstance(m, nn.Linear) and name == "weight":
                src = ("params", leaf("kernel"), _dense)
            elif isinstance(m, nn.Conv2d) and name == "weight":
                src = ("params", leaf("kernel"), _conv)
            elif isinstance(m, (nn.LayerNorm, nn.modules.batchnorm._BatchNorm)) and name == "weight":
                src = ("params", leaf("scale"), _same)
            elif isinstance(m, nn.modules.batchnorm._BatchNorm) and name == "running_mean":
                src = ("batch_stats", leaf("mean"), _same)
            elif isinstance(m, nn.modules.batchnorm._BatchNorm) and name == "running_var":
                src = ("batch_stats", leaf("var"), _same)
            elif isinstance(m, nn.modules.batchnorm._BatchNorm) and name == "num_batches_tracked":
                continue
            elif isinstance(m, MarginHead) and name == "weight":
                src = ("params", leaf("weight"), _class_columns(m.num_class))
            elif isinstance(m, LayerScale) and name == "gamma":
                src = ("params", fpath, _same)
            elif name in params:
                src = ("params", leaf(name), _same)
            else:
                raise ValueError(f"bridge: no JAX counterpart is known for buffer {key(name)!r}")
            out[key(name)] = src
    return out


def param_paths(model: nn.Module) -> Dict[str, str]:
    """Port parameter name → the flax path of its counterpart in the JAX
    ``params`` tree (``backbone.blocks.0.attn.qkv.weight`` →
    ``backbone/block0/attn/qkv/kernel``; ``layers.0.blocks.1.attn.qkv.weight``
    of a bare Swin → ``stage0_block1/attn/qkv/kernel``). The optimizer labels
    parameters by these paths, as the JAX optimizer labels its tree."""
    names = {n for n, _ in model.named_parameters()}
    return {k: path for k, (t, path, _) in _sources(model).items() if t == "params" and k in names}


def state_dict_from_jax(model: nn.Module, tree: Tree) -> Dict[str, torch.Tensor]:
    """The port state dict of ``model`` filled from a JAX tree (see module doc)."""
    target = model.state_dict()
    used = set()
    missing: List[str] = []
    out: Dict[str, torch.Tensor] = dict(target)
    for key, (t, path, fn) in _sources(model).items():
        flat = tree.get(t, {})
        if path not in flat:
            missing.append(f"{key} <- {t}::{path}")
            continue
        used.add((t, path))
        arr = np.array(fn(np.asarray(flat[path])), order="C")  # a writable copy
        want = tuple(target[key].shape)
        if arr.shape != want:
            raise ValueError(f"bridge: {t}::{path} has shape {arr.shape}, {key} needs {want}")
        out[key] = torch.from_numpy(arr).to(target[key].dtype)
    if missing:
        raise KeyError(
            f"bridge: {len(missing)} port tensors have no source in the JAX tree: {missing[:12]}"
            + (" ..." if len(missing) > 12 else "")
        )
    extra = [f"{t}::{p}" for t, flat in tree.items() for p in flat if (t, p) not in used]
    if extra:
        raise ValueError(
            f"bridge: {len(extra)} JAX tensors map to no port tensor "
            f"(refusing a silent partial import): {extra[:12]}" + (" ..." if len(extra) > 12 else "")
        )
    return out


def load_jax_params(model: nn.Module, tree: Tree) -> nn.Module:
    """Load a JAX tree into ``model`` in place (strict) and return it."""
    model.load_state_dict(state_dict_from_jax(model, tree), strict=True)
    return model


def merge_converted(model: nn.Module, tree: Tree, logger=None) -> nn.Module:
    """Non-strict load of a JAX tree into ``model`` in place (the JAX
    ``merge_converted``, a config's ``convert_npz``): each port tensor whose
    source is in ``tree`` with the right shape takes it, the others keep
    their values. Logs the counts. (The JAX merge also resizes a
    ``pos_embed`` of another grid; here that tensor is skipped.)"""
    target = model.state_dict()
    loaded, skipped = 0, []
    for key, (t, path, fn) in _sources(model).items():
        src = tree.get(t, {}).get(path)
        arr = None if src is None else np.array(fn(np.asarray(src)), order="C")
        if arr is not None and arr.shape == tuple(target[key].shape):
            target[key] = torch.from_numpy(arr).to(target[key].dtype)
            loaded += 1
        else:
            skipped.append(key)
    model.load_state_dict(target, strict=True)
    if logger is not None:
        logger.both(f"convert: loaded {loaded} tensors; skipped {len(skipped)} {skipped[:8]}")
    return model


def load_converted(path: str) -> Tree:
    """Read a ``{tree}::{path}`` npz (the JAX package's ``save_converted``).
    Keys that start with ``__`` are not tensors of a tree (a golden fixture's
    ``__input__`` and ``__logits__``) and are skipped."""
    out: Tree = {}
    with np.load(path) as data:
        for key in data.files:
            if key.startswith("__"):
                continue
            t, p = key.split("::", 1)
            out.setdefault(t, {})[p] = data[key]
    return out
