"""JAX parameter tree → port state dict (the weight bridge).

The reverse of ``visiondk_tpu/models/convert.py::convert_vit``. The source is
the JAX package's variables as flat numpy trees, ``{"params": {path: arr},
"batch_stats": {path: arr}}`` with "/"-joined flax paths, which is the
format ``save_converted`` writes as ``{tree}::{path}`` npz keys. The mapping
follows the port module that owns each tensor:

- ``nn.Linear`` weight ← ``kernel`` [in, out] transposed to [out, in];
- ``nn.Conv2d`` weight ← ``kernel`` HWIO permuted to OIHW;
- LayerNorm / BatchNorm weight ← ``scale``; BatchNorm running_mean/var ←
  ``batch_stats`` ``mean``/``var``;
- LayerScale gamma ← the flax param named after the module (``block{i}/ls1``);
- any other parameter (``cls_token``, ``pos_embed``) ← the same name;
- module paths, per family: ViT's torch ``blocks.{i}`` ↔ flax ``block{i}``;
  under a ``SwinTransformer``, ``layers.{s}.blocks.{b}`` ↔ ``stage{s}_block{b}``,
  ``layers.{s}.downsample`` ↔ ``merge{s}``, ``patch_embed.proj`` ↔
  ``patch_embed`` (the flax Conv) and ``patch_embed.norm`` ↔ ``patch_norm``;
  ``backbone.``/``neck.`` ↔ ``backbone/``/``neck/``.

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

from visiondk_tpu_torch.models.backbones.swin import SwinTransformer
from visiondk_tpu_torch.models.layers import LayerScale

Tree = Dict[str, Dict[str, np.ndarray]]

_BLOCK = re.compile(r"(^|\.)blocks\.(\d+)(?=\.|$)")
# module path relative to a family's root module → its flax name, rule by rule
_FAMILY_RULES = {
    SwinTransformer: (
        (re.compile(r"^layers\.(\d+)\.blocks\.(\d+)(?=\.|$)"), r"stage\1_block\2"),
        (re.compile(r"^layers\.(\d+)\.downsample(?=\.|$)"), r"merge\1"),
        (re.compile(r"^patch_embed\.proj$"), "patch_embed"),
        (re.compile(r"^patch_embed\.norm$"), "patch_norm"),
    ),
}


def _path_mapper(model: nn.Module) -> Callable[[str], str]:
    """Port module path → flax path: a family's rules below its root module,
    ViT's ``blocks.{i}`` rule everywhere else."""
    roots = [(name, _FAMILY_RULES[type(m)]) for name, m in model.named_modules() if type(m) in _FAMILY_RULES]

    def flax_path(module_path: str) -> str:
        for root, rules in roots:
            prefix = f"{root}." if root else ""
            if module_path != root and not module_path.startswith(prefix):
                continue
            rel = "" if module_path == root else module_path[len(prefix):]
            for pattern, repl in rules:
                rel = pattern.sub(repl, rel)
            return ".".join(p for p in (root, rel) if p).replace(".", "/")
        return _BLOCK.sub(r"\1block\2", module_path).replace(".", "/")

    return flax_path


def _same(a: np.ndarray) -> np.ndarray:
    return a


def _dense(a: np.ndarray) -> np.ndarray:
    return a.T  # [in, out] → [out, in]


def _conv(a: np.ndarray) -> np.ndarray:
    return a.transpose(3, 2, 0, 1)  # HWIO → OIHW


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
