"""The system under test: the port's model, train step and embed step, built
from a configuration as the port's trainer builds them. The only module of
the benchmark that imports ``visiondk_tpu_torch``.

The model is the factory's class for the configuration's task, made on the
meta device and materialised on the card with the benchmark's weights, so
that no weight is drawn on the host. The train step is ``make_train_step``
with ``build_tx`` of the configuration's ``hyp``, ``create_train_state`` and
the trainer's loss; the embed step is ``make_embed_step``.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from visiondk_tpu_torch.config.checks import canonical_model_name
from visiondk_tpu_torch.engine.state import TrainState, create_train_state
from visiondk_tpu_torch.engine.steps import StepConfig, make_embed_step, make_train_step
from visiondk_tpu_torch.engine.trainer import build_tx
from visiondk_tpu_torch.losses import create_lossfn
from visiondk_tpu_torch.models.factory import EmbeddingModel, VisionModel
from visiondk_tpu_torch.ops import attention as qkv_ops
from visiondk_tpu_torch.ops import window_attention as window_ops
from visiondk_tpu_torch.parallel.mesh import MeshContext, build_mesh, initialize_distributed

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def deterministic_cudnn() -> None:
    """The trainer's setting on the card: cuDNN's deterministic algorithms, no autotuner."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def _model_class(model_cfg: Dict) -> Tuple[type, Dict]:
    """The factory's class and arguments for a ``model:`` section (``get_model``'s dispatch)."""
    task = model_cfg["task"]
    if task == "classification":
        kwargs = dict(model_cfg.get("kwargs") or {})
        if model_cfg.get("image_size") is not None:
            kwargs.setdefault("img_size", int(model_cfg["image_size"]))
        return VisionModel, dict(backbone_name=canonical_model_name(model_cfg["name"]),
                                 num_classes=model_cfg["num_classes"],
                                 attention_pool=model_cfg.get("attention_pool", False),
                                 backbone_kwargs=kwargs)
    if task in ("face", "cbir"):
        (name, params), = model_cfg["backbone"].items()
        params = dict(params or {})
        kwargs = {k: v for k, v in params.items() if k not in ("feat_dim", "image_size", "pretrained")}
        if params.get("image_size") is not None:
            kwargs.setdefault("img_size", int(params["image_size"]))
        return EmbeddingModel, dict(backbone_name=canonical_model_name(name), feat_dim=params.get("feat_dim", 128),
                                    head_config=model_cfg.get("head"), backbone_kwargs=kwargs)
    raise ValueError(f"task {task!r} has no model here")


def build_model(cfg: Dict, state: Dict[str, torch.Tensor], device) -> nn.Module:
    """The configuration's model in its compute dtype on ``device``, holding
    ``state`` (every parameter and buffer, by the port's names; a missing or
    extra name, or another shape, raises)."""
    cls, args = _model_class(cfg["model"])
    with torch.device("meta"):
        model = cls(**args, dtype=DTYPES[cfg["compute_dtype"]])
    model = model.to_empty(device=device)
    want = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    have = {n: tuple(t.shape) for n, t in state.items()}
    if want != have:
        missing = sorted(set(want) - set(have))[:8]
        extra = sorted(set(have) - set(want))[:8]
        shapes = sorted(n for n in set(want) & set(have) if want[n] != have[n])[:8]
        raise ValueError(f"the benchmark's weights do not fit the port's model: missing {missing}, "
                         f"extra {extra}, other shapes {shapes}")
    model.load_state_dict(state, strict=True)
    return model


def step_config(cfg: Dict) -> StepConfig:
    task = "classification" if cfg["model"]["task"] == "classification" else "embedding"
    return StepConfig(task=task, mean=tuple(cfg["mean"]), std=tuple(cfg["std"]))


def lossfn(cfg: Dict) -> Callable:
    """The trainer's cross entropy: smoothed over the margin head's classes for the embedding tasks."""
    valid = None
    if cfg["model"]["task"] in ("face", "cbir"):
        valid = int(next(iter(cfg["model"]["head"].values()))["num_class"])
    return create_lossfn("ce", label_smooth=cfg["hyp"].get("label_smooth", 0.0), valid_class=valid)


def train_step(cfg: Dict, model: nn.Module, step_seed: int,
               mesh: Optional[MeshContext] = None) -> Tuple[TrainState, Callable]:
    """(state, step): ``build_tx`` of the ``hyp``, the train state (its CPU
    generator seeded with ``step_seed``, from which the step draws its
    dropout seeds) and ``make_train_step`` (DDP over ``mesh``'s process
    group where one is given), as ``run_classifier`` and ``run_embedding``
    build them."""
    discrete = cfg["model"]["task"] == "classification"
    tx = build_tx(cfg["hyp"], cfg["steps_per_epoch"], discrete_per_epoch=discrete, model_cfg=cfg["model"])
    state = create_train_state(model, tx, torch.Generator().manual_seed(step_seed))
    step = make_train_step(model, tx, lossfn(cfg), step_config(cfg), state.generator, mesh=mesh)
    return state, step


def join_ranks(address: str, world: int, rank: int, device) -> MeshContext:
    """Joins the process group as ``main.py --multihost`` does (NCCL on the
    card, the rank on ``cuda:rank``; gloo on the CPU) and returns the run's
    data-parallel layout."""
    os.environ["LOCAL_RANK"] = str(rank)
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    initialize_distributed(address, world, rank, backend=backend)
    return build_mesh()


def embed_step(cfg: Dict, model: nn.Module) -> Callable:
    return make_embed_step(model, step_config(cfg))


def momentum_buffers(state: TrainState) -> Dict[str, torch.Tensor]:
    """Each parameter's SGD trace by name (after the first update: its first
    gradient, clipped, plus weight decay)."""
    opt = state.optimizer.optimizer
    return {n: opt.state[p]["momentum_buffer"] for n, p in state.model.named_parameters()
            if "momentum_buffer" in opt.state.get(p, {})}


def ema_parameters(state: TrainState) -> Dict[str, torch.Tensor]:
    return dict(state.ema_model.named_parameters())


def kernel_launches() -> Dict[str, int]:
    """The attention kernels' launch counters, by wrapper name."""
    out = {}
    for module in (qkv_ops, window_ops):
        for name in dir(module):
            fn = getattr(module, name)
            if callable(fn) and hasattr(fn, "launches") and not name.startswith("_"):
                out[name] = int(fn.launches)
    return out
