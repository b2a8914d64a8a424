"""Knowledge distillation (counterpart of ``visiondk_tpu/engine/distill.py``).

- ``make_distill_step``: the teacher's forward in eval mode under
  ``torch.no_grad`` (the JAX ``stop_gradient``), then the student's forward
  and backward with ``loss = cls_weight·CE(s, y) + kl_weight·KL_T(s‖t)``,
  clip, optimizer and EMA, as the classification train step does. The
  device-augment stage runs first, so teacher and student see the same
  augmented batch.
- ``make_embed_distill_step``: embedding distillation against precomputed
  teacher features (``data.datasets.EmbeddingDistillDataset``): MSE or
  cosine loss on L2-normalised embeddings.
- ``DistillCenterProcessor``: a ``CenterProcessor`` over
  ``cfgs["student"]`` with a frozen teacher built from ``cfgs["teacher"]``
  and restored from one of the port's checkpoint directories.

The steps draw from the state's generator in the order of
``make_train_step`` (the dropout seed, then the device-augment seed), so a
checkpoint's generator replays them on resume. As the JAX distillation
steps, they update the EMA and count ``ema_updates`` at every call, the
mini-steps of gradient accumulation that apply no update included (the JAX
main step, and the port's ``make_train_step``, tick it on applied updates
only: a difference inside the reference). Under a process group
``make_distill_step`` trains the student through DDP as ``make_train_step``
does (the teacher, frozen, is not wrapped); the embedding distillation step,
which no CLI drives, runs in one process.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from visiondk_tpu_torch.engine.checkpoint import CheckpointManager
from visiondk_tpu_torch.engine.optim import OptimizerSpec
from visiondk_tpu_torch.engine.state import TrainState
from visiondk_tpu_torch.engine.steps import StepConfig, _device, device_preprocess, rank_seed
from visiondk_tpu_torch.engine.trainer import CenterProcessor
from visiondk_tpu_torch.losses.losses import distill_kl
from visiondk_tpu_torch.models.ema import update_ema
from visiondk_tpu_torch.models.factory import get_model
from visiondk_tpu_torch.parallel.mesh import MeshContext


def _update_every_mini_step(state: TrainState, tx: OptimizerSpec, cfg: StepConfig) -> None:
    """The end of a distillation step: the optimizer update (with
    accumulation, applied on the mini-step that completes a round), then the
    EMA update and ``ema_updates`` += 1 on every call, and step += 1."""
    tx.update(state.optimizer)
    state.ema_updates += 1
    update_ema(state.ema_model, state.model, state.ema_updates, cfg.ema_decay, cfg.ema_tau)
    state.step += 1


def make_distill_step(
    student: nn.Module,
    teacher: nn.Module,
    tx: OptimizerSpec,
    lossfn: Callable,
    cfg: StepConfig,
    generator: torch.Generator,
    cls_weight: float = 0.5,
    kl_weight: float = 0.5,
    temperature: float = 4.0,
    device_augment: Optional[Callable[[int, torch.Tensor], torch.Tensor]] = None,
    mesh: Optional[MeshContext] = None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """``step(state, batch, lam=0.0) -> {"loss", "loss_cls", "loss_kl"}``,
    in the form of ``make_train_step`` so that the trainer swaps it in.
    ``teacher`` must live on the student's device; it runs in eval mode
    under ``torch.no_grad`` on the same (augmented, normalised) batch. With a
    distributed ``mesh`` the batch is this rank's rows of the global one, as
    in ``make_train_step`` (the stage runs on the gathered global batch), and
    the losses returned are the global batch's."""
    device = _device(student)
    distributed = mesh is not None and mesh.distributed
    net = mesh.data_parallel(student) if distributed else student

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor], lam: float = 0.0):
        if state.model is not student:
            raise ValueError("the state holds another model than the one this step was built for")
        images = batch["image"].to(device, non_blocking=True)
        labels = batch["label"].to(device, non_blocking=True)
        rows = images.shape[0]
        seed = rank_seed(int(torch.randint(0, 2**62, (), generator=generator)), mesh.rank if distributed else 0)
        if device_augment is not None:  # on the global batch, as make_train_step's stage
            everyone = mesh.world_rows(images) if distributed else images
            everyone = device_augment(int(torch.randint(0, 2**62, (), generator=generator)), everyone)
            images = mesh.own_rows(everyone, rows) if distributed else everyone
        images = device_preprocess(images, cfg.mean, cfg.std)
        teacher.eval()
        with torch.no_grad():
            t_logits = teacher(images)
        student.train()
        for p in student.parameters():
            p.grad = None
        with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
            torch.manual_seed(seed)
            s_logits = net(images)
            loss_cls = lossfn(s_logits, labels)
            loss_kl = distill_kl(s_logits, t_logits, temperature)
            loss = cls_weight * loss_cls + kl_weight * loss_kl
        loss.backward()
        _update_every_mini_step(state, tx, cfg)
        out = {"loss": loss, "loss_cls": loss_cls, "loss_kl": loss_kl}
        return {k: mesh.world_mean(v.detach()) if distributed else v.detach() for k, v in out.items()}

    return step_fn


def make_embed_distill_step(
    student: nn.Module,
    tx: OptimizerSpec,
    cfg: StepConfig,
    generator: torch.Generator,
    loss_type: str = "cosine",
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Embedding distillation: ``batch = {"image", "feature" [B, D]}`` (the
    teacher's embeddings). The student's f32 embedding chases the
    teacher's: ``mean(1 − cos)`` of the two L2-normalised (each norm
    clamped at 1e-12) for ``"cosine"``, the mean squared difference of the
    raw ones otherwise."""
    device = _device(student)

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor], lam: float = 0.0):
        if state.model is not student:
            raise ValueError("the state holds another model than the one this step was built for")
        images = device_preprocess(batch["image"].to(device, non_blocking=True), cfg.mean, cfg.std)
        target = batch["feature"].to(device, non_blocking=True).float()
        seed = int(torch.randint(0, 2**62, (), generator=generator))
        student.train()
        for p in student.parameters():
            p.grad = None
        with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
            torch.manual_seed(seed)
            emb = student.embed(images).float()
            if loss_type == "cosine":
                e = emb / torch.linalg.vector_norm(emb, dim=1, keepdim=True).clamp_min(1e-12)
                t = target / torch.linalg.vector_norm(target, dim=1, keepdim=True).clamp_min(1e-12)
                loss = (1.0 - (e * t).sum(dim=1)).mean()
            else:
                loss = (emb - target).square().mean()
        loss.backward()
        _update_every_mini_step(state, tx, cfg)
        return {"loss": loss.detach()}

    return step_fn


class DistillCenterProcessor(CenterProcessor):
    """Classification training with a frozen logit teacher. Config layout::

        student: <a full classification config>
        teacher:
          model: {task: classification, name: ..., num_classes: ...}
          weight: run/teacher/best   # a checkpoint directory of the port
          ema: true                  # restore its EMA weights (else the live ones)
        distill: {cls_weight: 0.5, kl_weight: 0.5, temperature: 4.0}

    The teacher is built by ``get_model`` on the run's device in the compute
    dtype (at the student's input size where its config names none) and,
    with a ``weight``, loaded strictly from that checkpoint: a checkpoint
    of another model raises. Without one it keeps its seeded init."""

    def __init__(self, cfgs: Dict[str, Any], project: str, **kwargs):
        super().__init__(cfgs["student"], project=project, **kwargs)
        tcfg = cfgs["teacher"]
        dcfg = cfgs.get("distill") or {}
        self.cls_weight = float(dcfg.get("cls_weight", 0.5))
        self.kl_weight = float(dcfg.get("kl_weight", 0.5))
        self.temperature = float(dcfg.get("temperature", 4.0))
        model_cfg = dict(tcfg["model"])
        model_cfg.setdefault("image_size", self.imgsz)
        self.teacher_model = get_model(model_cfg, dtype=self.compute_dtype, device=self.device,
                                       generator=torch.Generator().manual_seed(0))
        if tcfg.get("weight"):
            weight = Path(tcfg["weight"])
            saved = CheckpointManager(weight.parent).read(weight.name)
            self.teacher_model.load_state_dict(saved["ema" if tcfg.get("ema", True) else "model"], strict=True)
            self.logger.both(f"teacher: {tcfg['model']['name']} from {weight} "
                             f"({'EMA' if tcfg.get('ema', True) else 'live'} weights)")
        self.teacher_model.requires_grad_(False).eval()

    def _get_train_step(self, tx: OptimizerSpec, state: TrainState, key, lossfn, device_aug: bool,
                        mixup: bool = False) -> Callable:
        """The distillation step, whatever the mixup window says: it takes λ
        and leaves it unused, as the JAX distillation step does."""
        key = ("distill", key)
        if key not in self._step_cache:
            self._step_cache[key] = make_distill_step(
                self.model, self.teacher_model, tx, lossfn, self.step_config(), state.generator,
                cls_weight=self.cls_weight, kl_weight=self.kl_weight, temperature=self.temperature,
                device_augment=self.device_augment_fn if device_aug else None, mesh=self.mesh,
            )
        return self._step_cache[key]
