"""The trainer (counterpart of ``visiondk_tpu/engine/trainer.py``).

``build_tx`` makes the optimizer a run trains with (the JAX
``CenterProcessor._build_tx``). ``CenterProcessor`` owns a run: model, data,
loss, optimizer, schedule, EMA, checkpoints, logger and ``metrics.jsonl``.
``run_classifier`` trains and validates a classification model epoch by
epoch, as the JAX loop does:

- the epoch strategy (``_epoch_strategy``): epoch 0 trains on the val
  augments, ``warm_ep`` restores the train augments (and swaps in the
  focal loss where configured), mixup is live in the epochs
  ``[warm_ep, warm_ep + duration)`` (its λ per step from
  ``np.random.default_rng([seed, epoch, i]).beta(ratio, ratio)``),
  ``aug_epoch`` weakens the augments to the val augments, progressive resize
  rewrites the pipeline's sizes; a resumed run replays the skipped epochs'
  strategy so its pipeline matches the uninterrupted run's;
- OHEM (``hyp.strategy.ohem``, CE only) in every train step, and gradient
  accumulation (``hyp.accumulate``: k mini-batches an applied update, the
  schedules on applied counts with ``steps_per_epoch / k`` of them an epoch);
- SAM (``hyp.optimizer: [sam, ...]``): SGD as the base optimizer and the
  step's second pass at w + e(w) (``StepConfig.sam``, with
  ``hyp.sam_local_perturb``, default true: the per-rank ε of a data-parallel
  run, which in one process is the global one);
- each step through the port's ``make_train_step``, fed by a
  ``DevicePrefetcher`` (batch N+1 is copied to the card while step N runs);
  per-step losses stay on the device, with one host read per epoch;
- the device-augment stage (``ops/device_augment.py``) where the data
  processor lifted the per-pixel random ops off the host pipeline: it runs
  inside the train step in the epochs whose train augments are live,
  ``[warm_ep, aug_epoch)``;
- EMA validation each epoch through ``make_eval_step`` on the EMA module;
- ``last`` / ``best`` checkpoints each epoch (``engine/checkpoint.py``),
  ``load_from`` and ``convert_npz`` initialisation, the epoch table,
  ``metrics.jsonl`` and the "Validate:" hint.

``run_embedding`` trains the face and CBIR tasks (a margin head over the
embedding neck), as the JAX loop does: the schedule steps per batch, the
train augments (and the device-augment stage) are live in every epoch with
no warm-up or weakening, the loss is logged every ``print_freq`` steps, and
every ``save_freq`` epochs the EMA model is evaluated (``_eval_embedding``:
the 10-fold pair accuracy for face, the retrieval metrics for CBIR) and
``Epoch_{n}`` (with its metrics), ``best`` and ``last`` are saved.

Distributed (``mesh``, a ``parallel.MeshContext`` over a process group;
``main.py --multihost``): ``data.train.bs`` is the global batch and each rank
loads its ``bs / W`` rows, the JAX loader's process shard (``_local_bs``);
the train step runs DDP (``engine/steps.py``); with ``--model_parallel`` m > 1
the margin head is class-sharded (``MarginHead.shard``) and its loss is the
CE over class shards. Evaluation is replicated: every rank runs the whole val
set, and only rank 0 logs, writes ``config.yaml``, ``metrics.jsonl`` and
checkpoints (every rank takes part in a checkpoint's gather).

A run trains on the card (``device="cuda"``, the default) unless the caller
passes ``device="cpu"``; without CUDA the default raises. Compute is bf16
with f32 parameters by default (``compute_dtype``). On the card the run
selects cuDNN's deterministic algorithms (no autotuner), so seeded runs are
bit-identical.
"""

from __future__ import annotations

import math
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from visiondk_tpu_torch.config.checks import normalize_accumulate
from visiondk_tpu_torch.config.loader import get_imgsz, yaml_dump
from visiondk_tpu_torch.data.dataprocessor import SmartDataProcessor
from visiondk_tpu_torch.data.datasets import CBIRDatasets, tell_data_distribution
from visiondk_tpu_torch.data.loader import DevicePrefetcher, loader_kind
from visiondk_tpu_torch.data.transforms import create_aug_transforms
from visiondk_tpu_torch.engine import cbir_eval, face_eval
from visiondk_tpu_torch.engine import evaluation as cls_eval
from visiondk_tpu_torch.engine.checkpoint import CheckpointManager
from visiondk_tpu_torch.engine.optim import OptimizerSpec, SAMConfig, create_optimizer
from visiondk_tpu_torch.engine.schedules import create_scheduler, momentum_schedule
from visiondk_tpu_torch.engine.state import TrainState, create_train_state, full_state_dict, load_full_state_dict
from visiondk_tpu_torch.engine.steps import OHEMConfig, StepConfig, make_embed_step, make_eval_step, make_train_step
from visiondk_tpu_torch.losses import create_lossfn
from visiondk_tpu_torch.losses.losses import class_sharded_cross_entropy
from visiondk_tpu_torch.models.convert import load_converted, merge_converted
from visiondk_tpu_torch.models.factory import get_model
from visiondk_tpu_torch.ops.device_augment import describe_split, make_device_augment
from visiondk_tpu_torch.parallel.mesh import MeshContext, build_mesh
from visiondk_tpu_torch.utils.logger import SmartLogger
from visiondk_tpu_torch.utils.meters import AverageMeter
from visiondk_tpu_torch.utils.metrics_writer import MetricsWriter
from visiondk_tpu_torch.utils.plots import colorstr


def build_tx(
    hyp: Dict[str, Any],
    steps_per_epoch: int,
    discrete_per_epoch: bool,
    model_cfg: Optional[Dict[str, Any]] = None,
) -> OptimizerSpec:
    """The optimizer of a config's ``hyp:`` section (and the freeze flags of
    its ``model:`` section). With ``hyp.accumulate`` = k the optimizer
    applies one update every k mini-steps (``optax.MultiSteps``), and an
    epoch is ``steps_per_epoch / k`` applied updates, kept fractional. The
    schedules run on epochs ``count / (steps_per_epoch / k)`` of the
    applied-update count, computed in f32 as the JAX schedule computes them,
    floored when ``discrete_per_epoch`` (classification steps its schedule
    per epoch, the embedding tasks per batch). ``sam`` builds its base
    optimizer, SGD; the step config carries its ascent (``StepConfig.sam``)."""
    accumulate = normalize_accumulate(hyp)
    spe_applied = np.float32(steps_per_epoch / accumulate)
    optimizer = hyp["optimizer"]
    opt_name = optimizer[0]
    layer_wise = bool(optimizer[1]) if isinstance(optimizer, (list, tuple)) and len(optimizer) > 1 else False
    epoch_sched = create_scheduler(
        hyp["scheduler"], hyp["warm_ep"], hyp["epochs"], hyp["lr0"], hyp.get("lrf_ratio")
    )
    mom_sched = momentum_schedule(
        hyp["warm_ep"], hyp["momentum"], hyp.get("warmup_momentum", hyp["momentum"])
    )

    def to_epochs(count: int) -> float:
        t = float(np.float32(count) / spe_applied)
        return math.floor(t) if discrete_per_epoch else t

    model_cfg = model_cfg or {}
    return create_optimizer(
        opt_name,
        lambda count: epoch_sched(to_epochs(count)),
        hyp["weight_decay"],
        lambda count: mom_sched(to_epochs(count)),
        layer_wise_lr=layer_wise,
        backbone_freeze=bool(model_cfg.get("backbone_freeze")),
        bn_freeze_affine=bool(model_cfg.get("bn_freeze_affine")),
        accumulate=accumulate,
    )


def logged_lr(tx: OptimizerSpec, mini_count: int) -> float:
    """The lr a run logs after ``mini_count`` mini-steps: the schedule at the
    applied count ``mini_count // accumulate`` (the JAX trainer's ``_lr_fn``)."""
    return tx.lr_schedule(mini_count // tx.accumulate)


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; CUDA without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} was asked for (the default) but CUDA is not available; "
            "pass --device cpu (device='cpu') to run on the CPU"
        )
    return device


class CenterProcessor:
    def __init__(
        self,
        cfgs: Dict[str, Any],
        project: str,
        train: bool = True,
        device: torch.device | str = "cuda",
        compute_dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        mesh: Optional[MeshContext] = None,
    ):
        self.device = resolve_device(device)
        self.mesh = mesh or build_mesh()
        primary = self.mesh.is_primary()
        if self.device.type == "cuda":
            # a seeded run is bit-reproducible: cuDNN's deterministic algorithms, no autotuner
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
        self.model_cfg = cfgs["model"]
        self.data_cfg = cfgs["data"]
        self.hyp_cfg = cfgs["hyp"]
        self.task = self.model_cfg["task"]
        self.project = Path(project)
        self.compute_dtype = compute_dtype
        self.seed = seed

        if primary:
            self.project.mkdir(parents=True, exist_ok=True)
        logfile = str(self.project / f"log{time.strftime('%Y%m%d-%H%M%S')}.log") if train and primary else None
        self.logger = SmartLogger(filename=logfile, console=primary)
        if train and primary:
            yaml_dump(cfgs, self.project / "config.yaml")

        strategy = self.hyp_cfg.get("strategy", {})
        loss_cfg = self.hyp_cfg["loss"]
        self.loss_choice = "ce" if loss_cfg.get("ce") else "bce"
        # OHEM (CE only), weighting both loss terms where mixup is on too
        ohem = strategy.get("ohem", [False])
        self.ohem_cfg = (OHEMConfig(*ohem[1:4]) if ohem and ohem[0] and self.loss_choice == "ce"
                         and self.task == "classification" else None)
        # the mixup window [warm_ep, warm_ep + duration)
        mix = strategy.get("mixup", [0.0, 0])
        if isinstance(mix, dict):
            mix = [mix["ratio"], mix["duration"]]
        self.mixup_ratio, self.mixup_duration = float(mix[0]), int(mix[1])
        # SAM: the step's second pass (hyp.sam_local_perturb: the per-rank ε of a
        # data-parallel run, the same step as the global ε in one process)
        self.sam_cfg = (SAMConfig(local_perturb=bool(self.hyp_cfg.get("sam_local_perturb", True)))
                        if self.hyp_cfg["optimizer"][0] == "sam" else None)

        self.model = get_model(self.model_cfg, dtype=compute_dtype, device=self.device,
                               generator=torch.Generator().manual_seed(seed))
        # partial-FC: every rank drew the whole head from the seed and keeps its columns
        self.class_sharded = self.task in ("face", "cbir") and self.mesh.n_model > 1
        if self.class_sharded:
            self.model.head.shard(self.mesh)
        # rank 0 writes the run's class_indices.json before the other ranks read it
        if not primary:
            self.mesh.barrier()
        self.data_processor = SmartDataProcessor(
            self.data_cfg, project=str(self.project), rank_is_primary=primary, training=train, task=self.task,
        )
        if primary:
            self.mesh.barrier()
        # the device-augment stage: the lifted per-pixel random ops run on the
        # batch inside the train step, in the epochs whose train augments are live
        self.device_augment_fn = None
        # the JAX package's per-group branch draw; the port draws per sample whatever it says
        self.device_augment_group_size = self.data_cfg["train"].get("device_augment_group_size", 8)
        if train and self.data_processor.device_augment_cfg:
            self.device_augment_fn = make_device_augment(
                self.data_processor.device_augment_cfg, group_size=self.device_augment_group_size)
            note = ""
            if self.device_augment_group_size != 1:
                note = (f"; data.train.device_augment_group_size {self.device_augment_group_size} is not used: "
                        "the port draws every branch per sample (group_size 1, the reference's semantics)")
            self.logger.both("device augment split — " + describe_split(
                self.data_processor.train_pipeline_cfg, self.data_processor.device_augment_cfg) + note)
        # look-ahead of the device feeder: batches on the card beyond the one in use
        self.device_prefetch_depth = int(self.data_cfg["train"].get("device_prefetch", 2))
        # the final resize of the val pipeline wins; model.image_size when it has none
        self.imgsz = get_imgsz(self.data_cfg["val"]["augment"]) or self.model_cfg.get("image_size")
        if self.imgsz is None:
            raise ValueError(
                "cannot infer input size: no resize op in data.val.augment and "
                "model.image_size is unset"
            )

        label_smooth = self.hyp_cfg.get("label_smooth", 0.0)
        if self.loss_choice == "ce":
            # smoothing over the margin head's classes (the JAX head pads its
            # class dim and passes the real count; the port's head has no pad)
            valid = None
            if self.task in ("face", "cbir"):
                valid = int(next(iter(self.model_cfg["head"].values()))["num_class"])
            self.lossfn = create_lossfn("ce", label_smooth=label_smooth, valid_class=valid)
            if self.class_sharded:  # the embedding tasks weight no sample (no OHEM)
                head = self.model.head
                self.lossfn = lambda logits, targets, sample_weight=None: class_sharded_cross_entropy(  # noqa: E731
                    logits, targets, head.num_class, head.class_offset, self.mesh, label_smooth)
            self.thresh = 0
        else:
            self.lossfn = create_lossfn("bce")
            self.thresh = loss_cfg["bce"][1]
            if train and self.task == "classification":
                self.data_processor.set_label_smoothing(self.model_cfg["num_classes"], label_smooth)
        focal = strategy.get("focal", [False])
        self.focal_fn = (
            create_lossfn("focal", alpha=focal[1], gamma=focal[2])
            if focal and focal[0] and self.loss_choice == "bce"
            else None
        )
        # progressive learning: three resize milestones from warm_ep on
        self.prog_learn = bool(strategy.get("prog_learn", False))
        warm_ep, epochs = self.hyp_cfg["warm_ep"], self.hyp_cfg["epochs"]
        if self.prog_learn:
            remaining = epochs - warm_ep
            s1, s2 = remaining // 4, remaining // 4
            self.resize_chnodes = [warm_ep, warm_ep + s1, warm_ep + s1 + s2]
            self.imgsz_milestone = [int(x) for x in np.linspace(int(self.imgsz * 0.5), self.imgsz, 3)]

        # only the training run may delete half-written temporaries in its run dir
        self.ckpt = CheckpointManager(self.project, writer=bool(train), mesh=self.mesh)
        self._step_cache: Dict[str, Callable] = {}
        self.metrics_writer = MetricsWriter(self.project) if train and primary else None

    # ------------------------------------------------------------ helpers

    def _local_bs(self, global_bs: int) -> int:
        """This rank's train batch: ``data.train.bs`` is the global batch,
        and each of the W ranks loads ``bs / W`` rows of it (the JAX
        trainer's ``_local_bs``)."""
        if global_bs % self.mesh.world:
            raise ValueError(
                f"data.train.bs={global_bs} must be divisible by the process count ({self.mesh.world}): "
                "each process feeds bs/process_count rows of the global batch")
        return global_bs // self.mesh.world

    def _train_loader(self):
        return self.data_processor.dataloader(
            "train", self._local_bs(self.data_cfg["train"]["bs"]), seed=self.seed,
            process_index=self.mesh.rank, process_count=self.mesh.world)

    def _rank_note(self, msg) -> None:
        """``msg`` on the console of a rank other than 0, tagged with it (its
        logger is silent): a replicated evaluation's result on every rank."""
        if not self.mesh.is_primary():
            print(f"[rank {self.mesh.rank}] {msg}", flush=True)

    def _validate_hint(self) -> None:
        device_flag = "" if self.device.type == "cuda" else f" --device {self.device.type}"
        self.logger.console(
            colorstr("Validate:")
            + f" python -m visiondk_tpu_torch.validate --cfgs {self.project / 'config.yaml'}"
            f" --weight {self.project / 'best'} --ema{device_flag}"
        )

    def step_config(self, mixup: bool = False) -> StepConfig:
        """The train step's variant (the serving steps read only its
        normalisation): the task, mixup on or off, and the run's SAM and OHEM."""
        mean, std = self.data_processor.normalization
        task = "classification" if self.task == "classification" else "embedding"
        return StepConfig(task=task, mixup=mixup, sam=self.sam_cfg, ohem=self.ohem_cfg, mean=mean, std=std)

    def _get_train_step(self, tx: OptimizerSpec, state: TrainState, key, lossfn, device_aug: bool,
                        mixup: bool = False) -> Callable:
        if key not in self._step_cache:
            self._step_cache[key] = make_train_step(
                self.model, tx, lossfn, self.step_config(mixup), state.generator,
                device_augment=self.device_augment_fn if device_aug else None, mesh=self.mesh)
        return self._step_cache[key]

    def mixup_lambda(self, epoch: int, i: int) -> float:
        """Step i's mixup weight in ``epoch``: a Beta(ratio, ratio) draw
        seeded by (seed, epoch, i), the same on every host and every run."""
        return float(np.random.default_rng([self.seed, epoch, i]).beta(self.mixup_ratio, self.mixup_ratio))

    def _epoch_strategy(self, epoch: int, lossfn, aug_epoch: int, log: bool = True):
        """Apply this epoch's strategy to the data processor and the loss and
        return (the loss, whether mixup is live). A function of the epoch
        number and the config, so a resume replays epochs [0, start) with
        ``log=False``."""
        dp = self.data_processor
        warm_ep = self.hyp_cfg["warm_ep"]
        mixup_on = self.mixup_ratio > 0 and self.mixup_duration > 0
        if epoch == 0:
            dp.set_augment("train", None)
        if epoch == warm_ep:
            dp.restore_train_augment()
            if self.focal_fn is not None:
                lossfn = self.focal_fn
            if log and mixup_on:
                self.logger.both("Mixup start up")
        mixup_active = mixup_on and warm_ep <= epoch < warm_ep + self.mixup_duration
        if log and mixup_on and epoch == warm_ep + self.mixup_duration:
            self.logger.both("Mixup end")
        dp.auto_aug_weaken(epoch, milestone=aug_epoch)
        if self.prog_learn:
            for node, size in zip(self.resize_chnodes, self.imgsz_milestone):
                if epoch == node:
                    if dp.set_train_size(size) and self.device_augment_fn is not None:
                        # a lifted random_crop carries a static size: rebuild the
                        # stage and drop the cached steps that hold the old one
                        self.device_augment_fn = make_device_augment(
                            dp.device_augment_cfg, group_size=self.device_augment_group_size)
                        self._step_cache.clear()
                    if log:
                        self.logger.both(f"progressive resize -> {size}")
        return lossfn, mixup_active

    # --------------------------------------------------------- classification

    def run_classifier(self, resume: Optional[str] = None) -> Dict[str, Any]:
        hyp, data_cfg = self.hyp_cfg, self.data_cfg
        epochs = hyp["epochs"]
        aug_epoch = data_cfg["train"].get("aug_epoch", epochs)
        logger = self.logger
        dp = self.data_processor

        train_loader = self._train_loader()
        val_loader = dp.dataloader("val", data_cfg["val"]["bs"])
        self.mesh.check_replicated_eval(shuffle=bool(val_loader.shuffle),
                                        process_sharded=int(val_loader.process_count) > 1, logger=logger)
        steps_per_epoch = max(len(train_loader), 1)
        _, table = tell_data_distribution({"train": dp.train_dataset, "val": dp.val_dataset})
        if self.model_cfg["num_classes"] <= 50:
            logger.both("\n" + table)
        else:
            logger.log("\n" + table)

        tx = build_tx(hyp, steps_per_epoch, discrete_per_epoch=True, model_cfg=self.model_cfg)
        # the train step draws its dropout seeds from this generator; checkpoints carry its state
        state = create_train_state(self.model, tx, torch.Generator().manual_seed(self.seed + 1))

        best_fitness, start_epoch = 0.0, 0
        if resume:
            state, meta = self.ckpt.restore(resume, state)
            start_epoch = meta["epoch"] + 1
            best_fitness = meta["best_fitness"]
            logger.both(f"resume: {resume} (epoch {start_epoch})")
            if meta.get("meta_missing"):
                logger.both(
                    f"WARNING resume: {resume} has no meta.json — epoch and "
                    "best_fitness are unknown; restarting the schedule at "
                    "epoch 0 with the restored weights"
                )
        elif self.model_cfg.get("load_from"):
            state = self._apply_load_from(state, self.model_cfg["load_from"])
        if not resume and self.model_cfg.get("convert_npz"):
            state = self._apply_convert_npz(state, self.model_cfg["convert_npz"])
        eval_step = make_eval_step(state.ema_model, self.step_config())

        num_classes = self.model_cfg["num_classes"]
        lossfn = self.lossfn
        logger.both(
            f"device {self.device}, compute {str(self.compute_dtype).replace('torch.', '')}; loaders: train "
            f"{loader_kind(train_loader)} ({len(train_loader)} batches of {data_cfg['train']['bs']}), "
            f"val {loader_kind(val_loader)} ({len(val_loader)} batches of {data_cfg['val']['bs']})"
        )
        logger.console(
            f"{'Epoch':>10}{'train_loss':>12}{'val_loss':>12}{'top1':>10}{'top5':>10}"
            if self.thresh == 0
            else f"{'Epoch':>10}{'train_loss':>12}{'val_loss':>12}{'precision':>12}{'recall':>10}{'f1':>10}"
        )

        # a resumed run replays the strategy of the skipped epochs, so its
        # augment pipeline / focal swap / progressive size match the uninterrupted run's
        for past in range(min(start_epoch, epochs)):
            lossfn, _ = self._epoch_strategy(past, lossfn, aug_epoch, log=False)

        t0 = time.time()
        last_metrics: Dict[str, Any] = {}
        for epoch in range(start_epoch, epochs):
            lossfn, mixup_active = self._epoch_strategy(epoch, lossfn, aug_epoch)
            # device augments are live exactly when the host train augments
            # are: epochs [warm_ep, aug_epoch) (before: val augments, the
            # warm-up; from aug_epoch on: weakened to the val augments)
            dev_aug = self.device_augment_fn is not None and hyp["warm_ep"] <= epoch < aug_epoch
            loss_key = "focal" if lossfn is self.focal_fn else self.loss_choice
            step = self._get_train_step(tx, state, (loss_key, mixup_active, dev_aug), lossfn, dev_aug,
                                        mixup=mixup_active)

            train_loader.set_epoch(epoch)
            epoch_t0 = time.time()
            n_images = 0
            # losses stay on the device; ONE host read per epoch. A per-step
            # .item() would sync the host with the card every step.
            step_losses = []
            for i, batch in enumerate(DevicePrefetcher(train_loader, self.device, self.device_prefetch_depth)):
                lam = self.mixup_lambda(epoch, i) if mixup_active else 0.0
                step_losses.append(step(state, batch, lam)["loss"])
                n_images += batch["image"].shape[0]
            tloss = torch.stack(step_losses).mean().item() if step_losses else 0.0
            epoch_secs = time.time() - epoch_t0
            rate = n_images / max(epoch_secs, 1e-9)

            val_metrics = cls_eval.valuate(
                eval_step, val_loader, num_classes,
                thresh=self.thresh if self.loss_choice == "bce" else None,
                lossfn=lossfn,
                class_names=dp.val_dataset.class_names,
            )
            fitness = val_metrics["fitness"]
            last_metrics = val_metrics
            self._rank_note(f"epoch {epoch + 1} val fitness {fitness!r}")
            if self.thresh == 0:
                logger.console(
                    f"{epoch + 1:>6}/{epochs:<3}{tloss:>12.4g}"
                    f"{val_metrics.get('v_loss', float('nan')):>12.4g}"
                    f"{val_metrics['top1']:>10.3g}{val_metrics.get('top5', 0.0):>10.3g}"
                )
            else:
                logger.console(
                    f"{epoch + 1:>6}/{epochs:<3}{tloss:>12.4g}"
                    f"{val_metrics.get('v_loss', float('nan')):>12.4g}"
                    f"{val_metrics['precision']:>12.3g}{val_metrics['recall']:>10.3g}"
                    f"{val_metrics['f1score']:>10.3g}"
                )
            logger.log(
                f"epoch:{epoch + 1} t_loss:{tloss:.4f} fitness:{fitness:.4f} imgs/s:{rate:.1f}"
                f" train loader {loader_kind(train_loader)}"
            )
            if self.metrics_writer is not None:
                w = self.metrics_writer
                w.add_scalar("Train_loss", tloss, epoch)
                w.add_scalar("Train_images_per_sec", rate, epoch)
                w.add_scalar("Train_lr", logged_lr(tx, state.step), epoch)
                for k in ("top1", "top5", "precision", "recall", "f1score", "v_loss"):
                    if k in val_metrics:
                        w.add_scalar(f"Val_{k}", float(val_metrics[k]), epoch)
                w.flush()

            self.ckpt.save("last", state, epoch, max(best_fitness, fitness))
            if fitness > best_fitness:
                best_fitness = fitness
                self.ckpt.save("best", state, epoch, best_fitness)

        self.ckpt.wait()  # join the in-flight writes before reporting done
        hours = (time.time() - t0) / 3600
        logger.both(f"\n{epochs - start_epoch} epochs completed in {hours:.3f} hours.")
        self._validate_hint()
        return {"best_fitness": best_fitness, **last_metrics}

    # ------------------------------------------------------------ embedding

    def run_embedding(self, resume: Optional[str] = None, save_freq: int = 1, print_freq: int = 50) -> Dict[str, Any]:
        hyp, data_cfg = self.hyp_cfg, self.data_cfg
        epochs = hyp["epochs"]
        logger = self.logger
        dp = self.data_processor

        train_loader = self._train_loader()
        steps_per_epoch = max(len(train_loader), 1)
        # the schedule steps per batch (vision_engine.py:486-489)
        tx = build_tx(hyp, steps_per_epoch, discrete_per_epoch=False, model_cfg=self.model_cfg)
        state = create_train_state(self.model, tx, torch.Generator().manual_seed(self.seed + 1))

        best_fitness, start_epoch = 0.0, 0
        if resume:
            state, meta = self.ckpt.restore(resume, state)
            start_epoch = meta["epoch"] + 1
            best_fitness = meta.get("best_fitness", 0.0)
            logger.both(f"resume: {resume} (epoch {start_epoch})")
            if meta.get("meta_missing"):
                logger.both(
                    f"WARNING resume: {resume} has no meta.json — epoch and "
                    "best_fitness are unknown; restarting the schedule at "
                    "epoch 0 with the restored weights"
                )
        elif self.model_cfg.get("load_from"):
            state = self._apply_load_from(state, self.model_cfg["load_from"])
        if not resume and self.model_cfg.get("convert_npz"):
            state = self._apply_convert_npz(state, self.model_cfg["convert_npz"])
        embed_step = make_embed_step(state.ema_model, self.step_config())

        # no warm-up or weakening of the augments (vision_engine.py:438-561):
        # the device-augment stage is live in every epoch; no mixup (λ = 0)
        dev_aug = self.device_augment_fn is not None
        step = self._get_train_step(tx, state, ("embed", False, dev_aug), self.lossfn, dev_aug, mixup=False)
        logger.both(
            f"device {self.device}, compute {str(self.compute_dtype).replace('torch.', '')}; loaders: train "
            f"{loader_kind(train_loader)} ({len(train_loader)} batches of {data_cfg['train']['bs']})"
        )
        loss_meter = AverageMeter()
        fitness_metrics: Dict[str, Any] = {}
        for epoch in range(start_epoch, epochs):
            train_loader.set_epoch(epoch)
            loss_meter.reset()
            epoch_t0 = time.time()
            n_images = 0
            pending = []  # device losses, read at print_freq and at the epoch's end
            for i, batch in enumerate(DevicePrefetcher(train_loader, self.device, self.device_prefetch_depth)):
                rows = batch["image"].shape[0]
                pending.append((step(state, batch, 0.0)["loss"], rows))
                n_images += rows
                if (i + 1) % print_freq == 0:
                    for dev_loss, n in pending:
                        loss_meter.update(float(dev_loss), n=n)
                    pending.clear()
                    steps_done = epoch * steps_per_epoch + i + 1
                    lr = logged_lr(tx, steps_done)
                    logger.console(f"epoch:{epoch + 1}/{epochs} batch:{i + 1} loss:{loss_meter.avg:.4f} lr:{lr:.3g}")
                    if self.metrics_writer is not None:
                        self.metrics_writer.add_scalar("Train_loss", loss_meter.avg, steps_done)
                        self.metrics_writer.add_scalar("Train_lr", lr, steps_done)
            for dev_loss, n in pending:
                loss_meter.update(float(dev_loss), n=n)
            rate = n_images / max(time.time() - epoch_t0, 1e-9)
            logger.both(f"epoch:{epoch + 1}/{epochs} loss:{loss_meter.avg:.4f} imgs/s:{rate:.1f}")
            if self.metrics_writer is not None:
                self.metrics_writer.add_scalar("Train_epoch_loss", loss_meter.avg, epoch)
                self.metrics_writer.add_scalar("Train_images_per_sec", rate, epoch)

            if (epoch + 1) % save_freq == 0 or epoch == epochs - 1:
                fitness_metrics = self._eval_embedding(embed_step)
                # the pair-verification mean (face) or the first retrieval metric (CBIR)
                fitness = float(fitness_metrics["mean"] if "mean" in fitness_metrics
                                else next(iter(fitness_metrics.values())))
                logger.both(fitness_metrics)
                self._rank_note(fitness_metrics)
                if self.metrics_writer is not None:
                    for k, v in fitness_metrics.items():
                        self.metrics_writer.add_scalar(f"Val_{k}", float(v), epoch)
                    self.metrics_writer.flush()
                self.ckpt.save(f"Epoch_{epoch + 1}", state, epoch, max(best_fitness, fitness),
                               extra={"fitness": {k: float(v) for k, v in fitness_metrics.items()}})
                if fitness > best_fitness:
                    best_fitness = fitness
                    self.ckpt.save("best", state, epoch, best_fitness)
                self.ckpt.save("last", state, epoch, best_fitness)
        self.ckpt.wait()  # join the in-flight writes before reporting done
        self._validate_hint()
        return fitness_metrics

    def _eval_embedding(self, embed_step: Callable) -> Dict[str, Any]:
        """The embedding task's evaluation with ``embed_step`` (the EMA
        module's during training): ``{"mean", "std"}`` of the 10-fold pair
        accuracy for face, the retrieval metrics for CBIR."""
        self.mesh.check_replicated_eval(logger=self.logger)
        val_aug = create_aug_transforms(self.data_cfg["val"]["augment"])
        if self.task == "face":
            mean, sem = face_eval.valuate(
                embed_step, self.data_cfg["val"]["pair_txt"], self.data_cfg["root"], val_aug,
                batch_size=self.data_cfg["val"]["bs"],
            )
            return {"mean": mean, "std": sem}
        query, gallery = CBIRDatasets.build(self.data_cfg["root"], transforms=val_aug)
        mcfg = self.data_cfg["val"].get("metrics", {})
        return cbir_eval.valuate(
            embed_step, query, gallery,
            batch_size=self.data_cfg["val"]["bs"],
            metrics=mcfg.get("metrics", ["mrr", "recall", "precision", "auc", "ndcg"]),
            cutoffs=mcfg.get("cutoffs", [1, 3, 5]),
            # approximate search when the config asks for it; the gallery sharded over the data ranks
            recall_target=mcfg.get("recall_target"),
            mesh=self.mesh if self.mesh.world > 1 else None,
            # not used in training (the model changes every epoch) unless the config forces it
            gallery_cache=self.data_cfg["val"].get("embedding_cache"),
            device=self.device,
        )

    # ------------------------------------------------------- initialisation

    def _apply_convert_npz(self, state: TrainState, path: str) -> TrainState:
        """Initialise from a converted ``.npz`` (the JAX package's
        ``save_converted`` format); a backbone-only file lands under the
        classification model's ``backbone``. The EMA restarts from the
        loaded weights."""
        tree = load_converted(path)
        prefix = "backbone/" if hasattr(self.model, "backbone") else ""
        tree = {t: {prefix + p: v for p, v in flat.items()} for t, flat in tree.items()}
        merge_converted(self.model, tree, logger=self.logger)
        state.ema_model.load_state_dict(self.model.state_dict())
        return state

    def _apply_load_from(self, state: TrainState, path: str) -> TrainState:
        """Fine-tune from another run's checkpoint dir: its EMA weights only,
        merged by key and shape (the saving run's optimizer need not match
        this run's); the EMA restarts from them. A margin head's weight
        loads only from a checkpoint with exactly this head's ``num_class``
        columns (the JAX ``head_classes`` rule; the port's heads hold no pad
        columns, so that is the shape match)."""
        path = Path(path)
        source = CheckpointManager(path.parent).read(path.name)["ema"]
        merged = CheckpointManager.load_from(full_state_dict(self.model), source, logger=self.logger, prefix="ema ")
        load_full_state_dict(self.model, merged)
        load_full_state_dict(state.ema_model, merged)
        self.logger.both(f"load_from: {path}")
        return state
