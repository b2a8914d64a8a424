"""Train, eval and embed steps (counterpart of ``visiondk_tpu/engine/steps.py``).

``make_train_step`` returns ``step(state, batch, lam=0.0)`` for
``{"image": uint8 [B, H, W, 3], "label": int [B] or f32 [B, C]}``: the JAX
step's chain, uint8 batch → the device-augment stage where one is given →
normalise on the device → forward in train mode
→ loss → backward → clip → optimizer → EMA, run eagerly and in place on the
state (see ``make_train_step``). Ported: the plain classification variant,
the embedding task (``task="embedding"``: the model's margin head gives
``(logits, aux)`` and the loss is ``lossfn(logits, labels) + aux``), mixup
(``cfg.mixup``: the batch mixed with a permutation of itself at weight
``lam``, the loss ``lam·L(y) + (1 − lam)·L(y[perm])``) and OHEM
(``cfg.ohem``: a per-sample weight from a no-grad forward of the clean batch,
``ohem_mask``), alone or together, and gradient accumulation (the optimizer's
``accumulate``: the EMA ticks only on the mini-steps that apply an update),
and SAM (``cfg.sam``: a second forward/backward at w + e(w); with more than
one rank and ``local_perturb``, e from each rank's own gradient). Under a
process group (``mesh``) the step is DDP over the ranks' rows of the global
batch and computes what the JAX step computes on that global batch.

``make_eval_step`` and ``make_embed_step`` return callables ``step(batch)``
that take ``{"image": uint8 [B, H, W, 3]}``, move it to the model's device
and run ``ServingModel`` (normalise, forward) in eval mode under
``torch.inference_mode()``; ``export`` traces the same module.
The module carries its own weights, so where the JAX steps choose
``state.params`` or ``state.ema_params`` (``use_ema``), the caller passes
the module it wants served (``state.model`` or ``state.ema_model``). With
``quant="int8"`` every dense layer computes in int8 (``ops/quant.py``),
from ``quant_cache`` where the caller built one from the served module.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from visiondk_tpu_torch.engine.optim import OptimizerSpec, OptState, SAMConfig, sam_perturb
from visiondk_tpu_torch.engine.state import TrainState
from visiondk_tpu_torch.models.ema import update_ema
from visiondk_tpu_torch.models.layers import local_batch_moments
from visiondk_tpu_torch.ops.quant import check_quant, dense_layers, quantized
from visiondk_tpu_torch.parallel.mesh import MeshContext


@dataclasses.dataclass(frozen=True)
class OHEMConfig:
    min_kept: int = 8
    thresh: float = 0.7
    ignore_index: int = 255


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Static configuration of a step variant."""

    task: str = "classification"        # "classification" | "embedding"
    mixup: bool = False
    sam: Optional[SAMConfig] = None
    ohem: Optional[OHEMConfig] = None
    ema_decay: float = 0.9999
    ema_tau: float = 2000.0
    mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: Tuple[float, float, float] = (0.229, 0.224, 0.225)


def device_preprocess(images: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """uint8 NHWC → normalised f32 NHWC, on the images' device."""
    if images.dtype == torch.uint8:
        images = images.to(torch.float32) / 255.0
    mean_t = torch.as_tensor(mean, dtype=torch.float32, device=images.device)
    std_t = torch.as_tensor(std, dtype=torch.float32, device=images.device)
    return (images - mean_t) / std_t


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def ohem_mask(logits: torch.Tensor, labels: torch.Tensor, cfg: OHEMConfig, mesh=None) -> torch.Tensor:
    """Keep the samples whose true-class probability is below max(the k-th
    smallest of them, ``thresh``), k = ``min_kept`` (at most B − 1), and
    whose label is not ``ignore_index``: an f32 weight [B] of 0s and 1s (the
    JAX ``ohem_mask``). An ignored label's probability is never read. With a
    distributed ``mesh`` the k-th smallest is the global batch's (every
    rank's probabilities gathered), as the JAX step's over its sharded batch."""
    probs = torch.softmax(logits.float(), dim=1)
    index = labels.long().clamp(0, probs.shape[1] - 1)  # ignored labels may lie past the classes
    tp = probs.gather(1, index[:, None])[:, 0]
    valid = labels != cfg.ignore_index
    keyed = torch.where(valid, tp, torch.inf)
    if mesh is not None:
        keyed = mesh.world_rows(keyed)
    sorted_tp = torch.sort(keyed).values
    threshold = sorted_tp[min(cfg.min_kept, keyed.shape[0] - 1)].clamp_min(cfg.thresh)
    return (valid & (tp < threshold)).float()


def rank_seed(seed: int, rank: int) -> int:
    """The dropout seed of ``rank`` from the step's seed (the JAX step's
    ``fold_in(key, axis_index('data'))``): rank 0 keeps it, so a run of one
    process draws the masks of a run without a process group."""
    return (seed + rank * 0x9E3779B97F4A7C15) % 2**62


def mixup_permutation(batch: int, generator: torch.Generator) -> torch.Tensor:
    """The rows each row is mixed with: a permutation drawn from the step's
    generator (on the CPU), so a seeded or resumed run draws the same ones."""
    return torch.randperm(batch, generator=generator)


@contextlib.contextmanager
def _buffers_kept(model: nn.Module):
    """Restores every buffer of ``model`` on exit: a train-mode forward that
    must not update the BatchNorm statistics (flax's ``mutable=False``)."""
    saved = [b.clone() for b in model.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, kept in zip(model.buffers(), saved):
                b.copy_(kept)


def make_train_step(
    model: nn.Module,
    tx: OptimizerSpec,
    lossfn: Callable,
    cfg: StepConfig,
    generator: torch.Generator,
    device_augment: Optional[Callable[[int, torch.Tensor], torch.Tensor]] = None,
    mesh: Optional[MeshContext] = None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build ``step(state, batch, lam=0.0) -> {"loss": f32 scalar tensor}``.

    Each call, on ``state.model`` (which must be ``model``): train mode,
    normalise the uint8 batch on the model's device, forward, ``lossfn``,
    backward, then ``tx.update`` (clip, schedules, optimizer step; with
    accumulation, one update every ``accumulate`` calls) and, where an update
    was applied, the EMA update, and ``state.step += 1`` (for
    ``task="embedding"`` the forward is ``model(images, labels)``, the margin
    head's ``(logits, aux)``, and the loss ``lossfn(logits, labels) + aux``).
    The state is updated in place; the clipped gradients stay in ``.grad``
    until the next call clears them.
    Dropout and DropPath draw from a seed taken from ``generator`` (a CPU
    ``torch.Generator``) on every call (the JAX step folds the step into its
    key), so two runs from the same generator state draw the same masks.
    ``device_augment`` (``ops/device_augment.make_device_augment``) runs on
    the uint8 batch on the model's device before normalisation, seeded by a
    second draw from ``generator`` after the dropout seed's: a checkpoint
    carries the generator, so a resumed run draws the same augments.
    With ``cfg.ohem`` the step first runs the model on the clean batch in
    train mode without gradient (the same dropout draws as the loss forward,
    the BatchNorm statistics left as they were) and weights the loss by
    ``ohem_mask`` of those logits. With ``cfg.mixup`` the images become
    ``lam·x + (1 − lam)·x[perm]`` (``perm`` from ``mixup_permutation``, drawn
    after the dropout and augment seeds) and the loss ``lam·L(y) + (1 −
    lam)·L(y[perm])``, both terms with the OHEM weight; ``lam`` and ``1 −
    lam`` are taken in f32, as the JAX step's traced scalar.
    With ``cfg.sam`` the first backward's gradients g give the ascent
    e = ``sam_perturb``(w, g); the step adds e to the parameters, runs the
    same forward and backward again (the same images, labels, OHEM weight,
    mixup λ and permutation, and dropout seed) with every buffer kept as the
    first pass left it (the BatchNorm statistics are the clean pass's), and
    restores the parameters from a copy, bit for bit; the update then runs
    on the second gradients, and the loss reported is the first pass's.

    Distributed (``mesh`` over a process group; ``engine/trainer.py`` passes
    the run's): ``batch`` is this rank's rows of the global batch, which is
    every rank's rows in rank order, and the step computes the JAX step on
    that global batch. The forward and backward run through
    ``mesh.data_parallel(model)`` (DDP: the replicated gradients averaged
    over the ranks); a class-sharded head's gradients are summed over the
    data group and divided by W here. Where the JAX step is global over the
    batch the step is too: the device-augment stage and mixup run on the
    gathered global batch (the same draws on every rank) and each rank keeps
    its rows; OHEM's k-th smallest probability and its loss's denominator
    are the global batch's; BatchNorm takes the global moments (SyncBN,
    ``models/layers.py``). Dropout draws from ``rank_seed``. The loss
    returned is the global batch's (the mean of the ranks'). SAM with
    ``cfg.sam.local_perturb``, more than one rank and no class sharding takes
    the JAX step's per-rank form (``_sam_local_grads``): the first backward
    without synchronisation, e from the rank's own gradient, BatchNorm on the
    rank's own moments in both passes (then the running statistics averaged
    over the ranks), the loss the rank's own (its mean reported), the second
    gradients averaged. Otherwise e is the global one.
    """
    device = _device(model)
    distributed = mesh is not None and mesh.distributed
    net = mesh.data_parallel(model) if distributed else model
    rank = mesh.rank if distributed else 0
    sam_local = (cfg.sam is not None and cfg.sam.local_perturb and distributed and mesh.world > 1
                 and mesh.n_model == 1)
    # the global batch on every rank where a draw spans it
    global_view = distributed and (device_augment is not None or cfg.mixup)

    def finish_grads(opt: OptState) -> None:
        # the class-sharded head: summed over the ranks that hold the shard, / W
        if distributed and opt.sharded is not None:
            shards = [p.grad for p, sharded in zip(opt.params, opt.sharded) if sharded and p.grad is not None]
            mesh.data_sum_(shards)
            torch._foreach_div_(shards, float(mesh.world))

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor], lam: float = 0.0):
        if state.model is not model:
            raise ValueError("the state holds another model than the one this step was built for")
        model.train()
        images = batch["image"].to(device, non_blocking=True)
        labels = batch["label"].to(device, non_blocking=True)
        rows = images.shape[0]
        seed = rank_seed(int(torch.randint(0, 2**62, (), generator=generator)), rank)
        if global_view:
            images = mesh.world_rows(images)
        if device_augment is not None:
            images = device_augment(int(torch.randint(0, 2**62, (), generator=generator)), images)
        images = device_preprocess(images, cfg.mean, cfg.std)
        perm = mixup_permutation(images.shape[0], generator).to(device) if cfg.mixup else None
        everyone = images
        if global_view:
            images = mesh.own_rows(everyone, rows)
        params = list(model.parameters())
        for p in params:
            p.grad = None
        with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
            loss_of = lossfn
            if cfg.ohem is not None:
                # the mask from the CLEAN images, before any mixing
                torch.manual_seed(seed)
                with torch.no_grad(), _buffers_kept(model):
                    sw = ohem_mask(model(images), labels, cfg.ohem, mesh if distributed else None)
                scale = 1.0
                if distributed and not sam_local:
                    # Σ w·l / max(Σ w, 1) over the global batch: this rank's share, × W
                    kept = sw.sum()
                    scale = mesh.world * kept.clamp_min(1.0) / mesh.world_sum(kept).clamp_min(1.0)
                loss_of = lambda logits, y: scale * lossfn(logits, y, sw)  # noqa: E731
            if cfg.mixup:
                lam32 = np.float32(lam)
                rest = np.float32(1.0) - lam32
                shuffled = everyone[perm]
                labels_b = (mesh.world_rows(labels) if global_view else labels)[perm]
                if global_view:
                    shuffled, labels_b = mesh.own_rows(shuffled, rows), mesh.own_rows(labels_b, rows)
                mixed = float(lam32) * images + float(rest) * shuffled

            def forward_loss() -> torch.Tensor:
                torch.manual_seed(seed)
                if cfg.task == "embedding":
                    logits, aux = net(images, labels)
                    return loss_of(logits, labels) + aux
                if cfg.mixup:
                    logits = net(mixed)
                    return float(lam32) * loss_of(logits, labels) + float(rest) * loss_of(logits, labels_b)
                return loss_of(net(images), labels)

            if sam_local:
                with net.no_sync(), local_batch_moments(model):
                    loss = forward_loss()
                    loss.backward()
                for b in model.buffers():  # the clean pass's running statistics, averaged
                    if b.is_floating_point():
                        b.copy_(mesh.world_mean(b))
            else:
                loss = forward_loss()
                loss.backward()
                finish_grads(state.optimizer)
            if cfg.sam is not None:
                clean = [p.detach().clone() for p in params]
                grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
                # a class-sharded head's squares count once over its model group
                shard = {} if sam_local or state.optimizer.mesh is None else {"state": state.optimizer}
                with torch.no_grad():
                    torch._foreach_add_(params, sam_perturb(params, grads, cfg.sam, **shard))
                del grads
                for p in params:
                    p.grad = None
                with _buffers_kept(model), local_batch_moments(model) if sam_local else contextlib.nullcontext():
                    forward_loss().backward()
                finish_grads(state.optimizer)
                with torch.no_grad():
                    torch._foreach_copy_(params, clean)
                del clean
        apply_update(state, tx, cfg)
        loss = loss.detach()
        return {"loss": mesh.world_mean(loss) if distributed else loss}

    return step_fn


def apply_update(state: TrainState, tx: OptimizerSpec, cfg: StepConfig) -> None:
    """The end of every train step, from the gradients in ``.grad``: the
    optimizer update (clip, schedules, step; with accumulation, only on the
    mini-step that completes it), the EMA update where one was applied (the
    EMA ticks on applied updates, or its horizon would shrink k-fold), step
    += 1."""
    if tx.update(state.optimizer):
        state.ema_updates += 1
        update_ema(state.ema_model, state.model, state.ema_updates, cfg.ema_decay, cfg.ema_tau)
    state.step += 1


def _serving(model: nn.Module, quant: Optional[str], quant_cache: Optional[dict]) -> Callable:
    """The context a serving step runs its forward in: inference mode, and
    with ``quant="int8"`` every dense layer in int8 (``ops/quant.py``; the
    JAX ``_inference_apply``). ``quant_cache`` (``build_weight_cache`` of
    the served module) skips the per-call weight quantization; training-time
    evaluation passes none."""
    quant = check_quant(quant)  # a typo ('int4') raises
    layers = dense_layers(model) if quant else None

    @contextlib.contextmanager
    def serving():
        with torch.inference_mode(), quantized(model, quant_cache, layers) if quant else contextlib.nullcontext():
            yield

    return serving


class ServingModel(nn.Module):
    """The served forward of a model: uint8 [B, H, W, 3] images → f32 logits
    [B, num_classes], or (``embed``) the L2-normalised f32 embeddings
    [B, feat_dim], ``x / max(‖x‖, 1e-12)``; normalised with ``cfg``'s mean
    and std on the images' device. The eval and embed steps call it, and
    ``export`` traces it, so the two cannot drift apart. It runs in the
    caller's grad mode and train/eval mode (the steps set both)."""

    def __init__(self, model: nn.Module, cfg: StepConfig, embed: bool = False):
        super().__init__()
        self.model = model
        self.mean, self.std, self.embed = tuple(cfg.mean), tuple(cfg.std), embed

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = device_preprocess(images, self.mean, self.std)
        if not self.embed:
            return self.model(x).to(torch.float32)
        feats = self.model.embed(x).to(torch.float32)
        return feats / torch.linalg.vector_norm(feats, dim=1, keepdim=True).clamp_min(1e-12)


def _serving_step(model: nn.Module, cfg: StepConfig, embed: bool, quant: Optional[str],
                  quant_cache: Optional[dict]) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
    device = _device(model)
    serving = _serving(model, quant, quant_cache)
    served = ServingModel(model, cfg, embed)

    def step_fn(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        model.eval()
        with serving():
            return served(batch["image"].to(device, non_blocking=True))

    return step_fn


def make_eval_step(model: nn.Module, cfg: StepConfig, quant: Optional[str] = None,
                   quant_cache: Optional[dict] = None) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
    """Classification eval: batch → f32 logits [B, num_classes]. Puts
    ``model`` in eval mode on every call (BatchNorm running stats, no
    dropout or DropPath), as the JAX step passes ``train=False``: a train
    step on the same model may have left it in train mode. ``quant`` and
    ``quant_cache``: see ``_serving``."""
    return _serving_step(model, cfg, False, quant, quant_cache)


def make_embed_step(model: nn.Module, cfg: StepConfig, quant: Optional[str] = None,
                    quant_cache: Optional[dict] = None) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
    """Embedding extraction: batch → L2-normalised f32 [B, feat_dim],
    ``x / max(‖x‖, 1e-12)``. Puts ``model`` in eval mode on every call.
    ``quant`` and ``quant_cache``: see ``_serving``."""
    return _serving_step(model, cfg, True, quant, quant_cache)
