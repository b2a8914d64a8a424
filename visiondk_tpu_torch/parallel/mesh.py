"""Process groups for data-parallel training and the class-sharded margin
head (counterpart of ``visiondk_tpu/parallel/mesh.py``).

The JAX package lays its devices out as one ``('data', 'model')`` mesh; here
the same layout is a set of ``torch.distributed`` process groups, one process
a device:

- every rank loads its own rows of the global batch (``data.train.bs`` is
  the global batch; rank r feeds ``bs / W`` rows), so the batch is split over
  all W ranks. Parameters that every rank holds are averaged over the world
  by ``DistributedDataParallel``;
- ``model`` = m splits the margin head's classes (partial-FC): ranks form
  W/m *model groups* of m consecutive ranks, and rank r holds class shard
  ``r % m`` of ``torch.tensor_split(weight, m, dim=1)``. The m ranks of a
  model group gather their features and labels, and each scores the group's
  rows against its shard. The W/m ranks that hold the same shard form a
  *data group*, over which the shard's gradients are summed.

Gradients follow one rule: each rank backpropagates its own loss (the loss
of its rows, or of its model group's rows for the sharded head), every
collective on the way is differentiable with a summed backward, and a
parameter's gradient is summed over the ranks that hold it and divided by W
(DDP does that for the replicated parameters; ``engine/steps.py`` for the
shards). The global loss is the mean of the ranks' losses.

Rank-0-only host work (logs, ``metrics.jsonl``, checkpoints) reads
``MeshContext.is_primary()``. The TPU-only parts of the JAX module (the
published current mesh and the ``shard_map`` wraps of the Pallas kernels) have
no counterpart: a CUDA kernel runs on its rank's tensors.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn

# torchrun's environment, and the JAX package's names for the same three facts
_TORCHRUN = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
_VDK = ("VDK_COORDINATOR_ADDRESS", "VDK_NUM_PROCESSES", "VDK_PROCESS_ID")


def _log(logger, msg: str) -> None:
    if logger is not None:
        logger.both(msg) if hasattr(logger, "both") else logger.info(msg)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    logger=None,
) -> bool:
    """Join the process group of a multi-process run (the JAX
    ``initialize_distributed``; the reference's ``init_process_group``).

    The coordinates come from the arguments, else torchrun's environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), else the
    JAX package's (``VDK_COORDINATOR_ADDRESS`` as ``host:port``,
    ``VDK_NUM_PROCESSES``, ``VDK_PROCESS_ID``). The backend is ``backend``,
    else NCCL where CUDA is available and gloo otherwise. With NCCL the rank
    takes ``cuda:LOCAL_RANK`` (``LOCAL_RANK`` defaults to 0) as its device.

    Returns True when the group was newly joined. A second call is a logged
    no-op. With no argument and no cluster environment it logs that the run
    is single-process and returns False. Anything else that goes wrong
    raises: a run asked to be distributed never trains alone.
    """
    if dist.is_initialized():
        _log(logger, "torch.distributed already initialized; skipping")
        return False
    env = os.environ
    if coordinator_address is None:
        if env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        else:
            coordinator_address = env.get("VDK_COORDINATOR_ADDRESS") or None
    if num_processes is None:
        count = env.get("WORLD_SIZE") or env.get("VDK_NUM_PROCESSES")
        num_processes = int(count) if count else None
    if process_id is None:
        index = env.get("RANK") or env.get("VDK_PROCESS_ID")
        process_id = int(index) if index else None
    given = (coordinator_address, num_processes, process_id)
    if all(v is None for v in given):
        _log(logger, "no cluster environment detected; running single-process")
        return False
    if any(v is None for v in given):
        raise ValueError(
            "distributed bring-up needs the coordinator address, the process count and this process's "
            f"index; got address={coordinator_address!r}, count={num_processes!r}, index={process_id!r} "
            f"(torchrun sets {', '.join(_TORCHRUN)}; or set {', '.join(_VDK)})")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process index {process_id} is outside a world of {num_processes}")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if backend == "nccl":
        local = torch.device("cuda", int(env.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(local)
        kwargs["device_id"] = local
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(minutes=10), **kwargs)
    _log(logger, f"torch.distributed initialized ({backend}): process {dist.get_rank()}/{dist.get_world_size()}")
    return True


def shard_ranges(num_class: int, n_model: int) -> List[Tuple[int, int]]:
    """The column range [lo, hi) of each class shard: ``torch.tensor_split``'s
    split of ``num_class`` into ``n_model`` parts (the first ``num_class %
    n_model`` one column wider)."""
    base, extra = divmod(num_class, n_model)
    bounds = [0]
    for j in range(n_model):
        bounds.append(bounds[-1] + base + (j < extra))
    return list(zip(bounds[:-1], bounds[1:]))


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class _GatherRows(torch.autograd.Function):
    """Rows of every rank of ``group`` stacked in rank order; the backward
    sums the gradient over the group and returns this rank's rows (the
    transpose of the gather). Built on all_gather and all_reduce only, which
    gloo runs on CUDA tensors too."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group, index: int, size: int) -> torch.Tensor:
        ctx.group, ctx.rows, ctx.index = group, x.shape[0], index
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad[ctx.index * ctx.rows: (ctx.index + 1) * ctx.rows], None, None, None


class MeshContext:
    """The run's layout: W ranks (1 without a process group), ``n_model`` = m
    ranks a model group, ``n_data`` = W / m; the model and data groups of
    this rank (None where one has a single rank) and the collectives the
    train step and the sharded head use. Every collective is the identity in
    a one-process run, and runs in a process group of one (bit-exact there).

    A model holding the context keeps it through ``copy.deepcopy`` (the EMA
    copy): it is a handle to the process's groups, not a value."""

    def __init__(self, model: int = 1):
        self.distributed = dist.is_available() and dist.is_initialized()
        self.world = dist.get_world_size() if self.distributed else 1
        self.rank = dist.get_rank() if self.distributed else 0
        model = int(model)
        if model < 1 or self.world % model:
            raise ValueError(f"model_parallel {model} must divide the world size {self.world}")
        self.n_model, self.n_data = model, self.world // model
        self.model_group = self.data_group = None
        self._wrapped = {}
        if self.distributed:
            # every rank creates every group, in the same order (new_group is collective)
            if model > 1:
                for g in range(self.n_data):
                    ranks = list(range(g * model, (g + 1) * model))
                    group = dist.new_group(ranks)
                    if self.rank in ranks:
                        self.model_group = group
            if model > 1 and self.n_data > 1:
                for j in range(model):
                    ranks = list(range(j, self.world, model))
                    group = dist.new_group(ranks)
                    if self.rank in ranks:
                        self.data_group = group

    def __deepcopy__(self, memo) -> "MeshContext":
        return self

    def data_parallel(self, model: torch.nn.Module) -> torch.nn.Module:
        """``model`` wrapped in ``DistributedDataParallel`` over the world
        (one wrapper a model, made at the first call and kept), the
        class-sharded head's weight left out of it: DDP would average
        different shards (its gradients are summed over the data group by the
        train step). ``model`` itself in a one-process run. Buffers are not
        broadcast: every rank's BatchNorm statistics come from the same global
        moments."""
        if not self.distributed:
            return model
        if id(model) not in self._wrapped:
            from torch.nn.parallel import DistributedDataParallel

            from visiondk_tpu_torch.engine.state import class_sharded_names

            DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(model, class_sharded_names(model))
            device = next(model.parameters()).device
            self._wrapped[id(model)] = DistributedDataParallel(
                model, device_ids=[device.index] if device.type == "cuda" else None, broadcast_buffers=False)
        return self._wrapped[id(model)]

    def __repr__(self) -> str:
        return f"MeshContext(world={self.world}, rank={self.rank}, data={self.n_data}, model={self.n_model})"

    @property
    def model_index(self) -> int:
        """This rank's class shard, and its place in its model group."""
        return self.rank % self.n_model

    @property
    def data_index(self) -> int:
        """This rank's place in its data group (the ranks that hold the same
        class shard), and its shard of a sharded gallery search."""
        return self.rank // self.n_model

    def is_primary(self) -> bool:
        return self.rank == 0

    def check_replicated_eval(self, shuffle: bool = False, process_sharded: bool = False, logger=None) -> None:
        """Evaluation is replicated: every rank runs the whole val set on
        an unsharded, unshuffled loader (identical metrics on every rank), and
        only rank 0 writes. Raises where a loader breaks that."""
        if self.world <= 1:
            return
        if shuffle or process_sharded:
            raise ValueError(
                "distributed eval must be replicated: eval loaders may not shuffle "
                f"(got shuffle={shuffle}) or shard by process (got process_sharded={process_sharded})")
        if self.is_primary():
            _log(logger, f"distributed: eval replicated across {self.world} processes "
                         "(identical inputs, rank-0-only artifacts)")

    # ------------------------------------------------------------ collectives

    def barrier(self) -> None:
        if self.distributed:
            dist.barrier()

    def world_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over all ranks, without gradient."""
        if not self.distributed:
            return t
        t = t.detach().clone()
        dist.all_reduce(t)
        return t

    def world_mean(self, t: torch.Tensor) -> torch.Tensor:
        """Mean over all ranks, without gradient (the global loss from the ranks')."""
        return self.world_sum(t) / self.world if self.distributed else t

    def world_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's rows in rank order (the global batch), without gradient."""
        if not self.distributed:
            return t
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts)

    def own_rows(self, full: torch.Tensor, rows: int) -> torch.Tensor:
        """This rank's ``rows`` of a global batch stacked in rank order."""
        return full[self.rank * rows: (self.rank + 1) * rows]

    def model_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The rows of the model group's ranks in rank order; the backward
        returns this rank's rows of the group's summed gradient."""
        if self.model_group is None:
            return t
        return _GatherRows.apply(t, self.model_group, self.model_index, self.n_model)

    def model_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the model group; the backward sums the gradient too."""
        if self.model_group is None:
            return t
        return dist_fn.all_reduce(t, group=self.model_group)

    def model_max(self, t: torch.Tensor) -> torch.Tensor:
        """Maximum over the model group, without gradient."""
        if self.model_group is None:
            return t
        t = t.detach().clone()
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.model_group)
        return t

    def model_cat(self, shard: torch.Tensor, widths: List[int]) -> torch.Tensor:
        """The model group's column shards ([rows, widths[j]] on shard j)
        joined along dim 1, without gradient. Shards of unequal width are
        padded to the widest for the gather and trimmed after."""
        if self.model_group is None:
            return shard
        wide = max(widths)
        padded = torch.zeros((*shard.shape[:1], wide, *shard.shape[2:]), dtype=shard.dtype, device=shard.device)
        padded[:, : shard.shape[1]] = shard
        parts = [torch.empty_like(padded) for _ in range(self.n_model)]
        dist.all_gather(parts, padded, group=self.model_group)
        return torch.cat([p[:, :w] for p, w in zip(parts, widths)], dim=1)

    def data_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The data group's tensors stacked in rank order, [n_data, *t.shape],
        without gradient (the world's where ``n_model`` is 1)."""
        if self.n_data == 1:
            return t[None]
        parts = [torch.empty_like(t) for _ in range(self.n_data)]
        dist.all_gather(parts, t.contiguous(), group=self.data_group)
        return torch.stack(parts)

    def data_sum_(self, tensors: List[torch.Tensor]) -> None:
        """Sum each tensor in place over this rank's data group (the ranks
        that hold the same class shard)."""
        if self.data_group is None:
            return
        for t in tensors:
            dist.all_reduce(t, group=self.data_group)


def build_mesh(model: int = 1) -> MeshContext:
    """The run's layout over the processes of the current group (one
    process without one): pure data parallelism by default, ``model`` > 1
    for the class-sharded margin head (it must divide the world size)."""
    return MeshContext(model=model)
