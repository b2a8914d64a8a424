"""visiondk-tpu-torch: the PyTorch/CUDA port of ``visiondk_tpu`` for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its module layout
(``models/``, ``engine/``, ``ops/``, ``config/``) so each counterpart is easy
to find. Plain tensor code is PyTorch; every Pallas kernel of the JAX package
becomes a kernel written by hand for ``sm_90a`` under ``csrc/``, built at first
use (``ops/_build.py``) and bound with ctypes.

Slices ported so far, for the ViT family and Swin V1: the serving path
(``engine.steps.make_eval_step`` and ``make_embed_step``) and the
single-label classification train step (``engine.steps.make_train_step``
with ``losses``, ``engine.optim``, ``engine.schedules``, ``models.ema``,
``engine.state`` and ``engine.trainer.build_tx``). Their attention cores are
``ops.attention.fused_qkv_attention`` (ViT) and
``ops.window_attention.fused_window_attention`` (Swin): four CUDA kernels
each (the forward with and without the probability stash, the backward from
the stash and the recompute backward) behind one autograd Function.
``ops.attention.vision_attention`` (q, k, v ``[B, H, N, D]``, which no model
calls, as in the JAX package) runs the ViT forward and recompute-backward
kernels through their strided entries. Models are built on the card unless
the caller passes ``device="cpu"`` to ``models.get_model``.

The classification run loop sits on top: ``config`` (YAML loading and
checks), ``data`` (the host pipeline, byte-identical to the JAX package's,
and the CUDA device feeder), ``engine.checkpoint``, ``engine.evaluation``,
``engine.trainer.CenterProcessor`` and the CLIs ``python -m
visiondk_tpu_torch.main`` / ``.validate``, on the card unless ``--device cpu``.
``parallel`` joins torchrun's process group for ``main --multihost`` (DDP,
SyncBN, and the class-sharded margin head behind ``--model_parallel``).

Importing this package loads torch, numpy and the standard library only: no
JAX, no Triton, and no kernel is built until a CUDA tensor reaches one. The
data modules add PIL; PyYAML is imported when a config is read or written.
"""

from visiondk_tpu_torch.version import __version__

__all__ = ["__version__"]
