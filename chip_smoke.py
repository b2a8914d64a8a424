#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port (visiondk_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line or more each; any failure raises and exits non-zero:

1. device  — needs CUDA (exits non-zero without it); prints the card's name
             and power limit as nvidia-smi reports them; TF32 off for the
             f32 comparisons.
2. build   — compiles the four kernel libraries of visiondk_tpu_torch/csrc/
             (fused QKV attention: forward with optional P stash, both
             backwards; fused window attention: the same two) with nvcc for
             sm_90a into visiondk_tpu_torch/_build/, one nvcc each, all in
             parallel, and prints ptxas' register and spill lines. Reads the
             SASS of the two fused-QKV libraries (cuobjdump): every bf16
             instantiation of the forward, dq and dkv kernels (head-dim
             buckets 32, 64, 80, 128 x variant) must issue tensor-core
             instructions (HMMA, or HGMMA for wgmma), counted per kernel; the
             float32 CUDA-core kernels must have no bf16 instantiation.
3. kernel  — each of the four kernels against its plain PyTorch version on
             the same inputs, at the ViT-B/16 shape and at smaller odd shapes
             (N=37 with a key mask, ViT-B/8's N=785, head dim 80, N=200 whose
             P rows are 16-byte aligned), f32 and
             bf16: the no-stash forward (O), the stash forward (O bit-equal to
             the no-stash kernel's, and P), the backward from P (both sides
             fed the kernel's stash) and the recompute backward (dqkv).
             Tolerances: O max |err| ≤ 1e-4 f32 / 1.6e-2 bf16 (about two bf16
             ulps at |o| ≈ 1); P ≤ 1e-5 f32 / 2**-8 bf16 (one bf16 ulp at
             p ≤ 1); dqkv |err| ≤ tol · max(1, |plain|) with the O tolerances
             (both sides compute in f32 from the same inputs and round the
             result). Times each kernel and its plain version at the ViT-B/16
             shape with CUDA events, in the order plain, kernel, kernel, plain.
4. slice   — the serving path at full ViT-B/16 width: the classification model
             of configs/classification/pet_synth.yaml and the 128-d embedding
             model, seeded weights, bf16, batches of 128 seeded uint8
             224×224 images through make_eval_step and make_embed_step. The
             no-stash kernel must launch exactly 12 times per forward (and no
             other kernel), and logits and embeddings must match the same
             models on the plain attention path (per-row cosine ≥ 0.999).
             Prints images/s of both paths. The same models in f32 must also
             agree on the argmax of ≥ 99% of rows.
3w. window kernel — each of the four window-attention kernels against its
             plain version, f32 and bf16, at the Swin-B (bs 80) stage shapes
             (stage 0: 56×56, 4 heads, unshifted and shifted; stage 2: 14×14,
             16 heads, shifted; stage 3: 7×7, 32 heads, one window) and at odd
             shapes (the JAX kernel test's B=4, 8×8, ws 4, 2 heads, shift 2;
             ws 8 with head dim 64 and scale 1.0, SwinV2's call). O, P and dqkv
             are held to phase 3's bars; the stash forward's O must be
             bit-equal to the no-stash kernel's; dbias (f32 in both dtypes)
             within 1e-4 · max(1, max |plain|): both sides sum the same f32
             terms over up to 5120 windows in another order. A repeated
             backward from P must return bit-identical dbias. Times all four
             kernels and their plain versions at the stage-0 (unshifted) and
             stage-2 bf16 shapes, in the order plain, kernel, kernel, plain.
5. train   — the training path: the pet_synth model at full width and depth,
             bf16 compute with f32 parameters, bs 128 seeded uint8 images and
             int labels, make_train_step with CE (label smoothing 0.05) and the
             optimizer build_tx makes of the pet_synth hyp: (SGD, wd 5e-4,
             momentum 0.8 → 0.937, cosine_with_warm from lr 0.01, clip 10),
             with STEPS_PER_EPOCH = 2 so that the warm-up ends inside the run,
             and the EMA. Five steps: each must launch exactly 12 stash
             forwards and 12 backwards from P (and nothing else) and give a
             finite loss; after the first, every parameter has a finite
             gradient and every qkv.weight gradient is non-zero. Two more
             steps with VDK_ATTN_NO_PCACHE=1: 12 no-stash forwards and 12
             recompute backwards each. The kernel path against the plain
             attention path from the same weights and batch, one step: in f32
             (bs 32) the loss within 1e-5 relative, and every gradient and
             every update (θ₁ − θ₀) within 1e-3 of its tensor's largest
             entry, max-abs, plus one f32 spacing of θ for the update (the
             paths differ only in f32 summation order;
             the key bias's gradient is zero in exact arithmetic, so a
             relative bar would not hold on it, and the max-abs bar compares
             it by absolute size); in bf16 (bs 128) the agreement is printed.
             Prints images/s and torch.cuda.max_memory_allocated of the
             kernel path with the P stash (the default), the kernel path with
             VDK_ATTN_NO_PCACHE=1 and the plain path (order kernel,
             no-pcache, plain, plain, no-pcache, kernel).
5p. profile — the ViT-B/16 bf16 train and eval steps (bs 128, K1 path):
             unprofiled step time, then device time per step by kernel class
             (attention kernels by name, GEMMs, copies and casts, LayerNorm,
             optimizer, reductions, other elementwise) from torch.profiler
             over 3 steps, and the device's idle share.

6. swin serving, 7. swin train — phases 4 and 5 for Swin-B
             (swin_base_patch4_window7_224), the reference's default recipe:
             the `model:` section of configs/classification/pet.yaml (35
             classes, 224²) and the embedding model of configs/faceX/cbir.yaml
             (Swin-B backbone, 128-d neck; its margin head is not ported),
             seeded weights. Serving: bs 128 through make_eval_step and
             make_embed_step, exactly 24 window-attention forwards per forward
             and no other kernel, the same bars. Training: pet.yaml's hyp (SGD
             lr0 0.006, momentum 0.8 → 0.937, wd 5e-4, cosine_with_warm, clip
             10), CE with label smoothing 0.05 and the EMA, bs 80 (its batch);
             3 steps of 24 stash forwards + 24 backwards from P, 2 steps of
             24 + 24 recompute with VDK_ATTN_NO_PCACHE=1; every qkv.weight and
             relative_position_bias_table gradient non-zero after the first;
             the one-step f32 comparison at bs 16 with phase 5's bars.

3v. vision kernel — vision_attention's forward (K3) and recompute backward
             (K3r) against their plain versions, f32 and bf16, at ViT-B/16
             (bs 128) as contiguous tensors and as the [B, H, N, D] views of a
             packed qkv buffer (timed), the same views one element into a
             wider buffer (rows not 16-byte aligned), the JAX test's shape,
             ViT-B/8 and head dim 128; phase 3's bars; strided and unaligned
             views bit-equal to the kernels on contiguous copies.
8. vision path — the pet_synth ViT-B/16 with every attention core on
             vision_attention: one bf16 train step (12 K3 + 12 K3r) and the
             eval forward (12 K3), then images/s against the K1 path and the
             f32 one-step comparison with phase 5's bars.

The line before the last is a JSON summary of the ten kernels, with each
kernel's launches counted on the main paths (the bf16 serving runs and the
bf16 train runs of both models and the vision path, counts set to 0 before
each and read after), and times at the ViT-B/16 bf16 shape (fused QKV
attention, vision_attention) or the Swin-B stage-0 bf16 shape (window
attention); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import time
import types
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F

from visiondk_tpu_torch.engine.state import create_train_state
from visiondk_tpu_torch.engine.steps import StepConfig, make_embed_step, make_eval_step, make_train_step
from visiondk_tpu_torch.engine.trainer import build_tx
from visiondk_tpu_torch.losses import create_lossfn
from visiondk_tpu_torch.models import get_model
from visiondk_tpu_torch.models.backbones.swin import WindowAttention, window_region_ids
from visiondk_tpu_torch.models.layers import Attention
from visiondk_tpu_torch.ops import _build
from visiondk_tpu_torch.ops import window_attention as wattn
from visiondk_tpu_torch.ops.attention import (
    fused_qkv_attention_bwd_from_p,
    fused_qkv_attention_bwd_from_p_plain,
    fused_qkv_attention_bwd_recompute,
    fused_qkv_attention_bwd_recompute_plain,
    fused_qkv_attention_fwd,
    fused_qkv_attention_fwd_stash,
    fused_qkv_attention_fwd_stash_plain,
    fused_qkv_attention_plain,
    vision_attention,
    vision_attention_bwd,
    vision_attention_bwd_plain,
    vision_attention_fwd,
    vision_attention_plain,
)
from visiondk_tpu_torch.ops.window_attention import (
    fused_window_attention_bwd_from_p,
    fused_window_attention_bwd_recompute,
    fused_window_attention_fwd,
    fused_window_attention_fwd_stash,
)

K1_KERNELS = (fused_qkv_attention_fwd, fused_qkv_attention_fwd_stash, fused_qkv_attention_bwd_from_p,
              fused_qkv_attention_bwd_recompute)
K3_KERNELS = (vision_attention_fwd, vision_attention_bwd)
KERNELS = K1_KERNELS + wattn.KERNELS + K3_KERNELS

# the `model:` section of configs/classification/pet_synth.yaml
PET_SYNTH_MODEL = {
    "task": "classification", "load_from": None, "name": "vit_base_patch16_224",
    "image_size": 224, "kwargs": {}, "num_classes": 35, "pretrained": False,
    "backbone_freeze": False, "bn_freeze": False, "bn_freeze_affine": False,
    "attention_pool": False,
}
# the optimizer fields of its `hyp:` section
PET_SYNTH_HYP = {
    "epochs": 6, "lr0": 0.01, "lrf_ratio": None, "momentum": 0.937, "weight_decay": 0.0005,
    "warmup_momentum": 0.8, "warm_ep": 1, "optimizer": ["sgd", False], "scheduler": "cosine_with_warm",
}
LABEL_SMOOTH = 0.05
STEPS_PER_EPOCH = 2
# the embedding model of bench.py: ViT-B/16 backbone, 128-d neck, no head
EMBED_MODEL = {"task": "cbir", "backbone": {"vit_base_patch16_224": {"feat_dim": 128, "image_size": 224}}}
# the `model:` section of configs/classification/pet.yaml: Swin-B, the reference's default recipe
PET_MODEL = {**PET_SYNTH_MODEL, "name": "swin_base_patch4_window7_224"}
# the optimizer fields of its `hyp:` section
PET_HYP = {**PET_SYNTH_HYP, "epochs": 15, "lr0": 0.006}
# the embedding model of configs/faceX/cbir.yaml: Swin-B backbone, 128-d neck (its
# arcface head trains the embedding and is not ported)
CBIR_EMBED_MODEL = {"task": "cbir", "backbone": {
    "swin_base_patch4_window7_224": {"pretrained": False, "image_size": 224, "feat_dim": 128}}}

BATCH = 128
IMG = PET_SYNTH_MODEL["image_size"]
F32_TRAIN_BATCH = 32
DEPTH = 12  # ViT-B/16 blocks, one attention forward and backward each
N_BATCHES = 3
TRAIN_STEPS = 5
NO_PCACHE_STEPS = 2
TOL = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}
P_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-8}
DBIAS_TOL = 1e-4  # max |kernel − plain| over dbias, relative to max(1, its largest |plain| entry)
MIN_COSINE = 0.999
MIN_ARGMAX_AGREEMENT = 0.99
F32_LOSS_RTOL = 1e-5
F32_TENSOR_TOL = 1e-3  # max |kernel − plain| over a tensor, relative to its largest |plain| entry
# the H100 SXM's published rates (NVIDIA's data sheet, 700 W): HBM bytes/s and
# dense peak FLOP/s of the products (bf16 tensor cores; f32 outside them)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}


@dataclasses.dataclass(frozen=True)
class Recipe:
    """A model the run serves and trains, and the four kernels of its attention."""

    tag: str                 # prefix of the serving phase's lines; the train phase's is train_tag
    train_tag: str
    model: dict              # the classification `model:` section
    embed_model: dict        # the embedding model
    hyp: dict                # the optimizer fields of the `hyp:` section
    train_batch: int
    f32_train_batch: int
    train_steps: int
    depth: int               # attention blocks: launches of each kernel per forward or step
    kernels: tuple           # (forward, stash forward, backward from P, recompute backward)
    nonzero_grads: tuple     # parameter-name suffixes whose gradients must be non-zero after a step


VIT = Recipe("slice", "train", PET_SYNTH_MODEL, EMBED_MODEL, PET_SYNTH_HYP, BATCH, F32_TRAIN_BATCH,
             TRAIN_STEPS, DEPTH, K1_KERNELS, ("attn.qkv.weight",))
SWIN = Recipe("swin serving", "swin train", PET_MODEL, CBIR_EMBED_MODEL, PET_HYP, 80, 16, 3, 24,
              wattn.KERNELS, ("attn.qkv.weight", "attn.relative_position_bias_table"))

# (name, B, N, heads, head_dim, n_valid): the ViT-B/16 main-path shape (timed),
# the JAX kernel test's unaligned N with a key mask, ViT-B/8's 785 tokens,
# ViT-H/14's head_dim 80, and an N that is a multiple of 8 (the bf16 kernels
# then move the P stash in 16-byte pieces; every other N here is odd)
QKV_CASES = [
    ("vit_b16", BATCH, 197, 12, 64, None),
    ("unaligned", 8, 37, 4, 32, 29),
    ("vit_b8", 4, 785, 12, 64, None),
    ("hd80", 4, 257, 16, 80, 250),
    ("n_mult8", 8, 200, 6, 64, 196),
]

# (name, B, H=W, heads, C, ws, shift, scale, timed): Swin-B at bs 80, stage by
# stage (18 of its 24 blocks run at stage 2), the JAX kernel test's shape, and
# SwinV2's window 8 with scale 1.0 at head dim 64
WINDOW_CASES = [
    ("swin_b_stage0", 80, 56, 4, 128, 7, 0, None, True),
    ("swin_b_stage0_shifted", 80, 56, 4, 128, 7, 3, None, False),
    ("swin_b_stage2_shifted", 80, 14, 16, 512, 7, 3, None, True),
    ("swin_b_stage3", 80, 7, 32, 1024, 7, 0, None, False),
    ("jax_test", 4, 8, 2, 32, 4, 2, None, False),
    ("ws8_scale1", 4, 16, 2, 128, 8, 4, 1.0, False),
]

NAMES = {k: k.__name__ for k in KERNELS}
SOURCES = {
    fused_qkv_attention_fwd: ("visiondk_tpu_torch/csrc/fused_qkv_attention.cu",
                              "visiondk_tpu/ops/pallas/attention.py:198"),
    fused_qkv_attention_fwd_stash: ("visiondk_tpu_torch/csrc/fused_qkv_attention.cu",
                                    "visiondk_tpu/ops/pallas/attention.py:436"),
    fused_qkv_attention_bwd_from_p: ("visiondk_tpu_torch/csrc/fused_qkv_attention_bwd.cu",
                                     "visiondk_tpu/ops/pallas/attention.py:323"),
    fused_qkv_attention_bwd_recompute: ("visiondk_tpu_torch/csrc/fused_qkv_attention_bwd.cu",
                                        "visiondk_tpu/ops/pallas/attention.py:263"),
    fused_window_attention_fwd: ("visiondk_tpu_torch/csrc/fused_window_attention.cu",
                                 "visiondk_tpu/ops/pallas/window_attention.py:246"),
    fused_window_attention_fwd_stash: ("visiondk_tpu_torch/csrc/fused_window_attention.cu",
                                       "visiondk_tpu/ops/pallas/window_attention.py:500"),
    fused_window_attention_bwd_from_p: ("visiondk_tpu_torch/csrc/fused_window_attention_bwd.cu",
                                        "visiondk_tpu/ops/pallas/window_attention.py:350"),
    fused_window_attention_bwd_recompute: ("visiondk_tpu_torch/csrc/fused_window_attention_bwd.cu",
                                           "visiondk_tpu/ops/pallas/window_attention.py:293"),
    vision_attention_fwd: ("visiondk_tpu_torch/csrc/fused_qkv_attention.cu",
                           "visiondk_tpu/ops/pallas/attention.py:55"),
    vision_attention_bwd: ("visiondk_tpu_torch/csrc/fused_qkv_attention_bwd.cu",
                           "visiondk_tpu/ops/pallas/attention.py:68"),
}


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype: torch.dtype) -> dict:
    """The least time the card could take for a call: the larger of its bytes
    (each input read once, each output written once) over the HBM rate and
    its products' FLOPs over the dtype's peak."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOP_PER_S[dtype] * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "flops": flops}


def sdpa_backend(fn) -> str:
    """Which of scaled_dot_product_attention's backends one call of ``fn``
    ran, read from the names of the CUDA kernels the profiler saw."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA})
    if not names:
        return "not read (the profiler showed no CUDA kernel)"
    joined = " ".join(names).lower()
    label = next((b for key, b in (("cudnn", "cudnn"), ("flash", "flash"), ("fmha", "efficient")) if key in joined),
                 "math")
    return f"{label} [{', '.join(n[:70] for n in names[:4])}{' ...' if len(names) > 4 else ''}]"


MATH_SDPA = "torch._scaled_dot_product_attention_math"


def math_attention(q, k, v, attn_mask=None, scale=None, transpose_to=None):
    """SDPA's math backend, the one PyTorch call that returns P beside O:
    (O, P), O transposed and reshaped to ``transpose_to`` when given."""
    o, p = torch._scaled_dot_product_attention_math(q, k, v, attn_mask=attn_mask, scale=scale)
    return (o if transpose_to is None else o.transpose(1, 2).reshape(transpose_to)), p


def time_row(tag: str, name: str, kern, plain, library=None, library_what: str = "") -> dict:
    """Times (ms) of a kernel, its plain version and, where one PyTorch call
    computes the same function, that call: CUDA-event means, in the order
    plain, kernel, kernel, plain, then the library call twice."""
    p1 = cuda_ms(plain, iters=10)
    k1 = cuda_ms(kern, iters=10)
    k2 = cuda_ms(kern, iters=10)
    p2 = cuda_ms(plain, iters=10)
    line = (f"{tag} {name}: kernel {k1:.4f}, {k2:.4f} ms | plain {p1:.4f}, {p2:.4f} ms "
            f"(order plain, kernel, kernel, plain)")
    lib_ms = None
    if library is not None:
        l1, l2 = cuda_ms(library, iters=10), cuda_ms(library, iters=10)
        lib_ms = (l1 + l2) / 2
        line += f" | library {l1:.4f}, {l2:.4f} ms: {library_what}, SDPA backend {sdpa_backend(library)}"
    elif library_what:
        line += f" | library: none ({library_what})"
    print(line)
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": lib_ms}


def heads_view(qkv: torch.Tensor, heads: int):
    """q, k, v [B, H, N, D]: strided views of the packed [B, N, 3C] buffer."""
    b, n, w = qkv.shape
    return qkv.view(b, n, 3, heads, w // (3 * heads)).permute(2, 0, 3, 1, 4).unbind(0)


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def read_counts() -> dict:
    torch.cuda.synchronize()
    return {k: k.launches for k in KERNELS}


def only(launches: dict) -> dict:
    """Expected counts: ``launches`` for the kernels named, 0 for every other."""
    return {k: launches.get(k, 0) for k in KERNELS}


def phase_device() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi)  # the card's name and power limit, as nvidia-smi reports them
    print(f"[device] {torch.cuda.get_device_name(0)} | count {torch.cuda.device_count()} | "
          f"torch {torch.__version__} | cuda {torch.version.cuda} | "
          f"capability {torch.cuda.get_device_capability(0)} | tf32 off for matmul and cudnn")


def sass_mma_counts(lib_path) -> dict:
    """Tensor-core instructions (HMMA, or HGMMA for wgmma) per kernel of a
    built library, read from its SASS with the toolkit's cuobjdump."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", str(lib_path)], check=True, capture_output=True,
                          text=True, timeout=300).stdout
    counts, function = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            function = found.group(1)
            counts[function] = 0
        elif function is not None and re.search(r"\bH(G)?MMA\b", line):
            counts[function] += 1
    return counts


# the bf16 tensor-core kernels: every instantiation (head-dim bucket x variant)
# must issue HMMA / HGMMA; the float32 CUDA-core kernels are instantiated for
# float only (no __nv_bfloat16 in their mangled names)
TC_KERNELS = {"fused_qkv_attention": ("fused_attention_fwd_tc_kernel", "fused_attention_fwd_kernel"),
              "fused_qkv_attention_bwd": ("attention_bwd_dq_tc_kernel", "attention_bwd_dkv_tc_kernel",
                                          "attention_bwd_dq_kernel", "attention_bwd_dkv_kernel")}
TC_INSTANTIATIONS = 8  # head-dim buckets 32, 64, 80, 128 x two variants


def check_sass(built) -> None:
    for b in built:
        name = b.path.name.split("-")[0][len("lib"):]
        if name not in TC_KERNELS:
            continue
        counts = sass_mma_counts(b.path)
        for kernel in TC_KERNELS[name]:
            found = {f: c for f, c in counts.items() if re.search(rf"\d{kernel}I", f)}
            if kernel.endswith("_tc_kernel"):
                check(len(found) == TC_INSTANTIATIONS,
                      f"{kernel}: {len(found)} instantiations in {b.path.name}, want {TC_INSTANTIATIONS}")
                bad = [f for f, c in found.items() if c == 0]
                check(not bad, f"bf16 kernels without tensor-core instructions: {bad}")
                print(f"[build] sass: {kernel} (bf16): HMMA/HGMMA per instantiation (head-dim bucket/variant) "
                      + ", ".join(f"{'/'.join(re.findall(r'L[ib](\d+)E', f))}: {c}" for f, c in found.items()))
            else:
                bf16 = [f for f in found if "bfloat16" in f]
                check(not bf16, f"a bf16 instantiation of the CUDA-core kernel {kernel}: {bf16}")
                print(f"[build] sass: {kernel} (float32, CUDA cores): {len(found)} instantiations, "
                      f"HMMA/HGMMA {sum(found.values())}")


def phase_build() -> None:
    names = ("fused_qkv_attention", "fused_qkv_attention_bwd",
             "fused_window_attention", "fused_window_attention_bwd")
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source, started together
        built = list(pool.map(_build.build, names))
    for b in built:
        print(f"[build] {b.path.relative_to(_build.BUILD_DIR.parent.parent)} in "
              f"{b.seconds:.2f} s: {' '.join(b.command)}")
        function = ""
        for line in b.ptxas_log.splitlines():
            found = re.search(r"Compiling entry function '([^']+)'", line)
            if found:
                function = found.group(1)  # mangled: kernel name, dtype, head-dim bucket, variant
            elif "registers" in line or "spill" in line:
                print(f"[build] ptxas: {function}: {line.split(':', 1)[-1].strip()}")
    check_sass(built)


def max_err(out: torch.Tensor, ref: torch.Tensor, scaled: bool = False) -> float:
    diff = (out.float() - ref.float()).abs()
    if scaled:
        diff = diff / ref.float().abs().clamp_min(1.0)
    return diff.max().item()


def phase_kernel(dev: torch.device) -> dict:
    """Every kernel against its plain version; returns, per kernel, its max
    error and times (ms) at the ViT-B/16 bf16 shape."""
    gen = torch.Generator(device=dev).manual_seed(0)
    summary = {}
    for name, b, n, h, d, n_valid in QKV_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"{name} B={b} N={n} H={h} d={d} n_valid={n_valid} {str(dtype).replace('torch.', '')}"
            qkv = torch.randn((b, n, 3 * h * d), generator=gen, device=dev).to(dtype)
            dout = torch.randn((b, n, h * d), generator=gen, device=dev).to(dtype)
            rows = n if n_valid is None else n_valid
            tol = TOL[dtype]

            out = fused_qkv_attention_fwd(qkv, h, n_valid)
            ref = fused_qkv_attention_plain(qkv, h, n_valid)
            o_s, p_s = fused_qkv_attention_fwd_stash(qkv, h, n_valid)
            o_r, p_r = fused_qkv_attention_fwd_stash_plain(qkv, h, n_valid)
            g_p = fused_qkv_attention_bwd_from_p(qkv, p_s, dout, h)
            g_p_ref = fused_qkv_attention_bwd_from_p_plain(qkv, p_s, dout, h)
            g_r = fused_qkv_attention_bwd_recompute(qkv, dout, h, n_valid)
            g_r_ref = fused_qkv_attention_bwd_recompute_plain(qkv, dout, h, n_valid)
            torch.cuda.synchronize()

            errs = {
                fused_qkv_attention_fwd: max_err(out[:, :rows], ref[:, :rows]),
                fused_qkv_attention_fwd_stash: max(max_err(o_s[:, :rows], o_r[:, :rows]), max_err(p_s, p_r)),
                fused_qkv_attention_bwd_from_p: max_err(g_p, g_p_ref, scaled=True),
                fused_qkv_attention_bwd_recompute: max_err(g_r, g_r_ref, scaled=True),
            }
            for t, what in ((out, "O"), (p_s, "P"), (g_p, "dqkv from P"), (g_r, "dqkv recompute")):
                check(bool(torch.isfinite(t[:, :rows] if what == "O" else t).all()), f"{tag}: non-finite {what}")
            check(torch.equal(o_s, out), f"{tag}: the stash forward's O differs from the no-stash kernel's")
            p_err = max_err(p_s, p_r)
            check(p_err <= P_TOL[dtype], f"{tag}: P max |kernel - plain| {p_err} > {P_TOL[dtype]}")
            if n_valid is not None:
                check(not bool(p_s[..., n_valid:].any()), f"{tag}: P is not 0 at masked keys")
            for k, err in errs.items():
                check(err <= tol, f"{tag}: {NAMES[k]} error {err} > {tol}")
            print(f"[kernel] {tag}: max|err| fwd {errs[fused_qkv_attention_fwd]:.3e}, "
                  f"stash O/P {max_err(o_s[:, :rows], o_r[:, :rows]):.3e}/{p_err:.3e} (O bit-equal to fwd), "
                  f"bwd_from_p {errs[fused_qkv_attention_bwd_from_p]:.3e}, "
                  f"bwd_recompute {errs[fused_qkv_attention_bwd_recompute]:.3e} "
                  f"(tol {tol}, P {P_TOL[dtype]:.3e}; dqkv scaled by max(1, |plain|))")

            if name != "vit_b16":
                continue
            timed = {
                fused_qkv_attention_fwd: (lambda: fused_qkv_attention_fwd(qkv, h),
                                          lambda: fused_qkv_attention_plain(qkv, h)),
                fused_qkv_attention_fwd_stash: (lambda: fused_qkv_attention_fwd_stash(qkv, h),
                                                lambda: fused_qkv_attention_fwd_stash_plain(qkv, h)),
                fused_qkv_attention_bwd_from_p: (
                    lambda: fused_qkv_attention_bwd_from_p(qkv, p_s, dout, h),
                    lambda: fused_qkv_attention_bwd_from_p_plain(qkv, p_s, dout, h)),
                fused_qkv_attention_bwd_recompute: (
                    lambda: fused_qkv_attention_bwd_recompute(qkv, dout, h),
                    lambda: fused_qkv_attention_bwd_recompute_plain(qkv, dout, h)),
            }
            if dtype == torch.float32:
                timed = {fused_qkv_attention_fwd: timed[fused_qkv_attention_fwd]}  # in f32 only the serving forward
            # the library's yardsticks: SDPA on the strided q, k, v views of the
            # packed buffer with the transpose-reshape to [B, N, C]; for the stash
            # forward SDPA's math backend, the one call that also returns P; SDPA's
            # backward from dO to dqkv (through the views) for both backwards
            qkv_g = qkv.detach().requires_grad_(True)
            o_lib = F.scaled_dot_product_attention(*heads_view(qkv_g, h)).transpose(1, 2).reshape(b, n, h * d)
            sdpa_fwd = "SDPA on the strided q, k, v views of qkv + transpose-reshape to [B, N, C]"
            sdpa_bwd = "SDPA's backward, dO -> dqkv through the views"
            library = {
                fused_qkv_attention_fwd: (
                    lambda: F.scaled_dot_product_attention(*heads_view(qkv, h)).transpose(1, 2).reshape(b, n, h * d),
                    sdpa_fwd),
                fused_qkv_attention_fwd_stash: (
                    lambda: math_attention(*heads_view(qkv, h), transpose_to=(b, n, h * d)),
                    f"{MATH_SDPA} (O and P) on the strided views + transpose-reshape of O to [B, N, C]"),
                fused_qkv_attention_bwd_from_p: (
                    lambda: torch.autograd.grad(o_lib, qkv_g, dout, retain_graph=True), sdpa_bwd),
                fused_qkv_attention_bwd_recompute: (
                    lambda: torch.autograd.grad(o_lib, qkv_g, dout, retain_graph=True), sdpa_bwd),
            }
            e = qkv.element_size()
            io_qkv, io_o, io_p = b * n * 3 * h * d * e, b * n * h * d * e, b * h * n * n * e
            product = 2 * b * h * n * n * d  # FLOPs of one [N, N] x [N, d] product over every (b, h)
            work = {  # (bytes, FLOPs): inputs read once, outputs written once; the products
                fused_qkv_attention_fwd: (io_qkv + io_o, 2 * product),
                fused_qkv_attention_fwd_stash: (io_qkv + io_o + io_p, 2 * product),
                fused_qkv_attention_bwd_from_p: (io_qkv + io_p + io_o + io_qkv, 4 * product),
                fused_qkv_attention_bwd_recompute: (io_qkv + io_o + io_qkv, 5 * product),
            }
            for k, (kern, plain) in timed.items():
                lib, lib_what = library[k] if dtype == torch.bfloat16 else (None, "")
                times = time_row(f"[kernel] {tag}", NAMES[k], kern, plain, lib, lib_what)
                if dtype == torch.bfloat16:
                    summary[k] = {"max_abs_err": errs[k], **times, **bound(*work[k], dtype)}
            del qkv_g, o_lib, library
            del qkv, dout, out, ref, o_s, p_s, o_r, p_r, g_p, g_p_ref, g_r, g_r_ref, timed
            torch.cuda.empty_cache()
    return summary


def window_library(qkv, bias, ids, dout, h: int, ws: int, scale):
    """The library's yardsticks for the window kernels: SDPA with the float
    bias (plus the shift-region mask, −100 across regions) on q, k, v and dO
    partitioned into [B·nW, h, ws², d] beforehand; the partition and reverse
    copies are left out of the time, so it is a lower bound on the library's.
    The mask is broadcast over windows when unshifted, else materialised per
    window. The stash forward's is SDPA's math backend, which returns P. The
    backward gives dq, dk, dv; it does not compute dbias."""
    b, n, d = qkv.shape[0], ws * ws, qkv.shape[-1] // (3 * h)

    def windows(x: torch.Tensor, m: int):  # [B, H, W, m·h·d] -> m tensors [B·nW, h, ws², d]
        win = wattn.window_partition(x, ws).reshape(-1, n, m, h, d)
        return win.permute(2, 0, 3, 1, 4).contiguous().unbind(0)

    q, k, v = windows(qkv, 3)
    (do,) = windows(dout, 1)
    mask = bias[None]
    if ids is not None:
        apart = ids[:, :, None] != ids[:, None, :]
        mask = mask + torch.where(apart, -100.0, 0.0)[:, None]
        mask = mask.expand(b, *mask.shape).reshape(-1, h, n, n)
    mask = mask.to(qkv.dtype)
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, scale=scale)
    kf, ks, kb, kr = wattn.KERNELS
    fwd = (lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale),
           "SDPA with the bias + shift mask on pre-partitioned [B*nW, h, ws^2, d]")
    stash = (lambda: math_attention(q, k, v, attn_mask=mask, scale=scale),
             f"{MATH_SDPA} (O and P) with the bias + shift mask on pre-partitioned [B*nW, h, ws^2, d]")
    bwd = (lambda: torch.autograd.grad(o, (qg, kg, vg), do, retain_graph=True),
           "SDPA's backward on pre-partitioned [B*nW, h, ws^2, d], dq, dk, dv (no dbias)")
    note = "partition and reverse copies left out, a lower bound on the library's time"
    return {kf: fwd, ks: stash, kb: bwd, kr: bwd}, note


def phase_window_kernel(dev: torch.device) -> dict:
    """Every window-attention kernel against its plain version; returns, per
    kernel, its max error and times (ms) at the Swin-B stage-0 bf16 shape."""
    gen = torch.Generator(device=dev).manual_seed(4)
    kf, ks, kb, kr = wattn.KERNELS
    summary = {}
    for name, b, hw, h, c, ws, shift, scale, timed in WINDOW_CASES:
        n = ws * ws
        ids = (torch.from_numpy(window_region_ids(hw, hw, ws, shift)).to(dev) if shift else None)
        for dtype in (torch.float32, torch.bfloat16):
            tag = (f"{name} B={b} {hw}x{hw} heads={h} C={c} ws={ws} shift={shift} scale={scale} "
                   f"{str(dtype).replace('torch.', '')}")
            qkv = torch.randn((b, hw, hw, 3 * c), generator=gen, device=dev).to(dtype)
            dout = torch.randn((b, hw, hw, c), generator=gen, device=dev).to(dtype)
            bias = 0.5 * torch.randn((h, n, n), generator=gen, device=dev)
            tol = TOL[dtype]

            out = kf(qkv, bias, ids, h, scale)
            ref = wattn.fused_window_attention_plain(qkv, bias, ids, h, scale)
            o_s, p_s = ks(qkv, bias, ids, h, scale)
            o_r, p_r = wattn.fused_window_attention_fwd_stash_plain(qkv, bias, ids, h, scale)
            g_p, db_p = kb(qkv, p_s, dout, h, scale)
            g_p_ref, db_p_ref = wattn.fused_window_attention_bwd_from_p_plain(qkv, p_s, dout, h, scale)
            g_r, db_r = kr(qkv, bias, ids, dout, h, scale)
            g_r_ref, db_r_ref = wattn.fused_window_attention_bwd_recompute_plain(qkv, bias, ids, dout, h, scale)
            _, db_p2 = kb(qkv, p_s, dout, h, scale)
            torch.cuda.synchronize()

            for t, what in ((out, "O"), (p_s, "P"), (g_p, "dqkv from P"), (db_p, "dbias from P"),
                            (g_r, "dqkv recompute"), (db_r, "dbias recompute")):
                check(bool(torch.isfinite(t).all()), f"{tag}: non-finite {what}")
            check(torch.equal(o_s, out), f"{tag}: the stash forward's O differs from the no-stash kernel's")
            check(torch.equal(db_p, db_p2), f"{tag}: a repeated backward from P gave other dbias bits")
            check(db_p.dtype == db_r.dtype == torch.float32, f"{tag}: dbias is not f32")
            p_err = max_err(p_s, p_r)
            dbias_err = {kb: max_err(db_p, db_p_ref) / max(1.0, db_p_ref.abs().max().item()),
                         kr: max_err(db_r, db_r_ref) / max(1.0, db_r_ref.abs().max().item())}
            errs = {kf: max_err(out, ref), ks: max(max_err(o_s, o_r), p_err),
                    kb: max_err(g_p, g_p_ref, scaled=True), kr: max_err(g_r, g_r_ref, scaled=True)}
            check(p_err <= P_TOL[dtype], f"{tag}: P max |kernel - plain| {p_err} > {P_TOL[dtype]}")
            for k, err in errs.items():
                check(err <= tol, f"{tag}: {NAMES[k]} error {err} > {tol}")
            for k, err in dbias_err.items():
                check(err <= DBIAS_TOL, f"{tag}: {NAMES[k]} dbias error {err} of max(1, |plain|) > {DBIAS_TOL}")
            print(f"[window kernel] {tag}: max|err| fwd {errs[kf]:.3e}, stash O/P "
                  f"{max_err(o_s, o_r):.3e}/{p_err:.3e} (O bit-equal to fwd), bwd_from_p dqkv "
                  f"{errs[kb]:.3e} dbias {dbias_err[kb]:.3e} (bit-identical on repeat), bwd_recompute "
                  f"dqkv {errs[kr]:.3e} dbias {dbias_err[kr]:.3e}, max|dbias| {db_p_ref.abs().max().item():.3e} "
                  f"(tol {tol}, P {P_TOL[dtype]:.3e}, dbias {DBIAS_TOL} of max(1, |plain|); dqkv scaled by "
                  f"max(1, |plain|))")

            if timed and dtype == torch.bfloat16:
                calls = {
                    kf: (lambda: kf(qkv, bias, ids, h, scale),
                         lambda: wattn.fused_window_attention_plain(qkv, bias, ids, h, scale)),
                    ks: (lambda: ks(qkv, bias, ids, h, scale),
                         lambda: wattn.fused_window_attention_fwd_stash_plain(qkv, bias, ids, h, scale)),
                    kb: (lambda: kb(qkv, p_s, dout, h, scale),
                         lambda: wattn.fused_window_attention_bwd_from_p_plain(qkv, p_s, dout, h, scale)),
                    kr: (lambda: kr(qkv, bias, ids, dout, h, scale),
                         lambda: wattn.fused_window_attention_bwd_recompute_plain(qkv, bias, ids, dout, h, scale)),
                }
                library, lib_note = window_library(qkv, bias, ids, dout, h, ws, scale)
                d, n_win = c // h, b * (hw // ws) ** 2
                e = qkv.element_size()
                io_qkv, io_o = qkv.numel() * e, dout.numel() * e
                io_p, io_bias = n_win * h * n * n * e, bias.numel() * 4
                io_ids = 0 if ids is None else ids.numel() * 4
                product = 2 * n_win * h * n * n * d
                work = {
                    kf: (io_qkv + io_bias + io_ids + io_o, 2 * product),
                    ks: (io_qkv + io_bias + io_ids + io_o + io_p, 2 * product),
                    kb: (io_qkv + io_p + io_o + io_qkv + io_bias, 4 * product),
                    kr: (io_qkv + io_bias + io_ids + io_o + io_qkv + io_bias, 5 * product),
                }
                for k, (kern, plain) in calls.items():
                    lib, lib_what = library[k]
                    times = time_row(f"[window kernel] {tag}", NAMES[k], kern, plain, lib,
                                     f"{lib_what}; {lib_note}" if lib is not None else lib_what)
                    if name == "swin_b_stage0":
                        summary[k] = {"max_abs_err": errs[k], **times, **bound(*work[k], dtype)}
                del calls, library
            del qkv, dout, out, ref, o_s, p_s, o_r, p_r, g_p, g_p_ref, g_r, g_r_ref
            torch.cuda.empty_cache()
    return summary


def set_fused(model: torch.nn.Module, on: bool) -> None:
    for m in model.modules():
        if isinstance(m, (Attention, WindowAttention)):
            m.use_fused = on


def vision_attention_forward(self: Attention, x: torch.Tensor) -> torch.Tensor:
    """``Attention.forward`` with its core on ``vision_attention``, as
    benchmarks/attn_ab.py routes the JAX ViT: the [B, H, N, D] q, k, v views
    of the QKV projection, O transposed back to [B, N, C] before proj."""
    b, n, c = x.shape
    if self.n_valid not in (None, n):
        raise ValueError("vision_attention has no key mask")
    q, k, v = heads_view(self.qkv(x), self.num_heads)
    out = vision_attention(q, k, v).transpose(1, 2).reshape(b, n, c)
    return self.proj_drop(self.proj(out))


def set_vision(model: torch.nn.Module, on: bool) -> None:
    """Route every ViT attention block's core through ``vision_attention``
    (on), or give each block its own forward back (off)."""
    for m in model.modules():
        if isinstance(m, Attention):
            if on:
                m.forward = types.MethodType(vision_attention_forward, m)
            else:
                m.__dict__.pop("forward", None)


# attention paths of a model: (name, how to set the model on it)
KERNEL_PATH = ("kernel", lambda m: (set_vision(m, False), set_fused(m, True)))
PLAIN_PATH = ("plain", lambda m: (set_vision(m, False), set_fused(m, False)))
VISION_PATH = ("vision", lambda m: (set_fused(m, True), set_vision(m, True)))


def images_per_s(step, batch: dict, iters: int = 10) -> float:
    return batch["image"].shape[0] / (cuda_ms(lambda: step(batch), iters=iters, warmup=2) / 1000.0)


def row_cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = a.double(), b.double()
    return (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1)).clamp_min(1e-30)


def build_models(recipe: Recipe, dtype: torch.dtype, dev: torch.device):
    cls_model = get_model(recipe.model, dtype=dtype, device=dev, generator=torch.Generator().manual_seed(0))
    emb_model = get_model(recipe.embed_model, dtype=dtype, device=dev, generator=torch.Generator().manual_seed(1))
    return cls_model, emb_model


def compare_paths(recipe: Recipe, cls_model, emb_model, batches, dtype: torch.dtype) -> dict:
    """Eval and embed steps on every batch through the kernel (counted), then
    on the plain attention path; checks shapes, finiteness, launch counts
    and agreement. Returns the launch counts of the counted run."""
    name = str(dtype).replace("torch.", "")
    fwd, depth = recipe.kernels[0], recipe.depth
    eval_step = make_eval_step(cls_model, StepConfig())
    embed_step = make_embed_step(emb_model, StepConfig())

    reset_counts()
    logits = [eval_step(b) for b in batches]
    eval_launches = read_counts()[fwd]
    feats = [embed_step(b) for b in batches]
    counts = read_counts()
    embed_launches = counts[fwd] - eval_launches
    print(f"[{recipe.tag}] {name}: kernel launches eval {eval_launches}, embed {embed_launches} "
          f"over {len(batches)} batches each (want {depth} per forward)")
    check(eval_launches == depth * len(batches), f"eval launched the kernel {eval_launches} times")
    check(embed_launches == depth * len(batches), f"embed launched the kernel {embed_launches} times")
    check(all(v == 0 for k, v in counts.items() if k is not fwd),
          f"serving launched another kernel: {[(NAMES[k], v) for k, v in counts.items()]}")

    set_fused(cls_model, False)
    set_fused(emb_model, False)
    logits_ref = [eval_step(b) for b in batches]
    feats_ref = [embed_step(b) for b in batches]
    torch.cuda.synchronize()
    set_fused(cls_model, True)
    set_fused(emb_model, True)
    check(read_counts() == counts, "the plain path launched a kernel")

    (feat_dim,) = {v["feat_dim"] for v in recipe.embed_model["backbone"].values()}
    for tag, outs, refs, width in (("logits", logits, logits_ref, recipe.model["num_classes"]),
                                   ("embeddings", feats, feats_ref, feat_dim)):
        out, ref = torch.cat(outs), torch.cat(refs)
        check(out.shape == (BATCH * len(batches), width) and out.dtype == torch.float32,
              f"{tag}: shape {tuple(out.shape)} dtype {out.dtype}")
        check(bool(torch.isfinite(out).all()), f"{tag}: non-finite values")
        cos = row_cosine(out, ref).min().item()
        line = (f"[{recipe.tag}] {name} {tag} kernel vs plain path: min row cosine {cos:.6f} "
                f"(want >= {MIN_COSINE}), max |diff| {(out - ref).abs().max().item():.3e}")
        check(cos >= MIN_COSINE, f"{name} {tag}: min row cosine {cos} < {MIN_COSINE}")
        if tag == "logits":
            agree = (out.argmax(1) == ref.argmax(1)).double().mean().item()
            top2 = ref.topk(2, dim=1).values
            near_tie = ((top2[:, 0] - top2[:, 1]) < 2 * (out - ref).abs().max()).double().mean().item()
            line += (f", argmax agreement {agree:.4f}, rows whose top-2 gap is within twice the "
                     f"largest difference {near_tie:.4f}")
            # In bf16 the two paths round at different places; at random init a
            # few percent of rows have near-tied top-2 logits, so the argmax
            # bar is held in f32, where the paths differ only in f32 rounding.
            if dtype == torch.float32:
                line += f" (want >= {MIN_ARGMAX_AGREEMENT})"
                check(agree >= MIN_ARGMAX_AGREEMENT,
                      f"{name} logits: argmax agreement {agree} < {MIN_ARGMAX_AGREEMENT}")
        print(line)
    norms = torch.linalg.vector_norm(torch.cat(feats), dim=1)
    check(bool(((norms - 1).abs() < 1e-3).all()), "embeddings are not unit-norm")
    return counts


def phase_slice(dev: torch.device, recipe: Recipe) -> dict:
    gen = torch.Generator(device=dev).manual_seed(2)
    batches = [
        {"image": torch.randint(0, 256, (BATCH, IMG, IMG, 3), generator=gen, device=dev, dtype=torch.uint8)}
        for _ in range(N_BATCHES)
    ]
    t0 = time.perf_counter()
    cls_model, emb_model = build_models(recipe, torch.bfloat16, dev)
    torch.cuda.synchronize()
    print(f"[{recipe.tag}] built {recipe.model['name']} ({recipe.model['num_classes']} classes) and the "
          f"128-d embedding model, bf16, seeded weights, in {time.perf_counter() - t0:.1f} s")

    # the main path, counted: bf16 serving
    counts = compare_paths(recipe, cls_model, emb_model, batches, torch.bfloat16)

    # throughput, interleaved: kernel, plain, plain, kernel
    steps = (("eval", make_eval_step(cls_model, StepConfig()), cls_model),
             ("embed", make_embed_step(emb_model, StepConfig()), emb_model))
    for tag, step, model in steps:
        rates = {True: [], False: []}
        for fused in (True, False, False, True):
            set_fused(model, fused)
            rates[fused].append(images_per_s(step, batches[0]))
        set_fused(model, True)
        k, p = rates[True], rates[False]
        print(f"[{recipe.tag}] {tag} bs {BATCH} bf16 images/s: kernel path {k[0]:.1f}, {k[1]:.1f} | "
              f"plain path {p[0]:.1f}, {p[1]:.1f} (order kernel, plain, plain, kernel)")
    del cls_model, emb_model, steps, model, step
    torch.cuda.empty_cache()

    # the same check in f32, where the two paths differ only in f32 rounding
    compare_paths(recipe, *build_models(recipe, torch.float32, dev), batches, torch.float32)
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------- train


def build_trainer(recipe: Recipe, dtype: torch.dtype, dev: torch.device, path=KERNEL_PATH):
    """The recipe's model (seed 0) on an attention path, its train state and step."""
    model = get_model(recipe.model, dtype=dtype, device=dev, generator=torch.Generator().manual_seed(0))
    path[1](model)
    tx = build_tx(recipe.hyp, STEPS_PER_EPOCH, discrete_per_epoch=True, model_cfg=recipe.model)
    state = create_train_state(model, tx)
    step = make_train_step(model, tx, create_lossfn("ce", label_smooth=LABEL_SMOOTH), StepConfig(),
                           torch.Generator().manual_seed(1))
    return model, state, step


def snapshot(model: torch.nn.Module):
    """(parameters, gradients), cloned, by name."""
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    return params, grads


def compare_one_step(recipe: Recipe, dtype: torch.dtype, dev: torch.device, batch: dict,
                     kernel_side=None, paths=(KERNEL_PATH, PLAIN_PATH), tag=None) -> None:
    """One step from the same weights and batch on two attention paths (the
    kernel path and the plain path unless told otherwise): loss, every
    gradient, every update θ₁ − θ₀. ``kernel_side`` is the first path's
    (loss, parameters, gradients) when already taken."""
    name = str(dtype).replace("torch.", "")
    theta0 = {n: p.detach().clone() for n, p in get_model(
        recipe.model, dtype=dtype, device=dev, generator=torch.Generator().manual_seed(0)).named_parameters()}
    sides = []
    for i, path in enumerate(paths):
        if i == 0 and kernel_side is not None:
            sides.append(kernel_side)
            continue
        model, state, step = build_trainer(recipe, dtype, dev, path)
        loss = step(state, batch)["loss"].item()
        sides.append((loss, *snapshot(model)))
        del model, state, step
        torch.cuda.empty_cache()
    (lk, pk, gk), (lp, pp, gp) = sides
    loss_rel = abs(lk - lp) / abs(lp)
    worst = {"grad": (0.0, ""), "update": (0.0, "")}
    min_cos = {"grad": (1.0, ""), "update": (1.0, "")}
    key_bias = {"max_abs_kernel": 0.0, "max_abs_plain": 0.0, "max_abs_diff": 0.0}
    for n in gp:
        update = (pp[n] - theta0[n].to(dev)).float()
        # θ₁ = θ₀ + Δ rounds to θ's f32 spacing, which can be near Δ's own
        # size, so the post-step parameters may differ by one spacing more
        spacing = torch.finfo(torch.float32).eps * pp[n].float().abs().max().item()
        pairs = {"grad": (gk[n].float(), gp[n].float(), gp[n].float().abs().max().item(), 0.0),
                 "update": ((pk[n] - theta0[n].to(dev)).float(), update, update.abs().max().item(), spacing)}
        for what, (a, b, scale, slack) in pairs.items():
            ratio = max((a - b).abs().max().item() - slack, 0.0) / max(scale, 1e-30)
            if ratio > worst[what][0]:
                worst[what] = (ratio, n)
            if n.endswith("attn.qkv.bias"):
                # the key bias's gradient is zero in exact arithmetic: compare that
                # slice by absolute size, the q and v slices by cosine
                c = a.shape[0] // 3
                if what == "grad":
                    ka, kp = a[c:2 * c], b[c:2 * c]
                    key_bias["max_abs_kernel"] = max(key_bias["max_abs_kernel"], ka.abs().max().item())
                    key_bias["max_abs_plain"] = max(key_bias["max_abs_plain"], kp.abs().max().item())
                    key_bias["max_abs_diff"] = max(key_bias["max_abs_diff"], (ka - kp).abs().max().item())
                a, b = torch.cat([a[:c], a[2 * c:]]), torch.cat([b[:c], b[2 * c:]])
            cos = torch.nn.functional.cosine_similarity(a.flatten().double(), b.flatten().double(), dim=0).item()
            if cos < min_cos[what][0]:
                min_cos[what] = (cos, n)
    print(f"[{tag or recipe.train_tag}] {name} {paths[0][0]} vs {paths[1][0]} path, one step, "
          f"bs {batch['label'].shape[0]}: loss "
          f"{lk:.6f} vs {lp:.6f} (rel {loss_rel:.3e}); worst max|diff|/max|plain| gradient {worst['grad'][0]:.3e} "
          f"({worst['grad'][1]}), update {worst['update'][0]:.3e} ({worst['update'][1]}); min cosine "
          f"gradient {min_cos['grad'][0]:.6f} ({min_cos['grad'][1]}), update {min_cos['update'][0]:.6f} "
          f"({min_cos['update'][1]}), key-bias slices excluded from the cosines; key-bias gradient slice: "
          f"max|kernel| {key_bias['max_abs_kernel']:.3e}, max|plain| {key_bias['max_abs_plain']:.3e}, "
          f"max|diff| {key_bias['max_abs_diff']:.3e}")
    if dtype == torch.float32:
        check(loss_rel <= F32_LOSS_RTOL, f"f32 loss differs by {loss_rel} relative > {F32_LOSS_RTOL}")
        for what in ("grad", "update"):
            check(worst[what][0] <= F32_TENSOR_TOL,
                  f"f32 {what} of {worst[what][1]} differs by {worst[what][0]} of its max > {F32_TENSOR_TOL}")


def train_rate(model, state, step, batch: dict, path, steps: int = 5):
    path[1](model)
    step(state, batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(state, batch)
    torch.cuda.synchronize()
    rate = steps * batch["label"].shape[0] / (time.perf_counter() - t0)
    return rate, torch.cuda.max_memory_allocated() / 2**30


def phase_train(dev: torch.device, recipe: Recipe) -> dict:
    fwd, stash, bwd_p, bwd_r = recipe.kernels
    depth, bs, tag = recipe.depth, recipe.train_batch, recipe.train_tag
    gen = torch.Generator(device=dev).manual_seed(3)
    batch = {
        "image": torch.randint(0, 256, (bs, IMG, IMG, 3), generator=gen, device=dev, dtype=torch.uint8),
        "label": torch.randint(0, recipe.model["num_classes"], (bs,), generator=gen, device=dev),
    }
    t0 = time.perf_counter()
    model, state, step = build_trainer(recipe, torch.bfloat16, dev)
    torch.cuda.synchronize()
    print(f"[{tag}] built {recipe.model['name']} ({recipe.model['num_classes']} classes, {depth} attention "
          f"blocks), bf16 compute, f32 parameters, SGD + clip + EMA from the hyp (lr0 {recipe.hyp['lr0']}), "
          f"steps_per_epoch {STEPS_PER_EPOCH}, in {time.perf_counter() - t0:.1f} s")

    # the main path, counted step by step: bf16 training with the P stash
    totals = {k: 0 for k in KERNELS}
    want = only({stash: depth, bwd_p: depth})
    losses, first = [], None
    os.environ.pop("VDK_ATTN_NO_PCACHE", None)
    for i in range(recipe.train_steps):
        reset_counts()
        loss = step(state, batch)["loss"]
        counts = read_counts()
        check(counts == want, f"train step {i}: launches {[(NAMES[k], v) for k, v in counts.items()]}")
        totals = {k: totals[k] + counts[k] for k in KERNELS}
        losses.append(loss.item())
        check(torch.isfinite(loss).item(), f"train step {i}: loss {losses[-1]}")
        if i == 0:
            bad = [n for n, p in model.named_parameters() if p.grad is None or not torch.isfinite(p.grad).all()]
            check(not bad, f"parameters without a finite gradient: {bad[:5]}")
            for suffix in recipe.nonzero_grads:
                named = [(n, p) for n, p in model.named_parameters() if n.endswith(suffix)]
                zero = [n for n, p in named if not p.grad.abs().sum().item() > 0]
                check(len(named) == depth and not zero, f"{suffix} gradients that are zero: {zero}")
            print(f"[{tag}] step 0: all {sum(1 for _ in model.parameters())} parameters have finite "
                  f"gradients; all {depth} {' and all '.join(recipe.nonzero_grads)} gradients are non-zero")
            first = (losses[0], *snapshot(model))
    lr = state.optimizer.optimizer.param_groups[0]["lr"]
    print(f"[{tag}] bf16 bs {bs}, {recipe.train_steps} steps: losses {', '.join(f'{x:.5f}' for x in losses)}; "
          f"launches per step: {depth} stash forwards, {depth} backwards from P, nothing else; "
          f"lr at the last step {lr:.6f}")

    os.environ["VDK_ATTN_NO_PCACHE"] = "1"
    want = only({fwd: depth, bwd_r: depth})
    for i in range(NO_PCACHE_STEPS):
        reset_counts()
        loss = step(state, batch)["loss"]
        counts = read_counts()
        check(counts == want, f"no-pcache step {i}: launches {[(NAMES[k], v) for k, v in counts.items()]}")
        totals = {k: totals[k] + counts[k] for k in KERNELS}
        check(torch.isfinite(loss).item(), f"no-pcache step {i}: loss {loss.item()}")
    os.environ.pop("VDK_ATTN_NO_PCACHE")
    print(f"[{tag}] VDK_ATTN_NO_PCACHE=1, {NO_PCACHE_STEPS} steps: finite losses; launches per step: "
          f"{depth} no-stash forwards, {depth} recompute backwards, nothing else")

    # throughput and memory, interleaved: kernel path with the P stash (the
    # default), kernel path with VDK_ATTN_NO_PCACHE=1 (forward and recompute
    # backward), plain path, then the same in reverse
    runs = (("kernel", KERNEL_PATH, False), ("no-pcache", KERNEL_PATH, True), ("plain", PLAIN_PATH, False))
    rates = {label: [] for label, _, _ in runs}
    for label, path, no_pcache in (*runs, *runs[::-1]):
        if no_pcache:
            os.environ["VDK_ATTN_NO_PCACHE"] = "1"
        rates[label].append(train_rate(model, state, step, batch, path))
        os.environ.pop("VDK_ATTN_NO_PCACHE", None)
    set_fused(model, True)
    print(f"[{tag}] bf16 bs {bs} images/s: " + " | ".join(
        f"{label} path {r[0][0]:.1f}, {r[1][0]:.1f}" for label, r in rates.items())
        + " (order kernel, no-pcache, plain, plain, no-pcache, kernel; no-pcache = the kernel path with "
        "VDK_ATTN_NO_PCACHE=1); max_memory_allocated " + ", ".join(
            f"{label} {r[0][1]:.2f}, {r[1][1]:.2f} GiB" for label, r in rates.items()))
    del model, state, step
    torch.cuda.empty_cache()

    # kernel path vs plain path from the same weights and batch
    compare_one_step(recipe, torch.bfloat16, dev, batch, kernel_side=first)
    small = {k: v[:recipe.f32_train_batch] for k, v in batch.items()}
    compare_one_step(recipe, torch.float32, dev, small)
    torch.cuda.empty_cache()
    return totals


# ---------------------------------------------------------------- profile

# device-time classes of a step, by kernel name (lower case), first match wins
KERNEL_CLASSES = (
    ("attention kernels", ("attention",)),
    ("GEMMs and the patch convolution", ("gemm", "xmma", "cutlass", "nvjet", "cublas", "conv")),
    ("copies and casts", ("copy", "cast", "memcpy", "memset", "transpose")),
    ("LayerNorm", ("layer_norm", "layernorm")),
    ("SGD + clip + EMA (foreach)", ("multi_tensor", "foreach")),
    ("softmax and reductions", ("reduce", "softmax", "norm")),
    ("other elementwise", ("",)),
)


def device_split(fn, steps: int) -> tuple:
    """Per step: device ms by class of kernel, and by attention kernel name,
    from torch.profiler over ``steps`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    split = {label: 0.0 for label, _ in KERNEL_CLASSES}
    attention = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name, ms = e.name.lower(), e.time_range.elapsed_us() / 1e3 / steps
        label = next(lb for lb, keys in KERNEL_CLASSES if any(k in name for k in keys))
        split[label] += ms
        if label == "attention kernels":
            short = re.search(r"(\w*attention\w*kernel)", e.name)
            key = short.group(1) if short else e.name[:60]
            attention[key] = attention.get(key, 0.0) + ms
    return split, attention


def phase_profile(dev: torch.device) -> None:
    """Where the time of the ViT-B/16 bf16 train step and eval step goes on
    the K1 path (bs 128): the unprofiled step time (host clock, synchronised,
    5 steps after 2 warm-up), then device time by kernel class from
    torch.profiler over 3 steps, and the device's idle share."""
    gen = torch.Generator(device=dev).manual_seed(7)
    batch = {
        "image": torch.randint(0, 256, (BATCH, IMG, IMG, 3), generator=gen, device=dev, dtype=torch.uint8),
        "label": torch.randint(0, VIT.model["num_classes"], (BATCH,), generator=gen, device=dev),
    }
    model, state, step = build_trainer(VIT, torch.bfloat16, dev)
    eval_step = make_eval_step(model, StepConfig())
    os.environ.pop("VDK_ATTN_NO_PCACHE", None)
    for what, fn in (("train", lambda: step(state, batch)), ("eval", lambda: eval_step(batch))):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / 5 * 1e3
        split, attention = device_split(fn, steps=3)
        busy = sum(split.values())
        print(f"[profile] vit_b16 {what} bf16 bs {BATCH}, K1 path: step {step_ms:.2f} ms unprofiled "
              f"({BATCH / step_ms * 1e3:.1f} img/s), device busy {busy:.2f} ms, idle share "
              f"{max(0.0, 1 - busy / step_ms):.1%}; device ms per step: "
              + ", ".join(f"{label} {ms:.2f}" for label, ms in split.items())
              + "; attention kernels: " + ", ".join(f"{k} {ms:.2f}" for k, ms in sorted(attention.items())))
    del model, state, step, eval_step
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- vision_attention


# (name, B, H, N, D, layout, timed): ViT-B/16 at bs 128 as contiguous
# tensors and as the views of a packed qkv buffer that the vision path hands
# over, the same views shifted by one element (rows not 16-byte aligned: the
# bf16 kernels stage them element by element), the JAX kernel test's shape,
# ViT-B/8's 785 tokens, head dim 128
VISION_CASES = [
    ("vit_b16", BATCH, 12, 197, 64, "contiguous", False),
    ("vit_b16_packed", BATCH, 12, 197, 64, "packed", True),
    ("vit_b16_unaligned", 16, 12, 197, 64, "unaligned", False),
    ("jax_test", 2, 3, 50, 32, "contiguous", False),
    ("vit_b8_packed", 4, 12, 785, 64, "packed", False),
    ("d128", 8, 8, 197, 128, "contiguous", False),
]


def phase_vision_kernel(dev: torch.device) -> dict:
    """K3 and K3r against their plain versions; returns, per kernel, its max
    error and times (ms) at the ViT-B/16 bf16 shape, strided as the vision
    path gives it."""
    gen = torch.Generator(device=dev).manual_seed(6)
    k3, k3r = K3_KERNELS
    summary = {}
    for name, b, h, n, d, layout, timed in VISION_CASES:
        strided = layout != "contiguous"
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"{name} B={b} H={h} N={n} D={d} {layout} {str(dtype).replace('torch.', '')}"
            if strided:  # q, k, v views of [B, N, 3C]; dO the [B, H, N, D] view of [B, N, C]
                shift = 1 if layout == "unaligned" else 0  # one element into a wider buffer
                qkv = torch.randn((b, n, 3 * h * d + shift), generator=gen, device=dev).to(dtype)
                qkv = qkv[..., shift:shift + 3 * h * d]
                q, k, v = heads_view(qkv, h)
                dout = torch.randn((b, n, h * d + shift), generator=gen, device=dev).to(dtype)
                dout = dout[..., shift:].view(b, n, h, d).transpose(1, 2)
                if shift:
                    check(all(t.data_ptr() % 16 for t in (q, k, v, dout)), f"{tag}: views are 16-byte aligned")
            else:
                q, k, v, dout = (torch.randn((b, h, n, d), generator=gen, device=dev).to(dtype) for _ in range(4))
            tol = TOL[dtype]
            out = vision_attention_fwd(q, k, v)
            ref = vision_attention_plain(q, k, v)
            grads = vision_attention_bwd(q, k, v, dout)
            grads_ref = vision_attention_bwd_plain(q, k, v, dout)
            torch.cuda.synchronize()
            check(out.shape == q.shape and out.is_contiguous() and out.dtype == dtype, f"{tag}: O {out.shape}")
            for t, what in ((out, "O"), *zip(grads, ("dq", "dk", "dv"))):
                check(bool(torch.isfinite(t).all()), f"{tag}: non-finite {what}")
            g_err = max(max_err(g, r, scaled=True) for g, r in zip(grads, grads_ref))
            errs = {k3: max_err(out, ref), k3r: g_err}
            for kk, err in errs.items():
                check(err <= tol, f"{tag}: {NAMES[kk]} error {err} > {tol}")
            line = (f"[vision kernel] {tag}: max|err| fwd {errs[k3]:.3e}, bwd dq/dk/dv "
                    + "/".join(f"{max_err(g, r, scaled=True):.3e}" for g, r in zip(grads, grads_ref))
                    + f" (tol {tol}; dq, dk, dv scaled by max(1, |plain|))")
            if strided:  # the strides change where the kernels read, not what they compute
                same = torch.equal(vision_attention_fwd(*(t.contiguous() for t in (q, k, v))), out) and all(
                    torch.equal(g1, g2) for g1, g2 in zip(
                        vision_attention_bwd(*(t.contiguous() for t in (q, k, v, dout))), grads))
                check(same, f"{tag}: strided views and contiguous copies give other bits")
                line += "; bit-equal to the kernels on contiguous copies"
            print(line)

            if timed and dtype == torch.bfloat16:
                qkv_g = qkv.detach().requires_grad_(True)
                views = heads_view(qkv_g, h)
                o_lib = F.scaled_dot_product_attention(*views)
                e, product = q.element_size(), 2 * b * h * n * n * d
                io = b * h * n * d * e  # one [B, H, N, D] operand
                calls = {
                    k3: (lambda: vision_attention_fwd(q, k, v), lambda: vision_attention_plain(q, k, v),
                         lambda: F.scaled_dot_product_attention(q, k, v), "SDPA on the same q, k, v views",
                         (4 * io, 2 * product)),
                    k3r: (lambda: vision_attention_bwd(q, k, v, dout),
                          lambda: vision_attention_bwd_plain(q, k, v, dout),
                          lambda: torch.autograd.grad(o_lib, views, dout, retain_graph=True),
                          "SDPA's backward alone (torch.autograd.grad), dO -> dq, dk, dv", (7 * io, 5 * product)),
                }
                for kk, (kern, plain, lib, lib_what, work) in calls.items():
                    times = time_row(f"[vision kernel] {tag}", NAMES[kk], kern, plain, lib, lib_what)
                    summary[kk] = {"max_abs_err": errs[kk], **times, **bound(*work, dtype)}
                del qkv_g, views, o_lib, calls
            del q, k, v, dout, out, ref, grads, grads_ref
            torch.cuda.empty_cache()
    return summary


def phase_vision_path(dev: torch.device) -> dict:
    """The construction of benchmarks/attn_ab.py on the port: the pet_synth
    ViT-B/16 with every block's attention core on vision_attention (K3 and
    K3r), one bf16 train step and the eval forward at bs 128 (counted), then
    the same weights on the K1 path: bars in f32 (bs 32), agreement printed
    in bf16, images/s of both paths."""
    tag, k3, k3r = "vision path", *K3_KERNELS
    gen = torch.Generator(device=dev).manual_seed(5)
    batch = {
        "image": torch.randint(0, 256, (BATCH, IMG, IMG, 3), generator=gen, device=dev, dtype=torch.uint8),
        "label": torch.randint(0, VIT.model["num_classes"], (BATCH,), generator=gen, device=dev),
    }
    model, state, step = build_trainer(VIT, torch.bfloat16, dev, VISION_PATH)
    eval_step = make_eval_step(model, StepConfig())

    # the main path, counted: one train step, then the eval forward
    reset_counts()
    loss = step(state, batch)["loss"]
    train_counts = read_counts()
    check(train_counts == only({k3: DEPTH, k3r: DEPTH}),
          f"vision train step launches {[(NAMES[k], v) for k, v in train_counts.items()]}")
    check(torch.isfinite(loss).item(), f"vision train step: loss {loss.item()}")
    first = (loss.item(), *snapshot(model))
    bad = [n for n, g in first[2].items() if not torch.isfinite(g).all()]
    check(not bad, f"vision path: parameters without a finite gradient: {bad[:5]}")
    reset_counts()
    logits = eval_step(batch)
    eval_counts = read_counts()
    check(eval_counts == only({k3: DEPTH}), f"vision eval launches {[(NAMES[k], v) for k, v in eval_counts.items()]}")
    check(logits.shape == (BATCH, VIT.model["num_classes"]) and bool(torch.isfinite(logits).all()),
          f"vision eval logits {tuple(logits.shape)}")
    print(f"[{tag}] bf16 bs {BATCH}: the train step launched {DEPTH} K3 + {DEPTH} K3r and nothing else, "
          f"loss {loss.item():.5f}, finite gradients; the eval forward launched {DEPTH} K3 and nothing else")
    KERNEL_PATH[1](model)
    logits_k1 = eval_step(batch)
    print(f"[{tag}] bf16 eval logits, vision vs K1 path after the step: min row cosine "
          f"{row_cosine(logits, logits_k1).min().item():.6f}, max |diff| {(logits - logits_k1).abs().max().item():.3e}")

    # images/s, interleaved: K1 path, vision path, vision path, K1 path
    rates = {KERNEL_PATH: [], VISION_PATH: []}
    for path in (KERNEL_PATH, VISION_PATH, VISION_PATH, KERNEL_PATH):
        rates[path].append(train_rate(model, state, step, batch, path)[0])
    evals = {KERNEL_PATH: [], VISION_PATH: []}
    for path in (KERNEL_PATH, VISION_PATH, VISION_PATH, KERNEL_PATH):
        path[1](model)
        evals[path].append(images_per_s(eval_step, batch))
    print(f"[{tag}] bf16 bs {BATCH} images/s (order K1, vision, vision, K1): train vision path "
          f"{rates[VISION_PATH][0]:.1f}, {rates[VISION_PATH][1]:.1f} | K1 path {rates[KERNEL_PATH][0]:.1f}, "
          f"{rates[KERNEL_PATH][1]:.1f}; eval vision path {evals[VISION_PATH][0]:.1f}, {evals[VISION_PATH][1]:.1f} | "
          f"K1 path {evals[KERNEL_PATH][0]:.1f}, {evals[KERNEL_PATH][1]:.1f}")
    del model, state, step, eval_step
    torch.cuda.empty_cache()

    # the same weights on both paths: bf16 printed, f32 held to the bars
    compare_one_step(VIT, torch.bfloat16, dev, batch, first, (VISION_PATH, KERNEL_PATH), tag)
    small = {k: v[:F32_TRAIN_BATCH] for k, v in batch.items()}
    compare_one_step(VIT, torch.float32, dev, small, None, (VISION_PATH, KERNEL_PATH), tag)
    model = get_model(VIT.model, dtype=torch.float32, device=dev, generator=torch.Generator().manual_seed(0))
    eval_step = make_eval_step(model, StepConfig())
    VISION_PATH[1](model)
    logits = eval_step(small)
    KERNEL_PATH[1](model)
    cos = row_cosine(logits, eval_step(small)).min().item()
    print(f"[{tag}] f32 bs {F32_TRAIN_BATCH} eval logits, vision vs K1 path: min row cosine {cos:.6f} "
          f"(want >= {MIN_COSINE})")
    check(cos >= MIN_COSINE, f"f32 vision path logits: min row cosine {cos} < {MIN_COSINE}")
    del model, eval_step
    torch.cuda.empty_cache()
    return {k: train_counts[k] + eval_counts[k] for k in KERNELS}


def main() -> None:
    phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    kern = {**phase_kernel(dev), **phase_window_kernel(dev), **phase_vision_kernel(dev)}
    launches = {k: 0 for k in KERNELS}
    for recipe in (VIT, SWIN):
        serving = phase_slice(dev, recipe)
        training = phase_train(dev, recipe)
        if recipe is VIT:
            phase_profile(dev)
        print(f"[launches] {recipe.model['name']} serving: {serving[recipe.kernels[0]]} no-stash forwards; "
              f"training: " + ", ".join(f"{NAMES[k]} {training[k]}" for k in recipe.kernels))
        launches = {k: launches[k] + serving[k] + training[k] for k in KERNELS}
    vision = phase_vision_path(dev)
    print("[launches] vision path: " + ", ".join(f"{NAMES[k]} {vision[k]}" for k in K3_KERNELS))
    report(kern, {k: launches[k] + vision[k] for k in KERNELS})


def report(kern: dict, launches: dict) -> None:
    """Each kernel's bound line and the two JSON lines that end the run."""
    kernels = []
    for k in KERNELS:
        source, replaces = SOURCES[k]
        check(launches[k] > 0, f"{NAMES[k]} was not launched on the main path")
        row = kern[k]
        print(f"[bound] {NAMES[k]}: {row['bytes'] / 1e6:.1f} MB, {row['flops'] / 1e9:.2f} GFLOP -> bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']} (3.35 TB/s; 989 TFLOP/s bf16); kernel "
              f"{row['ms']:.4f} ms = {row['bound_ms'] / row['ms']:.2%} of bound; plain {row['plain_ms']:.4f} ms; "
              f"library {'none' if row['library_ms'] is None else format(row['library_ms'], '.4f') + ' ms'}")
        kernels.append({"name": NAMES[k], "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[k], **{key: row[key] for key in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
