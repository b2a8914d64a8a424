#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port (visiondk_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line or more each; any failure raises and exits non-zero:

1. device  — needs CUDA (exits non-zero without it); prints the card's name
             and power limit as nvidia-smi reports them; TF32 off for the
             f32 comparisons.
2. build   — compiles the fused QKV attention kernel from
             visiondk_tpu_torch/csrc/ with nvcc for sm_90a into
             visiondk_tpu_torch/_build/.
3. kernel  — the kernel against its plain PyTorch version at the ViT-B/16
             shape and at smaller odd shapes, f32 (max |err| ≤ 1e-4) and bf16
             (≤ 1.6e-2, about two bf16 ulps at |o| ≈ 1); times both at the
             ViT-B/16 shape with CUDA events.
4. slice   — the serving path at full ViT-B/16 width: the classification model
             of configs/classification/pet_synth.yaml and the 128-d embedding
             model, seeded weights, bf16, batches of 128 seeded uint8
             224×224 images through make_eval_step and make_embed_step. The
             kernel must launch exactly 12 times per forward, and logits and
             embeddings must match the same models on the plain attention
             path (per-row cosine ≥ 0.999). Prints images/s of both paths.
             The same models in f32 must also agree on the argmax of ≥ 99% of
             rows (in bf16 the argmax agreement is printed: the two paths
             round at different places, and at random init a few percent of
             rows have near-tied top-2 logits).

The line before the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

from visiondk_tpu_torch.engine.steps import StepConfig, make_embed_step, make_eval_step
from visiondk_tpu_torch.models import get_model
from visiondk_tpu_torch.models.layers import Attention
from visiondk_tpu_torch.ops import _build
from visiondk_tpu_torch.ops.attention import fused_qkv_attention, fused_qkv_attention_plain

# the `model:` section of configs/classification/pet_synth.yaml
PET_SYNTH_MODEL = {
    "task": "classification", "load_from": None, "name": "vit_base_patch16_224",
    "image_size": 224, "kwargs": {}, "num_classes": 35, "pretrained": False,
    "backbone_freeze": False, "bn_freeze": False, "bn_freeze_affine": False,
    "attention_pool": False,
}
# the embedding model of bench.py: ViT-B/16 backbone, 128-d neck, no head
EMBED_MODEL = {"task": "cbir", "backbone": {"vit_base_patch16_224": {"feat_dim": 128, "image_size": 224}}}

BATCH = 128
DEPTH = 12  # ViT-B/16 blocks, one kernel launch each per forward
N_BATCHES = 3
TOL = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}
MIN_COSINE = 0.999
MIN_ARGMAX_AGREEMENT = 0.99


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


def phase_build() -> None:
    built = _build.build("fused_qkv_attention")
    print(f"[build] {built.path.relative_to(_build.BUILD_DIR.parent.parent)} in "
          f"{built.seconds:.2f} s: {' '.join(built.command)}")
    for line in built.ptxas_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] ptxas: {line.strip()}")


def phase_kernel(dev: torch.device) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    # (name, B, N, heads, head_dim, n_valid): the ViT-B/16 main-path shape, the
    # JAX kernel test's unaligned N with a key mask, ViT-B/8's 785 tokens, and
    # ViT-H/14's head_dim 80
    cases = [
        ("vit_b16", BATCH, 197, 12, 64, None),
        ("unaligned", 8, 37, 4, 32, 29),
        ("vit_b8", 4, 785, 12, 64, None),
        ("hd80", 4, 257, 16, 80, 250),
    ]
    summary = {}
    for name, b, n, h, d, n_valid in cases:
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn((b, n, 3 * h * d), generator=gen, device=dev).to(dtype)
            out = fused_qkv_attention(qkv, h, n_valid)
            ref = fused_qkv_attention_plain(qkv, h, n_valid)
            torch.cuda.synchronize()
            rows = n if n_valid is None else n_valid
            err = (out[:, :rows].float() - ref[:, :rows].float()).abs().max().item()
            check(bool(torch.isfinite(out[:, :rows]).all()), f"{name} {dtype}: non-finite output")
            check(err <= TOL[dtype], f"{name} {dtype}: max |kernel - plain| {err} > {TOL[dtype]}")
            line = (f"[kernel] {name} B={b} N={n} H={h} d={d} n_valid={n_valid} {dtype}: "
                    f"max|err| {err:.3e} (tol {TOL[dtype]})")
            if name == "vit_b16":
                plain_ms = cuda_ms(lambda: fused_qkv_attention_plain(qkv, h), iters=20)
                ms = cuda_ms(lambda: fused_qkv_attention(qkv, h), iters=20)
                ms2 = cuda_ms(lambda: fused_qkv_attention(qkv, h), iters=20)
                plain_ms2 = cuda_ms(lambda: fused_qkv_attention_plain(qkv, h), iters=20)
                line += (f" | kernel {ms:.4f}, {ms2:.4f} ms | plain {plain_ms:.4f}, "
                         f"{plain_ms2:.4f} ms (order plain, kernel, kernel, plain)")
                summary[dtype] = {"max_abs_err": err, "ms": (ms + ms2) / 2,
                                  "plain_ms": (plain_ms + plain_ms2) / 2}
            print(line)
    return summary


def set_fused(model: torch.nn.Module, on: bool) -> None:
    for m in model.modules():
        if isinstance(m, Attention):
            m.use_fused = on


def images_per_s(step, batch: dict, iters: int = 10) -> float:
    return BATCH / (cuda_ms(lambda: step(batch), iters=iters, warmup=2) / 1000.0)


def row_cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = a.double(), b.double()
    return (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1)).clamp_min(1e-30)


def build_models(dtype: torch.dtype, dev: torch.device):
    cls_model = get_model(PET_SYNTH_MODEL, dtype=dtype, device=dev,
                          generator=torch.Generator().manual_seed(0))
    emb_model = get_model(EMBED_MODEL, dtype=dtype, device=dev,
                          generator=torch.Generator().manual_seed(1))
    return cls_model, emb_model


def compare_paths(cls_model, emb_model, batches, dtype: torch.dtype) -> int:
    """Eval and embed steps on every batch through the kernel (counted), then
    on the plain attention path; checks shapes, finiteness, launch counts
    and agreement. Returns the kernel launches of the counted run."""
    name = str(dtype).replace("torch.", "")
    eval_step = make_eval_step(cls_model, StepConfig())
    embed_step = make_embed_step(emb_model, StepConfig())

    fused_qkv_attention.launches = 0
    logits = [eval_step(b) for b in batches]
    torch.cuda.synchronize()
    eval_launches = fused_qkv_attention.launches
    feats = [embed_step(b) for b in batches]
    torch.cuda.synchronize()
    launches = fused_qkv_attention.launches
    embed_launches = launches - eval_launches
    print(f"[slice] {name}: kernel launches eval {eval_launches}, embed {embed_launches} "
          f"over {len(batches)} batches each (want {DEPTH} per forward)")
    check(eval_launches == DEPTH * len(batches), f"eval launched the kernel {eval_launches} times")
    check(embed_launches == DEPTH * len(batches), f"embed launched the kernel {embed_launches} times")

    set_fused(cls_model, False)
    set_fused(emb_model, False)
    logits_ref = [eval_step(b) for b in batches]
    feats_ref = [embed_step(b) for b in batches]
    torch.cuda.synchronize()
    set_fused(cls_model, True)
    set_fused(emb_model, True)
    check(fused_qkv_attention.launches == launches, "the plain path launched the kernel")

    for tag, outs, refs, width in (("logits", logits, logits_ref, 35), ("embeddings", feats, feats_ref, 128)):
        out, ref = torch.cat(outs), torch.cat(refs)
        check(out.shape == (BATCH * len(batches), width) and out.dtype == torch.float32,
              f"{tag}: shape {tuple(out.shape)} dtype {out.dtype}")
        check(bool(torch.isfinite(out).all()), f"{tag}: non-finite values")
        cos = row_cosine(out, ref).min().item()
        line = (f"[slice] {name} {tag} kernel vs plain path: min row cosine {cos:.6f} "
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
    return launches


def phase_slice(dev: torch.device) -> int:
    gen = torch.Generator(device=dev).manual_seed(2)
    batches = [
        {"image": torch.randint(0, 256, (BATCH, 224, 224, 3), generator=gen, device=dev, dtype=torch.uint8)}
        for _ in range(N_BATCHES)
    ]
    t0 = time.perf_counter()
    cls_model, emb_model = build_models(torch.bfloat16, dev)
    torch.cuda.synchronize()
    print(f"[slice] built {PET_SYNTH_MODEL['name']} (35 classes) and the 128-d embedding model, "
          f"bf16, seeded weights, in {time.perf_counter() - t0:.1f} s")

    # the main path, counted: bf16 serving
    launches = compare_paths(cls_model, emb_model, batches, torch.bfloat16)

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
        print(f"[slice] {tag} bs {BATCH} bf16 images/s: kernel path {k[0]:.1f}, {k[1]:.1f} | "
              f"plain path {p[0]:.1f}, {p[1]:.1f} (order kernel, plain, plain, kernel)")
    del cls_model, emb_model, steps, model, step
    torch.cuda.empty_cache()

    # the same check in f32, where the two paths differ only in f32 rounding
    compare_paths(*build_models(torch.float32, dev), batches, torch.float32)
    return launches


def main() -> None:
    phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    kern = phase_kernel(dev)
    launches = phase_slice(dev)
    main_path = kern[torch.bfloat16]
    print(json.dumps({"kernels": [{
        "name": "fused_qkv_attention",
        "route": "cuda",
        "source": "visiondk_tpu_torch/csrc/fused_qkv_attention.cu",
        "replaces": "visiondk_tpu/ops/pallas/attention.py:198",
        "launches": launches,
        "max_abs_err": main_path["max_abs_err"],
        "ms": main_path["ms"],
        "plain_ms": main_path["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
