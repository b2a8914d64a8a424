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
             SASS of all four libraries (cuobjdump): every bf16 instantiation
             of the forward, dq and dkv kernels (head-dim buckets 32, 64, 80,
             128 x variant), of the window forward, ws <= 8 and the tiled
             8 < ws <= 16 (32, 64 x shift regions or none x stash or none)
             and of the window backward, ws <= 8 and the tiled dq and dkv
             kernels (32, 64 x shifted or not x from P or recomputing) must
             issue tensor-core instructions (HMMA, or HGMMA for wgmma),
             counted per kernel; the float32 CUDA-core kernels
             must have no bf16 instantiation. For every instantiation of the
             tiled bf16 kernels (window forward, dq, dkv): registers, stack
             and static shared memory (cuobjdump --dump-resource-usage), spill
             bytes (ptxas), its dynamic shared memory (held equal to the
             wrapper's planning figure) and blocks an SM
             (cudaOccupancyMaxActiveBlocksPerMultiprocessor, at least the
             blocks the wrapper plans its runs of windows for).
3. kernel  — each of the four kernels against its plain PyTorch version on
             the same inputs, at the ViT-B/16 shape and at smaller odd shapes
             (N=37 with a key mask, ViT-B/8's N=785, head dim 80, N=200 whose
             P rows are 16-byte aligned), and at SigLIP So400m's N=256, 16
             heads of head dim 72 (the 80-wide bucket, columns 72-79 staged
             as zeros) at bs 4, 64 and 128, f32 and
             bf16: the no-stash forward (O), the stash forward (O bit-equal to
             the no-stash kernel's, and P), the backward from P (both sides
             fed the kernel's stash) and the recompute backward (dqkv).
             Tolerances: O max |err| ≤ 1e-4 f32 / 1.6e-2 bf16 (about two bf16
             ulps at |o| ≈ 1); P ≤ 1e-5 f32 / 2**-8 bf16 (one bf16 ulp at
             p ≤ 1); dqkv |err| ≤ tol · max(1, |plain|) with the O tolerances
             (both sides compute in f32 from the same inputs and round the
             result). Times each kernel and its plain version at the ViT-B/16
             shape with CUDA events, in the order plain, kernel, kernel, plain,
             and at So400m's the bf16 stash forward and backward from P at bs
             64 (its train batch) and the forward at bs 128 (its serving
             batch), each beside SDPA; those get `[bound so400m]` lines.
4. slice   — the serving path at full ViT-B/16 width: the classification model
             of configs/classification/pet_synth.yaml and the 128-d embedding
             model, seeded weights, bf16, batches of 128 seeded uint8
             224×224 images through make_eval_step and make_embed_step. The
             no-stash kernel must launch exactly 12 times per forward (and no
             other kernel), and logits and embeddings must match the same
             models on the plain attention path (per-row cosine ≥ 0.999).
             Prints images/s of both paths. The same models in f32 must also
             agree on the argmax of ≥ 99% of rows.
4q. int8 serving (phase Q8) — inside the ViT-B/16 and Swin-B slices, on
             their models. The int8 GEMM (torch._int_mm behind ops/quant.py's
             zero padding) equal to the float64 product of its codes at
             ViT-B/16's fc1 at bs 128, its 37-class head on one image, SwinV2's
             cpb_fc1 at ws 8 (K 2), a 1000-class head and an odd shape; an
             unpadded 1-row product raises (nothing falls back to a float
             product); one int8 dense at fc1 split into its quantize, _int_mm
             and dequant beside bf16 F.linear and the int8 bound. The ViT-B/16
             weight cache's codes and scales on the card equal the CPU's. The
             eval and embed steps with quant="int8" (12 K1 or 24 K2 a forward):
             per-row cosine of the int8 embeddings >= 0.99 to the bf16 and the
             f32 ones, ViT-B/16's int8 logits >= 0.995 to f32 (Swin-B's
             printed); embed images/s in the order bf16, int8, int8, bf16.
4c. cam     — inside the same slices, on their f32 models: every CAM method
             of utils/cam.py on ViT-B/16 (gradcam and fullgrad on Swin-B), one
             image, class 3, the kernel path (counted: the stash forward and
             the backward from P after the target layer, 18 K1s and K1b on
             ViT-B/16, 25 K2s and K2b on Swin-B) against the plain attention
             path: the heat maps within 1e-3 of their largest value (1e-2 for
             ablationcam, scorecam and fullgrad).
3w. window kernel — each of the four window-attention kernels against its
             plain version, f32 and bf16, at the Swin-B (bs 80) stage shapes
             (stage 0: 56×56, 4 heads, unshifted and shifted; stage 2: 14×14,
             16 heads, shifted; stage 3: 7×7, 32 heads, one window) and at odd
             shapes (the JAX kernel test's B=4, 8×8, ws 4, 2 heads, shift 2;
             ws 8 with head dim 64 and scale 1.0, SwinV2's call; head dim 12,
             whose rows are not 16-byte aligned: the bf16 kernels load and
             store them element by element); then the tiled bodies of
             8 < ws <= 16 at SwinV2-L's stages at bs 32 (stage 0: 64×64, 6
             heads, ws 16 shifted by 8; stage 1: 32×32, 12 heads, shifted;
             stage 2: 16×16, 24 heads, one window; scale 1.0), ws 12 (N =
             144), ws 16 at head dim 64, ws 9 (the stash's rows not 16-byte
             aligned) and head dim 12 at ws 16. A shifted case hands its shift
             to the kernels, which wrap their addresses (the plain versions
             roll). In bf16 all four run on the tensor cores, over fixed runs
             of windows per block. O, P and dqkv
             are held to phase 3's bars, but O in bf16 element by element to
             max(1.6e-2, one bf16 ulp of |plain|): the same bar where |plain|
             < 4 and one ulp above it (SwinV2's scale 1.0 reaches |o| ≈ 5 at
             ws 16, where the kernel's f32 summation order can flip the last
             rounding); the stash forward's O must be
             bit-equal to the no-stash kernel's; dbias (f32 in both dtypes)
             within 1e-4 · max(1, max |plain|): both sides sum the same f32
             terms over up to 5120 windows in another order. A repeated
             backward from P must return bit-identical dbias. Times all four
             kernels and their plain versions at the stage-0 (unshifted) and
             stage-2 bf16 shapes and at SwinV2-L's stage 0, in the order plain,
             kernel, kernel, plain, beside SDPA with the bias as attn_mask on
             pre-partitioned windows; the SwinV2-L rows print the first tiled
             bodies' times (PERF.md) beside their own and get `[bound ws16]`
             lines at the end.
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
             no-pcache, plain, plain, no-pcache, kernel), each trial 4
             synchronised steps after 1 warm-up, each printed.
5p. profile — the bf16 train step (its train batch) and eval step (bs 128)
             on the kernel path: unprofiled step time (4 steps after 1
             warm-up), then device time per step by kernel class
             (attention kernels by name, GEMMs, copies and casts, LayerNorm,
             optimizer, reductions, other elementwise) from torch.profiler
             over 3 steps, and the device's idle share. Run after phase 5
             for ViT-B/16 and after phase 7 for Swin-B; then for the bf16
             Swin-B embedding train step of configs/faceX/face_synth.yaml
             (Swin-B, 128-d neck, ArcFace over 64 classes, bs 64, its hyp):
             24 K2s + 24 K2b in a step, the same split, and the margin head
             with its loss (ArcFace + CE, forward and backward) as rows of
             their own: profiled alone at the step's shapes and at
             face.yaml's 58,671 classes, CUDA-event and device time.

6. swin serving, 7. swin train — phases 4 and 5 for Swin-B
             (swin_base_patch4_window7_224), the reference's default recipe:
             the `model:` section of configs/classification/pet.yaml (35
             classes, 224²) and the embedding model of configs/faceX/cbir.yaml
             (Swin-B backbone, 128-d neck; serving embeds, so no margin
             head), seeded weights. Serving: bs 128 through make_eval_step and
             make_embed_step, exactly 24 window-attention forwards per forward
             and no other kernel, the same bars. Training: pet.yaml's hyp (SGD
             lr0 0.006, momentum 0.8 → 0.937, wd 5e-4, cosine_with_warm, clip
             10), CE with label smoothing 0.05 and the EMA, bs 80 (its batch);
             3 steps of 24 stash forwards + 24 backwards from P, 2 steps of
             24 + 24 recompute with VDK_ATTN_NO_PCACHE=1; every qkv.weight and
             relative_position_bias_table gradient non-zero after the first;
             the one-step f32 comparison at bs 16 with phase 5's bars.
6v, 7v. swinv2 serving, swinv2 train — phases 6 and 7 for SwinV2-B
             (swinv2_base_window8_256 at its registered 256², 24 blocks,
             heads 4/8/16/32, every window 8×8): pet.yaml's `model:`
             section and hyp with that name and size, and the 128-d
             embedding model on it. K2 runs at scale 1.0 (the clamped,
             exponentiated logit scale folded into the L2-normalised q) with
             the continuous log-CPB bias, whose gradient K2b's dbias carries
             into the CPB MLP. Serving at bs 128 (24 K2 a forward), training
             at bs 64 (24 K2s + 24 K2b a step; 24 K2 + 24 K2r with
             VDK_ATTN_NO_PCACHE=1), every qkv.weight, logit_scale and
             cpb_mlp.0.weight gradient non-zero after the first step, the
             same bars, and its profile.

DA. device augment — the device-augment stage (visiondk_tpu_torch/ops/
             device_augment.py) at pet_synth's shape: a seeded uint8 batch of
             128 224² images on the card. Every compiler of the registry with
             its defaults (random_crop at 192), every branch of pet_synth's two
             lifted items forced (its random_choice's seven, hflip at p 1), and
             both items as drawn: apply on the card against apply on a CPU copy
             with the same host draws (random_cutaddnoise's CPU side takes the
             noise the card drew from its seed). Flips, invert, grayscale,
             autocontrast, equalize, crop, cutout and the noise holes equal;
             the rest (blends, hue, blur, rotate, affine, AugMix, RandAugment)
             within 1 LSB with ≥ 99% of pixels equal. pet_synth's whole stage
             once under torch.cuda.set_sync_debug_mode("error"): a hidden
             device→host sync fails the phase. Its time per batch (CUDA events,
             10 calls after 2 warm-up, and the host clock) at bs 128 beside
             phase 5's ViT-B/16 step, and at pet.yaml's bs 80.
DT. determinism probe — a subprocess (CUBLAS_WORKSPACE_CONFIG=:4096:8),
             started after the run loop and running beside phases ML and DS
             (which check no timing):
             one bf16 train step each of face_synth's Swin-B embedding model
             (with the fixed-order relative-position bias gather, and with
             index_select's, the state before the repair), multilabel_csv's
             resnet50 (deterministic cuDNN, and torch's defaults),
             convnext_base and mobilenetv3_large_100 (depthwise
             convolutions; deterministic cuDNN) and the distillation
             step: the ops torch.use_deterministic_algorithms
             (warn_only) names, and the parameters whose gradients differ
             between two backward passes from the same weights and batch.
             The repaired steps must show neither.
CN. cnn — the CNN families at full width: multilabel_csv.yaml's resnet50
             (3 classes, BCE, train bs 64), distill_example.yaml's student
             resnet18 (35 classes, CE, train bs 128), and pet.yaml's model
             list beyond ResNet (35 classes, CE): convnext_base (bs 64),
             mobilenetv3_large_100 (bs 128), efficientnetv2_s (bs 64) and
             tf_efficientnetv2_s (bs 64, TF 'SAME' padding), seeded weights,
             bf16, 224², channels_last convolutions: 3 train steps and an
             eval forward (finite, no attention kernel launched), eval
             images/s at bs 128, train images/s and peak memory with cuDNN's
             deterministic algorithms (the trainer's setting), and for
             resnet50 also with torch's defaults (resnet18 and convnext_base
             too until PR 16; order det, defaults, defaults, det), the step's
             device time by
             class (convolutions, BatchNorm, layout transposes, copies and
             casts, pooling, optimizer, elementwise) and idle share for
             resnet50 and convnext_base (every row but resnet18 until PR 16),
             and one train step (bs 2) on the card
             against the CPU in float64 (model, loss and pixels): loss within
             1e-5 relative, every gradient, update and BN statistic within
             1e-3 of its tensor's largest entry (a tensor whose exact
             gradient is zero, a BatchNorm bias that a linear layer and a
             train-mode BatchNorm follow, is held against 1e-9 of the
             largest entry of its kind). Until PR 16 the same step in f32 was
             printed for resnet50 and resnet18 beside the CPU's own f32
             against float64 (at random init the last stage's gradients lose
             up to a fifth of their largest entry to f32 rounding on either
             device; CNN_F32_PRINTED names the rows that print it).
RL. run loop — the classification run loop through the port's own CLIs, on a
             temporary directory: benchmarks/make_synth_pet.py (a subprocess,
             started after phase 1 and shared with ML and DS) writes 20
             train and 4 val JPEGs per class (700 / 140), and
             configs/classification/pet_synth.yaml runs as written
             (data.train.device_augment "auto": the host keeps decode and the
             letterbox-or-RRC, the device-augment stage runs the rest) with
             these cuts, printed: that dataset size, hyp.epochs 3 (epoch 0 on
             the val augments, 1 on the full train pipeline, the one epoch in
             which the stage is live, 2 weakened from aug_epoch 2), everything
             else as written (ViT-B/16, bs 128 bf16, val bs 320). Needs PyYAML
             and PIL: without them the phase fails and names the one missing.
             Run A: `python -m visiondk_tpu_torch.main` in this process (runpy,
             sys.argv as on the command line): the split line the trainer
             logged, the epoch table, trainer-fed images/s per epoch, which
             loaders ran (native or PIL), exactly 12 x 15 K1s, 12 x 15 K1b and
             12 x 3 K1 launches (5 steps and one val batch an epoch), no other
             attention kernel, and the stage's calls per epoch exactly 0 / 5 /
             0 (make_device_augment.calls, read at each epoch's start). Run B,
             the same command through `python -m torch.distributed.run
             --nproc_per_node 1 -m visiondk_tpu_torch.main --multihost` (one
             NCCL rank: DDP, a one-rank all-reduce; a subprocess, run beside
             run C's first process and the serving CLIs below): per-epoch
             train loss, val loss and top1 bit-identical to run A's. Run C,
             the same command as a subprocess, SIGKILLed in epoch 1 once epoch
             0's checkpoint is complete on disk, then `--resume` in this
             process (after the serving CLIs): it must resume from epoch 1
             with stage calls 5 / 0, bit-identical to run A. The serving
             CLIs' and EX's timings run after runs B and C, with nothing
             beside them.
             `python -m visiondk_tpu_torch.validate --ema` on run A's best
             checkpoint: 12 K1 launches and exactly run A's best-epoch top1;
             `validate --quant int8` on it: top1 within 0.02 of that; `python -m
             visiondk_tpu_torch.visualize --cam --cam_method gradcam --sampling
             8 --remove_label`: 8 side-by-side overlays and 8 label files, one
             K1s and one K1b an image. Then phase EX on the same checkpoint:
             `python -m visiondk_tpu_torch.export --ema --batch -1` and the
             same with `--quant int8` (seconds, MB; the fake implementations
             launch nothing while tracing), each program loaded back and held
             to its eager step (make_eval_step, bf16; `quant="int8"` with the
             served model's weight cache) on the same uint8 batches at bs 1, 8
             and 128: max |diff| within 1e-5 of the largest |logit|, argmax
             equal, bit-identity printed, exactly 12 K1 a forward and nothing
             else; images/s of program and eager step at bs 128 (CUDA events,
             order eager, program, program, eager) and each one's host time
             to enqueue a call; `python -m
             visiondk_tpu_torch.tools.exported_predict` in a fresh process
             prints single_predict's top-5 on a val JPEG at 224² (neither
             resizes it); and the K1 operator against a direct launch of its
             kernel at bs 128 (device ms and host µs a call). Last, images/s of the train loader
             alone on epoch 1 (no step) with the split host pipeline and with
             the full one (the device_augment: false processor), each as the
             trainer builds it (4 batches in flight), beside the trainer-fed
             epochs and phase 5's synthetic batch, and whether the
             trainer-fed run is host-paced.
ML. multilabel run — configs/classification/multilabel_csv.yaml through
             the port's CLIs on a CSV written over RL's synthetic JPEGs (the
             first 10 train JPEGs a class and every val JPEG)
             (image_path, train True/False, three label columns: the bits of
             class index mod 7 + 1), read with the stdlib csv module (pandas
             never loads), with data.root and hyp.epochs 2 cut (printed):
             resnet50, BCE, the focal swap from epoch 1, bs 64. Run A
             (in-process; no attention kernel), run B bit-identical to A,
             run C (its first process beside run B) SIGKILLed in epoch 1 and
             resumed, bit-identical to A from
             epoch 1, validate --ema on A's best reproducing its P/R/F1
             exactly; trainer-fed images/s per epoch.
DS. distill — the teacher: configs/classification/pet.yaml (Swin-B, bs 80)
             through `python -m visiondk_tpu_torch.main` on RL's synthetic
             JPEGs (10 train a class, every val JPEG), hyp.epochs 2, runs A
             and B bit-identical, exactly 24 K2s
             + 24 K2b a step and 24 K2 a val forward. The student:
             configs/classification/distill_example.yaml --distill with the
             student's data.root and hyp.epochs 2 cut and teacher.weight
             teacher run A's best (EMA), runs A and B bit-identical, exactly
             24 K2 a student step and no other attention kernel. Then the
             distillation step alone on a synthetic bs-128 batch (24 K2,
             images/s) and one f32 step with the teacher on K2 against the
             teacher on the plain window attention, to phase 5's bars.
V2. swinv2 run — configs/classification/pet.yaml with SwinV2-B in Swin-B's
             place (model.name swinv2_base_window8_256 and the resize_size
             anchor 256, which model.image_size and every resize of the
             file read) through `python -m visiondk_tpu_torch.main` on RL's
             synthetic JPEGs (10 train a class, every val JPEG), data.root
             and hyp.epochs 2 cut (printed):
             runs A and B in this process, bit-identical, exactly 24 K2s +
             24 K2b a step and 24 K2 a val forward; `validate --ema` on A's
             best reproducing its top1 exactly.
V2L. swinv2 large — swinv2_large_window12to16_192to256 at 256² (embed 192,
             depths (2, 2, 18, 2), full width and depth, seeded weights)
             attends in 16×16 windows (N = 256) in stages 0-2, on the window
             kernels' tiled bodies. Serving, bf16, bs 64: exactly 24 K2 a
             forward, 22 of them on ws-16 windows; logits against the plain
             path, per-row cosine >= 0.999; images/s of both paths; its
             profile. Training, bf16, bs 32, pet.yaml's hyp: 3 steps of 24
             K2s + 24 K2b (22 each on ws-16 windows), one step of 24 K2 + 24
             K2r with VDK_ATTN_NO_PCACHE=1, every qkv.weight, logit_scale
             and cpb_mlp.0.weight gradient non-zero after the first;
             images/s and peak memory (kernel, plain, kernel), its profile;
             the repeat check (no gradient differs between two identical
             backward passes); one f32 step at bs 4 against the plain path
             with phase 5's bars; ws 17 on the card raises the wrapper's
             ValueError naming the limit. Then the V2 run with SwinV2-L in
             SwinV2-B's place (2 epochs, A = B bit-identical, exact launches,
             22 of each 24 on ws-16 windows, validate --ema's top1 exact).
SO. so400m — vit_so400m_patch14_siglip_224 at 224² (27 blocks, width
             1152, MLP 4304, 16 heads of head dim 72, 256 tokens, no CLS, the
             map pool: AttentionPoolLatent), full width and depth, seeded,
             pet.yaml's model section and hyp with the name swapped, built
             once (its weights kept on the card; the compute dtype switched
             in place). Serving bf16 bs 128: exactly 27 K1 a forward and
             nothing else, logits against the plain path (per-row cosine >=
             0.999; in f32 also argmax >= 99%), images/s, its profile.
             Training bf16 bs 64, SGD + clip + EMA: one step with remat off
             (27 K1s + 27 K1b) and one with remat on (54 K1s: the forward's
             and the recompute's, 27 K1b), every gradient finite, every
             qkv.weight gradient non-zero; images/s and peak memory (order
             off, on, on, off) and the profile of each. One f32 step at bs 4
             from the same weights: kernel path against the plain path, and
             remat on against remat off, at phase 5's bars (bit-identity
             printed). Then remat on SwinV2-B, f32 bs 8 (24 K2s twice and 24
             K2b a step), on against off at the same bars; one f32 SAM step
             (SGD base, the second pass at w + e(w)) of ViT-B/16 at bs 32,
             kernel path against plain path at the same bars (24 K1s + 24 K1b:
             two passes), and of resnet18 at bs 2 on the card against the CPU
             in float64 at phase CN's bars (the BatchNorm statistics are the
             first pass's); Swin-B with attention_pool (AttentionPooling over
             its token map, an f32 fc) serving bf16 bs 128 against the plain
             path (per-row cosine >= 0.999).
SO run. configs/classification/pet.yaml with model.name
             vit_so400m_patch14_siglip_224, model.kwargs {remat: true} and
             hyp.optimizer [sam, False] through `python -m
             visiondk_tpu_torch.main` on 5 of the run loop's train JPEGs a
             class (175: 2 steps of pet.yaml's bs 80) and its val JPEGs,
             hyp.epochs 2: runs A and B bit-identical, exactly 108 K1s + 54
             K1b a step (two passes, each recomputing) and 27 K1 a val
             forward; trainer-fed images/s and each checkpoint's bytes;
             `validate --ema` on A's best reproduces its top1 exactly. No
             killed-and-resumed run here (the run loop, ST and ER hold resume).
ST. strategies — configs/classification/pet_synth.yaml (ViT-B/16, bs 128,
             the device-augment stage) through the port's CLIs with mixup
             (ratio 0.2, duration 1: live in epoch 1, after warm_ep), OHEM on
             ([True, 8, 0.7, 255]) and hyp.accumulate 2, 2 epochs, on 11 of
             the run loop's train JPEGs a class (3 steps an epoch, so epoch
             0 ends in the middle of an accumulation round): runs A and B
             bit-identical, exactly 12 K1 (the OHEM forward) + 12 K1s + 12
             K1b a step and 12 K1 a val forward, the last checkpoint's
             mini-step, applied-update and EMA counts; run C (its first
             process beside run B) SIGKILLed in epoch 1 (epoch 0's checkpoint
             holds the half round) and resumed, bit-identical to A; validate
             --ema reproduces A's best top1.
MH. margin heads — every margin head of visiondk_tpu_torch/models/heads.py
             (ArcFace, MagFace, CircleLoss, MV-Softmax AM and Arc), forward
             and gradient, on the card in f32 against the same function in
             float64 on the CPU, at face_synth's bs 64, 128-d, 64 classes and
             at face.yaml's 58,671 classes, with the caller's
             allow_tf32 on (the heads must not depend on it): logits within
             1e-4 at scale 32 (x s/32 at another scale: CircleLoss's γ 256),
             MagFace's aux within 1e-6 relative, gradients within 1e-5 of
             their largest entry; what a TF32 product would do is printed.
             Exact retrieval (ops/retrieval.py): topk_ip and search (query
             chunks) at 512 queries x 50,000 x 128 (the last 2,000 gallery
             rows repeat the first: exact ties), k 100, against a float64
             CPU brute force over the same bf16-rounded inputs: scores within
             1e-5 rank by rank, indices equal wherever consecutive f64
             scores differ by more than 1e-5 and in every exact tie (the
             lower index first). Queries/s of exact search at a 1,000,000 x
             128 gallery, 1,024 queries, k 100 (CUDA events), split into the
             scores' product and the top-k. Phase AR on the same gallery:
             approximate search (recall_target 0.9, 0.95, 0.99: the bin count
             M, queries/s beside exact's, the bin maxima + top-k alone, the
             mean recall@100 against exact search, at least the target less
             0.005, and the returned scores the true ones); then at 4 queries
             x 65,536 the card's approximate top-101 against the CPU's, held
             as exact search is held to its brute force.
ER. embedding run — the face and CBIR run loops through the port's CLIs on
             Swin-B, on a temporary directory: benchmarks/make_synth_face.py
             (a subprocess, its defaults but --n-train 4: 64 ids x 4 train,
             4 val, 300 pairs, and the CBIR twin: 64 queries, 192 gallery
             images; started after
             phase 1 on one CPU core, so it overlaps the phases before), then
             configs/faceX/face_synth.yaml as written with data.root, its
             pair file and hyp.epochs 2 cut (printed; 3 before the CNN,
             multi-label and distillation phases came). Run A (`python -m
             visiondk_tpu_torch.main` in this process): the split line the
             trainer logged, per-epoch loss, pair mean, trainer-fed images/s
             and checkpoint bytes written; exactly 24 K2s + 24 K2b per train
             step and 24 K2 per evaluation forward, nothing else; the stage's
             calls equal to the steps in every epoch (read at each epoch's
             evaluation). Run B, the same command through `python -m
             torch.distributed.run --nproc_per_node 1 ... --multihost` (one
             NCCL rank, DDP; a subprocess beside run C's first process, as in
             phase RL): per-epoch loss and pair mean bit-identical to
             run A's (the relative-position bias gather sums its gradient in a
             fixed order, and the trainer selects cuDNN's deterministic
             algorithms). Run D, through torchrun on two gloo ranks sharing the
             card (`--model_parallel 2 --dist_backend gloo --device cuda:0`:
             the head's 64 classes 32 a rank; started with run B, beside it,
             run C and C's resume), 2 epochs: one log file, each
             metrics.jsonl record once, the same pair means printed by both
             ranks, finite losses, the checkpoint's head whole (128 x 64);
             then `--resume` in this process with hyp.epochs 3 trains epoch 3
             from it with exactly the launches of a one-process epoch. Run C, a subprocess
             SIGKILLed in epoch 1 once epoch 0's checkpoint is complete, then
             `--resume` here: bit-identical to run A from the epoch it
             resumed. `validate --ema` on run A's best: the
             best epoch's {mean, std} exactly. Then cbir_synth.yaml with the
             same cuts, one run with the same counts, and `validate --ema` and
             `python -m visiondk_tpu_torch.cbir_eval --ema` on its best: the
             best epoch's metrics exactly; cbir_eval's evaluation split into
             embed forwards and product + top-k (host clock, synchronised);
             `cbir_eval --quant int8` (its metrics beside bf16's) and
             `visualize` over 4 query ids against the whole gallery (one
             retrieval grid a query). Phase EX on it: `export --ema --embed
             --batch -1`, loaded back, held to make_embed_step as above with
             per-row cosine >= 0.99999 and exactly 24 K2 a forward; and
             `cbir_eval --ema --recall_target 0.95`, whose 192-row gallery is
             one bin each (M = G): the exact run's metrics exactly.
DP. distributed — two ranks of `chip_smoke.py --dp-rank` (gloo, both on
             cuda:0, TF32 off): rank 0 first takes three world-1 steps at
             global bs 8 before the group exists, then both join it, try
             all_reduce (sum, max), all_gather, broadcast and barrier on CUDA
             tensors (each result checked, which ones gloo took printed), and
             run the same steps as world 2 (4 rows a rank): face.yaml's model
             (Swin-B, stochastic depth off so the ranks' masks do not differ,
             ArcFace over 58,671 classes x 128 class-sharded over
             --model_parallel 2) in f32; multilabel_csv's resnet50 with SyncBN
             in float64 (phase CN's reason); pet_synth's ViT-B/16 with SAM's
             per-rank ε in f32, against a world-1 step that takes each half's
             ε by hand and averages the second gradients. Bars: the loss
             within 1e-5 relative, every gradient (the head's gathered whole),
             update and BN statistic within 1e-3 of its tensor's largest entry
             (floored at 1e-3 of its kind's largest entry in f32: a zero
             gradient's rounding noise). Then face.yaml at full width in bf16
             (stochastic depth as written, bs 160 = 80 a rank): ms a step
             (host clock, 3 after 1 warm-up) and peak memory of each rank,
             finite losses. Last, in this process as one NCCL rank: ViT-B/16
             bs 128 bf16 train images/s of the DDP step beside the plain step
             (order plain, DDP, DDP, plain). The ranks' launches count in the
             `[launches] dp` line. Phase SG, on the two gloo ranks: search()
             with the gallery sharded over them (mesh=build_mesh()) on 1,024
             queries x 65,537 x 128 (one pad row; every similarity negative,
             so a zero-scored pad would outrank them), k 100: the exact
             indices equal the one-process search's, scores within 1e-5; at
             recall_target 0.95 both ranks hold the same answers and the mean
             recall against exact search is printed.
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

With --swin-train-trials it runs only the Swin-B bf16 train step's timed
trials, device-time split and bf16 one-step comparison (swin_train_trials);
with --determinism-probe, phase DT's subprocess; with --tiled-variants, the
variants of the tiled window kernels that were tried and dropped
(TILED_VARIANTS) against the committed ones at SwinV2-L stage 0. Every phase prints its
seconds ([time] lines) and the run its total.

The line before the last is a JSON summary of the ten kernels, with each
kernel's launches counted on the main paths (the bf16 serving runs and the
bf16 train runs of ViT-B/16, Swin-B and SwinV2-B, the run loop's in-process
runs (A, C's resume, validate, validate --quant int8, visualize --cam; run B
runs through torchrun in a subprocess), the int8 serving and CAM runs of
phases 4q and 4c,
the distillation phase's (teacher runs A, B; distill runs A, B), the SwinV2
run's (A, B, validate), the embedding runs' (face A, C's resume, D's resume,
validate; CBIR, validate, cbir_eval, its int8 run, visualize), SwinV2-L's serving, training and run
(A, B, validate), So400m's serving, training and run (A, B, validate), the
strategy runs' (A, B, C's resume, validate), the vision path and phase DP
(the world-2 steps, each gloo rank's counts read by that rank; the one-rank
DDP trials), counts set to 0 before each and
read after; the window kernels' launches on ws-16 windows counted apart
in the `[launches]` lines), and times at the ViT-B/16 bf16 shape (fused QKV
attention, vision_attention) or the Swin-B stage-0 bf16 shape (window
attention); the last line is {"ok": true, "device": {...}}. The
device-augment stage has no kernel of its own (plain PyTorch ops on the card),
so it has no entry there.
"""

from __future__ import annotations

import ast
import contextlib
import copy
import ctypes
import dataclasses
import gc
import io
import json
import math
import os
import re
import runpy
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from visiondk_tpu_torch.engine.state import create_train_state
from visiondk_tpu_torch.engine.steps import (
    StepConfig, device_preprocess, make_embed_step, make_eval_step, make_train_step,
)
from visiondk_tpu_torch.engine.trainer import build_tx
from visiondk_tpu_torch.losses import create_lossfn
from visiondk_tpu_torch.models import get_model
from visiondk_tpu_torch.models.backbones.swin import WindowAttention, window_region_ids
from visiondk_tpu_torch.models.backbones.swinv2 import WindowAttentionV2
from visiondk_tpu_torch.models.layers import Attention
from visiondk_tpu_torch.ops import _build
from visiondk_tpu_torch.ops import device_augment as da
from visiondk_tpu_torch.ops import margin_heads as mh
from visiondk_tpu_torch.ops import quant
from visiondk_tpu_torch.ops import retrieval
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
from visiondk_tpu_torch.utils.cam import CAM_METHODS, ClassActivationMaper

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
# the embedding model of configs/faceX/cbir.yaml: Swin-B backbone, 128-d neck (serving
# embeds: no margin head)
CBIR_EMBED_MODEL = {"task": "cbir", "backbone": {
    "swin_base_patch4_window7_224": {"pretrained": False, "image_size": 224, "feat_dim": 128}}}

BATCH = 128
IMG = PET_SYNTH_MODEL["image_size"]
F32_TRAIN_BATCH = 32
DEPTH = 12  # ViT-B/16 blocks, one attention forward and backward each
N_BATCHES = 3
TRAIN_STEPS = 5
NO_PCACHE_STEPS = 2
# train images/s: each interleaved trial times this many steps after this many warm-up
# few, for the script's time limit: host-clock rates over 4 synchronised steps of 60-180 ms
TRAIN_RATE_STEPS = 4
TRAIN_RATE_WARMUP = 1
TOL = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}
P_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-8}
DBIAS_TOL = 1e-4  # max |kernel − plain| over dbias, relative to max(1, its largest |plain| entry)
MIN_COSINE = 0.999
MIN_ARGMAX_AGREEMENT = 0.99
F32_LOSS_RTOL = 1e-5
# kernel-path train images/s of phases 5 and 7 by train tag (the synthetic-batch rate)
TRAIN_RATES: dict = {}
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
    img: int = IMG           # the `model:` section's image_size


VIT = Recipe("slice", "train", PET_SYNTH_MODEL, EMBED_MODEL, PET_SYNTH_HYP, BATCH, F32_TRAIN_BATCH,
             TRAIN_STEPS, DEPTH, K1_KERNELS, ("attn.qkv.weight",))
SWIN = Recipe("swin serving", "swin train", PET_MODEL, CBIR_EMBED_MODEL, PET_HYP, 80, 16, 3, 24,
              wattn.KERNELS, ("attn.qkv.weight", "attn.relative_position_bias_table"))
# SwinV2-B at its registered 256², pet.yaml's model section and hyp otherwise: every window is
# 8×8, K2 runs at scale 1.0 with the logit scale folded into q, and K2b's dbias feeds the CPB MLP
SWINV2_NAME = "swinv2_base_window8_256"
SWINV2 = Recipe("swinv2 serving", "swinv2 train", {**PET_MODEL, "name": SWINV2_NAME, "image_size": 256},
                {"task": "cbir", "backbone": {SWINV2_NAME: {"pretrained": False, "image_size": 256, "feat_dim": 128}}},
                PET_HYP, 64, 16, 3, 24, wattn.KERNELS,
                ("attn.qkv.weight", "attn.logit_scale", "attn.cpb_mlp.0.weight"), img=256)

Q8_RECIPES = (VIT, SWIN)  # the slices that also run int8 serving (phase Q8) and CAM

# (name, B, N, heads, head_dim, n_valid): the ViT-B/16 main-path shape (timed),
# the JAX kernel test's unaligned N with a key mask, ViT-B/8's 785 tokens,
# ViT-H/14's head_dim 80, and an N that is a multiple of 8 (the bf16 kernels
# then move the P stash in 16-byte pieces; every other N here is odd); then
# SigLIP So400m's shape (256 tokens, 16 heads of head dim 72, which the bf16
# kernels run in their 80-wide bucket with columns 72-79 staged as zeros): a
# small batch, its train batch of 64 (the stash forward and the backward from
# P timed) and its serving batch of 128 (the forward timed)
QKV_CASES = [
    ("vit_b16", BATCH, 197, 12, 64, None),
    ("unaligned", 8, 37, 4, 32, 29),
    ("vit_b8", 4, 785, 12, 64, None),
    ("hd80", 4, 257, 16, 80, 250),
    ("n_mult8", 8, 200, 6, 64, 196),
    ("so400m", 4, 256, 16, 72, None),
    ("so400m_train", 64, 256, 16, 72, None),
    ("so400m_serve", 128, 256, 16, 72, None),
]
# the So400m rows of the bound lines: case → the kernels timed there
SO_TIMED = {"so400m_train": (fused_qkv_attention_fwd_stash, fused_qkv_attention_bwd_from_p),
            "so400m_serve": (fused_qkv_attention_fwd,)}
# kernel → (case tag, its row) at So400m's shapes, for report()
SO_ROWS: dict = {}

# The tiled bodies (8 < ws <= 16), same fields: SwinV2-L (swinv2_large_window12to16_192to256
# at 256², scale 1.0) at bs 32, stage 0 shifted (timed), stage 1 shifted and
# stage 2 (one window, unshifted); ws 12 (N = 144, no multiple of the 32-key
# tiles); ws 16 at head dim 64; ws 9 (N = 81: the stash's rows are not
# 16-byte aligned); head dim 12 at ws 16 (element-by-element loads and stores)
WINDOW16_CASES = [
    ("swinv2_l_stage0_shifted", 32, 64, 6, 192, 16, 8, 1.0, True),
    ("swinv2_l_stage1_shifted", 32, 32, 12, 384, 16, 8, 1.0, False),
    ("swinv2_l_stage2", 32, 16, 24, 768, 16, 0, 1.0, False),
    ("ws12_shifted", 4, 24, 4, 128, 12, 6, None, False),
    ("ws16_hd64", 4, 32, 2, 128, 16, 8, 1.0, False),
    ("ws9_unaligned_p", 2, 18, 2, 64, 9, 4, None, False),
    ("ws16_hd12_unaligned", 2, 32, 2, 24, 16, 8, None, False),
]

# (name, B, H=W, heads, C, ws, shift, scale, timed): Swin-B at bs 80, stage by
# stage (18 of its 24 blocks run at stage 2), the JAX kernel test's shape,
# SwinV2's window 8 with scale 1.0 at head dim 64, and head dim 12 (rows not
# 16-byte aligned: the bf16 backward loads and stores them element by element)
WINDOW_CASES = [
    ("swin_b_stage0", 80, 56, 4, 128, 7, 0, None, True),
    ("swin_b_stage0_shifted", 80, 56, 4, 128, 7, 3, None, False),
    ("swin_b_stage2_shifted", 80, 14, 16, 512, 7, 3, None, True),
    ("swin_b_stage3", 80, 7, 32, 1024, 7, 0, None, False),
    ("jax_test", 4, 8, 2, 32, 4, 2, None, False),
    ("ws8_scale1", 4, 16, 2, 128, 8, 4, 1.0, False),
    ("hd12_unaligned", 2, 14, 2, 24, 7, 3, None, False),
    *WINDOW16_CASES,
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
    for k in wattn.KERNELS:
        k.large_launches = k.shifted_launches = 0
    da.make_device_augment.calls = 0


def read_counts() -> dict:
    torch.cuda.synchronize()
    return {k: k.launches for k in KERNELS}


def read_large_counts() -> dict:
    """The window kernels' launches on windows of N > 64 (ws 16 here), which
    read_counts also counts."""
    return {k: k.large_launches for k in wattn.KERNELS}


def only(launches: dict) -> dict:
    """Expected counts: ``launches`` for the kernels named, 0 for every other."""
    return {k: launches.get(k, 0) for k in KERNELS}


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_device() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this run needs a GPU")
    smi = card()
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
                                          "attention_bwd_dq_kernel", "attention_bwd_dkv_kernel"),
              "fused_window_attention": ("window_attention_fwd_tc_kernel", "window_attention_fwd_kernel",
                                         "window_attention_fwd_large_tc_kernel", "window_attention_fwd_large_kernel"),
              "fused_window_attention_bwd": ("window_attention_bwd_tc_kernel", "window_attention_bwd_kernel",
                                             "window_attention_dq_tc_kernel", "window_attention_dkv_tc_kernel",
                                             "window_attention_dq_kernel", "window_attention_dkv_kernel")}
# bf16 instantiations of each tensor-core kernel, per library: head-dim buckets
# 32, 64, 80, 128 x two variants (fused QKV); 32, 64 x shift regions or none x
# stash or none (window forward, ws <= 8 and the tiled 8 < ws <= 16); 32, 64 x
# shifted windows or not x from P or recomputing (window backward, and the
# tiled dq and dkv kernels)
TC_INSTANTIATIONS = {"fused_qkv_attention": 8, "fused_qkv_attention_bwd": 8, "fused_window_attention": 8,
                     "fused_window_attention_bwd": 8}


def check_sass(built) -> None:
    for b in built:
        name = b.path.name.split("-")[0][len("lib"):]
        if name not in TC_KERNELS:
            continue
        counts = sass_mma_counts(b.path)
        for kernel in TC_KERNELS[name]:
            found = {f: c for f, c in counts.items() if re.search(rf"\d{kernel}I", f)}
            if kernel.endswith("_tc_kernel"):
                check(len(found) == TC_INSTANTIATIONS[name],
                      f"{kernel}: {len(found)} instantiations in {b.path.name}, want {TC_INSTANTIATIONS[name]}")
                bad = [f for f, c in found.items() if c == 0]
                check(not bad, f"bf16 kernels without tensor-core instructions: {bad}")
                print(f"[build] sass: {kernel} (bf16): HMMA/HGMMA per instantiation (head-dim bucket/variant) "
                      + ", ".join(f"{'/'.join(re.findall(r'L[ib](\d+)E', f))}: {c}" for f, c in found.items()))
            else:
                bf16 = [f for f in found if "bfloat16" in f]
                check(not bf16, f"a bf16 instantiation of the CUDA-core kernel {kernel}: {bf16}")
                print(f"[build] sass: {kernel} (float32, CUDA cores): {len(found)} instantiations, "
                      f"HMMA/HGMMA {sum(found.values())}")


def resource_usage(lib_path) -> dict:
    """Registers, stack, static shared and local memory per kernel of a built
    library, read with the toolkit's cuobjdump --dump-resource-usage."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "--dump-resource-usage", str(lib_path)], check=True, capture_output=True,
                          text=True, timeout=300).stdout
    usage, function = {}, None
    for line in text.splitlines():
        found = re.search(r"Function (\S+):", line)
        if found:
            function = found.group(1)
        elif function is not None and "REG:" in line:
            usage[function] = {k: int(v) for k, v in re.findall(r"\b(REG|STACK|SHARED|LOCAL):(\d+)", line)}
            function = None
    return usage


def spill_bytes(ptxas_log: str) -> dict:
    """(spill stores, spill loads) in bytes per kernel, from ptxas' -v report."""
    spills, function = {}, ""
    for line in ptxas_log.splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            function = found.group(1)
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if found and function:
            spills[function] = (int(found.group(1)), int(found.group(2)))
    return spills


# the tiled bf16 kernels (8 < ws <= 16): (library, kernel, its name in ops.window_attention.tiled_smem_bytes);
# their template arguments are the head-dim bucket, shift regions or none, stash (or recompute) or none
TILED_KERNELS = (("fused_window_attention", "window_attention_fwd_large_tc_kernel", "fwd"),
                 ("fused_window_attention_bwd", "window_attention_dq_tc_kernel", "dq"),
                 ("fused_window_attention_bwd", "window_attention_dkv_tc_kernel", "dkv"))


def tiled_occupancy(lib, kind: str, dp: int, masked: bool, variant: bool) -> tuple:
    """(threads, dynamic shared bytes, blocks an SM) of a tiled bf16 kernel at
    N = 256, from the library's own occupancy entry."""
    out = [ctypes.c_int() for _ in range(3)]
    refs = [ctypes.byref(x) for x in out]
    if kind == "fwd":
        fn = lib.vdk_fused_window_attention_fwd_tiled_occupancy
        err = fn(dp, int(masked), int(variant), 256, *refs)
    else:
        fn = lib.vdk_fused_window_attention_bwd_tiled_occupancy
        err = fn(0 if kind == "dq" else 1, dp, int(masked), int(variant), 256, *refs)
    check(err == 0, f"tiled {kind} occupancy query failed with CUDA error {err}")
    return tuple(x.value for x in out)


def report_tiled_resources(built) -> None:
    """Each instantiation of the tiled bf16 kernels: registers, spills, stack,
    static and dynamic shared memory, threads and blocks an SM."""
    libs = {b.path.name.split("-")[0][len("lib"):]: b for b in built}
    for name, kernel, kind in TILED_KERNELS:
        b = libs[name]
        usage, spills = resource_usage(b.path), spill_bytes(b.ptxas_log)
        for function, res in sorted(usage.items()):
            found = re.search(rf"\d{kernel}ILi(\d+)ELb(\d)ELb(\d)", function)
            if not found:
                continue
            dp, masked, variant = int(found.group(1)), found.group(2) == "1", found.group(3) == "1"
            threads, dyn, blocks = tiled_occupancy(b.lib, kind, dp, masked, variant)
            planned = wattn.tiled_smem_bytes(kind, dp, masked, variant)
            check(dyn == planned, f"{kernel}<{dp},{masked},{variant}>: {dyn} bytes of shared memory, the wrapper "
                                  f"plans for {planned}")
            check(blocks >= wattn.tiled_blocks_per_sm(kind, dp, masked, variant),
                  f"{kernel}<{dp},{masked},{variant}>: {blocks} blocks an SM, below the wrapper's plan")
            store, load = spills.get(function, (0, 0))
            print(f"[build] tiled {kernel}<DP {dp}, {'shifted' if masked else 'unshifted'}, "
                  f"{('stash' if variant else 'no stash') if kind == 'fwd' else ('recompute' if variant else 'from P')}>: "
                  f"{res['REG']} registers, spills {store} B stored / {load} B loaded, stack {res['STACK']} B, "
                  f"shared {res['SHARED']} B static + {dyn} B dynamic, {threads} threads, {blocks} blocks an SM")


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
    report_tiled_resources(built)


def max_err(out: torch.Tensor, ref: torch.Tensor, scaled: bool = False) -> float:
    diff = (out.float() - ref.float()).abs()
    if scaled:
        diff = diff / ref.float().abs().clamp_min(1.0)
    return diff.max().item()


def o_bar_ratio(out: torch.Tensor, ref: torch.Tensor, dtype: torch.dtype) -> float:
    """The largest |kernel − plain| over O as a share of its bar: TOL[dtype]
    in f32; in bf16, element by element, max(TOL, one bf16 ulp of |plain|)
    (2⁻⁷ of the power of two at or below |plain|)."""
    ref = ref.float()
    bar = torch.full_like(ref, TOL[dtype])
    if dtype == torch.bfloat16:
        ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0**-126))) - 7)
        bar = torch.maximum(bar, ulp)
    return ((out.float() - ref).abs() / bar).max().item()


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

            if name != "vit_b16" and name not in SO_TIMED:
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
            if name in SO_TIMED:
                timed = {k: v for k, v in timed.items() if k in SO_TIMED[name] and dtype == torch.bfloat16}
            elif dtype == torch.float32:
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
                    row = {"max_abs_err": errs[k], **times, **bound(*work[k], dtype)}
                    if name in SO_TIMED:
                        SO_ROWS[k] = (tag, row)
                    else:
                        summary[k] = row
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


# the window kernels' rows at SwinV2-L stage 0 (the timed ws-16 case): (tag, bound row), for report()
WS16_ROWS: dict = {}
# the first tiled bodies' times at that shape, bf16 ms, before their redesign (PERF.md §6: NVIDIA H100
# 80GB HBM3, 700 W)
WS16_FIRST_MS = {wattn.fused_window_attention_fwd: 1.1214, wattn.fused_window_attention_fwd_stash: 1.3357,
                wattn.fused_window_attention_bwd_from_p: 1.6965, wattn.fused_window_attention_bwd_recompute: 4.1546}


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

            out = kf(qkv, bias, ids, h, scale, shift)
            ref = wattn.fused_window_attention_plain(qkv, bias, ids, h, scale, shift)
            o_s, p_s = ks(qkv, bias, ids, h, scale, shift)
            o_r, p_r = wattn.fused_window_attention_fwd_stash_plain(qkv, bias, ids, h, scale, shift)
            g_p, db_p = kb(qkv, p_s, dout, h, scale, shift)
            g_p_ref, db_p_ref = wattn.fused_window_attention_bwd_from_p_plain(qkv, p_s, dout, h, scale, shift)
            g_r, db_r = kr(qkv, bias, ids, dout, h, scale, shift)
            g_r_ref, db_r_ref = wattn.fused_window_attention_bwd_recompute_plain(qkv, bias, ids, dout, h, scale,
                                                                                 shift)
            _, db_p2 = kb(qkv, p_s, dout, h, scale, shift)
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
            o_ratio = {kf: o_bar_ratio(out, ref, dtype), ks: o_bar_ratio(o_s, o_r, dtype)}
            check(p_err <= P_TOL[dtype], f"{tag}: P max |kernel - plain| {p_err} > {P_TOL[dtype]}")
            for k, ratio in o_ratio.items():
                check(ratio <= 1.0, f"{tag}: {NAMES[k]} O error {errs[k]} is {ratio:.3f} of its bar (> 1)")
            for k in (kb, kr):
                check(errs[k] <= tol, f"{tag}: {NAMES[k]} error {errs[k]} > {tol}")
            for k, err in dbias_err.items():
                check(err <= DBIAS_TOL, f"{tag}: {NAMES[k]} dbias error {err} of max(1, |plain|) > {DBIAS_TOL}")
            print(f"[window kernel] {tag}: max|err| fwd {errs[kf]:.3e} ({o_ratio[kf]:.3f} of the O bar), stash O/P "
                  f"{max_err(o_s, o_r):.3e}/{p_err:.3e} (O bit-equal to fwd), bwd_from_p dqkv "
                  f"{errs[kb]:.3e} dbias {dbias_err[kb]:.3e} (bit-identical on repeat), bwd_recompute "
                  f"dqkv {errs[kr]:.3e} dbias {dbias_err[kr]:.3e}, max|dbias| {db_p_ref.abs().max().item():.3e} "
                  f"(O bar {tol}{' or one bf16 ulp of |plain|, the larger' if dtype == torch.bfloat16 else ''}, "
                  f"P {P_TOL[dtype]:.3e}, dbias {DBIAS_TOL} of max(1, |plain|); dqkv {tol} scaled by max(1, |plain|))")

            if timed and dtype == torch.bfloat16:
                calls = {
                    kf: (lambda: kf(qkv, bias, ids, h, scale, shift),
                         lambda: wattn.fused_window_attention_plain(qkv, bias, ids, h, scale, shift)),
                    ks: (lambda: ks(qkv, bias, ids, h, scale, shift),
                         lambda: wattn.fused_window_attention_fwd_stash_plain(qkv, bias, ids, h, scale, shift)),
                    kb: (lambda: kb(qkv, p_s, dout, h, scale, shift),
                         lambda: wattn.fused_window_attention_bwd_from_p_plain(qkv, p_s, dout, h, scale, shift)),
                    kr: (lambda: kr(qkv, bias, ids, dout, h, scale, shift),
                         lambda: wattn.fused_window_attention_bwd_recompute_plain(qkv, bias, ids, dout, h, scale,
                                                                                  shift)),
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
                    if ws > 8:
                        print(f"[window kernel] {tag} {NAMES[k]}: tiled body {times['ms']:.4f} ms against the first "
                              f"tiled body's {WS16_FIRST_MS[k]:.4f} ms ({WS16_FIRST_MS[k] / times['ms']:.2f}x; PERF.md, "
                              f"NVIDIA H100 80GB HBM3 at 700 W)")
                    row = {"max_abs_err": errs[k], **times, **bound(*work[k], dtype)}
                    if name == "swin_b_stage0":
                        summary[k] = row
                    elif ws > 8:
                        WS16_ROWS[k] = (tag, row)
                del calls, library
            del qkv, dout, out, ref, o_s, p_s, o_r, p_r, g_p, g_p_ref, g_r, g_r_ref
            torch.cuda.empty_cache()
    return summary


def set_fused(model: torch.nn.Module, on: bool) -> None:
    for m in model.modules():
        if isinstance(m, (Attention, WindowAttention, WindowAttentionV2)):
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
    img = recipe.img
    batches = [
        {"image": torch.randint(0, 256, (BATCH, img, img, 3), generator=gen, device=dev, dtype=torch.uint8)}
        for _ in range(N_BATCHES)
    ]
    t0 = time.perf_counter()
    cls_model, emb_model = build_models(recipe, torch.bfloat16, dev)
    torch.cuda.synchronize()
    print(f"[{recipe.tag}] built {recipe.model['name']} ({recipe.model['num_classes']} classes, {img}²) and the "
          f"128-d embedding model, bf16, seeded weights, in {time.perf_counter() - t0:.1f} s")

    # the main path, counted: bf16 serving
    counts = compare_paths(recipe, cls_model, emb_model, batches, torch.bfloat16)
    # int8 serving (phase Q8) on the same models and batch; its launches count with the slice's
    q8 = timed(f"q8 {recipe.model['name']}", q8_serving, recipe, cls_model, emb_model, batches[0]) \
        if recipe in Q8_RECIPES else None

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
    cls32, emb32 = build_models(recipe, torch.float32, dev)
    compare_paths(recipe, cls32, emb32, batches, torch.float32)
    if q8 is not None:
        counts = add_counts(counts, q8_against_f32(recipe, q8, cls32, emb32, batches[0]))
        counts = add_counts(counts, timed(f"cam {recipe.model['name']}", phase_cam, recipe, cls32, batches[0]))
    del cls32, emb32
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------- int8 serving (Q8) and CAM

Q8_MIN_EMBED_COSINE = 0.99  # int8 embeddings against bf16 and f32, per row (tests/test_quant.py's bar)
Q8_MIN_LOGIT_COSINE = 0.995  # int8 ViT-B/16 logits against f32, per row (tests/test_quant.py's bar)
Q8_TOP1_POINTS = 0.02  # validate --quant int8's top1 against the bf16 validate's
INT8_PEAK_OPS_PER_S = 1979e12  # H100 SXM, dense int8
# (M, K, N) of the int8 GEMM held to the float64 product of its codes: ViT-B/16's fc1 at bs 128, its
# 37-class head on one image (M 1, N 37: padded), SwinV2's cpb_fc1 at ws 8 (K 2: padded), a
# 1000-class head at bs 128, and a small odd one
Q8_GEMM_SHAPES = ((BATCH * 197, 768, 3072), (1, 768, 37), (225, 2, 512), (BATCH, 768, 1000), (5, 24, 4))
CAM_CLASS = 3  # the class index every CAM is taken for
CAM_TOL = 1e-3  # max |kernel path − plain path| over the heat map, relative to its largest value
CAM_PERTURB_TOL = 1e-2  # the same for ablationcam, scorecam and fullgrad
CAM_PERTURB = ("ablationcam", "scorecam", "fullgrad")
# GradCAM++'s weights g²/(2g² + Σ A·g³) cancel in the denominator: its map moves by a few percent
# when its gradient moves by 1e-6 (on ViT-B/16), so the kernel is held through that gradient
CAM_ILL_CONDITIONED = ("gradcampp",)
CAM_GRAD_TOL = 1e-5  # the injected map's gradient, kernel path vs plain, relative to its largest entry
CAM_SWIN_METHODS = ("gradcam", "fullgrad")
# the methods whose CAM takes one injected backward: one stash forward and one backward from P a call
CAM_GRAD_METHODS = ("gradcam", "gradcampp", "xgradcam", "layercam", "hirescam", "eigengradcam")


def add_counts(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in KERNELS}


def q8_gemm(dev: torch.device) -> None:
    """The int8 GEMM (``torch._int_mm`` through ``ops/quant.py``'s padding)
    against the float64 product of the same codes, bit for bit, at
    Q8_GEMM_SHAPES; a shape ``_int_mm`` refuses raises; then one int8 dense
    at fc1's shape split into its passes beside ``F.linear`` in bf16."""
    gen = torch.Generator(device=dev).manual_seed(8)
    for m, k, n in Q8_GEMM_SHAPES:
        xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        w = quant.quantize_weight(torch.randn(n, k, generator=gen, device=dev))
        acc = quant.int8_matmul(xq, w)
        # |sum| <= K·127² < 2**53: float64 is exact
        exact = acc.dtype == torch.int32 and torch.equal(acc.double(), xq.double() @ w.q.double().T)
        print(f"[q8] int8 GEMM M {m} K {k} N {n} (padded to {quant.int_mm_shape(m, k, n)}): equal to the "
              f"float64 product of its codes: {exact} (required)")
        check(exact, f"int8 GEMM at {(m, k, n)} differs from the float64 product of its codes")
    saved = quant.INT_MM_MIN_ROWS
    quant.INT_MM_MIN_ROWS = 1  # an unpadded single row: _int_mm refuses it, and nothing falls back
    try:
        quant.int8_matmul(xq[:1], w)
        raised = False
    except RuntimeError as e:
        raised = True
        print(f"[q8] an unpadded 1-row int8 GEMM raises: {str(e).splitlines()[0][:120]}")
    finally:
        quant.INT_MM_MIN_ROWS = saved
    check(raised, "torch._int_mm took a 1-row product: the padding rules are out of date")

    m, k, n = Q8_GEMM_SHAPES[0]
    x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    w32 = 0.02 * torch.randn(n, k, generator=gen, device=dev)
    bias = 0.02 * torch.randn(n, generator=gen, device=dev)
    w = quant.quantize_weight(w32)
    xq, sx = quant.quantize_tensor(x)
    acc = quant.int8_matmul(xq, w)
    wb, bb = w32.to(torch.bfloat16), bias.to(torch.bfloat16)
    ms = {
        "quantize x": cuda_ms(lambda: quant.quantize_tensor(x), 20),
        "_int_mm": cuda_ms(lambda: quant.int8_matmul(xq, w), 20),
        "dequant": cuda_ms(lambda: (acc.float() * (sx * w.scale) + bias).to(torch.bfloat16), 20),
        "int8 dense": cuda_ms(lambda: quant.int8_dense_prequant(x, w, bias, torch.bfloat16), 20),
        "bf16 F.linear": cuda_ms(lambda: F.linear(x, wb, bb), 20),
    }
    ref = F.linear(x.float(), w32, bias)
    err = ((quant.int8_dense_prequant(x, w, bias, torch.bfloat16).float() - ref).norm() / ref.norm()).item()
    ops = 2.0 * m * k * n
    dense_bytes = m * k * 2 + k * n + 2 * n * 4 + m * n * 2  # x bf16, codes, scale and bias f32, y bf16
    mm_bytes = m * k + k * n + m * n * 4  # the int8 operands and the int32 result
    b_dense = max(dense_bytes / HBM_BYTES_PER_S, ops / INT8_PEAK_OPS_PER_S) * 1e3
    b_mm = max(mm_bytes / HBM_BYTES_PER_S, ops / INT8_PEAK_OPS_PER_S) * 1e3
    b_bf16 = max((m * k * 2 + k * n * 2 + n * 2 + m * n * 2) / HBM_BYTES_PER_S, ops / 989e12) * 1e3
    print(f"[q8] one int8 dense at ViT-B/16 fc1 (M {m}, K {k}, N {n}; bf16 in and out; CUDA events, 20 calls): "
          + ", ".join(f"{k_} {v:.4f} ms" for k_, v in ms.items())
          + f"; int8 bound {b_dense:.4f} ms (bytes {dense_bytes / 1e6:.1f} MB at 3.35 TB/s vs {ops / 1e9:.1f} GOP "
            f"at 1,979 TOP/s), _int_mm alone {b_mm:.4f} ms ({mm_bytes / 1e6:.1f} MB with its int32 result), bf16 "
            f"bound {b_bf16:.4f} ms; int8 dense vs the f32 product: {err:.3e} relative (Frobenius)")


def q8_serving(recipe: Recipe, cls_model, emb_model, batch: dict) -> dict:
    """int8 serving on the slice's bf16 models: the eval and embed steps with
    ``quant="int8"`` and the weight cache (launches counted), their outputs
    beside the bf16 ones, and embed images/s in the order bf16, int8, int8,
    bf16. On ViT-B/16 also the GEMM checks (``q8_gemm``) and the cache's codes
    and scales on the card against the CPU's, bit for bit."""
    fwd = recipe.kernels[0]
    name = recipe.model["name"]
    if recipe is VIT:
        q8_gemm(batch["image"].device)
    caches = {"cls": quant.build_weight_cache(cls_model), "emb": quant.build_weight_cache(emb_model)}
    if recipe is VIT:
        on_cpu = {p: quant.quantize_weight(m.weight.detach().cpu()) for p, m in quant.dense_layers(cls_model)}
        same = all(torch.equal(caches["cls"][p].q.cpu(), c.q) and torch.equal(caches["cls"][p].scale.cpu(), c.scale)
                   for p, c in on_cpu.items())
        print(f"[q8] {name}: int8 weight cache of {len(caches['cls'])} dense layers, codes and scales on the card "
              f"equal to the CPU's: {same} (required)")
        check(same, "the int8 weight cache on the card differs from the CPU's")
    steps = {
        "bf16 logits": make_eval_step(cls_model, StepConfig()),
        "int8 logits": make_eval_step(cls_model, StepConfig(), quant="int8", quant_cache=caches["cls"]),
        "bf16 embed": make_embed_step(emb_model, StepConfig()),
        "int8 embed": make_embed_step(emb_model, StepConfig(), quant="int8", quant_cache=caches["emb"]),
    }
    reset_counts()
    out = {"int8 logits": steps["int8 logits"](batch), "int8 embed": steps["int8 embed"](batch)}
    counts = read_counts()
    check(counts == only({fwd: 2 * recipe.depth}),
          f"int8 serving launches {[(NAMES[k], v) for k, v in counts.items()]}, want {2 * recipe.depth} {NAMES[fwd]}")
    out.update({k: steps[k](batch) for k in ("bf16 logits", "bf16 embed")})
    for k, v in out.items():
        check(bool(torch.isfinite(v).all()), f"{name} {k}: non-finite values")
    rates = {"bf16": [], "int8": []}
    for kind in ("bf16", "int8", "int8", "bf16"):
        rates[kind].append(images_per_s(steps[f"{kind} embed"], batch))
    print(f"[q8] {name} 128-d embedding bs {BATCH} images/s (CUDA events, 10 calls after 2): bf16 "
          f"{rates['bf16'][0]:.1f}, {rates['bf16'][1]:.1f} | int8 {rates['int8'][0]:.1f}, {rates['int8'][1]:.1f} "
          f"(order bf16, int8, int8, bf16); {NAMES[fwd]} launched {counts[fwd]} by the two int8 forwards")
    return {"out": out, "counts": counts}


def q8_against_f32(recipe: Recipe, q8: dict, cls32, emb32, batch: dict) -> dict:
    """Phase Q8's bars, once the slice's f32 models (the same seeded weights)
    are built: int8 embeddings against bf16 and f32, int8 logits against f32
    (held on ViT-B/16, printed on Swin-B). Returns the int8 forwards' launches."""
    out = q8["out"]
    out["f32 logits"] = make_eval_step(cls32, StepConfig())(batch)
    out["f32 embed"] = make_embed_step(emb32, StepConfig())(batch)
    cos = {(a, b): row_cosine(out[a], out[b]).min().item() for a, b in (
        ("int8 embed", "bf16 embed"), ("int8 embed", "f32 embed"), ("int8 logits", "f32 logits"),
        ("bf16 logits", "f32 logits"))}
    norms = torch.linalg.vector_norm(out["int8 embed"], dim=1)
    print(f"[q8] {recipe.model['name']} bs {BATCH}: min row cosine " + ", ".join(
        f"{a} vs {b} {v:.6f}" for (a, b), v in cos.items())
        + f" (want >= {Q8_MIN_EMBED_COSINE} for the embeddings"
        + (f", >= {Q8_MIN_LOGIT_COSINE} for int8 logits vs f32)" if recipe is VIT else "; logits printed)")
        + f"; int8 embedding norms within {(norms - 1).abs().max().item():.2e} of 1")
    check(cos["int8 embed", "bf16 embed"] >= Q8_MIN_EMBED_COSINE and cos["int8 embed", "f32 embed"]
          >= Q8_MIN_EMBED_COSINE, "int8 embeddings below the cosine bar")
    check(bool(((norms - 1).abs() < 1e-3).all()), "int8 embeddings are not unit-norm")
    if recipe is VIT:
        check(cos["int8 logits", "f32 logits"] >= Q8_MIN_LOGIT_COSINE, "int8 ViT-B/16 logits below the cosine bar")
    return q8["counts"]


def phase_cam(recipe: Recipe, model32, batch: dict) -> dict:
    """CAM on the slice's f32 classification model, one image, class
    CAM_CLASS: every method of ``utils/cam.py`` on ViT-B/16 (gradcam and
    fullgrad on Swin-B), the kernel path (the stash forward and the backward
    from P after the target layer, counted) against the plain attention path;
    the heat maps before the overlay within CAM_TOL of their largest value
    (CAM_PERTURB_TOL for the perturbation methods and fullgrad). Returns the
    kernel path's launches."""
    fwd, stash, bwd_p, _ = recipe.kernels
    name = recipe.model["name"]
    img = recipe.img
    methods = CAM_METHODS if recipe is VIT else CAM_SWIN_METHODS
    x = device_preprocess(batch["image"][:1], StepConfig().mean, StepConfig().std).cpu().numpy()
    heat, secs, grads = {}, {}, {}
    reset_counts()
    for path in ("kernel", "plain"):
        set_fused(model32, path == "kernel")
        for method in methods:
            t = time.perf_counter()
            maper = ClassActivationMaper(model32, method, x, backbone_name=name)
            heat[path, method] = maper.heatmap((img, img), x, class_idx=CAM_CLASS)
            secs[path, method] = time.perf_counter() - t
        if path == "kernel":
            counts = read_counts()
        # the gradient every gradient method reads: d(class score)/d(the target's map)
        maper = ClassActivationMaper(model32, "gradcam", x, backbone_name=name)
        xt = torch.from_numpy(x).to(batch["image"].device)
        grads[path] = maper._grad(maper._capture(xt), xt, CAM_CLASS)
    set_fused(model32, True)
    check(read_counts() == add_counts(counts, only({fwd: 3 * recipe.depth - 1, stash: 1, bwd_p: 1})),
          "the plain CAM path launched a kernel")
    g_err = ((grads["kernel"] - grads["plain"]).abs().max() / grads["plain"].abs().max()).item()
    print(f"[cam] {name}: d(score)/d(target map), kernel vs plain path: max |diff| / max |plain| {g_err:.3e} "
          f"(want <= {CAM_GRAD_TOL})")
    # the target is the last block's norm1, one attention after it; fullgrad differentiates every block
    want = sum(m in CAM_GRAD_METHODS for m in methods) + recipe.depth * ("fullgrad" in methods)
    print(f"[cam] {name} f32, one {img}² image, class {CAM_CLASS}: kernel path launches "
          + ", ".join(f"{NAMES[k]} {counts[k]}" for k in (fwd, stash, bwd_p))
          + f" (want {want} {NAMES[stash]} and {NAMES[bwd_p]}: one a gradient method, {recipe.depth} for fullgrad)")
    check(counts[stash] == want and counts[bwd_p] == want and all(
        v == 0 for k, v in counts.items() if k not in (fwd, stash, bwd_p)),
        f"CAM launches {[(NAMES[k], v) for k, v in counts.items()]}")
    worst = {}
    for method in methods:
        k, p = heat["kernel", method], heat["plain", method]
        tol = CAM_PERTURB_TOL if method in CAM_PERTURB else CAM_TOL
        worst[method] = float(np.abs(k - p).max() / max(np.abs(p).max(), 1e-12))
        bar = "printed: held through its gradient" if method in CAM_ILL_CONDITIONED else f"want <= {tol}"
        print(f"[cam] {name} {method}: heat map kernel vs plain path, max |diff| / max |plain| "
              f"{worst[method]:.3e} ({bar}); {secs['kernel', method]:.2f} s kernel path, "
              f"{secs['plain', method]:.2f} s plain")
    check(g_err <= CAM_GRAD_TOL, f"CAM gradient on {name}: kernel path {g_err} from the plain path")
    for method in methods:
        k = heat["kernel", method]
        check(k.shape == (img, img) and np.isfinite(k).all(), f"CAM {method}: shape {k.shape} or non-finite")
        tol = CAM_PERTURB_TOL if method in CAM_PERTURB else CAM_TOL
        check(method in CAM_ILL_CONDITIONED or worst[method] <= tol,
              f"CAM {method} on {name}: kernel path {worst[method]} from the plain path")
    return counts


# ---------------------------------------------------------------- train


def build_trainer(recipe: Recipe, dtype: torch.dtype, dev: torch.device, path=KERNEL_PATH, step_cfg=None,
                  model=None, mesh=None):
    """The recipe's model (seed 0, or ``model``) on an attention path, its
    train state and step (``step_cfg``: StepConfig() unless given; ``mesh``:
    the DDP step of a process group)."""
    if model is None:
        model = get_model(recipe.model, dtype=dtype, device=dev, generator=torch.Generator().manual_seed(0))
    path[1](model)
    tx = build_tx(recipe.hyp, STEPS_PER_EPOCH, discrete_per_epoch=True, model_cfg=recipe.model)
    state = create_train_state(model, tx)
    step = make_train_step(model, tx, create_lossfn("ce", label_smooth=LABEL_SMOOTH), step_cfg or StepConfig(),
                           torch.Generator().manual_seed(1), mesh=mesh)
    return model, state, step


def snapshot(model: torch.nn.Module):
    """(parameters, gradients), cloned, by name."""
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    return params, grads


def compare_one_step(recipe: Recipe, dtype: torch.dtype, dev: torch.device, batch: dict,
                     kernel_side=None, paths=(KERNEL_PATH, PLAIN_PATH), tag=None, step_cfg=None) -> None:
    """One step from the same weights and batch on two attention paths (the
    kernel path and the plain path unless told otherwise): loss, every
    gradient, every update θ₁ − θ₀. ``kernel_side`` is the first path's
    (loss, parameters, gradients) when already taken."""
    theta0 = {n: p.detach().clone() for n, p in get_model(
        recipe.model, dtype=dtype, device=dev, generator=torch.Generator().manual_seed(0)).named_parameters()}
    sides = []
    for i, path in enumerate(paths):
        if i == 0 and kernel_side is not None:
            sides.append(kernel_side)
            continue
        model, state, step = build_trainer(recipe, dtype, dev, path, step_cfg)
        loss = step(state, batch)["loss"].item()
        sides.append((loss, *snapshot(model)))
        del model, state, step
        torch.cuda.empty_cache()
    compare_sides(f"[{tag or recipe.train_tag}] {str(dtype).replace('torch.', '')} {paths[0][0]} vs {paths[1][0]} "
                  f"path", dtype, batch, theta0, *sides)


def compare_sides(label: str, dtype: torch.dtype, batch: dict, theta0: dict, side_a: tuple, side_b: tuple) -> tuple:
    """The one-step comparison of two sides (loss, parameters, gradients)
    from the same θ₀, the second the reference; in f32 held to the bars.
    Returns (loss relative difference, {gradient, update: worst ratio})."""
    (lk, pk, gk), (lp, pp, gp) = side_a, side_b
    loss_rel = abs(lk - lp) / abs(lp)
    worst = {"grad": (0.0, ""), "update": (0.0, "")}
    min_cos = {"grad": (1.0, ""), "update": (1.0, "")}
    key_bias = {"max_abs_kernel": 0.0, "max_abs_plain": 0.0, "max_abs_diff": 0.0}
    for n in gp:
        update = (pp[n] - theta0[n].to(pp[n].device)).float()
        # θ₁ = θ₀ + Δ rounds to θ's f32 spacing, which can be near Δ's own
        # size, so the post-step parameters may differ by one spacing more
        spacing = torch.finfo(torch.float32).eps * pp[n].float().abs().max().item()
        pairs = {"grad": (gk[n].float(), gp[n].float(), gp[n].float().abs().max().item(), 0.0),
                 "update": ((pk[n] - theta0[n].to(pp[n].device)).float(), update, update.abs().max().item(), spacing)}
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
    print(f"{label}, one step, bs {batch['label'].shape[0]}: loss "
          f"{lk:.6f} vs {lp:.6f} (rel {loss_rel:.3e}); worst max|diff|/max|plain| gradient {worst['grad'][0]:.3e} "
          f"({worst['grad'][1]}), update {worst['update'][0]:.3e} ({worst['update'][1]}); min cosine "
          f"gradient {min_cos['grad'][0]:.6f} ({min_cos['grad'][1]}), update {min_cos['update'][0]:.6f} "
          f"({min_cos['update'][1]}), key-bias slices excluded from the cosines; key-bias gradient slice: "
          f"max|kernel| {key_bias['max_abs_kernel']:.3e}, max|plain| {key_bias['max_abs_plain']:.3e}, "
          f"max|diff| {key_bias['max_abs_diff']:.3e}")
    if dtype == torch.float32:
        check(loss_rel <= F32_LOSS_RTOL, f"{label}: f32 loss differs by {loss_rel} relative > {F32_LOSS_RTOL}")
        for what in ("grad", "update"):
            check(worst[what][0] <= F32_TENSOR_TOL,
                  f"{label}: f32 {what} of {worst[what][1]} differs by {worst[what][0]} of its max > {F32_TENSOR_TOL}")
    return loss_rel, {what: worst[what][0] for what in worst}


def train_rate(model, state, step, batch: dict, path, label: str):
    """One trial on an attention path: images/s over TRAIN_RATE_STEPS
    synchronised train steps after TRAIN_RATE_WARMUP (host clock), and the
    peak memory; prints the trial under ``label``."""
    path[1](model)
    for _ in range(TRAIN_RATE_WARMUP):
        step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(TRAIN_RATE_STEPS):
        step(state, batch)
    torch.cuda.synchronize()
    rate = TRAIN_RATE_STEPS * batch["label"].shape[0] / (time.perf_counter() - t0)
    mem = torch.cuda.max_memory_allocated() / 2**30
    print(f"{label}: {rate:.1f} img/s over {TRAIN_RATE_STEPS} steps after {TRAIN_RATE_WARMUP} warm-up, "
          f"max_memory_allocated {mem:.2f} GiB")
    return rate, mem


def phase_train(dev: torch.device, recipe: Recipe) -> dict:
    fwd, stash, bwd_p, bwd_r = recipe.kernels
    depth, bs, tag, img = recipe.depth, recipe.train_batch, recipe.train_tag, recipe.img
    gen = torch.Generator(device=dev).manual_seed(3)
    batch = {
        "image": torch.randint(0, 256, (bs, img, img, 3), generator=gen, device=dev, dtype=torch.uint8),
        "label": torch.randint(0, recipe.model["num_classes"], (bs,), generator=gen, device=dev),
    }
    t0 = time.perf_counter()
    model, state, step = build_trainer(recipe, torch.bfloat16, dev)
    torch.cuda.synchronize()
    print(f"[{tag}] built {recipe.model['name']} ({recipe.model['num_classes']} classes, {img}², {depth} attention "
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
    for trial, (label, path, no_pcache) in enumerate((*runs, *runs[::-1])):
        if no_pcache:
            os.environ["VDK_ATTN_NO_PCACHE"] = "1"
        rates[label].append(train_rate(model, state, step, batch, path,
                                       f"[{tag}] bf16 bs {bs} trial {trial}, {label} path"))
        os.environ.pop("VDK_ATTN_NO_PCACHE", None)
    set_fused(model, True)
    TRAIN_RATES[tag] = [r for r, _ in rates["kernel"]]
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
    ("attention kernels", ("attention", "dbias_sum")),
    ("GEMMs and the patch convolution", ("gemm", "xmma", "cutlass", "nvjet", "cublas", "conv")),
    ("copies and casts", ("copy", "cast", "memcpy", "memset", "transpose")),
    ("LayerNorm", ("layer_norm", "layernorm")),
    ("SGD + clip + EMA (foreach)", ("multi_tensor", "foreach")),
    ("softmax and reductions", ("reduce", "softmax", "norm")),
    ("other elementwise", ("",)),
)


def device_split(fn, steps: int, classes=KERNEL_CLASSES) -> tuple:
    """Per step: device ms by class of kernel (``classes``: label → name
    keys, first match wins), and by attention kernel name, from
    torch.profiler over ``steps`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    split = {label: 0.0 for label, _ in classes}
    attention = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name, ms = e.name.lower(), e.time_range.elapsed_us() / 1e3 / steps
        label = next(lb for lb, keys in classes if any(k in name for k in keys))
        split[label] += ms
        if label == "attention kernels":
            short = re.search(r"(\w*(?:attention|dbias_sum)\w*kernel)", e.name)
            key = short.group(1) if short else e.name[:60]
            attention[key] = attention.get(key, 0.0) + ms
    return split, attention


def profile_step(label: str, fn, bs: int, classes=KERNEL_CLASSES) -> float:
    """Prints where the time of ``fn`` (one step of batch ``bs``) goes: the
    unprofiled step time (host clock, synchronised, TRAIN_RATE_STEPS calls
    after TRAIN_RATE_WARMUP), device time by kernel class from
    torch.profiler over 3 calls, and the device's idle share. Returns the
    device busy ms per step."""
    for _ in range(TRAIN_RATE_WARMUP):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_RATE_STEPS):
        fn()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / TRAIN_RATE_STEPS * 1e3
    split, attention = device_split(fn, steps=3, classes=classes)
    busy = sum(split.values())
    print(f"[profile] {label} bs {bs}, kernel path: step {step_ms:.2f} ms unprofiled "
          f"({bs / step_ms * 1e3:.1f} img/s), device busy {busy:.2f} ms, idle share "
          f"{max(0.0, 1 - busy / step_ms):.1%}; device ms per step: "
          + ", ".join(f"{lb} {ms:.2f}" for lb, ms in split.items())
          + ("; attention kernels: " + ", ".join(f"{k} {ms:.2f}" for k, ms in sorted(attention.items()))
             if attention else ""))
    return busy


def phase_profile(dev: torch.device, recipe: Recipe) -> None:
    """Where the time of a recipe's bf16 train step (its train batch) and eval
    step (bs 128) goes on the kernel path with the P stash (``profile_step``)."""
    gen = torch.Generator(device=dev).manual_seed(7)
    batch = {
        "image": torch.randint(0, 256, (BATCH, recipe.img, recipe.img, 3), generator=gen, device=dev,
                               dtype=torch.uint8),
        "label": torch.randint(0, recipe.model["num_classes"], (BATCH,), generator=gen, device=dev),
    }
    train_batch = {k: v[:recipe.train_batch] for k, v in batch.items()}
    model, state, step = build_trainer(recipe, torch.bfloat16, dev)
    eval_step = make_eval_step(model, StepConfig())
    os.environ.pop("VDK_ATTN_NO_PCACHE", None)
    name = recipe.model["name"]
    profile_step(f"{name} train bf16", lambda: step(state, train_batch), recipe.train_batch)
    profile_step(f"{name} eval bf16", lambda: eval_step(batch), BATCH)
    del model, state, step, eval_step
    torch.cuda.empty_cache()


def phase_profile_embedding(dev: torch.device) -> None:
    """Phase 5p for the embedding task: face_synth's bf16 Swin-B train step
    (Swin-B, 128-d neck, ArcFace over 64 classes, bs 64, its hyp) on a
    synthetic batch (``profile_step``; 24 K2s + 24 K2b launched), then the
    margin head and its loss (ArcFace + CE, forward and backward) alone at
    the step's shapes and at face.yaml's 58,671 classes: device time by
    class over 3 calls and CUDA-event time."""
    from visiondk_tpu_torch.config import yaml_load
    from visiondk_tpu_torch.models import build_head

    cfg = yaml_load(FACE_SYNTH_YAML)
    model_cfg, bs = cfg["model"], cfg["data"]["train"]["bs"]
    (head_name, head_cfg), = model_cfg["head"].items()
    classes, feat_dim = head_cfg["num_class"], head_cfg["feat_dim"]
    model = get_model(model_cfg, dtype=torch.bfloat16, device=dev, generator=torch.Generator().manual_seed(0))
    tx = build_tx(cfg["hyp"], 20, discrete_per_epoch=False, model_cfg=model_cfg)
    state = create_train_state(model, tx)
    step = make_train_step(model, tx, create_lossfn("ce", valid_class=classes), StepConfig(task="embedding"),
                           torch.Generator().manual_seed(1))
    gen = torch.Generator(device=dev).manual_seed(8)
    batch = {"image": torch.randint(0, 256, (bs, IMG, IMG, 3), generator=gen, device=dev, dtype=torch.uint8),
             "label": torch.randint(0, classes, (bs,), generator=gen, device=dev)}
    _, stash, bwd_p, _ = wattn.KERNELS
    reset_counts()
    check(torch.isfinite(step(state, batch)["loss"]).item(), "the embedding train step's loss is not finite")
    counts = read_counts()
    check(counts == only({stash: SWIN.depth, bwd_p: SWIN.depth}),
          f"embedding train step launches {[(NAMES[k], v) for k, v in counts.items()]}")
    busy = profile_step(f"face_synth embedding train ({next(iter(model_cfg['backbone']))} + {feat_dim}-d neck + "
                        f"{head_name} over {classes} classes) bf16", lambda: step(state, batch), bs)
    del model, state, step
    torch.cuda.empty_cache()
    for n_class in (classes, 58671):
        head = build_head({head_name: {**head_cfg, "num_class": n_class}})
        head.init_weights(torch.Generator().manual_seed(0))
        head.to(dev)
        lossfn = create_lossfn("ce", valid_class=n_class)
        feats = torch.randn(bs, feat_dim, generator=gen, device=dev).requires_grad_()
        labels = torch.randint(0, n_class, (bs,), generator=gen, device=dev)

        def head_step():
            logits, aux = head(feats, labels)
            (lossfn(logits, labels) + aux).backward()

        ms = cuda_ms(head_step, iters=20)
        split, _ = device_split(head_step, steps=3)
        dev_ms = sum(split.values())
        print(f"[profile] margin head + CE ({head_name}, bs {bs}, {feat_dim}-d, {n_class} classes; forward and "
              f"backward, alone): {ms:.4f} ms a call (CUDA events), device busy {dev_ms:.4f} ms"
              + (f" = {dev_ms / max(busy, 1e-9):.2%} of the face_synth step's device busy" if n_class == classes else "")
              + "; device ms: " + ", ".join(f"{lb} {v:.4f}" for lb, v in split.items() if v > 0))
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
    for trial, path in enumerate((KERNEL_PATH, VISION_PATH, VISION_PATH, KERNEL_PATH)):
        rates[path].append(train_rate(model, state, step, batch, path,
                                      f"[{tag}] bf16 bs {BATCH} trial {trial}, {path[0]} path")[0])
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


# ---------------------------------------------------------------- device augment

# the train augment list of configs/classification/pet_synth.yaml (pet.yaml's is the same, at bs 80)
PET_SYNTH_YAML = Path(__file__).resolve().parent / "configs" / "classification" / "pet_synth.yaml"
PET_BATCH = 80
# ops whose card and CPU results must be equal; the others (blends, hue, blur, the affine family and
# the composites that chain them) within 1 LSB, with at least this share of pixels equal
DA_EXACT = {"random_horizonflip", "random_verticalflip", "random_double_flip", "random_doubleflip", "random_invert",
            "random_grayscale", "random_autocontrast", "random_equalize", "random_cutout", "random_cutaddnoise",
            "random_crop"}
DA_MIN_EQUAL = 0.99
DA_TIMED_CALLS, DA_WARMUP = 10, 2


def augment_batch(n: int, dev: torch.device, seed: int = 5) -> torch.Tensor:
    """Seeded uint8 images [n, IMG, IMG, 3] on the card: noise over a per-image
    band [lo, hi] of values plus a gradient, so that the LUT ops, the blurs and
    the geometry all change it."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lo = torch.randint(0, 96, (n, 1, 1, 1), generator=gen, device=dev)
    span = torch.randint(64, 160, (n, 1, 1, 1), generator=gen, device=dev)
    noise = torch.randint(0, 256, (n, IMG, IMG, 3), generator=gen, device=dev)
    ramp = torch.arange(IMG, device=dev).view(1, IMG, 1, 1) * 255 // IMG
    return (lo + (noise // 2 + ramp // 2) * span // 256).clamp(0, 255).to(torch.uint8)


def card_noise(draw, like: torch.Tensor):
    """random_cutaddnoise's draw (a gate over its holes) with the noise the card
    draws from its seed, on the CPU, so the CPU apply uses the same noise."""
    fire, inner = draw
    shape = (len(fire), *like.shape[1:])
    noise = da.cutaddnoise_noise(torch.empty(shape, device=like.device), inner["noise_seed"]).cpu()
    return fire, {**inner, "noise": noise}


def phase_device_augment(dev: torch.device) -> None:
    """The device-augment stage at pet_synth's shape: every compiled op on the
    card against the same op on a CPU copy with the same draws, the stage once
    under the sync-debug mode, and its time per batch (see the module doc)."""
    from visiondk_tpu_torch.config import yaml_load

    tag = "device augment"
    augment = yaml_load(PET_SYNTH_YAML)["data"]["train"]["augment"]
    host, device_cfg = da.split_device_pipeline(augment)
    choice, flip = device_cfg
    x_card = augment_batch(BATCH, dev).to(torch.float32)
    x_cpu = x_card.cpu()
    n, h, w = x_card.shape[:3]
    cases = [(f"{name} (defaults)", {name: {"size": IMG - 32} if name == "random_crop" else None})
             for name in da._COMPILERS]
    cases += [(f"pet_synth choice branch {b} forced: {da._item_name(t)}", t)
              for b, t in enumerate(choice["random_choice"]["transforms"])]
    cases += [("pet_synth random_choice (drawn)", choice), ("pet_synth random_horizonflip (p 1 forced)",
                                                           {"random_horizonflip": {"p": 1.0}}),
              ("pet_synth random_horizonflip (drawn)", flip)]
    print(f"[{tag}] pet_synth split: {da.describe_split(host, device_cfg)}; batch {tuple(x_card.shape)} seeded "
          f"uint8 on the card; {len(cases)} ops, card against CPU on the same draws")
    worst = 0.0
    for i, (label, item) in enumerate(cases):
        name = da._item_name(item)
        op = da._compile_one(name, da._item_params(item))
        draw = op.draw(np.random.default_rng(100 + i), n, h, w)
        card = op.apply(x_card, draw).cpu()
        cpu = op.apply(x_cpu, card_noise(draw, x_card) if name == "random_cutaddnoise" else draw)
        check(card.shape == cpu.shape, f"[{tag}] {label}: card {tuple(card.shape)} vs CPU {tuple(cpu.shape)}")
        diff = (card - cpu).abs()
        err, equal = diff.max().item(), (diff == 0).float().mean().item()
        changed = (card.shape != x_cpu.shape) or bool((card != x_cpu).any())
        print(f"[{tag}] {label}: max |card - CPU| {err:g}, {equal:.6%} of pixels equal, "
              f"{'changed the batch' if changed else 'left the batch as it was'}")
        if name in DA_EXACT:
            check(err == 0, f"[{tag}] {label}: card and CPU differ (max {err})")
        else:
            check(err <= 1 and equal >= DA_MIN_EQUAL, f"[{tag}] {label}: card and CPU differ beyond the bar")
        worst = max(worst, err)

    stage = da.make_device_augment(device_cfg, group_size=1)
    images = x_card.to(torch.uint8)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = stage(7, images)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(out.shape == images.shape and out.dtype == torch.uint8, f"[{tag}] stage output {out.shape} {out.dtype}")
    print(f"[{tag}] pet_synth's whole stage under torch.cuda.set_sync_debug_mode('error'): no device-to-host "
          f"sync; {(out != images).any(dim=(1, 2, 3)).sum().item()} of {BATCH} images changed")

    step_ms = [BATCH / r * 1e3 for r in TRAIN_RATES[VIT.train_tag]]
    for bs, what in ((BATCH, "pet_synth"), (PET_BATCH, "pet.yaml")):
        imgs = augment_batch(bs, dev, seed=6)
        seeds = iter(range(1000))
        for _ in range(DA_WARMUP):
            stage(next(seeds), imgs)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for _ in range(DA_TIMED_CALLS):
            stage(next(seeds), imgs)
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / DA_TIMED_CALLS
        print(f"[{tag}] {what}'s stage, bs {bs} {IMG}²: {start.elapsed_time(end) / DA_TIMED_CALLS:.3f} ms a batch "
              f"(CUDA events over {DA_TIMED_CALLS} calls after {DA_WARMUP} warm-up; host clock {host_ms:.3f} ms)"
              + (f"; the ViT-B/16 bf16 train step (phase 5, kernel path) " + ", ".join(f"{t:.2f}" for t in step_ms)
                 + " ms" if bs == BATCH else ""))
    print(f"[{tag}] largest |card - CPU| over every op {worst:g}")


# ---------------------------------------------------------------- run loop

# the cuts of the run loop's pet_synth run: 20 train and 4 val JPEGs a class
# (35 classes: 700 train = 5 steps of 128 an epoch with drop_last, 140 val =
# one batch of 320), 3 epochs (0: val augments, the warm-up; 1: the full train
# pipeline; 2: weakened to the val augments from aug_epoch 2 on)
RUN_LOOP_CUTS = {"n_train_per_class": 20, "n_val_per_class": 4, "epochs": 3, "aug_epoch": 2}
RUN_LOOP_LOSS_RTOL = 1e-3
RUN_LOOP_TIMEOUT_S = 300


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self):
        for st in self.streams:
            st.flush()


def run_cli(module: str, argv: list) -> str:
    """``python -m module argv`` in this process (runpy with sys.argv set as
    on the command line), so the kernels' launch counts see its launches;
    returns what it printed, which also goes to stdout."""
    buf, saved = io.StringIO(), sys.argv
    sys.argv = [module, *argv]
    try:
        with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
            runpy.run_module(module, run_name="__main__", alter_sys=True)
    finally:
        sys.argv = saved
        gc.collect()
        torch.cuda.empty_cache()
    return buf.getvalue()


def read_metrics(project: Path) -> dict:
    """metrics.jsonl as {tag: {epoch: value}}; a resumed run's later record wins."""
    out: dict = {}
    for line in (project / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        out.setdefault(rec["tag"], {})[rec["step"]] = rec["value"]
    return out


def committed_epoch(project: Path):
    """The epoch of the newest complete ``last`` checkpoint on disk, or None:
    a promoted ``last/`` with its meta, or a complete ``.last.staging`` with
    the sidecar written before its save."""
    for data, meta in ((project / "last", project / "last" / "meta.json"),
                       (project / ".last.staging", project / "last.meta.json")):
        if data.is_dir() and meta.is_file():
            try:
                return json.loads(meta.read_text())["epoch"]
            except (ValueError, KeyError):  # the sidecar is being written
                return None
    return None


def killed_in_epoch_1(argv: list, project: Path) -> None:
    """``python -m visiondk_tpu_torch.main argv`` as a subprocess, SIGKILLed
    once epoch 0's checkpoint is complete on disk (its output in
    ``<project>.log``)."""
    log = project.parent / f"{project.name}.log"
    with open(log, "w") as fh:
        proc = subprocess.Popen([sys.executable, "-m", "visiondk_tpu_torch.main", *argv, "--project", str(project),
                                 "--seed", "0"], stdout=fh, stderr=subprocess.STDOUT)
        try:
            deadline = time.monotonic() + RUN_LOOP_TIMEOUT_S
            while committed_epoch(project) != 0:
                check(proc.poll() is None, f"{project.name} exited ({proc.returncode}) before epoch 0's "
                                           f"checkpoint: {log.read_text()[-2000:]}")
                check(time.monotonic() < deadline, f"{project.name}: no epoch-0 checkpoint in time")
                time.sleep(0.05)
            proc.send_signal(signal.SIGKILL)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait()


def start_killed_in_epoch_1(argv: list, project: Path):
    """``killed_in_epoch_1`` in a thread, beside work in this process; the
    returned future's ``result()`` waits for the kill (and raises what the
    thread raised)."""
    pool = ThreadPoolExecutor(max_workers=1)
    future = pool.submit(killed_in_epoch_1, argv, project)
    pool.shutdown(wait=False)
    return future


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start_torchrun(argv: list, project: Path, nproc: int = 1, extra=()) -> tuple:
    """``python -m torch.distributed.run --nproc_per_node nproc -m
    visiondk_tpu_torch.main --multihost argv`` started as a subprocess (its
    output in ``<project>.log``); ``finish_torchrun`` waits for it."""
    log = project.parent / f"{project.name}.log"
    fh = open(log, "w")
    proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(nproc),
                             "--master_addr", "127.0.0.1", "--master_port", str(free_port()),
                             "-m", "visiondk_tpu_torch.main", "--multihost", *argv, "--project", str(project),
                             "--seed", "0", *extra], stdout=fh, stderr=subprocess.STDOUT)
    return proc, fh, log, time.perf_counter()


def finish_torchrun(run: tuple, timeout: float = RUN_LOOP_TIMEOUT_S) -> float:
    """Waits for a ``start_torchrun`` run (``timeout`` seconds from its
    start, killed after them) and fails unless it exited 0. Returns its
    seconds."""
    proc, fh, log, t0 = run
    try:
        proc.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        fh.close()
    check(proc.returncode == 0, f"torchrun {log.stem} exited with {proc.returncode}: {log.read_text()[-3000:]}")
    return time.perf_counter() - t0


def stop_torchrun(run: tuple) -> None:
    """Kills a ``start_torchrun`` run whose result is no longer wanted."""
    proc, fh, _, _ = run
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    fh.close()


def torchrun_main(argv: list, project: Path, nproc: int = 1, extra=(), timeout: float = RUN_LOOP_TIMEOUT_S) -> float:
    """``start_torchrun`` and ``finish_torchrun`` in turn. Returns its seconds."""
    return finish_torchrun(start_torchrun(argv, project, nproc, extra), timeout)


def compare_runs(a: dict, b: dict, epochs, n_val: int) -> tuple:
    """Largest per-epoch train-loss difference (relative) and val-top1
    difference (in images) of two runs' metrics over ``epochs``, and whether
    every compared number is bit-identical."""
    loss = max(abs(a["Train_loss"][e] - b["Train_loss"][e]) / abs(a["Train_loss"][e]) for e in epochs)
    top1 = max(abs(a["Val_top1"][e] - b["Val_top1"][e]) * n_val for e in epochs)
    same = all(a[t][e] == b[t][e] for t in ("Train_loss", "Val_top1", "Val_v_loss") for e in epochs)
    return loss, top1, same


def start_synth_pet() -> tuple:
    """A temporary directory and the benchmarks/make_synth_pet.py process
    writing RUN_LOOP_CUTS' dataset into ``<dir>/synthpet``: (dir, process,
    start). The run loop, the multi-label run and distillation share it."""
    tmp = Path(tempfile.mkdtemp(prefix="vdk_synth_pet_"))
    proc = subprocess.Popen([sys.executable, str(PET_SYNTH_YAML.parents[2] / "benchmarks" / "make_synth_pet.py"),
                             "--root", str(tmp / "synthpet"), "--n-train", str(RUN_LOOP_CUTS["n_train_per_class"]),
                             "--n-val", str(RUN_LOOP_CUTS["n_val_per_class"]), "--seed", "0"],
                            stdout=subprocess.DEVNULL)
    return tmp, proc, time.perf_counter()


def synth_pet_root(data: tuple, tag: str) -> Path:
    """The shared synthetic pet folder, waiting for its generator."""
    tmp, proc, t0 = data
    waited = time.perf_counter()
    check(proc.wait(timeout=RUN_LOOP_TIMEOUT_S) == 0, f"make_synth_pet.py exited with {proc.returncode}")
    print(f"[{tag}] benchmarks/make_synth_pet.py --n-train {RUN_LOOP_CUTS['n_train_per_class']} --n-val "
          f"{RUN_LOOP_CUTS['n_val_per_class']}: done {time.perf_counter() - t0:.1f} s after its start, "
          f"{time.perf_counter() - waited:.1f} s of it waited for here")
    return tmp / "synthpet"


def phase_run_loop(dev: torch.device, pet_data: tuple) -> dict:
    """The classification run loop through the port's CLIs on pet_synth's
    ViT-B/16 (see the module doc), on the shared synthetic pet data
    (``start_synth_pet()``); returns the K1 family's launches of the
    in-process runs."""
    tag = "run loop"
    for module in ("yaml", "PIL"):
        try:
            __import__(module)
        except ImportError as e:
            raise RuntimeError(f"chip_smoke: [{tag}] needs {module} ({e}); it is not installed here") from e
    from visiondk_tpu_torch.config import yaml_dump, yaml_load
    from visiondk_tpu_torch.data import SmartDataProcessor, loader_kind
    from visiondk_tpu_torch.engine.trainer import CenterProcessor

    fwd, stash, bwd_p, _ = K1_KERNELS
    os.environ.pop("VDK_ATTN_NO_PCACHE", None)
    tmp = Path(tempfile.mkdtemp(prefix="vdk_run_loop_"))
    try:
        root = synth_pet_root(pet_data, tag)
        cfg = yaml_load(PET_SYNTH_YAML)
        cfg["data"]["root"] = str(root)
        cfg["data"]["train"]["aug_epoch"] = RUN_LOOP_CUTS["aug_epoch"]
        cfg["hyp"]["epochs"] = RUN_LOOP_CUTS["epochs"]
        yaml_path = tmp / "pet_synth_run_loop.yaml"
        yaml_dump(cfg, yaml_path)
        n_classes, bs, val_bs = cfg["model"]["num_classes"], cfg["data"]["train"]["bs"], cfg["data"]["val"]["bs"]
        n_train = RUN_LOOP_CUTS["n_train_per_class"] * n_classes
        n_val = RUN_LOOP_CUTS["n_val_per_class"] * n_classes
        epochs = RUN_LOOP_CUTS["epochs"]
        steps, val_batches = n_train // bs, -(-n_val // val_bs)
        print(f"[{tag}] configs/classification/pet_synth.yaml as written (data.train.device_augment 'auto': the "
              f"device-augment stage live in epoch 1) with these cuts: dataset {n_train} train / {n_val} val JPEGs "
              f"(make_synth_pet.py --n-train {RUN_LOOP_CUTS['n_train_per_class']} --n-val "
              f"{RUN_LOOP_CUTS['n_val_per_class']}; {steps} steps of {bs} an epoch), hyp.epochs {epochs} (was 6), "
              f"data.train.aug_epoch {RUN_LOOP_CUTS['aug_epoch']} (was 5); everything else as written "
              f"({cfg['model']['name']}, bs {bs}, val bs {val_bs}, bf16)")

        def train(project: Path, *extra) -> tuple:
            """One in-process run: its output, launches, metrics, seconds and the
            device-augment stage's calls in each epoch it trained."""
            reset_counts()
            marks, strategy = [], CenterProcessor._epoch_strategy

            def mark(self, epoch, *args, **kwargs):
                if kwargs.get("log", True):
                    marks.append(da.make_device_augment.calls)
                return strategy(self, epoch, *args, **kwargs)

            CenterProcessor._epoch_strategy = mark
            t = time.perf_counter()
            try:
                out = run_cli("visiondk_tpu_torch.main", ["--cfgs", str(yaml_path), "--project", str(project),
                                                          "--seed", "0", *extra])
            finally:
                CenterProcessor._epoch_strategy = strategy
            stage = [b - a for a, b in zip(marks, marks[1:] + [da.make_device_augment.calls])]
            return out, read_counts(), read_metrics(project), time.perf_counter() - t, stage

        live = [steps if cfg["hyp"]["warm_ep"] <= e < RUN_LOOP_CUTS["aug_epoch"] else 0 for e in range(epochs)]

        # run A: the main path, counted
        out_a, counts_a, metrics_a, secs_a, stage_a = train(tmp / "runA")
        want = only({stash: DEPTH * steps * epochs, bwd_p: DEPTH * steps * epochs, fwd: DEPTH * val_batches * epochs})
        check(counts_a == want, f"run A launches {[(NAMES[k], v) for k, v in counts_a.items()]}, want "
                                f"{[(NAMES[k], v) for k, v in want.items()]}")
        split = re.search(r"device augment split — (.*)", out_a)
        check(split is not None, "run A logged no device augment split")
        print(f"[{tag}] run A's trainer logged: device augment split — {split.group(1)}")
        check(stage_a == live, f"run A's device-augment stage calls by epoch {stage_a}, want {live}")
        loaders = re.search(r"loaders: (.*)", out_a).group(1)
        rates_a = [metrics_a["Train_images_per_sec"][e] for e in range(epochs)]
        for e in range(epochs):
            check(all(math.isfinite(metrics_a[t][e]) for t in ("Train_loss", "Val_v_loss", "Val_top1")),
                  f"run A epoch {e}: non-finite metrics")
        print(f"[{tag}] run A: {secs_a:.1f} s; loaders {loaders}; trainer-fed images/s by epoch "
              + ", ".join(f"{r:.1f}" for r in rates_a)
              + f"; launches: {NAMES[stash]} {counts_a[stash]} and {NAMES[bwd_p]} {counts_a[bwd_p]} "
                f"(= {DEPTH} x {steps * epochs} train steps), {NAMES[fwd]} {counts_a[fwd]} (= {DEPTH} x "
                f"{val_batches} val batch x {epochs} epochs), no other attention kernel; device-augment stage "
                f"calls by epoch {' / '.join(map(str, stage_a))}")

        # run B: the same command through torchrun as one NCCL rank (DDP, a one-rank all-reduce): no bit moves;
        # run C: a subprocess, killed (SIGKILL) in epoch 1 once epoch 0's checkpoint is complete, then resumed.
        # Both run beside validate and the serving CLIs below, which time nothing held
        run_b = start_torchrun(["--cfgs", str(yaml_path)], tmp / "runB")
        run_c = tmp / "runC"
        killing_c = start_killed_in_epoch_1(["--cfgs", str(yaml_path)], run_c)
        try:
            # validate on run A's best checkpoint
            reset_counts()
            out_v = run_cli("visiondk_tpu_torch.validate", ["--cfgs", str(tmp / "runA" / "config.yaml"),
                                                             "--weight", str(tmp / "runA" / "best"), "--ema"])
            counts_v = read_counts()
            check(counts_v == only({fwd: DEPTH * val_batches}),
                  f"validate launches {[(NAMES[k], v) for k, v in counts_v.items()]}")
            top1_v = float(re.search(r"'top1': ([0-9.e+-]+)", out_v).group(1))
            best_epoch = json.loads((tmp / "runA" / "best" / "meta.json").read_text())["epoch"]
            top1_a = metrics_a["Val_top1"][best_epoch]
            print(f"[{tag}] validate --ema on run A's best (epoch {best_epoch + 1}): top1 {top1_v!r}; run A logged "
                  f"{top1_a!r}; {NAMES[fwd]} launched {counts_v[fwd]}")
            check(top1_v == top1_a, f"validate top1 {top1_v} != run A's best-epoch top1 {top1_a}")
            counts_s, timed_serving = run_loop_serving(tmp, root, top1_v, val_batches, dev)
        except BaseException:
            stop_torchrun(run_b)
            raise
        finally:
            killing_c.result()
        secs_b = finish_torchrun(run_b)
        metrics_b = read_metrics(tmp / "runB")
        loss_d, top1_d, same = compare_runs(metrics_a, metrics_b, range(epochs), n_val)
        print(f"[{tag}] run B (python -m torch.distributed.run --nproc_per_node 1 -m visiondk_tpu_torch.main "
              f"--multihost: one NCCL rank, DDP; {secs_b:.1f} s, beside run C's first process and the serving CLIs) vs "
              f"run A, epochs 1-{epochs}: largest train-loss difference {loss_d:.3e} relative, largest val-top1 "
              f"difference {top1_d:.2f} images; bit-identical: {same} (required)")
        check(same, "run B through torchrun (one NCCL rank) is not bit-identical to run A")
        shutil.rmtree(tmp / "runB")

        done = sorted(read_metrics(run_c).get("Train_loss", {}))
        out_c, counts_c, metrics_c, _, stage_c = train(run_c, "--resume")
        resumed = int(re.search(r"resume: last \(epoch (\d+)\)", out_c).group(1))
        check(resumed == 1, f"run C resumed from epoch {resumed}, not 1 (epochs logged before the kill: {done})")
        check(stage_c == live[resumed:], f"resumed run C's device-augment stage calls {stage_c}, want {live[resumed:]}")
        loss_d, top1_d, same = compare_runs(metrics_a, metrics_c, range(resumed, epochs), n_val)
        print(f"[{tag}] run C: SIGKILL in epoch 1 (epochs logged before the kill: {done}), --resume from epoch "
              f"{resumed}; epochs {resumed + 1}-{epochs} vs run A: train loss {loss_d:.3e} relative, val top1 "
              f"{top1_d:.2f} images; bit-identical: {same} (required); device-augment stage calls by epoch "
              f"{' / '.join(map(str, stage_c))}")
        check(same, "the resumed run C is not bit-identical to run A")
        resumed_steps = steps * (epochs - resumed)
        check(counts_c == only({stash: DEPTH * resumed_steps, bwd_p: DEPTH * resumed_steps,
                                fwd: DEPTH * val_batches * (epochs - resumed)}),
              f"resumed run C launches {[(NAMES[k], v) for k, v in counts_c.items()]}")

        timed_serving()  # the programs' and the operator's times, with nothing beside them
        # the host pipeline alone against the step: the train loader of epoch 1, no step, on the split
        # host pipeline the trainer runs (decode + letterbox-or-RRC) and on the full pipeline (the
        # device_augment: false processor); as built (at most `prefetch` = 4 batches in flight, one
        # worker thread a batch)
        loader_rates, kinds = {}, {}
        for which, dev_aug in (("split", "auto"), ("full", False)):
            data_cfg = {**cfg["data"], "train": {**cfg["data"]["train"], "device_augment": dev_aug}}
            dp = SmartDataProcessor(data_cfg, project=str(tmp / f"loader_{which}"), training=True)
            loader = dp.dataloader("train", bs, seed=0)
            loader.set_epoch(1)
            built, kinds[which] = loader.prefetch, loader_kind(loader)
            t, n = time.perf_counter(), 0
            for batch in loader:
                n += batch["image"].shape[0]
            loader_rates[which, built] = n / (time.perf_counter() - t)
        synthetic = TRAIN_RATES[VIT.train_tag]
        fed = rates_a[1]
        print(f"[{tag}] ViT-B/16 bf16 bs {bs} images/s: train loader alone ({loader.num_workers} workers on "
              f"{os.cpu_count()} cores, epoch 1, no step) "
              + ", ".join(f"{which} host pipeline ({kinds[which]}) {r:.1f} with {k} batches in flight"
                          for (which, k), r in loader_rates.items())
              + f" (the trainer's loader keeps {built}; split = decode + letterbox-or-RRC, the rest on the card; "
                f"full = device_augment: false); trainer-fed by epoch " + ", ".join(f"{r:.1f}" for r in rates_a)
              + f"; synthetic batch on the card (phase 5, kernel path) " + ", ".join(f"{r:.1f}" for r in synthetic)
              + f" -> the trainer-fed epoch 1 runs at {fed / (sum(synthetic) / len(synthetic)):.1%} of the "
                f"synthetic rate: {'host-paced' if fed < 0.9 * min(synthetic) else 'not host-paced'}")
        return {k: counts_a[k] + counts_c[k] + counts_v[k] + counts_s[k] for k in KERNELS}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


VIS_SAMPLING = 8  # images visualize --cam writes on the run loop's best


def run_loop_serving(tmp: Path, root: Path, top1_bf16: float, val_batches: int, dev: torch.device) -> tuple:
    """Phases Q8 and CAM through the CLIs on the run loop's best checkpoint
    (run A's): ``validate --quant int8`` (top1 within Q8_TOP1_POINTS of the
    bf16 validate's), then ``visualize --cam --cam_method gradcam --sampling
    8 --remove_label``: 8 side-by-side overlays and 8 label files, one stash
    forward and one backward from P an image; then phase EX (``export_vit``).
    Returns their launches, and EX's timings to run where nothing runs
    beside them."""
    from PIL import Image

    tag = "run loop"
    fwd, stash, bwd_p, _ = K1_KERNELS
    weight = ["--cfgs", str(tmp / "runA" / "config.yaml"), "--weight", str(tmp / "runA" / "best"), "--ema"]
    reset_counts()
    t = time.perf_counter()
    out_q = run_cli("visiondk_tpu_torch.validate", weight + ["--quant", "int8"])
    counts_q = read_counts()
    secs_q = time.perf_counter() - t
    check(counts_q == only({fwd: DEPTH * val_batches}),
          f"validate --quant int8 launches {[(NAMES[k], v) for k, v in counts_q.items()]}")
    top1_q = float(re.search(r"'top1': ([0-9.e+-]+)", out_q).group(1))
    top5 = re.findall(r"'top5': ([0-9.e+-]+)", out_q)
    print(f"[{tag}] validate --ema --quant int8 on run A's best: top1 {top1_q!r} (bf16 validate {top1_bf16!r}; "
          f"want within {Q8_TOP1_POINTS}), top5 {top5[0] if top5 else '-'}; {secs_q:.1f} s with the model build; "
          f"{NAMES[fwd]} launched {counts_q[fwd]}")
    check(abs(top1_q - top1_bf16) <= Q8_TOP1_POINTS, f"int8 top1 {top1_q} vs bf16 {top1_bf16}")

    vis = tmp / "vis"
    reset_counts()
    t = time.perf_counter()
    run_cli("visiondk_tpu_torch.visualize", weight + ["--data", str(root / "val"), "--cam", "--cam_method", "gradcam",
                                                      "--sampling", str(VIS_SAMPLING), "--remove_label",
                                                      "--show_path", str(vis)])
    counts_c = read_counts()
    secs_c = time.perf_counter() - t
    overlays = sorted((vis / "exp").glob("*.jpg"))
    labels = sorted((vis / "exp" / "labels").glob("*.txt"))
    side = [Image.open(p).size for p in overlays]
    raw = [Image.open(next(root.glob(f"val/*/{p.name}"))).size for p in overlays]
    paired = all(s == (2 * r[0], r[1]) for s, r in zip(side, raw))  # the image and its CAM side by side
    # an image: its eval forward, the CAM's argmax forward and capture, the injected forward (the blocks
    # before the target on the no-stash kernel, the last on the stash forward) and one backward from P;
    # and the target search's forward once
    per_image = {fwd: 3 * DEPTH + DEPTH - 1, stash: 1, bwd_p: 1}
    want = only({k: v * VIS_SAMPLING + (DEPTH if k is fwd else 0) for k, v in per_image.items()})
    print(f"[{tag}] visualize --ema --cam --cam_method gradcam --sampling {VIS_SAMPLING} --remove_label on run A's "
          f"best: {len(overlays)} overlays (image and CAM side by side: {paired}), "
          f"{len(labels)} label files; {secs_c:.1f} s with the model build; launches "
          + ", ".join(f"{NAMES[k]} {counts_c[k]}" for k in (fwd, stash, bwd_p)))
    check(len(overlays) == VIS_SAMPLING and len(labels) == VIS_SAMPLING and paired,
          "visualize --cam did not write its overlays")
    check(counts_c == want, f"visualize --cam launches {[(NAMES[k], v) for k, v in counts_c.items()]}, want "
                            f"{[(NAMES[k], v) for k, v in want.items()]}")
    counts_x, timed = export_vit(tmp, root, weight, dev)
    return add_counts(add_counts(counts_q, counts_c), counts_x), timed


# ---------------------------------------------------------------- phase EX: export and the exported programs

EX_BATCHES = (1, 8, 128)  # batches each exported program is held to its eager step at
EX_TOL = 1e-5  # max |program − eager step| over the outputs, relative to their largest |entry|
EX_MIN_COSINE = 0.99999  # exported Swin-B embeddings against the eager embed step, per row
EX_RATE_ITERS = 10


def restore_served(weight: list, dev: torch.device):
    """(the served module, its CenterProcessor) of the ``--cfgs ... --weight
    ... --ema`` arguments ``weight``, restored as the port's serving CLIs
    restore it."""
    from visiondk_tpu_torch.config import yaml_load
    from visiondk_tpu_torch.engine.checkpoint import CheckpointManager
    from visiondk_tpu_torch.engine.trainer import CenterProcessor

    cfgs = yaml_load(weight[1])
    best = Path(weight[3])
    cp = CenterProcessor(cfgs, project=str(best.parent), train=False, device=dev)
    tx = build_tx(cfgs["hyp"], steps_per_epoch=1, discrete_per_epoch=True, model_cfg=cfgs["model"])
    state, _ = CheckpointManager(best.parent).restore(best.name, create_train_state(cp.model, tx))
    return state.ema_model, cp


def export_cli(tag: str, tmp: Path, weight: list, name: str, extra: list) -> tuple:
    """``python -m visiondk_tpu_torch.export ... --batch -1`` in this process:
    (the saved program loaded back, seconds, MB). Tracing runs the operators'
    fake implementations, which launch nothing."""
    out = tmp / f"{name}.pt2"
    reset_counts()
    t = time.perf_counter()
    printed = run_cli("visiondk_tpu_torch.export", weight + ["--out", str(out), "--batch", "-1", *extra])
    secs = time.perf_counter() - t
    counts = read_counts()
    t = time.perf_counter()
    program = torch.export.load(out)
    load_s = time.perf_counter() - t
    mb = out.stat().st_size / 1e6
    print(f"[{tag}] export {' '.join(extra) or '(f32 weights)'} --batch -1 --ema: {secs:.1f} s with the checkpoint's "
          f"restore; {mb:.1f} MB; loaded back in {load_s:.1f} s; launches while tracing "
          f"{sum(counts.values())}; it printed: {printed.strip().splitlines()[-1]}")
    check(sum(counts.values()) == 0, f"export launched kernels while tracing: {counts}")
    return program, secs, mb


def hold_program(tag: str, label: str, program, step, embed: bool, fwd, per_forward: int, img: int,
                 dev: torch.device) -> tuple:
    """The loaded program against the eager step on the same uint8 batches
    (EX_BATCHES): within EX_TOL of the largest |entry| (and, for embeddings,
    per-row cosine ≥ EX_MIN_COSINE), argmax equal for logits; exactly
    ``per_forward`` launches of ``fwd`` and no other kernel a program forward.
    Returns (the launches of these forwards, ``time_program``'s timing of
    both at the largest batch, to be called where nothing runs beside it)."""
    served = program.module()
    gen = torch.Generator(device=dev).manual_seed(21)
    total = {k: 0 for k in KERNELS}
    for b in EX_BATCHES:
        x = torch.randint(0, 256, (b, img, img, 3), generator=gen, device=dev, dtype=torch.uint8)
        reset_counts()
        with torch.inference_mode():
            got = served(x)
        counts = read_counts()
        total = add_counts(total, counts)
        want = step({"image": x})
        err = ((got - want).abs().max() / want.abs().max()).item()
        same = bool(torch.equal(got, want))
        line = (f"[{tag}] {label} bs {b}: program vs eager step max |diff| / max |entry| {err:.3e} (bar {EX_TOL}); "
                f"bit-identical {same}; launches a forward "
                + ", ".join(f"{NAMES[k]} {v}" for k, v in counts.items() if v))
        ok = err <= EX_TOL and counts == only({fwd: per_forward})
        if embed:
            cos = row_cosine(got, want).min().item()
            line += f"; min row cosine {cos:.7f} (bar {EX_MIN_COSINE})"
            ok = ok and cos >= EX_MIN_COSINE
        else:
            agree = (got.argmax(1) == want.argmax(1)).float().mean().item()
            line += f"; argmax agreement {agree:.2%}"
            ok = ok and agree == 1.0
        print(line)
        check(ok, f"{label} bs {b}: the exported program disagrees with the eager step")
    return total, lambda: time_program(tag, label, served, step, x)


def time_program(tag: str, label: str, served, step, x: torch.Tensor) -> None:
    """Images/s of a loaded program (``served``, its module) and its eager
    step on ``x`` (CUDA events, order eager, program, program, eager), and
    each one's host time to enqueue a call. Not counted as main-path launches."""

    def run_program():
        with torch.inference_mode():  # as the eager step runs (no_grad still dispatches every op's autograd key)
            served(x)

    def host_ms(fn):  # the time to enqueue one call, the device's queue drained before
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        ms = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        return ms

    eager = [cuda_ms(lambda: step({"image": x}), iters=EX_RATE_ITERS, warmup=2)]
    prog = [cuda_ms(run_program, iters=EX_RATE_ITERS, warmup=2) for _ in range(2)]
    eager.append(cuda_ms(lambda: step({"image": x}), iters=EX_RATE_ITERS, warmup=2))
    host = {"program": min(host_ms(run_program) for _ in range(3)),
            "eager": min(host_ms(lambda: step({"image": x})) for _ in range(3))}
    rate = lambda ms: x.shape[0] / ms * 1e3  # noqa: E731
    print(f"[{tag}] {label} bs {x.shape[0]} images/s (CUDA events, {EX_RATE_ITERS} calls after 2 warm-up; order "
          f"eager, program, program, eager; {card()}): program " + ", ".join(f"{rate(ms):.1f}" for ms in prog)
          + " | eager step " + ", ".join(f"{rate(ms):.1f}" for ms in eager)
          + f" -> program at {sum(eager) / sum(prog):.1%} of the eager step; host time to enqueue a call (best of "
            f"3): program {host['program']:.1f} ms, eager {host['eager']:.1f} ms")
    reset_counts()


def export_vit(tmp: Path, root: Path, weight: list, dev: torch.device) -> tuple:
    """Phase EX on the run loop's best (ViT-B/16, see the module doc).
    Returns (the launches of the programs' checked forwards and of
    single_predict, the timings to run where nothing runs beside them)."""
    from PIL import Image

    tag = "run loop"
    fwd = K1_KERNELS[0]
    program, _, _ = export_cli(tag, tmp, weight, "vit_b16", [])
    programs = {"bf16": program}
    # exported_predict in a fresh process, beside the int8 export, against single_predict on a val image at
    # IMG² (neither tool resizes it)
    image = tmp / "ex_image.jpg"
    Image.open(sorted((root / "val").glob("*/*.jpg"))[0]).convert("RGB").resize((IMG, IMG)).save(image, quality=95)
    t = time.perf_counter()
    fresh = subprocess.Popen([sys.executable, "-m", "visiondk_tpu_torch.tools.exported_predict", "--artifact",
                              str(tmp / "vit_b16.pt2"), "--img", str(image)], cwd=Path(__file__).resolve().parent,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        programs["int8"], _, _ = export_cli(tag, tmp, weight, "vit_b16_int8", ["--quant", "int8"])
        reset_counts()
        out_s = run_cli("visiondk_tpu_torch.tools.single_predict", ["--img", str(image), *weight])
        counts = read_counts()
        stdout, stderr = fresh.communicate(timeout=RUN_LOOP_TIMEOUT_S)
    finally:
        if fresh.poll() is None:
            fresh.kill()
            fresh.wait()
    secs = time.perf_counter() - t
    check(fresh.returncode == 0, f"exported_predict exited with {fresh.returncode}: {stderr[-3000:]}")
    served, cp = restore_served(weight, dev)
    scfg, names = cp.step_config(), cp.data_processor.val_dataset.class_names
    single = [(name, float(p)) for name, p in (ln.rsplit(maxsplit=1) for ln in out_s.strip().splitlines()[-5:])]
    exported = [(names[int(j)], float(p)) for j, p in re.findall(r"^class (\d+): (\S+)$", stdout, re.M)]
    same = (len(exported) == 5 and [n for n, _ in single] == [n for n, _ in exported]
            and all(abs(p - q) <= 1e-4 for (_, p), (_, q) in zip(single, exported)))
    print(f"[{tag}] exported_predict --artifact <the bf16 program> in a fresh process ({secs:.1f} s with the "
          f"interpreter's start and the kernel's load, beside the int8 export): top-5 {exported}; single_predict "
          f"--ema on the same image {single}: same classes and probabilities {same}")
    check(same, "exported_predict and single_predict disagree")

    steps = {"bf16": make_eval_step(served, scfg),
             "int8": make_eval_step(served, scfg, quant="int8", quant_cache=quant.build_weight_cache(served))}
    timings = []
    for which, program in programs.items():
        held, timing = hold_program(tag, f"the {which} program (export --ema"
                                    + (" --quant int8)" if which == "int8" else ")"),
                                    program, steps[which], False, fwd, DEPTH, IMG, dev)
        counts, timings = add_counts(counts, held), timings + [timing]

    def timed():
        for timing in timings:
            timing()
        op_against_launch(tag, dev)

    return counts, timed


def op_against_launch(tag: str, dev: torch.device) -> None:
    """The registered K1 operator (what the eval step and the programs call)
    against a direct ``_launch_fwd`` of the same kernel at ViT-B/16 eval bs
    128, bf16: device ms (CUDA events) and host µs a call (the time to
    enqueue, the queue kept short of full). Not counted as main-path
    launches."""
    from visiondk_tpu_torch.ops import attention as k1

    gen = torch.Generator(device=dev).manual_seed(22)
    qkv = torch.randn((BATCH, 197, 3 * 768), generator=gen, device=dev).bfloat16()

    def host_us(fn, iters=100):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        us = (time.perf_counter() - t) / iters * 1e6
        torch.cuda.synchronize()
        return us

    calls = {"operator": lambda: fused_qkv_attention_fwd(qkv, 12),
             "direct launch": lambda: k1._launch_fwd(qkv, 12, 197, stash=False)}
    check(torch.equal(calls["operator"](), calls["direct launch"]()[0]), "the operator's O differs from the launch's")
    order = ("direct launch", "operator", "operator", "direct launch")
    dev_ms = {name: [] for name in calls}
    host = {name: [] for name in calls}
    for name in order:
        dev_ms[name].append(cuda_ms(calls[name], iters=50))
        host[name].append(host_us(calls[name]))
    reset_counts()
    print(f"[{tag}] K1 forward at ViT-B/16 eval bs {BATCH} bf16 ({card()}; order direct, operator, operator, direct): "
          + "; ".join(f"{name} device " + ", ".join(f"{v:.4f}" for v in dev_ms[name]) + " ms, host "
                      + ", ".join(f"{v:.1f}" for v in host[name]) + " us a call" for name in calls))


# ---------------------------------------------------------------- margin heads and retrieval

# (bs, feat_dim, classes): face_synth's and cbir_synth's ArcFace head, and face.yaml's 58,671 classes
MH_SHAPES = ((64, 128, 64), (64, 128, 58671))
# every head of models/heads.py, MV-Softmax in both modes
MH_HEADS = (("arcface", {}), ("magface", {}), ("circleloss", {}), ("mv_softmax", {"is_am": False}),
            ("mv_softmax", {"is_am": True}))
MH_LOGIT_TOL = 1e-4   # max |card f32 − CPU f64| over the logits at scale 32 (× s/32 at another scale)
MH_GRAD_RTOL = 1e-5   # max |card − CPU| over a gradient, relative to its largest |entry|
SEARCH_TOL = 1e-5     # scores; and indices must agree where consecutive f64 scores differ by more
# (queries, gallery, dim, k): the card against a float64 CPU brute force (the gallery's last
# SEARCH_DUPLICATES rows repeat its first ones: exact ties), and the queries/s shape (the JAX
# docstring's 1M × 128 gallery)
SEARCH_CHECK = (512, 50_000, 128, 100)
SEARCH_DUPLICATES = 2_000
SEARCH_RATE = (1024, 1_000_000, 128, 100)


def margin_case(op, opts, w, f, y, g, device, dtype):
    """(logits, aux, dL/dW, dL/dfeats) in float64 on the CPU, of the loss
    sum(logits · g) + aux on ``device`` in ``dtype``."""
    tw = w.to(device, dtype, copy=True).requires_grad_()
    tf = f.to(device, dtype, copy=True).requires_grad_()
    logits, aux = op(tw, tf, y.to(device), **opts)
    (torch.sum(logits * g.to(device, dtype)) + aux).backward()
    return logits.detach().cpu().double(), aux.item(), tw.grad.cpu().double(), tf.grad.cpu().double()


def brute_topk(queries: torch.Tensor, gallery: torch.Tensor, k: int) -> tuple:
    """The exact top-(k + 1) in float64 on the CPU over the bf16-rounded
    inputs, ordered by (score descending, index ascending)."""
    sim = queries.bfloat16().double() @ gallery.bfloat16().double().T
    order = torch.sort(-sim, dim=1, stable=True).indices[:, :k + 1]
    return sim.gather(1, order), order


def check_topk(label: str, scores, idx, ref_scores, ref_idx, k: int) -> None:
    """Scores within SEARCH_TOL of the brute force rank by rank; indices
    equal at every rank whose f64 score is more than SEARCH_TOL from both
    neighbours, and at every rank of an exact tie (the lower index first)."""
    scores, idx = torch.as_tensor(scores).double().cpu(), torch.as_tensor(idx).cpu()
    err = (scores - ref_scores[:, :k]).abs().max().item()
    gap = ref_scores[:, :-1] - ref_scores[:, 1:]  # ≥ 0
    before = torch.cat([torch.full_like(gap[:, :1], math.inf), gap[:, :k - 1]], dim=1)
    after = gap[:, :k]
    decided = ((before > SEARCH_TOL) & (after > SEARCH_TOL)) | (before == 0) | (after == 0)
    wrong = ((idx != ref_idx[:, :k]) & decided).sum().item()
    ties = int(((before == 0) | (after == 0)).sum().item())
    print(f"[margin heads] {label}: max |score - reference| {err:.3e} (bar {SEARCH_TOL}); {wrong} index "
          f"mismatches among {int(decided.sum().item())} decided ranks ({ties} ranks in exact ties)")
    check(err <= SEARCH_TOL and wrong == 0, f"{label}: top-k disagrees with the float64 brute force")


def phase_margin_heads(dev: torch.device) -> None:
    """The margin heads and exact top-k retrieval on the card (see the module doc)."""
    tag = "margin heads"
    saved = torch.backends.cuda.matmul.allow_tf32
    # the heads and the search set their own product precision: run them under the caller's TF32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for b, d, c in MH_SHAPES:
            rng = np.random.default_rng(c)
            w = torch.from_numpy(rng.normal(size=(d, c)).astype(np.float32))
            f = torch.from_numpy((2.0 * rng.normal(size=(b, d))).astype(np.float32))  # ‖f‖ ≈ 23: MagFace's [10, 110]
            y = torch.from_numpy(rng.integers(0, c, size=b))
            g = torch.from_numpy(rng.normal(size=(b, c)).astype(np.float32))
            cos_ref = mh.cosine_logits(w.double(), f.double())
            cos_tf32 = torch.clamp(F.normalize(f.to(dev), dim=1) @ F.normalize(w.to(dev), dim=0), -1.0, 1.0)
            tf32_err = 32 * (cos_tf32.cpu().double() - cos_ref).abs().max().item()
            for name, opts in MH_HEADS:
                op = mh.MARGIN_OPS[name]
                got = margin_case(op, opts, w, f, y, g, dev, torch.float32)
                ref = margin_case(op, opts, w, f, y, g, "cpu", torch.float64)
                scale = opts.get("scale", opts.get("gamma", 256.0 if name == "circleloss" else 32.0))
                bar = MH_LOGIT_TOL * scale / 32
                err = (got[0] - ref[0]).abs().max().item()
                aux_err = abs(got[1] - ref[1]) / max(abs(ref[1]), 1e-30)
                grad_err = [(a - r).abs().max().item() / max(r.abs().max().item(), 1e-30)
                            for a, r in zip(got[2:], ref[2:])]
                label = f"{name}{'' if 'is_am' not in opts else ' (AM)' if opts['is_am'] else ' (Arc)'}"
                print(f"[{tag}] {label} bs {b}, {d}-d, {c} classes: card f32 vs CPU float64: max |logit diff| "
                      f"{err:.3e} (bar {bar:g}), aux rel {aux_err:.1e}, gradients max |diff| / max |entry| "
                      f"W {grad_err[0]:.3e}, feats {grad_err[1]:.3e} (bar {MH_GRAD_RTOL})")
                check(err <= bar and aux_err <= 1e-6 and max(grad_err) <= MH_GRAD_RTOL,
                      f"{label} at {c} classes: the card disagrees with float64")
            check(torch.backends.cuda.matmul.allow_tf32, "a head changed the caller's TF32 setting")
            print(f"[{tag}] {c} classes: a TF32 product (allow_tf32 on, the setting the heads ran under) "
                  f"would move the scale-32 logits by {tf32_err:.3e} (bar {MH_LOGIT_TOL})")

        q, n_g, d, k = SEARCH_CHECK
        gen = torch.Generator().manual_seed(11)
        queries = F.normalize(torch.randn(q, d, generator=gen), dim=1)
        gallery = F.normalize(torch.randn(n_g, d, generator=gen), dim=1)
        gallery[-SEARCH_DUPLICATES:] = gallery[:SEARCH_DUPLICATES]
        ref = brute_topk(queries, gallery, k)
        s, i = retrieval.topk_ip(queries.to(dev), gallery.to(dev), k)
        check_topk(f"topk_ip {q} x {n_g} x {d}, k {k}, against a float64 brute force", s, i, *ref, k)
        s, i = retrieval.search(queries.numpy(), gallery.numpy(), k, query_chunk=200, device=dev)
        check_topk(f"search (chunks of 200) {q} x {n_g} x {d}, k {k}", s, i, *ref, k)

        q, n_g, d, k = SEARCH_RATE
        gen = torch.Generator(device=dev).manual_seed(12)
        queries = F.normalize(torch.randn(q, d, generator=gen, device=dev), dim=1)
        gallery = F.normalize(torch.randn(n_g, d, generator=gen, device=dev), dim=1)
        whole = cuda_ms(lambda: retrieval.topk_ip(queries, gallery, k), iters=5, warmup=2)
        product = cuda_ms(lambda: retrieval.scores(queries, gallery), iters=5, warmup=2)
        sim = retrieval.scores(queries, gallery)
        topk = cuda_ms(lambda: retrieval.topk_lower_index(sim, k), iters=5, warmup=2)
        del sim
        print(f"[{tag}] exact search {q} queries x {n_g} x {d} gallery, k {k} (topk_ip, bf16-rounded inputs, "
              f"float64 products rounded to f32, on the card: {card()}): {whole:.3f} ms a call = "
              f"{q / whole * 1e3:.1f} queries/s (CUDA events, 5 calls after 2 warm-up); of which the scores "
              f"{product:.3f} ms ({2 * q * n_g * d / product / 1e9:.1f} TFLOP/s) and the top-k {topk:.3f} ms")
        approximate_search(queries, gallery, k, whole)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    torch.cuda.empty_cache()


AR_TARGETS = (0.9, 0.95, 0.99)  # recall targets of approximate search (phase AR)
AR_SLACK = 0.005  # mean recall@k against exact search at least the target less this
AR_CHECK = (4, 65_536)  # queries and gallery rows of the card-against-CPU check


def approximate_search(queries: torch.Tensor, gallery: torch.Tensor, k: int, exact_ms: float) -> None:
    """Phase AR (see the module doc) on phase MH's queries/s gallery, on the card."""
    tag = "margin heads"
    _, exact_i = retrieval.topk_ip(queries, gallery, k)
    q, n_g = queries.shape[0], gallery.shape[0]
    sim = retrieval.scores(queries, gallery)
    for r in AR_TARGETS:
        bins = retrieval.approx_reduction_size(n_g, k, r)
        whole = cuda_ms(lambda: retrieval.topk_ip(queries, gallery, k, recall_target=r), iters=5, warmup=2)
        select = cuda_ms(lambda: retrieval.approx_topk(sim, k, r), iters=5, warmup=2)
        s, i = retrieval.topk_ip(queries, gallery, k, recall_target=r)
        recall = (i[:, :, None] == exact_i[:, None, :]).any(dim=2).double().mean().item()
        true = torch.equal(sim.gather(1, i), s)
        print(f"[{tag}] approximate search, recall target {r}: {bins} bins of {-(-n_g // bins)} columns; "
              f"{whole:.3f} ms a call = {q / whole * 1e3:.1f} queries/s against exact {q / exact_ms * 1e3:.1f} "
              f"(CUDA events, 5 calls after 2 warm-up, {card()}); bin maxima + top-k {select:.3f} ms; mean "
              f"recall@{k} against exact search {recall:.6f} (bar {r - AR_SLACK:g}); scores the true scores: {true}")
        check(recall >= r - AR_SLACK and true, f"approximate search at {r}: recall {recall}, true scores {true}")
    del sim
    # the card against the CPU: the top k + 1 (of the same bins) held as phase MH holds exact search
    nq, ng = AR_CHECK
    q4, g4 = queries[:nq], gallery[:ng]
    for r in AR_TARGETS:
        check(retrieval.approx_reduction_size(ng, k, r) == retrieval.approx_reduction_size(ng, k + 1, r),
              "the top k + 1 takes other bins")
        s, i = retrieval.topk_ip(q4, g4, k + 1, recall_target=r)
        ref_s, ref_i = retrieval.topk_ip(q4.cpu(), g4.cpu(), k + 1, recall_target=r)
        check_topk(f"approximate search at {r}, {nq} x {ng} x {queries.shape[1]}, card against the CPU",
                   s[:, :k], i[:, :k], ref_s.double(), ref_i, k)


# ---------------------------------------------------------------- embedding run loop

FACE_SYNTH_YAML = PET_SYNTH_YAML.parents[1] / "faceX" / "face_synth.yaml"
CBIR_SYNTH_YAML = PET_SYNTH_YAML.parents[1] / "faceX" / "cbir_synth.yaml"
EMBED_RUN_EPOCHS = 2  # 3 until the CNN, multi-label and distillation phases took their share of the time
FACE_SYNTH_N_TRAIN = 4  # train images an id (the generator's default is 20), cut for the time limit
EMBED_RUN_TIMEOUT_S = 300


def checkpoint_bytes(written: list):
    """A context in which every checkpoint write's state.pt size is appended to ``written``."""
    from visiondk_tpu_torch.engine.checkpoint import CheckpointManager

    write = CheckpointManager._write

    def counted(self, name, host_state):
        write(self, name, host_state)
        written.append((self.directory / f".{name}.staging" / "state.pt").stat().st_size)

    @contextlib.contextmanager
    def ctx():
        CheckpointManager._write = counted
        try:
            yield
        finally:
            CheckpointManager._write = write

    return ctx()


def embedding_epochs(project: Path, *extra, module="visiondk_tpu_torch.main", argv=None) -> tuple:
    """One in-process run of ``module``: (output, launches in each epoch's
    training, launches in each evaluation, device-augment stage calls in
    each epoch, metrics.jsonl, seconds, checkpoint bytes written), with the
    epoch boundaries read at each evaluation (``_eval_embedding``)."""
    from visiondk_tpu_torch.engine.trainer import CenterProcessor

    train, evals, stage, written = [], [], [], []
    evaluate = CenterProcessor._eval_embedding
    mark = [read_counts(), da.make_device_augment.calls]

    def counted(self, embed_step):
        at = read_counts()
        train.append({k: at[k] - mark[0][k] for k in KERNELS})
        stage.append(da.make_device_augment.calls - mark[1])
        out = evaluate(self, embed_step)
        done = read_counts()
        evals.append({k: done[k] - at[k] for k in KERNELS})
        mark[:] = [done, da.make_device_augment.calls]
        return out

    reset_counts()
    mark[:] = [read_counts(), 0]
    CenterProcessor._eval_embedding = counted
    t = time.perf_counter()
    try:
        with checkpoint_bytes(written):
            out = run_cli(module, argv if argv is not None else ["--project", str(project), "--seed", "0", *extra])
    finally:
        CenterProcessor._eval_embedding = evaluate
    metrics = read_metrics(project) if (project / "metrics.jsonl").is_file() else {}
    return out, train, evals, stage, metrics, time.perf_counter() - t, sum(written)


def start_face_two_ranks(tmp: Path, face_yaml: Path) -> tuple:
    """face_synth (``face_yaml``) on two gloo ranks sharing the card
    (``--dist_backend gloo --device cuda:0``) with ``--model_parallel 2``
    through torchrun, started; ``face_two_ranks`` finishes it."""
    return start_torchrun(["--cfgs", str(face_yaml), "--model_parallel", "2", "--dist_backend", "gloo",
                           "--device", "cuda:0"], tmp / "D", nproc=2)


def face_two_ranks(tmp: Path, cfg: dict, face_yaml: Path, steps: int, face_batches: int, run: tuple) -> list:
    """``start_face_two_ranks``'s run (``cfg``: 2 epochs; its ArcFace head's
    64 classes split 32 / 32) waited for: rank 0 alone writes the log,
    metrics.jsonl and the checkpoints, and both ranks' replicated pair
    evaluations print the same mean; then ``--resume`` in one process (here,
    counted) loads its last checkpoint and trains a third epoch. Returns the
    resumed run's launches."""
    from visiondk_tpu_torch.config import yaml_dump

    tag, fwd, stash, bwd_p = "embedding run", *wattn.KERNELS[:3]
    epochs = cfg["hyp"]["epochs"]
    project = tmp / "D"
    secs = finish_torchrun(run, timeout=EMBED_RUN_TIMEOUT_S)
    out = (tmp / "D.log").read_text()
    logs = sorted(p.name for p in project.glob("log*.log"))
    records = [json.loads(line) for line in (project / "metrics.jsonl").read_text().splitlines()]
    written = [(r["tag"], r["step"]) for r in records]
    metrics = read_metrics(project)
    rank1 = [ast.literal_eval(m) for m in re.findall(r"^\[rank 1\] (\{'mean'.*\})$", out, re.M)]
    saved = torch.load(project / "last" / "state.pt", map_location="cpu", weights_only=True)
    heads = {k: tuple(saved[k]["head.weight"].shape) for k in ("model", "ema")}
    print(f"[{tag}] face run D: python -m torch.distributed.run --nproc_per_node 2 ... --multihost --model_parallel 2 "
          f"--dist_backend gloo --device cuda:0 (two ranks on this card, the head's 64 classes 32 a rank, bs 64 = "
          f"32 a rank), {epochs} epochs: {secs:.1f} s, beside runs B and C; epoch losses "
          + ", ".join(f"{metrics['Train_epoch_loss'][e]!r}" for e in range(epochs)) + "; rank 0's images/s (its rows) "
          + ", ".join(f"{metrics['Train_images_per_sec'][e]:.1f}" for e in range(epochs)) + "; pair means rank 0 "
          + f"{[metrics['Val_mean'][e] for e in range(epochs)]}, rank 1 {[r['mean'] for r in rank1]}; log files "
          f"{logs}; metrics.jsonl records {len(records)} (each tag and step once: {len(set(written)) == len(written)}); "
          f"the checkpoint's head {heads} (whole)")
    check(len(logs) == 1 and len(set(written)) == len(written), "face run D: a rank other than 0 wrote")
    check(all(math.isfinite(metrics["Train_epoch_loss"][e]) for e in range(epochs)), "face run D: non-finite loss")
    check([r["mean"] for r in rank1] == [metrics["Val_mean"][e] for e in range(epochs)],
          "face run D: the ranks' pair means differ")
    check(heads == {"model": (128, 64), "ema": (128, 64)}, f"face run D: checkpoint head {heads}")
    # one process resumes the two ranks' last checkpoint for one more epoch
    more = tmp / "face_two_ranks_resume.yaml"
    yaml_dump({**cfg, "hyp": {**cfg["hyp"], "epochs": epochs + 1}}, more)
    out_r, train_r, evals_r, _, metrics_r, secs_r, _ = embedding_epochs(project, "--cfgs", str(more), "--resume")
    resumed = int(re.search(r"resume: last \(epoch (\d+)\)", out_r).group(1))
    print(f"[{tag}] face run D resumed in one process (hyp.epochs {epochs + 1}): from epoch {resumed}, "
          f"{secs_r:.1f} s; epoch {epochs + 1} loss {metrics_r['Train_epoch_loss'][epochs]!r}, pair mean "
          f"{metrics_r['Val_mean'][epochs]!r}")
    check(resumed == epochs and math.isfinite(metrics_r["Train_epoch_loss"][epochs]), "face run D's resume failed")
    check(train_r == [only({stash: SWIN.depth * steps, bwd_p: SWIN.depth * steps})]
          and evals_r == [only({fwd: SWIN.depth * face_batches})],
          f"face run D's resume launches {train_r} {evals_r}")
    shutil.rmtree(project)
    return [*train_r, *evals_r]


def compare_embedding_runs(a: dict, b: dict, epochs, fit: str, fit_step: float) -> tuple:
    """Largest per-epoch train-loss difference (relative) and fitness
    difference (in steps of ``fit_step``: a pair a fold, a query) of two
    runs over ``epochs``, and whether all of it is bit-identical."""
    loss = max(abs(a["Train_epoch_loss"][e] - b["Train_epoch_loss"][e]) / abs(a["Train_epoch_loss"][e]) for e in epochs)
    fitness = max(abs(a[fit][e] - b[fit][e]) / fit_step for e in epochs)
    same = all(a[t][e] == b[t][e] for t in a if t == "Train_epoch_loss" or t.startswith("Val_") for e in epochs)
    return loss, fitness, same


def start_synth_face() -> tuple:
    """A temporary directory and the benchmarks/make_synth_face.py process
    (its defaults but FACE_SYNTH_N_TRAIN train images an id) writing face/
    and cbir/ into it: (dir, process, start)."""
    tmp = Path(tempfile.mkdtemp(prefix="vdk_embedding_run_"))
    proc = subprocess.Popen([sys.executable, str(PET_SYNTH_YAML.parents[2] / "benchmarks" / "make_synth_face.py"),
                             "--root", str(tmp / "face"), "--cbir-root", str(tmp / "cbir"),
                             "--n-train", str(FACE_SYNTH_N_TRAIN)])
    return tmp, proc, time.perf_counter()


def phase_embedding_run(dev: torch.device, data=None) -> dict:
    """The face and CBIR run loops through the port's CLIs on Swin-B (see the
    module doc), on ``data`` (``start_synth_face()``'s, started early so that
    it overlaps the phases before) or data made now; returns the K2 family's
    launches of the in-process runs."""
    from visiondk_tpu_torch.config import yaml_dump, yaml_load
    from visiondk_tpu_torch.engine import cbir_eval as cbir_eval_mod
    from visiondk_tpu_torch.engine.face_eval import process_pair_txt

    tag = "embedding run"
    fwd, stash, bwd_p, _ = wattn.KERNELS
    depth = SWIN.depth
    os.environ.pop("VDK_ATTN_NO_PCACHE", None)
    tmp, proc, t0 = data or start_synth_face()
    try:
        waited = time.perf_counter()
        check(proc.wait(timeout=EMBED_RUN_TIMEOUT_S) == 0, f"make_synth_face.py exited with {proc.returncode}")
        print(f"[{tag}] benchmarks/make_synth_face.py with its defaults but --n-train {FACE_SYNTH_N_TRAIN} (64 ids x "
              f"{FACE_SYNTH_N_TRAIN} train, 4 val, 300 pairs; the "
              f"CBIR twin): done {time.perf_counter() - t0:.1f} s after its start, "
              f"{time.perf_counter() - waited:.1f} s of it waited for here")
        totals = {k: 0 for k in KERNELS}

        def add(*runs):
            for run in runs:
                for counts in run:
                    for k in KERNELS:
                        totals[k] += counts[k]

        def configure(path: Path, root: Path, name: str) -> tuple:
            cfg = yaml_load(path)
            was = cfg["hyp"]["epochs"]
            cfg["data"]["root"] = str(root)
            if cfg["model"]["task"] == "face":
                cfg["data"]["val"]["pair_txt"] = str(root / "pairs.txt")
            cfg["hyp"]["epochs"] = EMBED_RUN_EPOCHS
            out = tmp / f"{name}.yaml"
            yaml_dump(cfg, out)
            n_train = sum(1 for _ in (root / "train").rglob("*.jpg"))
            bs, val_bs = cfg["data"]["train"]["bs"], cfg["data"]["val"]["bs"]
            print(f"[{tag}] {path.parent.name}/{path.name} as written with these cuts: data.root "
                  f"{root.name}{' (and its pair file)' if cfg['model']['task'] == 'face' else ''}, hyp.epochs {EMBED_RUN_EPOCHS} (was {was}); everything else as "
                  f"written ({next(iter(cfg['model']['backbone']))}, feat_dim 128, ArcFace over "
                  f"{next(iter(cfg['model']['head'].values()))['num_class']} classes, bs {bs}, val bs {val_bs}, "
                  f"bf16; {n_train} train images: {n_train // bs} steps an epoch)")
            return cfg, out, n_train // bs, val_bs

        def check_launches(label, train, evals, steps, eval_batches):
            for e, (tr, ev) in enumerate(zip(train, evals)):
                check(tr == only({stash: depth * steps, bwd_p: depth * steps}),
                      f"{label} epoch {e} training launches {[(NAMES[k], v) for k, v in tr.items()]}")
                check(ev == only({fwd: depth * eval_batches}),
                      f"{label} epoch {e} evaluation launches {[(NAMES[k], v) for k, v in ev.items()]}")

        def summary(label, train, evals, stage, metrics, secs, nbytes, fit):
            losses = metrics["Train_epoch_loss"]
            rates = metrics["Train_images_per_sec"]
            print(f"[{tag}] {label}: {secs:.1f} s; per epoch: train loss "
                  + ", ".join(f"{losses[e]!r}" for e in sorted(losses)) + f"; {fit} "
                  + ", ".join(f"{metrics[fit][e]!r}" for e in sorted(metrics[fit]))
                  + "; trainer-fed images/s " + ", ".join(f"{rates[e]:.1f}" for e in sorted(rates))
                  + f"; device-augment stage calls {' / '.join(map(str, stage))}; launches per epoch: "
                  f"{NAMES[stash]} {train[0][stash]} and {NAMES[bwd_p]} {train[0][bwd_p]} in training, "
                  f"{NAMES[fwd]} {evals[0][fwd]} in the evaluation, no other attention kernel; checkpoint bytes "
                  f"written {nbytes / 1e9:.2f} GB")

        # ---- face: runs A and B, run C killed and resumed, validate on A's best
        cfg, face_yaml, steps, val_bs = configure(FACE_SYNTH_YAML, tmp / "face", "face_synth_run")
        unique, _, pairs = process_pair_txt(str(tmp / "face" / "pairs.txt"), str(tmp / "face"))
        face_batches, per_fold = -(-len(unique) // val_bs), len(pairs) // 10
        want_stage = [steps] * EMBED_RUN_EPOCHS
        face_args = ["--cfgs", str(face_yaml)]
        out_a, train_a, evals_a, stage_a, metrics_a, secs_a, bytes_a = embedding_epochs(tmp / "A", *face_args)
        split = re.search(r"device augment split — (.*)", out_a)
        check(split is not None, "face run A logged no device augment split")
        print(f"[{tag}] face run A's trainer logged: device augment split — {split.group(1)}")
        check(stage_a == want_stage, f"face run A's device-augment stage calls by epoch {stage_a}, want {want_stage}")
        check_launches("face run A", train_a, evals_a, steps, face_batches)
        for e in range(EMBED_RUN_EPOCHS):
            check(math.isfinite(metrics_a["Train_epoch_loss"][e]) and 0 <= metrics_a["Val_mean"][e] <= 1,
                  f"face run A epoch {e}: metrics {[(t, v.get(e)) for t, v in metrics_a.items()]}")
        summary("face run A", train_a, evals_a, stage_a, metrics_a, secs_a, bytes_a, "Val_mean")

        # face run B through torchrun, a subprocess beside run C's first process and run D (two gloo ranks)
        run_b = start_torchrun(face_args, tmp / "B")
        run_d = start_face_two_ranks(tmp, face_yaml)
        run_c = tmp / "C"
        try:
            try:
                killed_in_epoch_1(face_args, run_c)
                secs_b = finish_torchrun(run_b, timeout=EMBED_RUN_TIMEOUT_S)
            except BaseException:
                stop_torchrun(run_b)
                raise
            metrics_b = read_metrics(tmp / "B")
            loss_d, fit_d, same = compare_embedding_runs(metrics_a, metrics_b, range(EMBED_RUN_EPOCHS), "Val_mean",
                                                         1 / per_fold)
            print(f"[{tag}] face run B (python -m torch.distributed.run --nproc_per_node 1 -m visiondk_tpu_torch.main "
                  f"--multihost: one NCCL rank, DDP; {secs_b:.1f} s, beside run C's first process and run D) vs run A, "
                  f"epochs 1-{EMBED_RUN_EPOCHS}: largest train-loss difference {loss_d:.3e} relative, largest pair-mean "
                  f"difference {fit_d:.2f} pairs a fold; bit-identical: {same} (required)")
            check(same, "face run B through torchrun (one NCCL rank) is not bit-identical to run A")
            shutil.rmtree(tmp / "B")

            done = sorted(read_metrics(run_c).get("Train_epoch_loss", {}))
            out_c, train_c, evals_c, stage_c, metrics_c, _, _ = embedding_epochs(run_c, *face_args, "--resume")
            resumed = int(re.search(r"resume: last \(epoch (\d+)\)", out_c).group(1))
            check(resumed == 1,
                  f"face run C resumed from epoch {resumed}, not 1 (epochs logged before the kill: {done})")
            check(stage_c == want_stage[resumed:], f"resumed face run C's stage calls {stage_c}")
            check_launches("resumed face run C", train_c, evals_c, steps, face_batches)
            loss_d, fit_d, same = compare_embedding_runs(metrics_a, metrics_c, range(resumed, EMBED_RUN_EPOCHS),
                                                         "Val_mean", 1 / per_fold)
            print(f"[{tag}] face run C: SIGKILL in epoch 1 (epochs logged before the kill: {done}), --resume from "
                  f"epoch {resumed}; epochs {resumed + 1}-{EMBED_RUN_EPOCHS} vs run A: train loss {loss_d:.3e} "
                  f"relative, pair mean {fit_d:.2f} pairs a fold; bit-identical: {same} (required); device-augment "
                  f"stage calls {' / '.join(map(str, stage_c))}")
            check(same, "the resumed face run C is not bit-identical to run A")
            add(train_c, evals_c)
            shutil.rmtree(run_c)
            add(face_two_ranks(tmp, cfg, face_yaml, steps, face_batches, run_d))
        except BaseException:
            stop_torchrun(run_d)
            raise

        best = json.loads((tmp / "A" / "best" / "meta.json").read_text())
        fitness = json.loads((tmp / "A" / f"Epoch_{best['epoch'] + 1}" / "meta.json").read_text())["fitness"]
        out_v, _, _, _, _, _, _ = embedding_epochs(tmp / "A", module="visiondk_tpu_torch.validate", argv=[
            "--cfgs", str(tmp / "A" / "config.yaml"), "--weight", str(tmp / "A" / "best"), "--ema"])
        counts_v = read_counts()
        printed = re.search(r"^(\{'mean'.*\})$", out_v, re.M).group(1)
        print(f"[{tag}] validate --ema on face run A's best (epoch {best['epoch'] + 1}): {printed}; run A logged "
              f"{fitness}, best_fitness {best['best_fitness']!r}; {NAMES[fwd]} launched {counts_v[fwd]}")
        check(printed == str(fitness) and fitness["mean"] == best["best_fitness"],
              "validate does not reproduce face run A's best")
        check(counts_v == only({fwd: depth * face_batches}),
              f"validate launches {[(NAMES[k], v) for k, v in counts_v.items()]}")
        add(train_a, evals_a, [counts_v])
        shutil.rmtree(tmp / "A")

        # ---- CBIR: one run, then validate and cbir_eval on its best
        cfg, cbir_yaml, steps, val_bs = configure(CBIR_SYNTH_YAML, tmp / "cbir", "cbir_synth_run")
        n_query = sum(1 for _ in (tmp / "cbir" / "query").rglob("*.jpg"))
        n_gallery = sum(1 for _ in (tmp / "cbir" / "gallery").rglob("*.jpg"))
        cbir_batches = -(-n_query // val_bs) + -(-n_gallery // val_bs)
        out_r, train_r, evals_r, stage_r, metrics_r, secs_r, bytes_r = embedding_epochs(
            tmp / "R", "--cfgs", str(cbir_yaml))
        check(stage_r == [steps] * EMBED_RUN_EPOCHS, f"CBIR run's device-augment stage calls {stage_r}")
        check_launches("CBIR run", train_r, evals_r, steps, cbir_batches)
        split = re.search(r"device augment split — (.*)", out_r)
        print(f"[{tag}] CBIR run's trainer logged: device augment split — {split.group(1)}")
        summary("CBIR run", train_r, evals_r, stage_r, metrics_r, secs_r, bytes_r, "Val_MRR@1")
        best = json.loads((tmp / "R" / "best" / "meta.json").read_text())
        fitness = json.loads((tmp / "R" / f"Epoch_{best['epoch'] + 1}" / "meta.json").read_text())["fitness"]
        weight = ["--cfgs", str(tmp / "R" / "config.yaml"), "--weight", str(tmp / "R" / "best"), "--ema"]
        out_v, _, _, _, _, _, _ = embedding_epochs(tmp / "R", module="visiondk_tpu_torch.validate", argv=weight)
        counts_v = read_counts()
        printed_v = re.search(r"^(\{'MRR@1'.*\})$", out_v, re.M).group(1)

        # cbir_eval, with the evaluation's split: embed forwards against the product and top-k
        timed = {"embed forwards": 0.0, "product + top-k": 0.0}
        extract, search = cbir_eval_mod._extract, retrieval.search

        def timer(what, fn):
            def run(*args, **kwargs):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                timed[what] += time.perf_counter() - t
                return out
            return run

        cbir_eval_mod._extract = timer("embed forwards", extract)
        retrieval.search = timer("product + top-k", search)
        try:
            out_e, _, _, _, _, _, _ = embedding_epochs(tmp / "R", module="visiondk_tpu_torch.cbir_eval", argv=weight)
        finally:
            cbir_eval_mod._extract, retrieval.search = extract, search
        counts_e = read_counts()
        printed_e = dict(re.findall(r"^(\S+@\d+): (\S+)$", out_e, re.M))
        print(f"[{tag}] on the CBIR run's best (epoch {best['epoch'] + 1}): validate --ema {printed_v}; cbir_eval "
              f"--ema {printed_e}; the run logged {fitness}; {NAMES[fwd]} launched {counts_v[fwd]} and "
              f"{counts_e[fwd]}; cbir_eval's evaluation ({n_query} queries, {n_gallery} gallery images, bs {val_bs}): "
              f"embed forwards {timed['embed forwards'] * 1e3:.1f} ms, product + top-k "
              f"{timed['product + top-k'] * 1e3:.1f} ms (host clock, synchronised)")
        check(printed_v == str(fitness) and printed_e == {k: str(v) for k, v in fitness.items()}
              and fitness["MRR@1"] == best["best_fitness"], "validate / cbir_eval do not reproduce the CBIR run's best")
        for label, counts in (("validate", counts_v), ("cbir_eval", counts_e)):
            check(counts == only({fwd: depth * cbir_batches}),
                  f"{label} launches {[(NAMES[k], v) for k, v in counts.items()]}")
        add(train_r, evals_r, [counts_v, counts_e], cbir_serving(tmp, weight, printed_e, cbir_batches, depth, fwd, dev))
        return totals
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


VIS_QUERIES = 4  # queries visualize draws a retrieval grid for on the CBIR run's best
CBIR_CUTOFFS = (1, 3, 5)  # cbir_eval's default --cutoffs: its search takes the top max(cutoffs)


def cbir_serving(tmp: Path, weight: list, printed_bf16: dict, cbir_batches: int, depth: int, fwd,
                 dev: torch.device) -> list:
    """Phases Q8 and CAM's CBIR CLIs on the embedding run's CBIR checkpoint:
    ``cbir_eval --quant int8`` (its metrics printed beside the bf16
    cbir_eval's), then ``visualize`` over the first VIS_QUERIES queries
    (``--root``: a folder of links) against the whole gallery, one grid a
    query. Returns their launches."""
    from PIL import Image

    tag = "embedding run"
    reset_counts()
    t = time.perf_counter()
    out_q = run_cli("visiondk_tpu_torch.cbir_eval", weight + ["--quant", "int8"])
    counts_q = read_counts()
    printed_q = dict(re.findall(r"^(\S+@\d+): (\S+)$", out_q, re.M))
    print(f"[{tag}] cbir_eval --ema --quant int8 on the CBIR run's best ({time.perf_counter() - t:.1f} s with the "
          f"model build): " + ", ".join(f"{k} {v} (bf16 {printed_bf16.get(k)})" for k, v in printed_q.items()))
    check(counts_q == only({fwd: depth * cbir_batches}) and set(printed_q) == set(printed_bf16)
          and all(math.isfinite(float(v)) for v in printed_q.values()),
          f"cbir_eval --quant int8: launches {[(NAMES[k], v) for k, v in counts_q.items()]}, metrics {printed_q}")

    sub = tmp / "cbir_vis"
    (sub / "query").mkdir(parents=True)
    queries = sorted((tmp / "cbir" / "query").iterdir())[:VIS_QUERIES]
    for d in queries:
        os.symlink(d, sub / "query" / d.name)
    os.symlink(tmp / "cbir" / "gallery", sub / "gallery")
    n_query = sum(1 for d in queries for _ in d.glob("*.jpg"))
    n_gallery = sum(1 for _ in (tmp / "cbir" / "gallery").rglob("*.jpg"))
    reset_counts()
    t = time.perf_counter()
    run_cli("visiondk_tpu_torch.visualize", weight + ["--root", str(sub), "--max_rank", "5",
                                                      "--show_path", str(tmp / "cbir_grids")])
    counts_g = read_counts()
    grids = sorted((tmp / "cbir_grids" / "exp").glob("*.jpg"))
    print(f"[{tag}] visualize --ema --root <{len(queries)} query ids, the whole gallery> --max_rank 5 on the CBIR "
          f"run's best: {len(grids)} grids for {n_query} queries against {n_gallery} gallery images "
          f"({time.perf_counter() - t:.1f} s with the model build); {NAMES[fwd]} launched {counts_g[fwd]}")
    check(len(grids) == n_query and all(Image.open(g).size == (300 * 6, 1200) for g in grids),  # 18 x 12 in
          f"visualize wrote {len(grids)} grids for {n_query} queries")
    check(counts_g[fwd] > 0 and all(v == 0 for k, v in counts_g.items() if k is not fwd),
          f"visualize (CBIR) launches {[(NAMES[k], v) for k, v in counts_g.items()]}")

    # phase EX: the embedding program, and approximate search through cbir_eval
    from visiondk_tpu_torch.tools.exported_predict import program_input

    program, _, _ = export_cli(tag, tmp, weight, "swin_cbir", ["--embed"])
    served, cp = restore_served(weight, dev)
    counts_x, timing = hold_program(tag, "the embedding program (export --ema --embed)", program,
                            make_embed_step(served, cp.step_config()),
                            True, fwd, depth, int(program_input(program).shape[1]), dev)
    reset_counts()
    out_r = run_cli("visiondk_tpu_torch.cbir_eval", weight + ["--recall_target", "0.95"])
    counts_r = read_counts()
    printed_r = dict(re.findall(r"^(\S+@\d+): (\S+)$", out_r, re.M))
    bins = retrieval.approx_reduction_size(n_gallery, max(CBIR_CUTOFFS), 0.95)
    print(f"[{tag}] cbir_eval --ema --recall_target 0.95 on the CBIR run's best ({n_gallery} gallery images in "
          f"{bins} bins: M = G, nothing to reduce): {printed_r}; equal to the exact cbir_eval's: "
          f"{printed_r == printed_bf16}")
    check(bins == n_gallery and printed_r == printed_bf16 and counts_r == only({fwd: depth * cbir_batches}),
          f"cbir_eval --recall_target 0.95: metrics {printed_r}, launches {counts_r}")
    timing()
    return [counts_q, counts_g, counts_x, counts_r]


# ---------------------------------------------------------------- CNNs, determinism, multi-label run, distillation

MULTILABEL_YAML = PET_SYNTH_YAML.parent / "multilabel_csv.yaml"
DISTILL_YAML = PET_SYNTH_YAML.parent / "distill_example.yaml"
PET_YAML = PET_SYNTH_YAML.parent / "pet.yaml"
# (tag, the `model:` section, train bs, loss, hyp.epochs): multilabel_csv.yaml's resnet50 (3 classes,
# BCE) and distill_example.yaml's student resnet18 (35 classes, CE); their other optimizer fields are
# pet_synth's
CNN_RECIPES = (
    ("resnet50", {"task": "classification", "name": "resnet50", "image_size": 224, "num_classes": 3,
                  "kwargs": {}, "pretrained": False}, 64, "bce", 20),
    ("resnet18", {"task": "classification", "name": "resnet18", "image_size": 224, "num_classes": 35,
                  "kwargs": {}, "pretrained": False}, 128, "ce", 30),
) + tuple(
    # the other CNN families of pet.yaml's model list as its `model:` section would name them (35
    # classes, CE, 224²), with pet_synth's optimizer fields; tf_efficientnetv2_s is the TF 'SAME' path
    (name, {"task": "classification", "name": name, "image_size": 224, "num_classes": 35, "kwargs": {},
            "pretrained": False}, bs, "ce", PET_SYNTH_HYP["epochs"])
    for name, bs in (("convnext_base", 64), ("mobilenetv3_large_100", 128), ("efficientnetv2_s", 64),
                     ("tf_efficientnetv2_s", 64))
)
# the rows whose train rate is also taken with torch's default cuDNN algorithms, and the rows profiled
CNN_DETERMINISM_AB = ("resnet50",)  # resnet18 and convnext_base too until PR 16 (time)
# (until PR 16 also mobilenetv3_large_100, efficientnetv2_s and tf_efficientnetv2_s: cut for the script's time)
CNN_PROFILED = ("resnet50", "convnext_base")
# the rows of phase DT beside resnet50: one step each of a 7×7 and of a 3×3 / 5×5 depthwise family
CNN_PROBED = ("convnext_base", "mobilenetv3_large_100")
# the rows whose card-vs-CPU step is also printed in f32 (the float64 step is held for every row)
CNN_F32_PRINTED = ()  # ("resnet50", "resnet18") until PR 16: cut for the script's time
CNN_F32_BATCH = 2  # the CPU float64 steps of six CNNs (and resnet18's SAM step) set much of phase CN's time
CNN_TENSOR_TOL = 1e-3  # card against CPU, max |diff| over a tensor relative to its largest |CPU| entry
# device-time classes of a CNN step, by kernel name (lower case), first match wins
CNN_KERNEL_CLASSES = (
    ("layout transposes", ("nchwtonhwc", "nhwctonchw")),
    ("convolutions", ("conv", "fprop", "dgrad", "wgrad", "xmma", "gemm", "cutlass", "nvjet", "implicit")),
    ("BatchNorm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "welford")),
    ("SGD + clip + EMA (foreach)", ("multi_tensor", "foreach")),
    ("copies, casts and other transposes", ("copy", "cast", "memcpy", "memset", "transpose")),
    ("pooling", ("pool",)),
    ("reductions", ("reduce", "softmax", "norm")),
    ("other elementwise", ("",)),
)
NO_ATTENTION = ("cnn", lambda m: None)


@contextlib.contextmanager
def cudnn_mode(deterministic: bool):
    """cuDNN's deterministic algorithms without the autotuner (the trainer's
    setting), or torch's defaults (no autotuner, any algorithm)."""
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def cnn_batch(model_cfg: dict, loss: str, bs: int, dev, seed: int) -> dict:
    """Seeded uint8 224² images with multi-hot (BCE) or int (CE) labels."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = model_cfg["num_classes"]
    label = ((torch.rand(bs, n, generator=gen, device=dev) < 0.5).float() if loss == "bce"
             else torch.randint(0, n, (bs,), generator=gen, device=dev))
    return {"image": torch.randint(0, 256, (bs, IMG, IMG, 3), generator=gen, device=dev, dtype=torch.uint8),
            "label": label}


def cnn_trainer(model_cfg: dict, loss: str, epochs: int, dtype: torch.dtype, dev, float64: bool = False,
                model=None, step_cfg=None):
    """The CNN (seed 0, or ``model``), its optimizer, train state and step:
    the config's SGD + clip + EMA, BCE or CE with label smoothing 0.05
    (``step_cfg``: StepConfig() unless given). With ``float64`` the
    parameters, buffers, every layer and the loss compute in float64."""
    if model is None:
        model = get_model(model_cfg, dtype=dtype, device=dev, generator=torch.Generator().manual_seed(0))
    if float64:
        model.double()
        for m in model.modules():
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = torch.float64
    tx = build_tx({**PET_SYNTH_HYP, "epochs": epochs}, STEPS_PER_EPOCH, discrete_per_epoch=True,
                  model_cfg=model_cfg)
    state = create_train_state(model, tx)
    step = make_train_step(model, tx, cnn_loss(loss, float64), step_cfg or StepConfig(),
                           torch.Generator().manual_seed(1))
    return model, tx, state, step


def cnn_loss(loss: str, float64: bool = False):
    """BCE, or CE with label smoothing 0.05: the port's (f32), or torch's in the logits' dtype."""
    if float64:
        if loss == "bce":
            return lambda logits, y: F.binary_cross_entropy_with_logits(logits, y.to(logits.dtype))
        return lambda logits, y: F.cross_entropy(logits, y.long(), label_smoothing=LABEL_SMOOTH)
    return create_lossfn("bce") if loss == "bce" else create_lossfn("ce", label_smooth=LABEL_SMOOTH)


def distill_trainer(dev, dtype: torch.dtype, teacher_seed: int, bs=None, fused: bool = True):
    """distill_example.yaml's step on a synthetic batch: the resnet18
    student (seed 0) and a Swin-B teacher (pet.yaml's model, seed
    ``teacher_seed``, on K2 or with ``fused`` off the plain window
    attention), CE with label smoothing 0.05 + KL at T 4, weights 0.5 / 0.5.
    Returns (step, state, batch, teacher)."""
    from visiondk_tpu_torch.engine.distill import make_distill_step

    _, student_cfg, train_bs, loss, epochs = CNN_RECIPES[1]
    student, tx, state, _ = cnn_trainer(student_cfg, loss, epochs, dtype, dev)
    teacher = get_model(PET_MODEL, dtype=dtype, device=dev, generator=torch.Generator().manual_seed(teacher_seed))
    set_fused(teacher.requires_grad_(False), fused)
    step = make_distill_step(student, teacher, tx, cnn_loss(loss), StepConfig(), torch.Generator().manual_seed(1),
                             cls_weight=0.5, kl_weight=0.5, temperature=4.0)
    return step, state, cnn_batch(student_cfg, loss, bs or train_bs, dev, seed=5), teacher


def nondeterministic_ops(fn) -> list:
    """The ops that ``torch.use_deterministic_algorithms(True,
    warn_only=True)`` names in one call of ``fn``."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    texts = {str(w.message) for w in caught if "deterministic" in str(w.message)}
    return sorted(t.split(" does not have a deterministic")[0].strip()[:160] for t in texts)


def unequal_gradients(model: torch.nn.Module, loss_fn) -> list:
    """The parameters whose gradients differ between two backward passes of
    ``loss_fn()`` from the same weights and batch (the same seed for
    dropout and DropPath), outside deterministic mode."""
    grads = []
    for _ in range(2):
        for p in model.parameters():
            p.grad = None
        with torch.random.fork_rng(devices=[torch.cuda.current_device()]):
            torch.manual_seed(0)
            loss_fn().backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None})
    return sorted(n for n in grads[0] if not torch.equal(grads[0][n], grads[1][n]))


def determinism_probe() -> None:
    """``--determinism-probe``: one bf16 train step each of face_synth's
    Swin-B embedding model (with the fixed-order bias gather, and with
    ``index_select``'s, the state before the repair), multilabel_csv's
    resnet50 (deterministic cuDNN, and torch's defaults) and the
    distillation step (resnet18 student, Swin-B teacher): the ops that
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` names, and
    the parameters whose gradients differ between two backward passes from
    the same weights and batch. Run as a subprocess with
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (phase CN)."""
    from visiondk_tpu_torch.config import yaml_load
    from visiondk_tpu_torch.losses.losses import distill_kl
    from visiondk_tpu_torch.models.backbones import swin

    phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    check(os.environ.get("CUBLAS_WORKSPACE_CONFIG") == ":4096:8", "the probe needs CUBLAS_WORKSPACE_CONFIG=:4096:8")
    found = {}

    def probe(label, model, step, loss_fn, deterministic=True):
        with cudnn_mode(deterministic):
            ops = nondeterministic_ops(step)
            found[label] = {"ops": ops, "unequal_gradients": unequal_gradients(model, loss_fn)}

    cfg = yaml_load(FACE_SYNTH_YAML)
    model_cfg, bs = cfg["model"], cfg["data"]["train"]["bs"]
    classes = next(iter(model_cfg["head"].values()))["num_class"]
    model = get_model(model_cfg, dtype=torch.bfloat16, device=dev, generator=torch.Generator().manual_seed(0))
    tx = build_tx(cfg["hyp"], 20, discrete_per_epoch=False, model_cfg=model_cfg)
    lossfn = create_lossfn("ce", valid_class=classes)
    step = make_train_step(model, tx, lossfn, StepConfig(task="embedding"), torch.Generator().manual_seed(1))
    state = create_train_state(model, tx)
    gen = torch.Generator(device=dev).manual_seed(8)
    batch = {"image": torch.randint(0, 256, (bs, IMG, IMG, 3), generator=gen, device=dev, dtype=torch.uint8),
             "label": torch.randint(0, classes, (bs,), generator=gen, device=dev)}
    images = batch["image"].float() / 255.0

    def face_loss():
        logits, aux = model(images, batch["label"])
        return lossfn(logits, batch["label"]) + aux

    swin.BiasGather.apply = staticmethod(lambda table, idx, readers: table.index_select(0, idx))
    try:
        probe("face_synth Swin-B embedding step, index_select gather (before the repair)", model,
              lambda: step(state, batch), face_loss)
    finally:
        del swin.BiasGather.apply  # back to torch.autograd.Function.apply
    probe("face_synth Swin-B embedding step", model, lambda: step(state, batch), face_loss)
    del model, state, step
    torch.cuda.empty_cache()

    tag, model_cfg, bs, loss, epochs = CNN_RECIPES[0]
    model, _, state, step = cnn_trainer(model_cfg, loss, epochs, torch.bfloat16, dev)
    batch = cnn_batch(model_cfg, loss, bs, dev, seed=4)
    images = batch["image"].float() / 255.0
    for det in (True, False):
        probe(f"multilabel_csv {tag} step, cuDNN {'deterministic' if det else 'defaults'}", model,
              lambda: step(state, batch), lambda: cnn_loss(loss)(model(images), batch["label"]), det)
    del model, state, step
    torch.cuda.empty_cache()

    for tag, model_cfg, bs, loss, epochs in (r for r in CNN_RECIPES if r[0] in CNN_PROBED):
        model, _, state, step = cnn_trainer(model_cfg, loss, epochs, torch.bfloat16, dev)
        batch = cnn_batch(model_cfg, loss, bs, dev, seed=4)
        images = batch["image"].float() / 255.0
        probe(f"{tag} step (depthwise convolutions), cuDNN deterministic", model, lambda: step(state, batch),
              lambda: cnn_loss(loss)(model(images), batch["label"]))
        del model, state, step
        torch.cuda.empty_cache()

    step, state, batch, teacher = distill_trainer(dev, torch.bfloat16, teacher_seed=2)
    images = batch["image"].float() / 255.0
    with torch.no_grad():
        t_logits = teacher.eval()(images)

    def distill_loss():
        s_logits = state.model(images)
        return 0.5 * cnn_loss("ce")(s_logits, batch["label"]) + 0.5 * distill_kl(s_logits, t_logits, 4.0)

    probe("distill step (resnet18 student, Swin-B teacher)", state.model, lambda: step(state, batch), distill_loss)
    for label, res in found.items():
        print(f"[determinism] {label}: ops named {'; '.join(res['ops']) if res['ops'] else 'none'}; gradients "
              f"unequal between two identical backward passes: "
              + (", ".join(res["unequal_gradients"][:6]) + (f" ... ({len(res['unequal_gradients'])})"
                 if len(res["unequal_gradients"]) > 6 else "") if res["unequal_gradients"] else "none"))
    print("DETERMINISM " + json.dumps(found))


def start_determinism_probe() -> tuple:
    """``determinism_probe`` in a subprocess with
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (cuBLAS reads it at its first use,
    and this process's cuBLAS keeps its default workspace), started in the
    background: it overlaps phases that check no timing (the multi-label run
    and distillation). Returns what ``finish_determinism_probe`` takes."""
    out = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--determinism-probe"],
                            env={**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}, stdout=out,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out, time.perf_counter()


def finish_determinism_probe(probe: tuple) -> dict:
    """Waits for the probe, prints its findings and checks that the repaired
    steps name no op. Returns its findings."""
    proc, out, t0 = probe
    try:
        proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out.seek(0)
    stdout = out.read()
    out.close()
    lines = [ln for ln in stdout.splitlines() if ln.startswith("[determinism]")]
    print("\n".join(lines))
    check(proc.returncode == 0, f"the determinism probe exited with {proc.returncode}: {stdout[-3000:]}")
    found = json.loads(next(ln for ln in stdout.splitlines() if ln.startswith("DETERMINISM "))[12:])
    print(f"[determinism] probe: {time.perf_counter() - t0:.1f} s (a subprocess, beside phases ML and DS)")
    for label, res in found.items():
        if "before the repair" not in label and "defaults" not in label:
            check(not res["ops"] and not res["unequal_gradients"], f"{label}: not deterministic: {res}")
    return found


def cnn_one_step(base: torch.nn.Module, model_cfg: dict, loss: str, epochs: int, batch: dict, device,
                 float64: bool, step_cfg=None) -> tuple:
    """One train step from a copy of ``base`` (the seeded f32 model on the
    CPU): (loss, {gradient, update θ₁ − θ₀, BN statistic: {name: float64
    CPU tensor}}, max |θ₀| by name)."""
    model, _, state, step = cnn_trainer(model_cfg, loss, epochs, torch.float32, device, float64=float64,
                                        model=copy.deepcopy(base).to(device), step_cfg=step_cfg)
    theta0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    if float64:  # the same float64 pixels on both devices: the step then normalises them in float64
        batch = {**batch, "image": batch["image"].cpu().double() / 255.0}
    value = step(state, {k: v.to(device) for k, v in batch.items()})["loss"].item()
    tensors = {
        "gradient": {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()},
        "update": {n: (p.detach() - theta0[n]).double().cpu() for n, p in model.named_parameters()},
        "BN statistic": {n: b.detach().double().cpu() for n, b in model.named_buffers() if n.endswith(("mean", "var"))},
    }
    return value, tensors, {n: t.abs().max().item() for n, t in theta0.items()}


def worst_diffs(side, ref, float32_spacing: bool, floor_share: float = 1e-9) -> tuple:
    """Loss difference (relative) and, per kind of tensor, the largest
    max|side − ref| / max|ref| (an update less one spacing of θ) and where.
    A tensor whose exact value is zero holds rounding noise alone (the
    gradient of a BatchNorm bias that a linear layer and a train-mode
    BatchNorm follow: MobileNetV3's and EfficientNetV2's last block before
    their head convolution; an embedding neck's LayerNorm bias ahead of its
    Linear and BatchNorm1d), so max|ref| is floored at ``floor_share`` of the
    kind's largest entry: 1e-9 against float64; 1e-3 between two f32 runs,
    where that noise is a few f32 spacings of the kind's largest entry (any
    tensor then holds to 1e-6 of it, the CPU tests' floor)."""
    (ls, ts, theta_max), (lr, tr, _) = side, ref
    eps = torch.finfo(torch.float32 if float32_spacing else torch.float64).eps
    worst = {}
    for what, tensors in tr.items():
        floor = floor_share * max((r.abs().max().item() for r in tensors.values()), default=0.0)
        for n, r in tensors.items():
            slack = eps * theta_max[n] if what == "update" else 0.0
            scale = max(r.abs().max().item(), floor, 1e-300)
            ratio = max((ts[what][n] - r).abs().max().item() - slack, 0.0) / scale
            if ratio >= worst.get(what, (-1.0, ""))[0]:
                worst[what] = (ratio, n)
    return abs(ls - lr) / abs(lr), worst


def compare_cnn_with_cpu(tag: str, model_cfg: dict, loss: str, epochs: int, dev, f32: bool = True,
                         step_cfg=None) -> None:
    """One train step on the card (TF32 off) against the same model, batch
    and generator on the CPU, in float64 (model and loss): the loss within
    F32_LOSS_RTOL relative; every gradient, update θ₁ − θ₀ (less one spacing
    of θ) and BN running statistic within CNN_TENSOR_TOL of its tensor's
    largest CPU entry; the float64 pixels are made on the CPU, so both
    sides start from the same bits. The same step in f32 (the port's
    losses, uint8 batch) is printed against the CPU's float64, beside the
    CPU's own f32: at random init the last stage's gradients are so
    ill-conditioned (cancellation in BatchNorm's backward) that f32
    rounding, or one f32 ulp of the normalised input, moves them by up to a
    fifth of their largest entry on either device, so an f32 bar would hold
    no implementation (``f32`` off: the float64 pair alone). Every run starts
    from a copy of one seeded model; ``step_cfg`` is the step's variant
    (StepConfig() unless given)."""
    batch = cnn_batch(model_cfg, loss, CNN_F32_BATCH, dev, seed=6)
    cpu = torch.device("cpu")
    base = get_model(model_cfg, device=cpu, generator=torch.Generator().manual_seed(0))
    sides = (("card f64", dev, True), ("cpu f64", cpu, True)) + (
        (("card f32", dev, False), ("cpu f32", cpu, False)) if f32 else ())
    runs = {key: cnn_one_step(base, model_cfg, loss, epochs, batch, device, f64, step_cfg)
            for key, device, f64 in sides}
    torch.cuda.empty_cache()

    def line(key, ref):
        loss_rel, worst = worst_diffs(runs[key], runs[ref], float32_spacing=key.endswith("f32"))
        return loss_rel, worst, (f"{key} vs {ref}: loss rel {loss_rel:.3e}; worst max|diff|/max|ref| "
                                 + ", ".join(f"{w} {r:.3e} ({n})" for w, (r, n) in worst.items()))

    loss_rel, worst, held = line("card f64", "cpu f64")
    print(f"[cnn] {tag} one step, bs {CNN_F32_BATCH}: {held} (bars {F32_LOSS_RTOL}, {CNN_TENSOR_TOL})"
          + (f"; printed: {line('card f32', 'cpu f64')[2]} | {line('cpu f32', 'cpu f64')[2]}" if f32 else ""))
    check(loss_rel <= F32_LOSS_RTOL, f"{tag}: float64 loss card vs CPU {loss_rel} relative")
    for what, (r, n) in worst.items():
        check(r <= CNN_TENSOR_TOL, f"{tag}: float64 {what} of {n} differs by {r} of its largest entry")


def phase_cnn(dev: torch.device) -> None:
    """The CNN families at full width (see the module doc): resnet50,
    resnet18, convnext_base, mobilenetv3_large_100, efficientnetv2_s and
    tf_efficientnetv2_s, bf16, seeded; no attention kernel may launch."""
    for tag, model_cfg, bs, loss, epochs in CNN_RECIPES:
        t0 = time.perf_counter()
        model, _, state, step = cnn_trainer(model_cfg, loss, epochs, torch.bfloat16, dev)
        eval_step = make_eval_step(model, StepConfig())
        eval_batch = cnn_batch(model_cfg, loss, BATCH, dev, seed=3)
        train_batch = {k: v[:bs] for k, v in cnn_batch(model_cfg, loss, max(bs, BATCH), dev, seed=4).items()}
        reset_counts()
        with cudnn_mode(True):
            losses = [step(state, train_batch)["loss"].item() for _ in range(3)]
            logits = eval_step(eval_batch)
        counts = read_counts()
        check(all(v == 0 for v in counts.values()), f"{tag} launched an attention kernel: {counts}")
        check(all(math.isfinite(x) for x in losses) and bool(torch.isfinite(logits).all())
              and tuple(logits.shape) == (BATCH, model_cfg["num_classes"]), f"{tag}: losses {losses}")
        print(f"[cnn] {tag} ({model_cfg['num_classes']} classes, {loss.upper()}), bf16 compute, f32 parameters, "
              f"channels_last convolutions: 3 train steps at bs {bs}, losses {', '.join(f'{x:.5f}' for x in losses)};"
              f" eval logits {tuple(logits.shape)} finite; no attention kernel launched; {time.perf_counter() - t0:.1f} s")
        rates = [images_per_s(eval_step, eval_batch) for _ in range(2)]
        print(f"[cnn] {tag} eval bs {BATCH} bf16 images/s: {rates[0]:.1f}, {rates[1]:.1f}")
        trials = {True: [], False: []}
        ab = tag in CNN_DETERMINISM_AB
        for trial, det in enumerate((True, False, False, True) if ab else (True, True)):
            with cudnn_mode(det):
                trials[det].append(train_rate(model, state, step, train_batch, NO_ATTENTION,
                                              f"[cnn] {tag} train bf16 bs {bs} trial {trial}, cuDNN "
                                              + ("deterministic (the trainer's)" if det else "defaults")))
        TRAIN_RATES[tag] = [r for r, _ in trials[True]]
        if ab:
            det, free = (sum(r for r, _ in trials[d]) / 2 for d in (True, False))
            print(f"[cnn] {tag} train bf16 bs {bs} images/s: deterministic cuDNN {trials[True][0][0]:.1f}, "
                  f"{trials[True][1][0]:.1f} | torch defaults {trials[False][0][0]:.1f}, {trials[False][1][0]:.1f} "
                  f"(order det, defaults, defaults, det): deterministic costs {1 - det / free:.1%}; "
                  f"max_memory_allocated {trials[True][0][1]:.2f} GiB")
        else:
            print(f"[cnn] {tag} train bf16 bs {bs} images/s, deterministic cuDNN (the trainer's): "
                  f"{trials[True][0][0]:.1f}, {trials[True][1][0]:.1f}; max_memory_allocated "
                  f"{trials[True][0][1]:.2f} GiB")
        if tag in CNN_PROFILED:
            with cudnn_mode(True):
                profile_step(f"{tag} train bf16 (deterministic cuDNN)", lambda: step(state, train_batch), bs,
                             classes=CNN_KERNEL_CLASSES)
        del model, state, step, eval_step
        torch.cuda.empty_cache()
        with cudnn_mode(True):
            compare_cnn_with_cpu(tag, model_cfg, loss, epochs, dev, f32=tag in CNN_F32_PRINTED)
        torch.cuda.empty_cache()


# train JPEGs a class of the V2 and V2L runs, the multi-label run and the distillation runs: the first
# of the run loop's (all 20 until the export phases took their share of the script's time)
CLI_RUN_TRAIN = 10
ML_EPOCHS = 2  # the focal swap from epoch 1 (warm_ep), and an epoch for the resumed run C
ML_COLUMNS = ("bit0", "bit1", "bit2")
ML_TAGS = ("Train_loss", "Val_v_loss", "Val_precision", "Val_recall", "Val_f1score")
DS_EPOCHS = 2


def write_multilabel_csv(root: Path, out: Path) -> tuple:
    """A multi-label CSV (image_path, train, three label columns) over the
    synthetic pet folders: an image of class index c has the labels of the
    three bits of c mod 7 + 1, so at least one is positive; ``train`` is
    True for the train folders, False for the val ones. Returns the row
    counts (train, val)."""
    import csv

    classes = sorted(d.name for d in (root / "train").iterdir() if d.is_dir())
    counts = {"train": 0, "val": 0}
    with open(out, "w", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow(["image_path", "train", *ML_COLUMNS])
        for split in ("train", "val"):
            for ci, name in enumerate(classes):
                bits = ci % 7 + 1
                for f in sorted((root / split / name).glob("*.jpg")):
                    writer.writerow([str(f), str(split == "train"), *(str((bits >> j) & 1) for j in range(3))])
                    counts[split] += 1
    return counts["train"], counts["val"]


def counted_run(project: Path, argv: list, module: str = "visiondk_tpu_torch.main") -> tuple:
    """``python -m module argv`` in this process: (output, launches,
    metrics.jsonl, seconds)."""
    reset_counts()
    t = time.perf_counter()
    out = run_cli(module, argv)
    counts = read_counts()
    metrics = read_metrics(project) if (project / "metrics.jsonl").is_file() else {}
    return out, counts, metrics, time.perf_counter() - t


def same_metrics(a: dict, b: dict, tags, epochs) -> bool:
    return all(a[t][e] == b[t][e] for t in tags for e in epochs)


def phase_multilabel_run(dev: torch.device, pet_data: tuple) -> None:
    """The multi-label run through the port's CLIs on resnet50 (see the
    module doc)."""
    from visiondk_tpu_torch.config import yaml_dump, yaml_load

    tag = "multilabel run"
    tmp = Path(tempfile.mkdtemp(prefix="vdk_multilabel_"))
    try:
        root = subset_root(synth_pet_root(pet_data, tag), tmp / "data", CLI_RUN_TRAIN)
        csv_path = tmp / "synth_multilabel.csv"
        n_train, n_val = write_multilabel_csv(root, csv_path)
        cfg = yaml_load(MULTILABEL_YAML)
        was = cfg["data"]["root"], cfg["hyp"]["epochs"]
        cfg["data"]["root"] = str(csv_path)
        cfg["hyp"]["epochs"] = ML_EPOCHS
        yaml_path = tmp / "multilabel_run.yaml"
        yaml_dump(cfg, yaml_path)
        bs, val_bs = cfg["data"]["train"]["bs"], cfg["data"]["val"]["bs"]
        print(f"[{tag}] configs/classification/multilabel_csv.yaml as written with these cuts: data.root {csv_path.name} "
              f"(was {was[0]}: {n_train} train / {n_val} val rows over the synthetic pet JPEGs, labels {ML_COLUMNS} "
              f"the bits of class index mod 7 + 1; read with the stdlib csv module, pandas is not imported), "
              f"hyp.epochs {ML_EPOCHS} (was {was[1]}); everything else as written ({cfg['model']['name']}, "
              f"{cfg['model']['num_classes']} classes, BCE with threshold {cfg['hyp']['loss']['bce'][1]}, the focal "
              f"swap from warm_ep {cfg['hyp']['warm_ep']}, bs {bs}, val bs {val_bs}, bf16)")
        argv = ["--cfgs", str(yaml_path), "--seed", "0"]
        out_a, counts_a, metrics_a, secs_a = counted_run(tmp / "A", [*argv, "--project", str(tmp / "A")])
        check(all(v == 0 for v in counts_a.values()), f"run A launched an attention kernel: {counts_a}")
        check("pandas" not in sys.modules, "the multi-label run imported pandas")
        for e in range(ML_EPOCHS):
            check(all(math.isfinite(metrics_a[t][e]) for t in ML_TAGS), f"run A epoch {e}: non-finite metrics")
        rates = [metrics_a["Train_images_per_sec"][e] for e in range(ML_EPOCHS)]
        print(f"[{tag}] run A: {secs_a:.1f} s; loaders {re.search(r'loaders: (.*)', out_a).group(1)}; per epoch: "
              + "; ".join(f"train loss {metrics_a['Train_loss'][e]!r}, P/R/F1 {metrics_a['Val_precision'][e]!r} / "
                          f"{metrics_a['Val_recall'][e]!r} / {metrics_a['Val_f1score'][e]!r}" for e in range(ML_EPOCHS))
              + "; trainer-fed images/s by epoch " + ", ".join(f"{r:.1f}" for r in rates)
              + f" (synthetic batch on the card, phase CN: " + ", ".join(f"{r:.1f}" for r in TRAIN_RATES['resnet50'])
              + ")")
        killing_c = start_killed_in_epoch_1(argv[:2], tmp / "C")  # run C's first process, beside run B
        try:
            _, _, metrics_b, _ = counted_run(tmp / "B", [*argv, "--project", str(tmp / "B")])
        finally:
            killing_c.result()
        same = same_metrics(metrics_a, metrics_b, ML_TAGS, range(ML_EPOCHS))
        print(f"[{tag}] run B vs run A, epochs 1-{ML_EPOCHS}: bit-identical {same} (required)")
        check(same, "seeded multi-label runs A and B are not bit-identical")
        shutil.rmtree(tmp / "B")
        done = sorted(read_metrics(tmp / "C").get("Train_loss", {}))
        out_c, counts_c, metrics_c, _ = counted_run(tmp / "C", [*argv, "--project", str(tmp / "C"), "--resume"])
        resumed = int(re.search(r"resume: last \(epoch (\d+)\)", out_c).group(1))
        check(resumed == 1, f"run C resumed from epoch {resumed}, not 1 (epochs logged before the kill: {done})")
        same = same_metrics(metrics_a, metrics_c, ML_TAGS, range(resumed, ML_EPOCHS))
        print(f"[{tag}] run C: SIGKILL in epoch 1 (epochs logged before the kill: {done}), --resume from epoch "
              f"{resumed}; epochs {resumed + 1}-{ML_EPOCHS} bit-identical to run A: {same} (required)")
        check(same, "the resumed multi-label run C is not bit-identical to run A")
        best = json.loads((tmp / "A" / "best" / "meta.json").read_text())["epoch"]
        out_v, _, _, _ = counted_run(tmp / "A", ["--cfgs", str(tmp / "A" / "config.yaml"), "--weight",
                                                 str(tmp / "A" / "best"), "--ema"], module="visiondk_tpu_torch.validate")
        line = re.search(r"^\{'precision'.*$", out_v, re.M).group(0)
        printed = {k: float(v) for k, v in re.findall(r"'(precision|recall|f1score)': ([0-9.e+-]+)", line)}
        logged = {k: metrics_a[f"Val_{k}"][best] for k in ("precision", "recall", "f1score")}
        print(f"[{tag}] validate --ema on run A's best (epoch {best + 1}): {printed}; run A logged {logged}")
        check(printed == logged, "validate does not reproduce run A's best P/R/F1")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def compare_distill_paths(dev: torch.device) -> None:
    """One f32 distillation step (bs CNN_F32_BATCH) with the teacher on K2
    against the teacher on the plain window attention, from the same
    weights: phase 5's bars on the loss and on every student gradient and
    update."""
    sides = []
    for fused in (True, False):
        step, state, batch, _ = distill_trainer(dev, torch.float32, teacher_seed=2, bs=CNN_F32_BATCH, fused=fused)
        theta0 = {n: p.detach().clone() for n, p in state.model.named_parameters()}
        out = step(state, batch)
        sides.append(({k: v.item() for k, v in out.items()},
                      {n: p.grad.detach().clone() for n, p in state.model.named_parameters()},
                      {n: p.detach() - theta0[n] for n, p in state.model.named_parameters()},
                      {n: torch.finfo(torch.float32).eps * p.detach().abs().max().item()
                       for n, p in state.model.named_parameters()}))
        del step, state
        torch.cuda.empty_cache()
    (mk, gk, uk, _), (mp, gp, up, spacing) = sides
    loss_rel = abs(mk["loss"] - mp["loss"]) / abs(mp["loss"])
    worst = {}
    for what, a, b in (("gradient", gk, gp), ("update", uk, up)):
        for n in b:
            slack = spacing[n] if what == "update" else 0.0
            r = max((a[n] - b[n]).abs().max().item() - slack, 0.0) / max(b[n].abs().max().item(), 1e-30)
            if r >= worst.get(what, (-1.0, ""))[0]:
                worst[what] = (r, n)
    print(f"[distill] f32 one distillation step, bs {CNN_F32_BATCH}, teacher on K2 vs the plain window attention: "
          f"loss {mk['loss']:.7f} vs {mp['loss']:.7f} (rel {loss_rel:.3e}, bar {F32_LOSS_RTOL}; KL term "
          f"{mk['loss_kl']:.7f} vs {mp['loss_kl']:.7f}); worst max|diff|/max|plain| "
          + ", ".join(f"{w} {r:.3e} ({n})" for w, (r, n) in worst.items()) + f" (bar {F32_TENSOR_TOL})")
    check(loss_rel <= F32_LOSS_RTOL, f"distill f32 loss differs by {loss_rel} relative")
    for what, (r, n) in worst.items():
        check(r <= F32_TENSOR_TOL, f"distill f32 {what} of {n} differs by {r} of its largest entry")


def phase_distill(dev: torch.device, pet_data: tuple) -> dict:
    """pet.yaml's Swin-B teacher and distill_example.yaml's resnet18 student
    through the port's CLIs (see the module doc); returns the K2 family's
    launches of the in-process runs."""
    from visiondk_tpu_torch.config import yaml_dump, yaml_load

    tag = "distill"
    fwd, stash, bwd_p, _ = wattn.KERNELS
    depth = SWIN.depth
    os.environ.pop("VDK_ATTN_NO_PCACHE", None)
    tmp = Path(tempfile.mkdtemp(prefix="vdk_distill_"))
    try:
        root = subset_root(synth_pet_root(pet_data, tag), tmp / "data", CLI_RUN_TRAIN)
        n_train = sum(1 for _ in (root / "train").rglob("*.jpg"))
        n_val = sum(1 for _ in (root / "val").rglob("*.jpg"))
        tcfg = yaml_load(PET_YAML)
        was = tcfg["data"]["root"], tcfg["hyp"]["epochs"]
        tcfg["data"]["root"], tcfg["hyp"]["epochs"] = str(root), DS_EPOCHS
        teacher_yaml = tmp / "pet_teacher.yaml"
        yaml_dump(tcfg, teacher_yaml)
        bs, val_bs = tcfg["data"]["train"]["bs"], tcfg["data"]["val"]["bs"]
        steps, val_batches = n_train // bs, -(-n_val // val_bs)
        print(f"[{tag}] the teacher: configs/classification/pet.yaml as written with these cuts: data.root the "
              f"synthetic pet folders (was {was[0]}; {n_train} train / {n_val} val JPEGs, {steps} steps of {bs} an "
              f"epoch), hyp.epochs {DS_EPOCHS} (was {was[1]}); everything else as written ({tcfg['model']['name']}, "
              f"bs {bs}, val bs {val_bs}, bf16)")
        totals = {k: 0 for k in KERNELS}
        teacher = {}
        for run in ("A", "B"):
            project = tmp / f"teacher{run}"
            out, counts, metrics, secs = counted_run(project, ["--cfgs", str(teacher_yaml), "--project", str(project),
                                                               "--seed", "0"])
            want = only({stash: depth * steps * DS_EPOCHS, bwd_p: depth * steps * DS_EPOCHS,
                         fwd: depth * val_batches * DS_EPOCHS})
            check(counts == want, f"teacher run {run} launches {[(NAMES[k], v) for k, v in counts.items()]}")
            totals = {k: totals[k] + counts[k] for k in KERNELS}
            teacher[run] = metrics
            print(f"[{tag}] teacher run {run}: {secs:.1f} s; per epoch train loss "
                  + ", ".join(f"{metrics['Train_loss'][e]!r}" for e in range(DS_EPOCHS)) + ", val top1 "
                  + ", ".join(f"{metrics['Val_top1'][e]!r}" for e in range(DS_EPOCHS)) + "; trainer-fed images/s "
                  + ", ".join(f"{metrics['Train_images_per_sec'][e]:.1f}" for e in range(DS_EPOCHS))
                  + f"; launches {NAMES[stash]} {counts[stash]}, {NAMES[bwd_p]} {counts[bwd_p]} (= {depth} x "
                    f"{steps * DS_EPOCHS} steps), {NAMES[fwd]} {counts[fwd]} (= {depth} x {val_batches} val batch x "
                    f"{DS_EPOCHS} epochs), no other attention kernel")
        same = same_metrics(teacher["A"], teacher["B"], ("Train_loss", "Val_top1", "Val_v_loss"), range(DS_EPOCHS))
        print(f"[{tag}] teacher run B vs run A (Swin-B classification): bit-identical {same} (required)")
        check(same, "seeded pet.yaml runs A and B are not bit-identical")

        dcfg = yaml_load(DISTILL_YAML)
        student = dcfg["student"]
        was = student["data"]["root"], student["hyp"]["epochs"], dcfg["teacher"]["weight"]
        student["data"]["root"], student["hyp"]["epochs"] = str(root), DS_EPOCHS
        dcfg["teacher"]["weight"] = str(tmp / "teacherA" / "best")
        distill_yaml = tmp / "distill.yaml"
        yaml_dump(dcfg, distill_yaml)
        sbs = student["data"]["train"]["bs"]
        ssteps = n_train // sbs
        print(f"[{tag}] the student: configs/classification/distill_example.yaml --distill as written with these "
              f"cuts: student data.root the same folders (was {was[0]}; {ssteps} steps of {sbs} an epoch), "
              f"hyp.epochs {DS_EPOCHS} (was {was[1]}), teacher.weight teacher run A's best (was {was[2]}); "
              f"everything else as written ({student['model']['name']} student, "
              f"{dcfg['teacher']['model']['name']} teacher with its EMA weights, {dcfg['distill']}, bf16)")
        runs = {}
        for run in ("A", "B"):
            project = tmp / f"distill{run}"
            out, counts, metrics, secs = counted_run(project, ["--cfgs", str(distill_yaml), "--distill", "--project",
                                                               str(project), "--seed", "0"])
            check("teacher: " in out, f"distill run {run} logged no teacher restore")
            want = only({fwd: depth * ssteps * DS_EPOCHS})
            check(counts == want, f"distill run {run} launches {[(NAMES[k], v) for k, v in counts.items()]}, want "
                                  f"{depth} K2 a step")
            totals = {k: totals[k] + counts[k] for k in KERNELS}
            runs[run] = metrics
            print(f"[{tag}] distill run {run}: {secs:.1f} s; {re.search(r'teacher: (.*)', out).group(1)}; per epoch "
                  f"train loss " + ", ".join(f"{metrics['Train_loss'][e]!r}" for e in range(DS_EPOCHS)) + ", val top1 "
                  + ", ".join(f"{metrics['Val_top1'][e]!r}" for e in range(DS_EPOCHS)) + "; trainer-fed images/s "
                  + ", ".join(f"{metrics['Train_images_per_sec'][e]:.1f}" for e in range(DS_EPOCHS))
                  + f"; launches {NAMES[fwd]} {counts[fwd]} (= {depth} x {ssteps * DS_EPOCHS} student steps), no other "
                    f"attention kernel")
        same = same_metrics(runs["A"], runs["B"], ("Train_loss", "Val_top1", "Val_v_loss"), range(DS_EPOCHS))
        print(f"[{tag}] distill run B vs run A: bit-identical {same} (required)")
        check(same, "seeded distillation runs A and B are not bit-identical")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the distillation step alone on a synthetic batch: launches, images/s, and K2 against the plain path
    step, state, batch, _ = distill_trainer(dev, torch.bfloat16, teacher_seed=2)
    reset_counts()
    out = step(state, batch)
    counts = read_counts()
    check(counts == only({fwd: depth}), f"a distillation step launches {[(NAMES[k], v) for k, v in counts.items()]}")
    check(all(torch.isfinite(v).item() for v in out.values()), f"distillation step: {out}")
    with cudnn_mode(True):
        rate, mem = train_rate(state.model, state, step, batch, NO_ATTENTION,
                               f"[{tag}] distillation step bf16 bs {batch['label'].shape[0]} (resnet18 student + "
                               f"Swin-B teacher forward, {depth} K2 a step)")
    del step, state, batch
    torch.cuda.empty_cache()
    with cudnn_mode(True):
        compare_distill_paths(dev)
    return totals


SV2_EPOCHS = 2


def swinv2_pet_yaml(root: Path, out: Path, name: str = SWINV2_NAME) -> tuple:
    """configs/classification/pet.yaml with the SwinV2 ``name`` at 256² in
    Swin-B's place (the model name and the `resize_size` anchor that every
    resize of the file reads), data.root ``root`` and SV2_EPOCHS epochs,
    written to ``out``; returns (the config, what the cuts replaced: root,
    epochs)."""
    from visiondk_tpu_torch.config import yaml_dump, yaml_load

    text = PET_YAML.read_text()
    swaps = ((f"name: {PET_MODEL['name']}", f"name: {name}"), ("&resize_size 224", "&resize_size 256"))
    for old, new in swaps:
        check(text.count(old) == 1, f"pet.yaml has {text.count(old)} lines '{old}', want 1")
        text = text.replace(old, new)
    out.write_text(text)
    cfg = yaml_load(out)
    was = cfg["data"]["root"], cfg["hyp"]["epochs"]
    cfg["data"]["root"], cfg["hyp"]["epochs"] = str(root), SV2_EPOCHS
    yaml_dump(cfg, out)
    return cfg, was


def phase_swinv2_run(dev: torch.device, pet_data: tuple, name: str = SWINV2_NAME, tag: str = "swinv2 run",
                     ws16_blocks: int = 0) -> dict:
    """pet.yaml with a SwinV2 in Swin-B's place through the port's CLIs (see
    the module doc): runs A and B bit-identical, exact K2-family launches
    (``ws16_blocks`` of each step's and forward's on ws-16 windows), validate
    on A's best; returns the launches of the in-process runs."""
    fwd, stash, bwd_p, _ = wattn.KERNELS
    depth = SWINV2.depth
    os.environ.pop("VDK_ATTN_NO_PCACHE", None)
    tmp = Path(tempfile.mkdtemp(prefix="vdk_swinv2_"))
    try:
        root = subset_root(synth_pet_root(pet_data, tag), tmp / "data", CLI_RUN_TRAIN)
        n_train = sum(1 for _ in (root / "train").rglob("*.jpg"))
        n_val = sum(1 for _ in (root / "val").rglob("*.jpg"))
        yaml_path = tmp / "pet_swinv2.yaml"
        cfg, was = swinv2_pet_yaml(root, yaml_path, name)
        bs, val_bs = cfg["data"]["train"]["bs"], cfg["data"]["val"]["bs"]
        steps, val_batches = n_train // bs, -(-n_val // val_bs)
        print(f"[{tag}] configs/classification/pet.yaml with these cuts: model.name {name} and the "
              f"resize_size anchor 256 (was {PET_MODEL['name']} at 224: model.image_size and every resize of the "
              f"train and val augments read it), data.root the synthetic pet folders (was {was[0]}; {n_train} "
              f"train / {n_val} val JPEGs, {steps} steps of {bs} an epoch), hyp.epochs {SV2_EPOCHS} (was {was[1]}: "
              f"the config check wants more epochs than warm_ep's {cfg['hyp']['warm_ep']}); everything else as "
              f"written (bs {bs}, val bs {val_bs}, bf16)")
        totals, runs = {k: 0 for k in KERNELS}, {}
        large_want = {fwd: ws16_blocks * val_batches * SV2_EPOCHS, stash: ws16_blocks * steps * SV2_EPOCHS,
                      bwd_p: ws16_blocks * steps * SV2_EPOCHS}
        for run in ("A", "B"):
            project = tmp / f"run{run}"
            out, counts, metrics, secs = counted_run(project, ["--cfgs", str(yaml_path), "--project", str(project),
                                                               "--seed", "0"])
            large = read_large_counts()
            want = only({stash: depth * steps * SV2_EPOCHS, bwd_p: depth * steps * SV2_EPOCHS,
                         fwd: depth * val_batches * SV2_EPOCHS})
            check(counts == want, f"{name} run {run} launches {[(NAMES[k], v) for k, v in counts.items()]}")
            check(all(large[k] == large_want.get(k, 0) for k in wattn.KERNELS),
                  f"{name} run {run} ws-16 launches {[(NAMES[k], v) for k, v in large.items()]}")
            totals = {k: totals[k] + counts[k] for k in KERNELS}
            runs[run] = metrics
            print(f"[{tag}] run {run}: {secs:.1f} s; per epoch train loss "
                  + ", ".join(f"{metrics['Train_loss'][e]!r}" for e in range(SV2_EPOCHS)) + ", val top1 "
                  + ", ".join(f"{metrics['Val_top1'][e]!r}" for e in range(SV2_EPOCHS)) + ", val loss "
                  + ", ".join(f"{metrics['Val_v_loss'][e]!r}" for e in range(SV2_EPOCHS)) + "; trainer-fed images/s "
                  + ", ".join(f"{metrics['Train_images_per_sec'][e]:.1f}" for e in range(SV2_EPOCHS))
                  + f"; launches {NAMES[stash]} {counts[stash]}, {NAMES[bwd_p]} {counts[bwd_p]} (= {depth} x "
                    f"{steps * SV2_EPOCHS} steps), {NAMES[fwd]} {counts[fwd]} (= {depth} x {val_batches} val batches "
                    f"x {SV2_EPOCHS} epochs), no other attention kernel"
                  + (f"; on ws-16 windows {large[stash]}, {large[bwd_p]}, {large[fwd]} ({ws16_blocks} of the "
                     f"{depth} blocks)" if ws16_blocks else ""))
        same = same_metrics(runs["A"], runs["B"], ("Train_loss", "Val_top1", "Val_v_loss"), range(SV2_EPOCHS))
        print(f"[{tag}] run B vs run A: bit-identical {same} (required)")
        check(same, f"seeded {name} runs A and B are not bit-identical")

        reset_counts()
        out_v = run_cli("visiondk_tpu_torch.validate", ["--cfgs", str(tmp / "runA" / "config.yaml"),
                                                         "--weight", str(tmp / "runA" / "best"), "--ema"])
        counts_v = read_counts()
        check(counts_v == only({fwd: depth * val_batches}),
              f"validate launches {[(NAMES[k], v) for k, v in counts_v.items()]}")
        check(read_large_counts()[fwd] == ws16_blocks * val_batches, "validate's ws-16 launches")
        top1_v = float(re.search(r"'top1': ([0-9.e+-]+)", out_v).group(1))
        best_epoch = json.loads((tmp / "runA" / "best" / "meta.json").read_text())["epoch"]
        top1_a = runs["A"]["Val_top1"][best_epoch]
        print(f"[{tag}] validate --ema on run A's best (epoch {best_epoch + 1}): top1 {top1_v!r}; run A logged "
              f"{top1_a!r}; {NAMES[fwd]} launched {counts_v[fwd]}")
        check(top1_v == top1_a, f"validate top1 {top1_v} != run A's best-epoch top1 {top1_a}")
        for k in wattn.KERNELS:
            LARGE_LAUNCHES[k] = LARGE_LAUNCHES.get(k, 0) + 2 * large_want.get(k, 0) + (
                ws16_blocks * val_batches if k is fwd else 0)
        return {k: totals[k] + counts_v[k] for k in KERNELS}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


SWINV2_LARGE = "swinv2_large_window12to16_192to256"
# SwinV2-L at its 256², pet.yaml's model section and hyp otherwise: stages 0-2 (22 of its 24 blocks)
# attend in 16 x 16 windows (N = 256) on the window kernels' tiled bodies, stage 3 in 8 x 8
SWINV2_L = Recipe("swinv2 large serving", "swinv2 large train", {**PET_MODEL, "name": SWINV2_LARGE, "image_size": 256},
                  {"task": "cbir", "backbone": {SWINV2_LARGE: {"pretrained": False, "image_size": 256,
                                                                "feat_dim": 128}}},
                  PET_HYP, 32, 4, 3, 24, wattn.KERNELS,
                  ("attn.qkv.weight", "attn.logit_scale", "attn.cpb_mlp.0.weight"), img=256)
V2L_WS16_BLOCKS = 22
V2L_SERVE_BATCH = 64
# launches on ws-16 windows on the main paths, by window kernel, for report()
LARGE_LAUNCHES: dict = {}


def phase_swinv2_large(dev: torch.device) -> dict:
    """swinv2_large_window12to16_192to256 at 256² on the card (see the module
    doc): serving, training, the repeat check and the f32 step against the
    plain path. Returns the launches of its bf16 serving and training runs."""
    tag, recipe = "swinv2 large", SWINV2_L
    fwd, stash, bwd_p, bwd_r = recipe.kernels
    depth, img, ws16 = recipe.depth, recipe.img, V2L_WS16_BLOCKS
    gen = torch.Generator(device=dev).manual_seed(2)
    batches = [{"image": torch.randint(0, 256, (V2L_SERVE_BATCH, img, img, 3), generator=gen, device=dev,
                                       dtype=torch.uint8)} for _ in range(2)]

    # serving, bf16, bs 64: the main path, counted
    model = get_model(recipe.model, dtype=torch.bfloat16, device=dev, generator=torch.Generator().manual_seed(0))
    eval_step = make_eval_step(model, StepConfig())
    reset_counts()
    logits = [eval_step(b) for b in batches]
    counts, large = read_counts(), read_large_counts()
    check(counts == only({fwd: depth * len(batches)}), f"serving launches {[(NAMES[k], v) for k, v in counts.items()]}")
    check(large[fwd] == ws16 * len(batches), f"serving launched {large[fwd]} ws-16 forwards, want {ws16} a forward")
    totals = dict(counts)
    set_fused(model, False)
    ref = [eval_step(b) for b in batches]
    set_fused(model, True)
    out, ref = torch.cat(logits), torch.cat(ref)
    check(out.shape == (V2L_SERVE_BATCH * len(batches), recipe.model["num_classes"]) and out.dtype == torch.float32
          and bool(torch.isfinite(out).all()), f"logits: shape {tuple(out.shape)}, finite {torch.isfinite(out).all()}")
    cos = row_cosine(out, ref).min().item()
    print(f"[{tag}] {SWINV2_LARGE} bf16 eval bs {V2L_SERVE_BATCH}, {img}²: {counts[fwd]} {NAMES[fwd]} launches over "
          f"{len(batches)} forwards ({large[fwd]} on ws-16 windows: {ws16} of the {depth} blocks a forward), nothing "
          f"else; logits kernel vs plain path: min row cosine {cos:.6f} (want >= {MIN_COSINE}), max |diff| "
          f"{(out - ref).abs().max().item():.3e}")
    check(cos >= MIN_COSINE, f"{SWINV2_LARGE} logits: min row cosine {cos} < {MIN_COSINE}")
    rates = {True: [], False: []}
    for fused in (True, False, False, True):
        set_fused(model, fused)
        rates[fused].append(images_per_s(eval_step, batches[0]))
    set_fused(model, True)
    print(f"[{tag}] eval bs {V2L_SERVE_BATCH} bf16 images/s: kernel path {rates[True][0]:.1f}, {rates[True][1]:.1f} | "
          f"plain path {rates[False][0]:.1f}, {rates[False][1]:.1f} (order kernel, plain, plain, kernel)")
    profile_step(f"{SWINV2_LARGE} eval", lambda: eval_step(batches[0]), V2L_SERVE_BATCH)
    del model, eval_step, logits, ref
    torch.cuda.empty_cache()

    # training, bf16: the stash forwards and backwards from P, counted, then recomputing
    bs = recipe.train_batch
    batch = {"image": torch.randint(0, 256, (bs, img, img, 3), generator=gen, device=dev, dtype=torch.uint8),
             "label": torch.randint(0, recipe.model["num_classes"], (bs,), generator=gen, device=dev)}
    model, state, step = build_trainer(recipe, torch.bfloat16, dev)
    os.environ.pop("VDK_ATTN_NO_PCACHE", None)
    losses = []
    for i in range(recipe.train_steps):
        reset_counts()
        loss = step(state, batch)["loss"]
        counts, large = read_counts(), read_large_counts()
        check(counts == only({stash: depth, bwd_p: depth}) and large[stash] == large[bwd_p] == ws16,
              f"train step {i}: launches {[(NAMES[k], v) for k, v in counts.items()]}, ws-16 {large}")
        totals = {k: totals[k] + counts[k] for k in KERNELS}
        losses.append(loss.item())
        check(math.isfinite(losses[-1]), f"train step {i}: loss {losses[-1]}")
        if i == 0:
            bad = [n for n, p in model.named_parameters() if p.grad is None or not torch.isfinite(p.grad).all()]
            check(not bad, f"parameters without a finite gradient: {bad[:5]}")
            for suffix in recipe.nonzero_grads:
                named = [(n, p) for n, p in model.named_parameters() if n.endswith(suffix)]
                zero = [n for n, p in named if not p.grad.abs().sum().item() > 0]
                check(len(named) == depth and not zero, f"{suffix} gradients that are zero: {zero}")
    os.environ["VDK_ATTN_NO_PCACHE"] = "1"
    reset_counts()
    loss = step(state, batch)["loss"]
    counts, large = read_counts(), read_large_counts()
    os.environ.pop("VDK_ATTN_NO_PCACHE")
    check(counts == only({fwd: depth, bwd_r: depth}) and large[fwd] == large[bwd_r] == ws16 and
          math.isfinite(loss.item()), f"no-pcache step: launches {[(NAMES[k], v) for k, v in counts.items()]}")
    totals = {k: totals[k] + counts[k] for k in KERNELS}
    for k in recipe.kernels:
        LARGE_LAUNCHES[k] = LARGE_LAUNCHES.get(k, 0) + ws16 * totals[k] // depth
    print(f"[{tag}] bf16 bs {bs} train, {recipe.train_steps} steps: losses {', '.join(f'{x:.5f}' for x in losses)}; "
          f"launches per step {depth} {NAMES[stash]} + {depth} {NAMES[bwd_p]} ({ws16} of each on ws-16 windows), "
          f"with VDK_ATTN_NO_PCACHE=1 {depth} {NAMES[fwd]} + {depth} {NAMES[bwd_r]} (loss {loss.item():.5f}); all "
          f"{depth} {' and '.join(recipe.nonzero_grads)} gradients non-zero after step 0")
    for trial, path in enumerate((KERNEL_PATH, PLAIN_PATH, KERNEL_PATH)):
        train_rate(model, state, step, batch, path, f"[{tag}] bf16 bs {bs} trial {trial}, {path[0]} path")
    set_fused(model, True)
    profile_step(f"{SWINV2_LARGE} train", lambda: step(state, batch), bs)

    # the repeat check: two backward passes from the same weights and batch give the same gradients
    lossfn = create_lossfn("ce", label_smooth=LABEL_SMOOTH)
    images = device_preprocess(batch["image"], StepConfig().mean, StepConfig().std)
    model.train()
    unequal = unequal_gradients(model, lambda: lossfn(model(images), batch["label"]))
    print(f"[{tag}] gradients unequal between two identical backward passes: "
          f"{', '.join(unequal[:6]) if unequal else 'none'} (of {sum(1 for _ in model.parameters())} parameters)")
    check(not unequal, f"{SWINV2_LARGE}: gradients differ between two identical backward passes: {unequal[:6]}")
    del model, state, step, images
    torch.cuda.empty_cache()

    # one f32 step on the kernel path against the plain path
    compare_one_step(recipe, torch.float32, dev, {k: v[:recipe.f32_train_batch] for k, v in batch.items()}, tag=tag)
    torch.cuda.empty_cache()

    # the wrapper takes ws <= 16 and raises above it, naming the limit
    x = torch.zeros((1, 17, 17, 3 * 2 * 8), device=dev, dtype=torch.bfloat16)
    try:
        fwd(x, torch.zeros((2, 289, 289), device=dev), None, 2)
        raised = None
    except ValueError as err:
        raised = err
    check(raised is not None and "ws <= 16" in str(raised), f"ws 17 on the card did not raise the limit: {raised!r}")
    print(f"[{tag}] ws 17 on the card: ValueError({raised})")
    return totals


# ---------------------------------------------------------------- strategies

# pet_synth.yaml with mixup in epoch 1 (the epoch after warm_ep), OHEM on and
# two mini-batches an update; 11 of the run loop's train JPEGs a class
# (385: 3 steps of 128, so epoch 0 ends in the middle of a round of 2)
ST_CUTS = {"n_train_per_class": 11, "epochs": 2, "mixup": {"ratio": 0.2, "duration": 1},
           "ohem": [True, 8, 0.7, 255], "accumulate": 2}


def subset_root(root: Path, out: Path, n_train: int) -> Path:
    """``out`` holding the first ``n_train`` train JPEGs of each class of
    ``root`` (by name) and all its val JPEGs, as symbolic links."""
    for split in ("train", "val"):
        for class_dir in sorted((root / split).iterdir()):
            files = sorted(class_dir.glob("*.jpg"))
            dst = out / split / class_dir.name
            dst.mkdir(parents=True)
            for f in files[:n_train] if split == "train" else files:
                (dst / f.name).symlink_to(f)
    return out


def phase_strategies(dev: torch.device, pet_data: tuple) -> dict:
    """pet_synth's ViT-B/16 with mixup, OHEM and gradient accumulation through
    the port's CLIs (see the module doc); returns the launches of the
    in-process runs."""
    from visiondk_tpu_torch.config import yaml_dump, yaml_load
    from visiondk_tpu_torch.engine.checkpoint import CheckpointManager

    tag = "strategies"
    fwd, stash, bwd_p, _ = K1_KERNELS
    os.environ.pop("VDK_ATTN_NO_PCACHE", None)
    tmp = Path(tempfile.mkdtemp(prefix="vdk_strategies_"))
    try:
        root = subset_root(synth_pet_root(pet_data, tag), tmp / "data", ST_CUTS["n_train_per_class"])
        cfg = yaml_load(PET_SYNTH_YAML)
        was = (cfg["hyp"]["epochs"], cfg["hyp"]["strategy"]["mixup"], cfg["hyp"]["strategy"]["ohem"],
               cfg["hyp"].get("accumulate"))
        cfg["data"]["root"] = str(root)
        cfg["hyp"]["epochs"] = ST_CUTS["epochs"]
        cfg["hyp"]["strategy"]["mixup"] = dict(ST_CUTS["mixup"])
        cfg["hyp"]["strategy"]["ohem"] = list(ST_CUTS["ohem"])
        cfg["hyp"]["accumulate"] = ST_CUTS["accumulate"]
        yaml_path = tmp / "pet_synth_strategies.yaml"
        yaml_dump(cfg, yaml_path)
        n_classes, bs, val_bs = cfg["model"]["num_classes"], cfg["data"]["train"]["bs"], cfg["data"]["val"]["bs"]
        n_train = ST_CUTS["n_train_per_class"] * n_classes
        n_val = RUN_LOOP_CUTS["n_val_per_class"] * n_classes
        epochs, k = ST_CUTS["epochs"], ST_CUTS["accumulate"]
        steps, val_batches = n_train // bs, -(-n_val // val_bs)
        print(f"[{tag}] configs/classification/pet_synth.yaml with these cuts: hyp.strategy.mixup "
              f"{ST_CUTS['mixup']} (was {was[1]}), hyp.strategy.ohem {ST_CUTS['ohem']} (was {was[2]}), "
              f"hyp.accumulate {k} (was {was[3]}), hyp.epochs {epochs} (was {was[0]}), the run loop's JPEGs cut to "
              f"{ST_CUTS['n_train_per_class']} train a class ({n_train} train / {n_val} val, {steps} steps of {bs} an "
              f"epoch: epoch 0 ends in the middle of a round of {k}); everything else as written")
        # a step: the OHEM forward (no stash, no gradient), the stash forward and the backward from P
        want = only({fwd: DEPTH * (steps + val_batches), stash: DEPTH * steps, bwd_p: DEPTH * steps})
        totals, runs = {k_: 0 for k_ in KERNELS}, {}
        run_c = tmp / "runC"
        for run in ("A", "B"):
            project = tmp / f"run{run}"
            if run == "B":  # run C's first process (killed in epoch 1, below), beside run B
                killing_c = start_killed_in_epoch_1(["--cfgs", str(yaml_path)], run_c)
                try:
                    out, counts, metrics, secs = counted_run(project, ["--cfgs", str(yaml_path), "--project",
                                                                       str(project), "--seed", "0"])
                finally:
                    killing_c.result()
            else:
                out, counts, metrics, secs = counted_run(project, ["--cfgs", str(yaml_path), "--project",
                                                                   str(project), "--seed", "0"])
            check(counts == {k_: v * epochs for k_, v in want.items()},
                  f"run {run} launches {[(NAMES[k_], v) for k_, v in counts.items()]}")
            check("Mixup start up" in out, f"run {run} logged no 'Mixup start up'")
            totals = {k_: totals[k_] + counts[k_] for k_ in KERNELS}
            runs[run] = metrics
            print(f"[{tag}] run {run}: {secs:.1f} s; per epoch train loss "
                  + ", ".join(f"{metrics['Train_loss'][e]!r}" for e in range(epochs)) + ", val top1 "
                  + ", ".join(f"{metrics['Val_top1'][e]!r}" for e in range(epochs)) + ", lr "
                  + ", ".join(f"{metrics['Train_lr'][e]!r}" for e in range(epochs)) + "; trainer-fed images/s "
                  + ", ".join(f"{metrics['Train_images_per_sec'][e]:.1f}" for e in range(epochs))
                  + f"; launches per epoch {NAMES[fwd]} {counts[fwd] // epochs} (= {DEPTH} x ({steps} OHEM forwards + "
                    f"{val_batches} val batch)), {NAMES[stash]} and {NAMES[bwd_p]} {counts[stash] // epochs} "
                    f"(= {DEPTH} x {steps}); 'Mixup start up' logged")
        saved = CheckpointManager(tmp / "runA").read("last")
        check((saved["step"], saved["opt_count"], saved["ema_updates"], saved["opt_mini_step"]) ==
              (steps * epochs, steps * epochs // k, steps * epochs // k, steps * epochs % k),
              f"run A's last checkpoint counts {saved['step'], saved['opt_count'], saved['ema_updates']}")
        same = same_metrics(runs["A"], runs["B"], ("Train_loss", "Val_top1", "Val_v_loss"), range(epochs))
        print(f"[{tag}] run B vs run A: bit-identical {same} (required); run A's last checkpoint: {steps * epochs} "
              f"mini-steps, {saved['opt_count']} applied updates, {saved['ema_updates']} EMA updates")
        check(same, "seeded strategy runs A and B are not bit-identical")
        shutil.rmtree(tmp / "runB")

        # run C: killed in epoch 1 once epoch 0's checkpoint (in the middle of a round) was complete, resumed
        ckpt = CheckpointManager(run_c).read("last")
        check(ckpt["opt_mini_step"] == steps % k and (ckpt["opt_acc_grads"] is not None) == bool(steps % k),
              f"epoch 0's checkpoint holds mini-step {ckpt['opt_mini_step']}")
        del ckpt
        out_c, counts_c, metrics_c, _ = counted_run(run_c, ["--cfgs", str(yaml_path), "--project", str(run_c),
                                                            "--seed", "0", "--resume"])
        resumed = int(re.search(r"resume: last \(epoch (\d+)\)", out_c).group(1))
        check(resumed == 1 and counts_c == want, f"run C resumed from epoch {resumed}, launches "
                                                 f"{[(NAMES[k_], v) for k_, v in counts_c.items()]}")
        same_c = same_metrics(runs["A"], metrics_c, ("Train_loss", "Val_top1", "Val_v_loss"), range(resumed, epochs))
        print(f"[{tag}] run C: SIGKILL in epoch 1, epoch 0's checkpoint in the middle of a round (mini-step "
              f"{steps % k} of {k}, its running mean saved), --resume from epoch {resumed}: epoch {epochs} "
              f"bit-identical to run A: {same_c} (required)")
        check(same_c, "the resumed strategy run C is not bit-identical to run A")

        reset_counts()
        out_v = run_cli("visiondk_tpu_torch.validate", ["--cfgs", str(tmp / "runA" / "config.yaml"),
                                                         "--weight", str(tmp / "runA" / "best"), "--ema"])
        counts_v = read_counts()
        check(counts_v == only({fwd: DEPTH * val_batches}),
              f"validate launches {[(NAMES[k_], v) for k_, v in counts_v.items()]}")
        top1_v = float(re.search(r"'top1': ([0-9.e+-]+)", out_v).group(1))
        best_epoch = json.loads((tmp / "runA" / "best" / "meta.json").read_text())["epoch"]
        top1_a = runs["A"]["Val_top1"][best_epoch]
        print(f"[{tag}] validate --ema on run A's best (epoch {best_epoch + 1}): top1 {top1_v!r}; run A logged "
              f"{top1_a!r}")
        check(top1_v == top1_a, f"validate top1 {top1_v} != run A's best-epoch top1 {top1_a}")
        return {k_: totals[k_] + counts_c[k_] + counts_v[k_] for k_ in KERNELS}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------- SigLIP So400m

SO_NAME = "vit_so400m_patch14_siglip_224"
# SigLIP So400m at 224² (27 blocks, width 1152, MLP 4304, 16 heads of head dim 72, 256 tokens and no CLS,
# the map pool), full width and depth, pet.yaml's model section and hyp with the name swapped: K1, K1s and
# K1b in their 80-wide bucket
SO400M = Recipe("so400m serving", "so400m train", {**PET_MODEL, "name": SO_NAME}, {}, PET_HYP, 64, 4, 3, 27,
                K1_KERNELS, ("attn.qkv.weight",))
SO_SERVE_BATCH = 128
SWINV2_REMAT_BATCH = 8
SAM_VIT_BATCH = 32
# launches on the So400m paths (serving, training, the run), by kernel, for report()
SO_LAUNCHES: dict = {}


def set_compute_dtype(model: torch.nn.Module, dtype: torch.dtype) -> None:
    """Every layer of ``model`` computes in ``dtype`` (its parameters stay
    f32): what ``get_model(dtype=...)`` builds, without drawing the weights
    again."""
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype


def restore(model: torch.nn.Module, params: dict) -> None:
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(params[n])


def phase_so400m(dev: torch.device) -> dict:
    """vit_so400m_patch14_siglip_224 on the card (see the module doc):
    serving bf16 and f32, training bf16 with remat off and on, the f32
    steps against the plain path and remat on against off; then the remat
    check on SwinV2-B, the SAM steps on ViT-B/16 and resnet18, and
    attention_pool on Swin-B. Returns the launches of the So400m bf16
    serving and training runs."""
    from visiondk_tpu_torch.engine.optim import SAMConfig

    tag, recipe = "so400m", SO400M
    fwd, stash, bwd_p, _ = recipe.kernels
    depth, img = recipe.depth, recipe.img
    gen = torch.Generator(device=dev).manual_seed(2)
    batches = [{"image": torch.randint(0, 256, (SO_SERVE_BATCH, img, img, 3), generator=gen, device=dev,
                                       dtype=torch.uint8)} for _ in range(2)]
    t0 = time.perf_counter()
    model = get_model(recipe.model, dtype=torch.float32, device=dev, generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    theta0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    bb = model.backbone
    heads = bb.blocks[0].attn.num_heads
    print(f"[{tag}] built {SO_NAME} ({recipe.model['num_classes']} classes, {img}², {depth} blocks, width "
          f"{bb.pos_embed.shape[-1]}, MLP {bb.blocks[0].mlp.fc1.out_features}, {heads} heads of head dim "
          f"{bb.pos_embed.shape[-1] // heads}, {bb.pos_embed.shape[1]} tokens, no CLS, map pool), "
          f"{sum(p.numel() for p in model.parameters()):,} parameters, seeded, in {time.perf_counter() - t0:.1f} s")

    # serving, bf16, bs 128: the main path, counted
    set_compute_dtype(model, torch.bfloat16)
    eval_step = make_eval_step(model, StepConfig())
    reset_counts()
    logits = [eval_step(b) for b in batches]
    counts = read_counts()
    check(counts == only({fwd: depth * len(batches)}),
          f"So400m serving launches {[(NAMES[k], v) for k, v in counts.items()]}, want {depth} K1 a forward")
    totals = dict(counts)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        set_compute_dtype(model, dtype)
        if dtype == torch.float32:
            logits = [eval_step(b) for b in batches]
        set_fused(model, False)
        ref = [eval_step(b) for b in batches]
        set_fused(model, True)
        out, ref = torch.cat(logits), torch.cat(ref)
        check(out.shape == (SO_SERVE_BATCH * len(batches), recipe.model["num_classes"]) and
              out.dtype == torch.float32 and bool(torch.isfinite(out).all()),
              f"{name} logits: shape {tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}")
        cos = row_cosine(out, ref).min().item()
        agree = (out.argmax(1) == ref.argmax(1)).double().mean().item()
        print(f"[{tag}] {name} eval bs {SO_SERVE_BATCH}: "
              + (f"{counts[fwd]} {NAMES[fwd]} launches over {len(batches)} forwards, nothing else; "
                 if dtype == torch.bfloat16 else "") +
              f"logits kernel vs plain path: min row cosine {cos:.6f} (want >= {MIN_COSINE}), max |diff| "
              f"{(out - ref).abs().max().item():.3e}, argmax agreement {agree:.4f}"
              + (f" (want >= {MIN_ARGMAX_AGREEMENT})" if dtype == torch.float32 else " (printed: held in f32)"))
        check(cos >= MIN_COSINE, f"So400m {name} logits: min row cosine {cos} < {MIN_COSINE}")
        if dtype == torch.float32:
            check(agree >= MIN_ARGMAX_AGREEMENT, f"So400m f32 argmax agreement {agree} < {MIN_ARGMAX_AGREEMENT}")
    set_compute_dtype(model, torch.bfloat16)
    rates = {True: [], False: []}
    for fused in (True, False, False, True):
        set_fused(model, fused)
        rates[fused].append(images_per_s(eval_step, batches[0]))
    set_fused(model, True)
    print(f"[{tag}] eval bs {SO_SERVE_BATCH} bf16 images/s: kernel path {rates[True][0]:.1f}, {rates[True][1]:.1f} | "
          f"plain path {rates[False][0]:.1f}, {rates[False][1]:.1f} (order kernel, plain, plain, kernel)")
    profile_step(f"{SO_NAME} eval bf16", lambda: eval_step(batches[0]), SO_SERVE_BATCH)
    del eval_step, logits, ref, out

    # training, bf16, bs 64, SGD + clip + EMA: remat off (K1s + K1b a block) and on (K1s twice)
    bs = recipe.train_batch
    batch = {"image": torch.randint(0, 256, (bs, img, img, 3), generator=gen, device=dev, dtype=torch.uint8),
             "label": torch.randint(0, recipe.model["num_classes"], (bs,), generator=gen, device=dev)}
    model, state, step = build_trainer(recipe, torch.bfloat16, dev, model=model)
    os.environ.pop("VDK_ATTN_NO_PCACHE", None)
    losses = {}
    for remat in (False, True):
        bb.remat = remat
        reset_counts()
        loss = step(state, batch)["loss"]
        counts = read_counts()
        want = only({stash: depth * (2 if remat else 1), bwd_p: depth})
        check(counts == want, f"So400m train step, remat {remat}: launches "
                              f"{[(NAMES[k], v) for k, v in counts.items()]}")
        totals = {k: totals[k] + counts[k] for k in KERNELS}
        losses[remat] = loss.item()
        check(math.isfinite(losses[remat]), f"So400m train step, remat {remat}: loss {losses[remat]}")
        bad = [n for n, p in model.named_parameters() if p.grad is None or not torch.isfinite(p.grad).all()]
        zero = [n for n, p in model.named_parameters() if n.endswith("attn.qkv.weight") and not p.grad.abs().sum() > 0]
        check(not bad and not zero, f"parameters without a finite gradient: {bad[:5]}; zero qkv gradients {zero}")
    print(f"[{tag}] bf16 bs {bs} train steps: remat off loss {losses[False]:.5f}, launches {depth} {NAMES[stash]} + "
          f"{depth} {NAMES[bwd_p]}; remat on loss {losses[True]:.5f}, launches {2 * depth} {NAMES[stash]} (the "
          f"forward's and the recompute's) + {depth} {NAMES[bwd_p]}; nothing else; every gradient finite, every "
          f"qkv.weight gradient non-zero")
    trials = {False: [], True: []}
    for trial, remat in enumerate((False, True, True, False)):
        bb.remat = remat
        trials[remat].append(train_rate(model, state, step, batch, KERNEL_PATH,
                                        f"[{tag}] bf16 bs {bs} trial {trial}, remat {'on' if remat else 'off'}"))
    TRAIN_RATES[recipe.train_tag] = [r for r, _ in trials[False]]
    print(f"[{tag}] bf16 bs {bs} train images/s: remat off {trials[False][0][0]:.1f}, {trials[False][1][0]:.1f} | "
          f"remat on {trials[True][0][0]:.1f}, {trials[True][1][0]:.1f} (order off, on, on, off); "
          f"max_memory_allocated remat off {trials[False][0][1]:.2f} GiB, remat on {trials[True][0][1]:.2f} GiB")
    for remat in (False, True):
        bb.remat = remat
        profile_step(f"{SO_NAME} train bf16 remat {'on' if remat else 'off'}", lambda: step(state, batch), bs)
    del state, step
    torch.cuda.empty_cache()

    # one f32 step at bs 4 from θ₀: kernel path against the plain path, remat on against remat off
    small = {k: v[:recipe.f32_train_batch] for k, v in batch.items()}
    set_compute_dtype(model, torch.float32)
    sides = {}
    for label, path, remat in (("kernel", KERNEL_PATH, False), ("plain", PLAIN_PATH, False),
                               ("kernel remat", KERNEL_PATH, True)):
        restore(model, theta0)
        bb.remat = remat
        _, state, step = build_trainer(recipe, torch.float32, dev, path, model=model)
        with cudnn_mode(True):  # the trainer's setting: the patch convolution's backward is then deterministic
            loss = step(state, small)["loss"].item()
        sides[label] = (loss, *snapshot(model))
        del state, step
        torch.cuda.empty_cache()
    set_fused(model, True)
    f32 = str(torch.float32).replace("torch.", "")
    compare_sides(f"[{tag}] {f32} kernel vs plain path", torch.float32, small, theta0, sides["kernel"],
                  sides["plain"])
    compare_sides(f"[{tag}] {f32} remat on vs remat off (kernel path)", torch.float32, small, theta0,
                  sides["kernel remat"], sides["kernel"])
    same = sides["kernel remat"][0] == sides["kernel"][0] and all(
        torch.equal(sides["kernel remat"][i][n], sides["kernel"][i][n]) for i in (1, 2) for n in theta0)
    print(f"[{tag}] f32 one step, remat on vs off: bit-identical {same} (printed; the bars above are held)")
    del model, sides, theta0, bb
    torch.cuda.empty_cache()

    # remat on SwinV2-B, f32 bs 8: two stash forwards and one backward from P a block
    sv2_batch = {"image": torch.randint(0, 256, (SWINV2_REMAT_BATCH, SWINV2.img, SWINV2.img, 3), generator=gen,
                                        device=dev, dtype=torch.uint8),
                 "label": torch.randint(0, SWINV2.model["num_classes"], (SWINV2_REMAT_BATCH,), generator=gen,
                                        device=dev)}
    model = get_model(SWINV2.model, dtype=torch.float32, device=dev, generator=torch.Generator().manual_seed(0))
    theta0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    sides = {}
    wf, ws, wb, _ = wattn.KERNELS
    for remat in (False, True):
        restore(model, theta0)
        for stage in model.backbone.layers:
            stage.remat = remat
        _, state, step = build_trainer(SWINV2, torch.float32, dev, model=model)
        reset_counts()
        with cudnn_mode(True):
            loss = step(state, sv2_batch)["loss"].item()
        counts = read_counts()
        check(counts == only({ws: SWINV2.depth * (2 if remat else 1), wb: SWINV2.depth}),
              f"SwinV2-B f32 step, remat {remat}: launches {[(NAMES[k], v) for k, v in counts.items()]}")
        sides[remat] = (loss, *snapshot(model))
        del state, step
    compare_sides(f"[{tag}] {SWINV2_NAME} f32 remat on vs remat off ({SWINV2.depth} {NAMES[ws]} twice and "
                  f"{SWINV2.depth} {NAMES[wb]} a step with remat)", torch.float32, sv2_batch, theta0,
                  sides[True], sides[False])
    same = sides[True][0] == sides[False][0] and all(
        torch.equal(sides[True][i][n], sides[False][i][n]) for i in (1, 2) for n in theta0)
    print(f"[{tag}] {SWINV2_NAME} f32 one step, remat on vs off: bit-identical {same} (printed)")
    del model, sides, theta0
    torch.cuda.empty_cache()

    # SAM: one f32 step of ViT-B/16 at bs 32 on the kernel path against the plain path (a step: two
    # passes, 24 K1s + 24 K1b), and resnet18 at CNN_F32_BATCH on the card against the CPU in float64
    sam = StepConfig(sam=SAMConfig())
    vit_batch = {"image": torch.randint(0, 256, (SAM_VIT_BATCH, IMG, IMG, 3), generator=gen, device=dev,
                                        dtype=torch.uint8),
                 "label": torch.randint(0, VIT.model["num_classes"], (SAM_VIT_BATCH,), generator=gen, device=dev)}
    model, state, step = build_trainer(VIT, torch.float32, dev, step_cfg=sam)
    reset_counts()
    kernel_side = (step(state, vit_batch)["loss"].item(), *snapshot(model))
    counts = read_counts()
    check(counts == only({stash: 2 * DEPTH, bwd_p: 2 * DEPTH}),
          f"a ViT-B/16 SAM step launches {[(NAMES[k], v) for k, v in counts.items()]}")
    del model, state, step
    compare_one_step(VIT, torch.float32, dev, vit_batch, kernel_side=kernel_side, tag=f"{tag} SAM", step_cfg=sam)
    del kernel_side
    torch.cuda.empty_cache()
    r18_tag, r18_cfg, _, r18_loss, r18_epochs = CNN_RECIPES[1]
    with cudnn_mode(True):
        compare_cnn_with_cpu(f"{r18_tag} SAM", r18_cfg, r18_loss, r18_epochs, dev, f32=False, step_cfg=sam)
    torch.cuda.empty_cache()

    # attention_pool on Swin-B: serving bf16 bs 128, kernel path against the plain path
    pool_cfg = {**PET_MODEL, "attention_pool": True}
    model = get_model(pool_cfg, dtype=torch.bfloat16, device=dev, generator=torch.Generator().manual_seed(0))
    eval_step = make_eval_step(model, StepConfig())
    pool_batches = [{"image": b["image"][:BATCH]} for b in batches]
    reset_counts()
    out = torch.cat([eval_step(b) for b in pool_batches])
    counts = read_counts()
    check(counts == only({wf: SWIN.depth * len(pool_batches)}),
          f"attention_pool serving launches {[(NAMES[k], v) for k, v in counts.items()]}")
    set_fused(model, False)
    ref = torch.cat([eval_step(b) for b in pool_batches])
    check(out.shape == (BATCH * len(pool_batches), PET_MODEL["num_classes"]) and bool(torch.isfinite(out).all()),
          f"attention_pool logits {tuple(out.shape)}")
    cos = row_cosine(out, ref).min().item()
    print(f"[{tag}] {PET_MODEL['name']} attention_pool (AttentionPooling over its 7x7 token map, f32 fc) bf16 eval "
          f"bs {BATCH}: {counts[wf]} {NAMES[wf]} over {len(pool_batches)} forwards; logits kernel vs plain path: min "
          f"row cosine {cos:.6f} (want >= {MIN_COSINE}), max |diff| {(out - ref).abs().max().item():.3e}")
    check(cos >= MIN_COSINE, f"attention_pool logits: min row cosine {cos} < {MIN_COSINE}")
    del model, eval_step
    torch.cuda.empty_cache()
    for k in KERNELS:
        SO_LAUNCHES[k] = SO_LAUNCHES.get(k, 0) + totals[k]
    return totals


# pet.yaml with So400m in Swin-B's place, remat on and SAM, on 5 of the run loop's train JPEGs a
# class (175: 2 steps of pet.yaml's bs 80) and all its val JPEGs, 2 epochs
SO_RUN_CUTS = {"n_train_per_class": 5, "epochs": 2}


def phase_so400m_run(dev: torch.device, pet_data: tuple) -> dict:
    """pet.yaml with ``name: vit_so400m_patch14_siglip_224``, ``kwargs:
    {remat: true}`` and ``optimizer: [sam, False]`` through the port's CLIs
    (see the module doc): runs A and B bit-identical, exact K1-family
    launches, validate on A's best; returns the launches of the in-process
    runs."""
    from visiondk_tpu_torch.config import yaml_dump, yaml_load

    tag = "so400m run"
    fwd, stash, bwd_p, _ = K1_KERNELS
    depth = SO400M.depth
    os.environ.pop("VDK_ATTN_NO_PCACHE", None)
    tmp = Path(tempfile.mkdtemp(prefix="vdk_so400m_"))
    try:
        root = subset_root(synth_pet_root(pet_data, tag), tmp / "data", SO_RUN_CUTS["n_train_per_class"])
        cfg = yaml_load(PET_YAML)
        was = (cfg["model"]["name"], cfg["model"]["kwargs"], cfg["hyp"]["optimizer"], cfg["data"]["root"],
               cfg["hyp"]["epochs"])
        cfg["model"]["name"] = SO_NAME
        cfg["model"]["kwargs"] = {"remat": True}
        cfg["hyp"]["optimizer"] = ["sam", False]
        cfg["data"]["root"] = str(root)
        cfg["hyp"]["epochs"] = epochs = SO_RUN_CUTS["epochs"]
        yaml_path = tmp / "pet_so400m.yaml"
        yaml_dump(cfg, yaml_path)
        n_classes, bs, val_bs = cfg["model"]["num_classes"], cfg["data"]["train"]["bs"], cfg["data"]["val"]["bs"]
        n_train = SO_RUN_CUTS["n_train_per_class"] * n_classes
        n_val = RUN_LOOP_CUTS["n_val_per_class"] * n_classes
        steps, val_batches = n_train // bs, -(-n_val // val_bs)
        check(steps >= 2, f"{steps} optimizer steps an epoch, want at least 2")
        print(f"[{tag}] configs/classification/pet.yaml with these cuts: model.name {SO_NAME} (was {was[0]}), "
              f"model.kwargs {{remat: true}} (was {was[1]}), hyp.optimizer [sam, False] (was {was[2]}), data.root the "
              f"run loop's JPEGs cut to {SO_RUN_CUTS['n_train_per_class']} train a class (was {was[3]}; {n_train} "
              f"train / {n_val} val, {steps} steps of {bs} an epoch), hyp.epochs {epochs} (was {was[4]}); everything "
              f"else as written (bf16, val bs {val_bs})")
        # a step: two passes (SAM), each a stash forward twice a block (remat) and a backward from P
        want = only({stash: 4 * depth * steps * epochs, bwd_p: 2 * depth * steps * epochs,
                     fwd: depth * val_batches * epochs})
        totals, runs, written = {k: 0 for k in KERNELS}, {}, []
        for run in ("A", "B"):
            project = tmp / f"run{run}"
            written.clear()
            with checkpoint_bytes(written):
                out, counts, metrics, secs = counted_run(project, ["--cfgs", str(yaml_path), "--project",
                                                                   str(project), "--seed", "0"])
            check(counts == want, f"run {run} launches {[(NAMES[k], v) for k, v in counts.items()]}")
            totals = {k: totals[k] + counts[k] for k in KERNELS}
            runs[run] = metrics
            print(f"[{tag}] run {run}: {secs:.1f} s; per epoch train loss "
                  + ", ".join(f"{metrics['Train_loss'][e]!r}" for e in range(epochs)) + ", val top1 "
                  + ", ".join(f"{metrics['Val_top1'][e]!r}" for e in range(epochs)) + ", val loss "
                  + ", ".join(f"{metrics['Val_v_loss'][e]!r}" for e in range(epochs)) + "; trainer-fed images/s "
                  + ", ".join(f"{metrics['Train_images_per_sec'][e]:.1f}" for e in range(epochs))
                  + f"; launches {NAMES[stash]} {counts[stash]} (= 2 passes x 2 (remat) x {depth} x {steps * epochs} "
                    f"steps), {NAMES[bwd_p]} {counts[bwd_p]} (= 2 x {depth} x {steps * epochs}), {NAMES[fwd]} "
                    f"{counts[fwd]} (= {depth} x {val_batches} val batches x {epochs} epochs), no other attention "
                    f"kernel; {len(written)} checkpoints written (last and best each epoch): "
                  + ", ".join(f"{b / 1e9:.3f}" for b in written) + " GB")
            if run == "A":
                shutil.rmtree(project / "last", ignore_errors=True)  # disk: the validate below reads best
        same = same_metrics(runs["A"], runs["B"], ("Train_loss", "Val_top1", "Val_v_loss"), range(epochs))
        print(f"[{tag}] run B vs run A: bit-identical {same} (required)")
        check(same, "seeded So400m runs A and B are not bit-identical")
        shutil.rmtree(tmp / "runB", ignore_errors=True)

        reset_counts()
        out_v = run_cli("visiondk_tpu_torch.validate", ["--cfgs", str(tmp / "runA" / "config.yaml"),
                                                         "--weight", str(tmp / "runA" / "best"), "--ema"])
        counts_v = read_counts()
        check(counts_v == only({fwd: depth * val_batches}),
              f"validate launches {[(NAMES[k], v) for k, v in counts_v.items()]}")
        top1_v = float(re.search(r"'top1': ([0-9.e+-]+)", out_v).group(1))
        best_epoch = json.loads((tmp / "runA" / "best" / "meta.json").read_text())["epoch"]
        top1_a = runs["A"]["Val_top1"][best_epoch]
        print(f"[{tag}] validate --ema on run A's best (epoch {best_epoch + 1}): top1 {top1_v!r}; run A logged "
              f"{top1_a!r}; {NAMES[fwd]} launched {counts_v[fwd]}")
        check(top1_v == top1_a, f"validate top1 {top1_v} != run A's best-epoch top1 {top1_a}")
        out = {k: totals[k] + counts_v[k] for k in KERNELS}
        for k in KERNELS:
            SO_LAUNCHES[k] = SO_LAUNCHES.get(k, 0) + out[k]
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------- DP: distributed training

FACE_YAML = PET_SYNTH_YAML.parents[1] / "faceX" / "face.yaml"
DP_WORLD = 2
DP_F32_BATCH = 8            # the global batch of the one-step checks: 4 a rank
DP_TIMED_STEPS, DP_WARMUP = 3, 1
DP_TIMEOUT_S = 420
DP_COLLECTIVES = ("all_reduce", "all_reduce max", "all_gather", "broadcast", "barrier")


def dp_cases() -> list:
    """The world-2 one-step checks: (label, model section, loss, f64, step
    kwargs). face.yaml's model with the backbone's stochastic depth off (the
    ranks draw their own masks), resnet50 with SyncBN in float64 (f32
    BatchNorm gradients at random init are ill-conditioned: see phase CN),
    and pet_synth's ViT-B/16 with SAM's per-rank ε."""
    from visiondk_tpu_torch.config import yaml_load
    from visiondk_tpu_torch.engine.optim import SAMConfig

    face = yaml_load(FACE_YAML)["model"]
    (name, params), = face["backbone"].items()
    face = {**face, "backbone": {name: {**params, "stochastic_depth_prob": 0.0}}}
    resnet50 = CNN_RECIPES[0][1]
    return [("face.yaml, model_parallel 2", face, "ce", False, {"task": "embedding"}),
            ("resnet50 SyncBN", resnet50, "bce", True, {}),
            ("ViT-B/16 SAM per-rank", PET_SYNTH_MODEL, "ce", False, {"sam": SAMConfig(local_perturb=True)})]


def dp_batch(model_cfg: dict, loss: str, bs: int, dev, seed: int) -> dict:
    """Seeded uint8 224² images and labels: int over the model's classes
    (a margin head's: the rows spread over both shards), or multi-hot."""
    if model_cfg["task"] != "classification":
        n = next(iter(model_cfg["head"].values()))["num_class"]
        gen = torch.Generator(device=dev).manual_seed(seed)
        return {"image": torch.randint(0, 256, (bs, IMG, IMG, 3), generator=gen, device=dev, dtype=torch.uint8),
                "label": torch.randint(0, n, (bs,), generator=gen, device=dev)}
    return cnn_batch(model_cfg, loss, bs, dev, seed)


def dp_trainer(model_cfg: dict, loss: str, f64: bool, step_kwargs: dict, dev, mesh=None, dtype=torch.float32):
    """(model, state, step) of a DP check: the model (seed 0; float64 where
    asked), its head class-sharded over ``mesh``'s model group when it has
    one, the config's SGD + clip + EMA, and the loss (a sharded head's the
    CE over class shards)."""
    from visiondk_tpu_torch.losses.losses import class_sharded_cross_entropy

    embedding = model_cfg["task"] != "classification"
    model = get_model(model_cfg, dtype=dtype, device=dev, generator=torch.Generator().manual_seed(0))
    if f64:
        model.double()
        for m in model.modules():
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = torch.float64
    lossfn = cnn_loss(loss, f64)
    if embedding:
        lossfn = create_lossfn("ce", valid_class=model.head.num_class)
        if mesh is not None and mesh.n_model > 1:
            model.head.shard(mesh)
            head = model.head
            lossfn = lambda logits, y, sample_weight=None: class_sharded_cross_entropy(  # noqa: E731
                logits, y, head.num_class, head.class_offset, mesh)
    hyp = PET_HYP if embedding else PET_SYNTH_HYP
    tx = build_tx(hyp, STEPS_PER_EPOCH, discrete_per_epoch=not embedding, model_cfg=model_cfg)
    state = create_train_state(model, tx)
    step = make_train_step(model, tx, lossfn, StepConfig(**step_kwargs), torch.Generator().manual_seed(1), mesh=mesh)
    return model, state, step, tx, lossfn


def dp_outcome(model, state, loss: float, theta0: dict) -> tuple:
    """(loss, {gradient, update, BN statistic: {name: float64 CPU tensor}},
    max |θ₀| by name) after a step, a class-sharded head's tensors gathered
    whole (``cnn_one_step``'s form, for ``worst_diffs``)."""
    from visiondk_tpu_torch.engine.state import gather_head, sharded_heads

    heads = sharded_heads(model)

    def whole(name, t):
        return gather_head(t, heads[name].num_class, heads[name].mesh) if name in heads else t

    params = {n: whole(n, p.detach()) for n, p in model.named_parameters()}
    tensors = {
        "gradient": {n: whole(n, p.grad.detach()).double().cpu() for n, p in model.named_parameters()},
        "update": {n: (params[n] - theta0[n]).double().cpu() for n in params},
        "BN statistic": {n: b.detach().double().cpu() for n, b in model.named_buffers() if n.endswith(("mean", "var"))},
    }
    return loss, tensors, {n: t.abs().max().item() for n, t in theta0.items()}


def dp_reference(case: tuple, batch: dict, dev) -> tuple:
    """The world-1 step of ``case`` on the whole batch (this process has no
    process group yet); SAM's per-rank form by hand: each half's ε from its
    own gradient, the two second gradients averaged, then the update."""
    from visiondk_tpu_torch.engine.optim import sam_perturb
    from visiondk_tpu_torch.engine.steps import apply_update

    _, model_cfg, loss, f64, step_kwargs = case
    model, state, step, tx, lossfn = dp_trainer(model_cfg, loss, f64, step_kwargs, dev)
    theta0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    images = batch["image"].double() / 255.0 if f64 else batch["image"]
    if "sam" not in step_kwargs:
        value = step(state, {**batch, "image": images})["loss"].item()
        return dp_outcome(model, state, value, theta0)
    cfg = StepConfig(**step_kwargs)
    params, rows = list(model.parameters()), DP_F32_BATCH // DP_WORLD
    model.train()
    second, losses = [torch.zeros_like(p) for p in params], []
    for r in range(DP_WORLD):
        x = device_preprocess(images[r * rows:(r + 1) * rows], cfg.mean, cfg.std)
        y = batch["label"][r * rows:(r + 1) * rows]
        for p in params:
            p.grad = None
        value = lossfn(model(x), y)
        value.backward()
        losses.append(value.item())
        clean = [p.detach().clone() for p in params]
        with torch.no_grad():
            torch._foreach_add_(params, sam_perturb(params, [p.grad for p in params], cfg.sam))
        for p in params:
            p.grad = None
        lossfn(model(x), y).backward()
        torch._foreach_add_(second, [p.grad for p in params])
        with torch.no_grad():
            torch._foreach_copy_(params, clean)
    for p, g in zip(params, second):
        p.grad = g / DP_WORLD
    apply_update(state, tx, cfg)
    return dp_outcome(model, state, sum(losses) / DP_WORLD, theta0)


def dp_collectives(dev, rank: int) -> dict:
    """Which collectives gloo runs on CUDA tensors here: each tried and its
    result checked."""
    import torch.distributed as dist

    x = torch.full((4,), float(rank + 1), device=dev)
    trials = {
        "all_reduce": lambda: (dist.all_reduce(t := x.clone()), bool((t == 3).all()))[1],
        "all_reduce max": lambda: (dist.all_reduce(t := x.clone(), op=dist.ReduceOp.MAX), bool((t == 2).all()))[1],
        "all_gather": lambda: (dist.all_gather(parts := [torch.empty_like(x) for _ in range(DP_WORLD)], x),
                               [int(p[0]) for p in parts] == [1, 2])[1],
        "broadcast": lambda: (dist.broadcast(t := x.clone(), src=1), bool((t == 2).all()))[1],
        "barrier": lambda: (dist.barrier(), True)[1],
    }
    out = {}
    for name in DP_COLLECTIVES:
        try:
            out[name] = "ok" if trials[name]() else "wrong result"
        except RuntimeError as e:  # what a backend raises for an unsupported device or op
            out[name] = f"refused ({str(e).splitlines()[0][:120]})"
    return out


def dp_rank(dev: torch.device) -> None:
    """``--dp-rank``: one of the two gloo ranks of phase DP, on ``dev``
    (cuda:0 for both; see phase_dp). Rank 0 first takes the world-1
    references, before the process group exists."""
    import torch.distributed as dist

    from visiondk_tpu_torch.config import yaml_load
    from visiondk_tpu_torch.engine.state import gather_head, sharded_heads
    from visiondk_tpu_torch.parallel import build_mesh, initialize_distributed

    rank = int(os.environ["RANK"])
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    cases = dp_cases()
    batches = [dp_batch(case[1], case[2], DP_F32_BATCH, dev, seed=7 + i) for i, case in enumerate(cases)]
    refs = [dp_reference(case, batch, dev) if rank == 0 else None for case, batch in zip(cases, batches)]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    initialize_distributed(backend="gloo")
    print(f"[dp] rank {rank}: gloo group of {dist.get_world_size()} joined ({time.perf_counter() - t0:.1f} s, "
          f"rank 0's world-1 references taken before it); collectives on CUDA tensors: {dp_collectives(dev, rank)}",
          flush=True)
    counts = {k: 0 for k in KERNELS}
    for case, batch, ref in zip(cases, batches, refs):
        label, model_cfg, loss, f64, step_kwargs = case
        mesh = build_mesh(model=2 if model_cfg["task"] != "classification" else 1)
        model, state, step, _, _ = dp_trainer(model_cfg, loss, f64, step_kwargs, dev, mesh)
        theta0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        for key, head in sharded_heads(model).items():
            theta0[key] = gather_head(theta0[key], head.num_class, mesh)
        rows = DP_F32_BATCH // DP_WORLD
        mine = {k: v[rank * rows:(rank + 1) * rows] for k, v in batch.items()}
        if f64:
            mine["image"] = mine["image"].double() / 255.0
        reset_counts()
        t = time.perf_counter()
        value = step(state, mine)["loss"].item()
        secs = time.perf_counter() - t
        counts = {k: counts[k] + v for k, v in read_counts().items()}
        side = dp_outcome(model, state, value, theta0)
        if rank == 0:
            loss_rel, worst = worst_diffs(side, ref, float32_spacing=not f64, floor_share=1e-9 if f64 else 1e-3)
            print(f"[dp] {label}: {'float64' if f64 else 'f32'} one step at global bs {DP_F32_BATCH} "
                  f"({rows} a rank, {secs:.2f} s), world 2 vs world 1: loss {side[0]!r} vs {ref[0]!r} (rel "
                  f"{loss_rel:.3e}, bar {F32_LOSS_RTOL}); worst max|diff|/max|ref| " + ", ".join(
                      f"{w} {r:.3e} ({n})" for w, (r, n) in worst.items()) + f" (bar {F32_TENSOR_TOL})", flush=True)
            check(loss_rel <= F32_LOSS_RTOL, f"[dp] {label}: loss {loss_rel} relative")
            for what, (r, n) in worst.items():
                check(r <= F32_TENSOR_TOL, f"[dp] {label}: {what} of {n} differs by {r} of its largest entry")
        del model, state, step
        torch.cuda.empty_cache()

    # face.yaml at full width in bf16: Swin-B (stochastic depth as configured) + ArcFace 58,671 x 128, m 2
    face = yaml_load(FACE_YAML)
    mesh = build_mesh(model=2)
    bs = face["data"]["train"]["bs"] // DP_WORLD
    model, state, step, _, _ = dp_trainer(face["model"], "ce", False, {"task": "embedding"}, dev, mesh,
                                          dtype=torch.bfloat16)
    batch = dp_batch(face["model"], "ce", bs, dev, seed=20 + rank)
    for _ in range(DP_WARMUP):
        step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.perf_counter()
    values = [step(state, batch)["loss"] for _ in range(DP_TIMED_STEPS)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) / DP_TIMED_STEPS * 1e3
    counts = {k: counts[k] + v for k, v in read_counts().items()}
    losses = [v.item() for v in values]
    (backbone, _), = face["model"]["backbone"].items()
    print(f"[dp] rank {rank}: face.yaml bf16 train step, {backbone} + ArcFace over {model.head.num_class} classes "
          f"(this rank's {model.head.weight.shape[1]} columns), feat {model.head.feat_dim}, global bs "
          f"{face['data']['train']['bs']} ({bs} a rank), "
          f"--model_parallel 2 over gloo on one card: {ms:.1f} ms a step over {DP_TIMED_STEPS} after "
          f"{DP_WARMUP} warm-up (host clock, synchronised; gloo moves every gradient bucket through host memory), "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; losses "
          + ", ".join(f"{x:.4f}" for x in losses), flush=True)
    check(all(math.isfinite(x) for x in losses), f"[dp] rank {rank}: non-finite face.yaml losses {losses}")
    del model, state, step
    torch.cuda.empty_cache()
    sharded_search(dev, rank)
    print("DP_COUNTS " + json.dumps({NAMES[k]: v for k, v in counts.items()}), flush=True)
    dist.destroy_process_group()


SG_SHAPE = (1024, 65_537, 128, 100)  # queries, gallery rows (one pad row over two ranks), dim, k


def sharded_search(dev: torch.device, rank: int) -> None:
    """Phase SG, on one of phase DP's gloo ranks (see the module doc)."""
    from visiondk_tpu_torch.parallel import build_mesh

    q, g, d, k = SG_SHAPE
    gen = torch.Generator().manual_seed(31)  # the same data on both ranks
    # a dominant opposing first coordinate (25 against a spread of about 1): every similarity negative, below a
    # zero-scored pad row's
    queries = F.normalize(torch.cat([5 * torch.ones(q, 1), 0.3 * torch.randn(q, d - 1, generator=gen)], 1), dim=1)
    gallery = F.normalize(torch.cat([-5 * torch.ones(g, 1), 0.3 * torch.randn(g, d - 1, generator=gen)], 1), dim=1)
    queries, gallery = queries.numpy(), gallery.numpy()
    mesh = build_mesh()
    one_s, one_i = retrieval.search(queries, gallery, k, device=dev)
    t = time.perf_counter()
    s, i = retrieval.search(queries, gallery, k, device=dev, mesh=mesh)
    secs = time.perf_counter() - t
    approx_s, approx_i = retrieval.search(queries, gallery, k, device=dev, mesh=mesh, recall_target=0.95)
    held = mesh.data_gather(torch.from_numpy(np.concatenate([i, approx_i], axis=1)).to(dev))
    same = torch.equal(held[0], held[1])
    recall = float(np.mean([len(set(a) & set(b)) / k for a, b in zip(approx_i, one_i)]))
    shard = -(-g // mesh.n_data)
    print(f"[dp] rank {rank}: sharded search ({mesh.n_data} shards of {shard} rows, {shard * mesh.n_data - g} pad "
          f"row; {q} queries x {g} x {d}, k {k}, every similarity negative: {bool((one_s < 0).all())}): exact indices "
          f"equal to the one-process search's {np.array_equal(i, one_i)}, max |score diff| "
          f"{np.abs(s - one_s).max():.3e}, {secs:.2f} s (host clock, gloo on one card); recall target 0.95 "
          f"({retrieval.approx_reduction_size(shard, k, 0.95)} bins a shard): mean recall@{k} against exact {recall:.6f}; "
          f"both ranks hold the same answers {same}", flush=True)
    check(bool((one_s < 0).all()) and np.array_equal(i, one_i) and np.abs(s - one_s).max() <= SEARCH_TOL and same,
          f"[dp] rank {rank}: the sharded search disagrees")


def phase_dp(dev: torch.device) -> dict:
    """Phase DP (see the module doc): the two gloo ranks, then ViT-B/16's
    DDP train rate beside the plain step's on one NCCL rank in this process.
    Returns the launches of both."""
    import torch.distributed as dist

    from visiondk_tpu_torch.parallel import build_mesh, initialize_distributed

    tmp = Path(tempfile.mkdtemp(prefix="vdk_dp_"))
    try:
        port, procs = free_port(), []
        for rank in range(DP_WORLD):
            env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "WORLD_SIZE": str(DP_WORLD),
                   "RANK": str(rank), "LOCAL_RANK": "0"}
            log = open(tmp / f"rank{rank}.log", "w")
            procs.append((subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dp-rank"], env=env,
                                           stdout=log, stderr=subprocess.STDOUT), log))
        deadline = time.monotonic() + DP_TIMEOUT_S
        try:
            for proc, _ in procs:
                proc.wait(timeout=max(deadline - time.monotonic(), 1))
        finally:
            for proc, log in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
        counts = {k: 0 for k in KERNELS}
        for rank, (proc, _) in enumerate(procs):
            out = (tmp / f"rank{rank}.log").read_text()
            print("\n".join(line for line in out.splitlines() if line.startswith("[dp]")))
            check(proc.returncode == 0, f"[dp] rank {rank} exited with {proc.returncode}: {out[-3000:]}")
            found = json.loads(re.search(r"^DP_COUNTS (.*)$", out, re.M).group(1))
            counts = {k: counts[k] + found[NAMES[k]] for k in KERNELS}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # one NCCL rank here: ViT-B/16 bs 128 bf16, the DDP step against the plain one
    saved = {k: os.environ.get(k) for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), WORLD_SIZE="1", RANK="0", LOCAL_RANK="0")
    try:
        initialize_distributed(backend="nccl")
        gen = torch.Generator(device=dev).manual_seed(3)
        batch = {"image": torch.randint(0, 256, (BATCH, IMG, IMG, 3), generator=gen, device=dev, dtype=torch.uint8),
                 "label": torch.randint(0, VIT.model["num_classes"], (BATCH,), generator=gen, device=dev)}
        plain = build_trainer(VIT, torch.bfloat16, dev)
        ddp = build_trainer(VIT, torch.bfloat16, dev, mesh=build_mesh())
        rates = {"plain": [], "DDP": []}
        reset_counts()
        for trial, (which, (model, state, step)) in enumerate(
                (("plain", plain), ("DDP", ddp), ("DDP", ddp), ("plain", plain))):
            rates[which].append(train_rate(model, state, step, batch, KERNEL_PATH,
                                           f"[dp] ViT-B/16 bf16 bs {BATCH} trial {trial}, {which} step"
                                           + (" (one NCCL rank)" if which == "DDP" else ""))[0])
        found = read_counts()
        counts = {k: counts[k] + found[k] for k in KERNELS}
        print(f"[dp] ViT-B/16 bf16 bs {BATCH} train images/s (order plain, DDP, DDP, plain): DDP over one NCCL rank "
              + ", ".join(f"{r:.1f}" for r in rates["DDP"]) + " | plain " + ", ".join(f"{r:.1f}" for r in rates["plain"])
              + f" -> DDP at {sum(rates['DDP']) / sum(rates['plain']):.1%} of the plain step")
        del plain, ddp
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        torch.cuda.empty_cache()
    return counts


def main() -> None:
    phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    # one CPU core each, in the background until the run loops
    data = [start_synth_face(), start_synth_pet()]
    try:
        kern, launches = run_phases(dev, *data)
    finally:
        for tmp, proc, _ in data:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            shutil.rmtree(tmp, ignore_errors=True)
    print(f"[time] all phases: {time.perf_counter() - t0:.1f} s")
    # the two JSON lines end the output: nothing may print after them
    report(kern, launches)


def timed(name: str, fn, *args):
    """``fn(*args)``, with the phase's seconds printed."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        print(f"[time] {name}: {time.perf_counter() - t0:.1f} s")


def run_phases(dev: torch.device, face_data: tuple, pet_data: tuple) -> tuple[dict, dict]:
    timed("build", phase_build)
    kern = {**timed("kernel", phase_kernel, dev), **timed("window kernel", phase_window_kernel, dev),
            **timed("vision kernel", phase_vision_kernel, dev)}
    launches = {k: 0 for k in KERNELS}
    for recipe in (VIT, SWIN, SWINV2):
        serving = timed(recipe.tag, phase_slice, dev, recipe)
        training = timed(recipe.train_tag, phase_train, dev, recipe)
        timed(f"profile {recipe.model['name']}", phase_profile, dev, recipe)
        print(f"[launches] {recipe.model['name']} serving (bf16" + (", int8 and the f32 CAMs" if recipe in Q8_RECIPES
                                                                    else "") + "): "
              + ", ".join(f"{NAMES[k]} {serving[k]}" for k in recipe.kernels if serving[k]) + "; training: "
              + ", ".join(f"{NAMES[k]} {training[k]}" for k in recipe.kernels))
        launches = {k: launches[k] + serving[k] + training[k] for k in KERNELS}
    timed("profile embedding", phase_profile_embedding, dev)
    timed("margin heads", phase_margin_heads, dev)
    timed("device augment", phase_device_augment, dev)
    timed("cnn", phase_cnn, dev)
    run_loop = timed("run loop", phase_run_loop, dev, pet_data)
    print("[launches] run loop: " + ", ".join(f"{NAMES[k]} {run_loop[k]}" for k in K1_KERNELS))
    probe = start_determinism_probe()
    try:
        timed("multilabel run", phase_multilabel_run, dev, pet_data)
        distill = timed("distill", phase_distill, dev, pet_data)
    finally:
        timed("determinism probe (the rest of it)", finish_determinism_probe, probe)
    print("[launches] distill (teacher runs A, B; distill runs A, B): "
          + ", ".join(f"{NAMES[k]} {distill[k]}" for k in wattn.KERNELS))
    swinv2_run = timed("swinv2 run", phase_swinv2_run, dev, pet_data)
    print("[launches] swinv2 run (runs A, B; validate): "
          + ", ".join(f"{NAMES[k]} {swinv2_run[k]}" for k in wattn.KERNELS))
    large = timed("swinv2 large", phase_swinv2_large, dev)
    print("[launches] swinv2 large serving and training: " + ", ".join(f"{NAMES[k]} {large[k]}" for k in wattn.KERNELS)
          + "; of them on ws-16 windows: " + ", ".join(f"{NAMES[k]} {LARGE_LAUNCHES.get(k, 0)}" for k in wattn.KERNELS))
    large_run = timed("swinv2 large run", phase_swinv2_run, dev, pet_data, SWINV2_LARGE, "swinv2 large run",
                      V2L_WS16_BLOCKS)
    print("[launches] swinv2 large run (runs A, B; validate): " + ", ".join(
        f"{NAMES[k]} {large_run[k]}" for k in wattn.KERNELS) + "; all three and earlier, on ws-16 windows: "
        + ", ".join(f"{NAMES[k]} {LARGE_LAUNCHES.get(k, 0)}" for k in wattn.KERNELS))
    so400m = timed("so400m", phase_so400m, dev)
    so400m_run = timed("so400m run", phase_so400m_run, dev, pet_data)
    print("[launches] so400m serving and training: " + ", ".join(f"{NAMES[k]} {so400m[k]}" for k in K1_KERNELS)
          + "; so400m run (runs A, B; validate): " + ", ".join(f"{NAMES[k]} {so400m_run[k]}" for k in K1_KERNELS))
    strategies = timed("strategies", phase_strategies, dev, pet_data)
    print("[launches] strategies (runs A, B, C's resume; validate): "
          + ", ".join(f"{NAMES[k]} {strategies[k]}" for k in K1_KERNELS))
    embedding_run = timed("embedding run", phase_embedding_run, dev, face_data)
    print("[launches] embedding run: " + ", ".join(f"{NAMES[k]} {embedding_run[k]}" for k in wattn.KERNELS))
    launches = {k: launches[k] + run_loop[k] + distill[k] + swinv2_run[k] + large[k] + large_run[k] + so400m[k]
                + so400m_run[k] + strategies[k] + embedding_run[k] for k in KERNELS}
    vision = timed("vision path", phase_vision_path, dev)
    print("[launches] vision path: " + ", ".join(f"{NAMES[k]} {vision[k]}" for k in K3_KERNELS))
    dp = timed("dp", phase_dp, dev)
    print("[launches] dp (the world-2 steps of both gloo ranks; the one-NCCL-rank DDP and plain trials): "
          + ", ".join(f"{NAMES[k]} {dp[k]}" for k in KERNELS if dp[k]))
    return kern, {k: launches[k] + vision[k] + dp[k] for k in KERNELS}


def swin_train_trials(dev: torch.device, trials: int = 3) -> None:
    """The Swin-B bf16 train step (bs 80, kernel path with the P stash)
    alone: ``trials`` timed trials, then its device time by kernel class,
    then the bf16 one-step comparison with the plain path. It uses nothing
    but the package's public API, so running this file's function against
    another tree's package (``python3 -c "import runpy, sys; sys.argv =
    ['chip_smoke.py', '--swin-train-trials']; runpy.run_path('<this
    file>', run_name='__main__')"`` from that tree's root) A/Bs two trees
    on one card."""
    gen = torch.Generator(device=dev).manual_seed(3)
    bs = SWIN.train_batch
    batch = {
        "image": torch.randint(0, 256, (bs, IMG, IMG, 3), generator=gen, device=dev, dtype=torch.uint8),
        "label": torch.randint(0, SWIN.model["num_classes"], (bs,), generator=gen, device=dev),
    }
    model, state, step = build_trainer(SWIN, torch.bfloat16, dev)
    os.environ.pop("VDK_ATTN_NO_PCACHE", None)
    for trial in range(trials):
        train_rate(model, state, step, batch, KERNEL_PATH, f"[swin trials] bf16 bs {bs} trial {trial}, kernel path")
    split, attention = device_split(lambda: step(state, batch), steps=3)
    print(f"[swin trials] device busy {sum(split.values()):.2f} ms per step: "
          + ", ".join(f"{label} {ms:.2f}" for label, ms in split.items())
          + "; attention kernels: " + ", ".join(f"{k} {ms:.2f}" for k, ms in sorted(attention.items())))
    del model, state, step
    torch.cuda.empty_cache()
    compare_one_step(SWIN, torch.bfloat16, dev, batch, tag="swin trials")


# Variants of the tiled bf16 window kernels that were tried and dropped, each a few lines' edit of the
# committed source: (library, label, [(committed text, variant text), ...])
TILED_VARIANTS = (
    ("fused_window_attention", "exp2f in place of ex2.approx.ftz",
     [("s[j][e] = wtc::exp2_ftz(s[j][e] - mx[e >> 1]);", "s[j][e] = exp2f(s[j][e] - mx[e >> 1]);")]),
    ("fused_window_attention", "no __syncwarp() fences in the products",
     [("          if ((np & 3) == 3) __syncwarp();  // keeps ptxas from hoisting every step's loads\n", ""),
      ("        if ((kk & 3) == 3) __syncwarp();\n", "")]),
    ("fused_window_attention_bwd", "no __syncwarp() fences (dq, dkv from P)",
     [("      __syncwarp();  // keeps ptxas from hoisting every step's loads (255 registers and spills without)\n", ""),
      ("pa[kk], vs, lanes, kk);\n        __syncwarp();\n", "pa[kk], vs, lanes, kk);\n"),
      ("        }\n        __syncwarp();\n      }\n#pragma unroll\n      for (int r = 0; r < 2; ++r) dlt[r] =",
       "        }\n      }\n#pragma unroll\n      for (int r = 0; r < 2; ++r) dlt[r] ="),
      ("        tile(qc);\n        __syncwarp();\n", "        tile(qc);\n")]),
    ("fused_window_attention_bwd", "dkv recomputing unrolled whole, dkv from P in pairs",
     [("#pragma unroll 2\n      for (int qc = 0; qc < kQ / 16; ++qc) tile(qc);",
       "#pragma unroll\n      for (int qc = 0; qc < kQ / 16; ++qc) tile(qc);"),
      ("#pragma unroll\n      for (int qc = 0; qc < kQ / 16; ++qc) {\n        tile(qc);",
       "#pragma unroll 2\n      for (int qc = 0; qc < kQ / 16; ++qc) {\n        tile(qc);")]),
    ("fused_window_attention_bwd", "delta through a split P . V when recomputing (as from P)",
     [("    if (active && kRecompute) {", "    if (false) {"),
      ("        wtc::accumulate<DP, false>(o[kk & 1], pa[kk], pa[kk], vs, lanes, kk);\n",
       "        if (kRecompute) {\n          uint32_t hi[4], lo[4];\n"
       "          a_from_c_split(hi, lo, s[2 * kk], s[2 * kk + 1]);\n"
       "          wtc::accumulate<DP, true>(o[kk & 1], hi, lo, vs, lanes, kk);\n"
       "        } else {\n          wtc::accumulate<DP, false>(o[kk & 1], pa[kk], pa[kk], vs, lanes, kk);\n        }\n")]),
)


def build_variant(name: str, label: str, edits) -> "_build.Built":
    """The committed csrc/<name>.cu with ``edits`` applied, built as _build
    builds it into a directory of its own under the build directory."""
    out = _build.BUILD_DIR / "variants" / re.sub(r"\W+", "_", f"{name}_{label}")
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for header in _build.CSRC_DIR.glob("*.cuh"):
        shutil.copy(header, out)
    text = (_build.CSRC_DIR / f"{name}.cu").read_text()
    for old, new in edits:
        check(text.count(old) == 1, f"variant {label!r}: its edit does not match {name}.cu once: {old[:60]!r}")
        text = text.replace(old, new)
    (out / f"{name}.cu").write_text(text)
    lib = out / f"lib{name}.so"
    t0 = time.perf_counter()
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(out / f"{name}.cu")], check=True,
                   capture_output=True, timeout=600)
    return _build.Built(lib=ctypes.CDLL(str(lib)), path=lib, command=[], seconds=time.perf_counter() - t0,
                        ptxas_log="")


def tiled_variants(dev: torch.device) -> None:
    """Each variant of TILED_VARIANTS against the committed kernels at
    SwinV2-L stage 0 (bf16, the timed WINDOW16_CASES row): CUDA-event ms in the
    order committed, variant, variant, committed, one process and one card."""
    names = ("fused_window_attention", "fused_window_attention_bwd")
    with ThreadPoolExecutor(len(names) + len(TILED_VARIANTS)) as pool:
        committed = dict(zip(names, pool.map(_build.build, names)))
        variants = list(pool.map(lambda v: build_variant(*v), TILED_VARIANTS))
    name, b, hw, h, c, ws, shift, scale, _ = WINDOW16_CASES[0]
    n = ws * ws
    gen = torch.Generator(device=dev).manual_seed(4)
    ids = torch.from_numpy(window_region_ids(hw, hw, ws, shift)).to(dev)
    qkv = torch.randn((b, hw, hw, 3 * c), generator=gen, device=dev).to(torch.bfloat16)
    dout = torch.randn((b, hw, hw, c), generator=gen, device=dev).to(torch.bfloat16)
    bias = 0.5 * torch.randn((h, n, n), generator=gen, device=dev)
    kf, ks, kb, kr = wattn.KERNELS
    _, p = ks(qkv, bias, ids, h, scale, shift)
    calls = {"fused_window_attention": {kf: lambda: kf(qkv, bias, ids, h, scale, shift),
                                        ks: lambda: ks(qkv, bias, ids, h, scale, shift)},
             "fused_window_attention_bwd": {kb: lambda: kb(qkv, p, dout, h, scale, shift),
                                            kr: lambda: kr(qkv, bias, ids, dout, h, scale, shift)}}
    for (lib, label, _), built in zip(TILED_VARIANTS, variants):
        for k, fn in calls[lib].items():
            ms = []
            for which in (committed[lib], built, built, committed[lib]):
                _build._loaded[lib] = which
                ms.append(cuda_ms(fn, iters=10))
            _build._loaded[lib] = committed[lib]
            print(f"[tiled variants] {name} bf16 {NAMES[k]}: committed {ms[0]:.4f}, {ms[3]:.4f} ms | {label}: "
                  f"{ms[1]:.4f}, {ms[2]:.4f} ms (order committed, variant, variant, committed)")


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
    for k, (tag, row) in WS16_ROWS.items():
        print(f"[bound ws16] {NAMES[k]} at {tag}: {row['bytes'] / 1e6:.1f} MB, {row['flops'] / 1e9:.2f} GFLOP -> bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']}; kernel {row['ms']:.4f} ms = "
              f"{row['bound_ms'] / row['ms']:.2%} of bound; plain {row['plain_ms']:.4f} ms; library "
              f"{'none' if row['library_ms'] is None else format(row['library_ms'], '.4f') + ' ms'}; max|err| "
              f"{row['max_abs_err']:.3e}; launches on ws-16 windows on the main paths {LARGE_LAUNCHES.get(k, 0)}")
    for k, (tag, row) in SO_ROWS.items():
        print(f"[bound so400m] {NAMES[k]} at {tag}: {row['bytes'] / 1e6:.1f} MB, {row['flops'] / 1e9:.2f} GFLOP -> "
              f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}; kernel {row['ms']:.4f} ms = "
              f"{row['bound_ms'] / row['ms']:.2%} of bound; plain {row['plain_ms']:.4f} ms; library "
              f"{'none' if row['library_ms'] is None else format(row['library_ms'], '.4f') + ' ms'} (kernel / library "
              f"{'-' if row['library_ms'] is None else format(row['ms'] / row['library_ms'], '.2f')}); max|err| "
              f"{row['max_abs_err']:.3e}; launches on the So400m paths {SO_LAUNCHES.get(k, 0)}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:] == ["--swin-train-trials"]:
        phase_device()
        torch.cuda.set_device(0)
        swin_train_trials(torch.device("cuda", 0))
    elif sys.argv[1:] == ["--determinism-probe"]:
        determinism_probe()
    elif sys.argv[1:] == ["--dp-rank"]:
        dp_rank(torch.device("cuda", 0))
    elif sys.argv[1:] == ["--tiled-variants"]:
        phase_device()
        torch.cuda.set_device(0)
        tiled_variants(torch.device("cuda", 0))
    else:
        main()
