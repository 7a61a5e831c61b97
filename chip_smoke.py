#!/usr/bin/env python3
"""Runs the PyTorch / CUDA port of EgoNN (inference, the training step and
loop, evaluation, data parallel), of MinkLoc (inference) and of ResNet14
(inference) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; one CUDA card, nvcc
    python3 chip_smoke.py bf16   # phases 1-3, 3b and 5b alone (bf16 activations)

Phases, each printing its lines:

1. environment: the card (nvidia-smi name and power limit) and the build of
   the CUDA kernels from `egonn_tpu_torch/csrc`, with ptxas's registers and
   spills per kernel (its report is kept beside each library, so a cached
   build reports them too); a spill in gather_conv, tdown or gather_dw fails.
   The Hopper bf16 bodies (gather_mm_sm90_kernel, gather_dw_sm90_kernel)
   must be in the build with their ptxas lines, and where the toolkit has
   cuobjdump their SASS must hold wgmma (HGMMA); their mbarrier (SYNCS),
   cp.async (LDGSTS) and TMA (UTMALDG) instructions are counted.
2. kernels: one EgoNN forward at full width (8 LiDAR clouds x 65,536 points,
   cap0 16384, weights from a seeded generator) records every kernel call's
   inputs; each call is then held against the kernel's plain PyTorch version
   on the card (integers bit-equal, floats within rel 1e-5: the conv kernels
   multiply in split TF32, f32 accuracy) and each distinct call shape is
   timed with CUDA events (median of 20 runs, each queued behind a sleep
   kernel so host overhead is not counted), beside its bound (bytes over 3.35
   TB/s or operations over the type's peak rate, whichever is larger; f32
   67 TFLOP/s for the float kernels), for gather_conv, tdown and gather_dw
   also `tc_bound_ms` (bytes, or three TF32 MMAs per product at 495 TFLOP/s),
   and one PyTorch library call where one computes the same function.  Each
   conv / dW call shape prints a line with its levels (L<in>->L<out>), rows,
   offsets and widths; a tdown line adds the fine rows its blocks stream
   (each coarse tile's hull) against the children, a zrun line the blocks
   whose table slice overflowed shared memory (0 expected).  The stem
   (stem_ones) is timed beside its plain form's GEMM alone as its library
   call; the transposed conv (tconv) beside its all-slot form's GEMM alone.
   The largest gather_conv, tdown, zrun_rank, stem_ones and tconv calls are
   re-run twice and must be bit-equal.
3. slice: the same forward with every launch counter zeroed just before and
   read just after (zrun_presence 1, zrun_rank 7, gather_conv 14, tdown 7,
   stem_ones 1, tconv 3, slot_order 3 expected); output shapes, finiteness, capacity report.
   Then 2 clouds on the card and on the CPU with the same weights: from one
   shared quantization every pyramid map must be bit-equal and the outputs
   within the tolerances of tests/test_torch_model.py; from independent
   quantizations the voxel mismatch rate (atan2 may differ by an ulp) is
   reported.  Last, clouds/s over 10 forwards on varied inputs (host clock;
   `python -m egonn_tpu_torch.profile_forward` splits a forward's device time).
3b. bf16 forward: the same forward with EGONN_BF16_ACTS=1 (set by the
   phase alone, every other phase runs f32 activations): launches 1 / 7 /
   14 / 7 / 1 (zrun_presence / zrun_rank / gather_conv_bf16 / tdown_bf16 /
   stem_ones: the stem sums in f32 either way), no f32 conv launch; every
   bf16 gather_conv and tdown call held against its bf16 plain version
   (within one bf16 ulp, or 1e-6 x max |plain| near 0) and timed as in
   phase 2 beside the split-TF32 kernel on the same call in f32 and
   (gather_conv) the SM80 bf16 body on the same call, its bound at 2
   bytes a feature element or one bf16 MMA per product at 989 TFLOP/s; the
   launches by body (`kernels.conv_body` picks the Hopper or the SM80 one per
   call: the Hopper body must launch); the largest call of each re-run and
   two more forwards
   bit-equal; 2 clouds on the card and on the CPU (bf16 forced there) from
   one shared quantization: `global`, descriptors, keypoints and sigma
   within 3e-2 of max |CPU| (tests/test_banded.py's bf16 rule), every
   output's type the CPU run's; clouds/s (medians of 6 turns of 10
   forwards, in rounds f32 / bf16 / bf16 / f32), peak memory of the bf16
   forward beside f32's, max |bf16 - f32| of `global`.
4. train kernels: the training parameters of config/config_egonn.txt +
   model_configs/egonn.txt (batch 32, local batch 8, Adam lr 1e-3, weight
   decay 1e-4, aug_mode 2), a full-width batch (16 places x 2 scans of
   65,536 points, 8 cloud pairs under seeded rigid transforms, each local
   cloud one point per voxel) and one training step with every kernel call
   recorded; each call held against its plain version (gather_dw within
   1e-4 x max |plain|: it sums up to 32 x 16,384 rows per weight in another
   order) and each distinct shape timed as in phase 2 (median of 10); the
   largest gather_dw call re-run twice, bit-equal.
5. train slice: 1 warm-up step, then 5 train steps, each with the launch
   counters zeroed before and read after (TRAIN_STEP_LAUNCHES), and 1
   validation step (VAL_STEP_LAUNCHES) that must leave the model and the
   optimizer untouched; finite stats; every parameter and BN statistic
   moved.  Every kernel call of one more validation step (three eval
   forwards, tdown's largest user) is held against its plain version and
   timed as in phase 4: the `val_step` path.  Train steps/s and clouds/s (host clock, 48 clouds a step) and the
   peak device memory.  Then one step on 4 global clouds and 2 pairs on the
   card and on the CPU from the same weights, augmentation off, points at
   voxel centres (so both build the same pyramids): stats within rel 1e-4,
   every gradient within 1e-2 of the leaf's max |grad| and 2e-3 of its l2
   norm (ReLU branches and argmin matches flip on near-ties), the BN
   statistics within rel 1e-4, and on each side the first Adam update equal
   to its closed form within 1e-6.
5b. bf16 train step: phases 4-5's batch and step with EGONN_BF16_ACTS=1
   (set by the phase alone): activations and their cotangents bf16, every
   conv, dX and dW on the bf16 kernels (BF16_TRAIN_STEP_LAUNCHES per train
   step, BF16_VAL_STEP_LAUNCHES per validation step: no split-TF32 conv or
   dW launch); every kernel call of one train step and one validation step
   held against its plain version (the bf16 convs within one bf16 ulp,
   gather_dw_bf16 within 1e-4 x max |plain|: both sum exact products in
   f32) and each distinct shape timed (median of 10), the train step's conv
   and dW calls and the validation step's tdown calls beside the
   split-TF32 kernels on the same calls cast to f32 and the conv and dW
   calls beside the SM80 bf16 bodies on the same calls (the
   `bf16_train_step` and `bf16_val_step` paths), with the launches by body
   (the Hopper bodies must launch); the largest gather_dw_bf16 and
   gather_conv_bf16 calls re-run twice, bit-equal; phase 5's card vs CPU
   step with bf16 forced on the CPU:
   stats and BN statistics within BF16_REL_TOL, gradients by
   `bf16_grad_check` (the rule tests/test_torch_bf16_train.py measured),
   f32 gradients, each side's first Adam update its closed form; train
   steps/s and peak memory of the bf16 step beside the f32 step's in
   BF16_TRAIN_ROUNDS rounds f32 / bf16 / bf16 / f32.  Then `do_train`
   under the flag: one step at bucket LOOP_BUCKET on phase 10's set beside
   the f32 step on the same batch (launches, peak memory), and
   BF16_LOOP_EPOCHS epochs checkpointed every epoch (only bf16 conv and dW
   launches), resumed from a copy of the epoch-1 checkpoint: parameters,
   BatchNorm statistics and Adam's state f32 and bit-equal to the
   uninterrupted run's.  Numbers under "bf16_train".
6. MinkLoc and lookup.  (a) Phase 2's 8 clouds and EgoNN spec with no up
   maps recorded: one launch of the lookup kernel in down mode
   (`kernels.lookup_down`, the queries formed in the kernel) builds
   kmap_down at L1-L7 (launches LOOKUP_MAPS_LAUNCHES); every map equals the
   inverted up map of the standard pyramid, every kernel call of that
   pyramid is held against its plain version (`lookup_down_plain`: the
   queries in torch ops, then `lookup_plain` per level) and timed (library:
   `torch.searchsorted` per level on the same tables and the formed
   queries, which gives the rank only), the grouped call is re-run
   bit-equal, and its blocks whose table run overflowed shared memory are
   counted (0 expected; the result is exact either way).  Lookup calls
   print two bounds: the fused form's (coarse keys and table in, positions
   out) and the TPU kernel's (table and queries in, positions out).  (b) The MinkFPN model of
   model_configs/minkloc3d_mulran.txt through `model_factory` at its
   published widths (cartesian 0.3 m, planes 32/64/64, one top-down step,
   ECA blocks, GeM, 256-d), seeded weights, cap0 40960 (every level fits),
   on 8 x 65,536 points, twice: on the factory pyramid (MINKLOC_LAUNCHES)
   and on one that records only level 2's up map, so the L1 and L2 down
   convs gather over lookup-built maps (MINKLOC_LOOKUP_LAUNCHES).  Both give
   `global` (8, 256), finite and equal (rel <= 1e-6); every kernel call of
   both is held against its plain version and timed (median of 10).  Then 2
   clouds on the card and on the CPU from one shared quantization, each
   pyramid: maps bit-equal, `global` within rel 1e-5.  Last, clouds/s of
   each pyramid (host clock): the median of 20 turns of 10 forwards on
   varied inputs, the two pyramids in alternation.  The lookup pyramid's
   grouped lookup call is re-run bit-equal.
7. wide: gather_conv at (256, 256) and (512, 512) with K = 27 and at
   (256, 512) with K = 8, gather_dw at (256, 256) and (512, 512) with K = 27,
   on seeded ResNet-like inputs (4 clouds of capacity 4,096, 3,000 voxels,
   40% of the neighbours present): held against the plain versions, re-run
   bit-equal, timed (median of 10).  Then the widths the kernels take only
   through the wrappers' width plan (zero padding, 512-wide splits):
   gather_conv at F_in 1 (K 125) and 3 (K 27), F_out 48, 1024 -> 1024 at
   K = 8 (ResNet50's stage-4 down conv), gather_dw at 1024, tdown at F_out
   48.  Not in the kernels line's sums: they go to build/chip_smoke.json
   under "wide".
8. ResNet14 (`models/resnet.py`: BasicBlock, planes 64/128/256/512,
   init_dim 64, in_channels 1, 5^3 stem), seeded weights, on phase 2's 8
   clouds through the cartesian 0.3 m quantizer of
   model_configs/minkloc3d_mulran.txt, capacities RESNET_CAPACITIES (every
   level fits), each voxel's one feature its centre's z (so the stem's
   F_in = 1 runs through the width plan): capacity report, launches
   RESNET_LAUNCHES (L1-L4's down maps in one lookup launch), level outputs
   finite, every kernel call held against its plain version and timed
   (median of 10), the grouped lookup re-run bit-equal; 2 clouds on the
   card and on the CPU from one shared quantization: pyramids bit-equal,
   each level's output within rel 1e-5; clouds/s (host clock, median of
   RESNET_ROUNDS turns of 10 forwards on varied inputs, quantization
   included).
9. eval: the JAX package's synthetic dataset (64 scans, seed 0: 32 map and
   32 query scans of ~6k points after ground removal, padded to 65,536),
   written into build/eval_synth by the port's generator; EgoNN from
   model_configs/egonn.txt (cap0 16384), seeded weights with seeded
   BatchNorm statistics.  GLEvaluator (n_k 128 and 256, 1,024 hypotheses):
   launches of the whole evaluation (each embedding batch 1/7/14/7/1/3/3, plus the
   capacity check's pyramid), the recall at 5 and 20 m, the 6DoF metrics,
   t_ransac; one embedding batch's launches and every kernel call of it
   against its plain version and timed (the `eval` path); embedding
   clouds/s (host clock, loading and padding included).  The global-only
   Evaluator (same top1_ndx) and RotationEvaluator at 0 / 90 / 180 deg (0
   gives the Evaluator's recall).  Card vs CPU on the debug subset (4 + 4
   scans): embeddings within tests/test_torch_model.py's tolerances after
   aligning near-tie swaps of the sigma order, top1_ndx equal, RANSAC from
   one set of draws (transforms within 1e-4, counts equal); clouds whose
   level-0 voxels differ are reported and excluded.  RANSAC on 32
   known-transform pairs (K 256, 128-d, a quarter outliers, yaw to 180 deg,
   10 m) at 1,024 and 10,240 hypotheses: RTE < 0.1 m and RRE < 0.5 deg,
   card vs CPU from one set of draws, CUDA-event times and the batched 3x3
   SVD's alone.  Capacity calibration on the evaluator's 16-scan sample,
   card equal to CPU.  topk_l2 on 4,096 x 2,048 256-d embeddings against a
   float64 brute force (near-ties counted), timed.  Numbers under "eval" in
   build/chip_smoke.json.
10. train loop: `do_train` (`train/trainer.py`, the training entry point)
   with config/config_egonn.txt + model_configs/egonn.txt at full width
   (batch 32, local batch 8, aug_mode 2, cap0 16384, 65,536 points) on a
   synthetic set of LOOP_SCANS scans (144 train, 48 validation, ~6k
   points a scan) written by the port's generator into build/train_synth,
   with test_file set.  First one train step each at bucket 32 and at
   bucket 128 (the largest of batch expansion: 128 global clouds + 8
   pairs): launches TRAIN_STEP_LAUNCHES and the peak device memory; on
   the bucket-32 batch the host's batch assembly alone and a step's host
   time alone and beside a thread assembling batches (the Prefetcher's
   competition for the interpreter), and the same step twice from one
   state: gradients bit-equal, and every aten op's inputs and outputs
   checksummed to name the ops whose outputs differ from equal inputs
   (where the steps differ, again under torch.use_deterministic_algorithms).
   Run (a): LOOP_EPOCHS epochs, checkpoints every LOOP_SAVE_FREQ, every
   launch counter zeroed before and read after (each kernel of the loop
   launched); the loop's first train and validation steps (the validation
   batch has 52 clouds in a bucket of 61: padding rows) launch exactly
   TRAIN_STEP_LAUNCHES and VAL_STEP_LAUNCHES and every kernel call of the
   two is held against its plain version and timed (the `train_loop`
   path); every epoch's stats finite, checkpoints at 5 and 10, 10 epoch
   lines and one in-training evaluation (epoch 10, its Recall@1) in the
   metrics JSONL; steps/s and clouds/s of the train phases of epochs 2-10
   (host clock, loading included) beside phase 5's bare step, the loop's
   wait for the Prefetcher and copy time per step, seconds per epoch, the
   evaluation's seconds.  Run (b): resumed from a copy of (a)'s epoch-5
   checkpoint in a fresh directory to epoch 10: parameters, BatchNorm
   statistics and Adam's state bit-equal to (a)'s.  Numbers under
   "train_loop".
11. data parallel (`parallel/mesh.py`): DP_WORLD ranks over NCCL need as
   many cards and the machine has one, so (a) DP_WORLD gloo ranks share
   cuda:0 (spawned by `run_ranks`; this process is rank 0).  Each builds
   phase 4's model (BatchNorms perturbed as in phase 9) and takes its rows
   of phase 5's batch (16 of the 32 global clouds, 4 of the 8 pairs): one
   validation step, then one train step with augmentation drawn for the
   whole batch from a generator seeded SEED, against the same two steps
   of one process on the card from the same weights: stats within rel
   1e-4 (JAX's sharded-vs-unsharded bound, tests/test_multichip.py),
   gradients within 1e-2 / 2e-3 of the leaf's max / l2 (known difference
   9); parameters, BatchNorm statistics, Adam's state and gradients
   bit-equal across the ranks; each rank's launches TRAIN_STEP_LAUNCHES
   and VAL_STEP_LAUNCHES; rank 0's kernel calls of both steps held against
   their plain versions and timed (the `dp` path); the collectives per
   step with their bytes, each rank's host ms over DP_TIMED_STEPS more
   steps, the global step rate beside the 1-process step's, and peak
   memory per rank.  (b) A 1-rank NCCL group runs the same steps: the NCCL
   collectives on CUDA tensors, bit-equal to the 1-process steps.  (c) The
   evaluation of phase 9's set sharded over DP_WORLD gloo ranks: recalls
   and top-1 equal to the unsharded ones, phase 9's embedding batch
   `global` within JAX's sharded-vs-unsharded embedding bound (rtol 2e-4,
   atol 2e-5), launches per rank GLOBAL_EVAL_BATCH_LAUNCHES.  (d) `do_train`
   on a mesh of DP_WORLD (gloo, one card) for DP_EPOCHS epochs on phase 10's
   set against one process with the same buckets and draws, both at lr
   DP_LR (known difference 20): every epoch stat within rel 1e-4; only rank
   0 writes the checkpoint and the metrics log.  A rank that fails or does
   not end within DP_TIMEOUT_S fails the phase.  Numbers under
   "data_parallel".

The last three lines are the card's name and power limit, one JSON object
with every kernel's numbers (summed over the calls of all the paths: the
inference forward, the bf16 forward (the rows gather_conv_bf16 and
tdown_bf16), the training step, the validation step, the bf16 training
and validation steps (the row gather_dw_bf16), the pyramid
without up maps, the two MinkLoc forwards, the ResNet14 forward, one
embedding batch of the evaluation, the training loop's first train and
validation steps, and rank 0's train and validation steps in phase 11;
`launches` is the paths' launch counts added) and
`{"ok": true, "device": {...}}`.  Details (every call shape's times and
`tc_bound_ms`, each path apart and summed) go to build/chip_smoke.json.
Any failure exits non-zero before the last line; without CUDA the script
exits non-zero at once.
"""
from __future__ import annotations

import copy
import dataclasses
import inspect
import json
import math
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time
import types
import warnings

import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # f32 FMA pipes, outside the tensor cores (data sheet)
TF32_OPS_PER_S = 495e12     # dense TF32 tensor cores (data sheet)
BF16_OPS_PER_S = 989e12     # dense bf16 tensor cores (data sheet)
# split TF32: 3 TF32 MMAs per product
TC_KERNELS = ("gather_conv", "tdown", "gather_dw", "tconv")
# the bf16 kernels of gather_conv, tdown and gather_dw (bf16 features), one
# MMA per product, with their own rows and launch counts
BF16_ROWS = {"gather_conv": "gather_conv_bf16", "tdown": "tdown_bf16",
             "gather_dw": "gather_dw_bf16"}
# ptxas must report no spills
SPILL_FREE = ("gather_conv.cu", "tdown.cu", "gather_dw.cu", "tconv.cu")
# the Hopper bf16 bodies (wgmma, mbarrier rings) and their sources
HOPPER_BODIES = (("gather_conv.cu", "gather_mm_sm90_kernel"),
                 ("gather_dw.cu", "gather_dw_sm90_kernel"))
INT32_OPS_PER_S = 33.5e12   # 64 INT32 lanes per SM against 128 FP32 lanes
B, N_POINTS, CAP0, SEED = 8, 65536, 16384, 0
EXPECTED_LAUNCHES = {"zrun_presence": 1, "zrun_rank": 7, "gather_conv": 14, "tdown": 7,
                     "gather_dw": 0, "lookup": 0,
                     "gather_conv_bf16": 0, "tdown_bf16": 0, "gather_dw_bf16": 0,
                     "stem_ones": 1, "tconv": 3,
                     "slot_order": 3}
# Kernel launches of one training step: three train-mode forwards (global,
# anchor, positive), each 1 zrun_presence + 7 zrun_rank (the pyramid), 7 down
# convs + 14 self convs through gather_conv; then one backward, which reaches
# only what the losses read.  The global forward's loss reads `global` alone,
# so its backward runs all 7 levels (14 self-conv dX through gather_conv,
# 21 dW through gather_dw) and the global head's two transposed convs (dX
# through gather_conv); its local head gets no gradient.  The local losses
# read the local head alone, which takes levels 3 and 4, so each local
# backward runs levels 1-4 (8 self-conv dX, 4 + 8 dW) and one transposed
# conv.  gather_conv 3 x 21 + 14 + 2 + 2 x (8 + 1) = 97; gather_dw
# 21 + 2 x 12 = 45.  Every forward runs the stem once: stem_ones 3 (its dW
# is a torch.mm).  tconv: each forward's three transposed convs (the global
# head's two, the local head's one) and the down convs' dX, 7 + 2 x 4:
# 9 + 15 = 24, over slot orders built once per level a forward (slot_order:
# the down convs' 7 levels, which the heads' levels are among: 3 x 7).
TRAIN_STEP_LAUNCHES = {"zrun_presence": 3, "zrun_rank": 21, "gather_conv": 97, "tdown": 0,
                       "gather_dw": 45, "lookup": 0,
                       "gather_conv_bf16": 0, "tdown_bf16": 0, "gather_dw_bf16": 0,
                       "stem_ones": 3, "tconv": 24,
                       "slot_order": 21}
# The validation step: three eval forwards (7 tdown, 14 gather_conv, the stem,
# 3 tconv and their 3 slot orders each).
VAL_STEP_LAUNCHES = {"zrun_presence": 3, "zrun_rank": 21, "gather_conv": 42, "tdown": 21,
                     "gather_dw": 0, "lookup": 0,
                     "gather_conv_bf16": 0, "tdown_bf16": 0, "gather_dw_bf16": 0,
                     "stem_ones": 3, "tconv": 9,
                     "slot_order": 9}
# Phase 6a: the EgoNN pyramid without up maps, kmap_down looked up at L1-L7
# in one launch of the lookup kernel.
LOOKUP_MAPS_LAUNCHES = {"zrun_presence": 1, "zrun_rank": 7, "gather_conv": 0, "tdown": 0,
                        "gather_dw": 0, "lookup": 1,
                        "gather_conv_bf16": 0, "tdown_bf16": 0, "gather_dw_bf16": 0,
                        "stem_ones": 0, "tconv": 0,
                        "slot_order": 0}
# Phase 6b: one MinkLoc forward: the stem map, 3 self maps, 2 convs in each
# of 3 blocks; the factory pyramid runs the 3 down convs from the up maps,
# the one with level 2's up map alone looks up L1 and L2's down maps (one
# lookup launch) and runs those down convs as gathers.
MINKLOC_LAUNCHES = {"zrun_presence": 1, "zrun_rank": 3, "gather_conv": 6, "tdown": 3,
                    "gather_dw": 0, "lookup": 0,
                    "gather_conv_bf16": 0, "tdown_bf16": 0, "gather_dw_bf16": 0,
                    "stem_ones": 1, "tconv": 1,
                    "slot_order": 1}
MINKLOC_LOOKUP_LAUNCHES = {"zrun_presence": 1, "zrun_rank": 3, "gather_conv": 8, "tdown": 1,
                           "gather_dw": 0, "lookup": 1,
                           "gather_conv_bf16": 0, "tdown_bf16": 0, "gather_dw_bf16": 0,
                           "stem_ones": 1, "tconv": 1,
                           "slot_order": 1}
MINKLOC_CAP0 = 40960
MINKLOC_ROUNDS = 20  # throughput turns of each MinkLoc pyramid
# Phase 8: ResNet14 at torchvision widths over MinkLoc's quantizer and
# capacities max(256, cap0 >> min(l, 4)).  One forward: the L0 (k = 5) and
# L1-L4 self maps by z-run rank (real features: positions, not presence),
# the stem, 4 down convs and 2 convs in each of 4 blocks through gather_conv,
# no up maps, so the L1-L4 down maps come from one lookup launch.
RESNET_CAPACITIES = (40960, 20480, 10240, 5120, 2560)
RESNET_PLANES, RESNET_INIT_DIM = (64, 128, 256, 512), 64
RESNET_LAUNCHES = {"zrun_presence": 0, "zrun_rank": 5, "gather_conv": 13, "tdown": 0,
                   "gather_dw": 0, "lookup": 1,
                   "gather_conv_bf16": 0, "tdown_bf16": 0, "gather_dw_bf16": 0,
                   "stem_ones": 0, "tconv": 0,
                   "slot_order": 0}
# Phase 3b: the forward of phases 2-3 with EGONN_BF16_ACTS=1: the same maps,
# the 21 convs on the bf16 kernels (the stem sums and returns f32, then casts)
BF16_LAUNCHES = {"zrun_presence": 1, "zrun_rank": 7, "gather_conv": 0, "tdown": 0,
                 "gather_dw": 0, "lookup": 0, "gather_conv_bf16": 14, "tdown_bf16": 7,
                 "gather_dw_bf16": 0, "stem_ones": 1, "tconv": 0,
                 "slot_order": 0}
# Phase 5b: the train and validation steps of phases 4-5 with
# EGONN_BF16_ACTS=1: TRAIN_STEP_LAUNCHES and VAL_STEP_LAUNCHES with every
# conv, dX and dW on the bf16 kernels (the activations and their cotangents
# are bf16 from the stem on)
BF16_TRAIN_STEP_LAUNCHES = {"zrun_presence": 3, "zrun_rank": 21, "gather_conv": 0, "tdown": 0,
                            "gather_dw": 0, "lookup": 0, "gather_conv_bf16": 97,
                            "tdown_bf16": 0, "gather_dw_bf16": 45,
                            "stem_ones": 3, "tconv": 0,
                            "slot_order": 0}
BF16_VAL_STEP_LAUNCHES = {"zrun_presence": 3, "zrun_rank": 21, "gather_conv": 0, "tdown": 0,
                          "gather_dw": 0, "lookup": 0, "gather_conv_bf16": 42,
                          "tdown_bf16": 21, "gather_dw_bf16": 0,
                          "stem_ones": 3, "tconv": 0,
                          "slot_order": 0}
# card vs CPU bf16 forward, of each output's max |CPU| (tests/test_banded.py's
# bf16 rule): roundings to bf16 at other places flip single activations by an ulp
BF16_REL_TOL = 3e-2
# a bf16 kernel's output against its bf16 plain version: one bf16 ulp, or
# this much of max |plain| for outputs near 0 (both round the same f32 sums
# once, summed in another order)
BF16_ABS_TOL = 1e-6
BF16_ROUNDS = 3  # rounds of throughput turns f32, bf16, bf16, f32
# Phase 5b: train steps/s in BF16_TRAIN_ROUNDS rounds of turns f32, bf16,
# bf16, f32, each turn one warm-up step and BF16_TRAIN_TIMED timed steps;
# do_train under the flag for BF16_LOOP_EPOCHS epochs, resumed from epoch 1
BF16_TRAIN_ROUNDS, BF16_TRAIN_TIMED, BF16_LOOP_EPOCHS = 2, 3, 2
# The bf16 step's gradients against a reference (`bf16_grad_check`: the card
# against the CPU here, the port against JAX in
# tests/test_torch_bf16_train.py): together within BF16_WHOLE_L2_TOL in l2,
# each leaf at cosine >= BF16_COS_MIN.  Single bf16 roundings that two
# summation orders round apart are magnified by the global loss's backward
# through the deep levels' batch statistics, and by the local losses'
# nearest-keypoint matches at full width.  Against JAX at the test's size
# the local head's leaves (which only the local losses reach) are also held
# each within BF16_GRAD_MAX_TOL of its max and BF16_GRAD_L2_TOL of its l2.
BF16_WHOLE_L2_TOL, BF16_COS_MIN = 0.15, 0.8
BF16_GRAD_MAX_TOL, BF16_GRAD_L2_TOL = 3e-2, 1e-2
RESNET_Z_SCALE = 0.25  # the stem's one feature: the voxel centre's z, per 4 m
RESNET_ROUNDS = 5      # throughput turns of 10 forwards
# the wrappers recorded apart from KERNELS, and the kernel whose row they feed
ROW_OF = {"lookup_down": "lookup"}
REPLACES = {
    "gather_conv_bf16": ("egonn_tpu_torch/csrc/gather_conv.cu", "egonn_tpu/sparse/banded.py:207"),
    "tdown_bf16": ("egonn_tpu_torch/csrc/tdown.cu", "egonn_tpu/sparse/banded.py:506"),
    "gather_dw_bf16": ("egonn_tpu_torch/csrc/gather_dw.cu", "egonn_tpu/sparse/banded.py:688"),
    "zrun_presence": ("egonn_tpu_torch/csrc/zrun.cu", "egonn_tpu/sparse/banded.py:970"),
    "zrun_rank": ("egonn_tpu_torch/csrc/zrun.cu", "egonn_tpu/sparse/banded.py:1095"),
    "gather_conv": ("egonn_tpu_torch/csrc/gather_conv.cu", "egonn_tpu/sparse/banded.py:207"),
    "tdown": ("egonn_tpu_torch/csrc/tdown.cu", "egonn_tpu/sparse/banded.py:506"),
    "gather_dw": ("egonn_tpu_torch/csrc/gather_dw.cu", "egonn_tpu/sparse/banded.py:688"),
    "lookup": ("egonn_tpu_torch/csrc/lookup.cu", "egonn_tpu/sparse/banded.py:808"),
    # no Pallas kernel: the JAX package's stem is a jnp product
    "stem_ones": ("egonn_tpu_torch/csrc/stem.cu", "none (egonn_tpu/sparse/conv.py, jnp)"),
    # nor for the transposed conv: XLA's product there
    "tconv": ("egonn_tpu_torch/csrc/tconv.cu", "none (egonn_tpu/sparse/conv.py, XLA)"),
    "slot_order": ("egonn_tpu_torch/csrc/tconv.cu", "none (tconv's row order)"),
}
# Phase 7: synthetic ResNet-width calls (name, K, F_in, F_out); the last
# six at widths the kernels take only through the wrappers' width plan
WIDE_CALLS = (("gather_conv", 27, 256, 256), ("gather_conv", 27, 512, 512),
              ("gather_conv", 8, 256, 512), ("gather_dw", 27, 256, 256),
              ("gather_dw", 27, 512, 512), ("gather_conv", 125, 1, 64),
              ("gather_conv", 27, 3, 64), ("gather_conv", 27, 64, 48),
              ("gather_conv", 8, 1024, 1024), ("gather_dw", 8, 1024, 1024),
              ("tdown", 8, 32, 48))
WIDE_CLOUDS, WIDE_CAPACITY, WIDE_VOXELS = 4, 4096, 3000
FLOAT_REL_TOL = 1e-5
# gather_dw sums up to 32 x 16,384 rows per weight, in per-chunk partials
# and then over the chunks, against one einsum in the plain version
DW_REL_TOL = 1e-4
N_PLACES, TRAIN_STEPS = 16, 5
OUT_DIR = pathlib.Path("build")
# Phase 9: the evaluation on the JAX package's synthetic set (64 scans, seed
# 0: 32 map, 32 query), written by the port's generator into EVAL_DIR
EVAL_DIR = OUT_DIR / "eval_synth"
EVAL_SCANS, EVAL_N_K, EVAL_HYPOTHESES = 64, (128, 256), 1024
EVAL_THETAS = (0.0, 90.0, 180.0)
EVAL_BATCH_LAUNCHES = dict(EXPECTED_LAUNCHES)  # each embedding batch: one eval forward
# each global-only embedding batch: the forward without the local head, whose
# transposed conv (and its level's slot order) it skips
GLOBAL_EVAL_BATCH_LAUNCHES = dict(EVAL_BATCH_LAUNCHES, tconv=2, slot_order=2)
# known-transform RANSAC pairs at evaluation sizes; 10240 hypotheses is the
# reference's Open3D budget (evaluate.py --ransac_hypotheses)
RANSAC_PAIRS, RANSAC_K, RANSAC_DIM, RANSAC_HYPOTHESES = 32, 256, 128, (1024, 10240)
# device top-k above the evaluator's 4 M-entry host threshold
TOPK_MAP, TOPK_QUERY, TOPK_DIM = 4096, 2048, 256
# Phase 10: do_train for LOOP_EPOCHS epochs on a synthetic set of LOOP_SCANS
# scans (144 train, 48 validation) written by the port's generator into
# LOOP_DATA, checkpoints every LOOP_SAVE_FREQ epochs, runs under LOOP_DIR
LOOP_DATA, LOOP_DIR = OUT_DIR / "train_synth", OUT_DIR / "train_loop"
LOOP_SCANS, LOOP_EPOCHS, LOOP_SAVE_FREQ = 192, 10, 5
LOOP_BUCKET = 128  # config_egonn.txt's batch_size_limit: the largest bucket
# the kernels a loop step launches (lookup builds no EgoNN map)
LOOP_KERNELS = ("zrun_presence", "zrun_rank", "gather_conv", "tdown", "gather_dw", "stem_ones",
                "tconv", "slot_order")
# Phase 11: data parallel over DP_WORLD ranks sharing the card (gloo); each
# rank times DP_TIMED_STEPS train steps; do_train on the mesh for DP_EPOCHS
# epochs against one process at DP_LR (see phase_data_parallel)
DP_WORLD, DP_TIMED_STEPS, DP_EPOCHS, DP_LR = 2, 3, 2, 1e-5
DP_TIMEOUT_S = 300.0  # a rank's wait in a collective, and for a rank to end
DP_DIR = OUT_DIR / "train_dp"
ROOT = pathlib.Path(__file__).resolve().parent


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def _sleep_cycles_per_ms() -> float:
    torch.cuda._sleep(1000)
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    torch.cuda._sleep(10_000_000)
    e.record()
    e.synchronize()
    return 10_000_000 / s.elapsed_time(e)


def _sleep(ms: float, cycles_per_ms: float) -> None:
    cycles = int(cycles_per_ms * ms)
    while cycles > 0:  # in pieces that fit any integer width of the sleep
        torch.cuda._sleep(min(cycles, 1 << 30))
        cycles -= 1 << 30


def device_ms(fn, cycles_per_ms: float, reps: int = 20) -> float:
    """Median device time of fn() over `reps` runs, each between two CUDA
    events.  Each run is queued behind a sleep kernel twice as long as the
    host takes to enqueue it, so the card runs it back to back and the events
    see device time, not the host's launch overhead (one run's launches must
    fit the launch queue: a kernel call or a plain version, not a forward)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for s, e in events:
        _sleep(2.0 * host_ms + 0.05, cycles_per_ms)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


# ---------------------------------------------------------------------------
# per-kernel work and bounds
# ---------------------------------------------------------------------------

def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def row_of(name: str, args: tuple = ()) -> str:
    """The kernel row a recorded wrapper's call feeds: a conv or dW on bf16
    features feeds its bf16 kernel's row."""
    if name in BF16_ROWS and args and args[0].dtype == torch.bfloat16:
        return BF16_ROWS[name]
    return ROW_OF.get(name, name)


def row_names(kernels) -> tuple:
    return tuple(fn.__name__ for fn in kernels.KERNELS) + tuple(BF16_ROWS.values())


def _outputs(out) -> tuple:
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _down_queries(args: tuple) -> list:
    """The queries a `lookup_down` call forms in the kernel, one tensor per
    level (for its work and for `torch.searchsorted` beside it)."""
    from egonn_tpu_torch.sparse import kernels

    keys, packs, levels = args
    return [kernels.down_queries(keys[l], packs[l], packs[l - 1]) for l in levels]


def _lookup_ops(tables, queries) -> int:
    """Binary search steps + one equality test per valid query."""
    return sum(int((q != 2**31 - 1).sum()) * (math.ceil(math.log2(t.shape[1] + 1)) + 1)
               for t, q in zip(tables, queries))


def lookup_tpu_bytes(args: tuple, out) -> int:
    """The bytes of the TPU kernel's form of a `lookup_down` call: each
    level's table, its formed queries in and its positions out (what
    `lookup` moves given the queries), so that the grouped call compares
    with the per-level one."""
    keys, _, levels = args
    return sum(_nbytes(keys[l - 1]) + 2 * _nbytes(pos) for l, pos in zip(levels, out))


def work(name: str, args: tuple, kwargs: dict, out) -> tuple:
    """(bytes, operations, ops rate) the call needs: each input read once,
    each output written once; operations as this call's data needs them."""
    if name in ("zrun_presence", "zrun_rank"):
        keys, q_lo, kz = args
        n_valid = int((q_lo != 2**31 - 1).sum())
        outs = out if isinstance(out, tuple) else (out,)
        # binary search steps + kz compares per valid query
        ops = n_valid * (math.ceil(math.log2(keys.shape[1] + 1)) + kz)
        return _nbytes(keys, q_lo, *outs), ops, INT32_OPS_PER_S
    if name == "lookup":
        keys, queries = args
        return _nbytes(keys, queries, out), _lookup_ops([keys], [queries]), INT32_OPS_PER_S
    if name == "lookup_down":  # the fused form: coarse keys and table in, positions out
        keys, _, levels = args
        nbytes = sum(_nbytes(keys[l], keys[l - 1], pos) for l, pos in zip(levels, out))
        return (nbytes, _lookup_ops([keys[l - 1] for l in levels], _down_queries(args)),
                INT32_OPS_PER_S)
    if name == "stem_ones":  # one f32 addition per valid entry and feature
        kmap, t, n_in = args[:3]
        ops = int((kmap < n_in).sum()) * t.shape[2]
        return _nbytes(kmap, t, out), ops, F32_OPS_PER_S / 2
    if name == "slot_order":  # the up map read twice, a key and a count each row and pass
        up_parent, up_koffset = args[:2]
        return (_nbytes(up_parent, up_koffset, *out), 4 * up_parent.numel(),
                INT32_OPS_PER_S)
    if name == "tconv":  # one product a fine row with a parent
        feats, up_parent, up_koffset, kernel = args[:4]
        n_child = int(((up_parent >= 0) & (up_parent < feats.shape[1])).sum())
        ops = 2 * n_child * kernel.shape[1] * kernel.shape[2]
        return _nbytes(feats, up_parent, up_koffset, kernel, out), ops, F32_OPS_PER_S
    # bf16 features: 2 bytes a feature (and g) element, bf16 tensor-core rate
    rate = BF16_OPS_PER_S if args[0].dtype == torch.bfloat16 else F32_OPS_PER_S
    if name == "gather_dw":
        feats, kmap, g = args
        nnz = int(((kmap >= 0) & (kmap < feats.shape[1])).sum())
        return _nbytes(feats, kmap, g, out), 2 * nnz * feats.shape[2] * g.shape[2], rate
    epi = kwargs.get("epi")
    epi_t = (epi[0], epi[1], epi[3]) if epi else ()
    if name == "gather_conv":
        feats, kmap, kernel = args
        nnz = int(((kmap >= 0) & (kmap < feats.shape[1])).sum())
        ops = 2 * nnz * kernel.shape[1] * kernel.shape[2]
        return _nbytes(feats, kmap, kernel, out, *epi_t), ops, rate
    feats, up_parent, up_koffset, kernel, c_coarse = args
    n_child = int(((up_parent >= 0) & (up_parent < c_coarse)).sum())
    ops = 2 * n_child * kernel.shape[1] * kernel.shape[2]
    return _nbytes(feats, up_parent, up_koffset, kernel, out, *epi_t), ops, rate


def plain_call(name: str, kernels):
    return {
        "zrun_presence": lambda keys, q, kz: kernels.zrun_plain(keys, q, kz)[0],
        "zrun_rank": kernels.zrun_plain,
        "gather_conv": kernels.gather_conv_plain,
        "tdown": kernels.tdown_plain,
        "gather_dw": kernels.gather_dw_plain,
        "lookup": kernels.lookup_plain,
        "lookup_down": kernels.lookup_down_plain,
        "stem_ones": kernels.stem_ones_plain,
        "tconv": lambda feats, up, ko, kernel, slots=None: kernels.tconv_plain(feats, up, ko,
                                                                               kernel),
        "slot_order": kernels.slot_order_plain,
    }[name]


def library_call(name: str, args: tuple):
    """One PyTorch call computing the same function, where there is one
    (the stem's: its GEMM alone, on the 0/1 matrix built beforehand)."""
    if name in ("zrun_rank", "lookup"):
        keys, q = args[:2]
        q = q.reshape(keys.shape[0], -1)
        return lambda: torch.searchsorted(keys, q, out_int32=True)
    if name == "lookup_down":  # one call per level, on the queries formed beforehand
        keys, _, levels = args
        pairs = [(keys[l - 1], q.reshape(q.shape[0], -1))
                 for l, q in zip(levels, _down_queries(args))]
        return lambda: [torch.searchsorted(t, q, out_int32=True) for t, q in pairs]
    if name == "stem_ones":  # the plain form's GEMM on its built 0/1 matrix
        kmap, kernel, n_in = args[:3]
        valid = (kmap < n_in).to(torch.float32)
        return lambda: torch.matmul(valid.transpose(1, 2), kernel[:, 0, :])
    if name == "tconv":  # the all-slot form's GEMM on its gathered parent rows
        feats, up_parent, _, kernel = args[:4]
        f_in = feats.shape[2]
        rows = torch.cat([feats, feats.new_zeros(feats.shape[0], 1, f_in)], dim=1)
        rows = torch.gather(rows, 1, up_parent.long()[..., None].expand(-1, -1, f_in))
        w_all = kernel.permute(1, 0, 2).reshape(f_in, -1)
        return lambda: torch.matmul(rows, w_all)
    return None


def _bf16_within_one_ulp(name: str, g: torch.Tensor, w: torch.Tensor, kernels) -> None:
    near = (g.float() - w.float()).abs() <= BF16_ABS_TOL * float(w.float().abs().max())
    ulps = kernels.bf16_ulps(g, w)
    far = ~(near | (ulps <= 1))
    if bool(far.any()):
        raise AssertionError(f"{name}: {int(far.sum())} bf16 outputs more than one ulp from the "
                             f"plain version's (up to {int(ulps[far].max())} ulps)")


def compare(name: str, got, want) -> float:
    """Max abs error of a kernel's outputs against its plain version's:
    integers bit-equal, f32 within rel FLOAT_REL_TOL (gather_dw DW_REL_TOL)
    of max |plain|, bf16 within one ulp (`_bf16_within_one_ulp`)."""
    from egonn_tpu_torch.sparse import kernels

    got, want = _outputs(got), _outputs(want)
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} outputs against {len(want)}")
    tol = DW_REL_TOL if name == "gather_dw" else FLOAT_REL_TOL
    err = 0.0
    for g, w in zip(got, want):
        g, w = g.detach(), w.detach()
        if g.dtype != w.dtype:
            raise AssertionError(f"{name}: output {g.dtype} against the plain version's {w.dtype}")
        if g.dtype == torch.bfloat16:
            _bf16_within_one_ulp(name, g, w, kernels)
            e = float((g.float() - w.float()).abs().max())
        elif g.dtype.is_floating_point:
            e = float((g - w).abs().max())
            scale = float(w.abs().max())
            if not e <= tol * max(scale, 1e-30):
                raise AssertionError(f"{name}: max abs err {e} against max |plain| {scale}")
        else:
            e = float((g.long() - w.long()).abs().max())
            if e != 0:
                raise AssertionError(f"{name}: integer outputs differ (max {e})")
        err = max(err, e)
    return err


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_environment(cuda_lib):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[env] nvidia-smi: {smi}")
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    cuda_lib.build_all()
    log(f"[env] kernels built in {cuda_lib.build_seconds:.1f} s into {cuda_lib.BUILD_DIR}")
    spills = []
    for src, text in cuda_lib.ptxas_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[env] ptxas {src}: {line.strip()}")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and src in SPILL_FREE and (int(m[1]) or int(m[2])):
                spills.append(f"{src}: {line.strip()}")
    if spills:
        raise AssertionError(f"register spills in the tensor-core kernels: {spills}")
    unreported = [src for src in SPILL_FREE if "spill" not in cuda_lib.ptxas_log.get(src, "")]
    if unreported:
        raise AssertionError(f"ptxas reported no spill counts for {unreported}")
    hopper_bodies(cuda_lib)
    return smi


def hopper_bodies(cuda_lib) -> dict:
    """The Hopper bf16 bodies in the built libraries: ptxas's registers and
    spills for each (from its `Compiling entry function` block), and the
    wgmma (HGMMA), mbarrier (SYNCS) and cp.async (LDGSTS) / TMA (UTMALDG)
    instructions of each in cuobjdump's SASS (where the toolkit has
    cuobjdump).  Fails if a body is missing or has no HGMMA."""
    out = {}
    for src, name in HOPPER_BODIES:
        text = cuda_lib.ptxas_log.get(src, "")
        blocks = [b for b in text.split("Compiling entry function") if name in b.split("\n")[0]]
        if not blocks:
            raise AssertionError(f"ptxas compiled no {name} in {src}")
        for b in blocks:
            fn = b.split("'")[1] if "'" in b else name
            for line in b.splitlines()[1:]:
                if "registers" in line or "spill" in line:
                    log(f"[env] ptxas {fn}: {line.strip()}")
        serialized = [line for line in text.splitlines() if "C7520" in line and name in line]
        if serialized:
            log(f"[env] ptxas: wgmma serialized in {len(serialized)} instance(s) of {name}")
        out[name] = dict(ptxas=blocks, wgmma_serialized=len(serialized))
    cuobjdump = pathlib.Path(cuda_lib.nvcc()).with_name("cuobjdump")
    if not cuobjdump.exists():
        log("[env] cuobjdump not found: SASS of the Hopper bodies not read")
        return out
    for src, name in HOPPER_BODIES:
        sass = subprocess.run([str(cuobjdump), "-sass", str(cuda_lib._library_path(src))],
                              capture_output=True, text=True, timeout=120).stdout
        for fn in sass.split("Function : ")[1:]:
            # the production instances (template argument CUT = 0, the only
            # one the port's libraries hold)
            if not re.search(rf"{name}I(?:Li\d+E)*Li0EEE", fn.split("\n")[0]):
                continue
            counts = {op: len(re.findall(rf"\b{op}\b", fn))
                      for op in ("HGMMA", "SYNCS", "LDGSTS", "UTMALDG", "BAR")}
            log(f"[env] SASS {fn.split(chr(10))[0].strip()[:60]}: {counts}")
            out[name].setdefault("sass", []).append(counts)
            if not counts["HGMMA"]:
                raise AssertionError(f"{name}: no wgmma (HGMMA) in its SASS")
        if not out[name].get("sass"):
            raise AssertionError(f"{name}: not found in the SASS of {src}")
    return out


def make_inputs(device, b=None, seed=SEED):
    from egonn_tpu_torch.data.lidar_sim import lidar_scan_clouds

    clouds = torch.from_numpy(lidar_scan_clouds(b or B, N_POINTS, seed=seed)).to(device)
    mask = torch.ones(clouds.shape[:2], dtype=torch.bool, device=device)
    return clouds, mask


def record_calls(kernels, run) -> list:
    """run() with every kernel wrapper replaced by a recorder: the calls as
    (name, positional args, keyword args, output)."""
    calls = []
    originals = {fn.__name__: fn for fn in kernels.KERNELS}
    originals.update({name: getattr(kernels, name) for name in ROW_OF})

    def recorder(name):
        sig = inspect.signature(originals[name])

        def call(*args, **kwargs):
            out = originals[name](*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            # parameters are copied: the optimizer updates them in place later
            vals = {k: v.detach().clone() if torch.is_tensor(v) and v.requires_grad else v
                    for k, v in bound.arguments.items()}
            # positional tensors and sizes in signature order; `epi` by keyword
            epi = {"epi": vals.pop("epi")} if "epi" in vals else {}
            calls.append((name, tuple(vals.values()), epi, out))
            return out
        return call

    for name in originals:
        setattr(kernels, name, recorder(name))
    try:
        run()
    finally:
        for name, fn in originals.items():
            setattr(kernels, name, fn)
    torch.cuda.synchronize()
    return calls


def new_rows(kernels) -> dict:
    return {name: dict(name=name, route="cuda", source=REPLACES[name][0],
                       replaces=REPLACES[name][1], launches=None, max_abs_err=0.0,
                       ms=0.0, plain_ms=0.0, bound_ms=0.0, tc_bound_ms=None,
                       library_ms=None, _bytes_ms=0.0, _ops_ms=0.0, calls=[])
            for name in row_names(kernels)}


def level_of(capacities) -> dict:
    """Capacity -> level name, for the per-call lines (each EgoNN and
    MinkLoc level has its own capacity)."""
    return {c: f"L{l}" for l, c in enumerate(capacities)}


def call_level(name: str, args: tuple, levels: dict) -> str:
    """'L<in>->L<out>' of a conv or dW call from its row counts."""
    if name == "tdown":
        c_in, c_out = args[0].shape[1], args[4]
    elif name == "tconv":
        c_in, c_out = args[0].shape[1], args[1].shape[1]
    elif name in ("gather_conv", "gather_dw"):
        c_in, c_out = args[0].shape[1], args[1].shape[2]
    else:
        return ""
    return f"{levels.get(c_in, c_in)}->{levels.get(c_out, c_out)}"


def call_desc(name: str, args: tuple) -> str:
    """B, C_in, C_out, K and widths of a conv or dW call; table and query
    sizes of a zrun call."""
    if name in ("zrun_presence", "zrun_rank"):
        keys, q_lo, kz = args
        return f"B {keys.shape[0]} C {keys.shape[1]} queries {tuple(q_lo.shape[1:])} kz {kz}"
    if name == "lookup_down":
        keys, _, levels = args
        return (f"B {keys[0].shape[0]} levels L{levels[0]}-L{levels[-1]} C "
                f"{[keys[l].shape[1] for l in levels]} into {[keys[l - 1].shape[1] for l in levels]}")
    if name == "tdown":
        feats, _, _, kernel, c_out = args
        return (f"B {feats.shape[0]} C {feats.shape[1]}->{c_out} K 8 "
                f"F {kernel.shape[1]}->{kernel.shape[2]}")
    if name == "slot_order":  # (up_parent, up_koffset, c_coarse)
        up_parent, _, c_coarse = args
        return (f"B {up_parent.shape[0]} C {c_coarse}<-{up_parent.shape[1]} rows "
                f"{int((up_parent < c_coarse).sum())}")
    if name == "tconv":  # (feats, up_parent, up_koffset, kernel, slots)
        feats, up_parent, _, kernel = args[:4]
        rows = int(((up_parent >= 0) & (up_parent < feats.shape[1])).sum())
        return (f"B {feats.shape[0]} C {feats.shape[1]}->{up_parent.shape[1]} K 8 "
                f"F {kernel.shape[1]}->{kernel.shape[2]} rows {rows}")
    if name == "stem_ones":  # (kmap, kernel, n_in_rows)
        kmap, kernel, n_in = args
        return (f"B {kmap.shape[0]} C {kmap.shape[2]} K {kmap.shape[1]} F 1->{kernel.shape[2]} "
                f"valid {float((kmap < n_in).float().mean()):.3f}")
    feats, kmap = args[0], args[1]
    f_out = args[2].shape[2]
    return (f"B {feats.shape[0]} C {feats.shape[1]}->{kmap.shape[2]} K {kmap.shape[1]} "
            f"F {feats.shape[2]}->{f_out}")


def tc_bound_ms(row: str, nbytes: int, ops: int):
    """The least time of a tensor-core kernel's work: bytes over HBM, or
    three TF32 MMAs per f32 product at the dense TF32 rate (one bf16 MMA at
    the bf16 rate for the bf16 rows); None for the integer kernels."""
    if row in BF16_ROWS.values():
        return max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3
    if row not in TC_KERNELS:
        return None
    return max(nbytes / HBM_BYTES_PER_S, 3 * ops / TF32_OPS_PER_S) * 1e3


def call_detail(kernels, name: str, args: tuple) -> dict:
    """tdown: the fine rows its blocks stream (each tile's hull, at the
    wrapper's tiling) against the children; zrun and the grouped lookup:
    the blocks whose table slice did not fit in shared memory (one more run
    of the call), and for the lookup its TPU-form bound."""
    if name == "tdown":
        feats, up_parent, _, kernel, c_coarse = args
        tile_rows = kernels.tdown_tiling(*feats.shape)[0]
        hull = kernels.tdown_hulls_plain(up_parent, c_coarse, tile_rows)
        return dict(tile_rows=tile_rows,
                    hull_rows=int((hull[..., 1] - hull[..., 0]).clamp_min(0).sum()),
                    children=int(((up_parent >= 0) & (up_parent < c_coarse)).sum()))
    if name in ("zrun_presence", "zrun_rank"):
        device = args[1].device
        before = kernels.zrun_overflow_blocks(device)
        getattr(kernels, name)(*args)
        return dict(q_chunk=kernels.zrun_chunk(args[1].shape[2]),
                    overflow_blocks=kernels.zrun_overflow_blocks(device) - before)
    if name == "lookup_down":
        device = args[0][0].device
        before = kernels.lookup_overflow_blocks(device)
        out = kernels.lookup_down(*args)
        return dict(overflow_blocks=kernels.lookup_overflow_blocks(device) - before,
                    tpu_bound_ms=lookup_tpu_bytes(args, out) / HBM_BYTES_PER_S * 1e3)
    return {}


def _detail_text(detail: dict) -> str:
    if "hull_rows" in detail:
        return (f" tile {detail['tile_rows']} hull rows {detail['hull_rows']} / children "
                f"{detail['children']}")
    if "q_chunk" in detail:
        return f" chunk {detail['q_chunk']} overflow blocks {detail['overflow_blocks']}"
    if "tpu_bound_ms" in detail:
        return (f" overflow blocks {detail['overflow_blocks']} tpu-form bound "
                f"{detail['tpu_bound_ms']:.4f}")
    return ""


def _shape(a):
    """A call argument as it keys and describes the call: a tensor's shape,
    a list's items, a packing by its repr."""
    if torch.is_tensor(a):
        return list(a.shape)
    if isinstance(a, (list, tuple)):
        return [_shape(x) for x in a]
    return a if isinstance(a, (int, float, bool, str, type(None))) else repr(a)


def measure_calls(rows: dict, calls: list, kernels, cycles_per_ms: float, reps: int,
                  tag: str, levels: dict) -> None:
    """Hold every recorded call against its plain version; time each
    distinct call shape once (kernel, plain version, library call) and add
    the times, bounds and errors of every call to its kernel's row.  Each
    new shape prints a line, with its level for the convs and dW, and for
    tdown and zrun the `call_detail` of its first call; every call's detail
    is summed into its row (hull_rows, children, overflow_blocks)."""
    timed = {}
    with torch.no_grad():
        for name, args, kwargs, out in calls:
            plain = plain_call(name, kernels)
            err = compare(name, out, plain(*args, **kwargs))
            detail = call_detail(kernels, name, args)
            shape = [_shape(a) for a in args]
            key = json.dumps([name, shape, "epi" in kwargs and kwargs["epi"] is not None])
            if key not in timed:
                kern = getattr(kernels, name)
                lib = library_call(name, args)
                timed[key] = (device_ms(lambda: kern(*args, **kwargs), cycles_per_ms, reps),
                              device_ms(lambda: plain(*args, **kwargs), cycles_per_ms, reps),
                              device_ms(lib, cycles_per_ms, reps) if lib else None)
                new_shape = True
            else:
                new_shape = False
            ms, plain_ms, lib_ms = timed[key]
            nbytes, ops, rate = work(name, args, kwargs, out)
            bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
            tc_ms = tc_bound_ms(row_of(name, args), nbytes, ops)
            row = rows[row_of(name, args)]
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["ms"] += ms
            row["plain_ms"] += plain_ms
            row["bound_ms"] += max(bytes_ms, ops_ms)
            row["_bytes_ms"] += bytes_ms
            row["_ops_ms"] += ops_ms
            if tc_ms is not None:
                row["tc_bound_ms"] = (row["tc_bound_ms"] or 0.0) + tc_ms
            if lib_ms is not None:
                row["library_ms"] = (row["library_ms"] or 0.0) + lib_ms
            for k in ("hull_rows", "children", "overflow_blocks", "tpu_bound_ms"):
                if k in detail:
                    row[k] = row.get(k, 0) + detail[k]
            level = call_level(name, args, levels)
            row["calls"].append(dict(shapes=shape, level=level, ms=ms, plain_ms=plain_ms,
                                     library_ms=lib_ms, bytes=nbytes, ops=ops,
                                     bound_ms=max(bytes_ms, ops_ms), tc_bound_ms=tc_ms,
                                     max_abs_err=err, **detail))
            if new_shape and tc_ms is not None:
                log(f"[{tag}] {row_of(name, args)} {level} {call_desc(name, args)} "
                    f"{'epi ' if kwargs.get('epi') is not None else ''}ms {ms:.4f} "
                    f"plain {plain_ms:.4f} bound {max(bytes_ms, ops_ms):.4f} "
                    f"tc_bound {tc_ms:.4f} err {err:.3g}{_detail_text(detail)}")
            elif new_shape:
                log(f"[{tag}] {name} {call_desc(name, args)} ms {ms:.4f} plain {plain_ms:.4f} "
                    f"library {lib_ms if lib_ms is None else round(lib_ms, 4)} "
                    f"bound {max(bytes_ms, ops_ms):.4f} err {err:.3g}{_detail_text(detail)}")
    for name, row in rows.items():
        if "hull_rows" in row:
            log(f"[{tag}] {name}: {row['hull_rows']} hull rows streamed for {row['children']} "
                f"children")
        if "overflow_blocks" in row:
            log(f"[{tag}] {name}: {row['overflow_blocks']} blocks overflowed their table slice")


def merged_rows(*paths: dict) -> dict:
    """One row per kernel over the calls of all paths; bound_by from the
    summed byte and operation times."""
    out = {}
    for name in paths[0]:
        rows = [p[name] for p in paths]
        libs = [r["library_ms"] for r in rows if r["library_ms"] is not None]
        tcs = [r["tc_bound_ms"] for r in rows if r["tc_bound_ms"] is not None]
        bytes_ms = sum(r["_bytes_ms"] for r in rows)
        ops_ms = sum(r["_ops_ms"] for r in rows)
        out[name] = dict(
            name=name, route="cuda", source=rows[0]["source"], replaces=rows[0]["replaces"],
            launches=sum(r["launches"] for r in rows),
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=sum(r["ms"] for r in rows), plain_ms=sum(r["plain_ms"] for r in rows),
            bound_ms=sum(r["bound_ms"] for r in rows),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            tc_bound_ms=sum(tcs) if tcs else None,
            library_ms=sum(libs) if libs else None)
    return out


def check_repeat(kernels, calls: list, name: str, tag: str) -> dict:
    """The recorded `name` call with the most work, run twice more: both
    outputs must be bit-equal to the recorded one."""
    def size(call):
        return work(*call[:4])[1]

    _, args, kwargs, out = max((c for c in calls if c[0] == name), key=size)
    fn = getattr(kernels, name)
    with torch.no_grad():
        again = [fn(*args, **kwargs) for _ in range(2)]
    torch.cuda.synchronize()
    want = _outputs(out)
    equal = all(all(torch.equal(x, y) for x, y in zip(_outputs(a), want)) for a in again)
    log(f"[{tag}] determinism: {name} {call_desc(name, args)} re-run twice, bit-equal {equal}")
    if not equal:
        raise AssertionError(f"{name}: a re-run differs from the recorded output")
    return dict(name=name, call=call_desc(name, args), bit_equal=equal)


def phase_kernels(built, kernels, inference, cycles_per_ms):
    """Record every kernel call of one forward, then compare and time each."""
    clouds, mask = make_inputs(built.device)
    calls = record_calls(kernels, lambda: inference.forward(built, clouds, mask))
    rows = new_rows(kernels)
    measure_calls(rows, calls, kernels, cycles_per_ms, reps=20, tag="kernels",
                  levels=level_of(built.pyramid_spec.capacities))
    return rows, [check_repeat(kernels, calls, name, "kernels")
                  for name in ("gather_conv", "tdown", "zrun_rank", "stem_ones", "tconv")]


def _wide_call(gen, name, k_vol, f_in, f_out, device):
    """Seeded ResNet-like inputs: 4 clouds of capacity 4,096 with 3,000
    voxels; each offset finds a neighbour for 40% of them (the centre
    offset for all)."""
    import numpy as np

    b, c, n_valid = WIDE_CLOUDS, WIDE_CAPACITY, WIDE_VOXELS
    feats = np.zeros((b, c, f_in), np.float32)
    feats[:, :n_valid] = gen.standard_normal((b, n_valid, f_in))
    kmap = np.where(gen.random((b, k_vol, c)) < 0.4, gen.integers(0, n_valid, (b, k_vol, c)), c)
    if k_vol % 2:
        kmap[:, k_vol // 2] = np.arange(c)
    kmap[:, :, n_valid:] = c
    if name == "tdown":  # each fine voxel a child of one of c / 2 parents, 8 slots each
        cells = np.stack([gen.choice(4 * c, n_valid, replace=False) for _ in range(b)])
        parent = np.full((b, c), c // 2, np.int32)
        slot = np.zeros((b, c), np.int32)
        parent[:, :n_valid], slot[:, :n_valid] = cells // 8, cells % 8
        w = gen.standard_normal((8, f_in, f_out)) / np.sqrt(8 * f_in)
        return (torch.from_numpy(feats).to(device), torch.from_numpy(parent).to(device),
                torch.from_numpy(slot).to(device), torch.from_numpy(w.astype(np.float32)).to(device),
                c // 2)
    feats = torch.from_numpy(feats).to(device)
    kmap = torch.from_numpy(kmap.astype(np.int32)).to(device)
    if name == "gather_dw":
        g = np.zeros((b, c, f_out), np.float32)
        g[:, :n_valid] = gen.standard_normal((b, n_valid, f_out))
        return (feats, kmap, torch.from_numpy(g).to(device))
    w = gen.standard_normal((k_vol, f_in, f_out)) / np.sqrt(k_vol * f_in)
    return (feats, kmap, torch.from_numpy(w.astype(np.float32)).to(device))


def phase_wide(kernels, cycles_per_ms, device) -> list:
    """gather_conv and gather_dw at ResNet widths (256-512), and gather_conv,
    gather_dw and tdown at widths the kernels take only through the width
    plan (F_in 1 and 3, F_out 48, 1024), on synthetic seeded inputs: held
    against the plain versions, re-run bit-equal and timed.  Not part of any
    path's sums."""
    import numpy as np

    gen = np.random.default_rng(SEED)
    out = []
    with torch.no_grad():
        for name, k_vol, f_in, f_out in WIDE_CALLS:
            args = _wide_call(gen, name, k_vol, f_in, f_out, device)
            fn, plain = getattr(kernels, name), plain_call(name, kernels)
            got = fn(*args)
            err = compare(name, got, plain(*args))
            if not torch.equal(fn(*args), got):
                raise AssertionError(f"wide {name}: a re-run differs")
            ms = device_ms(lambda: fn(*args), cycles_per_ms, 10)
            plain_ms = device_ms(lambda: plain(*args), cycles_per_ms, 10)
            nbytes, ops, rate = work(name, args, {}, got)
            bound = max(nbytes / HBM_BYTES_PER_S, ops / rate) * 1e3
            tc = tc_bound_ms(name, nbytes, ops)
            plan = kernels.width_plan(f_in, f_out, dw=name == "gather_dw")
            log(f"[wide] {name} {call_desc(name, args)} ms {ms:.4f} plain {plain_ms:.4f} "
                f"bound {bound:.4f} tc_bound {tc:.4f} err {err:.3g} plan "
                f"{plan.f_in}x{plan.f_out} in {len(plan.in_chunks) * len(plan.out_chunks)} "
                f"launches")
            out.append(dict(name=name, call=call_desc(name, args), ms=ms, plain_ms=plain_ms,
                            bound_ms=bound, tc_bound_ms=tc, max_abs_err=err, ops=ops,
                            bytes=nbytes))
    return out


def phase_slice(built, kernels, inference, pyramid_mod):
    clouds, mask = make_inputs(built.device)
    spec = built.pyramid_spec
    kernels.reset_launches()
    y = inference.forward(built, clouds, mask)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    log(f"[slice] launches per forward: {launches}")
    if launches != EXPECTED_LAUNCHES:
        raise AssertionError(f"launch counts {launches}, expected {EXPECTED_LAUNCHES}")
    c3 = spec.capacities[3]
    expect = {"global": (B, 256), "descriptors": (B, c3, 128), "keypoints": (B, c3, 3),
              "sigma": (B, c3, 1), "kp_mask": (B, c3)}
    for k, shape in expect.items():
        if tuple(y[k].shape) != shape:
            raise AssertionError(f"{k}: shape {tuple(y[k].shape)}, expected {shape}")
        if y[k].dtype.is_floating_point and not bool(torch.isfinite(y[k]).all()):
            raise AssertionError(f"{k}: non-finite values")
    log(f"[slice] output shapes ok: { {k: tuple(v.shape) for k, v in y.items()} }")
    res = built.quantizer.quantize(clouds, mask, spec.capacities[0], need_index=False)
    report = pyramid_mod.capacity_report(
        pyramid_mod.build_pyramid(res.coords_t, res.mask, spec, keys0=res.keys), spec)
    log(f"[slice] capacity report: {report}")
    if not all(ok for _, _, ok in report.values()):
        raise AssertionError(f"capacity overflow: {report}")

    # the same weights on the CPU, 2 clouds
    cpu = torch.device("cpu")
    built_cpu = dataclasses.replace(built, model=copy.deepcopy(built.model).to(cpu), device=cpu)
    # (a) one shared quantization: pyramids bit-equal, outputs within tolerance
    c2, m2, pg, pc = _two_cloud_pyramids(built, pyramid_mod)
    for l in range(spec.num_levels + 1):
        for field in ("coords", "mask", "kmap_self", "up_parent", "up_koffset"):
            a, b_ = getattr(pg[l], field), getattr(pc[l], field)
            if (a is None) != (b_ is None) or (a is not None and not torch.equal(a.cpu(), b_)):
                raise AssertionError(f"L{l} {field}: card and CPU pyramids differ")
    with torch.no_grad():
        yg = built.model(pg, built.quantizer)
        yc = built_cpu.model(pc, built.quantizer)
    g_rel = float((yg["global"].cpu() - yc["global"]).abs().max() / yc["global"].abs().max())
    d_err = float((yg["descriptors"].cpu() - yc["descriptors"]).abs().max())
    k_err = float((yg["keypoints"].cpu() - yc["keypoints"]).abs().max())
    s_rel = float(((yg["sigma"].cpu() - yc["sigma"]).abs() / yc["sigma"].abs().clamp_min(1e-30))
                  .max())
    log(f"[slice] card vs CPU, shared quantization: pyramids bit-equal; global rel {g_rel:.3g}, "
        f"descriptors abs {d_err:.3g}, keypoints abs {k_err:.3g} m, sigma rel {s_rel:.3g}")
    if not (g_rel <= 1e-4 and d_err <= 1e-4 and k_err <= 1e-3 and s_rel <= 1e-4
            and torch.equal(yg["kp_mask"].cpu(), yc["kp_mask"])):
        raise AssertionError("card and CPU forwards disagree beyond tolerance")
    # (b) independent quantization end to end (report only)
    vg = built.quantizer.to_polar_voxels(c2.to(built.device)).cpu()
    vc = built_cpu.quantizer.to_polar_voxels(c2)
    mismatch = float((vg != vc).any(dim=1).double().mean())
    ye2 = inference.forward(built, c2.to(built.device), m2.to(built.device))
    yc2 = inference.forward(built_cpu, c2, m2)
    e2e_rel = float((ye2["global"].cpu() - yc2["global"]).abs().max()
                    / yc2["global"].abs().max())
    log(f"[slice] card vs CPU, independent quantization: voxel mismatch rate {mismatch:.3g} "
        f"of {vg.shape[0] * vg.shape[2]} points, global rel {e2e_rel:.3g}")

    # throughput on varied inputs
    cps = _clouds_per_s(inference, built, _varied(clouds), mask)
    return dict(launches=launches, capacity=report, global_rel_shared=g_rel,
                descriptors_abs=d_err, keypoints_abs_m=k_err, sigma_rel=s_rel,
                voxel_mismatch_rate=mismatch, global_rel_independent=e2e_rel,
                clouds_per_s=cps, forward_ms=B / cps * 1e3)


# ---------------------------------------------------------------------------
# bf16 activations
# ---------------------------------------------------------------------------

def _forward_peak_gb(run) -> tuple:
    """run()'s output and its peak device memory above what was allocated
    before it, in GiB."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = run()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 2**30


def _two_cloud_pyramids(built, pyramid_mod) -> tuple:
    """2 clouds (on the CPU) quantized once on the card, and their pyramid
    built from that one quantization on the card and on the CPU: (clouds,
    mask, card pyramid, CPU pyramid)."""
    spec = built.pyramid_spec
    c2, m2 = make_inputs(torch.device("cpu"), b=2, seed=SEED + 1)
    res2 = built.quantizer.quantize(c2.to(built.device), m2.to(built.device),
                                    spec.capacities[0], need_index=False)
    pg = pyramid_mod.build_pyramid(res2.coords_t, res2.mask, spec, keys0=res2.keys)
    pc = pyramid_mod.build_pyramid(res2.coords_t.cpu(), res2.mask.cpu(), spec,
                                   keys0=res2.keys.cpu())
    return c2, m2, pg, pc


def _varied(clouds: torch.Tensor, n: int = 10) -> list:
    """n seeded jitters of the clouds (1 cm), so no forward repeats another."""
    gen = torch.Generator(device=clouds.device).manual_seed(SEED)
    return [clouds + 0.01 * torch.randn(clouds.shape, generator=gen, device=clouds.device)
            for _ in range(n)]


def _clouds_per_s(inference, built, variants, mask) -> float:
    """Clouds/s of forwards over `variants` after one warm-up (host clock,
    ending in a synchronize)."""
    inference.forward(built, variants[0], mask)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for v in variants:
        inference.forward(built, v, mask)
    torch.cuda.synchronize()
    return B * len(variants) / (time.perf_counter() - t0)


def split_tf32_ms(kernels, calls: list, names: tuple, cycles_per_ms: float, reps: int) -> dict:
    """Device ms of the split-TF32 kernels on the recorded bf16 calls of
    `names`, every bf16 tensor of a call cast to f32 (each distinct shape
    timed once, as `measure_calls` times it), summed per wrapper."""
    out, timed = {name: 0.0 for name in names}, {}
    with torch.no_grad():
        for name, args, kwargs, _ in calls:
            if name not in names:
                continue
            key = json.dumps([name, [_shape(a) for a in args], kwargs.get("epi") is not None])
            if key not in timed:
                fn = getattr(kernels, name)
                args32 = tuple(a.float() if torch.is_tensor(a) and a.dtype == torch.bfloat16
                               else a for a in args)
                timed[key] = device_ms(lambda: fn(*args32, **kwargs), cycles_per_ms, reps)
            out[name] += timed[key]
    return out


def sm80_body_ms(kernels, calls: list, names: tuple, cycles_per_ms: float, reps: int,
                 tag: str, levels: dict) -> dict:
    """Device ms of the SM80 bf16 bodies (`kernels.SM80`, the body rules
    swapped for the call) on the recorded bf16 calls of `names`, each
    distinct shape timed once as `measure_calls` times it and printed beside
    the rules' choice, timed again; summed per wrapper."""
    out, timed = {name: 0.0 for name in names}, {}
    with torch.no_grad():
        for name, args, kwargs, _ in calls:
            if name not in names or args[0].dtype != torch.bfloat16:
                continue
            key = json.dumps([name, [_shape(a) for a in args], kwargs.get("epi") is not None])
            if key not in timed:
                fn = getattr(kernels, name)
                now = device_ms(lambda: fn(*args, **kwargs), cycles_per_ms, reps)
                rules = kernels.conv_body, kernels.dw_body
                kernels.conv_body = kernels.dw_body = lambda *shape: kernels.SM80
                try:
                    timed[key] = device_ms(lambda: fn(*args, **kwargs), cycles_per_ms, reps)
                finally:
                    kernels.conv_body, kernels.dw_body = rules
                log(f"[{tag}] {BF16_ROWS[name]} {call_level(name, args, levels)} "
                    f"{call_desc(name, args)}: the SM80 body {timed[key]:.4f} ms, the rule's "
                    f"{now:.4f}")
            out[name] += timed[key]
    return out


def phase_bf16(built, kernels, inference, pyramid_mod, cycles_per_ms):
    """Phase 3b: the forward of phases 2-3 (same clouds, same weights) with
    EGONN_BF16_ACTS=1: activations in bf16 from the stem on, the 21 convs
    on the bf16 kernels (BF16_LAUNCHES).  Every bf16 gather_conv and tdown
    call is held against its bf16 plain version (one bf16 ulp) and timed
    beside the split-TF32 kernel on the same call in f32; the largest of
    each re-run bit-equal; two forwards bit-equal; 2 clouds on the card and
    on the CPU (bf16 forced there: the flag keeps the CPU in f32, as JAX's
    keeps it off the TPU) from one shared quantization: each output within
    BF16_REL_TOL of max |CPU|, every output's type the CPU run's; clouds/s
    (host clock, medians of 6 turns of 10 forwards, in BF16_ROUNDS rounds
    f32 / bf16 / bf16 / f32) and peak memory
    of the bf16 forward beside f32's; max |bf16 - f32| of `global`.  The
    flag is unset again at the end, whatever happens."""
    from egonn_tpu_torch.sparse import conv as sconv

    clouds, mask = make_inputs(built.device)
    spec = built.pyramid_spec
    y32, peak32 = _forward_peak_gb(lambda: inference.forward(built, clouds, mask))
    os.environ["EGONN_BF16_ACTS"] = "1"
    try:
        if sconv.activation_dtype(built.device) != torch.bfloat16:
            raise AssertionError("EGONN_BF16_ACTS=1 did not give bf16 activations on the card")
        y, peak16 = _forward_peak_gb(lambda: inference.forward(built, clouds, mask))
        _, launches = _path_launches(kernels, lambda: inference.forward(built, clouds, mask),
                                     BF16_LAUNCHES, "bf16 forward", tag="bf16")
        again = [inference.forward(built, clouds, mask) for _ in range(2)]
        repeat_equal = all(torch.equal(a[k], y[k]) for a in again for k in y)
        log(f"[bf16] two more forwards bit-equal: {repeat_equal}")
        if not repeat_equal:
            raise AssertionError("bf16 forward: a repeat differs")
        rows, calls = _measured_path(kernels, lambda: inference.forward(built, clouds, mask),
                                     launches, cycles_per_ms, 20, "bf16",
                                     level_of(spec.capacities))
        repeats = [check_repeat(kernels, calls, name, "bf16") for name in ("gather_conv", "tdown")]
        f32_ms = split_tf32_ms(kernels, calls, ("gather_conv", "tdown"), cycles_per_ms, 20)
        sm80_ms = sm80_body_ms(kernels, calls, ("gather_conv",), cycles_per_ms, 20, "bf16",
                               level_of(spec.capacities))
        for name in ("gather_conv", "tdown"):
            row = BF16_ROWS[name]
            r = rows[row]
            sm80 = f", the SM80 body {sm80_ms[name]:.4f}" if name in sm80_ms else ""
            log(f"[bf16] {row}: {r['launches']} launches, {r['ms']:.4f} ms per forward (split TF32 "
                f"on the same calls {f32_ms[name]:.4f}{sm80}), bound {r['bound_ms']:.4f} "
                f"({'bytes' if r['_bytes_ms'] >= r['_ops_ms'] else 'operations'}), plain "
                f"{r['plain_ms']:.4f}, max abs err {r['max_abs_err']:.3g}")

        # card vs CPU, 2 clouds from one shared quantization
        model_cpu = copy.deepcopy(built.model).to(torch.device("cpu"))
        _, _, pg, pc = _two_cloud_pyramids(built, pyramid_mod)
        flag_dtype = sconv.activation_dtype
        with torch.no_grad():
            yg = built.model(pg, built.quantizer)
            sconv.activation_dtype = lambda device: torch.bfloat16
            try:
                yc = model_cpu(pc, built.quantizer)
            finally:
                sconv.activation_dtype = flag_dtype
        types_ = {k: (str(yg[k].dtype), str(yc[k].dtype)) for k in yc}
        card_cpu = {k: float((yg[k].cpu().float() - yc[k].float()).abs().max()
                             / yc[k].float().abs().max().clamp_min(1e-30))
                    for k in ("global", "descriptors", "keypoints", "sigma")}
        log(f"[bf16] card vs CPU (bf16 on both), shared quantization: rel to max |CPU| "
            f"{ {k: float(f'{v:.3g}') for k, v in card_cpu.items()} } (gate {BF16_REL_TOL}); "
            f"types {types_}")
        if any(a != b for a, b in types_.values()):
            raise AssertionError(f"bf16 forward: output types differ from the CPU run's: {types_}")
        if not (all(v <= BF16_REL_TOL for v in card_cpu.values())
                and torch.equal(yg["kp_mask"].cpu(), yc["kp_mask"])):
            raise AssertionError(f"bf16 forward: card and CPU disagree: {card_cpu}")
    finally:
        os.environ.pop("EGONN_BF16_ACTS", None)

    # throughput, in BF16_ROUNDS rounds of turns f32, bf16, bf16, f32
    variants = _varied(clouds)
    turns = {"f32": [], "bf16": []}
    for kind in ("f32", "bf16", "bf16", "f32") * BF16_ROUNDS:
        if kind == "bf16":
            os.environ["EGONN_BF16_ACTS"] = "1"
        try:
            turns[kind].append(_clouds_per_s(inference, built, variants, mask))
        finally:
            os.environ.pop("EGONN_BF16_ACTS", None)
    g_err = float((y["global"] - y32["global"]).abs().max())
    g_max = float(y32["global"].abs().max())
    med = {k: statistics.median(v) for k, v in turns.items()}
    log(f"[bf16] clouds/s (host clock, turns of 10 forwards of {B} x {N_POINTS} points): bf16 "
        f"median {med['bf16']:.1f} {[round(t, 1) for t in turns['bf16']]} against f32 median "
        f"{med['f32']:.1f} {[round(t, 1) for t in turns['f32']]}; "
        f"forward peak memory above its inputs and weights: bf16 {peak16:.3f} GiB, f32 "
        f"{peak32:.3f} GiB; max |bf16 - f32| of global {g_err:.3g} (max |f32| {g_max:.3g})")
    return rows, dict(launches=launches, card_vs_cpu=card_cpu, output_types=types_,
                      repeat_bit_equal=repeat_equal, repeats=repeats, split_tf32_ms=f32_ms,
                      sm80_body_ms=sm80_ms,
                      clouds_per_s=turns, clouds_per_s_median=med,
                      peak_gb=dict(bf16=peak16, f32=peak32),
                      global_max_abs_diff_f32=g_err, global_max_abs_f32=g_max)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _gen(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def phase_train_kernels(step, g, l, lr, kernels, cycles_per_ms, levels):
    """Record every kernel call of one training step, then compare and time
    each distinct shape."""
    calls = record_calls(kernels, lambda: step(g, l, _gen(g["clouds"].device, SEED), lr, True))
    counts = {name: sum(row_of(*c[:2]) == name for c in calls) for name in TRAIN_STEP_LAUNCHES}
    if counts != TRAIN_STEP_LAUNCHES:
        raise AssertionError(f"kernel calls per train step {counts}, expected "
                             f"{TRAIN_STEP_LAUNCHES}")
    rows = new_rows(kernels)
    measure_calls(rows, calls, kernels, cycles_per_ms, reps=10, tag="train-kernels",
                  levels=levels)
    return rows, [check_repeat(kernels, calls, name, "train-kernels")
                  for name in ("gather_dw", "zrun_presence", "zrun_rank")]


def phase_val_kernels(step, g, l, lr, kernels, cycles_per_ms, levels):
    """Record every kernel call of one validation step (three eval forwards:
    tdown's largest user), then compare and time each distinct shape."""
    calls = record_calls(kernels, lambda: step(g, l, None, lr, False))
    counts = {name: sum(row_of(*c[:2]) == name for c in calls) for name in VAL_STEP_LAUNCHES}
    if counts != VAL_STEP_LAUNCHES:
        raise AssertionError(f"kernel calls per validation step {counts}, expected "
                             f"{VAL_STEP_LAUNCHES}")
    rows = new_rows(kernels)
    measure_calls(rows, calls, kernels, cycles_per_ms, reps=10, tag="val-kernels", levels=levels)
    return rows, check_repeat(kernels, calls, "tdown", "val-kernels")


def _finite_stats(stats: dict, what: str) -> dict:
    out = {k: float(v) for k, v in stats.items()}
    bad = [k for k, v in out.items() if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"{what}: non-finite stats {bad}")
    return out


def phase_train_slice(step, g, l, lr, kernels):
    model, opt = step.state.model, step.state.optimizer
    device = g["clouds"].device
    n_clouds = g["clouds"].shape[0] + 2 * l["anc_clouds"].shape[0]
    step(g, l, _gen(device, 1), lr, True)  # warm-up
    torch.cuda.synchronize()
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    host_s = []
    for i in range(TRAIN_STEPS):
        kernels.reset_launches()
        t0 = time.perf_counter()
        stats = step(g, l, _gen(device, 2 + i), lr, True)
        torch.cuda.synchronize()
        host_s.append(time.perf_counter() - t0)
        launches = kernels.launch_counts()
        if launches != TRAIN_STEP_LAUNCHES:
            raise AssertionError(f"train step {i}: launches {launches}, expected "
                                 f"{TRAIN_STEP_LAUNCHES}")
    train_stats = _finite_stats(stats, "train step")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    after = model.state_dict()
    still = [k for k in before if torch.equal(before[k], after[k])]
    if still:
        raise AssertionError(f"not moved by {TRAIN_STEPS} train steps: {still}")
    log(f"[train] launches per train step: {launches}")
    log(f"[train] last train step stats: {json.dumps(train_stats)}")

    snap = {k: v.clone() for k, v in model.state_dict().items()}
    opt_snap = copy.deepcopy(opt.state_dict())
    kernels.reset_launches()
    val_stats = _finite_stats(step(g, l, None, lr, False), "validation step")
    torch.cuda.synchronize()
    val_launches = kernels.launch_counts()
    if val_launches != VAL_STEP_LAUNCHES:
        raise AssertionError(f"validation step: launches {val_launches}, expected "
                             f"{VAL_STEP_LAUNCHES}")
    changed = [k for k, v in model.state_dict().items() if not torch.equal(v, snap[k])]
    opt_now = opt.state_dict()
    changed += [f"optimizer {i}.{k}" for i, st in opt_snap["state"].items()
                for k, v in st.items() if not torch.equal(torch.as_tensor(v),
                                                          torch.as_tensor(opt_now["state"][i][k]))]
    if changed:
        raise AssertionError(f"the validation step changed {changed}")
    log(f"[train] validation step: launches {val_launches}, loss {val_stats['loss']:.6g}; "
        "model and optimizer untouched")
    sec = sum(host_s)
    return dict(train_launches=launches, val_launches=val_launches, train_stats=train_stats,
                val_stats=val_stats, step_s=host_s, steps_per_s=TRAIN_STEPS / sec,
                clouds_per_s=TRAIN_STEPS * n_clouds / sec, clouds_per_step=n_clouds,
                peak_memory_gb=peak_gb)


def _voxel_centres(quantizer, pc):
    """Each point moved to its voxel's centre, so that an ulp of atan2 on
    one device cannot move it across a voxel boundary (trap C1)."""
    return quantizer.dequantize(quantizer.to_polar_voxels(pc).transpose(-1, -2))


def _card_and_cpu_steps(tp, g, l, lr, cpu_bf16: bool = False) -> tuple:
    """One train step on 4 global clouds (2 places) and 2 pairs, on the card
    and on the CPU, from the same weights, augmentation off; the points sit
    at voxel centres, so both devices build the same pyramids.  cpu_bf16:
    the CPU step with bf16 activations (the flag keeps the CPU in f32, as
    JAX's keeps it off the TPU).  (card, CPU, initial state), each side's
    stats, seconds, gradients and state on the CPU."""
    from egonn_tpu_torch.models.factory import create_egonn_model
    from egonn_tpu_torch.sparse import conv as sconv
    from egonn_tpu_torch.train.trainer import make_train_step

    device = g["clouds"].device
    built = create_egonn_model(tp.model_params, cap0=CAP0, device=device, seed=SEED + 2)
    cpu = torch.device("cpu")
    built_cpu = dataclasses.replace(built, model=copy.deepcopy(built.model).to(cpu), device=cpu)
    p0 = {k: v.detach().cpu().clone() for k, v in built.model.state_dict().items()}
    q = built.quantizer
    small_g = dict(clouds=_voxel_centres(q, g["clouds"][:4].cpu()), point_mask=g["point_mask"][:4],
                   positives_mask=g["positives_mask"][:4, :4],
                   negatives_mask=g["negatives_mask"][:4, :4])
    small_l = {k: v[:2] for k, v in l.items()}
    for k in ("anc_clouds", "pos_clouds"):
        small_l[k] = _voxel_centres(q, small_l[k].cpu())
    results = []
    flag_dtype = sconv.activation_dtype
    for b, dev in ((built, device), (built_cpu, cpu)):
        step = make_train_step(b, tp)
        gd = {k: v.to(dev) for k, v in small_g.items()}
        ld = {k: v.to(dev) for k, v in small_l.items()}
        if cpu_bf16 and dev == cpu:
            sconv.activation_dtype = lambda device: torch.bfloat16
        try:
            t0 = time.perf_counter()
            stats = _finite_stats(step(gd, ld, None, lr, True), f"step on {dev}")
        finally:
            sconv.activation_dtype = flag_dtype
        results.append(dict(stats=stats, seconds=time.perf_counter() - t0,
                             grads={n: p.grad.detach().cpu() for n, p in
                                    b.model.named_parameters()},
                             state={k: v.detach().cpu() for k, v in
                                    b.model.state_dict().items()}))
    return (*results, p0)


def _adam_closed_form_err(side: dict, p0: dict, tp, lr) -> float:
    """Adam's first step in closed form on a side's own gradient: m_hat = g,
    v_hat = g^2, so p1 = p0 - lr * g / (|g| + eps), g with the L2 term."""
    err = 0.0
    for n, gr in side["grads"].items():
        g_adam = gr + tp.weight_decay * p0[n]
        want = p0[n] - lr * g_adam / (g_adam.abs() + 1e-8)
        err = max(err, float((side["state"][n] - want).abs().max()))
    return err


def _bn_rel(got: dict, want: dict) -> float:
    return max(float((got[k] - w).abs().max() / w.abs().max().clamp_min(1e-30))
               for k, w in want.items() if k.endswith((".mean", ".var")))


def phase_train_card_vs_cpu(tp, g, l, lr):
    """One train step on the card and on the CPU (`_card_and_cpu_steps`):
    stats, gradients, BatchNorm statistics and the first Adam update."""
    card, host, p0 = _card_and_cpu_steps(tp, g, l, lr)
    stat_rel = max(abs(card["stats"][k] - host["stats"][k]) / max(abs(host["stats"][k]), 1e-12)
                   for k in host["stats"])
    per_leaf = sorted(((float((card["grads"][n] - w).abs().max() / w.abs().max().clamp_min(1e-30)),
                        float((card["grads"][n] - w).norm() / w.norm().clamp_min(1e-30)), n)
                       for n, w in host["grads"].items()), reverse=True)
    grad_rel = per_leaf[0][0]
    log(f"[train] card vs CPU, worst gradient leaves (max abs err / max, l2 err / l2): "
        f"{[(round(a, 6), round(b, 7), n) for a, b, n in per_leaf[:6]]}")
    bn_rel = _bn_rel(card["state"], host["state"])
    grad_l2 = max(b for _, b, _ in per_leaf)
    upd_err = max(_adam_closed_form_err(side, p0, tp, lr) for side in (card, host))
    log(f"[train] card vs CPU, one step on 4 global clouds + 2 pairs: stats rel {stat_rel:.3g}, "
        f"grads max abs err / leaf max {grad_rel:.3g}, l2 err / leaf l2 {grad_l2:.3g}, "
        f"BN statistics rel {bn_rel:.3g}, first Adam update vs closed form {upd_err:.3g} "
        f"(card {card['seconds']:.2f} s, CPU {host['seconds']:.2f} s)")
    # Gradients: ReLU branches and the local losses' argmin matches flip on
    # near-ties between two f32 summation orders, each flip moving a few
    # gradient rows: held at 1e-2 of the leaf's max and 2e-3 of its l2 norm
    # (measured 4.1e-3 and 8.8e-4 on an H100).  The rest in f32 rounding.
    if not (stat_rel <= 1e-4 and grad_rel <= 1e-2 and grad_l2 <= 2e-3 and bn_rel <= 1e-4
            and upd_err <= 1e-6):
        raise AssertionError("card and CPU train steps disagree beyond tolerance")
    return dict(stats_rel=stat_rel, grad_rel=grad_rel, grad_l2_rel=grad_l2, bn_rel=bn_rel,
                update_abs=upd_err, worst_leaves=per_leaf[:6], card_s=card["seconds"],
                cpu_s=host["seconds"])


# ---------------------------------------------------------------------------
# the bf16 train step
# ---------------------------------------------------------------------------

def bf16_grad_check(got: dict, want: dict, local_leaves: bool = False) -> dict:
    """The bf16 step's gradients (names -> CPU tensors) against a reference:
    the l2 error of all leaves together, each leaf's cosine (the worst
    four), and with `local_leaves` the local head's worst leaf (max abs err
    / max, l2 err / l2); `ok` whether BF16_WHOLE_L2_TOL, BF16_COS_MIN and,
    with `local_leaves`, BF16_GRAD_MAX_TOL and BF16_GRAD_L2_TOL hold."""
    names = sorted(want)
    a = torch.cat([got[n].reshape(-1).double() for n in names])
    b = torch.cat([want[n].reshape(-1).double() for n in names])
    whole = float((a - b).norm() / b.norm())
    cos = sorted((float(torch.nn.functional.cosine_similarity(
        got[n].reshape(1, -1).double(), want[n].reshape(1, -1).double())), n) for n in names)
    out = dict(whole_l2=whole, cos_worst=cos[:4],
               ok=whole <= BF16_WHOLE_L2_TOL and cos[0][0] >= BF16_COS_MIN)
    if local_leaves:
        local = [n for n in names if n.startswith("local_")]
        out["local_max"] = max(float((got[n] - want[n]).abs().max()
                                     / want[n].abs().max().clamp_min(1e-30)) for n in local)
        out["local_l2"] = max(float((got[n] - want[n]).norm() / want[n].norm().clamp_min(1e-30))
                              for n in local)
        out["ok"] = (out["ok"] and out["local_max"] <= BF16_GRAD_MAX_TOL
                     and out["local_l2"] <= BF16_GRAD_L2_TOL)
    return out


def _bf16_card_vs_cpu(tp, g, l, lr) -> dict:
    """Phase 5's card-vs-CPU step with bf16 activations on both sides: stats
    within BF16_REL_TOL, gradients by `bf16_grad_check`, BatchNorm running
    statistics within BF16_REL_TOL, each side's first Adam update its
    closed form within 1e-6."""
    card, host, p0 = _card_and_cpu_steps(tp, g, l, lr, cpu_bf16=True)
    stat_rel = max(abs(card["stats"][k] - host["stats"][k]) / max(abs(host["stats"][k]), 1e-12)
                   for k in host["stats"])
    grads = bf16_grad_check(card["grads"], host["grads"])
    bn_rel = _bn_rel(card["state"], host["state"])
    upd_err = max(_adam_closed_form_err(side, p0, tp, lr) for side in (card, host))
    types_ = {str(v.dtype) for side in (card, host) for v in side["grads"].values()}
    per_leaf = sorted(((float((card["grads"][n] - w).norm() / w.norm().clamp_min(1e-30)), n)
                       for n, w in host["grads"].items()), reverse=True)
    log(f"[bf16-train] card vs CPU (bf16 on both), one step on 4 global clouds + 2 pairs: stats "
        f"rel {stat_rel:.3g}; gradients l2 over all leaves {grads['whole_l2']:.3g}, worst "
        f"cosines {[(round(c, 4), n) for c, n in grads['cos_worst']]}, worst leaves' l2 "
        f"{[(round(e, 4), n) for e, n in per_leaf[:4]]}; BN statistics rel {bn_rel:.3g}; "
        f"first Adam update vs closed form {upd_err:.3g}; gradient types {sorted(types_)} (card "
        f"{card['seconds']:.2f} s, CPU {host['seconds']:.2f} s)")
    if not (stat_rel <= BF16_REL_TOL and grads["ok"] and bn_rel <= BF16_REL_TOL
            and upd_err <= 1e-6 and types_ == {"torch.float32"}):
        raise AssertionError("bf16: card and CPU train steps disagree beyond tolerance")
    return dict(stats_rel=stat_rel, grads=grads, bn_rel=bn_rel, update_abs=upd_err,
                card_s=card["seconds"], cpu_s=host["seconds"])


def _step_turns(tp, g, l, lr) -> dict:
    """Train steps/s (host clock, ending in a synchronize) and peak device
    memory of the f32 and the bf16 step on one model, in BF16_TRAIN_ROUNDS
    rounds of turns f32, bf16, bf16, f32: each turn one warm-up step, then
    BF16_TRAIN_TIMED steps."""
    from egonn_tpu_torch.models.factory import create_egonn_model
    from egonn_tpu_torch.train.trainer import make_train_step

    device = g["clouds"].device
    step = make_train_step(create_egonn_model(tp.model_params, cap0=CAP0, device=device,
                                              seed=SEED + 1), tp)
    turns, peak = {"f32": [], "bf16": []}, {"f32": 0.0, "bf16": 0.0}
    for i, kind in enumerate(("f32", "bf16", "bf16", "f32") * BF16_TRAIN_ROUNDS):
        if kind == "bf16":
            os.environ["EGONN_BF16_ACTS"] = "1"
        try:
            step(g, l, _gen(device, 100 + i), lr, True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for j in range(BF16_TRAIN_TIMED):
                step(g, l, _gen(device, 200 + 10 * i + j), lr, True)
            torch.cuda.synchronize()
            turns[kind].append(BF16_TRAIN_TIMED / (time.perf_counter() - t0))
            peak[kind] = max(peak[kind], torch.cuda.max_memory_allocated() / 2**30)
        finally:
            os.environ.pop("EGONN_BF16_ACTS", None)
    return dict(steps_per_s=turns, peak_gb=peak,
                median={k: statistics.median(v) for k, v in turns.items()})


def _bf16_loop(kernels, device, smi) -> dict:
    """do_train under the flag: one step at bucket LOOP_BUCKET beside the
    f32 step on the same batch (launches, peak memory), then
    BF16_LOOP_EPOCHS epochs with a checkpoint every epoch (every conv and dW
    launch on the bf16 kernels) and a resume from a copy of the epoch-1
    checkpoint: parameters, BatchNorm statistics and Adam's state bit-equal
    to the uninterrupted run's."""
    from egonn_tpu_torch.models.factory import create_egonn_model
    from egonn_tpu_torch.train import trainer

    names, ds, lds, big = _loop_data()
    tp = _loop_params(names, BF16_LOOP_EPOCHS, save_freq=1)
    built = create_egonn_model(tp.model_params, device=device, seed=SEED + 6)
    lids = lds.valid_ids[:tp.local_batch_size]
    out = dict(bucket={})
    for kind, want in (("f32", TRAIN_STEP_LAUNCHES), ("bf16", BF16_TRAIN_STEP_LAUNCHES)):
        if kind == "bf16":
            os.environ["EGONN_BF16_ACTS"] = "1"
        try:
            launches, peak, b_rows, _ = _bucket_step(tp, built, kernels, ds, lds, big, lids,
                                                     device)
        finally:
            os.environ.pop("EGONN_BF16_ACTS", None)
        torch.cuda.empty_cache()
        log(f"[bf16-loop] {kind} train step at bucket {b_rows} ({len(big)} global clouds + "
            f"{len(lids)} pairs): launches {launches}, peak memory {peak:.2f} GiB on {smi}")
        if launches != want:
            raise AssertionError(f"{kind} step at bucket {b_rows}: launches {launches}")
        out["bucket"][kind] = dict(rows=b_rows, launches=launches, peak_gb=peak)
    del built

    run_dir = OUT_DIR / "train_loop_bf16"
    shutil.rmtree(run_dir, ignore_errors=True)
    os.environ["EGONN_BF16_ACTS"] = "1"
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        state_a, stats_a, name = trainer.do_train(tp, weights_path=str(run_dir / "a"),
                                                  device=device)
        torch.cuda.synchronize()
        out["run_a_s"] = time.perf_counter() - t0
        launches = out["launches"] = kernels.launch_counts()
        (run_dir / "b" / name).mkdir(parents=True)
        for f in ("step_1.pt", "step_1.meta.json"):
            shutil.copy(run_dir / "a" / name / f, run_dir / "b" / name / f)
        t0 = time.perf_counter()
        state_b, _, _ = trainer.do_train(tp, resume_from=str(run_dir / "b" / name),
                                         device=device)
        out["run_b_s"] = time.perf_counter() - t0
    finally:
        os.environ.pop("EGONN_BF16_ACTS", None)
    for e, st in enumerate(stats_a["train"] + stats_a["val"]):
        _finite_stats(st, f"bf16 loop record {e}")
    xa, xb = _loop_state(state_a), _loop_state(state_b)
    diff = out["resume"] = _state_diff(xa, xb)
    f32_types = sorted({str(v.dtype) for v in xa.values() if v.is_floating_point()})
    log(f"[bf16-loop] {BF16_LOOP_EPOCHS} epochs in {out['run_a_s']:.1f} s, launches {launches}; "
        f"resumed at epoch 1 in {out['run_b_s']:.1f} s: {diff['unequal']} of {diff['leaves']} "
        f"state tensors differ from the uninterrupted run's; state types {f32_types}")
    f32_launched = [k for k in ("gather_conv", "tdown", "gather_dw") if launches[k]]
    missing = [k for k in ("gather_conv_bf16", "tdown_bf16", "gather_dw_bf16") if not launches[k]]
    if f32_launched or missing:
        raise AssertionError(f"bf16 loop: split-TF32 launches {f32_launched}, no launch of "
                             f"{missing}")
    if diff["unequal"] or f32_types != ["torch.float32"]:
        raise AssertionError(f"bf16 loop: the resumed run differs: {diff}, types {f32_types}")
    shutil.rmtree(run_dir, ignore_errors=True)
    return out


def phase_bf16_train(tp, g, l, lr, kernels, cycles_per_ms, levels, smi):
    """Phase 5b: phases 4-5's train step with EGONN_BF16_ACTS=1 (set by the
    phase alone): launches per train step BF16_TRAIN_STEP_LAUNCHES and per
    validation step BF16_VAL_STEP_LAUNCHES (no split-TF32 conv or dW); every
    kernel call of one train step and one validation step held against its
    plain version (bf16 convs within one bf16 ulp, gather_dw_bf16 within
    DW_REL_TOL of max |plain|) and each distinct shape timed (median of 10),
    the conv and dW calls beside the split-TF32 kernels on the same calls
    in f32; the largest gather_dw_bf16 call re-run bit-equal; a card vs CPU
    step (bf16 forced on the CPU); steps/s and peak memory beside the f32
    step's; the training loop under the flag (`_bf16_loop`).  Returns the
    two paths' rows and the phase's numbers."""
    from egonn_tpu_torch.models.factory import create_egonn_model
    from egonn_tpu_torch.sparse import conv as sconv
    from egonn_tpu_torch.train.trainer import make_train_step

    device = g["clouds"].device
    out = {}
    os.environ["EGONN_BF16_ACTS"] = "1"
    try:
        if sconv.activation_dtype(device) != torch.bfloat16:
            raise AssertionError("EGONN_BF16_ACTS=1 did not give bf16 activations on the card")
        step = make_train_step(create_egonn_model(tp.model_params, cap0=CAP0, device=device,
                                                  seed=SEED + 1), tp)
        step(g, l, _gen(device, 1), lr, True)  # warm-up
        _, train_launches = _path_launches(
            kernels, lambda: step(g, l, _gen(device, 2), lr, True), BF16_TRAIN_STEP_LAUNCHES,
            "bf16 train step", tag="bf16-train")
        _, val_launches = _path_launches(
            kernels, lambda: step(g, l, None, lr, False), BF16_VAL_STEP_LAUNCHES,
            "bf16 validation step", tag="bf16-train")
        train_rows, calls = _measured_path(
            kernels, lambda: step(g, l, _gen(device, SEED), lr, True), train_launches,
            cycles_per_ms, 10, "bf16-train-kernels", levels)
        val_rows, val_calls = _measured_path(
            kernels, lambda: step(g, l, None, lr, False), val_launches, cycles_per_ms, 10,
            "bf16-val-kernels", levels)
        out["repeat"] = check_repeat(kernels, calls, "gather_dw", "bf16-train-kernels")
        f32_ms = split_tf32_ms(kernels, calls, ("gather_conv", "gather_dw"), cycles_per_ms, 10)
        f32_ms["tdown"] = split_tf32_ms(kernels, val_calls, ("tdown",), cycles_per_ms, 10)["tdown"]
        sm80_ms = {"train": sm80_body_ms(kernels, calls, ("gather_conv", "gather_dw"),
                                         cycles_per_ms, 10, "bf16-train-kernels", levels),
                   "validation": sm80_body_ms(kernels, val_calls, ("gather_conv",),
                                              cycles_per_ms, 10, "bf16-val-kernels", levels)}
        out["conv_repeat"] = check_repeat(kernels, calls, "gather_conv", "bf16-train-kernels")
        del calls, val_calls
        for path, rows, names in (("train", train_rows, ("gather_conv", "gather_dw")),
                                  ("validation", val_rows, ("gather_conv", "tdown"))):
            for name in names:
                r = rows[BF16_ROWS[name]]
                notes = []
                if path == "train" or name == "tdown":
                    notes.append(f"split TF32 on the same calls {f32_ms[name]:.4f}")
                if name in sm80_ms[path]:
                    notes.append(f"the SM80 body {sm80_ms[path][name]:.4f}")
                split = f" ({', '.join(notes)})" if notes else ""
                log(f"[bf16-train] {BF16_ROWS[name]}: {r['launches']} launches, {r['ms']:.4f} ms "
                    f"per {path} step{split}, bound {r['bound_ms']:.4f} "
                    f"({'bytes' if r['_bytes_ms'] >= r['_ops_ms'] else 'operations'}), "
                    f"tc_bound {r['tc_bound_ms']:.4f}, plain {r['plain_ms']:.4f}, max abs err "
                    f"{r['max_abs_err']:.3g} on {smi}")
        out.update(train_launches=train_launches, val_launches=val_launches,
                   split_tf32_ms=f32_ms, sm80_body_ms=sm80_ms)
        del step
        torch.cuda.empty_cache()
        out["card_vs_cpu"] = _bf16_card_vs_cpu(tp, g, l, lr)
    finally:
        os.environ.pop("EGONN_BF16_ACTS", None)
    turns = out["turns"] = _step_turns(tp, g, l, lr)
    n_clouds = g["clouds"].shape[0] + 2 * l["anc_clouds"].shape[0]
    med = turns["median"]
    log(f"[bf16-train] train steps/s (host clock, {BF16_TRAIN_TIMED} steps of {n_clouds} clouds "
        f"a turn): bf16 median {med['bf16']:.3f} "
        f"{[round(t, 3) for t in turns['steps_per_s']['bf16']]} against f32 median "
        f"{med['f32']:.3f} {[round(t, 3) for t in turns['steps_per_s']['f32']]} "
        f"({med['bf16'] * n_clouds:.1f} / {med['f32'] * n_clouds:.1f} clouds/s); peak memory "
        f"bf16 {turns['peak_gb']['bf16']:.2f} GiB, f32 {turns['peak_gb']['f32']:.2f} GiB on {smi}")
    torch.cuda.empty_cache()
    out["loop"] = _bf16_loop(kernels, device, smi)
    return {"bf16_train_step": train_rows, "bf16_val_step": val_rows}, out


# ---------------------------------------------------------------------------
# MinkLoc and lookup
# ---------------------------------------------------------------------------

def _path_launches(kernels, run, expected: dict, what: str, tag: str = "minkloc"):
    """run() with every launch counter zeroed just before and read just
    after; fails unless the counts are `expected`."""
    kernels.reset_launches()
    out = run()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    bodies = kernels.body_launch_counts()
    log(f"[{tag}] launches per {what}: {launches}")
    if launches != expected:
        raise AssertionError(f"{what}: launches {launches}, expected {expected}")
    if any(launches[name] for name in bodies):
        log(f"[{tag}] bf16 launches per {what} by body (the rules' choice): {bodies}")
        missing = [name for name in bodies if launches[name] and not bodies[name]["sm90"]]
        if missing:
            raise AssertionError(f"{what}: no launch of the Hopper body of {missing}")
    return out, launches


def _measured_path(kernels, run, launches: dict, cycles_per_ms, reps, tag, levels):
    """Every kernel call of run() held against its plain version and timed;
    rows with this path's launch counts, and the calls."""
    rows = new_rows(kernels)
    calls = record_calls(kernels, run)
    measure_calls(rows, calls, kernels, cycles_per_ms, reps=reps, tag=tag, levels=levels)
    for name, row in rows.items():
        row["launches"] = launches[name]
    return rows, calls


def phase_lookup_maps(built, kernels, pyramid_mod, cycles_per_ms):
    """Phase 2's clouds and EgoNN spec, the pyramid built again without up
    maps: kmap_down at L1-L7 from one launch of the lookup kernel, equal to
    the inverted up maps and to `lookup_down_plain`, bit-equal on repeat."""
    clouds, mask = make_inputs(built.device)
    spec = built.pyramid_spec
    res = built.quantizer.quantize(clouds, mask, spec.capacities[0], need_index=False)
    no_up = dataclasses.replace(spec, up_levels=())

    def build():
        return pyramid_mod.build_pyramid(res.coords_t, res.mask, no_up, keys0=res.keys)

    looked_up, launches = _path_launches(kernels, build, LOOKUP_MAPS_LAUNCHES,
                                         "pyramid without up maps")
    inverted = pyramid_mod.build_pyramid(res.coords_t, res.mask, spec, keys0=res.keys,
                                         with_kmap_down=True)
    valid = []
    for l in range(1, spec.num_levels + 1):
        if not torch.equal(looked_up[l].kmap_down, inverted[l].kmap_down):
            raise AssertionError(f"L{l}: looked-up kmap_down differs from the inverted up map")
        valid.append(int((looked_up[l].kmap_down < spec.capacities[l - 1]).sum()))
    log(f"[minkloc] EgoNN kmap_down L1-L7 by lookup equal the inverted up maps; valid "
        f"entries per level {valid}")
    rows, calls = _measured_path(kernels, build, launches, cycles_per_ms, reps=20,
                                 tag="lookup-maps", levels=level_of(spec.capacities))
    return rows, dict(launches=launches, kmap_down_valid=valid,
                      repeat=check_repeat(kernels, calls, "lookup_down", "lookup-maps"))


def _minkloc_params():
    from egonn_tpu_torch.config import ModelParams

    mp = ModelParams(str(ROOT / "model_configs" / "minkloc3d_mulran.txt"))
    got = (mp.model, mp.coordinates, mp.quantization_step, mp.planes, mp.layers,
           mp.num_top_down, mp.conv0_kernel_size, mp.block, mp.pooling, mp.feature_size,
           mp.output_dim)
    if got != ("MinkFPN", "cartesian", 0.3, [32, 64, 64], [1, 1, 1], 1, 5, "ECABasicBlock",
               "GeM", 256, 256):
        raise AssertionError(f"unexpected MinkLoc model parameters {got}")
    return mp


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.cpu() - want.cpu()).abs().max() / want.abs().max())


def phase_minkloc(kernels, inference, pyramid_mod, cycles_per_ms, device):
    from egonn_tpu_torch.models.factory import model_factory

    built = model_factory(_minkloc_params(), cap0=MINKLOC_CAP0, device=device, seed=SEED + 3)
    spec = built.pyramid_spec
    if spec.capacities != (40960, 20480, 10240, 5120) or spec.up_levels != (0, 1, 2):
        raise AssertionError(f"unexpected MinkLoc pyramid spec {spec}")
    lookup_built = dataclasses.replace(
        built, pyramid_spec=dataclasses.replace(spec, up_levels=(2,)))
    clouds, mask = make_inputs(device)
    res = built.quantizer.quantize(clouds, mask, spec.capacities[0], need_index=False)
    report = pyramid_mod.capacity_report(
        pyramid_mod.build_pyramid(res.coords_t, res.mask, spec, keys0=res.keys), spec)
    log(f"[minkloc] capacity report: {report}")
    if not all(ok for _, _, ok in report.values()):
        raise AssertionError(f"capacity overflow: {report}")

    outs, launches = {}, {}
    for name, b, expected in (("minkloc", built, MINKLOC_LAUNCHES),
                              ("minkloc_lookup", lookup_built, MINKLOC_LOOKUP_LAUNCHES)):
        y, launches[name] = _path_launches(
            kernels, lambda: inference.forward(b, clouds, mask), expected, f"{name} forward")
        g = y["global"]
        if set(y) != {"global"} or tuple(g.shape) != (B, 256) or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: outputs { {k: tuple(v.shape) for k, v in y.items()} }")
        outs[name] = g
    spec_rel = _rel_err(outs["minkloc_lookup"], outs["minkloc"])
    spec_equal = torch.equal(outs["minkloc_lookup"], outs["minkloc"])
    log(f"[minkloc] global ({B}, 256) finite; lookup-built vs up-map pyramid: rel {spec_rel:.3g}, "
        f"bit-equal {spec_equal}")
    if not spec_rel <= 1e-6:
        raise AssertionError("the two pyramids give different MinkLoc outputs")

    rows, repeat = {}, None
    for name, b in (("minkloc", built), ("minkloc_lookup", lookup_built)):
        rows[name], calls = _measured_path(
            kernels, lambda: inference.forward(b, clouds, mask), launches[name], cycles_per_ms,
            reps=10, tag=f"{name}-kernels", levels=level_of(spec.capacities))
        if name == "minkloc_lookup":
            repeat = check_repeat(kernels, calls, "lookup_down", f"{name}-kernels")

    # the same weights on the CPU, 2 clouds, one shared quantization
    cpu = torch.device("cpu")
    model_cpu = copy.deepcopy(built.model).to(cpu)
    c2, m2 = make_inputs(cpu, b=2, seed=SEED + 1)
    res2 = built.quantizer.quantize(c2.to(device), m2.to(device), spec.capacities[0],
                                    need_index=False)
    cpu_rel = {}
    for name, b in (("minkloc", built), ("minkloc_lookup", lookup_built)):
        pg = pyramid_mod.build_pyramid(res2.coords_t, res2.mask, b.pyramid_spec, keys0=res2.keys)
        pc = pyramid_mod.build_pyramid(res2.coords_t.cpu(), res2.mask.cpu(), b.pyramid_spec,
                                       keys0=res2.keys.cpu())
        for l in range(spec.num_levels + 1):
            for field in ("coords", "mask", "kmap_self", "kmap_down", "up_parent", "up_koffset"):
                a, c = getattr(pg[l], field), getattr(pc[l], field)
                if (a is None) != (c is None) or (a is not None and not torch.equal(a.cpu(), c)):
                    raise AssertionError(f"{name} L{l} {field}: card and CPU pyramids differ")
        with torch.no_grad():
            cpu_rel[name] = _rel_err(built.model(pg)["global"], model_cpu(pc)["global"])
    log(f"[minkloc] card vs CPU, 2 clouds, shared quantization: pyramids bit-equal; global rel "
        f"{cpu_rel}")
    if not max(cpu_rel.values()) <= 1e-5:
        raise AssertionError("card and CPU MinkLoc forwards disagree beyond tolerance")

    # throughput on varied inputs: the two pyramids in turns, 10 forwards a
    # turn, the order swapped every round; the median turn of each
    gen = torch.Generator(device=device).manual_seed(SEED)
    iters = 10
    variants = [clouds + 0.01 * torch.randn(clouds.shape, generator=gen, device=device)
                for _ in range(iters)]
    paths = [("minkloc", built), ("minkloc_lookup", lookup_built)]
    turns = {name: [] for name, _ in paths}
    for rnd in range(MINKLOC_ROUNDS):
        for name, b in paths[::1 if rnd % 2 == 0 else -1]:
            inference.forward(b, variants[0], mask)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for v in variants:
                inference.forward(b, v, mask)
            torch.cuda.synchronize()
            turns[name].append(B * iters / (time.perf_counter() - t0))
    rates = {name: statistics.median(r) for name, r in turns.items()}
    return rows, dict(launches=launches, capacity=report, spec_rel=spec_rel,
                      spec_bit_equal=spec_equal, card_vs_cpu_rel=cpu_rel, clouds_per_s=rates,
                      clouds_per_s_turns=turns, lookup_repeat=repeat)


# ---------------------------------------------------------------------------
# ResNet14
# ---------------------------------------------------------------------------

def _resnet_features(quantizer, res) -> torch.Tensor:
    """The stem's one feature per voxel: its centre's z (`dequantize` of the
    voxel coords, as `_voxel_centres` places points), RESNET_Z_SCALE per
    metre, zero on padding rows.  (B, C0, 1), so the stem's F_in = 1 runs
    through the width plan."""
    z = quantizer.dequantize(res.coords_t.transpose(-1, -2))[..., 2:3] * RESNET_Z_SCALE
    return torch.where(res.mask[..., None], z, 0.0).contiguous()


def resnet_spec(pyramid_mod):
    """ResNet14's pyramid: self maps at L1-L4, no up maps, real stem features."""
    return pyramid_mod.PyramidSpec(capacities=RESNET_CAPACITIES, conv0_kernel_size=5,
                                   block_kernel_size=3, self_levels=(1, 2, 3, 4), up_levels=(),
                                   conv0_ones=False, need_source_index=False)


def phase_resnet(kernels, pyramid_mod, cycles_per_ms, device):
    """ResNet14 (BasicBlock, planes 64-512, init_dim 64, in_channels 1, 5^3
    stem), seeded weights, on phase 2's 8 clouds through MinkLoc's cartesian
    0.3 m quantizer: capacity, launch counts, every kernel call against its
    plain version and timed, the grouped lookup re-run bit-equal, card vs
    CPU on 2 clouds from one shared quantization, clouds/s."""
    from egonn_tpu_torch.models.resnet import ResNetBase

    quantizer = _minkloc_params().quantizer
    spec = resnet_spec(pyramid_mod)
    model = ResNetBase(1, torch.Generator().manual_seed(SEED + 4), planes=RESNET_PLANES,
                       layers=(1, 1, 1, 1), block="BasicBlock", conv0_kernel_size=5,
                       init_dim=RESNET_INIT_DIM).eval()
    model_cpu = copy.deepcopy(model)
    model = model.to(device)

    def forward(net, clouds, mask):
        res = quantizer.quantize(clouds, mask, spec.capacities[0], need_index=False)
        pyr = pyramid_mod.build_pyramid(res.coords_t, res.mask, spec, keys0=res.keys)
        with torch.no_grad():
            return net(pyr, _resnet_features(quantizer, res))

    clouds, mask = make_inputs(device)
    res = quantizer.quantize(clouds, mask, spec.capacities[0], need_index=False)
    report = pyramid_mod.capacity_report(
        pyramid_mod.build_pyramid(res.coords_t, res.mask, spec, keys0=res.keys), spec)
    log(f"[resnet] capacity report: {report}")
    if not all(ok for _, _, ok in report.values()):
        raise AssertionError(f"capacity overflow: {report}")
    y, launches = _path_launches(kernels, lambda: forward(model, clouds, mask), RESNET_LAUNCHES,
                                 "ResNet14 forward", tag="resnet")
    widths = dict(zip((1, 2, 3, 4), RESNET_PLANES))
    for l, f in y.items():
        if tuple(f.shape) != (B, RESNET_CAPACITIES[l], widths[l]) or not bool(torch.isfinite(f).all()):
            raise AssertionError(f"ResNet14 level {l}: shape {tuple(f.shape)} or non-finite")
    log(f"[resnet] outputs { {l: tuple(f.shape) for l, f in y.items()} } finite")
    rows, calls = _measured_path(kernels, lambda: forward(model, clouds, mask), launches,
                                 cycles_per_ms, reps=10, tag="resnet-kernels",
                                 levels=level_of(spec.capacities))
    repeat = check_repeat(kernels, calls, "lookup_down", "resnet-kernels")

    # the same weights on the CPU, 2 clouds, one shared quantization
    c2, m2 = make_inputs(device, b=2, seed=SEED + 1)
    res2 = quantizer.quantize(c2, m2, spec.capacities[0], need_index=False)
    pg = pyramid_mod.build_pyramid(res2.coords_t, res2.mask, spec, keys0=res2.keys)
    pc = pyramid_mod.build_pyramid(res2.coords_t.cpu(), res2.mask.cpu(), spec,
                                   keys0=res2.keys.cpu())
    for l in range(spec.num_levels + 1):
        for field in ("coords", "mask", "kmap_self", "kmap_down"):
            a, c = getattr(pg[l], field), getattr(pc[l], field)
            if (a is None) != (c is None) or (a is not None and not torch.equal(a.cpu(), c)):
                raise AssertionError(f"ResNet14 L{l} {field}: card and CPU pyramids differ")
    feats2 = _resnet_features(quantizer, res2)
    with torch.no_grad():
        yg, yc = model(pg, feats2), model_cpu(pc, feats2.cpu())
    cpu_rel = {l: _rel_err(yg[l], yc[l]) for l in yc}
    log(f"[resnet] card vs CPU, 2 clouds, shared quantization: pyramids bit-equal; level "
        f"outputs rel {cpu_rel}")
    if not max(cpu_rel.values()) <= FLOAT_REL_TOL:
        raise AssertionError("card and CPU ResNet14 forwards disagree beyond tolerance")

    # throughput on varied inputs: RESNET_ROUNDS turns of 10 forwards
    gen = torch.Generator(device=device).manual_seed(SEED)
    iters = 10
    variants = [clouds + 0.01 * torch.randn(clouds.shape, generator=gen, device=device)
                for _ in range(iters)]
    turns = []
    for _ in range(RESNET_ROUNDS):
        forward(model, variants[0], mask)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for v in variants:
            forward(model, v, mask)
        torch.cuda.synchronize()
        turns.append(B * iters / (time.perf_counter() - t0))
    return rows, dict(launches=launches, capacity=report, card_vs_cpu_rel=cpu_rel,
                      clouds_per_s=statistics.median(turns), clouds_per_s_turns=turns,
                      lookup_repeat=repeat)


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def _eval_set_launches(n_batches: int, per_batch: dict = EVAL_BATCH_LAUNCHES) -> dict:
    """Launches of an evaluation over n_batches embedding batches: each an
    eval forward (`per_batch`), plus the capacity check's pyramid on the
    first batch."""
    out = {k: n_batches * v for k, v in per_batch.items()}
    out["zrun_presence"] += 1
    out["zrun_rank"] += 7
    return out


@torch.no_grad()
def _perturb_bn(model, seed: int) -> None:
    """Seeded random statistics and affines for every BatchNorm (as the CPU
    tests do): at its initial statistics the random model's local
    descriptors are almost equal, so mutual matching would turn on
    nearest-neighbour gaps at f32 rounding."""
    from egonn_tpu_torch.sparse.norm import SparseBatchNorm

    gen = torch.Generator().manual_seed(seed)
    for bn in (m for m in model.modules() if isinstance(m, SparseBatchNorm)):
        f = bn.scale.shape[0]

        def draw(lo, hi):
            return (lo + (hi - lo) * torch.rand(f, generator=gen)).to(bn.scale.device)

        bn.scale.copy_(draw(0.5, 1.5))
        bn.bias.copy_(0.2 * torch.randn(f, generator=gen).to(bn.scale.device))
        bn.mean.copy_(0.2 * torch.randn(f, generator=gen).to(bn.scale.device))
        bn.var.copy_(draw(0.5, 2.0))


def _known_transform_pairs(gen, n_pairs: int):
    """tests/test_ransac.py's make_pair at evaluation sizes: K keypoints with
    unit descriptors shared by matched pairs, a quarter of cloud 2's
    descriptors random (outliers), yaw up to 180 deg, translation up to 10 m,
    noise 0.05 m; four padding rows per cloud 1 far away."""
    import numpy as np

    from egonn_tpu_torch.ops.geometry import rotz

    k, n_out = RANSAC_K, RANSAC_K // 4
    kp1 = gen.uniform(-40, 40, (n_pairs, k, 3)).astype(np.float32)
    t = np.stack([rotz(a) for a in gen.uniform(0, np.pi, n_pairs)]).astype(np.float32)
    t[:, :3, 3] = gen.uniform(-10, 10, (n_pairs, 3))
    kp2 = (np.einsum("pkj,pij->pki", kp1, t[:, :3, :3]) + t[:, None, :3, 3]
           + gen.normal(0, 0.05, kp1.shape)).astype(np.float32)
    d1 = gen.standard_normal((n_pairs, k, RANSAC_DIM)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 = d1.copy()
    d2[:, :n_out] = gen.standard_normal((n_pairs, n_out, RANSAC_DIM))
    d2[:, :n_out] /= np.linalg.norm(d2[:, :n_out], axis=-1, keepdims=True)
    m1 = np.ones((n_pairs, k), bool)
    m1[:, -4:] = False
    kp1[:, -4:] = 1e6
    return kp1, d1, m1, kp2, d2, np.ones((n_pairs, k), bool), t


def _ransac_card_vs_cpu(ransac, args_cpu, device, n_hyp: int, samples) -> dict:
    """ransac_6dof on the card and on the CPU from the same draws."""
    got = ransac.ransac_6dof(*(a.to(device) for a in args_cpu), n_hypotheses=n_hyp,
                             samples=samples.to(device))
    want = ransac.ransac_6dof(*args_cpu, n_hypotheses=n_hyp, samples=samples)
    err = float((got.transform.cpu() - want.transform).abs().max())
    same = (torch.equal(got.n_inliers.cpu(), want.n_inliers)
            and torch.equal(got.n_matches.cpu(), want.n_matches))
    if not (err <= 1e-4 and same):
        raise AssertionError(f"RANSAC card vs CPU at H {n_hyp}: transform err {err}, counts "
                             f"equal {same}")
    return dict(transform_abs=err, counts_equal=same, card=got)


def _align_keypoints(got: dict, want: dict, sigma_tol: float = 1e-4) -> tuple:
    """Card (got) against CPU (want) selected keypoints: per cloud the card
    rank of each CPU keypoint (matched by position within 1e-3 m).  A
    keypoint at another rank must be a near-tie: the CPU sigmas at the two
    ranks within sigma_tol relative.  Returns (perm, near-tie swaps,
    clouds whose keypoints could not be matched)."""
    import numpy as np

    b, k = want["kp_valid"].shape
    perm = np.tile(np.arange(k), (b, 1))
    swaps, unmatched = 0, []
    for i in range(b):
        for r in np.nonzero(want["kp_valid"][i])[0]:
            d = np.linalg.norm(got["keypoints"][i] - want["keypoints"][i, r], axis=1)
            d[~got["kp_valid"][i]] = np.inf
            r2 = int(np.argmin(d))
            if d[r2] > 1e-3:
                unmatched.append(i)
                break
            if r2 != r:
                swaps += 1
                if not abs(want["sigma"][i, r2] - want["sigma"][i, r]) <= \
                        sigma_tol * want["sigma"][i, r]:
                    raise AssertionError(f"cloud {i}: keypoint rank {r} -> {r2} is no near-tie")
            perm[i, r] = r2
    return perm, swaps, unmatched


def _host_syncs(fn) -> list:
    """The source lines (file:line) of the operations of one fn() call that
    synchronize the host with the card (PyTorch's sync debug mode warns on
    each)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return [f"{pathlib.Path(w.filename).name}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message)]


def _l0_keys(built, clouds, mask):
    spec = built.pyramid_spec
    return built.quantizer.quantize(clouds, mask, spec.capacities[0], need_index=False).keys


def _eval_card_vs_cpu(ev_cls, built, ransac, device) -> dict:
    """The debug subset (4 map + 4 query scans) on the card and on the CPU,
    same weights: global embeddings (rel 1e-4), the selected keypoints
    (1e-3 m), descriptors (1e-4) and sigma (rel 1e-4) after aligning near-tie
    swaps of the sigma order, top1_ndx equal; RANSAC on the CPU's selection
    from one set of draws on both.  Clouds whose level-0 voxels differ
    between the devices (an atan2 ulp) are reported and excluded."""
    import numpy as np

    cpu = torch.device("cpu")
    built_cpu = dataclasses.replace(built, model=copy.deepcopy(built.model).to(cpu), device=cpu)
    evs = [ev_cls(str(EVAL_DIR), "synthetic", "test_synthetic.pickle", b, num_points=N_POINTS,
                  batch_size=4, debug=True, n_k=EVAL_N_K, n_hypotheses=EVAL_HYPOTHESES)
           for b in (built, built_cpu)]
    out = dict(excluded=[], near_tie_swaps=0)
    emb = {}
    for name, subset in (("map", evs[1].eval_set.map_set), ("query", evs[1].eval_set.query_set)):
        clouds, mask = evs[1].load_clouds(subset, len(subset))
        c, m = torch.from_numpy(clouds), torch.from_numpy(mask)
        differ = [i for i, same in enumerate(
            (_l0_keys(built, c.to(device), m.to(device)).cpu() == _l0_keys(built_cpu, c, m))
            .all(1).tolist()) if not same]
        out["excluded"] += [f"{name} {i}" for i in differ]
        got, want = (ev.compute_embeddings(subset, with_local=True, n_k=max(EVAL_N_K))
                     for ev in evs)
        emb[name] = (got, want)
        keep = np.array([i not in differ for i in range(len(subset))])
        g_rel = float(np.abs(got["global"][keep] - want["global"][keep]).max()
                      / np.abs(want["global"][keep]).max())
        sub = {k: v[keep] for k, v in got.items()}
        wsub = {k: v[keep] for k, v in want.items()}
        if not np.array_equal(sub["kp_valid"], wsub["kp_valid"]):
            raise AssertionError(f"{name}: selected keypoint validity differs card vs CPU")
        perm, swaps, unmatched = _align_keypoints(sub, wsub)
        if unmatched:
            raise AssertionError(f"{name}: CPU keypoints the card did not select in clouds "
                                 f"{unmatched}")
        v = wsub["kp_valid"]

        def aligned(key):
            return np.take_along_axis(sub[key], perm[..., None] if sub[key].ndim == 3 else perm,
                                      1)

        errs = dict(global_rel=g_rel,
                    keypoints_abs=float(np.abs(aligned("keypoints")[v] - wsub["keypoints"][v])
                                        .max()),
                    descriptors_abs=float(np.abs(aligned("descriptors")[v]
                                                 - wsub["descriptors"][v]).max()),
                    sigma_rel=float((np.abs(aligned("sigma")[v] - wsub["sigma"][v])
                                     / wsub["sigma"][v]).max()))
        out[name] = errs
        out["near_tie_swaps"] += swaps
        log(f"[eval] card vs CPU, debug {name} set: {errs}, near-tie swaps of the sigma order "
            f"{swaps}, clouds with differing voxels {differ}")
        if not (g_rel <= 1e-4 and errs["keypoints_abs"] <= 1e-3
                and errs["descriptors_abs"] <= 1e-4 and errs["sigma_rel"] <= 1e-4):
            raise AssertionError(f"{name}: card and CPU embeddings disagree beyond tolerance")
    tops = [evs[i].compute_recall(emb["map"][i]["global"], emb["query"][i]["global"])["top1_ndx"]
            for i in (0, 1)]
    if not np.array_equal(*tops):
        raise AssertionError(f"top1_ndx card {tops[0]} vs CPU {tops[1]}")
    out["top1_ndx"] = tops[1].tolist()
    # RANSAC on the CPU's selection of every query and its top-1, one set of draws
    (_, wq), (_, wm) = emb["query"], emb["map"]
    top1 = tops[1]
    for n_k in EVAL_N_K:
        args = [torch.from_numpy(np.ascontiguousarray(a)) for a in
                (wq["keypoints"][:, :n_k], wq["descriptors"][:, :n_k], wq["kp_valid"][:, :n_k],
                 wm["keypoints"][top1, :n_k], wm["descriptors"][top1, :n_k],
                 wm["kp_valid"][top1, :n_k])]
        valid = ransac.mutual_matches(args[1], args[2], args[4], args[5])[1]
        samples = ransac.draw_samples(valid, EVAL_HYPOTHESES, torch.Generator().manual_seed(0))
        r = _ransac_card_vs_cpu(ransac, args, device, EVAL_HYPOTHESES, samples)
        out[f"ransac_n_k_{n_k}"] = dict(transform_abs=r["transform_abs"],
                                        n_inliers=r["card"].n_inliers.tolist())
        log(f"[eval] card vs CPU, RANSAC n_k {n_k} on the debug pairs from the same draws: "
            f"transform abs err {r['transform_abs']:.3g}, n_inliers / n_matches equal "
            f"{r['counts_equal']}")
    return out


def phase_eval(kernels, cycles_per_ms, device, smi):
    """Phase 9: the evaluation path on the card (see the module docstring)."""
    import numpy as np

    from egonn_tpu_torch.config import ModelParams
    from egonn_tpu_torch.data.synthetic import generate_synthetic_dataset
    from egonn_tpu_torch.eval.evaluator import Evaluator, GLEvaluator
    from egonn_tpu_torch.eval.rotations import RotationEvaluator
    from egonn_tpu_torch import inference
    from egonn_tpu_torch.models.factory import create_egonn_model
    from egonn_tpu_torch.ops import knn, ransac
    from egonn_tpu_torch.ops.geometry import rotation_error_deg
    from egonn_tpu_torch.sparse.calibrate import calibrate_capacities

    t0 = time.perf_counter()
    names = generate_synthetic_dataset(str(EVAL_DIR), n_scans=EVAL_SCANS, seed=SEED)
    out = dict(dataset_s=time.perf_counter() - t0, names=list(names))
    mp = ModelParams(str(ROOT / "model_configs" / "egonn.txt"))
    if (mp.model, mp.cap0, mp.num_points) != ("egonn", CAP0, N_POINTS):
        raise AssertionError(f"unexpected EgoNN parameters {(mp.model, mp.cap0, mp.num_points)}")
    built = create_egonn_model(mp, cap0=CAP0, device=device, seed=SEED + 5)
    _perturb_bn(built.model, SEED + 5)
    kw = dict(num_points=N_POINTS, batch_size=B)
    ev = GLEvaluator(str(EVAL_DIR), "synthetic", names[2], built, n_k=EVAL_N_K,
                     n_hypotheses=EVAL_HYPOTHESES, **kw)
    n_map, n_query = len(ev.eval_set.map_set), len(ev.eval_set.query_set)
    log(f"[eval] synthetic set: {EVAL_SCANS} scans ({n_map} map, {n_query} query) in "
        f"{out['dataset_s']:.1f} s, points per scan after ground removal "
        f"{[len(ev.pc_loader(str(EVAL_DIR / e.rel_scan_filepath))) for e in ev.eval_set.map_set[:4]]}"
        f"... padded to {N_POINTS}")
    n_batches = -(-n_map // B) + -(-n_query // B)

    # the GL evaluation, every launch counted
    (g, local), launches = _path_launches(kernels, ev.evaluate, _eval_set_launches(n_batches),
                                          "GL evaluation", tag="eval")
    log(f"[eval] capacity report {ev.capacity_ok}, band_ok {ev.band_ok}")
    if not all(ok for _, _, ok in ev.capacity_ok.values()):
        raise AssertionError(f"capacity overflow: {ev.capacity_ok}")
    recall = {r: [round(float(x), 4) for x in rec[:5]] for r, rec in g["recall"].items()}
    log(f"[eval] Recall@1..5 {recall}, Recall@1% {g['one_percent_recall']}")
    for n_k, st in local.items():
        if st["n_pairs"] == 0:
            raise AssertionError(f"n_k {n_k}: no pair eligible for the local evaluation")
        if not all(math.isfinite(st[k]) for k in ("rte_all", "rre_all", "mean_inliers")):
            raise AssertionError(f"n_k {n_k}: non-finite local metrics {st}")
        log(f"[eval] n_k {n_k}: n_pairs {st['n_pairs']} success_rate {st['success_rate']:.4f} "
            f"rte {st['rte']:.4f} m rre {st['rre']:.4f} deg (rte_all {st['rte_all']:.3f}, "
            f"rre_all {st['rre_all']:.3f}) repeatability {st['repeatability']:.4f} "
            f"mean_inliers {st['mean_inliers']:.2f} mean_matches {st['mean_matches']:.2f} "
            f"t_ransac {st['t_ransac'] * 1e3:.3f} ms per pair (host clock, H "
            f"{EVAL_HYPOTHESES})")
    out.update(gl_launches=launches, recall={str(r): v.tolist() for r, v in g["recall"].items()},
               one_percent_recall={str(r): v for r, v in g["one_percent_recall"].items()},
               local={str(n_k): st for n_k, st in local.items()}, capacity=ev.capacity_ok)

    # one embedding batch: launches, then every kernel call against its plain version
    first = ev.eval_set.map_set[:B]
    _, batch_launches = _path_launches(
        kernels, lambda: ev.compute_embeddings(first, with_local=True, n_k=max(EVAL_N_K)),
        EVAL_BATCH_LAUNCHES, "embedding batch", tag="eval")
    clouds, mask = ev.load_clouds(first, B)
    clouds, mask = torch.from_numpy(clouds).to(device), torch.from_numpy(mask).to(device)
    eval_rows, _ = _measured_path(kernels, lambda: inference.forward(built, clouds, mask),
                                  batch_launches, cycles_per_ms, reps=10, tag="eval-kernels",
                                  levels=level_of(built.pyramid_spec.capacities))
    t0 = time.perf_counter()
    ev.compute_embeddings(ev.eval_set.map_set, with_local=True, n_k=max(EVAL_N_K))
    sec = time.perf_counter() - t0
    out["embed_clouds_per_s"] = n_map / sec
    log(f"[eval] embeddings: {out['embed_clouds_per_s']:.1f} clouds/s over the {n_map} map "
        f"scans, loading and padding included (host clock) on {smi}")

    # the global-only evaluator and the rotation sweep
    evg = Evaluator(str(EVAL_DIR), "synthetic", names[2], built, **kw)
    gm, launches_g = _path_launches(kernels, evg.evaluate,
                                    _eval_set_launches(n_batches, GLOBAL_EVAL_BATCH_LAUNCHES),
                                    "global-only evaluation", tag="eval")
    if not np.array_equal(gm["top1_ndx"], g["top1_ndx"]):
        raise AssertionError("the global-only and GL evaluators retrieve differently")
    rot = RotationEvaluator(str(EVAL_DIR), "synthetic", names[2], built,
                            thetas_deg=EVAL_THETAS, **kw)
    rot_res = rot.evaluate()
    for r in gm["recall"]:
        if not np.array_equal(rot_res[0.0]["recall"][r], gm["recall"][r]):
            raise AssertionError(f"rotation 0: recall at {r} m differs from the Evaluator's")
    rot_r1 = {theta: {str(r): float(rec[0]) for r, rec in m["recall"].items()}
              for theta, m in rot_res.items()}
    log(f"[eval] global-only evaluation: top1_ndx equal to the GL run's; rotation sweep "
        f"Recall@1 {rot_r1} (theta 0 equal to the Evaluator's)")
    out.update(global_launches=launches_g, rotation_recall_at_1=rot_r1)

    # card vs CPU on the debug subset
    t0 = time.perf_counter()
    out["card_vs_cpu"] = _eval_card_vs_cpu(GLEvaluator, built, ransac, device)
    log(f"[eval] card vs CPU done in {time.perf_counter() - t0:.1f} s")

    # RANSAC at evaluation sizes on known-transform pairs
    gen = np.random.default_rng(SEED)
    kp1, d1, m1, kp2, d2, m2, t_gt = _known_transform_pairs(gen, RANSAC_PAIRS)
    args_cpu = [torch.from_numpy(a) for a in (kp1, d1, m1, kp2, d2, m2)]
    args = [a.to(device) for a in args_cpu]
    valid = ransac.mutual_matches(args_cpu[1], args_cpu[2], args_cpu[4], args_cpu[5])[1]
    out["ransac"] = {}
    for n_hyp in RANSAC_HYPOTHESES:
        samples = ransac.draw_samples(valid, n_hyp, torch.Generator().manual_seed(0))
        r = _ransac_card_vs_cpu(ransac, args_cpu, device, n_hyp, samples)
        est = r["card"].transform.cpu()
        rte = (est[:, :3, 3] - torch.from_numpy(t_gt[:, :3, 3])).norm(dim=1)
        rre = rotation_error_deg(est[:, :3, :3], torch.from_numpy(t_gt[:, :3, :3]))
        s_dev = samples.to(device)
        syncs = _host_syncs(lambda: ransac.ransac_6dof(*args, n_hypotheses=n_hyp,
                                                       samples=s_dev))
        ms = device_ms(lambda: ransac.ransac_6dof(*args, n_hypotheses=n_hyp, samples=s_dev),
                       cycles_per_ms, reps=5)
        h = torch.randn(RANSAC_PAIRS * n_hyp, 3, 3, generator=_gen(device, SEED), device=device)
        svd_ms = device_ms(lambda: torch.linalg.svd(h), cycles_per_ms, reps=5)
        out["ransac"][n_hyp] = dict(rte_max=float(rte.max()), rre_max=float(rre.max()),
                                    ms_per_pair=ms / RANSAC_PAIRS, ms=ms, svd_ms=svd_ms,
                                    transform_abs_card_vs_cpu=r["transform_abs"],
                                    min_inliers=int(r["card"].n_inliers.min()),
                                    host_syncs=syncs)
        log(f"[eval] RANSAC {RANSAC_PAIRS} known-transform pairs (K {RANSAC_K}, {RANSAC_DIM}-d, "
            f"1/4 outliers) at H {n_hyp}: RTE max {float(rte.max()):.4f} m, RRE max "
            f"{float(rre.max()):.4f} deg, min inliers {int(r['card'].n_inliers.min())}; card vs "
            f"CPU from the same draws: transform abs err {r['transform_abs']:.3g}, counts equal; "
            f"{ms:.3f} ms per call = {ms / RANSAC_PAIRS:.4f} ms per pair (CUDA events; "
            f"synchronizing ops of a call at {syncs}), the "
            f"batched 3x3 SVD of {RANSAC_PAIRS * n_hyp} matrices alone {svd_ms:.3f} ms, on {smi}")
        if not (float(rte.max()) < 0.1 and float(rre.max()) < 0.5):
            raise AssertionError(f"RANSAC at H {n_hyp} missed a known transform: RTE "
                                 f"{rte.tolist()}, RRE {rre.tolist()}")

    # capacity calibration on the evaluator's sample, card against CPU
    sample = ev.eval_set.map_set[::max(1, n_map // 16)][:16]
    c16, m16 = ev.load_clouds(sample, len(sample))
    t0 = time.perf_counter()
    fit_card = calibrate_capacities(c16, m16, built.quantizer, built.pyramid_spec, device=device)
    card_s = time.perf_counter() - t0
    fit_cpu = calibrate_capacities(c16, m16, built.quantizer, built.pyramid_spec,
                                   device=torch.device("cpu"))
    log(f"[eval] capacity calibration on {len(sample)} scans: {built.pyramid_spec.capacities} -> "
        f"{fit_card} on the card ({card_s:.2f} s), CPU {fit_cpu}")
    if fit_card != fit_cpu:
        raise AssertionError(f"calibration card {fit_card} vs CPU {fit_cpu}")
    out["calibration"] = dict(capacities=fit_card, card_s=card_s)

    # device top-k above the host brute force's threshold
    emb_m = gen.standard_normal((TOPK_MAP, TOPK_DIM)).astype(np.float32)
    emb_q = gen.standard_normal((TOPK_QUERY, TOPK_DIM)).astype(np.float32)
    kk = max(ev.k, round(TOPK_MAP / 100))
    t0 = time.perf_counter()
    idx = knn.topk_l2(emb_m, emb_q, kk, device=device)
    host_ms = (time.perf_counter() - t0) * 1e3
    m64, q64 = emb_m.astype(np.float64), emb_q.astype(np.float64)
    d64 = (q64 ** 2).sum(1)[:, None] + (m64 ** 2).sum(1)[None] - 2 * q64 @ m64.T
    want = np.argsort(d64, axis=1)[:, :kk]
    diff = idx != want
    # a difference must be a near-tie: the two candidates' distances within f32 rounding
    ri, ci = np.nonzero(diff)
    gap = np.abs(d64[ri, idx[ri, ci]] - d64[ri, want[ri, ci]])
    if not (gap <= 1e-4 * np.abs(d64[ri, want[ri, ci]])).all():
        raise AssertionError(f"topk_l2: {int(diff.sum())} indices differ beyond near-ties")
    qd = torch.from_numpy(emb_q).to(device)
    md = torch.from_numpy(emb_m).to(device)

    def dev_topk():
        d = (qd * qd).sum(1)[:, None] + (md * md).sum(1)[None] - 2.0 * (qd @ md.T)
        return torch.topk(-d, kk, dim=1)

    topk_ms = device_ms(dev_topk, cycles_per_ms, reps=10)
    log(f"[eval] topk_l2 {TOPK_MAP} map x {TOPK_QUERY} query x {TOPK_DIM}-d, k {kk}: indices "
        f"equal the float64 brute force except {int(diff.sum())} near-ties; {host_ms:.2f} ms "
        f"host clock with copies, {topk_ms:.4f} ms device (product + top-k, CUDA events)")
    out["topk"] = dict(near_ties=int(diff.sum()), host_ms=host_ms, device_ms=topk_ms, k=kk)
    return eval_rows, out


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------

def _loop_params(names, epochs: int, save_freq: int = LOOP_SAVE_FREQ):
    """config_egonn.txt + model_configs/egonn.txt at full width on the
    synthetic set: its folder, type and files instead of MulRan's."""
    from egonn_tpu_torch.config import TrainingParams

    tp = TrainingParams(str(ROOT / "config" / "config_egonn.txt"),
                        str(ROOT / "model_configs" / "egonn.txt"), require_dataset=False)
    tp.dataset, tp.dataset_folder = "synthetic", str(LOOP_DATA)
    tp.train_file, tp.val_file, tp.test_file = names
    tp.epochs, tp.save_freq = epochs, save_freq
    got = (tp.batch_size, tp.batch_size_limit, tp.local_batch_size, tp.aug_mode,
           tp.model_params.cap0, tp.model_params.num_points)
    if got != (2 * N_PLACES, LOOP_BUCKET, 8, 2, CAP0, N_POINTS):
        raise AssertionError(f"unexpected training parameters {got}")
    return tp


class _LoopWatch:
    """While active, every `TrainStep` call of the loop is noted (epoch,
    train, clouds); the first train step's and the first validation step's
    kernel calls are recorded and their launches counted."""

    def __init__(self, trainer, kernels):
        self.trainer, self.kernels = trainer, kernels
        self.orig = trainer.TrainStep.__call__
        self.steps, self.calls, self.launches = [], {}, {}

    def __enter__(self):
        watch, kernels = self, self.kernels

        def call(step, g, l, gen, lr, train):
            watch.steps.append(dict(epoch=step.state.epoch + 1, train=train,
                                    rows=g["clouds"].shape[0],
                                    clouds=g["clouds"].shape[0] + 2 * l["anc_clouds"].shape[0]))
            if train in watch.calls:
                return watch.orig(step, g, l, gen, lr, train)
            before, out = kernels.launch_counts(), []
            watch.calls[train] = record_calls(
                kernels, lambda: out.append(watch.orig(step, g, l, gen, lr, train)))
            after = kernels.launch_counts()
            watch.launches[train] = {k: after[k] - before[k] for k in after}
            return out[0]

        self.trainer.TrainStep.__call__ = call
        return self

    def __exit__(self, *exc):
        self.trainer.TrainStep.__call__ = self.orig


def _loop_state(state) -> dict:
    """A TrainState's tensors: the model's state dict and Adam's moments."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for i, st in state.optimizer.state_dict()["state"].items():
        out.update({f"adam.{i}.{k}": torch.as_tensor(v) for k, v in st.items()})
    return out


def _state_diff(x: dict, y: dict) -> dict:
    """Leaves that differ, and the l2 norm of the parameters' difference
    relative to theirs (float model tensors)."""
    unequal = [k for k in x if not torch.equal(x[k], y[k])]
    num = den = 0.0
    for k in x:
        if k.startswith("model.") and x[k].dtype.is_floating_point:
            num += float((x[k].double() - y[k].double()).pow(2).sum())
            den += float(x[k].double().pow(2).sum())
    return dict(unequal=len(unequal), leaves=len(x), first=unequal[:5],
                rel_l2=math.sqrt(num / max(den, 1e-300)))


def _read_metrics(path: pathlib.Path) -> list:
    return [json.loads(line) for line in path.read_text().splitlines()]


def _bucket_step(tp, built, kernels, ds, lds, ids, lids, device) -> tuple:
    """One train step on the elements `ids` (padded to their bucket) and
    the pairs `lids`: (launches, peak device memory in GiB, rows, inputs)."""
    from egonn_tpu_torch.data.local_dataset import make_local_batch
    from egonn_tpu_torch.data.pipeline import make_global_batch
    from egonn_tpu_torch.train.trainer import expansion_buckets, make_train_step

    buckets = expansion_buckets(tp.batch_size, tp.batch_size_limit, tp.batch_expansion_rate)
    g = make_global_batch(ds, ids, N_POINTS, buckets)
    l = make_local_batch(lds, lids, N_POINTS)
    as_t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    gd = dict(clouds=as_t(g.clouds), point_mask=as_t(g.point_mask),
              positives_mask=as_t(g.positives_mask), negatives_mask=as_t(g.negatives_mask))
    ld = dict(anc_clouds=as_t(l.anc_clouds), anc_mask=as_t(l.anc_mask),
              pos_clouds=as_t(l.pos_clouds), pos_mask=as_t(l.pos_mask), t_gt=as_t(l.t_gt))
    step = make_train_step(built, tp)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = kernels.launch_counts()
    _finite_stats(step(gd, ld, _gen(device, SEED), 1e-3, True), f"step at {len(g.clouds)} rows")
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    return ({k: after[k] - before[k] for k in after}, torch.cuda.max_memory_allocated() / 2**30,
            len(g.clouds), (gd, ld))


def _host_contention(tp, built, ds, lds, ids, lids, g, l, device, n: int = 5) -> dict:
    """Host ms of one batch's assembly alone (make_global_batch +
    make_local_batch, one thread), and ms per train step on one device
    batch (n steps ending in a synchronize) alone and with a thread
    assembling batches beside it, as the Prefetcher's does."""
    import threading

    from egonn_tpu_torch.data.local_dataset import make_local_batch
    from egonn_tpu_torch.data.pipeline import make_global_batch
    from egonn_tpu_torch.train.trainer import expansion_buckets, make_train_step

    buckets = expansion_buckets(tp.batch_size, tp.batch_size_limit, tp.batch_expansion_rate)
    step = make_train_step(built, tp)

    def assemble():
        t0 = time.perf_counter()
        make_global_batch(ds, ids, N_POINTS, buckets)
        t1 = time.perf_counter()
        make_local_batch(lds, lids, N_POINTS)
        return (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3

    def steps_ms():
        step(g, l, _gen(device, SEED), 1e-3, True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            step(g, l, _gen(device, SEED + i), 1e-3, True)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    times = [assemble() for _ in range(3)]
    alone = steps_ms()
    stop = threading.Event()
    built_batches = []

    def loader():
        while not stop.is_set():
            assemble()
            built_batches.append(1)

    th = threading.Thread(target=loader, daemon=True)
    th.start()
    try:
        busy = steps_ms()
    finally:
        stop.set()
        th.join()
    return dict(global_batch_ms=statistics.median(t[0] for t in times),
                local_batch_ms=statistics.median(t[1] for t in times),
                step_ms_alone=alone, step_ms_with_loader=busy,
                batches_during=len(built_batches))


def _op_checksums(run) -> list:
    """run() under a dispatch mode that notes every aten op in order (the
    backward's too) with exact checksums of its tensor inputs (as it is
    called) and outputs: the sum of each tensor's bytes as int64 (device
    tensors, read at the end); none for views.  The `empty` ops' memory is
    zeroed, so that both runs start from the same bytes."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    def sums(tree):
        s = [t.detach().contiguous().view(-1).view(torch.uint8).to(torch.int64).sum()
             for t in tree_leaves(tree) if torch.is_tensor(t) and t.numel()]
        return torch.stack(s) if s else None

    ops = []

    class Trace(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.is_view:
                ops.append((str(func), None, None))
                return func(*args, **(kwargs or {}))
            ins = sums((args, kwargs))
            out = func(*args, **(kwargs or {}))
            if "empty" in str(func):
                out.zero_()  # the same bytes in both runs
            ops.append((str(func), ins, sums(out)))
            return out

    with Trace():
        run()
    return [(name, None if i is None else i.tolist(), None if o is None else o.tolist())
            for name, i, o in ops]


def _divergence(a: list, b: list) -> dict:
    """Two runs' op traces: the ops whose outputs differ from equal inputs
    (nondeterministic ops) before the first op whose inputs differ (where a
    difference reached the computation), by name with counts."""
    sources, first_input = {}, None
    for i, ((name, in_a, out_a), (_, in_b, out_b)) in enumerate(zip(a, b)):
        if in_a != in_b:
            first_input = dict(op=name, index=i)
            break
        if out_a != out_b:
            sources.setdefault(name, []).append(i)
    return dict(ops=len(a), first_differing_input=first_input,
                sources={k: dict(count=len(v), first=v[0]) for k, v in sources.items()})


def _determinism_probe(tp, device, g, l) -> dict:
    """One train step twice from one state on one batch with one generator:
    the gradients that differ, the nondeterministic aten ops (`_divergence`)
    and host ms per step; where the two differ, the same again under
    torch.use_deterministic_algorithms(True, warn_only=True), with the
    warnings it gave."""
    from egonn_tpu_torch.models.factory import create_egonn_model
    from egonn_tpu_torch.train.trainer import make_train_step

    built = create_egonn_model(tp.model_params, device=device, seed=SEED + 7)
    step = make_train_step(built, tp)
    model, opt = step.state.model, step.state.optimizer
    snap = copy.deepcopy(model.state_dict()), copy.deepcopy(opt.state_dict())

    def restore():
        model.load_state_dict(snap[0])
        opt.load_state_dict(snap[1])

    def one_step():
        restore()
        step(g, l, _gen(device, SEED), 1e-3, True)

    def traced_step():
        restore()
        return _op_checksums(lambda: step(g, l, _gen(device, SEED), 1e-3, True))

    def grads():
        one_step()
        return {n: p.grad.detach().clone() for n, p in model.named_parameters()}

    def step_ms(n=3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            one_step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    def first_divergence():
        return _divergence(traced_step(), traced_step())

    out = {}
    for mode in ("default", "deterministic"):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(mode == "deterministic", warn_only=True)
            try:
                a, b = grads(), grads()
                diverges = first_divergence()
                ms = step_ms()
            finally:
                torch.use_deterministic_algorithms(False)
        out[mode] = dict(leaves=sorted(n for n in a if not torch.equal(a[n], b[n])),
                         first_op=diverges, step_ms=ms,
                         warnings=sorted({str(w.message)[:160] for w in caught}))
        if not out[mode]["leaves"] and diverges["first_differing_input"] is None:
            break  # repeatable: the deterministic algorithms are not needed
    out["grads"] = len(a)
    return out


def _loop_data() -> tuple:
    """Phase 10's synthetic set, written (again: the generator is seeded)
    into LOOP_DATA: (file names, train dataset, local pair dataset, the
    sampler's first bucket-LOOP_BUCKET batch of epoch 1)."""
    from egonn_tpu_torch.data.base import TrainingDataset
    from egonn_tpu_torch.data.local_dataset import Training6DOFDataset
    from egonn_tpu_torch.data.samplers import BatchSampler
    from egonn_tpu_torch.data.synthetic import generate_synthetic_dataset

    names = generate_synthetic_dataset(str(LOOP_DATA), n_scans=LOOP_SCANS, seed=SEED)
    tp = _loop_params(names, LOOP_EPOCHS)
    ds = TrainingDataset(str(LOOP_DATA), "synthetic", names[0])
    lds = Training6DOFDataset(str(LOOP_DATA), "synthetic", names[0], tp.model_params.quantizer,
                              rot_max=tp.rot_max, trans_max=tp.trans_max)
    if len(ds) < LOOP_BUCKET:
        raise AssertionError(f"{len(ds)} train elements, fewer than bucket {LOOP_BUCKET}")
    sampler = BatchSampler(ds, batch_size=LOOP_BUCKET, seed=0)
    sampler.set_epoch(1)
    return names, ds, lds, next(iter(sampler))


def phase_train_loop(kernels, cycles_per_ms, device, smi, bare_steps_per_s):
    """Phase 10: do_train on the card (see the module docstring)."""
    from egonn_tpu_torch.models.factory import create_egonn_model
    from egonn_tpu_torch.sparse.pyramid import egonn_pyramid_spec
    from egonn_tpu_torch.train import trainer

    t0 = time.perf_counter()
    shutil.rmtree(LOOP_DIR, ignore_errors=True)
    names, ds, lds, big = _loop_data()
    tp = _loop_params(names, LOOP_EPOCHS)
    out = dict(dataset_s=time.perf_counter() - t0, train_elements=len(ds), bucket={},
               names=list(names))

    # one step each at buckets 32 and 128 (launches, peak memory); on the
    # bucket-32 batch the host's batch assembly against a step, and whether
    # two steps from one state are bit-equal
    built = create_egonn_model(tp.model_params, device=device, seed=SEED + 6)
    lids = lds.valid_ids[:tp.local_batch_size]
    for ids in (big[:2 * N_PLACES], big):
        step_launches, peak, b_rows, inputs = _bucket_step(tp, built, kernels, ds, lds, ids,
                                                           lids, device)
        log(f"[loop] one train step at bucket {b_rows} ({len(ids)} global clouds + "
            f"{len(lids)} pairs): launches {step_launches}, peak memory {peak:.2f} GiB on {smi}")
        if step_launches != TRAIN_STEP_LAUNCHES:
            raise AssertionError(f"bucket {b_rows}: launches {step_launches}")
        out["bucket"][b_rows] = dict(launches=step_launches, peak_gb=peak)
        if b_rows != 2 * N_PLACES:
            continue
        host = out["host"] = _host_contention(tp, built, ds, lds, ids, lids, *inputs, device)
        log(f"[loop] host: one batch's assembly alone {host['global_batch_ms']:.1f} ms "
            f"global + {host['local_batch_ms']:.1f} ms local (one thread); a train step on "
            f"one device batch {host['step_ms_alone']:.1f} ms alone, "
            f"{host['step_ms_with_loader']:.1f} ms with a thread assembling batches beside "
            f"it ({host['batches_during']} batches meanwhile; host clock) on {smi}")
        probe = out["determinism"] = _determinism_probe(tp, device, *inputs)
        for mode in ("default", "deterministic"):
            if mode in probe:
                pm = probe[mode]
                log(f"[loop] determinism ({mode} algorithms), one train step twice from one "
                    f"state: {len(pm['leaves'])} of {probe['grads']} gradients differ "
                    f"{pm['leaves'][:6]}; ops whose outputs differ from equal inputs before "
                    f"the first differing input {pm['first_op']}; {pm['step_ms']:.1f} ms per "
                    f"step; warnings {pm['warnings']}")
    del inputs
    if sorted(out["bucket"]) != [2 * N_PLACES, LOOP_BUCKET]:
        raise AssertionError(f"buckets {sorted(out['bucket'])}")
    torch.cuda.empty_cache()

    # (a) LOOP_EPOCHS epochs, every launch counted
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _LoopWatch(trainer, kernels) as watch:
        state_a, stats_a, name = trainer.do_train(tp, weights_path=str(LOOP_DIR / "a"),
                                                  device=device)
    torch.cuda.synchronize()
    out["run_a_s"] = time.perf_counter() - t0
    out["run_a_peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    launches = out["launches"] = kernels.launch_counts()
    log(f"[loop] run (a): {LOOP_EPOCHS} epochs in {out['run_a_s']:.1f} s, launches {launches}")
    missing = [k for k in LOOP_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"the loop launched no {missing}")
    for train, want in ((True, TRAIN_STEP_LAUNCHES), (False, VAL_STEP_LAUNCHES)):
        what = "train" if train else "validation"
        log(f"[loop] first {what} step of the loop: launches {watch.launches[train]}")
        if watch.launches[train] != want:
            raise AssertionError(f"first loop {what} step: launches {watch.launches[train]}, "
                                 f"expected {want}")
    for phase in ("train", "val"):
        if len(stats_a[phase]) != LOOP_EPOCHS:
            raise AssertionError(f"{len(stats_a[phase])} {phase} epochs of {LOOP_EPOCHS}")
        for e, st in enumerate(stats_a[phase], 1):
            _finite_stats(st, f"epoch {e} {phase}")
    ckpt_a = LOOP_DIR / "a" / name
    for e in (LOOP_SAVE_FREQ, LOOP_EPOCHS):
        if not (ckpt_a / f"step_{e}.pt").exists():
            raise AssertionError(f"no checkpoint at epoch {e} in {ckpt_a}")
    records = _read_metrics(LOOP_DIR / "a" / f"{name}.metrics.jsonl")
    epochs = [r for r in records if "train" in r]
    tests = [r for r in records if "test" in r]
    if [r["epoch"] for r in epochs] != list(range(1, LOOP_EPOCHS + 1)):
        raise AssertionError(f"metrics epochs {[r['epoch'] for r in epochs]}")
    if [r["epoch"] for r in tests] != [LOOP_EPOCHS] or not all(
            math.isfinite(v) for v in tests[0]["test"]["recall@1"].values()):
        raise AssertionError(f"in-training evaluation records {tests}")
    out["test"] = tests[0]["test"]
    out["eval_s"] = tests[0]["seconds"]
    ts = [records[0]["_ts"]] + [r["_ts"] for r in epochs]
    out["epoch_s"] = [b - a for a, b in zip(ts, ts[1:])]
    steady = [r for r in epochs if r["epoch"] > 1]
    clouds = {(s["epoch"], s["train"]): 0 for s in watch.steps}
    for s in watch.steps:
        clouds[(s["epoch"], s["train"])] += s["clouds"]
    for phase, train in (("train", True), ("val", False)):
        sec = sum(r["seconds"][phase] for r in steady)
        out[f"{phase}_steps_per_s"] = sum(r["steps"][phase] for r in steady) / sec
        out[f"{phase}_clouds_per_s"] = sum(clouds[(r["epoch"], train)] for r in steady) / sec
    n_train = sum(r["steps"]["train"] for r in steady)
    out["train_wait_ms"] = sum(r["input_wait_s"]["train"] for r in steady) / n_train * 1e3
    out["train_copy_ms"] = sum(r["copy_s"]["train"] for r in steady) / n_train * 1e3
    out["stats_last"] = dict(train=stats_a["train"][-1], val=stats_a["val"][-1])
    out["rows"] = sorted({(s["train"], s["rows"]) for s in watch.steps})
    log(f"[loop] epoch {LOOP_EPOCHS} train loss {stats_a['train'][-1]['loss']:.6g}, val loss "
        f"{stats_a['val'][-1]['loss']:.6g}; global rows per step (train, rows) {out['rows']}; "
        f"in-training evaluation at epoch {LOOP_EPOCHS}: Recall@1 {out['test']['recall@1']} in "
        f"{out['eval_s']:.2f} s")
    log(f"[loop] {out['train_steps_per_s']:.3f} train steps/s, {out['train_clouds_per_s']:.1f} "
        f"clouds/s over epochs 2-{LOOP_EPOCHS}'s train phases (host clock, loading included), "
        f"against phase 5's bare step {bare_steps_per_s:.3f} steps/s; per train step "
        f"{out['train_wait_ms']:.1f} ms waiting for the Prefetcher and "
        f"{out['train_copy_ms']:.1f} ms copying to the card; validation "
        f"{out['val_steps_per_s']:.3f} steps/s; seconds per epoch "
        f"{[round(x, 2) for x in out['epoch_s']]} (epoch {LOOP_EPOCHS} with the evaluation); "
        f"run (a) peak memory {out['run_a_peak_gb']:.2f} GiB (recorded calls and the "
        f"evaluation included) on {smi}")

    # the first train and validation steps' kernel calls against their plain versions
    rows = new_rows(kernels)
    measure_calls(rows, watch.calls[True] + watch.calls[False], kernels, cycles_per_ms,
                  reps=10, tag="loop-kernels", levels=level_of(egonn_pyramid_spec(CAP0).capacities))
    for k, row in rows.items():
        row["launches"] = watch.launches[True][k] + watch.launches[False][k]
    del watch
    torch.cuda.empty_cache()

    # (b) resumed from a copy of (a)'s epoch-5 checkpoint in a fresh directory
    (LOOP_DIR / "b" / name).mkdir(parents=True)
    for f in (f"step_{LOOP_SAVE_FREQ}.pt", f"step_{LOOP_SAVE_FREQ}.meta.json"):
        shutil.copy(ckpt_a / f, LOOP_DIR / "b" / name / f)
    t0 = time.perf_counter()
    state_b, stats_b, _ = trainer.do_train(tp, resume_from=str(LOOP_DIR / "b" / name),
                                           device=device)
    xa, xb = _loop_state(state_a), _loop_state(state_b)
    diff_ab = _state_diff(xa, xb)
    loss_ab = max(abs(a["loss"] - b["loss"]) for a, b in
                  zip(stats_a["train"][LOOP_SAVE_FREQ:], stats_b["train"]))
    out["resume"] = dict(diff=diff_ab, train_loss_abs=loss_ab, run_b_s=time.perf_counter() - t0)
    log(f"[loop] run (b), resumed at epoch {LOOP_SAVE_FREQ} in {out['resume']['run_b_s']:.1f} "
        f"s: {diff_ab['unequal']} of {diff_ab['leaves']} state tensors (parameters, BatchNorm "
        f"statistics, Adam's moments and steps) differ from (a)'s, parameters' rel l2 "
        f"{diff_ab['rel_l2']:.3g}, epochs {LOOP_SAVE_FREQ + 1}-{LOOP_EPOCHS} train loss max abs "
        f"diff {loss_ab:.3g}")
    if diff_ab["unequal"]:
        raise AssertionError(f"the resumed run differs from the uninterrupted one: {diff_ab}")
    return rows, out


# ---------------------------------------------------------------------------
# data parallel
# ---------------------------------------------------------------------------

def _dp_rank(group, tp, g: dict, l: dict, lr: float, record: bool = False) -> dict:
    """One rank of phase 11 (a) / (b), or with group None the single
    process it is held against: a fresh EgoNN (phase 4's seeded weights,
    BatchNorms perturbed as in phase 9: at their initial statistics the
    eval-mode embeddings are almost equal, and the validation step's pair
    distances, ~2.5e-4, would be differences of nearly equal vectors) on
    this rank's rows of the batch (numpy, whole), then one validation step,
    one train step with augmentation from a generator seeded SEED (both
    counted: launches, collectives) and DP_TIMED_STEPS more train steps
    (host ms each, ending in a synchronize).  record: also the kernel calls
    of the two counted steps (rank 0, in this process)."""
    from egonn_tpu_torch.models.factory import create_egonn_model
    from egonn_tpu_torch.parallel import mesh
    from egonn_tpu_torch.parallel.dryrun import rows_of
    from egonn_tpu_torch.sparse import kernels
    from egonn_tpu_torch.train.trainer import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    device = mesh.rank_device("cuda:0", group)
    built = create_egonn_model(tp.model_params, cap0=CAP0, device=device, seed=SEED + 1)
    with torch.no_grad():
        _perturb_bn(built.model, SEED + 1)
    step = make_train_step(built, tp, group)
    gd = {k: torch.from_numpy(v).to(device)
          for k, v in rows_of(g, ("clouds", "point_mask"), group).items()}
    ld = {k: torch.from_numpy(v).to(device) for k, v in rows_of(l, tuple(l), group).items()}
    out = {}

    def counted(name, train, gen):
        kernels.reset_launches()
        mesh.reset_collectives()
        box = []
        run = lambda: box.append(step(gd, ld, gen, lr, train))  # noqa: E731
        if record:
            out[f"{name}_calls"] = record_calls(kernels, run)
        else:
            run()
        torch.cuda.synchronize(device)
        out[f"{name}_launches"] = kernels.launch_counts()
        out[f"{name}_collectives"] = mesh.collective_counts()
        out[f"{name}_stats"] = {k: float(v) for k, v in box[0].items()}

    counted("val", False, None)
    torch.cuda.reset_peak_memory_stats(device)
    counted("train", True, torch.Generator(device=device).manual_seed(SEED))
    model, adam = built.model, step.state.optimizer.state
    out["grads"] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    out["state"] = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    out["adam"] = {n: [adam[p][k].detach().cpu() for k in ("exp_avg", "exp_avg_sq")]
                   for n, p in model.named_parameters()}
    out["step_ms"] = []
    for i in range(DP_TIMED_STEPS):
        gen = torch.Generator(device=device).manual_seed(SEED + 100 + i)
        t0 = time.perf_counter()
        step(gd, ld, gen, lr, True)
        torch.cuda.synchronize(device)
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
    out["peak_gb"] = torch.cuda.max_memory_allocated(device) / 2**30
    return out


def _dp_eval_rank(group, eval_file: str) -> dict:
    """Phase 11 (c) on one rank (group None: unsharded): phase 9's model and
    Evaluator on its synthetic set, the global evaluation (recalls), then
    phase 9's embedding batch with its launches counted."""
    from egonn_tpu_torch.config import ModelParams
    from egonn_tpu_torch.eval.evaluator import Evaluator
    from egonn_tpu_torch.models.factory import create_egonn_model
    from egonn_tpu_torch.sparse import kernels

    device = torch.device("cuda", 0)
    mp = ModelParams(str(ROOT / "model_configs" / "egonn.txt"))
    built = create_egonn_model(mp, cap0=CAP0, device=device, seed=SEED + 5)
    _perturb_bn(built.model, SEED + 5)
    ev = Evaluator(str(EVAL_DIR), "synthetic", eval_file, built, num_points=N_POINTS,
                   batch_size=B, group=group)
    t0 = time.perf_counter()
    m = ev.evaluate()
    seconds = time.perf_counter() - t0
    kernels.reset_launches()
    emb = ev.compute_embeddings(ev.eval_set.map_set[:B])
    torch.cuda.synchronize(device)
    return dict(recall={str(r): v.tolist() for r, v in m["recall"].items()},
                top1=m["top1_ndx"].tolist(), global_=emb["global"], seconds=seconds,
                launches=kernels.launch_counts())


def _stat_diffs(got: dict, want: dict) -> list:
    """[(relative difference, stat, got, want)], the largest first."""
    if set(got) != set(want):
        raise AssertionError(f"stats {sorted(got)} against {sorted(want)}")
    return sorted(((abs(got[k] - w) / max(abs(w), 1e-12), k, got[k], w)
                   for k, w in want.items()), reverse=True)


def _stat_rel(got: dict, want: dict) -> float:
    return _stat_diffs(got, want)[0][0]


def _grad_errors(got: dict, want: dict) -> tuple:
    """(worst max abs err / leaf max, worst l2 err / leaf l2) over the leaves."""
    mx = max(float((got[n] - w).abs().max() / w.abs().max().clamp_min(1e-30))
             for n, w in want.items())
    l2 = max(float((got[n] - w).norm() / w.norm().clamp_min(1e-30)) for n, w in want.items())
    return mx, l2


def _same(a: dict, b: dict) -> bool:
    """Every tensor (or list of tensors) of a equal to b's, bit for bit."""
    def eq(x, y):
        return all(map(eq, x, y)) if isinstance(x, list) else torch.equal(x, y)
    return a.keys() == b.keys() and all(eq(a[k], b[k]) for k in a)


def phase_data_parallel(tp, g, l, lr, kernels, cycles_per_ms, smi, bare_steps_per_s,
                        eval_file: str, loop_names: list):
    """Phase 11: data parallel on the card (see the module docstring)."""
    import numpy as np

    from egonn_tpu_torch.parallel import mesh
    from egonn_tpu_torch.sparse.pyramid import egonn_pyramid_spec
    from egonn_tpu_torch.train import trainer

    g_np = {k: v.cpu().numpy() for k, v in g.items()}
    l_np = {k: v.cpu().numpy() for k, v in l.items()}
    n_cards = torch.cuda.device_count()
    log(f"[dp] {DP_WORLD} ranks over NCCL need {DP_WORLD} cards and {n_cards} is visible: "
        f"the {DP_WORLD} ranks share cuda:0 over gloo (collectives staged through host "
        f"memory); {DP_WORLD}-card NCCL is not run here (unverified)")
    torch.cuda.empty_cache()

    # (a) the 1-process step, then DP_WORLD gloo ranks from the same weights
    t0 = time.perf_counter()
    ref = _dp_rank(None, tp, g_np, l_np, lr)
    ranks = mesh.run_ranks(_dp_rank, DP_WORLD, (tp, g_np, l_np, lr), device="cuda:0",
                           backend="gloo", timeout_s=DP_TIMEOUT_S, rank0_kwargs={"record": True})
    out = dict(ranks_s=time.perf_counter() - t0, ranks={})
    for r, res in enumerate(ranks):
        for what, want in (("train", TRAIN_STEP_LAUNCHES), ("val", VAL_STEP_LAUNCHES)):
            if res[f"{what}_launches"] != want:
                raise AssertionError(f"rank {r} {what} step: launches {res[what + '_launches']}")
        rel = max(_stat_rel(res["train_stats"], ref["train_stats"]),
                  _stat_rel(res["val_stats"], ref["val_stats"]))
        g_max, g_l2 = _grad_errors(res["grads"], ref["grads"])
        equal = r == 0 or all(_same(res[k], ranks[0][k]) for k in ("state", "adam", "grads"))
        worst = (_stat_diffs(res["train_stats"], ref["train_stats"])[:3]
                 + _stat_diffs(res["val_stats"], ref["val_stats"])[:2])
        log(f"[dp] rank {r}: largest stat differences (rel, stat, rank, 1 process) "
            f"{[(f'{d:.3g}', k, a, b) for d, k, a, b in worst]}")
        out["ranks"][r] = dict(stats_rel=rel, grad_rel=g_max, grad_l2_rel=g_l2,
                               bit_equal_to_rank0=equal, step_ms=res["step_ms"],
                               peak_gb=res["peak_gb"], collectives=res["train_collectives"],
                               val_collectives=res["val_collectives"])
        log(f"[dp] rank {r}: launches train {res['train_launches']} val "
            f"{res['val_launches']}; against the 1-process step: stats rel {rel:.3g}, grads "
            f"max abs err / leaf max {g_max:.3g}, l2 {g_l2:.3g}; parameters, BatchNorm "
            f"statistics, Adam state and gradients bit-equal to rank 0's {equal}; step ms "
            f"{[round(x, 1) for x in res['step_ms']]}, peak memory {res['peak_gb']:.2f} GiB")
        # stats at JAX's sharded-vs-unsharded bound (tests/test_multichip.py),
        # gradients at known difference 9's card bounds
        if not (rel <= 1e-4 and g_max <= 1e-2 and g_l2 <= 2e-3 and equal):
            raise AssertionError(f"rank {r} disagrees with the 1-process step")
    coll = ranks[0]["train_collectives"]
    log(f"[dp] collectives per train step (rank 0): {json.dumps(coll)}; per validation step "
        f"{json.dumps(ranks[0]['val_collectives'])}")
    ms0 = statistics.median(ranks[0]["step_ms"])
    ms1 = statistics.median(ref["step_ms"])
    out.update(ref_step_ms=ref["step_ms"], ref_peak_gb=ref["peak_gb"],
               dp_steps_per_s=1e3 / ms0, one_steps_per_s=1e3 / ms1)
    log(f"[dp] {DP_WORLD}-rank train step {ms0:.1f} ms (median of {DP_TIMED_STEPS}, host "
        f"clock): {1e3 / ms0:.3f} global steps/s against {1e3 / ms1:.3f} for the 1-process "
        f"step in this phase ({ref['peak_gb']:.2f} GiB) and phase 5's {bare_steps_per_s:.3f} "
        f"on {smi}")
    rows = new_rows(kernels)
    measure_calls(rows, ranks[0]["train_calls"] + ranks[0]["val_calls"], kernels,
                  cycles_per_ms, reps=10, tag="dp-kernels",
                  levels=level_of(egonn_pyramid_spec(CAP0).capacities))
    for k, row in rows.items():
        row["launches"] = ranks[0]["train_launches"][k] + ranks[0]["val_launches"][k]
    del ranks
    torch.cuda.empty_cache()

    # (b) one NCCL rank: the NCCL collectives on CUDA tensors, bit-equal
    (nccl,) = mesh.run_ranks(_dp_rank, 1, (tp, g_np, l_np, lr), device="cuda:0",
                             backend="nccl", timeout_s=DP_TIMEOUT_S)
    equal = (nccl["train_stats"] == ref["train_stats"] and nccl["val_stats"] == ref["val_stats"]
             and all(_same(nccl[k], ref[k]) for k in ("state", "adam", "grads")))
    out["nccl_1_rank"] = dict(bit_equal=equal, collectives=nccl["train_collectives"],
                              step_ms=nccl["step_ms"])
    log(f"[dp] a 1-rank NCCL group: stats, gradients, parameters, BatchNorm statistics and "
        f"Adam state bit-equal to the 1-process step {equal}; collectives "
        f"{json.dumps(nccl['train_collectives'])}")
    if not equal:
        raise AssertionError("the 1-rank NCCL step differs from the 1-process step")
    del nccl, ref
    torch.cuda.empty_cache()

    # (c) the sharded evaluation on phase 9's set
    one = _dp_eval_rank(None, eval_file)
    shard = mesh.run_ranks(_dp_eval_rank, DP_WORLD, (eval_file,), device="cuda:0",
                           backend="gloo", timeout_s=DP_TIMEOUT_S)
    err = max(float(np.abs(r["global_"] - one["global_"]).max()) for r in shard)
    scale = float(np.abs(one["global_"]).max())
    same = all(r["recall"] == one["recall"] and r["top1"] == one["top1"] for r in shard)
    out["eval"] = dict(global_max_abs_err=err, global_max=scale, recall_equal=same,
                       seconds=[one["seconds"]] + [r["seconds"] for r in shard],
                       launches=[r["launches"] for r in shard])
    log(f"[dp] sharded evaluation over {DP_WORLD} ranks: Recall@N and top-1 equal to the "
        f"unsharded {same}; phase 9's embedding batch `global` max abs err {err:.3g} (max "
        f"{scale:.3g}); launches per rank {shard[0]['launches']}; evaluation s unsharded "
        f"{one['seconds']:.2f}, per rank {[round(r['seconds'], 2) for r in shard]}")
    # embeddings at JAX's own sharded-vs-unsharded bound (rtol 2e-4, atol
    # 2e-5, tests/test_multichip.py): each rank's batch is half as large
    if not (same and err <= 2e-5 + 2e-4 * scale
            and all(r["launches"] == GLOBAL_EVAL_BATCH_LAUNCHES for r in shard)):
        raise AssertionError("the sharded evaluation differs from the unsharded one")

    # (d) do_train on a mesh of DP_WORLD against one process, DP_EPOCHS epochs
    shutil.rmtree(DP_DIR, ignore_errors=True)
    runs = {}
    for mesh_opt in ("off", DP_WORLD):
        p = _loop_params(loop_names, DP_EPOCHS)
        p.lr, p.mesh, p.test_file = DP_LR, mesh_opt, None
        t0 = time.perf_counter()
        if mesh_opt == "off":
            # the same buckets as the mesh's (multiples of DP_WORLD): the
            # same padding rows, so that the batches are the same
            bucket_fn = trainer.expansion_buckets
            trainer.expansion_buckets = lambda *a, multiple_of=1: bucket_fn(
                *a, multiple_of=DP_WORLD)
            try:
                state, stats, name = trainer.do_train(p, weights_path=str(DP_DIR / "one"),
                                                      device="cuda")
            finally:
                trainer.expansion_buckets = bucket_fn
        else:
            state, stats, name = trainer.do_train(p, weights_path=str(DP_DIR / "mesh"),
                                                  device="cuda", backend="gloo")
        runs[mesh_opt] = dict(stats=stats, name=name, seconds=time.perf_counter() - t0)
        del state
    one, two = runs["off"], runs[DP_WORLD]
    diffs = sorted(((d, f"epoch {e} {phase} {k}", x, y) for phase in ("train", "val")
                    for e, (a, b) in enumerate(zip(one["stats"][phase], two["stats"][phase]), 1)
                    for d, k, x, y in _stat_diffs(b, a)), reverse=True)
    rel = diffs[0][0]
    log(f"[dp] do_train, largest epoch stat differences (rel, stat, mesh, 1 process) "
        f"{[(f'{d:.3g}', k, x, y) for d, k, x, y in diffs[:6]]}")
    n_epochs = [len(two["stats"][ph]) for ph in ("train", "val")]
    files = sorted(f.name for f in (DP_DIR / "mesh" / two["name"]).iterdir())
    want_files = sorted(f"step_{DP_EPOCHS}{ext}" for ext in (".pt", ".meta.json"))
    records = [r for r in _read_metrics(DP_DIR / "mesh" / f"{two['name']}.metrics.jsonl")
               if "train" in r]
    # the first epoch starts from the same weights: every stat within rel
    # 1e-4; later epochs follow Adam's updates, whose first step moves a
    # weight with a near-zero gradient by ~lr either way (known difference
    # 10), so a keypoint may cross the 0.5 m matching threshold: rel 1e-2
    rel_first = max(d for d, k, _, _ in diffs if k.startswith("epoch 1 "))
    out["do_train"] = dict(stats_rel=rel, stats_rel_epoch1=rel_first, one_s=one["seconds"],
                           mesh_s=two["seconds"], files=files, epoch_records=len(records))
    log(f"[dp] do_train on a mesh of {DP_WORLD} (gloo, one card), {DP_EPOCHS} epochs at lr "
        f"{DP_LR} on phase 10's set: epoch stats within rel {rel:.3g} of one process's with "
        f"the same buckets and draws ({rel_first:.3g} in epoch 1); {two['seconds']:.1f} s "
        f"against {one['seconds']:.1f} s; "
        f"rank 0's checkpoint files {files}, {len(records)} epoch records in its metrics log")
    if not (rel_first <= 1e-4 and rel <= 1e-2 and n_epochs == [DP_EPOCHS] * 2
            and files == want_files and len(records) == DP_EPOCHS):
        raise AssertionError("do_train on the mesh disagrees with one process")
    return rows, out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from egonn_tpu_torch import inference
    from egonn_tpu_torch.models.factory import create_egonn_model
    from egonn_tpu_torch.ops.quantization import PolarQuantizer
    from egonn_tpu_torch.sparse import cuda_lib, kernels
    from egonn_tpu_torch.sparse import pyramid as pyramid_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # every phase runs f32 activations but phases 3b and 5b, which set the flag themselves
    os.environ.pop("EGONN_BF16_ACTS", None)
    bf16_only = sys.argv[1:] == ["bf16"]
    if sys.argv[1:] and not bf16_only:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]} (none, or `bf16`)", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = phase_environment(cuda_lib)
    device = torch.device("cuda")
    mp = types.SimpleNamespace(model="egonn", quantizer=PolarQuantizer([1.0, 0.3, 0.2]),
                               cap0=CAP0)
    built = create_egonn_model(mp, cap0=CAP0, device=device, seed=SEED)
    cycles_per_ms = _sleep_cycles_per_ms()

    t0 = time.perf_counter()
    rows, repeat_fwd = phase_kernels(built, kernels, inference, cycles_per_ms)
    log(f"[kernels] phase done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sl = phase_slice(built, kernels, inference, pyramid_mod)
    log(f"[slice] phase done in {time.perf_counter() - t0:.1f} s")
    log(f"[slice] {sl['clouds_per_s']:.1f} clouds/s over 10 forwards of {B} x {N_POINTS} "
        f"points ({sl['forward_ms']:.2f} ms per forward, host clock) on {smi}")
    for name, row in rows.items():
        row["launches"] = sl["launches"][name]
    t0 = time.perf_counter()
    bf16_rows, bf16 = phase_bf16(built, kernels, inference, pyramid_mod, cycles_per_ms)
    log(f"[bf16] phase done in {time.perf_counter() - t0:.1f} s")

    from egonn_tpu_torch.config import TrainingParams
    from egonn_tpu_torch.data.train_batch import make_train_batch
    from egonn_tpu_torch.train.state import make_lr_schedule
    from egonn_tpu_torch.train.trainer import make_train_step

    tp = TrainingParams(str(ROOT / "config" / "config_egonn.txt"),
                        str(ROOT / "model_configs" / "egonn.txt"), require_dataset=False)
    got = (tp.batch_size, tp.local_batch_size, tp.lr, tp.weight_decay, tp.aug_mode, tp.margin,
           tp.loss_gammas, tp.model_params.cap0)
    if got != (2 * N_PLACES, 8, 1e-3, 1e-4, 2, 0.2, [1.0, 1.0, 1.0, 4.0], CAP0):
        raise AssertionError(f"unexpected training parameters {got}")
    built_t = create_egonn_model(tp.model_params, cap0=CAP0, device=device, seed=SEED + 1)
    step = make_train_step(built_t, tp)
    lr = make_lr_schedule(tp)(0)
    t0 = time.perf_counter()
    g, l = make_train_batch(tp, built_t.quantizer, device, n_places=N_PLACES,
                            n_points=N_POINTS, seed=SEED)
    log(f"[train-kernels] batch: {tuple(g['clouds'].shape)} global clouds, "
        f"{tuple(l['anc_clouds'].shape)} x 2 local, {int(l['anc_mask'].sum(1).min())}-"
        f"{int(l['anc_mask'].sum(1).max())} voxel points per anchor "
        f"({time.perf_counter() - t0:.1f} s)")
    levels = level_of(built_t.pyramid_spec.capacities)
    if bf16_only:
        t0 = time.perf_counter()
        bt_rows, bt = phase_bf16_train(tp, g, l, lr, kernels, cycles_per_ms, levels, smi)
        log(f"[bf16-train] phase done in {time.perf_counter() - t0:.1f} s")
        return _finish(smi, {"forward": rows, "bf16_forward": bf16_rows, **bt_rows},
                       dict(card=smi, slice=sl, bf16=bf16, bf16_train=bt,
                            determinism=[*bf16["repeats"], bt["repeat"], bt["conv_repeat"]]), t_start)
    t0 = time.perf_counter()
    train_rows, repeat_train = phase_train_kernels(step, g, l, lr, kernels, cycles_per_ms,
                                                   levels)
    log(f"[train-kernels] phase done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tr = phase_train_slice(step, g, l, lr, kernels)
    tr["card_vs_cpu"] = phase_train_card_vs_cpu(tp, g, l, lr)
    log(f"[train] phase done in {time.perf_counter() - t0:.1f} s")
    log(f"[train] {tr['steps_per_s']:.3f} train steps/s, {tr['clouds_per_s']:.1f} clouds/s "
        f"over {TRAIN_STEPS} steps of {tr['clouds_per_step']} clouds x {N_POINTS} points "
        f"(host clock), peak memory {tr['peak_memory_gb']:.2f} GiB on {smi}")
    for name, row in train_rows.items():
        row["launches"] = tr["train_launches"][name]
    t0 = time.perf_counter()
    val_rows, repeat_val = phase_val_kernels(step, g, l, lr, kernels, cycles_per_ms, levels)
    log(f"[val-kernels] phase done in {time.perf_counter() - t0:.1f} s")
    for name, row in val_rows.items():
        row["launches"] = tr["val_launches"][name]
    t0 = time.perf_counter()
    bt_rows, bt = phase_bf16_train(tp, g, l, lr, kernels, cycles_per_ms, levels, smi)
    log(f"[bf16-train] phase done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    maps_rows, maps = phase_lookup_maps(built, kernels, pyramid_mod, cycles_per_ms)
    mink_rows, mink = phase_minkloc(kernels, inference, pyramid_mod, cycles_per_ms, device)
    log(f"[minkloc] phase done in {time.perf_counter() - t0:.1f} s")
    turns = mink["clouds_per_s_turns"]
    quartiles = {k: [round(q, 1) for q in statistics.quantiles(v, n=4)] for k, v in turns.items()}
    wins = sum(a > b for a, b in zip(turns["minkloc"], turns["minkloc_lookup"]))
    log(f"[minkloc] {mink['clouds_per_s']['minkloc']:.1f} clouds/s (factory pyramid), "
        f"{mink['clouds_per_s']['minkloc_lookup']:.1f} (lookup-built down maps): medians of "
        f"{MINKLOC_ROUNDS} turns of 10 forwards of {B} x {N_POINTS} points in alternation, "
        f"quartiles {quartiles}, the factory pyramid faster in {wins} of {MINKLOC_ROUNDS} "
        f"pairs (host clock) on {smi}")
    t0 = time.perf_counter()
    wide = phase_wide(kernels, cycles_per_ms, device)
    log(f"[wide] phase done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    resnet_rows, resnet = phase_resnet(kernels, pyramid_mod, cycles_per_ms, device)
    log(f"[resnet] phase done in {time.perf_counter() - t0:.1f} s")
    log(f"[resnet] {resnet['clouds_per_s']:.1f} clouds/s: median of {RESNET_ROUNDS} turns of 10 "
        f"ResNet14 forwards of {B} x {N_POINTS} points, quantization included (host clock), "
        f"turns {[round(t, 1) for t in resnet['clouds_per_s_turns']]} on {smi}")
    t0 = time.perf_counter()
    eval_rows, ev = phase_eval(kernels, cycles_per_ms, device, smi)
    log(f"[eval] phase done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    loop_rows, loop = phase_train_loop(kernels, cycles_per_ms, device, smi, tr["steps_per_s"])
    log(f"[loop] phase done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dp_rows, dp = phase_data_parallel(tp, g, l, lr, kernels, cycles_per_ms, smi,
                                      tr["steps_per_s"], ev["names"][2], loop["names"])
    log(f"[dp] phase done in {time.perf_counter() - t0:.1f} s")
    paths = {"forward": rows, "bf16_forward": bf16_rows, "train_step": train_rows,
             "val_step": val_rows, **bt_rows, "lookup_maps": maps_rows, **mink_rows,
             "resnet": resnet_rows, "eval": eval_rows, "train_loop": loop_rows, "dp": dp_rows}
    return _finish(smi, paths, dict(
        card=smi, slice=sl, bf16=bf16, train=tr, bf16_train=bt, lookup_maps=maps, minkloc=mink,
        resnet=resnet, eval=ev, train_loop=loop, data_parallel=dp, wide=wide,
        determinism=[*repeat_fwd, *bf16["repeats"], *repeat_train, repeat_val, bt["repeat"],
                     bt["conv_repeat"],
                     maps["repeat"], mink["lookup_repeat"], resnet["lookup_repeat"]]), t_start)


def _finish(smi: str, paths: dict, details: dict, t_start: float) -> int:
    """build/chip_smoke.json, then the last three lines: the card, the
    kernels' numbers summed over the paths' calls, and the result."""
    all_rows = merged_rows(*paths.values())
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        dict(details, kernels=all_rows, paths=paths, seconds=time.perf_counter() - t_start),
        indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(f"card: {smi}")
    log(json.dumps({"kernels": [{k: row[k] for k in keys} for row in all_rows.values()]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
