#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (image_restoration_platform_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100 (sm_90a),
the CUDA toolkit and PyTorch built for CUDA:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package, and every phase raises on
failure (exit code 1):

1. report: the card's name and power limit, torch and CUDA versions, and the
   image codec the port's imageio got (native libjpeg/libpng/libwebp or
   Pillow);
2. kernels: builds every CUDA source under csrc/ with nvcc (one process per
   source, started together), holds every variant of each kernel that its
   wrapper can choose against its plain PyTorch version on the card at its
   path's shapes (attention: wgmma at D = 64 and 32 with one consumer
   warpgroup, with three, and with three on some heads and two on the rest,
   each on the plan ``launch_plan`` picks: one block a unit, a persistent
   grid or a key split over a cluster; mma.sync at a T that is no multiple
   of 128; SIMT f32; each on unit-variance and peaked-logit inputs, and every
   plan once more at small shapes, FORCED_PLANS; blend: vector and
   scalar on the 2K -> 4K grid, a clamped grid, overlap = T/2, odd origins
   and a single tile; the fused GroupNorm's two kernels at GN_SHAPES in
   bf16: the moments' sums within GN_SUM_RTOL of the plain f32 sums on
   unit-variance and offset inputs, the FiLM prologue's y and the affine +
   SiLU bit for bit; the window attention at SwinIR-M's shape, plain and
   shifted windows, within ``bf16_parity_bar``, and its launches in one
   swinir-m-x2 tiled call on a 2048 canvas; the Swin layer's add-norm at
   that chunk, both forms and both shifts, the sums bit for bit and the
   LayerNorm within one bf16 ulp, with its launches in the same call, and
   the PyTorch chain it replaces timed as its yardstick), and times the kernel, the
   plain version and the
   library call that computes the same function beside the computed bound
   and, for attention, the exponential limit ``exp_ms`` (CUDA events around
   10 back-to-back calls queued behind a sleep kernel, so host dispatch is
   not timed; median of 20 such groups after warm-up);
3. slice: RestoratorService + MicroBatcher + RestorationEngine(bf16) with
   the shipped weights serve, path by path with the kernels' launch counts
   set to 0 before each and read after it, after ``warmup_serving`` at the
   default buckets has built every executable (CUDA graphs) the paths
   take (its seconds, executables, graphs and device memory printed), so
   no path builds one (``compile_count`` held flat over the restore path):
   - restore: concurrent 256 and 512 requests (clean, low-quality JPEG,
     motion-blurred); every result is checked, each UNet forward at a bucket
     <= 512 launched the attention kernel once, the deblock/deblur fire
     decisions are checked on those canvases, and one 256 request's card
     output is held against the port's CPU f32 run;
   - super-resolution: a 2048x2048 upload through sr-x2 (tiled, 81 tiles,
     4096x4096 out), a 1500x1100 upload (letterboxed, resized on the host on
     the way out), a 384 upload (direct), one sr-x4 request, and
     ``engine.sr_tiled(output="yuv420")``; one blend launch per tiled call
     and no attention launch; a 640 canvas (3x3 tiles) on the card in bf16
     is held against the port's CPU f32 run;
   - diffusion and fusion: a 256 and a 512 diffusion-restore request (two
     attention launches per 256 batch, none at 512) and ``restore_fusion``
     of three 512 captures (one launch);
4. throughput: steady-state images/s and p50 request latency at 256 b1 and
   512 b8, end to end through RestoratorService, and the engine's step time
   with the stages' host syncs and fire counts a step;
   warm wall time of one 2048 -> 4096 sr-x2 request and of ``engine.sr_tiled``
   alone, with the profiler's split of one such step;
5. service graph: the HTTP service's ``AppContext`` on the card (batcher,
   two queue workers) below the HTTP layer, which the card's machine cannot
   import (no aiohttp): ``warmup_serving`` at 256 and 512, then 48 jobs
   through ``api/submit.py:submit_job`` from 8 threads (256 and 512 JPEGs, a
   3000 x 2000 upload that ``resize_u8`` downscales on the card, a fusion
   job, an ``sr-x2`` job, sync jobs) with the kernels' counts set to 0 before
   and read after: every job SUCCEEDED on its first attempt, one credit
   charge each, one attention launch per UNet forward at 256 and 512, one
   blend launch; jobs/s and p50/p95 from submission to SUCCEEDED; then the
   HDR pre-pass (``engine.hdr_deblur_batch``: the disk channel fires, card vs
   CPU), ``ClassifierService`` and ``resize_u8`` card vs CPU, and
   ``get_health_status``;
6. training: ``Trainer`` on the shipped flagship's own recipe
   (scripts/queues/r5_anchor.json: restore-unet, batch 32, 128 px, warm
   start) in a temporary ``IRP_WEIGHTS_DIR`` holding copies of the shipped
   weights. The trainer's executable tier (train/exec.py: the train step
   as one CUDA graph, each of the recipe's three data distributions as
   one) against ``Trainer(eager=True)``, with cuDNN's deterministic
   algorithms on both sides: 8 steps in lockstep (batches and losses equal
   bit for bit, one attention launch a step on each side, ``compile_count``
   1 + 3 and flat), a checkpoint saved at step 4 and resumed into a graph
   trainer that had built and stepped (the uninterrupted losses bit for
   bit), ``remat`` (two launches a step), and three steps each of sr-x2,
   diffusion-restore (x0 and eps) and the sampler-aware loss at b8. Then,
   with cuDNN's defaults, graph and eager trainers warmed (5 steps: every
   executable built) and timed in blocks of 10 steps (eager, graph, graph,
   eager), the attention kernel's count set to 0 before the graph blocks and
   read after (one launch per step), the train step and ``synthetic_batch``
   timed apart with CUDA events, images/s, peak memory, the graph build's
   memory and one profiled step of each; the loss and global gradient norm
   on the card against the CPU on one batch (f32 against f32, bf16 against
   bf16, and bf16's loss gap to f32 against the JAX trainer's); fused AdamW
   on the card against the CPU; the npz export round trip; ``main()`` with
   ``TRAIN_STEPS=2`` (graphs);
7. mesh: the mesh surfaces on slot meshes that repeat the card
   (``make_mesh([cuda:0] * 4, ...)``; the slots share one stream, so their
   times show the cost of a mesh path, not scaling), bf16, shipped weights,
   each against the unsharded port with the reference's bars and its
   kernels' launches counted from 0: restore-unet 512 b8 through
   RestoratorService on data=4 and on data=2 x tensor=2 (4 and 2 attention
   launches a batch), image by image, the stages' fire flags equal to the
   unsharded engine's, data=4 equal to the unsharded engine at batch 2, and
   one profiled step each; sr-x2 2048 through ``engine.sr_tiled`` on data=4
   (equal, one blend launch); ``engine.sr_spatial`` on spatial=4 at 2048 and
   on a 1501-row canvas (padded rows); ``srnet_pipeline_apply`` on pipe=4 and
   ``unet_pipeline_apply`` on data=2 x pipe=2 at 512 with 4 microbatches; two
   ``Trainer`` steps on data=2 against two unsharded steps (f32); and
   ``maybe_initialize_distributed`` with one rank on NCCL and one
   ``all_reduce``. Every mesh surface runs through the mesh executable tier
   (CUDA graphs, each data row's on its own, replayed segment-major) after
   its engine's ``warmup_serving`` (``compile_count`` held flat) and is held
   to ``RestorationEngine(mesh=..., eager=True)``: restore 512 b8 on both
   meshes on a batch that fires deblock and deblur in some shards and on one
   that fires nothing, ``sr_tiled`` in both egresses, ``sr_spatial`` on both
   canvases, bytes and attention / blend launches equal, then eager and
   graph step times in turns (eager, graph, graph, eager) with one profiled
   step each (kernel ms, kernels, host kernel and graph launches, idle
   share); the mesh ``Trainer`` on data=2 on graphs against its eager twin
   bit for bit over 8 steps of the r5 mix (deterministic cuDNN) in f32 and
   in bf16 with their step times, and again for 3 steps with the one-rank
   NCCL group up (the step's ``all_gather`` and ``all_reduce`` captured);
   and the W-folded flagship (``fold_w``) at 512 b8 on data=2 x tensor=2 on
   graphs against the single-device folded engine (the column-parallel
   layers hold whole channel pairs, two attention launches a batch);
8. quality and bench: the quality gates of tests/test_quality*.py
   (eval/gates.py) on the card in bf16 with the shipped weights, the
   attention kernel's count set to 0 before and read after (one launch per
   UNet forward at 128 px): the OOD gates (six classes at seed 2026, n 8,
   128 px; motion's per-image mean; clean harm at seed 2027), each class's
   card gain within 0.2 dB of the port's CPU bf16 run on the same inputs;
   the in-distribution gates (flagship, near-clean, sr-x2 and sr-x4 over
   nearest, smooth no-hallucination, diffusion) on the port's own
   ``synthetic_batch`` draws at the gate seeds, made on the CPU; then
   ``python -m image_restoration_platform_tpu_torch.bench`` in a subprocess:
   its headline parses, with a positive value, ``mfu`` in (0, 1], the
   validity stamp VALID, and attention and blend launches in its run;
9. graphs: the executable tier (serve/exec_cache.py) on phase 3's engine
   against an engine that runs the same programs eagerly
   (``RestorationEngine(eager=True)``), on every surface the warm-up built
   (restore-unet and diffusion-restore at 256, 512, 1024 x b1-b8, each on
   a batch that fires no stage and on batches that fire deblock, the veto's
   gate and deblur; fusion k3; sr-x2 direct and tiled 2048 in both
   egresses) and on the HDR pre-pass: the outputs equal in bytes (a
   surface named in GRAPH_LEVEL_EXCEPTIONS, with the op that differs
   under capture, may differ by 1 level), the attention and blend launches
   equal, ``compile_count`` flat; then the eager and graph engine step at
   256 b1, 512 b8 and sr_tiled 2048, timed in turns (eager, graph, graph,
   eager) with one profiled step each: kernel ms, kernels, the host's
   kernel-launch and graph-launch calls, idle share;
10. fold: the W-fold serving layout (models/folded.py, ``fold_w`` and
   ``fold_w_sr``): a bf16 engine with both on and one with both off, on
   graphs after ``warmup_serving``, on restore-unet 256 b1 and 512 b8 (a
   firing and a clean batch each), diffusion-restore 256, fusion k3 at 512,
   sr-x2 direct at 384 and tiled 2048 -> 4096: folded bytes against
   unfolded (SR at the reference's bf16 bar, tests/test_folded.py; the UNet
   surfaces at the bf16 bar; every surface in an f32 engine pair at the
   reference's f32 bar), the folded run against the port's
   unfolded CPU f32 run, attention and blend launches equal and above 0
   where the surface launches the kernel, ``compile_count`` flat; then the
   median of 24 steps of each engine taken in alternation and one profiled
   step each, and the defaults those times argue for (``fold_w_sr`` stays
   on unless the folded sr_tiled step is slower by more than the engines'
   spread; ``fold_w`` goes on only if the folded 512 b8 step is faster by
   more than it);
11. promotion: the retrain-and-promote chain (retrain/) with the shipped
   weights in bf16: the port's r5_anchor.json manifest, its two chunks cut
   to 20 steps in a temporary staging directory warm-started from a copy
   of weights/restore-unet.npz, run by ``chip_queue.Runner`` behind the card
   probe "alive" (both chunks done, the attention kernel launched in each
   payload, read from its log); ``rank_candidates --include-shipped`` at
   --n 4 in this process (every candidate scored); ``validate_staging`` on
   the ranker's winner (its row printed) and on a byte copy of weights/
   (every family PROMOTEs with no regression, the largest |staged - shipped|
   printed); the attention launches of the ranker and the gate counted
   from 0; weights/ unchanged.

Every engine and trainer replays CUDA graphs by default (the executable
tier), so phases 3-8 run on graphs; the launch counts read the kernels' counters,
which every graph replay advances by the launches its capture recorded.
Every path that runs a UNet also reads the fused GroupNorm kernels' counts
(``_read_gn``: restore, diffusion and fusion, the service graph, train, the
mesh restores, the quality gates, bench, the graph phase, the fold phase,
the promotion's ranker and gate and its payloads' logs); a count of 0 fails.
Phase 2 also holds the kernel at the training shapes ([32, 4, 256, 64] and
[32, 4, 1024, 64] bf16) and checks the gradients through ``FlashAttention``
(the kernel's forward, the plain backward) against autograd through the
plain forward at [32, 4, 256, 64].

``--report PATH`` also writes the full report as JSON to PATH;
``--kernels-only`` stops after phase 2 (a quick check of a changed kernel),
``--plan-sweep`` times every attention plan the wrapper weighs at every
launched shape after it and fits the plan model to the times,
and ``--train-only``, ``--mesh-only``, ``--quality-only``,
``--graphs-only``, ``--fold-only`` and ``--promotion-only`` run phase 6, 7,
8, 9, 10 or 11 (after its own warm-up) alone after the builds; they print no result lines and exit 0 or 1. The last
lines of standard output are the card line, the kernels JSON line, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import hashlib
import json
import logging
import os
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "image_restoration_platform_tpu_torch"

KERNEL_SHAPES = [  # (shape [N,H,T,D], dtype, where the path uses it)
    ((1, 4, 1024, 64), "bfloat16", "restore-unet 256 b1"),
    ((8, 4, 4096, 64), "bfloat16", "restore-unet 512 b8"),
    ((3, 4, 4096, 64), "bfloat16", "fusion of three 512 captures (a batch that is no power of two)"),
    ((2, 2, 1024, 32), "bfloat16", "restore-unet-small 64 b2"),
    ((1, 4, 192, 64), "bfloat16", "T no multiple of 128"),
    ((1, 4, 1024, 64), "float32", "restore-unet 256 b1, f32 engine"),
    ((32, 4, 256, 64), "bfloat16", "training restore-unet 128 b32 (the r5-anchor recipe)"),
    ((32, 4, 1024, 64), "bfloat16", "training diffusion-restore 128 b32"),
    ((2, 4, 4096, 64), "bfloat16", "mesh restore-unet 512 b8 on data=4: one slot's shard"),
    ((4, 4, 4096, 64), "bfloat16", "mesh restore-unet 512 b8 on data=2 x tensor=2: one slot's shard"),
    ((1, 4, 4096, 64), "bfloat16", "unet_pipeline_apply 512 b8, data=2 x pipe=2: one microbatch of a data row; "
                                    "bench single 512 requests"),
    ((4, 4, 256, 64), "float32", "mesh train step 128 b8 on data=2 (the f32 check): one slot's shard"),
    ((8, 4, 256, 64), "bfloat16", "quality gates: restore-unet 128 b8"),
    ((8, 4, 1024, 64), "bfloat16", "quality gates: diffusion-restore 128 b8"),
    ((32, 2, 4096, 32), "bfloat16", "training restore-unet-small 128 b32"),
    ((2, 4, 1024, 64), "bfloat16", "restore-unet 256 b2 / b4 serving; diffusion-restore 128"),
    ((4, 4, 1024, 64), "bfloat16", "restore-unet 256 b2 / b4 serving; diffusion-restore 128"),
    ((48, 4, 256, 64), "bfloat16", "retrain gate: eval.ood at its n = 48, restore-unet 128"),
    ((4, 4, 256, 64), "bfloat16", "retrain ranker: eval.ood and eval.flagship_quick at --n 4, restore-unet 128"),
    ((16, 4, 256, 64), "bfloat16", "the train entry point's held-out evals, restore-unet 128 b16"),
]
# the fused GroupNorm (ops/cuda/group_norm.py): NHWC bf16 tensors at the
# main path's GroupNorm sites, (shape, SiLU after the affine, where). Every
# row runs the moments kernel plain and with the FiLM prologue, and the
# affine kernel; the W-folded restore UNet (SERVE_FOLD_W) doubles C and
# halves W, and the decoder's concat parts are these shapes too
GN_SHAPES = [
    ((8, 256, 128, 128), True, "restore-unet 512 b8 folded, level 0 (and the level-2 up-block's skip part)"),
    ((8, 128, 64, 256), True, "restore-unet 512 b8 folded, level 1 (and the up-blocks' parts)"),
    ((8, 64, 32, 512), True, "restore-unet 512 b8 folded, level 2 and the bottleneck (the first concat: two parts)"),
    ((8, 64, 64, 256), False, "restore-unet 512 b8: the attention's GroupNorm, unfolded (no SiLU)"),
    ((1, 128, 64, 128), True, "restore-unet 256 b1 folded, level 0"),
    ((32, 64, 64, 64), True, "training restore-unet 128 b32, unfolded, level 0"),
]
# restore-unet's norm_groups; the moments' sums are held to the plain f32
# sums within GN_SUM_RTOL relative to the sum of |x| (s1: the sum of a
# zero-mean input cancels, so its own size is no scale) and to s2 itself;
# inputs of unit variance, and offset ones (mean 4, std 0.1), where
# E[x^2] - mu^2 cancels to 1/1600 of E[x^2] and the clamp must hold it >= 0
GN_GROUPS, GN_SUM_RTOL = 32, 1e-5
GN_INPUTS = {"unit": (0.0, 1.0), "offset": (4.0, 0.1)}
GN_MAIN_SHAPE = (8, 256, 128, 128)
# the gradient check: dq, dk, dv through FlashAttention (kernel forward, plain
# backward) against autograd through the plain forward, at the training shape
GRAD_SHAPE = (32, 4, 256, 64)
# every variant ops.cuda.attention.launch_plan can choose has a shape above
ATTENTION_VARIANTS = ("wgmma_q64", "wgmma_q192", "mma_sync", "simt_f32")
# Which plan the wgmma kernel gets depends on the card's SM count, so every
# plan it can take is also forced once, for correctness only, on peaked
# inputs: (shape, consumer warpgroups, heads of the N*H that take the full
# 192-query units, key splits, clusters or None for one a unit). At T = 640
# (no multiple of 192: the last unit of a head reaches past it) one
# warpgroup on 64 queries, three on 192, the mix of 192- and 128-query units,
# and persistent grids that walk several units a block (unevenly: 80, 100 and
# 200 units on 7, 9 and 13 blocks); at T = 1024 the key split over clusters
# of 2 and 4 blocks, on alike and on mixed units (three warpgroups split 4 ways
# only at D = 32: at D = 64 their partials outgrow shared memory); each at
# D = 64 and D = 32.
FORCED_PLANS = tuple(
    plan for d in (64, 32) for plan in (
        ((5, 4, 640, d), 1, 20, 1, None), ((5, 4, 640, d), 3, 20, 1, None), ((5, 4, 640, d), 3, 7, 1, None),
        ((5, 4, 640, d), 3, 0, 1, None), ((5, 4, 640, d), 3, 20, 1, 7), ((5, 4, 640, d), 3, 0, 1, 9),
        ((5, 4, 640, d), 1, 20, 1, 13), ((3, 4, 1024, d), 1, 12, 2, None), ((3, 4, 1024, d), 1, 12, 4, None),
        ((3, 4, 1024, d), 3, 12, 2, None), ((3, 4, 1024, d), 3, 5, 2, None),
        ((3, 4, 1024, d), 3, 0, 4 if d == 32 else 2, None)))
# bf16 is held to ops.cuda.attention.bf16_parity_bar: 0.02 (the reference's
# own) and at most 4 bf16 ulps of max |plain|, since at T = 4096 with
# unit-variance inputs a typical output is ~0.03. f32 is held to 1e-4.
F32_ATOL = 1e-4
# (q scale, v scale): unit-variance inputs, and peaked logits (std 4, the
# online softmax's running max jumps between tiles) with outputs kept below 1
INPUT_SCALES = {"randn": (1.0, 1.0), "peaked": (4.0, 0.125)}
# bf16 card output vs the port's f32 CPU run of the same canvas. bf16 keeps 8
# significant bits, so the ingress x = k/255 alone moves up to ~0.5 level
# near 1.0, and the UNet runs ~40 layers in bf16; the port's CPU bf16 run
# against its CPU f32 run measured mean 0.48-0.53 levels and 99.9th
# percentile 3 levels on such canvases. Scores are f32 on both sides.
CPU_MEAN_LEVELS, CPU_P999_LEVELS, CPU_SCORES_ATOL = 1.0, 4.0, 1e-4

# SwinIR's window attention (ops/cuda/window_attention.py) at the SR path's
# shape: a chunk of 8 tiles of 256 is 8 x 32 x 32 windows of 64 tokens with
# 6 heads of 30 (swinir-m-x2); each row runs plain (shift 0) and shifted
# (shift 4) windows. Its launches are read from one replay of the family's
# tiled call on a 2048 canvas: 36 layers x 11 chunks
WINDOW_ATTENTION_SHAPE = (8, (32, 32), 6, 30)  # tiles, window grid, heads, head dim
WINDOW_ATTENTION_FAMILY, WINDOW_ATTENTION_CANVAS = "swinir-m-x2", 2048
# the Swin layer's add-norm (ops/cuda/swin_add_norm.py) at the same chunk:
# [tiles, 256, 256, 180] bf16; every form at shift 0 and 4. Its launches in
# the 2048 call: two a Swin layer and chunk
SWIN_ADD_NORM_SHAPE = (8, 256, 256, 180)
SWIN_ADD_NORM_FORMS = ("to_windows", "to_windows_no_add", "from_windows")
# the Swin layer's MLP (ops/cuda/swin_mlp.py) at the same chunk: [8 x 256 x
# 256 tokens, 180] -> 360 -> 180 bf16. Its launches in the 2048 call: one a
# Swin layer and chunk
SWIN_MLP_SHAPE = (8 * 256 * 256, 180, 360)

# the blend: (canvas h x w, tile, overlap, scale, where the path uses it);
# tiles of T*scale land at scaled origins, as ops/tile.py tiled_apply calls it
BLEND_MAIN = ((2048, 2048), 256, 32, 2)
BLEND_CLAMPED = ((1024, 1024), 256, 32, 2)
BLEND_SHAPES = [
    (*BLEND_MAIN, "sr-x2 2048 -> 4096, 81 tiles"),
    (*BLEND_CLAMPED, "sr-x2 1024 bucket, clamped last tile"),
    ((1024, 1024), 256, 128, 1, "overlap = T/2"),
    ((100, 68), 32, 8, 1, "clamped in both axes"),
    ((99, 67), 32, 8, 1, "odd origins and row length: scalar only"),
    ((64, 56), 32, 24, 1, "four tiles cover a row"),
    ((256, 256), 256, 32, 2, "single tile"),
]
# the reference's own bar on a 0..255 range (tests/test_pallas_blend.py); the
# kernel repeats the plain fold's f32 arithmetic, so the error should be 0
BLEND_ATOL = 1e-3

# the service phase: async JPEG jobs per bucket (256 and 512), sync jobs, and
# the seconds every job has to reach SUCCEEDED
SERVICE_JOBS_PER_BUCKET = 20
SERVICE_SYNC_JOBS = 5
SERVICE_DEADLINE_S = 120.0
# the HDR pre-pass: a disk PSF its float path identifies at 16 bits; card
# against CPU at 1e-3 on [0, 1] (the FFTs and reductions run in other orders)
HDR_RADIUS = 2.5
HDR_ATOL = 1e-3
CLASSIFY_ATOL = 1e-4

# the training phase: the shipped flagship's own recipe
# (scripts/queues/r5_anchor.json, chunk 1), warm-started from a copy of its
# weights; remat is off in the recipe, so one attention launch per step
TRAIN_RECIPE = dict(
    family="restore-unet", batch_size=32, image_size=128, learning_rate=2e-5, total_steps=4000,
    identity_weight=6.0, data_photo=True, data_deconv=True, data_grain=True, data_smooth=True,
    data_mix_mild=0.5, data_mix_rich=0.2, data_compression_solo=0.3, data_lowlight_solo=0.18, anchor_comp=0.5,
    seed=601,
)
TRAIN_ENV = {  # the same recipe as the entry point reads it
    "TRAIN_FAMILY": "restore-unet", "TRAIN_RESUME": "1", "TRAIN_DATA_PHOTO": "1", "TRAIN_DATA_DECONV": "1",
    "TRAIN_DATA_GRAIN": "1", "TRAIN_DATA_SMOOTH": "1", "TRAIN_DATA_MIX_MILD": "0.5", "TRAIN_DATA_MIX_RICH": "0.2",
    "TRAIN_DATA_COMP_SOLO": "0.3", "TRAIN_DATA_LOWLIGHT_SOLO": "0.18", "TRAIN_ANCHOR_COMP": "0.5",
    "TRAIN_BATCH": "32", "TRAIN_SIZE": "128", "TRAIN_LR": "2e-5", "TRAIN_IDENTITY_WEIGHT": "6.0", "TRAIN_SEED": "601",
}
# the main path: warm-up steps until every executable of the r5 mix is built
# (its rich distribution first comes at step 5), then 20 timed steps of each
# trainer in blocks of 10 (eager, graph, graph, eager)
TRAIN_WARMUP_STEPS, TRAIN_TIMED_STEPS = 5, 20
# graph against eager: 8 steps (the three distributions), a checkpoint
# saved before step 5 and resumed into a graph trainer that has built and
# stepped; TRAIN_GRAPH_WARMUP is train/exec.py's WARMUP_STEPS (a step that
# builds the graph launches the attention kernel that many times more)
TRAIN_COMPARE_STEPS, TRAIN_RESUME_AT, TRAIN_GRAPH_WARMUP = 8, 4, 2
# the optimizer card against CPU: one tensor of this size, five steps
TRAIN_OPT_SIZE = 1 << 20
# card against CPU: the same warm weights, one batch of 4 at 128 px drawn on
# the CPU. In f32 (TF32 off) the loss within 2 %, the global gradient norm
# within 5 % and the gradients' cosine >= 0.99; in bf16 the loss within 2 % of
# the CPU's bf16 loss. Card bf16 against CPU f32: the loss gap is the JAX
# trainer's own on this batch to 10 %. That gap is 6.27 % (its bf16 loss over
# its f32 loss, tests/test_torch_train_flagship.py): at the shipped state the
# loss is ~0.007 and bf16 rounding moves it by more than a 2 % bar, and the
# gradient is mostly rounding in both packages (cosine to f32 0.54 in the
# reference on the CPU, 0.14 in the port), so the gradient norm across dtypes
# is printed, not held
TRAIN_CPU_BATCH, TRAIN_LOSS_RTOL, TRAIN_GRAD_NORM_RTOL, TRAIN_GRAD_COSINE = 4, 0.02, 0.05, 0.99
TRAIN_REFERENCE_BF16_GAP, TRAIN_GAP_RTOL = 0.06271, 0.10
# the other branches: three steps each at batch 8, 128 px, graph against
# eager, and the attention launches of each step (SR has no attention; the
# diffusion UNet attends once a forward at 32 x 32 tokens; the sampler-aware
# loss runs two forwards)
TRAIN_BRANCHES = (("sr-x2", "sr-x2", {}, 0), ("diffusion_x0", "diffusion-restore", {}, 1),
                  ("diffusion_eps", "diffusion-restore", {}, 1),
                  ("sampler_aware", "diffusion-restore", {"diffusion_sampler_steps": 2}, 2))
# the export round trip: fp16 storage moves a weight by at most 2^-11 of it
# (2^-25 below fp16's normal range); the f32 forward on the stored weights
# stays within one level of the trained weights' (every shipped checkpoint is
# served from fp16 storage; a CPU rehearsal at 32 px measured 0.44 level)
EXPORT_PARAM_RTOL, EXPORT_PARAM_ATOL, EXPORT_OUT_ATOL = 2.0**-11, 2.0**-25, 1.0 / 255


def fail(message: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {message}")


def check(cond: bool, message: str) -> None:
    if not cond:
        fail(message)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- inputs


def _cells(np, rng, size: int):
    """Voronoi mosaic with shaded cells, rendered at 2x and box-downsampled."""
    ss = size * 2
    k = int(rng.integers(10, 24))
    pts = rng.uniform(0, ss, size=(k, 2))
    colors = rng.uniform(0.1, 0.9, size=(k, 3))
    yy, xx = np.mgrid[0:ss, 0:ss].astype(np.float32)
    d2 = (yy[None] - pts[:, 0, None, None]) ** 2 + (xx[None] - pts[:, 1, None, None]) ** 2
    dmin = np.sqrt(d2.min(0))
    img = colors[np.argmin(d2, axis=0)] * (1.0 - 0.25 * (dmin / dmin.max())[..., None])
    return img.reshape(size, 2, size, 2, 3).mean(axis=(1, 3))


def _photo(np, seed: int, size: int):
    """Voronoi mosaic with shaded cells, fine sinusoid texture and noise."""
    rng = np.random.default_rng(seed)
    img = _cells(np, rng, size)
    img += rng.normal(0, 0.02, img.shape)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    tex = np.zeros((size, size), np.float32)
    for _ in range(12):
        f, a, ph = rng.uniform(0.05, 0.35), rng.uniform(0, np.pi), rng.uniform(0, 6.28)
        tex += np.sin(2 * np.pi * f * (xx * np.cos(a) + yy * np.sin(a)) + ph)
    img = img + 0.12 * tex[..., None] / np.sqrt(12.0) + rng.normal(0, 0.03, img.shape)
    return np.clip(img, 0, 1).astype(np.float32)


def _photo_large(np, seed: int, h: int, w: int):
    """A photo-like [h, w, 3] u8 image made at full size in a few passes:
    Voronoi cells from a 1/8-size label map (sharp edges), a smooth colour
    field, sinusoid texture and sensor noise."""
    rng = np.random.default_rng(seed)
    cells = _photo(np, seed, max(256, -(-max(h, w) // 8)))[: -(-h // 8), : -(-w // 8)]
    img = np.repeat(np.repeat(cells, 8, axis=0), 8, axis=1)[:h, :w].copy()
    yy = np.arange(h, dtype=np.float32)[:, None]
    xx = np.arange(w, dtype=np.float32)[None, :]
    for c in range(3):
        img[..., c] += 0.15 * np.sin(xx / (90.0 + 20 * c)) * np.cos(yy / (70.0 + 15 * c))
    tex = np.zeros((h, w), np.float32)
    for _ in range(6):
        f, a, ph = rng.uniform(0.02, 0.3), rng.uniform(0, np.pi), rng.uniform(0, 6.28)
        tex += np.sin(2 * np.pi * f * (xx * np.cos(a) + yy * np.sin(a)) + ph)
    img += 0.08 * tex[..., None] / np.sqrt(6.0)
    img += rng.normal(0, 0.02, img.shape).astype(np.float32)
    return np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)


def _motion_blur(np, img, psf):
    h, w = img.shape[:2]
    pad = np.zeros((h, w), np.float32)
    ph, pw = psf.shape
    pad[:ph, :pw] = psf
    otf = np.fft.rfft2(np.roll(pad, (-(ph // 2), -(pw // 2)), axis=(0, 1)))
    return np.stack(
        [np.fft.irfft2(np.fft.rfft2(img[..., c]) * otf, s=(h, w)) for c in range(3)], axis=-1
    )


def build_requests(np, imageio, motion_psf):
    """{name: (encoded bytes, what it was built to trigger)}."""
    u8 = lambda x: np.clip(np.round(x * 255.0), 0, 255).astype(np.uint8)  # noqa: E731
    reqs = {}
    for size in (256, 512):
        reqs[f"clean{size}"] = (imageio.encode_png(u8(_photo(np, 1, size))), "none")
        reqs[f"jpeg{size}"] = (imageio.encode_jpeg(u8(_photo(np, 3, size)), quality=15), "deblock")
        blurred = _motion_blur(np, _photo(np, 2, size), motion_psf(9.0, 0.9))
        reqs[f"blur{size}"] = (imageio.encode_png(u8(blurred)), "deblur")
    # a non-square upload, letterboxed into the 512 bucket
    reqs["wide512"] = (imageio.encode_jpeg(u8(_photo(np, 7, 512)[:300, :400]), quality=85), "none")
    return reqs


# ----------------------------------------------------------------- timing


def time_ms(torch, fn, groups: int = 20, calls: int = 10, warmup: int = 3) -> float:
    """Device ms per call of ``fn``: each group queues ``calls`` calls behind
    a sleep kernel, so they run back to back on the card with no gap for the
    host's dispatch, between one pair of events; median over the groups."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times, behind = [], 0
    for _ in range(groups):
        torch.cuda._sleep(20_000_000)  # ~10 ms of clock cycles: the host queues the group meanwhile
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        behind += start.query()  # the card reached the group before the host had queued it
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    if behind:
        print(f"time_ms: the host fell behind the card in {behind} of {groups} groups", flush=True)
    return statistics.median(times)


def attention_bound_ms(shape, dtype: str) -> tuple[float, str]:
    from image_restoration_platform_tpu_torch.utils.peaks import HBM_BYTES_PER_S, PEAK_FLOPS

    n, h, t, d = shape
    nbytes = 4 * n * h * t * d * (2 if dtype == "bfloat16" else 4)  # q, k, v read; o written
    flops = 4 * n * h * t * t * d  # Q K^T and P V
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sm_clock_hz(torch) -> float:
    """The SM clock ``torch.cuda.get_device_properties`` reports (kHz)."""
    khz = getattr(torch.cuda.get_device_properties(0), "clock_rate", 0)
    check(khz > 0, "torch.cuda.get_device_properties reports no SM clock (clock_rate)")
    return 1e3 * float(khz)


def attention_exp_ms(shape, sm_count: int, clock_hz: float) -> float:
    """The exponential limit: N H T^2 exp2 at 16 a clock per SM (the SFU
    rate of Hopper). A limit of its own beside ``attention_bound_ms``: at
    D = 32 it is the larger of the two."""
    n, h, t, _ = shape
    return 1e3 * n * h * t * t / (16 * sm_count * clock_hz)


def blend_bound_ms(n_tiles: int, t: int, c: int, out_h: int, out_w: int) -> tuple[float, str]:
    from image_restoration_platform_tpu_torch.utils.peaks import HBM_BYTES_PER_S, PEAK_FLOPS

    nbytes = 4 * (n_tiles * t * t * c + out_h * out_w * c)  # tiles read, canvas written, f32
    flops = 3 * n_tiles * t * t * c  # multiply, add, and the window sum
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["float32"]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def gn_bound_ms(shape, variant: str, silu: bool = True) -> tuple[float, str]:
    """The least time of one fused GroupNorm call on bf16 [N, H, W, C]:
    each input read once and each output written once (the [N, C] f32
    vectors included) over the memory rate, against its f32 operations
    (moments: add and multiply-add an element; the FiLM prologue three more;
    the affine a multiply and an add, the SiLU four) over the f32 peak."""
    from image_restoration_platform_tpu_torch.utils.peaks import HBM_BYTES_PER_S, PEAK_FLOPS

    n, h, w, c = shape
    elems, vec = n * h * w * c, 4 * n * c
    if variant == "moments":
        nbytes, flops = 2 * elems + 2 * vec, 3 * elems
    elif variant == "film":
        nbytes, flops = 4 * elems + 2 * c + 4 * n * c + 2 * vec, 6 * elems
    else:
        nbytes, flops = 4 * elems + 2 * vec, (6 if silu else 2) * elems
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["float32"]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# ----------------------------------------------------------------- phases


def phase_gn_kernels(torch, report):
    """The fused GroupNorm kernels at the main path's shapes in bf16: the
    moments against the plain f32 sums (and the clamped group variance on
    offset inputs), the FiLM prologue's y and the affine + SiLU bit for bit
    against their plain versions; then the kernels, the plain versions and
    the yardstick F.silu(F.group_norm(...)) (two library calls, on the NCHW
    channels_last view of the same tensor) timed beside the byte bound."""
    from image_restoration_platform_tpu_torch.models import nn as L
    from image_restoration_platform_tpu_torch.ops.cuda import group_norm as G

    F = torch.nn.functional
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(3)

    def randn(shape, scale=1.0, loc=0.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device="cuda") * scale + loc).to(dtype)

    def sum_errors(got, want, x):
        mag = x.float().abs().sum(dim=(1, 2))
        return {"s1_err_over_sum_abs": float(((got[0] - want[0]).abs() / mag).max()),
                "s2_rel_err": float(((got[1] - want[1]).abs() / want[1]).max()),
                "max_abs_err": max(float((a - b).abs().max()) for a, b in zip(got, want))}

    rows = []
    for shape, silu, where in GN_SHAPES:
        n, h, w, c = shape
        g = L.gn_groups(c, GN_GROUPS)
        cnt = h * w * (c // g)
        x = randn(shape)
        checks = {}
        for inputs, (loc, scale) in GN_INPUTS.items():
            xi = x if inputs == "unit" else randn(shape, scale, loc)
            got, want = G.moments_kernel(xi), G.moments_reference(xi)
            torch.cuda.synchronize()
            row = sum_errors(got, want, xi)

            def group_var(s1, s2):
                mean = s1.reshape(n, g, -1).sum(-1) / cnt
                return torch.clamp(s2.reshape(n, g, -1).sum(-1) / cnt - mean * mean, min=0.0)

            var64 = xi.double().reshape(n, h * w, g, c // g).var(dim=(1, 3), unbiased=False)
            var_k, var_p = group_var(*got), group_var(*want)
            row.update(var_min=float(var_k.min()), var_rel_err=float(((var_k - var64).abs() / var64).max()),
                       plain_var_rel_err=float(((var_p - var64).abs() / var64).max()))
            checks[f"moments_{inputs}"] = row
            check(row["s1_err_over_sum_abs"] <= GN_SUM_RTOL and row["s2_rel_err"] <= GN_SUM_RTOL,
                  f"gn_moments {shape} {inputs}: {row}")
            check(row["var_min"] >= 0.0 and bool(torch.isfinite(torch.rsqrt(var_k + 1e-5)).all()),
                  f"gn_moments {shape} {inputs}: the clamped group variance {row}")
        cb, gb = randn((c,), 0.3), randn((n, 2 * c), 0.5)
        got, want = G.moments_kernel(x, cb, gb), G.film_moments_reference(x, cb, gb)
        torch.cuda.synchronize()
        checks["film"] = {"y_equal": bool(torch.equal(got[0], want[0])), **sum_errors(got[1:], want[1:], want[0])}
        check(checks["film"]["y_equal"], f"gn_moments FiLM prologue {shape}: y differs from the plain chain")
        check(checks["film"]["s1_err_over_sum_abs"] <= GN_SUM_RTOL and checks["film"]["s2_rel_err"] <= GN_SUM_RTOL,
              f"gn_moments FiLM prologue {shape}: {checks['film']}")
        weight, bias = randn((c,), 0.1, 1.0, torch.float32), randn((c,), 0.1, dtype=torch.float32)
        sc, bi = L._folded_affine(weight, bias, *L._group_moments(*G.moments_reference(x), g, cnt, 1e-5))
        out, ref = G.affine_silu_kernel(x, sc, bi, silu), G.affine_silu_reference(x, sc, bi, silu)
        torch.cuda.synchronize()
        checks["affine"] = {"equal": bool(torch.equal(out, ref)),
                            "max_abs_err": float((out.float() - ref.float()).abs().max())}
        check(checks["affine"]["equal"], f"gn_affine_silu {shape} silu={silu}: {checks['affine']}")

        xc, wb, bb = x.permute(0, 3, 1, 2), weight.to(bf16), bias.to(bf16)  # NCHW, channels_last

        def library():
            o = F.group_norm(xc, g, wb, bb)
            return F.silu(o) if silu else o

        timed = {}
        for variant, kernel, plain in (
            ("moments", lambda: G.moments_kernel(x), lambda: G.moments_reference(x)),
            ("film", lambda: G.moments_kernel(x, cb, gb), lambda: G.film_moments_reference(x, cb, gb)),
            ("affine", lambda: G.affine_silu_kernel(x, sc, bi, silu), lambda: G.affine_silu_reference(x, sc, bi, silu)),
        ):
            bound, bound_by = gn_bound_ms(shape, variant, silu)
            timed[variant] = {"ms": time_ms(torch, kernel), "plain_ms": time_ms(torch, plain, groups=10),
                              "bound_ms": bound, "bound_by": bound_by}
        row = {"kernel": "fused_group_norm", "shape": list(shape), "dtype": "bfloat16", "silu": silu, "groups": g,
               "path": where, "checks": checks, **timed,
               "library_ms": time_ms(torch, library, groups=10),
               "library": "F.silu(F.group_norm(x)): two calls" if silu else "F.group_norm(x): one call"}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del x, out, ref, got, want
    torch.cuda.empty_cache()
    report["gn_checks"] = rows
    return rows


def phase_window_attention(torch, report):
    """The window attention kernel at SwinIR-M's shape, plain and shifted:
    against its plain version (``bf16_parity_bar``), timed beside its byte
    bound, the plain version and F.scaled_dot_product_attention with the
    bias and mask as a float mask (on q, k, v and the mask made beforehand);
    then its launches in one replay of the family's tiled call on a 2048
    canvas (random weights: the family ships none), and that call's time."""
    import numpy as np

    from image_restoration_platform_tpu_torch.ops.cuda import attention as A
    from image_restoration_platform_tpu_torch.ops.cuda import window_attention as W
    from image_restoration_platform_tpu_torch.ops.cuda.swin_add_norm import swin_add_norm_kernel
    from image_restoration_platform_tpu_torch.ops.cuda.swin_mlp import swin_mlp_kernel
    from image_restoration_platform_tpu_torch.serve import RestorationEngine
    from image_restoration_platform_tpu_torch.utils.peaks import HBM_BYTES_PER_S

    F = torch.nn.functional
    tiles, (gh, gw), heads, d = WINDOW_ATTENTION_SHAPE
    nw, c = tiles * gh * gw, heads * d
    gen = torch.Generator(device="cuda").manual_seed(5)
    qkv = torch.randn((nw, 64, 3 * c), generator=gen, device="cuda").to(torch.bfloat16)
    table = torch.randn((225, heads), generator=gen, device="cuda") * 0.5
    nbytes = 4 * nw * 64 * c * 2 + table.numel() * 4  # q, k, v read, o written; the table
    q, k, v = (t.contiguous() for t in qkv.view(tiles, gh * gw, 64, 3, heads, d).permute(3, 0, 1, 4, 2, 5))
    bias = table[W.relative_position_index(8).cuda()].permute(2, 0, 1)  # [heads, 64, 64]
    rows = []
    for shift in (0, 4):
        ref = W.window_attention_reference(qkv, table, heads, shift, (gh, gw))
        out = W.window_attention_kernel(qkv, table, heads, shift, (gh, gw))
        torch.cuda.synchronize()
        mask = bias[None].expand(gh * gw, -1, -1, -1)
        if shift:
            mask = mask + W.region_mask((gh, gw), 8, shift).cuda()[:, None]
        mask = mask[None].to(torch.bfloat16).contiguous()  # [1, nW, heads, 64, 64]

        def library():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

        lib = library().permute(0, 1, 3, 2, 4).reshape(nw, 64, c)
        row = {"kernel": "window_attention", "shape": [nw * heads, 64, d], "qkv": list(qkv.shape), "heads": heads,
               "shift": shift, "dtype": "bfloat16", "path": f"{WINDOW_ATTENTION_FAMILY} sr_tiled, a chunk of {tiles} tiles",
               "max_abs_err": float((out.float() - ref.float()).abs().max()), "tolerance": A.bf16_parity_bar(ref),
               "library_max_abs_err": float((lib.float() - ref.float()).abs().max()),
               "ms": time_ms(torch, lambda: W.window_attention_kernel(qkv, table, heads, shift, (gh, gw))),
               "plain_ms": time_ms(torch, lambda: W.window_attention_reference(qkv, table, heads, shift, (gh, gw)),
                                   groups=10, calls=2),
               "library_ms": time_ms(torch, library, groups=10, calls=3),
               "library": "F.scaled_dot_product_attention, the bias and the mask as one float mask",
               "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes"}
        print(json.dumps(row), flush=True)
        check(row["max_abs_err"] <= row["tolerance"], f"window attention: {row}")
        rows.append(row)
        del ref, out, mask, lib
    del qkv, q, k, v
    torch.cuda.empty_cache()

    engine = RestorationEngine(device="cuda")
    canvas = np.zeros((WINDOW_ATTENTION_CANVAS, WINDOW_ATTENTION_CANVAS, 3), np.uint8)
    engine.sr_tiled(canvas, WINDOW_ATTENTION_FAMILY)  # builds the graph
    torch.cuda.reset_peak_memory_stats()
    before = W.window_attention_kernel.launches
    before_norm = swin_add_norm_kernel.launches
    before_mlp = swin_mlp_kernel.launches
    t = time.perf_counter()
    engine.sr_tiled(canvas, WINDOW_ATTENTION_FAMILY)
    call = {"family": WINDOW_ATTENTION_FAMILY, "canvas": WINDOW_ATTENTION_CANVAS,
            "launches": W.window_attention_kernel.launches - before, "wall_ms": 1e3 * (time.perf_counter() - t),
            "swin_add_norm_launches": swin_add_norm_kernel.launches - before_norm,
            "swin_mlp_launches": swin_mlp_kernel.launches - before_mlp,
            "memory_peak_bytes": torch.cuda.max_memory_allocated()}
    print(json.dumps({"window_attention_sr_tiled": call}), flush=True)
    check(call["launches"] == 36 * 11, f"window attention launches in one {WINDOW_ATTENTION_CANVAS} sr_tiled call: {call}")
    check(call["swin_add_norm_launches"] == 2 * 36 * 11,
          f"add-norm launches in one {WINDOW_ATTENTION_CANVAS} sr_tiled call: {call}")
    check(call["swin_mlp_launches"] == 36 * 11, f"MLP launches in one {WINDOW_ATTENTION_CANVAS} sr_tiled call: {call}")
    del engine
    torch.cuda.empty_cache()
    for row in rows:
        row["launches"] = call["launches"]
    report["window_attention_checks"] = rows
    report["window_attention_sr_tiled"] = call
    return rows


def phase_swin_add_norm(torch, report):
    """The add-norm kernel at SwinIR-M's chunk, each form at shift 0 and 4:
    against its plain version (the sums bit for bit, the LayerNorm within
    one bf16 ulp at no less than 2^-8), timed beside its byte bound (each
    bf16 tensor read or written once, and the affine), the plain version
    (a gather and F.layer_norm) and, as the yardstick, the PyTorch chain it
    replaces in the Swin layer (add, F.layer_norm, torch.roll, the window
    partition's copy; or the reverse's copy, the roll back, the add and
    F.layer_norm)."""
    from image_restoration_platform_tpu_torch.ops.cuda import swin_add_norm as S
    from image_restoration_platform_tpu_torch.utils.peaks import HBM_BYTES_PER_S

    F = torch.nn.functional
    n, h, w, c = SWIN_ADD_NORM_SHAPE
    eps, ws = 1e-5, S.KERNEL_WINDOW
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = (torch.randn((n, h, w, c), generator=gen, device="cuda") + 0.3).to(torch.bfloat16)
    a = (0.5 * torch.randn((n, h, w, c), generator=gen, device="cuda")).to(torch.bfloat16)
    weight = (1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")).to(torch.bfloat16)
    bias = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(torch.bfloat16)
    p = a.view(-1, ws * ws, c)  # a window-layout operand of the same bytes

    def partition(y):
        return y.view(n, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)

    def chain(form, shift):
        if form == "from_windows":
            y = p.view(n, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(n, h, w, c)
            if shift:
                y = torch.roll(y, shifts=(shift, shift), dims=(1, 2))
            s = x + y
            return s, F.layer_norm(s, (c,), weight, bias, eps)
        s = x + a if form == "to_windows" else x
        y = F.layer_norm(s, (c,), weight, bias, eps)
        if shift:
            y = torch.roll(y, shifts=(-shift, -shift), dims=(1, 2))
        return s, partition(y)

    rows = []
    for form in SWIN_ADD_NORM_FORMS:
        for shift in (0, 4):
            if form == "from_windows":
                def kernel():
                    return S.swin_add_norm_kernel("from_windows", x, p, weight, bias, eps, shift)

                def plain():
                    return S.add_norm_from_windows_reference(x, p, weight, bias, eps, shift, ws)
            else:
                operand = a if form == "to_windows" else None

                def kernel():
                    return S.swin_add_norm_kernel("to_windows", x, operand, weight, bias, eps, shift)

                def plain():
                    return S.add_norm_to_windows_reference(x, operand, weight, bias, eps, shift, ws)
            (gs, gy), (ps, py), (cs, cy) = kernel(), plain(), chain(form, shift)
            torch.cuda.synchronize()
            ulp = torch.exp2(torch.floor(torch.log2(py.float().abs().clamp_min(2.0**-8))) - 7)
            over = (gy.float() - py.float()).abs() / ulp
            tensors = 2 if form == "to_windows_no_add" else 4
            nbytes = tensors * n * h * w * c * 2 + 2 * c * 2
            row = {"kernel": "swin_add_norm", "form": form, "shift": shift, "shape": list(SWIN_ADD_NORM_SHAPE),
                   "dtype": "bfloat16", "path": f"{WINDOW_ATTENTION_FAMILY} sr_tiled, a chunk of {n} tiles",
                   "sums_equal": bool(torch.equal(gs, ps)), "max_norm_err_ulps": float(over.max()),
                   "norm_unequal_share": float((gy != py).float().mean()),
                   "max_abs_err": float((gy.float() - py.float()).abs().max()),
                   "chain_equal": bool(torch.equal(cs, ps) and torch.equal(cy, py)),
                   "ms": time_ms(torch, kernel), "plain_ms": time_ms(torch, plain, groups=10, calls=3),
                   "library_ms": time_ms(torch, lambda: chain(form, shift), groups=10, calls=3),
                   "library": "the PyTorch chain it replaces (add, F.layer_norm, torch.roll, the window copies)",
                   "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes"}
            row["bound_share"] = row["bound_ms"] / row["ms"]
            print(json.dumps(row), flush=True)
            check(row["sums_equal"] and row["max_norm_err_ulps"] <= 1.0, f"add-norm: {row}")
            rows.append(row)
            del gs, gy, ps, py, cs, cy, over, ulp
    del x, a, p
    torch.cuda.empty_cache()
    report["swin_add_norm_checks"] = rows
    return rows


def phase_swin_mlp(torch, report):
    """The MLP kernel at SwinIR-M's chunk, [524288, 180] -> 360 -> 180
    bf16: against its plain version (``parity_bar`` with one hidden ulp) and
    the chain it replaces (three), timed beside its bound (the larger of the
    operations at the bf16 peak and the bytes, x and m once and the weights
    once, at the memory rate), the plain version and, as the yardstick, the
    PyTorch chain it replaces in the Swin layer (``F.linear``, ``F.gelu``,
    ``F.linear``). The weights are laid out once, outside the timing."""
    from image_restoration_platform_tpu_torch.ops.cuda import swin_mlp as M
    from image_restoration_platform_tpu_torch.utils.peaks import HBM_BYTES_PER_S, PEAK_FLOPS

    F = torch.nn.functional
    rows, c, hidden = SWIN_MLP_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((rows, c), generator=gen, device="cuda").to(torch.bfloat16)
    w1 = (0.08 * torch.randn((c, hidden), generator=gen, device="cuda")).to(torch.bfloat16)
    b1 = (0.1 * torch.randn(hidden, generator=gen, device="cuda")).to(torch.bfloat16)
    w2 = (0.06 * torch.randn((hidden, c), generator=gen, device="cuda")).to(torch.bfloat16)
    b2 = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(torch.bfloat16)
    wpack, bias = M.pack_weights(w1, b1, w2, b2)

    def kernel():
        return M.swin_mlp_kernel(x, wpack, bias)

    def plain():
        return M.swin_mlp_reference(x, w1, b1, w2, b2)

    def chain():
        return F.linear(F.gelu(F.linear(x, w1.t(), b1)), w2.t(), b2)

    got, ref, lib = kernel(), plain(), chain()
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs()
    flops = 4 * rows * c * hidden
    nbytes = 2 * rows * c * 2 + 2 * c * hidden * 2 + (c + hidden) * 2
    t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"], nbytes / HBM_BYTES_PER_S
    row = {"kernel": "swin_mlp", "shape": list(SWIN_MLP_SHAPE), "dtype": "bfloat16",
           "path": f"{WINDOW_ATTENTION_FAMILY} sr_tiled, a chunk of 8 tiles",
           "max_abs_err": float(err.max()), "unequal_share": float((got != ref).float().mean()),
           "within_bar": bool((err <= M.parity_bar(x, w1, b1, w2, b2)).all()),
           "chain_max_abs_err": float((got.float() - lib.float()).abs().max()),
           "chain_within_bar": bool(((got.float() - lib.float()).abs() <= M.parity_bar(x, w1, b1, w2, b2, chain=True)).all()),
           "ms": time_ms(torch, kernel), "plain_ms": time_ms(torch, plain, groups=10, calls=3),
           "library_ms": time_ms(torch, chain, groups=10, calls=3),
           "library": "the PyTorch chain it replaces (F.linear, F.gelu, F.linear)",
           "bound_ms": 1e3 * max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    row["bound_share"] = row["bound_ms"] / row["ms"]
    print(json.dumps(row), flush=True)
    check(row["within_bar"] and row["chain_within_bar"], f"swin MLP: {row}")
    del x, got, ref, lib, err
    torch.cuda.empty_cache()
    report["swin_mlp_checks"] = [row]
    return [row]


def phase_blend_kernel(torch, report):
    from image_restoration_platform_tpu_torch.ops import tile as T
    from image_restoration_platform_tpu_torch.ops.cuda import blend as B

    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for hw, tile, overlap, scale, where in BLEND_SHAPES:
        ys, xs = T.tile_grid(hw[0], tile, tile - overlap), T.tile_grid(hw[1], tile, tile - overlap)
        t = tile * scale
        tiles = torch.rand((len(ys) * len(xs), t, t, 3), generator=gen, device="cuda") * 255.0
        out_hw = (hw[0] * scale, hw[1] * scale)
        out_ys, out_xs = tuple(y * scale for y in ys), tuple(x * scale for x in xs)
        ref = T.blend_tiles(tiles, out_hw, out_ys, out_xs)
        bound, bound_by = blend_bound_ms(tiles.shape[0], t, 3, *out_hw)
        chosen = B.kernel_variant(t, 3, out_hw[1], out_xs)
        # the variant the wrapper chooses first, then the scalar one where it chose the vector one
        by_variant = {}
        for variant in dict.fromkeys((chosen, "scalar")):
            out = B.blend_kernel(tiles, out_hw, out_ys, out_xs, variant=variant)
            torch.cuda.synchronize()
            check(tuple(out.shape) == (*out_hw, 3) and bool(torch.isfinite(out).all()),
                  f"blend {where} {variant}: output")
            by_variant[variant] = {
                "max_abs_err": float((out - ref).abs().max()),
                "ms": time_ms(torch, lambda: B.blend_kernel(tiles, out_hw, out_ys, out_xs, variant=variant)),
            }
        row = {
            "kernel": "blend_tiles", "variant": chosen, "canvas": list(hw), "tile": tile, "overlap": overlap,
            "scale": scale, "tiles": tiles.shape[0], "path": where,
            "max_abs_err": max(v["max_abs_err"] for v in by_variant.values()),
            "tolerance": BLEND_ATOL, "ms": by_variant[chosen]["ms"], "by_variant": by_variant,
            "plain_ms": time_ms(torch, lambda: T.blend_tiles(tiles, out_hw, out_ys, out_xs), groups=10, calls=1),
            "library_ms": None, "bound_ms": bound, "bound_by": bound_by,
        }
        if (hw, tile, overlap, scale) == BLEND_MAIN:
            # the library yardstick: F.fold computes the same overlap-add
            # where the grid is uniform, as it is here (stride 448 divides
            # 4096 - 512). The summed window depends on the grid alone and is
            # folded once outside the timing, like the kernel's window table;
            # windowing, layout, fold and divide are timed. Nothing in the
            # port calls fold.
            stride = (tile - overlap) * scale
            check(out_ys == tuple(range(0, out_hw[0] - t + 1, stride)), "fold needs a uniform grid")
            window = torch.from_numpy(T._hann_window(t)).cuda()
            wsum = F.fold(window.reshape(1, t * t, 1).expand(1, t * t, tiles.shape[0]), out_hw,
                          kernel_size=t, stride=stride)[0]

            def fold():
                cols = (tiles * window[None, :, :, None]).permute(3, 1, 2, 0).reshape(1, 3 * t * t, -1)
                return (F.fold(cols, out_hw, kernel_size=t, stride=stride)[0] / wsum).permute(1, 2, 0)

            row["library_max_abs_err"] = float((fold() - ref).abs().max())
            check(row["library_max_abs_err"] <= BLEND_ATOL, f"F.fold disagrees with the plain fold: {row}")
            row["library_ms"] = time_ms(torch, fold, groups=10, calls=3)
        elif (hw, tile, overlap, scale) == BLEND_CLAMPED:
            # 25 tiles -> 2048 x 2048: the last tile of each axis is clamped
            # (origins 0, 448, 896, 1344, 1536), so no single fold stride
            # fits; the library yardstick is index_add_ of the windowed tiles
            # into the flat canvas, then the divide. The flat indices and the
            # summed window depend on the grid alone and are made once
            # outside the timing; windowing, scatter-add and divide are timed.
            r = torch.arange(t, device="cuda")
            tile_rows = torch.tensor(out_ys, device="cuda")[:, None] + r  # [ny, t]
            tile_cols = torch.tensor(out_xs, device="cuda")[:, None] + r  # [nx, t]
            flat = tile_rows[:, None, :, None] * out_hw[1] + tile_cols[None, :, None, :]  # [ny, nx, t, t]
            idx = (flat.reshape(-1, t, t, 1) * 3 + torch.arange(3, device="cuda")).reshape(-1)
            window = torch.from_numpy(T._hann_window(t)).cuda()
            wins = window[None, :, :, None].expand(tiles.shape[0], t, t, 3).reshape(-1)
            wsum = torch.zeros(out_hw[0] * out_hw[1] * 3, device="cuda").index_add_(0, idx, wins)

            def scatter():
                acc = torch.zeros(out_hw[0] * out_hw[1] * 3, device="cuda")
                acc.index_add_(0, idx, (tiles * window[None, :, :, None]).reshape(-1))
                return (acc / wsum).reshape(*out_hw, 3)

            row["library_max_abs_err"] = float((scatter() - ref).abs().max())
            check(row["library_max_abs_err"] <= BLEND_ATOL, f"index_add_ disagrees with the plain fold: {row}")
            row["library_ms"] = time_ms(torch, scatter, groups=10, calls=3)
            del idx, wins, wsum
        print(json.dumps(row), flush=True)
        check(row["max_abs_err"] <= BLEND_ATOL, f"blend kernel {where}: {row}")
        rows.append(row)
        del tiles, out, ref
    torch.cuda.empty_cache()
    seen = {variant for r in rows for variant in r["by_variant"]}
    check(seen == set(B.VARIANTS), f"blend variants checked {sorted(seen)}, the wrapper has {sorted(B.VARIANTS)}")
    report["blend_checks"] = rows
    return rows


def phase_kernels(torch, report):
    from image_restoration_platform_tpu_torch.ops.cuda import attention as A

    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(0)
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = sm_clock_hz(torch)
    print(json.dumps({"sm_count": sm_count, "sm_clock_mhz": clock_hz / 1e6}), flush=True)
    rows = []
    for shape, dtype, where in KERNEL_SHAPES:
        dt = getattr(torch, dtype)
        plan = A.launch_plan(shape, dt, sm_count)
        base = [torch.randn(shape, generator=gen, device="cuda").to(dt) for _ in range(3)]
        checks = {}
        for inputs, (q_scale, v_scale) in INPUT_SCALES.items():
            q, k, v = base[0] * q_scale, base[1], base[2] * v_scale
            out = A.flash_kernel(q, k, v)
            ref = A.attention_reference(q, k, v)
            err = float((out.float() - ref.float()).abs().max())
            tol = A.bf16_parity_bar(ref) if dt == torch.bfloat16 else F32_ATOL
            checks[inputs] = {"max_abs_err": err, "tolerance": tol, "max_abs_plain": float(ref.float().abs().max())}
        q, k, v = base
        bound, bound_by = attention_bound_ms(shape, dtype)
        row = {
            "kernel": "flash_attention", "variant": plan.variant, "shape": list(shape), "dtype": dtype,
            "path": where, "plan": dataclasses.asdict(plan), "schedule": plan.schedule,
            "max_abs_err": max(c["max_abs_err"] for c in checks.values()), "checks": checks,
            "ms": time_ms(torch, lambda: A.flash_kernel(q, k, v)),
            "plain_ms": time_ms(torch, lambda: A.attention_reference(q, k, v)),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v)),
            "bound_ms": bound, "bound_by": bound_by, "exp_ms": attention_exp_ms(shape, sm_count, clock_hz),
        }
        print(json.dumps(row), flush=True)
        for inputs, c in checks.items():
            check(c["max_abs_err"] <= c["tolerance"], f"flash attention {shape} {dtype} {inputs}: {c}")
        rows.append(row)
    seen = {r["variant"] for r in rows}
    check(seen == set(ATTENTION_VARIANTS) == set(A.VARIANTS),
          f"attention variants checked {sorted(seen)}, the wrapper has {sorted(A.VARIANTS)}")

    forced = []
    for shape, consumers, full_heads, splits, clusters in FORCED_PLANS:
        n, h, t, d = shape
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
        q, v = q * INPUT_SCALES["peaked"][0], v * INPUT_SCALES["peaked"][1]
        ref = A.attention_reference(q, k, v)
        plan = A.wgmma_plan(n * h, t, consumers, full_heads, d=d, splits=splits, clusters=clusters)
        out = A.flash_kernel(q, k, v, plan=plan)
        row = {"kernel": "flash_attention", "variant": plan.variant, "shape": list(shape), "schedule": plan.schedule,
               "grid": list(plan.grid), "units": plan.units, "splits": plan.splits, "full_heads": plan.full_heads,
               "max_abs_err": float((out.float() - ref.float()).abs().max()), "tolerance": A.bf16_parity_bar(ref)}
        print(json.dumps(row), flush=True)
        check(row["max_abs_err"] <= row["tolerance"], f"flash attention, forced plan: {row}")
        forced.append(row)
    check({r["schedule"] for r in forced} == {"grid", "persistent", "split"}, "a schedule of the wgmma kernel is not forced")
    # gradients at the training shape: FlashAttention (the kernel's forward,
    # the plain backward) against autograd through the plain forward
    q, k, v = (torch.randn(GRAD_SHAPE, generator=gen, device="cuda").to(torch.bfloat16).requires_grad_()
               for _ in range(3))
    dout = torch.randn(GRAD_SHAPE, generator=gen, device="cuda").to(torch.bfloat16)
    got = torch.autograd.grad(A.flash_attention(q, k, v), (q, k, v), dout)
    want = torch.autograd.grad(A.attention_reference(q, k, v), (q, k, v), dout)
    grads = {"kernel": "flash_attention", "check": "gradients", "shape": list(GRAD_SHAPE), "dtype": "bfloat16"}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        grads[name] = {"max_abs_err": float((a.float() - b.float()).abs().max()), "tolerance": A.bf16_parity_bar(b),
                       "max_abs_plain": float(b.float().abs().max())}
    print(json.dumps(grads), flush=True)
    for name in ("dq", "dk", "dv"):
        check(grads[name]["max_abs_err"] <= grads[name]["tolerance"], f"flash attention gradients: {grads}")
    report["kernel_checks"] = rows
    report["kernel_forced_plans"] = forced
    report["kernel_gradients"] = grads
    return rows


def phase_plan_sweep(torch, report):
    """The plans ``wgmma_candidates`` weighs (of its mixes of 192- and
    128-query units the model's best of each kind and the alike ones) and
    the alike-unit grids beside them, timed at every bf16 row of KERNEL_SHAPES that the wgmma
    kernel takes, each first held to the bf16 bar: the measurements that
    ``UNIT_COST_US`` is fitted to and the plan's choice is checked against.
    Prints one line a shape (ms and the model's microseconds a plan)."""
    from image_restoration_platform_tpu_torch.ops.cuda import attention as A

    gen = torch.Generator(device="cuda").manual_seed(2)
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    sweep = []
    for shape, dtype, where in KERNEL_SHAPES:
        n, h, t, d = shape
        if dtype != "bfloat16" or t % A.WGMMA_TILE_KEYS:
            continue
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
        ref = A.attention_reference(q, k, v)
        chosen = A.launch_plan(shape, torch.bfloat16, sm_count)
        weighed = A.wgmma_candidates(n * h, t, d, sm_count)
        # of the mixes of 192- and 128-query units, the model's best of each
        # (block, schedule, splits) and the alike ones
        best = {}
        for plan in weighed:
            key = (plan.block_q, plan.schedule, plan.splits)
            if key not in best or A.plan_us(plan, t, d, sm_count) < A.plan_us(best[key], t, d, sm_count):
                best[key] = plan
        plans = [p for p in weighed if p in best.values() or p.full_heads in (0, n * h)]
        for consumers, full in ((3, n * h), (3, 0), (1, n * h)):
            alike = [A.wgmma_plan(n * h, t, consumers, full, d=d)]
            if alike[0].units > sm_count:
                alike.append(A.wgmma_plan(n * h, t, consumers, full, d=d, clusters=sm_count))
            plans += [p for p in alike if p not in plans]
        rows = []
        for plan in plans:
            err = float((A.flash_kernel(q, k, v, plan=plan).float() - ref.float()).abs().max())
            check(err <= A.bf16_parity_bar(ref), f"flash attention {shape}, plan {plan}: max error {err}")
            rows.append({"variant": plan.variant, "schedule": plan.schedule, "full_heads": plan.full_heads,
                         "units": plan.units, "splits": plan.splits, "clusters": plan.clusters,
                         "stages": plan.stages, "chosen": plan == chosen, "weighed": plan in weighed,
                         "ms": time_ms(torch, lambda: A.flash_kernel(q, k, v, plan=plan), groups=10),
                         "model_us": A.plan_us(plan, t, d, sm_count)})
        line = {"plan_sweep": list(shape), "path": where, "plans": rows}
        print(json.dumps(line), flush=True)
        sweep.append(line)
    report["plan_sweep"] = sweep
    report["unit_cost_fit"] = fit_unit_costs(sweep, sm_count)
    print(json.dumps({"unit_cost_fit": report["unit_cost_fit"]}), flush=True)
    return sweep


def fit_unit_costs(sweep, sm_count: int = 132) -> dict:
    """Least squares of the plan model (ops/cuda/attention.py ``plan_us``:
    UNIT_COST_US, PERSISTENT_UNIT_US, SPLIT_COMBINE_US, and a launch L
    beside them) on every plan the sweep timed that the wrapper weighs, each
    residual relative to its measured time (scipy's least_squares from a
    start at 1 microsecond). Prints nothing; returns the fit and its
    residuals."""
    from unittest import mock

    import numpy as np
    from scipy.optimize import least_squares

    from image_restoration_platform_tpu_torch.ops.cuda import attention as A

    keys = [(w, d) for d in (64, 32) for w in (3, 2, 1)]
    cases = []
    for line in sweep:
        n, h, t, d = line["plan_sweep"]
        for p in line["plans"]:
            if not p["weighed"]:
                continue
            plan = A.wgmma_plan(n * h, t, int(p["variant"].split("q")[-1]) // 64, p["full_heads"], d=d,
                                splits=p["splits"], clusters=p["clusters"])
            cases.append((plan, t, d, 1e3 * p["ms"]))

    def costs(x):
        unit = {k: (x[3 + 2 * i], x[4 + 2 * i]) for i, k in enumerate(keys)}
        return unit, x[1], x[2]

    def residuals(x):
        # plan_us reads the module's costs: the trial values stand in for them here
        unit, persistent_us, split_us = costs(x)
        with mock.patch.multiple(A, UNIT_COST_US=unit, PERSISTENT_UNIT_US=persistent_us,
                                 SPLIT_COMBINE_US=split_us):
            return np.array([(x[0] + A.plan_us(plan, t, d, sm_count)) / us - 1.0 for plan, t, d, us in cases])

    fit = least_squares(residuals, np.ones(3 + 2 * len(keys)), bounds=(0.0, np.inf), diff_step=1e-3)
    unit, persistent_us, split_us = costs(fit.x)
    resid = residuals(fit.x)
    return {"launch_us": float(fit.x[0]), "PERSISTENT_UNIT_US": float(persistent_us),
            "SPLIT_COMBINE_US": float(split_us),
            "UNIT_COST_US": {f"{w},{d}": [float(a), float(b)] for (w, d), (a, b) in unit.items()},
            "relative_residual_rms": float(np.sqrt(np.mean(resid ** 2))),
            "relative_residual_max": float(np.abs(resid).max()), "plans": len(cases)}


def serving_warmup(torch, engine, card, report) -> dict:
    """``warmup_serving`` of GRAPH_WARM_FAMILIES at the engine's buckets
    (the defaults: 256, 512, 1024, batches 1-8, sr_tiled 2048): seconds,
    executables and graphs built, and device memory, the peak during it and
    what it leaves held."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    t = time.perf_counter()
    warm = engine.warmup_serving(families=GRAPH_WARM_FAMILIES)
    torch.cuda.synchronize()
    warmup = {"card": card, "seconds": time.perf_counter() - t, "surfaces": len(warm),
              "seconds_by_surface": warm, **engine.exec_stats(),
              "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
              "held_after_gib": (torch.cuda.memory_allocated() - held_before) / 2**30,
              "reserved_gib": torch.cuda.memory_reserved() / 2**30}
    print(json.dumps({"serving_warmup": {k: v for k, v in warmup.items() if k != "seconds_by_surface"}}),
          flush=True)
    report["serving_warmup"] = warmup
    return warmup


def phase_slice(torch, np, report, card):
    from image_restoration_platform_tpu_torch import imageio
    from image_restoration_platform_tpu_torch.config import ServingConfig
    from image_restoration_platform_tpu_torch.models.weights import weights_path
    from image_restoration_platform_tpu_torch.obs.metrics import get_counters
    from image_restoration_platform_tpu_torch.ops.cuda.attention import flash_kernel
    from image_restoration_platform_tpu_torch.ops.deblock import deblock_canvas_batch
    from image_restoration_platform_tpu_torch.ops.deblur import deblur_canvas_batch, motion_psf
    from image_restoration_platform_tpu_torch.serve import MicroBatcher, RestorationEngine, RestoratorService

    check(os.path.exists(weights_path("restore-unet")), "weights/restore-unet.npz missing")
    cfg = ServingConfig(size_buckets=(256, 512, 1024), max_batch=8)
    engine = RestorationEngine(device="cuda", dtype=torch.bfloat16, serving_config=cfg)
    batcher = MicroBatcher(engine, cfg, device="cuda")
    svc = RestoratorService(engine=engine, batcher=batcher, serving_config=cfg, device="cuda")
    reqs = build_requests(np, imageio, motion_psf)

    try:
        # every executable of the surfaces the phases drive is built here, none in a path
        warmup = serving_warmup(torch, engine, card, report)
        t = time.perf_counter()
        for name in ("clean256", "clean512"):
            check(svc.restore(reqs[name][0])["success"], f"warm-up {name} failed")
        report["warmup_s"] = time.perf_counter() - t
        check(engine.compile_count == warmup["compile_count"], "a warmed restore request built an executable")

        # --- the main path: counts from 0, concurrent requests, counts read after
        counters = get_counters()
        before = counters.snapshot()
        _zero_launches(flash_kernel)
        _zero_gn()
        with ThreadPoolExecutor(max_workers=len(reqs)) as pool:
            futures = {name: pool.submit(svc.restore, data) for name, (data, _) in reqs.items()}
            results = {name: f.result() for name, f in futures.items()}
        launches = _read_launches("flash_attention", flash_kernel)
        gn_launches = _read_gn("restore")
        after = counters.snapshot()
        delta = _counter_delta(before, after)
        forwards = int(delta.get("restore_batches.256", 0) + delta.get("restore_batches.512", 0))
        batches = int(sum(v for k, v in delta.items() if k.startswith("restore_batches.")))

        for name, res in results.items():
            check(res.get("success") is True, f"{name}: {res.get('error')}")
            scores = np.asarray([res["degradationAnalysis"][k] for k in sorted(res["degradationAnalysis"])])
            check(scores.shape == (7,) and np.isfinite(scores).all(), f"{name}: scores {scores}")
            src = imageio.decode_image(reqs[name][0])
            out = _decode_result(imageio, res)
            check((out.height, out.width) == (src.height, src.width), f"{name}: output {out.height}x{out.width}")
        check(forwards > 0 and launches == forwards,
              f"attention launches {launches} != UNet forwards at buckets <= 512 ({forwards})")
        check(engine.compile_count == warmup["compile_count"],
              f"the restore path built {engine.compile_count - warmup['compile_count']} executables after the warm-up")
        print(json.dumps({"slice": {"requests": len(results), "batches": batches, "forwards_le_512": forwards,
                                    "attention_launches": launches, "fused_norm_launches": gn_launches,
                                    "host_syncs": {k: v for k, v in delta.items() if k.startswith("host_sync")},
                                    "stage_fires": {k: v for k, v in delta.items() if k.startswith("stage_fires")},
                                    "egress": "yuv420" if imageio.native_available() else "rgb"}}),
              flush=True)

        # --- the stages fire where the inputs were built to make them fire
        fires = {}
        for name, (data, built_for) in reqs.items():
            dec = imageio.decode_image(data)
            canvas, (sh, sw), _ = svc._canonicalize(dec.pixels)
            c = torch.from_numpy(np.array(canvas[None])).cuda()
            valid = torch.tensor([[sh, sw]], dtype=torch.int32, device="cuda")
            _, fire_k = deblock_canvas_batch(c, valid)
            comp = torch.tensor([results[name]["degradationAnalysis"]["compression"]], device="cuda")
            fire_d = not torch.equal(deblur_canvas_batch(c, valid, comp), c)
            fires[name] = {"built_for": built_for, "deblock": bool(fire_k[0]), "deblur": fire_d}
            check(fires[name]["deblock"] == (built_for == "deblock"), f"{name}: deblock fire {fires[name]}")
            if built_for != "deblock":  # the deblur gate reads the deblocked canvas there
                check(fire_d == (built_for == "deblur"), f"{name}: deblur fire {fires[name]}")
        print(json.dumps({"fires": fires}), flush=True)

        # --- card bf16 vs the port's own CPU f32 run of the same 256 canvas
        dec = imageio.decode_image(reqs["jpeg256"][0])
        canvas, (sh, sw), _ = svc._canonicalize(dec.pixels)
        args = (canvas[None], np.asarray([[sh, sw]], np.int32), np.ones((1,), np.float32))
        out_gpu, s_gpu, _ = engine.restore_batch(*args)
        cpu_engine = RestorationEngine(device="cpu", dtype=torch.float32, serving_config=cfg)
        out_cpu, s_cpu, _ = cpu_engine.restore_batch(*args)
        diff = np.abs(out_gpu.astype(np.int32) - out_cpu.astype(np.int32))
        cmp = {"mean_levels": float(diff.mean()), "p99.9_levels": float(np.percentile(diff, 99.9)),
               "max_levels": int(diff.max()), "scores_max_abs": float(np.abs(s_gpu - s_cpu).max())}
        print(json.dumps({"card_bf16_vs_cpu_f32": cmp}), flush=True)
        check(cmp["mean_levels"] <= CPU_MEAN_LEVELS and cmp["p99.9_levels"] <= CPU_P999_LEVELS,
              f"card vs CPU output {cmp}")
        check(cmp["scores_max_abs"] <= CPU_SCORES_ATOL, f"card vs CPU scores {cmp}")

        report["slice"] = {"launches": launches, "forwards": forwards, "batches": batches,
                           "counters": delta, "fires": fires, "card_vs_cpu": cmp}
        sr_reqs, blend_launches = phase_sr(torch, np, report, svc, engine, cfg)
        diffusion_launches = phase_diffusion_fusion(np, report, svc, reqs)
        phase_throughput(torch, np, report, svc, engine, reqs, card)
        phase_sr_throughput(torch, np, report, svc, engine, sr_reqs, card)
    finally:
        batcher.shutdown()
    return {"flash_attention": {"restore": launches, "diffusion_fusion": diffusion_launches},
            "blend_tiles": {"super_resolution": blend_launches}}, engine


# launches of each kernel variant on the driven paths, summed over the paths
PATH_LAUNCHES_BY_VARIANT: dict = {"flash_attention": {}, "blend_tiles": {}, "gn_moments": {}, "gn_affine_silu": {}}


def _zero_launches(kernel) -> None:
    """Counts to 0 just before a path is driven."""
    kernel.launches = 0
    for variant in kernel.launches_by_variant:
        kernel.launches_by_variant[variant] = 0


def _read_launches(name: str, kernel) -> int:
    """The count just after a path was driven; its split by variant joins the totals."""
    total = PATH_LAUNCHES_BY_VARIANT[name]
    for variant, n in kernel.launches_by_variant.items():
        total[variant] = total.get(variant, 0) + n
    check(sum(kernel.launches_by_variant.values()) == kernel.launches, f"{name}: counts by variant disagree")
    return kernel.launches


# the fused GroupNorm kernels' launches on each UNet path, read by _read_gn
GN_PATH_LAUNCHES: dict = {"gn_moments": {}, "gn_affine_silu": {}}


def _gn_kernels() -> dict:
    from image_restoration_platform_tpu_torch.ops.cuda import group_norm as G

    return {"gn_moments": G.moments_kernel, "gn_affine_silu": G.affine_silu_kernel}


def _zero_gn() -> None:
    """The fused GroupNorm kernels' counts to 0 just before a UNet path."""
    for kernel in _gn_kernels().values():
        _zero_launches(kernel)


def _read_gn(path: str) -> dict:
    """Both fused GroupNorm kernels' counts just after a UNet path: each
    must have launched, and the count joins GN_PATH_LAUNCHES under ``path``."""
    counts = {name: _read_launches(name, kernel) for name, kernel in _gn_kernels().items()}
    for name, n in counts.items():
        GN_PATH_LAUNCHES[name][path] = GN_PATH_LAUNCHES[name].get(path, 0) + n
    check(all(n > 0 for n in counts.values()), f"{path}: a fused GroupNorm kernel was not launched: {counts}")
    return counts


def _counter_delta(before: dict, after: dict) -> dict:
    return {k: after.get(k, 0.0) - before.get(k, 0.0) for k in after if k not in ("uptime_s", "images_per_sec")}


def _decode_result(imageio, res):
    return imageio.decode_image(base64.b64decode(res["restoredImage"]))


def phase_sr(torch, np, report, svc, engine, cfg):
    """The super-resolution path through RestoratorService, its blend
    launches counted from 0, and the card's bf16 against the CPU's f32."""
    from image_restoration_platform_tpu_torch import imageio
    from image_restoration_platform_tpu_torch.models.weights import weights_path
    from image_restoration_platform_tpu_torch.obs.metrics import get_counters
    from image_restoration_platform_tpu_torch.ops.cuda.attention import flash_kernel
    from image_restoration_platform_tpu_torch.ops.cuda.blend import blend_kernel
    from image_restoration_platform_tpu_torch.serve import RestorationEngine

    for family in ("sr-x2", "sr-x4"):
        check(os.path.exists(weights_path(family)), f"weights/{family}.npz missing")
    # (encoded upload, family, expected output h x w, tiled?)
    sr_reqs = {
        "sr2048": (imageio.encode_png(_photo_large(np, 11, 2048, 2048)), "sr-x2", (4096, 4096), True),
        "sr1500x1100": (imageio.encode_png(_photo_large(np, 12, 1500, 1100)), "sr-x2", (3000, 2200), True),
        "sr384": (imageio.encode_png(_photo_large(np, 13, 384, 384)), "sr-x2", (768, 768), False),
        "sr4_300x200": (imageio.encode_jpeg(_photo_large(np, 14, 300, 200), quality=90), "sr-x4", (1200, 800), False),
    }
    t = time.perf_counter()
    check(svc.restore(sr_reqs["sr384"][0], options={"model": "sr-x2"})["success"], "SR warm-up failed")
    warm = svc.restore(sr_reqs["sr2048"][0], options={"model": "sr-x2"})  # model load, cuDNN plans, kernel bind
    check(warm["success"], f"tiled SR warm-up failed: {warm.get('error')}")
    report["sr_warmup_s"] = time.perf_counter() - t

    counters = get_counters()
    before = counters.snapshot()
    _zero_launches(blend_kernel)
    _zero_launches(flash_kernel)
    results = {name: svc.restore(data, options={"model": family}) for name, (data, family, _, _) in sr_reqs.items()}
    canvas2048 = imageio.decode_image(sr_reqs["sr2048"][0]).pixels
    (py, pcb, pcr), meta = engine.sr_tiled(canvas2048, "sr-x2", output="yuv420")
    blend_launches = _read_launches("blend_tiles", blend_kernel)
    attn_launches = _read_launches("flash_attention", flash_kernel)
    delta = _counter_delta(before, counters.snapshot())
    tiled_calls = int(sum(v for k, v in delta.items() if k.startswith("sr_tiled_calls.")))
    direct_calls = int(sum(v for k, v in delta.items() if k.startswith("sr_batches.")))

    for name, res in results.items():
        _, family, out_hw, _ = sr_reqs[name]
        check(res.get("success") is True, f"{name}: {res.get('error')}")
        out = _decode_result(imageio, res)
        check((out.height, out.width) == out_hw, f"{name}: output {out.height}x{out.width}, expected {out_hw}")
        md = res["metadata"]
        check(md["scaleFactor"] == int(family[-1]) and md["outputSize"] == list(out_hw) and md["model"] == family,
              f"{name}: metadata {md}")
        check(res["degradationAnalysis"] == {} and md["classificationIssues"] == [], f"{name}: analysis not empty")
        # the output is the input, larger: its box-downsample stays near the upload
        src = imageio.decode_image(sr_reqs[name][0]).pixels.astype(np.float32)
        s = int(family[-1])
        down = out.pixels.astype(np.float32).reshape(src.shape[0], s, src.shape[1], s, 3).mean(axis=(1, 3))
        err = float(np.abs(down - src).mean())
        check(err < 10.0, f"{name}: box-downsampled output is {err:.2f} levels from the upload")
        results[name] = {"sizeBucket": md["sizeBucket"], "deviceSeconds": md["deviceSeconds"],
                         "total_ms": res["timings"]["total_ms"], "downsample_mean_abs_levels": err}
    check(results["sr2048"]["sizeBucket"] == 2048 and results["sr1500x1100"]["sizeBucket"] == 2048,
          f"tiled requests took buckets {results}")
    check(py.shape == (4096, 4096) and pcb.shape == pcr.shape == (2048, 2048) and py.dtype == np.uint8,
          f"sr_tiled yuv420 planes {py.shape} {pcb.shape} {pcr.shape}")
    check(tiled_calls == 3 and direct_calls == 2, f"SR calls: tiled {tiled_calls}, direct {direct_calls}")
    check(blend_launches == tiled_calls, f"blend launches {blend_launches} != sr_tiled calls {tiled_calls}")
    check(attn_launches == 0, f"the SR path launched attention {attn_launches} times")
    # planes against the RGB request's JPEG: same image through two egresses
    rgb = _decode_result(imageio, svc.restore(sr_reqs["sr2048"][0], options={"model": "sr-x2"})).pixels
    luma = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    plane_err = float(np.abs(py.astype(np.float32) - luma).mean())
    check(plane_err < 3.0, f"yuv420 luma is {plane_err:.2f} levels from the RGB request's JPEG")
    print(json.dumps({"sr_slice": {"requests": results, "sr_tiled_calls": tiled_calls, "sr_batch_calls": direct_calls,
                                   "blend_launches": blend_launches, "attention_launches": attn_launches,
                                   "yuv420_vs_rgb_jpeg_luma_levels": plane_err,
                                   "egress": "yuv420" if imageio.native_available() else "rgb"}}), flush=True)

    # --- card bf16 vs the port's own CPU f32 run of a 640 canvas (3 x 3 tiles)
    canvas = _photo_large(np, 15, 640, 640)
    out_gpu, _ = engine.sr_tiled(canvas, "sr-x2")
    cpu_engine = RestorationEngine(device="cpu", dtype=torch.float32, serving_config=cfg)
    out_cpu, _ = cpu_engine.sr_tiled(canvas, "sr-x2")
    diff = np.abs(out_gpu.astype(np.int32) - out_cpu.astype(np.int32))
    cmp = {"mean_levels": float(diff.mean()), "p99.9_levels": float(np.percentile(diff, 99.9)),
           "max_levels": int(diff.max())}
    print(json.dumps({"sr_card_bf16_vs_cpu_f32": cmp}), flush=True)
    check(out_gpu.shape == (1280, 1280, 3), f"640 canvas output {out_gpu.shape}")
    check(cmp["mean_levels"] <= CPU_MEAN_LEVELS and cmp["p99.9_levels"] <= CPU_P999_LEVELS,
          f"SR card vs CPU output {cmp}")
    report["sr_slice"] = {"requests": results, "blend_launches": blend_launches, "sr_tiled_calls": tiled_calls,
                          "counters": delta, "card_vs_cpu": cmp}
    return sr_reqs, blend_launches


def phase_diffusion_fusion(np, report, svc, reqs):
    """diffusion-restore at 256 (attention over T = 4096, once per sampler
    step) and 512 (T = 16384: skipped), and a three-capture fusion at 512."""
    from image_restoration_platform_tpu_torch import imageio
    from image_restoration_platform_tpu_torch.models import get_family
    from image_restoration_platform_tpu_torch.models.weights import weights_path
    from image_restoration_platform_tpu_torch.obs.metrics import get_counters
    from image_restoration_platform_tpu_torch.ops.cuda.attention import flash_kernel

    check(os.path.exists(weights_path("diffusion-restore")), "weights/diffusion-restore.npz missing")
    steps = get_family("diffusion-restore").config.sample_steps
    fusion_images = [reqs["clean512"][0], reqs["jpeg512"][0], reqs["blur512"][0]]
    options = {"model": "diffusion-restore"}
    check(svc.restore(reqs["clean256"][0], options=options)["success"], "diffusion warm-up failed")

    counters = get_counters()
    before = counters.snapshot()
    _zero_launches(flash_kernel)
    _zero_gn()
    d256 = svc.restore(reqs["jpeg256"][0], options=options)
    after256 = flash_kernel.launches
    d512 = svc.restore(reqs["clean512"][0], options=options)
    after512 = flash_kernel.launches
    gn_launches = {"diffusion": _read_gn("diffusion")}
    _zero_gn()
    fused = svc.restore_fusion(fusion_images, "fuse these captures")
    launches = _read_launches("flash_attention", flash_kernel)
    gn_launches["fusion"] = _read_gn("fusion")
    delta = _counter_delta(before, counters.snapshot())

    for name, res, src in (("diffusion256", d256, reqs["jpeg256"][0]), ("diffusion512", d512, reqs["clean512"][0]),
                           ("fusion512", fused, fusion_images[0])):
        check(res.get("success") is True, f"{name}: {res.get('error')}")
        scores = np.asarray([res["degradationAnalysis"][k] for k in sorted(res["degradationAnalysis"])])
        check(scores.shape == (7,) and np.isfinite(scores).all(), f"{name}: scores {scores}")
        want, out = imageio.decode_image(src), _decode_result(imageio, res)
        check((out.height, out.width) == (want.height, want.width), f"{name}: output {out.height}x{out.width}")
        err = float(np.abs(out.pixels.astype(np.float32) - want.pixels.astype(np.float32)).mean())
        check(err < 40.0, f"{name}: output is {err:.1f} levels from its input")
    check(d256["metadata"]["model"] == "diffusion-restore" and d256["metadata"]["sizeBucket"] == 256, "diffusion meta")
    check(fused["metadata"]["fusionInputs"] == 3 and len(fused["metadata"]["perImageAnalysis"]) == 3
          and fused["metadata"]["sizeBucket"] == 512, f"fusion metadata {fused['metadata']}")
    check(delta.get("diffusion_batches.256") == 1 and delta.get("diffusion_batches.512") == 1
          and delta.get("fusion_batches.512") == 1, f"batches {delta}")
    check(after256 == steps == 2, f"256 diffusion batch: {after256} attention launches, {steps} sampler steps")
    check(after512 == after256, f"512 diffusion batch launched attention {after512 - after256} times")
    check(launches == after512 + 1, f"fusion of three 512 captures: {launches - after512} attention launches")
    out = {"attention_launches": {"diffusion256": after256, "diffusion512": after512 - after256,
                                  "fusion512_k3": launches - after512},
           "fused_norm_launches": gn_launches, "sampler_steps": steps,
           "ms": {"diffusion256": d256["timings"]["total_ms"], "diffusion512": d512["timings"]["total_ms"],
                  "fusion512_k3": fused["timings"]["total_ms"]}}
    print(json.dumps({"diffusion_fusion_slice": out}), flush=True)
    report["diffusion_fusion_slice"] = {**out, "counters": delta}
    return launches


def _service_uploads(np, imageio, ctx, preprocess):
    """The service phase's jobs: (kind, [(filename, bytes)], options, sync).
    Each upload's JPEG quality is the first from 85 down whose preprocessed
    JPEG the deterministic mock moderation passes (it rejects by the
    re-encoded size), so every job reaches the restorator."""
    u8 = lambda x: np.clip(np.round(x * 255.0), 0, 255).astype(np.uint8)  # noqa: E731

    def passing(pixels, name):
        for quality in range(85, 60, -1):
            data = imageio.encode_jpeg(pixels, quality=quality)
            if ctx.moderation.moderate(preprocess(data, ctx)[1], {"userId": "smoke-precheck"})["allowed"]:
                return (name, data)
        fail(f"no JPEG quality of {name} passes the mock moderation")

    photos = {size: [u8(_photo(np, 40 + i, size)) for i in range(4)] for size in (256, 512)}
    jobs = []
    for i in range(SERVICE_JOBS_PER_BUCKET):
        for size in (256, 512):
            jobs.append((f"{size}", [passing(photos[size][i % 4], f"p{size}_{i}.jpg")], {}, False))
    for i in range(SERVICE_SYNC_JOBS):
        size = (256, 512)[i % 2]
        jobs.append((f"{size}_sync", [passing(np.ascontiguousarray(photos[size][i % 4][::-1]), f"s{i}.jpg")], {}, True))
    jobs.append(("3000x2000", [passing(_photo_large(np, 21, 2000, 3000), "big.jpg")], {}, False))
    jobs.append(("fusion512", [passing(photos[512][i], f"f{i}.jpg") for i in range(3)], {}, False))
    jobs.append(("sr-x2_1024x768", [passing(_photo_large(np, 22, 768, 1024), "sr.jpg")], {"model": "sr-x2"}, False))
    return jobs


def phase_service_graph(torch, np, report, card):
    """The HTTP service's graph on the card, below the HTTP layer (the card's
    machine has no aiohttp): AppContext with the batcher and two queue
    workers, warmed at 256 and 512, then jobs through the aiohttp-free
    submission path, with the kernels' counts set to 0 before and read after;
    then the HDR pre-pass, the classifier and the resize on the card against
    the CPU, and the restorator's health status."""
    from image_restoration_platform_tpu_torch import imageio
    from image_restoration_platform_tpu_torch.api import AppContext
    from image_restoration_platform_tpu_torch.api.submit import preprocess, submit_job
    from image_restoration_platform_tpu_torch.classify import ClassifierService
    from image_restoration_platform_tpu_torch.config import Config, ServingConfig
    from image_restoration_platform_tpu_torch.obs.metrics import get_counters
    from image_restoration_platform_tpu_torch.ops.cuda.attention import flash_kernel
    from image_restoration_platform_tpu_torch.ops.cuda.blend import blend_kernel
    from image_restoration_platform_tpu_torch.ops.deblur import disk_psf
    from image_restoration_platform_tpu_torch.ops.resize import fit_inside, resize_u8
    from image_restoration_platform_tpu_torch.serve import RestorationEngine
    from image_restoration_platform_tpu_torch.serve.jobs import JobState

    config = Config()
    config.serving = ServingConfig(size_buckets=(256, 512, 1024), max_batch=8)
    ctx = AppContext(config=config, queue_workers=2, device="cuda")
    try:
        t = time.perf_counter()
        # every surface the jobs take, so no job builds an executable (a build's
        # warm-up pass would add its own launches to the path's counts)
        warm = ctx.engine.warmup_serving(families=("restore-unet", "fusion", "sr-x2"), sizes=(256, 512),
                                         sr_tiled_canvas=1024)
        out = {"card": card, "warmup_s": time.perf_counter() - t, "warmup_surfaces_s": warm}
        print(json.dumps({"service_warmup": out}), flush=True)
        jobs = _service_uploads(np, imageio, ctx, preprocess)
        ctx.user_store.grant("smoke", 1000)

        # --- the path: counts from 0, every job submitted, counts read after
        counters = get_counters()
        before = counters.snapshot()
        _zero_launches(flash_kernel)
        _zero_launches(blend_kernel)
        _zero_gn()

        def submit(index):
            kind, images, options, sync = jobs[index]
            t_submit = time.time()
            status, body, _ = submit_job(ctx, {"id": "smoke"}, images, None, options,
                                         f"smoke-{index}", None, sync)
            return index, t_submit, time.time(), status, body

        with ThreadPoolExecutor(max_workers=8) as pool:
            submitted = list(pool.map(submit, range(len(jobs))))
        ids = {}
        for index, t_submit, t_return, status, body in submitted:
            sync = jobs[index][3]
            check(status == (200 if sync else 202), f"job {jobs[index][0]}: HTTP {status} {body}")
            ids[body["id"]] = (index, t_submit)
        deadline = time.time() + SERVICE_DEADLINE_S
        done = (JobState.SUCCEEDED, JobState.FAILED, JobState.DEAD_LETTER)
        while not all(ctx.jobs.get(j).state in done for j in ids) and time.time() < deadline:
            time.sleep(0.005)
        launches = {"flash_attention": _read_launches("flash_attention", flash_kernel),
                    "blend_tiles": _read_launches("blend_tiles", blend_kernel)}
        out["fused_norm_launches"] = _read_gn("service_graph")
        delta = _counter_delta(before, counters.snapshot())

        latency, by_kind, outside = [], {}, []
        for job_id, (index, t_submit) in ids.items():
            kind, images, options, _ = jobs[index]
            job = ctx.jobs.get(job_id)
            check(job.state is JobState.SUCCEEDED and job.attempts == 1,
                  f"job {kind}: {job.state.value} after {job.attempts} attempts: {job.error}")
            res = job.result
            check(res["success"] is True, f"job {kind}: {res.get('error')}")
            decoded = _decode_result(imageio, res)
            src = imageio.decode_image(images[0][1])
            h, w = src.height, src.width
            w, h = fit_inside(w, h, config.upload.max_dimension)
            scale = 2 if options.get("model") == "sr-x2" else 1
            check((decoded.height, decoded.width) == (h * scale, w * scale),
                  f"job {kind}: output {decoded.height}x{decoded.width}, expected {h * scale}x{w * scale}")
            latency.append(job.updated_at - t_submit)
            # submission (validate, preprocess, moderation, credits) and queueing
            outside.append(latency[-1] - res["timings"]["total_ms"] / 1e3)
            by_kind.setdefault(kind.split("_")[0], []).append(job.updated_at - t_submit)
        big = next(j for j, (i, _) in ids.items() if jobs[i][0] == "3000x2000")
        check("resize_2048x1365" in ctx.jobs.get(big).payload["preprocessOperations"][0],
              f"3000x2000 upload: {ctx.jobs.get(big).payload['preprocessOperations']}")
        charges = [e for e in ctx.ledger.entries() if e["jobId"] in ids and e["amount"] < 0]
        check(sorted(e["jobId"] for e in charges) == sorted(ids), f"{len(charges)} charges for {len(ids)} jobs")
        forwards = int(delta.get("restore_batches.256", 0) + delta.get("restore_batches.512", 0)
                       + delta.get("fusion_batches.512", 0))
        check(forwards > 0 and launches["flash_attention"] == forwards,
              f"attention launches {launches['flash_attention']} != UNet forwards at 256 and 512 ({forwards})")
        check(delta.get("sr_tiled_calls.1024") == 1 and launches["blend_tiles"] == 1,
              f"blend launches {launches['blend_tiles']}, sr_tiled calls {delta.get('sr_tiled_calls.1024')}")
        wall = max(j.updated_at for j in map(ctx.jobs.get, ids)) - min(t for _, t in ids.values())
        restores = sum(1 for kind, *_ in jobs if kind.split("_")[0] in ("256", "512"))
        q = lambda xs, p: 1e3 * float(np.percentile(xs, p))  # noqa: E731
        out.update({
            "jobs": len(ids), "jobs_per_s": len(ids) / wall, "wall_s": wall,
            "p50_ms": q(latency, 50), "p95_ms": q(latency, 95),
            "p50_ms_by_kind": {k: q(v, 50) for k, v in sorted(by_kind.items())},
            # the async submissions' burst (a sync submission returns with its result)
            "submit_burst_s": (max(t for i, _, t, _, _ in submitted if not jobs[i][3])
                               - min(t for _, t, _, _, _ in submitted)),
            "p50_ms_outside_restorator": q(outside, 50),
            "mean_batch_256_512": restores / max(1, delta.get("restore_batches.256", 0)
                                                 + delta.get("restore_batches.512", 0)),
            "launches": launches, "unet_forwards_le_512": forwards, "charges": len(charges),
            "batches": {k: v for k, v in delta.items() if k.endswith(("batches.256", "batches.512", "batches.1024"))
                        or k.startswith("sr_tiled_calls")},
        })
        print(json.dumps({"service_graph": out}), flush=True)

        # --- the HDR pre-pass on the card against the port's CPU run
        cpu_engine = RestorationEngine(device="cpu", dtype=torch.float32, serving_config=config.serving)
        hdr = {}
        for size in (256, 512):
            blurred = np.clip(_motion_blur(np, _cells(np, np.random.default_rng(2), size), disk_psf(HDR_RADIUS)), 0, 1)
            canvas = (np.round(blurred * 65535.0) / 65535.0).astype(np.float32)[None]
            args = (canvas, np.asarray([[size, size]], np.int32), np.zeros((1,), np.float32))
            card_out, _ = ctx.engine.hdr_deblur_batch(*args)
            cpu_out, _ = cpu_engine.hdr_deblur_batch(*args)
            times = []
            for _ in range(5):
                t = time.perf_counter()
                ctx.engine.hdr_deblur_batch(*args)
                times.append(time.perf_counter() - t)
            hdr[size] = {"fired_card": not np.array_equal(card_out, canvas),
                         "fired_cpu": not np.array_equal(cpu_out, canvas),
                         "max_abs_vs_cpu": float(np.abs(card_out - cpu_out).max()),
                         "ms": 1e3 * statistics.median(times)}
            check(hdr[size]["fired_card"] and hdr[size]["fired_cpu"], f"HDR pre-pass at {size}: {hdr[size]}")
            check(hdr[size]["max_abs_vs_cpu"] <= HDR_ATOL, f"HDR pre-pass at {size}: {hdr[size]}")

        # --- the classifier and the resize on the card against the CPU
        uploads = {kind: images[0][1] for kind, images, _, _ in jobs}
        cls_card, cls_cpu = ClassifierService(device="cuda"), ClassifierService(device="cpu")
        cls = 0.0
        for kind in ("256", "512", "3000x2000"):
            a, b = cls_card.analyze(uploads[kind]), cls_cpu.analyze(uploads[kind])
            cls = max(cls, max(abs(a[k] - b[k]) for k in a))
        check(cls <= CLASSIFY_ATOL, f"classifier card vs CPU: {cls}")
        big_px = imageio.decode_image(uploads["3000x2000"]).pixels
        card_r = resize_u8(big_px, (1365, 2048), device="cuda")
        diff = np.abs(card_r.cpu().numpy() - resize_u8(big_px, (1365, 2048), device="cpu").numpy())
        rs = {"max_levels": float(diff.max()), "exact_share": float((diff == 0).mean()),
              "ms": time_ms(torch, lambda: resize_u8(big_px, (1365, 2048), device="cuda"), groups=5, calls=3)}
        check(rs["max_levels"] <= 1.0 and rs["exact_share"] >= 0.999, f"resize_u8 card vs CPU: {rs}")
        health = ctx.restorator.get_health_status()
        check(health["healthy"] is True, f"health status {health}")
        checks = {"hdr_prepass": hdr, "classifier_max_abs_vs_cpu": cls, "resize_u8_3000x2000": rs,
                  "healthy": health["healthy"]}
        print(json.dumps({"service_checks": checks}), flush=True)
        report["service_graph"] = {**out, "checks": checks, "counters": delta}
    finally:
        ctx.shutdown()
    return launches


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _kernel_split(torch, prof, skip: tuple = ("Optimizer.",)) -> tuple[float, int, dict, list]:
    """(busy ms, kernel launches, ms by kind, the top kernels) of a profiled
    window; annotation ranges named with a ``skip`` prefix (the optimizer's
    step by default) are not kernels."""
    self_us = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))  # noqa: E731
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == cuda and self_us(e) > 0 and not e.key.startswith(skip)),
                     key=self_us, reverse=True)

    def kind(name: str) -> str:
        low = name.lower()
        if "flash_fwd" in low:
            return "attention_kernel"
        if "gn_moments" in low or "gn_affine_silu" in low:
            return "fused_group_norm"
        if "memcpy" in low or "memset" in low:
            return "copies"
        if any(k in low for k in ("conv", "gemm", "cudnn", "cutlass", "xmma", "implicit", "nhwc", "nchw", "sm90")):
            return "convolutions_and_matmuls"
        return "elementwise_and_reductions"

    split: dict = {}
    for e in kernels:
        split[kind(e.key)] = split.get(kind(e.key), 0.0) + self_us(e) / 1e3
    top = [{"name": e.key[:90], "device_ms": self_us(e) / 1e3, "count": e.count} for e in kernels[:10]]
    return sum(split.values()), sum(e.count for e in kernels), split, top


def _train_pair(cfg, **kw):
    """A graph trainer and its eager twin on ``cfg`` (the same seed, so the
    same weights and data stream)."""
    from image_restoration_platform_tpu_torch.train import Trainer

    graph = Trainer(cfg, device="cuda", **kw)
    eager = Trainer(cfg, device="cuda", eager=True, **kw)
    check(not graph.eager and eager.eager, "the graph trainer must replay graphs and its twin run eagerly")
    return graph, eager


def _train_compare(torch, graph, eager, steps: int, launches_per_step: int, on_step=None) -> list:
    """``steps`` steps of each trainer in lockstep: the batches and the
    losses equal bit for bit, the attention launches of each step counted
    apart (a step that builds the graph also counts its warm-up steps);
    ``on_step(k)`` runs before step k."""
    from image_restoration_platform_tpu_torch.ops.cuda.attention import flash_kernel

    rows = []
    for k in range(steps):
        if on_step is not None:
            on_step(k)
        builds = graph.compile_count
        batch_g, batch_e = graph.next_batch(), eager.next_batch()
        same_batch = all(torch.equal(a, b) for a, b in zip(batch_g, batch_e))
        _zero_launches(flash_kernel)
        loss_g = graph.train_step(batch_g).clone()
        launches_g = flash_kernel.launches
        _zero_launches(flash_kernel)
        loss_e = eager.train_step(batch_e)
        launches_e = flash_kernel.launches
        rows.append({"step": graph.state.step, "batch_equal": same_batch, "loss_graph": float(loss_g),
                     "loss_eager": float(loss_e), "launches_graph": launches_g, "launches_eager": launches_e,
                     "step_built": graph.compile_count > builds and k == 0, "compile_count": graph.compile_count})
    for row in rows:
        check(row["batch_equal"] and row["loss_graph"] == row["loss_eager"], f"graph against eager: {row}")
        check(row["launches_eager"] == launches_per_step, f"eager attention launches: {row}")
        # the build's warm-up steps launch too; a replay launches what its capture recorded
        want = launches_per_step * (1 + TRAIN_GRAPH_WARMUP if row["step_built"] else 1)
        check(row["launches_graph"] == want, f"graph attention launches: {row}, want {want}")
    params_equal = all(torch.equal(a, b) for a, b in zip(graph.state.model.parameters(),
                                                         eager.state.model.parameters()))
    check(params_equal, "graph and eager trainers' parameters differ")
    return rows


def _timed_steps(torch, trainer, steps: int) -> dict:
    """``steps`` steps through ``next_batch`` and ``train_step``, the draw
    and the step timed apart with CUDA events, host wall clock around all;
    the memory allocated before them and the peak in them (a graph's
    activations live in its pool, reserved and not allocated, between
    replays)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(3)] for _ in range(steps)]
    losses = []
    t = time.perf_counter()
    for start, mid, end in events:
        start.record()
        batch = trainer.next_batch()
        mid.record()
        losses.append(trainer.train_step(batch).clone())
        end.record()
    torch.cuda.synchronize()
    return {"wall_s": time.perf_counter() - t, "data_ms": [a.elapsed_time(b) for a, b, _ in events],
            "step_ms": [b.elapsed_time(c) for _, b, c in events], "losses": torch.stack(losses).cpu().tolist(),
            "allocated_before_gib": before / 2**30, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def phase_train(torch, np, report, card):
    """The trainer on the card: the r5-anchor recipe at full width through
    ``Trainer``'s executable tier (the train step and each distribution's
    draw as CUDA graphs) against ``Trainer(eager=True)``, bit for bit with
    cuDNN's deterministic algorithms on both sides (the r5 mix's three
    distributions, remat, the SR and diffusion branches, a checkpoint
    resumed into a graph trainer); then eager and graph steps timed in
    turns with the attention launches of the graph steps counted from 0;
    card against CPU, the optimizer card against CPU, the export round trip
    and the entry point ``main()``. It runs in a temporary
    ``IRP_WEIGHTS_DIR`` holding copies of the shipped weights, so nothing
    under weights/ is written."""
    import shutil
    import tempfile

    from image_restoration_platform_tpu_torch.models import get_family
    from image_restoration_platform_tpu_torch.models import weights as W
    from image_restoration_platform_tpu_torch.ops.cuda.attention import flash_kernel
    from image_restoration_platform_tpu_torch.train import DataConfig, Trainer, TrainConfig, synthetic_batch
    from image_restoration_platform_tpu_torch.train import __main__ as train_main
    from image_restoration_platform_tpu_torch.train import exec as X
    from image_restoration_platform_tpu_torch.train import trainer as T

    check(X.WARMUP_STEPS == TRAIN_GRAPH_WARMUP, f"the train graph's warm-up is {X.WARMUP_STEPS} steps")
    families = ("restore-unet", "sr-x2", "diffusion-restore")
    for family in families:
        check(os.path.exists(W.weights_path(family)), f"weights/{family}.npz missing")
    shipped_paths = {family: W.weights_path(family) for family in families}
    shipped_sha = {f: _sha256(p) for f, p in shipped_paths.items()}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    saved_env = {k: os.environ.get(k) for k in ("IRP_WEIGHTS_DIR", "TRAIN_STEPS", *TRAIN_ENV)}
    out: dict = {"card": card, "recipe": TRAIN_RECIPE}
    t_phase = time.perf_counter()
    try:
        for family, path in shipped_paths.items():
            shutil.copy(path, tmp)
        os.environ["IRP_WEIGHTS_DIR"] = tmp
        cfg = TrainConfig(**TRAIN_RECIPE)
        shipped = W.load_state_dict(W.weights_path("restore-unet"))

        # --- graph against eager, bit for bit: cuDNN's deterministic
        # algorithms on both sides (its default weight gradients may sum in
        # another order on every run, eager against eager too)
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        t = time.perf_counter()
        try:
            graph, eager = _train_pair(cfg, warm_start=True)
            check(all(torch.equal(p.detach().cpu(), shipped[n]) for n, p in graph.state.model.named_parameters()),
                  "the warm start did not load the shipped weights")
            ckpt = os.path.join(tmp, "ckpt")
            saved: list = []

            def save(k):
                if k == TRAIN_RESUME_AT:
                    saved.append(graph.save_checkpoint(ckpt))

            rows = _train_compare(torch, graph, eager, TRAIN_COMPARE_STEPS, 1, on_step=save)
            check([r["compile_count"] for r in rows][TRAIN_COMPARE_STEPS - 4:] == [4] * 4,
                  f"compile_count not 1 step + 3 distributions, flat: {[r['compile_count'] for r in rows]}")
            stats = graph.exec_stats()
            check(stats == {"compile_count": 4, "executables": 4, "graphs": 4}, f"graph trainer built {stats}")
            # a checkpoint resumed into a graph trainer that has built and
            # stepped: it continues the uninterrupted losses, bit for bit
            resumed = Trainer(cfg, device="cuda")
            resumed.run(1, log_every=100)
            builds = resumed.compile_count
            resumed.resume_checkpoint(saved[0])
            check(resumed.state.step == TRAIN_RESUME_AT, "resumed step")
            resumed_losses = [float(resumed.train_step(resumed.next_batch()))
                              for _ in range(TRAIN_COMPARE_STEPS - TRAIN_RESUME_AT)]
            straight = [r["loss_graph"] for r in rows[TRAIN_RESUME_AT:]]
            check(resumed_losses == straight, f"resume under graphs: {resumed_losses} against {straight}")
            check(all(torch.equal(a, b) for a, b in zip(graph.state.model.parameters(),
                                                        resumed.state.model.parameters())), "resumed parameters")
            out["graph_vs_eager"] = {"steps": rows, "exec_stats": stats,
                                     "resume": {"at_step": TRAIN_RESUME_AT, "losses": resumed_losses,
                                                "builds_before_resume": builds,
                                                "compile_count_after": resumed.compile_count}}
            del graph, eager, resumed
            torch.cuda.empty_cache()

            # remat captures too: two attention launches a step
            graph, eager = _train_pair(dataclasses.replace(cfg, remat=True), warm_start=True)
            out["remat"] = _train_compare(torch, graph, eager, 2, 2)
            del graph, eager

            # the SR and diffusion branches at b8 (the diffusion noise from the
            # registered generator)
            branches = {}
            for name, family, extra, want in TRAIN_BRANCHES:
                bcfg = TrainConfig(family=family, batch_size=8, image_size=cfg.image_size,
                                   learning_rate=cfg.learning_rate, total_steps=cfg.total_steps, data_photo=True,
                                   seed=cfg.seed, **extra)
                graph, eager = _train_pair(bcfg, warm_start=True)
                if name == "diffusion_eps":  # the same network trained for eps prediction
                    for tr in (graph, eager):
                        tr.step_fn.model_cfg = dataclasses.replace(tr.step_fn.model_cfg, parameterization="eps")
                if family == "sr-x2":
                    check(graph.state.model.config.limit_pool == 0, "SR trains with the limiter on")
                t_branch = time.perf_counter()
                branch_rows = _train_compare(torch, graph, eager, 3, want)
                branches[name] = {"losses": [r["loss_graph"] for r in branch_rows],
                                  "launches_per_replay": branch_rows[-1]["launches_graph"],
                                  "graphs": graph.exec_stats()["graphs"], "s": time.perf_counter() - t_branch}
                check(np.isfinite(branches[name]["losses"]).all(), f"{name}: {branches[name]}")
                del graph, eager
            out["branches"] = branches
            torch.cuda.empty_cache()
        finally:
            torch.backends.cudnn.deterministic = deterministic
        out["compare_s"] = time.perf_counter() - t
        print(json.dumps({"train_graph_vs_eager": {
            "steps": [{k: r[k] for k in ("step", "loss_graph", "launches_graph", "compile_count")}
                      for r in out["graph_vs_eager"]["steps"]],
            "resume": out["graph_vs_eager"]["resume"], "remat_losses": [r["loss_graph"] for r in out["remat"]],
            "branches": out["branches"], "s": out["compare_s"]}}), flush=True)

        # --- the main path, timed: eager and graph trainers on the recipe
        # (default cuDNN), warmed until every executable is built, then
        # blocks of steps in turns (eager, graph, graph, eager); the
        # attention launches of the graph steps counted from 0
        t = time.perf_counter()
        torch.cuda.synchronize()
        reserved = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(cfg, device="cuda", warm_start=True)
        warm_losses = trainer.run(TRAIN_WARMUP_STEPS, log_every=1)
        torch.cuda.synchronize()
        build = {"peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
                 "reserved_growth_gib": (torch.cuda.memory_reserved() - reserved) / 2**30,
                 "executables": trainer.exec_stats()}
        eager = Trainer(cfg, device="cuda", warm_start=True, eager=True)
        eager.run(TRAIN_WARMUP_STEPS, log_every=100)
        out["setup_and_warmup_s"] = time.perf_counter() - t
        builds = trainer.compile_count
        blocks = {"eager": [], "graph": []}
        for i, mode in enumerate(("eager", "graph", "graph", "eager")):
            if i == 1:
                _zero_launches(flash_kernel)
                _zero_gn()
            blocks[mode].append(_timed_steps(torch, trainer if mode == "graph" else eager, TRAIN_TIMED_STEPS // 2))
            if i == 2:
                launches = _read_launches("flash_attention", flash_kernel)
                out["fused_norm_launches"] = _read_gn("train")
        check(trainer.compile_count == builds, f"a timed step built an executable: {builds} -> "
                                               f"{trainer.compile_count}")
        check(launches == TRAIN_TIMED_STEPS, f"attention launches {launches} != train steps {TRAIN_TIMED_STEPS}")
        timing = {}
        for mode, runs in blocks.items():
            data_ms = [x for r in runs for x in r["data_ms"]]
            step_ms = [x for r in runs for x in r["step_ms"]]
            losses = [x for r in runs for x in r["losses"]]
            check(np.isfinite(losses).all(), f"{mode} training losses {losses}")
            timing[mode] = {
                "images_per_s": TRAIN_TIMED_STEPS * cfg.batch_size / sum(r["wall_s"] for r in runs),
                "wall_ms_per_step": 1e3 * sum(r["wall_s"] for r in runs) / TRAIN_TIMED_STEPS,
                "train_step_ms": statistics.median(step_ms), "train_step_ms_min_max": [min(step_ms), max(step_ms)],
                "synthetic_batch_ms": statistics.median(data_ms), "synthetic_batch_ms_min_max": [min(data_ms),
                                                                                                 max(data_ms)],
                "peak_allocated_gib": max(r["peak_gib"] for r in runs),
                "peak_over_allocated_before_gib": max(r["peak_gib"] - r["allocated_before_gib"] for r in runs),
                "losses_first_last": [losses[0], losses[-1]],
            }
        for mode, tr in (("eager", eager), ("graph", trainer)):
            step_total = timing[mode]["train_step_ms"] + timing[mode]["synthetic_batch_ms"]
            timing[mode]["profile_step"] = _step_profile(
                torch, lambda tr=tr: (tr.train_step(tr.next_batch()), torch.cuda.synchronize()), step_total,
                skip=("Optimizer.",))
        out.update({"steps": TRAIN_TIMED_STEPS, "batch": cfg.batch_size, "size": cfg.image_size,
                    "attention_launches": launches, "warmup_losses": warm_losses, "graph_build": build,
                    "memory_reserved_gib": torch.cuda.memory_reserved() / 2**30, "timing": timing,
                    "timed_s": time.perf_counter() - t})
        print(json.dumps({"training": {k: v for k, v in out.items()
                                       if k in ("steps", "batch", "size", "attention_launches", "warmup_losses",
                                                "graph_build", "memory_reserved_gib", "setup_and_warmup_s",
                                                "timed_s")}}), flush=True)
        for mode in ("eager", "graph"):
            print(json.dumps({f"training_{mode}": timing[mode]}), flush=True)
        del eager

        # --- card against CPU: same warm weights, one batch drawn on the CPU.
        # In f32 (TF32 off for the check) the card must agree with the CPU;
        # in bf16 with the CPU's bf16, and its loss gap to f32 with the JAX
        # trainer's (see the bars)
        data_cfg = DataConfig(size=cfg.image_size, photo=True, deconv=True, grain=True, smooth=True,
                              compression_solo=cfg.data_compression_solo, lowlight_solo=cfg.data_lowlight_solo)
        cpu_batch = synthetic_batch(torch.Generator().manual_seed(cfg.seed), TRAIN_CPU_BATCH, data_cfg, with_masks=True)

        def loss_and_grads(where, dtype):
            ts = T.TrainStep(dataclasses.replace(cfg, compute_dtype=dtype), torch.device(where))
            model = ts.build_model()
            model.load_state_dict(shipped, strict=True)
            loss = ts.loss(model, *(b.to(where) for b in cpu_batch))
            grads = torch.autograd.grad(loss, list(model.parameters()))
            return loss.item(), torch.cat([g.double().flatten().cpu() for g in grads])

        tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            runs = {"card_f32": loss_and_grads("cuda", torch.float32), "cpu_f32": loss_and_grads("cpu", torch.float32)}
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        runs["card_bf16"] = loss_and_grads("cuda", torch.bfloat16)
        runs["cpu_bf16"] = loss_and_grads("cpu", torch.bfloat16)

        def rel(a, b):
            (la, ga), (lb, gb) = runs[a], runs[b]
            na, nb = float(ga.norm()), float(gb.norm())
            return {"loss_rel": abs(la - lb) / lb, "grad_norm_rel": abs(na - nb) / nb,
                    "grad_cosine": float(ga @ gb) / (na * nb)}

        cmp = {**{f"{k}_loss": v[0] for k, v in runs.items()}, **{f"{k}_grad_norm": float(v[1].norm())
                                                                 for k, v in runs.items()},
               "card_f32_vs_cpu_f32": rel("card_f32", "cpu_f32"), "card_bf16_vs_cpu_bf16": rel("card_bf16", "cpu_bf16"),
               "card_bf16_vs_cpu_f32": rel("card_bf16", "cpu_f32"), "cpu_bf16_vs_cpu_f32": rel("cpu_bf16", "cpu_f32")}
        del runs
        f32 = cmp["card_f32_vs_cpu_f32"]
        check(f32["loss_rel"] <= TRAIN_LOSS_RTOL and f32["grad_norm_rel"] <= TRAIN_GRAD_NORM_RTOL
              and f32["grad_cosine"] >= TRAIN_GRAD_COSINE, f"training card vs CPU in f32: {cmp}")
        check(cmp["card_bf16_vs_cpu_bf16"]["loss_rel"] <= TRAIN_LOSS_RTOL, f"training card vs CPU in bf16: {cmp}")
        gap = cmp["card_bf16_vs_cpu_f32"]["loss_rel"]
        check(abs(gap - TRAIN_REFERENCE_BF16_GAP) <= TRAIN_GAP_RTOL * TRAIN_REFERENCE_BF16_GAP,
              f"training card bf16 vs CPU f32: loss gap {gap} against the reference's {TRAIN_REFERENCE_BF16_GAP}")
        # the optimizer alone: fused AdamW on the card against the CPU on the
        # same parameters, gradients and learning rates
        gen = torch.Generator().manual_seed(5)
        start = torch.randn(TRAIN_OPT_SIZE, generator=gen)
        grads = [torch.randn(TRAIN_OPT_SIZE, generator=gen) * scale for scale in (0.1, 4.0, 0.01, 1.0, 0.3)]
        sched = T.lr_schedule(cfg)
        after = {}
        for where in ("cpu", "cuda"):
            p = torch.nn.Parameter(start.to(where, copy=True))  # to("cpu") alone would share start's memory
            opt = T.make_optimizer(cfg, [p])
            for k, g in enumerate(grads):
                T.set_lr_(opt, sched(k + 100))
                p.grad = g.to(where)
                opt.step()
            after[where] = p.detach().cpu()
        cmp["adamw_card_vs_cpu_max_abs_over_lr"] = float((after["cuda"] - after["cpu"]).abs().max()) / sched(104)
        print(json.dumps({"train_card_vs_cpu": cmp}), flush=True)
        out["card_vs_cpu"] = cmp

        # --- the export round trip
        path = os.path.join(tmp, "roundtrip", "restore-unet.npz")
        W.save_params(trainer.state.model.state_dict(), path)
        back = W.load_state_dict(path)
        worst = 0.0
        for name, p in trainer.state.model.state_dict().items():
            p = p.cpu()
            excess = (back[name] - p).abs() - (EXPORT_PARAM_RTOL * p.abs() + EXPORT_PARAM_ATOL)
            worst = max(worst, float(excess.max()))
        check(worst <= 0.0, f"export round trip: a weight moved {worst} past fp16's storage error")
        reloaded = get_family("restore-unet").build().cuda()
        reloaded.load_state_dict(back, strict=True)
        x, c = cpu_batch[0].cuda(), cpu_batch[2].cuda()
        with torch.no_grad():
            out_err = float((reloaded(x, c) - trainer.state.model(x, c)).abs().max())
        check(out_err <= EXPORT_OUT_ATOL, f"export round trip: the forward moved {out_err}")
        out["export"] = {"worst_weight_excess": worst, "forward_max_abs": out_err}
        print(json.dumps({"train_export": out["export"]}), flush=True)
        del trainer, reloaded
        torch.cuda.empty_cache()

        # --- the entry point, two steps on the recipe
        os.environ.update({**TRAIN_ENV, "TRAIN_STEPS": "2", "IRP_WEIGHTS_DIR": os.path.join(tmp, "main")})
        os.makedirs(os.path.join(tmp, "main"))
        shutil.copy(shipped_paths["restore-unet"], os.path.join(tmp, "main"))
        said = []
        handler = logging.Handler()
        handler.emit = lambda record: said.append(record.getMessage())
        logging.getLogger("irp.train-main").addHandler(handler)
        t = time.perf_counter()
        try:
            train_main.main()
        finally:
            logging.getLogger("irp.train-main").removeHandler(handler)
        out["main_s"] = time.perf_counter() - t
        check(any("training done" in m for m in said) and any("weights exported" in m for m in said),
              f"main() said {said}")
        get_family("restore-unet").build().load_state_dict(W.load_state_dict(W.weights_path("restore-unet")))
        out["phase_s"] = time.perf_counter() - t_phase
        print(json.dumps({"train_main": {"s": out["main_s"], "phase_s": out["phase_s"]}}), flush=True)
        report["training"] = out
    finally:
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        shutil.rmtree(tmp, ignore_errors=True)
    check({f: _sha256(p) for f, p in shipped_paths.items()} == shipped_sha, "the phase changed weights/")
    torch.cuda.empty_cache()
    return {"train": launches}


# the mesh phase: slot meshes that repeat the one card, [cuda:0] x 4. Their
# slots share the card's stream and run one after another: the times show that
# a mesh path costs about what the unsharded one does, not any scaling.
MESH_SLOTS = 4
MESH_RESTORE = (("data4", dict(data=4), 4), ("data2_tensor2", dict(data=2, tensor=2), 2))
# the reference's bars (tests/test_mesh_serving.py, tests/test_pipeline.py):
# restore_batch mean |delta| < 1 level with scores within 1e-4 (and the
# stages' per-image fire flags equal); in bf16 the unsharded engine itself
# moves an image by up to tens of levels between batch sizes (cuDNN picks
# other convolution algorithms), so a data slot is also held to the
# unsharded engine at its shard's batch size, bit for bit where the tensor
# axis is 1; sr_tiled
# exactly; sr_spatial max |delta| <= 1 level with the shard-boundary rows no
# worse than max(0.5, 1.5 x the mean); the bf16 SRNet pipeline within 0.05 on
# [0, 1]; the UNet pipeline (bf16, as served) at the restore bar
MESH_MEAN_LEVELS, MESH_SCORES_ATOL, SPATIAL_MAX_LEVELS, PIPE_BF16_ATOL = 1.0, 1e-4, 1, 0.05
SPATIAL_ROWS = 1501  # no multiple of 4: three rows of padding
# two Trainer steps on data=2 against two unsharded steps, in f32 (TF32 off):
# the losses to 1e-4 relative, each step's gradient to cosine 0.9999 and its
# norm to 1e-4; the parameters equal up to cuDNN's nondeterministic weight
# gradients, which Adam scales to ~lr on elements whose gradient is near 0:
# at most 0.1 % of elements off by more than 1 % of lr
MESH_TRAIN_BATCH, MESH_LOSS_RTOL, MESH_GRAD_COSINE, MESH_GRAD_NORM_RTOL = 8, 1e-4, 0.9999, 1e-4
MESH_FAR_SHARE = 1e-3
# the mesh surfaces on graphs against eager: calls a turn (eager, graph,
# graph, eager) after one untimed call; the mesh trainer on graphs against
# eager: steps compared (the r5 mix's three distributions by step 5), steps
# a timed turn, and steps with the one-rank NCCL group up
MESH_STEP_REPS = 3
MESH_TRAIN_COMPARE_STEPS, MESH_TRAIN_TIMED_STEPS, MESH_NCCL_STEPS = 8, 5, 3


def _levels(np, a, b) -> dict:
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return {"mean_levels": float(d.mean()), "max_levels": int(d.max())}


def _levels_per_image(np, a, b) -> dict:
    d = np.abs(a.astype(np.int32) - b.astype(np.int32)).reshape(len(a), -1)
    return {"mean_levels": [float(x) for x in d.mean(1)], "max_levels": [int(x) for x in d.max(1)]}


def _mesh_restore_batch(np, imageio, motion_psf):
    """Phase 7's 512 b8: photos, two blocky JPEGs (2, 7) and two motion
    blurs (1, 3), so each stage fires on some shards' images and not on
    others (images 4-5 fire nothing). The blurs deblur with room to spare: the
    Wiener output's total variation is 2.5x the input's, the bar 3x (the
    port on the CPU). (canvas [8,512,512,3] u8, is_jpeg [8] f32, the
    uploads)."""
    u8 = lambda x: np.clip(np.round(x * 255.0), 0, 255).astype(np.uint8)  # noqa: E731
    blurs = {1: (15.0, 0.0), 3: (9.0, 0.9)}  # image: (length, angle)
    canvas, is_jpeg, uploads = [], [], []
    for i in range(8):
        img = _photo(np, 40 + i, 512)
        if i in blurs:
            img = _motion_blur(np, img, motion_psf(*blurs[i]))
        if i in (2, 7):
            data = imageio.encode_jpeg(u8(img), quality=15)
            pixels = imageio.decode_image(data).pixels
        else:
            pixels = u8(img)
            data = imageio.encode_png(pixels)
        canvas.append(pixels)
        is_jpeg.append(float(i in (2, 7)))
        uploads.append(data)
    return np.stack(canvas), np.asarray(is_jpeg, np.float32), uploads


def _fire_flags_of(torch, engine, canvas, is_jpeg):
    """[N, 3] bool: the stages' per-image fire flags (deblock, deblur_veto,
    deblur) of the engine's restore-unet program run eagerly on full
    canvases, each data row's shard on the row's replica in turn on a mesh
    (slot after slot, outside the executables): what the engine's fetch
    reads and counts as ``stage_fires.*``."""
    from image_restoration_platform_tpu_torch.serve.programs.restore import fire_flags

    n, h, w = canvas.shape[:3]
    args = (torch.from_numpy(canvas).to(engine.device),
            torch.tensor([[h, w]] * n, dtype=torch.int32, device=engine.device),
            torch.from_numpy(is_jpeg).to(engine.device))
    program = engine._program("restore-unet", "rgb")
    models = engine._data_replicas("restore-unet") if engine._is_multi_device() else [engine.model("restore-unet")]
    flags = []
    for model, shard in zip(models, zip(*(a.chunk(len(models)) for a in args))):
        fires: dict = {}
        program(model, *shard, fires=fires)
        flags.append(fire_flags(fires, shard[0].shape[0], engine.device))
    return torch.cat(flags).cpu().numpy().astype(bool)


def _profiled_step(torch, fn) -> dict:
    """Kernel ms and launches of one profiled call (the engine's own
    annotation range left out): set beside the unprofiled step time, what
    the card did and what the host waited on."""
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
    with prof:
        fn()
    busy, count, split, _ = _kernel_split(torch, prof, skip=("restore/",))
    return {"kernel_ms": busy, "kernel_launches": count, "by_kind_ms": split}


def phase_mesh(torch, np, report, card):
    """The mesh surfaces on slot meshes of the card at full width, bf16,
    shipped weights, each held to the unsharded port with the reference's
    bars and its kernels' launches counted from 0: restore_batch through
    RestoratorService on data=4 and data=2 x tensor=2, sr_tiled on data=4,
    sr_spatial on spatial=4, both pipelines, two Trainer steps on data=2,
    and the process group of one rank on NCCL. Every mesh surface runs on
    CUDA graphs (the mesh executable tier, after ``warmup_serving``, with
    ``compile_count`` held flat) and is held to its eager twin
    (``RestorationEngine(mesh=..., eager=True)``): bytes and the kernels'
    launches equal, step times in turns (eager, graph, graph, eager) with
    one profiled step each; the mesh ``Trainer`` on data=2 on graphs
    against its eager twin bit for bit over 8 steps in f32 and in bf16
    (deterministic cuDNN), with the steps' times, and again captured with
    the one-rank NCCL group up."""
    import socket

    import torch.distributed as dist

    from image_restoration_platform_tpu_torch import imageio
    from image_restoration_platform_tpu_torch.config import ServingConfig
    from image_restoration_platform_tpu_torch.obs.metrics import get_counters
    from image_restoration_platform_tpu_torch.ops.cuda.attention import flash_kernel
    from image_restoration_platform_tpu_torch.ops.cuda.blend import blend_kernel
    from image_restoration_platform_tpu_torch.ops.deblur import motion_psf
    from image_restoration_platform_tpu_torch.parallel import (
        make_mesh, maybe_initialize_distributed, srnet_pipeline_apply, unet_pipeline_apply,
    )
    from image_restoration_platform_tpu_torch.parallel.sharding import ShardedConv
    from image_restoration_platform_tpu_torch.serve import MicroBatcher, RestorationEngine, RestoratorService
    from image_restoration_platform_tpu_torch.train import TrainConfig, Trainer

    t_phase = time.perf_counter()
    slots = [torch.device("cuda", 0)] * MESH_SLOTS
    cfg = ServingConfig(size_buckets=(256, 512, 1024), max_batch=8)
    single = RestorationEngine(device="cuda", dtype=torch.bfloat16, serving_config=cfg)
    counters = get_counters()
    out: dict = {"card": card, "parts_s": {}, "graph_vs_eager": []}
    launches: dict = {"flash_attention": {}, "blend_tiles": {}}
    mark = [time.perf_counter()]

    def part_done(name: str) -> None:
        out["parts_s"][name] = time.perf_counter() - mark[0]
        mark[0] = time.perf_counter()

    def step_ms(fn, reps: int = 5) -> float:
        fn()
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t)
        return 1e3 * statistics.median(times)

    def mesh_engines(families: tuple, **axes):
        """A mesh engine on CUDA graphs after ``warmup_serving`` of
        ``families`` at 512 (and the tiled or spatial 2048 canvas), its
        warm-up report, and its eager twin."""
        mesh = make_mesh(slots, **axes)
        graph = RestorationEngine(dtype=torch.bfloat16, serving_config=cfg, param_cache=single.params_cache,
                                  mesh=mesh)
        eager = RestorationEngine(dtype=torch.bfloat16, serving_config=cfg, param_cache=single.params_cache,
                                  mesh=mesh, eager=True)
        check(not graph.eager and eager.eager, "the graph engine must replay graphs and its twin run eagerly")
        t = time.perf_counter()
        graph.warmup_serving(families=families, sizes=(512,))
        warm = {"s": time.perf_counter() - t, **graph.exec_stats()}
        check(warm["graphs"] > 0 and warm["eager_executables"] == 0, f"mesh {axes}: warm-up {warm}")
        return graph, eager, warm

    def graph_vs_eager(surface: str, run, graph, eager) -> dict:
        """``run(e)`` on the graph engine, then on its eager twin: equal
        arrays and equal launches of both kernels."""
        _zero_launches(flash_kernel)
        _zero_launches(blend_kernel)
        got = _arrays(run(graph))
        graph_n = (_read_launches("flash_attention", flash_kernel), _read_launches("blend_tiles", blend_kernel))
        _zero_launches(flash_kernel)
        _zero_launches(blend_kernel)
        want = _arrays(run(eager))
        eager_n = (flash_kernel.launches, blend_kernel.launches)
        levels = max(int(np.abs(a.astype(np.float64) - b.astype(np.float64)).max()) if a.dtype == np.uint8 else 0
                     for a, b in zip(got, want))
        row = {"surface": surface, "equal": all(np.array_equal(a, b) for a, b in zip(got, want)),
               "max_levels": levels, "launches_graph": graph_n, "launches_eager": eager_n}
        print(json.dumps({"mesh_graph_vs_eager": row}), flush=True)
        check(row["equal"] and graph_n == eager_n, f"mesh graph replay against eager execution: {row}")
        out["graph_vs_eager"].append(row)
        return row

    def steps(run, graph, eager) -> dict:
        return _eager_graph_steps(torch, run, {"eager": eager, "graph": graph}, MESH_STEP_REPS)

    # --- restore-unet 512 b8: RestoratorService on the mesh engine, and the
    # engine against the unsharded one on the same batch, image by image, with
    # the stages' per-image fire flags held equal
    canvas8, is_jpeg8, uploads = _mesh_restore_batch(np, imageio, motion_psf)
    clean8 = np.stack([np.clip(np.round(_photo(np, 60 + i, 512) * 255.0), 0, 255).astype(np.uint8)
                       for i in range(8)])
    no_jpeg8 = np.zeros(8, np.float32)
    part_done("restore_inputs")
    ref_out, ref_scores, _ = single.restore_batch(canvas8, is_jpeg=is_jpeg8)
    ref_flags = _fire_flags_of(torch, single, canvas8, is_jpeg8)
    check(ref_flags[:, [0, 2]].any(0).all() and not ref_flags[:, [0, 2]].all(0).any(),
          f"the mesh batch should fire deblock and deblur on some images only: {ref_flags.tolist()}")
    clean_flags = _fire_flags_of(torch, single, clean8, no_jpeg8)
    check(not clean_flags.any(), f"the clean mesh batch should fire no stage: {clean_flags.tolist()}")
    # the same in f32 (TF32 convolutions, torch's default): the spread of
    # the unsharded engine between batch sizes is bf16 rounding
    f32 = RestorationEngine(device="cuda", dtype=torch.float32, serving_config=cfg, param_cache=single.params_cache)
    f32_b8 = f32.restore_batch(canvas8, is_jpeg=is_jpeg8)[0]
    f32_pairs = np.concatenate([f32.restore_batch(canvas8[i : i + 2], is_jpeg=is_jpeg8[i : i + 2])[0]
                                for i in range(0, 8, 2)])
    out["f32_unsharded_b2_vs_b8"] = _levels_per_image(np, f32_pairs, f32_b8)
    del f32
    part_done("restore_f32_pairs")
    out["restore_512_b8_single_ms"] = step_ms(lambda: single.restore_batch(canvas8, is_jpeg=is_jpeg8))
    out["restore_512_b8_single_profile"] = _profiled_step(torch, lambda: single.restore_batch(canvas8, is_jpeg=is_jpeg8))
    part_done("restore_unsharded")
    for name, axes, per_batch in MESH_RESTORE:
        shard = 8 // axes["data"]
        # the unsharded engine at a data slot's batch size, shard by shard
        by_shard = np.concatenate([single.restore_batch(canvas8[i : i + shard], is_jpeg=is_jpeg8[i : i + shard])[0]
                                   for i in range(0, 8, shard)])
        engine, eager, warm = mesh_engines(("restore-unet",), **axes)
        builds = engine.compile_count
        batcher = MicroBatcher(engine, cfg, device="cuda")
        svc = RestoratorService(engine=engine, batcher=batcher, serving_config=cfg, device="cuda")
        try:
            check(svc.restore(uploads[0])["success"], f"mesh {name}: warm-up failed")
            before = counters.snapshot()
            _zero_launches(flash_kernel)
            _zero_gn()
            with ThreadPoolExecutor(max_workers=len(uploads)) as pool:
                results = list(pool.map(svc.restore, uploads))
            got_out, got_scores, meta = engine.restore_batch(canvas8, is_jpeg=is_jpeg8)
            n = _read_launches("flash_attention", flash_kernel)
            gn_launches = _read_gn(f"mesh_restore_{name}")
            batches = int(_counter_delta(before, counters.snapshot()).get("restore_batches.512", 0))
        finally:
            batcher.shutdown()
        for res in results:
            check(res.get("success") is True, f"mesh {name}: {res.get('error')}")
            check(res["metadata"]["sizeBucket"] == 512, f"mesh {name}: bucket {res['metadata']['sizeBucket']}")
        flags = _fire_flags_of(torch, engine, canvas8, is_jpeg8)
        cmp = {**_levels(np, got_out, ref_out), "per_image": _levels_per_image(np, got_out, ref_out),
               "scores_max_abs": float(np.abs(got_scores - ref_scores).max()), "fused_norm_launches": gn_launches,
               "vs_unsharded_at_shard_batch": _levels(np, got_out, by_shard),
               "unsharded_shard_batch_vs_b8": _levels_per_image(np, by_shard, ref_out),
               "stage_fires": flags.sum(0).tolist(), "batches": batches, "attention_launches": n,
               "batch_bucket": meta["batchBucket"], "warmup": warm}
        check(n == per_batch * batches, f"mesh {name}: {n} attention launches in {batches} batches, "
                                        f"expected {per_batch} a batch")
        check(np.array_equal(flags, ref_flags), f"mesh {name}: stage fires {flags.tolist()} against the "
                                                f"unsharded engine's {ref_flags.tolist()}")
        check(cmp["mean_levels"] < MESH_MEAN_LEVELS and cmp["scores_max_abs"] <= MESH_SCORES_ATOL,
              f"mesh {name} against the unsharded engine: {cmp}")
        if axes.get("tensor", 1) == 1:  # each slot runs the unsharded program on its shard
            check(cmp["vs_unsharded_at_shard_batch"]["max_levels"] == 0,
                  f"mesh {name} against the unsharded engine at the shard's batch size: {cmp}")
        for batch_name, canvas, is_jpeg in (("fire", canvas8, is_jpeg8), ("clean", clean8, no_jpeg8)):
            row = graph_vs_eager(f"restore/{name}/512b8/{batch_name}",
                                 lambda e, c=canvas, j=is_jpeg: e.restore_batch(c, is_jpeg=j), engine, eager)
            check(row["launches_graph"][0] == per_batch, f"mesh {name}: {row}")
        cmp["steps"] = steps(lambda e: e.restore_batch(canvas8, is_jpeg=is_jpeg8), engine, eager)
        cmp["compile_count_after_warmup"], cmp["compile_count_after_serving"] = builds, engine.compile_count
        print(json.dumps({f"mesh_restore_{name}": cmp}), flush=True)
        check(engine.compile_count == builds, f"mesh {name}: a warmed surface was built in a request: {cmp}")
        out[f"restore_{name}"] = cmp
        launches["flash_attention"][f"mesh_restore_{name}"] = n
        del engine, eager, svc, batcher
        torch.cuda.empty_cache()
        part_done(f"restore_{name}")

    # --- the W-fold on data=2 x tensor=2: the folded flagship column-parallel
    # (each slot whole channel pairs, the phase kernels replicated) on graphs
    # against the single-device folded engine, at the reference's mesh bars
    fold_cfg = dataclasses.replace(cfg, fold_w=True)
    single_fold = RestorationEngine(device="cuda", dtype=torch.bfloat16, serving_config=fold_cfg,
                                    param_cache=single.params_cache)
    ref_fold, ref_fold_scores, _ = single_fold.restore_batch(canvas8, is_jpeg=is_jpeg8)
    fold_mesh = RestorationEngine(dtype=torch.bfloat16, serving_config=fold_cfg, param_cache=single.params_cache,
                                  mesh=make_mesh(slots, data=2, tensor=2))
    t = time.perf_counter()
    fold_mesh.warmup_serving(families=("restore-unet",), sizes=(512,), batches=(8,))
    warm = {"s": time.perf_counter() - t, **fold_mesh.exec_stats()}
    builds = fold_mesh.compile_count
    _zero_launches(flash_kernel)
    got_out, got_scores, _ = fold_mesh.restore_batch(canvas8, is_jpeg=is_jpeg8)
    n = _read_launches("flash_attention", flash_kernel)
    replicas = fold_mesh._data_replicas("restore-unet")
    split = [w.shape[0] for m in replicas[0].modules() if isinstance(m, ShardedConv) for w in m.w]
    cmp = {**_levels(np, got_out, ref_fold), "scores_max_abs": float(np.abs(got_scores - ref_fold_scores).max()),
           "attention_launches": n, "warmup": warm, "sharded_conv_slices": len(split),
           "odd_slices": sum(c % 2 for c in split), "compile_count": (builds, fold_mesh.compile_count)}
    print(json.dumps({"mesh_restore_folded_data2_tensor2": cmp}), flush=True)
    check(all(getattr(r, "folded", False) for r in replicas) and split and not cmp["odd_slices"],
          f"mesh folded: the replicas' layout {cmp}")
    check(warm["graphs"] > 0 and warm["eager_executables"] == 0, f"mesh folded: warm-up {warm}")
    check(n == 2, f"mesh folded: {n} attention launches, expected one a data row")
    check(cmp["mean_levels"] < MESH_MEAN_LEVELS and cmp["scores_max_abs"] <= MESH_SCORES_ATOL,
          f"mesh folded against the single-device folded engine: {cmp}")
    check(fold_mesh.compile_count == builds, f"mesh folded: a warmed surface was built in a request: {cmp}")
    out["restore_folded_data2_tensor2"] = cmp
    launches["flash_attention"]["mesh_restore_folded"] = n
    del single_fold, fold_mesh, replicas
    torch.cuda.empty_cache()
    part_done("restore_folded")

    # --- sr-x2 2048 -> 4096 with the tiles split over data=4: equal, one blend
    canvas2048 = _photo_large(np, 11, 2048, 2048)
    ref_sr, _ = single.sr_tiled(canvas2048, "sr-x2")
    tiled, tiled_eager, warm = mesh_engines(("sr-x2",), data=4)
    check(all(getattr(r, "folded", False) == cfg.fold_w_sr for r in tiled._data_replicas("sr-x2")),
          "the mesh sr_tiled replicas are not in the layout fold_w_sr asks for")
    builds = tiled.compile_count
    _zero_launches(blend_kernel)
    got_sr, _ = tiled.sr_tiled(canvas2048, "sr-x2")
    n = _read_launches("blend_tiles", blend_kernel)
    cmp = {**_levels(np, got_sr, ref_sr), "blend_launches": n, "warmup": warm}
    check(n == 1, f"mesh sr_tiled: {n} blend launches")
    check(cmp["max_levels"] == 0, f"mesh sr_tiled differs from the unsharded call: {cmp}")
    for output in ("rgb", "yuv420"):
        graph_vs_eager(f"sr_tiled/data4/2048/{output}", lambda e, o=output: e.sr_tiled(canvas2048, "sr-x2", output=o),
                       tiled, tiled_eager)
    cmp["single_ms"] = step_ms(lambda: single.sr_tiled(canvas2048, "sr-x2"), 3)
    cmp["steps"] = steps(lambda e: e.sr_tiled(canvas2048, "sr-x2"), tiled, tiled_eager)
    cmp["compile_count_after_warmup"], cmp["compile_count_after_serving"] = builds, tiled.compile_count
    print(json.dumps({"mesh_sr_tiled_data4": cmp}), flush=True)
    check(tiled.compile_count == builds, f"mesh sr_tiled: a warmed surface was built in a request: {cmp}")
    out["sr_tiled_data4"] = cmp
    launches["blend_tiles"]["mesh_sr_tiled"] = n
    del tiled, tiled_eager
    torch.cuda.empty_cache()
    part_done("sr_tiled")

    # --- one canvas row-sharded over spatial=4 against the unsharded forward
    # (limiter included) of the same padded canvas; the 2048 canvas is the
    # one the restorator sends there (warmed), 1501 x 1100 a shape of its own
    spatial, spatial_eager, warm = mesh_engines(("sr-x2",), spatial=4)
    builds = spatial.compile_count
    out["sr_spatial_warmup"] = warm
    model = single.model("sr-x2", folded=False)  # the row-sharded program's layout
    for name, canvas in (("2048", canvas2048), (f"{SPATIAL_ROWS}x1100", _photo_large(np, 12, SPATIAL_ROWS, 1100))):
        got, meta = spatial.sr_spatial(canvas, "sr-x2")
        pad = (-canvas.shape[0]) % 4
        padded = np.concatenate([canvas, np.repeat(canvas[-1:], pad, axis=0)], axis=0) if pad else canvas
        with torch.inference_mode():
            x = torch.from_numpy(padded).cuda()[None].to(torch.bfloat16) / 255.0
            ref = torch.clamp(torch.round(model(x).float() * 255.0), 0, 255).to(torch.uint8)[0].cpu().numpy()
        ref = ref[: canvas.shape[0] * 2]
        diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        rows = padded.shape[0] * 2
        seams = [r for b in range(1, 4) for r in (rows // 4 * b - 1, rows // 4 * b) if r < diff.shape[0]]
        cmp = {**_levels(np, got, ref), "seam_mean_levels": float(diff[seams].mean()), "padded_rows": meta["paddedRows"],
               "halo": meta["halo"], "shape": list(got.shape), "compile_count": spatial.compile_count - builds}
        check(got.shape == (canvas.shape[0] * 2, canvas.shape[1] * 2, 3) and meta["paddedRows"] == pad,
              f"sr_spatial {name}: {cmp}")
        check(cmp["max_levels"] <= SPATIAL_MAX_LEVELS, f"sr_spatial {name} against the unsharded forward: {cmp}")
        check(cmp["seam_mean_levels"] <= max(0.5, 1.5 * cmp["mean_levels"]), f"sr_spatial {name} seams: {cmp}")
        graph_vs_eager(f"sr_spatial/spatial4/{name}", lambda e, c=canvas: e.sr_spatial(c, "sr-x2"), spatial,
                       spatial_eager)
        cmp["steps"] = steps(lambda e, c=canvas: e.sr_spatial(c, "sr-x2"), spatial, spatial_eager)
        print(json.dumps({f"mesh_sr_spatial_{name}": cmp}), flush=True)
        out[f"sr_spatial_{name}"] = cmp
    check(out["sr_spatial_2048"]["compile_count"] == 0, "sr_spatial 2048: the warmed canvas was built in a request")
    del spatial, spatial_eager
    torch.cuda.empty_cache()
    part_done("sr_spatial")

    # --- the pipelines at 512, n_micro 4, against the unpipelined forwards
    with torch.inference_mode():
        x = torch.from_numpy(canvas8).cuda().to(torch.bfloat16) / 255.0
        ref = model(x)
        got = srnet_pipeline_apply(model, x, make_mesh(slots, pipe=4), n_micro=4)
        sr_err = float((got - ref).abs().max())
        unet = single.model("restore-unet", folded=False)  # the pipeline splits the unfolded UNet
        cond = torch.rand((8, 28), generator=torch.Generator().manual_seed(7)).cuda().to(torch.bfloat16)
        ref = unet(x, cond)
        _zero_launches(flash_kernel)
        got = unet_pipeline_apply(unet, x, cond, make_mesh(slots, data=2, pipe=2), n_micro=4)
        n = _read_launches("flash_attention", flash_kernel)
        u8 = lambda t: torch.round(torch.clamp(t.float(), 0, 1) * 255.0).to(torch.uint8).cpu().numpy()  # noqa: E731
        unet_cmp = _levels(np, u8(got), u8(ref))
    cmp = {"srnet_pipe4_max_abs": sr_err, "unet_data2_pipe2": unet_cmp, "unet_attention_launches": n}
    print(json.dumps({"mesh_pipelines": cmp}), flush=True)
    check(sr_err <= PIPE_BF16_ATOL, f"SRNet pipeline against the forward: {sr_err}")
    check(unet_cmp["mean_levels"] < MESH_MEAN_LEVELS, f"UNet pipeline against the forward: {unet_cmp}")
    check(n == 8, f"UNet pipeline: {n} attention launches, expected 4 microbatches x 2 data rows")
    out["pipelines"] = cmp
    launches["flash_attention"]["unet_pipeline"] = n
    part_done("pipelines")

    # --- two Trainer steps on data=2 against two unsharded steps, in f32
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        tcfg = TrainConfig(**{**TRAIN_RECIPE, "batch_size": MESH_TRAIN_BATCH, "compute_dtype": torch.float32,
                              "total_steps": 20, "warmup_steps": 1})
        plain = Trainer(tcfg, device="cuda", warm_start=True)
        meshed = Trainer(tcfg, warm_start=True, mesh=make_mesh(slots[:2], data=2))
        train_steps, n = [], 0
        for _ in range(2):
            batch = plain.next_batch()
            check(all(torch.equal(a, b) for a, b in zip(batch, meshed.next_batch())), "the two data streams differ")
            lp = float(plain.step_fn(plain.state, *batch))
            _zero_launches(flash_kernel)
            lm = float(meshed.step_fn(meshed.state, *batch))
            n += _read_launches("flash_attention", flash_kernel)
            gp = torch.cat([p.grad.reshape(-1) for p in plain.state.model.parameters()])
            gm = torch.cat([p.grad.reshape(-1) for p in meshed.state.model.parameters()])
            train_steps.append({"loss": lp, "loss_rel": abs(lm - lp) / abs(lp),
                                "grad_cosine": float(torch.nn.functional.cosine_similarity(gp, gm, dim=0)),
                                "grad_norm_rel": float(abs(gm.norm() - gp.norm()) / gp.norm())})
        lr = tcfg.learning_rate
        far = sum(int(((a - b).abs() > 0.01 * lr).sum()) for a, b in zip(
            plain.state.model.parameters(), meshed.state.model.parameters()))
        total = sum(p.numel() for p in plain.state.model.parameters())
        del plain, meshed
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    cmp = {"steps": train_steps, "params_far_share": far / total, "attention_launches": n}
    print(json.dumps({"mesh_train_data2": cmp}), flush=True)
    for s in train_steps:
        check(s["loss_rel"] <= MESH_LOSS_RTOL and s["grad_cosine"] >= MESH_GRAD_COSINE
              and s["grad_norm_rel"] <= MESH_GRAD_NORM_RTOL, f"mesh train step against the unsharded one: {cmp}")
    check(far / total <= MESH_FAR_SHARE, f"mesh train parameters: {cmp}")
    check(n == 4, f"mesh train: {n} attention launches in 2 steps, expected one a slot a step")
    out["train_data2"] = cmp
    launches["flash_attention"]["mesh_train"] = n
    part_done("train")

    # --- the mesh Trainer on graphs against its eager twin, bit for bit
    # (cuDNN's deterministic algorithms on both sides), in f32 and in bf16;
    # then the steps timed in turns; then again with the data axis's
    # collectives in the step: a process group of one rank on NCCL
    def train_pair(dtype):
        tcfg = TrainConfig(**{**TRAIN_RECIPE, "batch_size": MESH_TRAIN_BATCH, "compute_dtype": dtype,
                              "total_steps": 40, "warmup_steps": 1})
        return _train_pair(tcfg, warm_start=True, mesh=make_mesh(slots[:2], data=2))

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    sock = socket.socket()
    sock.bind(("localhost", 0))
    env = {"JAX_COORDINATOR": f"localhost:{sock.getsockname()[1]}", "JAX_NUM_PROCESSES": "1", "JAX_PROCESS_ID": "0"}
    sock.close()
    saved = {k: os.environ.get(k) for k in env}
    try:
        for dtype_name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            graph_t, eager_t = train_pair(dtype)
            rows = _train_compare(torch, graph_t, eager_t, MESH_TRAIN_COMPARE_STEPS, launches_per_step=2)
            times: dict = {"eager": [], "graph": []}
            for mode in ("eager", "graph", "graph", "eager"):
                times[mode] += _timed_steps(torch, graph_t if mode == "graph" else eager_t,
                                            MESH_TRAIN_TIMED_STEPS)["step_ms"]
            cmp = {"steps": rows, "exec_stats": graph_t.exec_stats(),
                   "step_ms": {mode: statistics.median(t) for mode, t in times.items()}}
            print(json.dumps({f"mesh_train_graph_{dtype_name}": cmp}), flush=True)
            check(cmp["exec_stats"]["graphs"] > 0 and cmp["exec_stats"]["eager_executables"] == 0,
                  f"the mesh train step was not captured: {cmp['exec_stats']}")
            out[f"train_graph_{dtype_name}"] = cmp
            del graph_t, eager_t
        part_done("train_graphs")

        # the data axis across processes: a group of one rank on NCCL
        os.environ.update(env)
        check(maybe_initialize_distributed() and maybe_initialize_distributed(), "no process group")
        value = torch.full((4,), 3.0, device="cuda")
        dist.all_reduce(value)
        group = {"backend": dist.get_backend(), "world_size": dist.get_world_size(), "all_reduce": float(value[0])}
        graph_t, eager_t = train_pair(torch.bfloat16)
        rows = _train_compare(torch, graph_t, eager_t, MESH_NCCL_STEPS, launches_per_step=2)
        group["train_graph"] = {"steps": len(rows), "loss": rows[-1]["loss_graph"], "exec_stats": graph_t.exec_stats()}
        del graph_t, eager_t
        dist.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic = deterministic
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    print(json.dumps({"mesh_process_group": group}), flush=True)
    check({k: group[k] for k in ("backend", "world_size", "all_reduce")}
          == {"backend": "nccl", "world_size": 1, "all_reduce": 3.0}, f"process group {group}")
    check(group["train_graph"]["exec_stats"]["graphs"] > 0, f"the NCCL mesh step was not captured: {group}")
    out["process_group"] = group
    torch.cuda.empty_cache()
    part_done("process_group")
    out["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"mesh_phase": {"seconds": out["seconds"], "parts_s": out["parts_s"],
                                     "surfaces_graph_vs_eager": len(out["graph_vs_eager"]),
                                     "restore_512_b8_single_ms": out["restore_512_b8_single_ms"],
                                     "restore_512_b8_single_profile": out["restore_512_b8_single_profile"],
                                     "f32_unsharded_b2_vs_b8": out["f32_unsharded_b2_vs_b8"]}}), flush=True)
    report["mesh"] = out
    return launches


# the graph phase: the executable tier's CUDA graphs against eager execution
# (serve/exec_cache.py). The surfaces warmup_serving builds at the default
# buckets; sr-x4 goes through the same programs as sr-x2 and is left out.
GRAPH_WARM_FAMILIES = ("restore-unet", "diffusion-restore", "sr-x2", "fusion")
# a surface whose graph may differ from eager execution by 1 level, with the
# op whose library algorithm differs under capture: none, every surface is
# held equal in bytes
GRAPH_LEVEL_EXCEPTIONS: dict = {}
GRAPH_STEP_REPS = 5
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def _graph_inputs(np, imageio, motion_psf, size: int) -> dict:
    """Canvases at ``size``: a clean photo, a blocky JPEG (deblock fires) and
    a motion blur (the veto's gate and deblur fire), as phase 3 builds them."""
    u8 = lambda x: np.clip(np.round(x * 255.0), 0, 255).astype(np.uint8)  # noqa: E731
    jpeg = imageio.decode_image(imageio.encode_jpeg(u8(_photo(np, 3, size)), quality=15)).pixels
    return {"clean": u8(_photo(np, 1, size)), "jpeg": np.ascontiguousarray(jpeg),
            "blur": u8(_motion_blur(np, _photo(np, 2, size), motion_psf(9.0, 0.9)))}


def _graph_batches(np, images: dict, batch: int) -> dict:
    """{name: (canvas, is_jpeg)} of ``batch`` images: clean photos, and
    batches that fire the stages (the JPEG and the blur together, or one
    each at batch 1)."""
    def of(names):
        names = (list(names) * batch)[:batch]
        return (np.stack([images[n] for n in names]),
                np.asarray([1.0 if n == "jpeg" else 0.0 for n in names], np.float32))

    if batch == 1:
        return {"clean": of(["clean"]), "fire_jpeg": of(["jpeg"]), "fire_blur": of(["blur"])}
    return {"clean": of(["clean"]), "fire": of(["jpeg", "blur", "clean"])}


def _arrays(result) -> list:
    """The numpy arrays of a surface's result, in order, meta left out."""
    out = []
    for item in result if isinstance(result, tuple) else (result,):
        if isinstance(item, tuple):
            out.extend(item)
        elif hasattr(item, "dtype"):
            out.append(item)
    return out


def _step_profile(torch, fn, step_ms: float, skip: tuple = ("restore/", "sr_tiled/", "sr_spatial/")) -> dict:
    """One profiled call: kernel ms on the card, kernels run, the host's
    kernel-launch calls and graph launches, and the idle share against the
    unprofiled step time (annotation ranges named with a ``skip`` prefix
    are not kernels)."""
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
    with prof:
        fn()
    busy, count, split, _ = _kernel_split(torch, prof, skip=skip)
    events = prof.key_averages()
    return {"kernel_ms": busy if count else "not measured", "kernels": count, "by_kind_ms": split,
            "host_kernel_launches": sum(e.count for e in events if e.key in LAUNCH_APIS),
            "host_graph_launches": sum(e.count for e in events if e.key == "cudaGraphLaunch"),
            "device_idle_share": 1.0 - busy / step_ms if count else "not measured"}


def _eager_graph_steps(torch, run, engines: dict, reps: int) -> dict:
    """``run(e)`` timed on the "eager" and the "graph" engine in turns
    (eager, graph, graph, eager), ``reps`` calls a turn after one untimed
    call, then one profiled call of each: {mode: step ms and profile}."""
    times: dict = {"graph": [], "eager": []}
    for mode in ("eager", "graph", "graph", "eager"):
        run(engines[mode])
        for _ in range(reps):
            t = time.perf_counter()
            run(engines[mode])
            times[mode].append(1e3 * (time.perf_counter() - t))
    out = {}
    for mode in ("eager", "graph"):
        step = statistics.median(times[mode])
        out[mode] = {"step_ms": step, **_step_profile(torch, lambda: run(engines[mode]), step)}
    return out


def phase_graphs(torch, np, report, card, engine):
    """The executable tier on the card: graph replay against eager execution
    of the same programs on every surface ``warmup_serving`` built (phase 3's
    engine, warmed at the default buckets), on batches that fire the stages
    and on batches that fire none, bytes, scores and the kernels' launches
    equal, with no build in any of it; then eager and graph step times taken
    in turns (eager, graph, graph, eager) at 256 b1, 512 b8 and sr_tiled
    2048, each with one profiled step."""
    from image_restoration_platform_tpu_torch import imageio
    from image_restoration_platform_tpu_torch.obs.metrics import get_counters
    from image_restoration_platform_tpu_torch.ops.cuda.attention import flash_kernel
    from image_restoration_platform_tpu_torch.ops.cuda.blend import blend_kernel
    from image_restoration_platform_tpu_torch.ops.deblur import disk_psf, motion_psf
    from image_restoration_platform_tpu_torch.serve import RestorationEngine
    from image_restoration_platform_tpu_torch.serve.programs import sr as sr_programs

    t_phase = time.perf_counter()
    cfg = engine.config
    eager = RestorationEngine(device="cuda", dtype=engine.dtype, serving_config=cfg,
                              param_cache=engine.params_cache, eager=True)
    check(not engine.eager and eager.eager, "the graph engine must replay graphs and its twin run eagerly")
    counters = get_counters()
    rows: list = []
    launches = {"flash_attention": 0, "blend_tiles": 0}
    gn = _gn_kernels()

    def compare(surface: str, run) -> None:
        """``run(e)`` on the graph engine, then on the eager twin: equal
        arrays and equal launches of every kernel (attention, blend, the
        two fused GroupNorm kernels)."""
        _zero_launches(flash_kernel)
        _zero_launches(blend_kernel)
        _zero_gn()
        got = _arrays(run(engine))
        graph_n = (_read_launches("flash_attention", flash_kernel), _read_launches("blend_tiles", blend_kernel),
                   *(_read_launches(name, kernel) for name, kernel in gn.items()))
        _zero_launches(flash_kernel)
        _zero_launches(blend_kernel)
        _zero_gn()
        want = _arrays(run(eager))
        eager_n = (flash_kernel.launches, blend_kernel.launches, *(kernel.launches for kernel in gn.values()))
        launches["flash_attention"] += graph_n[0]
        launches["blend_tiles"] += graph_n[1]
        for name, n in zip(gn, graph_n[2:]):
            GN_PATH_LAUNCHES[name]["graphs"] = GN_PATH_LAUNCHES[name].get("graphs", 0) + n
        levels = max(int(np.abs(a.astype(np.float64) - b.astype(np.float64)).max()) if a.dtype == np.uint8 else 0
                     for a, b in zip(got, want))
        rows.append({"surface": surface, "equal": all(np.array_equal(a, b) for a, b in zip(got, want)),
                     "max_levels": levels, "launches_graph": graph_n, "launches_eager": eager_n})

    builds = engine.compile_count
    fires_before = counters.snapshot()
    for size in cfg.size_buckets:
        images = _graph_inputs(np, imageio, motion_psf, size)
        for batch in (1, 2, 4, 8):
            for name, (canvas, is_jpeg) in _graph_batches(np, images, batch).items():
                compare(f"restore-unet/{size}/b{batch}/{name}",
                        lambda e, c=canvas, j=is_jpeg: e.restore_batch(c, is_jpeg=j))

                def diffusion(e, c=canvas, j=is_jpeg):
                    e._generator.manual_seed(size + batch)  # both engines draw the same noise
                    return e.restore_batch(c, is_jpeg=j, family_name="diffusion-restore")

                compare(f"diffusion-restore/{size}/b{batch}/{name}", diffusion)
        triple = np.stack([images[n] for n in ("clean", "jpeg", "blur")])
        compare(f"fusion/k3/{size}", lambda e, c=triple: e.fuse_batch(
            c, np.tile([[size, size]], (3, 1)).astype(np.int32), np.asarray([0, 1, 0], np.float32)))
        if size <= sr_programs.DIRECT_MAX:
            compare(f"sr-x2/direct/{size}", lambda e, c=images["clean"]: e.sr_batch(c[None], "sr-x2"))
    canvas2048 = _photo_large(np, 11, 2048, 2048)
    for output in ("rgb", "yuv420"):
        compare(f"sr-x2/tiled-{output}/2048", lambda e, o=output: e.sr_tiled(canvas2048, "sr-x2", output=o))
    fires = _counter_delta(fires_before, counters.snapshot())
    out = {"card": card, "compile_count_after_warmup": builds, "compile_count_after_serving": engine.compile_count,
           "executables": engine.exec_stats(), "stage_fires_graph_and_eager": {
               k: v for k, v in fires.items() if k.startswith("stage_fires.")}}
    # the HDR pre-pass (not a warmed surface: built here), firing and not
    for size in (256, 512):
        blurred = np.clip(_motion_blur(np, _cells(np, np.random.default_rng(2), size), disk_psf(HDR_RADIUS)), 0, 1)
        for name, x in (("fire", blurred), ("clean", _cells(np, np.random.default_rng(4), size))):
            canvas = (np.round(x * 65535.0) / 65535.0).astype(np.float32)[None]
            compare(f"hdr_deblur/{size}/{name}", lambda e, c=canvas: e.hdr_deblur_batch(
                c, np.asarray([[size, size]], np.int32), np.zeros((1,), np.float32)))
    out["surfaces"] = len(rows)
    out["differing"] = [r for r in rows if not r["equal"]]
    out["launches_differing"] = [r for r in rows if r["launches_graph"] != r["launches_eager"]]
    out["launches_graph"] = launches
    out["compare_s"] = time.perf_counter() - t_phase

    # --- eager and graph step times in turns, one profiled step of each
    steps = {}
    photos = {s: np.clip(np.round(_photo(np, 1, s) * 255.0), 0, 255).astype(np.uint8) for s in (256, 512)}
    cells = {
        "256_b1": lambda e: e.restore_batch(photos[256][None]),
        "512_b8": lambda e: e.restore_batch(np.repeat(photos[512][None], 8, axis=0)),
        "sr_tiled_2048": lambda e: e.sr_tiled(canvas2048, "sr-x2"),
    }
    for cell, fn in cells.items():
        steps[cell] = _eager_graph_steps(torch, fn, {"eager": eager, "graph": engine}, GRAPH_STEP_REPS)
        print(json.dumps({f"graph_step_{cell}": steps[cell]}), flush=True)
    out["steps"] = steps
    out["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"graph_phase": {k: v for k, v in out.items() if k != "steps"}}), flush=True)
    report["graphs"] = {**out, "rows": rows}

    check(out["compile_count_after_serving"] == builds,
          f"a warmed surface was built in a request: {builds} -> {out['compile_count_after_serving']} executables")
    for stage in ("deblock", "deblur_veto", "deblur"):
        check(fires.get(f"stage_fires.{stage}", 0) > 0, f"no batch of the graph phase fired {stage}: {fires}")
    for row in out["differing"]:
        op = next((op for prefix, op in GRAPH_LEVEL_EXCEPTIONS.items() if row["surface"].startswith(prefix)), None)
        check(op is not None and row["max_levels"] <= 1, f"graph replay differs from eager execution: {row}")
    check(not out["launches_differing"], f"graph and eager launches differ: {out['launches_differing']}")
    check(launches["flash_attention"] > 0 and launches["blend_tiles"] > 0, f"graph phase launches {launches}")
    check(all(GN_PATH_LAUNCHES[name].get("graphs", 0) > 0 for name in gn),
          f"graph phase: fused GroupNorm launches {GN_PATH_LAUNCHES}")
    return {"flash_attention": {"graphs": launches["flash_attention"]},
            "blend_tiles": {"graphs": launches["blend_tiles"]}}


# the quality and bench phase: every gate value of the card's bf16 run held
# to the port's CPU bf16 run on the same inputs. The bars are ~10x the gaps
# read on the card (NVIDIA H100 80GB HBM3, 700 W): OOD gains within 0.0014 dB,
# in-distribution gains and PSNRs within 0.0082 dB, MADs and Laplacian
# energies within 0.0011 levels of 255.
QUALITY_CPU_DB = {"ood": 0.02, "in_distribution": 0.1}
QUALITY_CPU_LEVELS = 0.02
QUALITY_FAMILIES = ("restore-unet", "sr-x2", "sr-x4", "diffusion-restore")
BENCH_TIMEOUT_S = 600


def _flat(values: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in values.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def quality_gaps(card: dict, cpu: dict, db_bar: float) -> dict:
    """{value: (|card - cpu|, bar)} for every gate value of a report: the
    MADs and Laplacian energies in levels, gains and PSNRs in dB."""
    card, cpu = _flat(card), _flat(cpu)
    return {k: (abs(card[k] - cpu[k]), QUALITY_CPU_LEVELS if k.endswith("_mad") or ".hf_" in k else db_bar)
            for k in card}


def phase_quality_bench(torch, np, report, card):
    """The quality gates of tests/test_quality*.py on the card in bf16 with
    the shipped weights (eval/gates.py), the attention kernel's launches
    counted from 0: the OOD gates at their own seeds and sizes; the
    in-distribution gates on the port's own draws at the gate seeds (made on
    the CPU, so the CPU run sees the same numbers); every value of both
    within its bar (QUALITY_CPU_DB, QUALITY_CPU_LEVELS) of the port's CPU
    bf16 run on the same inputs; then the bench entry in a subprocess, whose
    headline must parse with a positive value, an mfu in (0, 1], a VALID
    stamp and both kernels launched."""
    from image_restoration_platform_tpu_torch.eval import gates as G
    from image_restoration_platform_tpu_torch.eval.common import load_model
    from image_restoration_platform_tpu_torch.ops.cuda.attention import flash_kernel

    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    out: dict = {"card": card}

    def gates_on(device):
        return {name: load_model(name, device, bf16) for name in QUALITY_FAMILIES}

    card_models = gates_on("cuda")
    forwards = [0]  # UNet forwards at 128 px: one attention launch each ([8, 4, 256, 64], diffusion [8, 4, 1024, 64])
    hooks = [card_models[name].register_forward_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
             for name in ("restore-unet", "diffusion-restore")]
    t = time.perf_counter()
    _zero_launches(flash_kernel)
    _zero_gn()
    ood = G.ood_report("restore-unet", card_models["restore-unet"], bf16)
    indist = G.in_distribution_report(card_models, bf16, "cuda")
    launches = _read_launches("flash_attention", flash_kernel)
    out["fused_norm_launches"] = _read_gn("quality_gates")
    out["card_s"] = time.perf_counter() - t
    for hook in hooks:
        hook.remove()
    t = time.perf_counter()
    cpu_models = gates_on("cpu")
    ood_cpu = G.ood_report("restore-unet", cpu_models["restore-unet"], bf16)
    indist_cpu = G.in_distribution_report(cpu_models, bf16, "cpu")
    out["cpu_s"] = time.perf_counter() - t
    gaps = {**quality_gaps(ood, ood_cpu, QUALITY_CPU_DB["ood"]),
            **quality_gaps(indist, indist_cpu, QUALITY_CPU_DB["in_distribution"])}
    out.update(ood=ood, ood_cpu=ood_cpu, in_distribution=indist, in_distribution_cpu=indist_cpu,
               card_vs_cpu={k: gap for k, (gap, _bar) in gaps.items()}, attention_launches=launches,
               unet_forwards=forwards[0])
    print(json.dumps({"quality": {k: out[k] for k in ("ood", "ood_cpu", "in_distribution", "in_distribution_cpu",
                                                      "card_vs_cpu", "attention_launches", "unet_forwards",
                                                      "card_s", "cpu_s")}}), flush=True)
    failures = G.ood_failures(ood) + G.in_distribution_failures(indist)
    check(not failures, f"quality gates missed on the card: {failures}")
    off = {k: v for k, v in gaps.items() if not v[0] <= v[1]}
    check(not off, f"card gate values off the CPU's by more than their bars (gap, bar): {off}")
    check(forwards[0] > 0 and launches == forwards[0],
          f"attention launches {launches} != UNet forwards {forwards[0]} in the quality gates")

    # --- the bench entry, as a user runs it: one headline line on stdout
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"{PKG}.bench"], cwd=REPO, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT_S)
    out["bench_s"] = time.perf_counter() - t
    for line in proc.stderr.strip().splitlines()[-12:]:
        print(f"  bench: {line}", flush=True)
    check(proc.returncode == 0, f"bench exited {proc.returncode}: {proc.stderr[-2000:]}")
    head = json.loads(proc.stdout.strip().splitlines()[-1])
    detail = head["detail"]
    out["bench"] = head
    print(json.dumps({"bench": head}), flush=True)
    check(head["metric"] == "images_per_sec_per_chip_512px_single_restore_e2e" and head["value"] > 0,
          f"bench headline {head}")
    check(detail["mfu"] is not None and 0.0 < detail["mfu"] <= 1.0, f"bench mfu {detail['mfu']}")
    check(detail["validity"]["status"] == "VALID", f"bench validity {detail['validity']}")
    check(detail["launches"]["flash_attention"] >= 1 and detail["launches"]["blend_tiles"] >= 1,
          f"bench kernel launches {detail['launches']}")
    for name, n in detail["fused_norm_launches"].items():
        GN_PATH_LAUNCHES[name]["bench"] = n
        check(n >= 1, f"bench fused GroupNorm launches {detail['fused_norm_launches']}")
    out["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"quality_bench_phase": {k: out[k] for k in ("seconds", "card_s", "cpu_s", "bench_s")}}),
          flush=True)
    report["quality_bench"] = out
    return {"flash_attention": {"quality_gates": launches, "bench": detail["launches"]["flash_attention"]},
            "blend_tiles": {"bench": detail["launches"]["blend_tiles"]}}


def phase_throughput(torch, np, report, svc, engine, reqs, card):
    from image_restoration_platform_tpu_torch import imageio
    from image_restoration_platform_tpu_torch.obs.metrics import get_counters

    out = {"card": card}
    # 256 b1: one request at a time
    data = reqs["clean256"][0]
    for _ in range(3):
        svc.restore(data)
    lat = []
    t0 = time.perf_counter()
    for _ in range(60):
        t = time.perf_counter()
        check(svc.restore(data)["success"], "256 b1 request failed")
        lat.append(time.perf_counter() - t)
    out["256_b1"] = {"images_per_s": len(lat) / (time.perf_counter() - t0), "p50_ms": 1e3 * statistics.median(lat)}

    # 512 b8: with two batches in flight (pipeline_depth 2), sixteen clients
    # sending back to back keep batches of eight forming
    data = reqs["clean512"][0]
    counters = get_counters()
    clients, rounds = 16, 8
    barrier = threading.Barrier(clients)
    lat512: list[float] = []
    lock = threading.Lock()

    def client():
        barrier.wait()
        for _ in range(rounds):
            t = time.perf_counter()
            check(svc.restore(data)["success"], "512 b8 request failed")
            with lock:
                lat512.append(time.perf_counter() - t)

    for warm in (True, False):
        lat512.clear()
        before = counters.snapshot()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=clients) as pool:
            for f in [pool.submit(client) for _ in range(clients)]:
                f.result()
        wall = time.perf_counter() - t0
        after = counters.snapshot()
    batches = after.get("restore_batches.512", 0) - before.get("restore_batches.512", 0)
    out["512_b8"] = {"images_per_s": len(lat512) / wall, "p50_ms": 1e3 * statistics.median(lat512),
                     "mean_batch": len(lat512) / max(batches, 1)}

    # the engine alone: host clock around restore_batch, which ends in the
    # fetch; with the stages' host syncs and fire counts a step
    dec = {s: imageio.decode_image(reqs[f"clean{s}"][0]).pixels for s in (256, 512)}
    for size, batch in ((256, 1), (512, 8)):
        canvas = np.repeat(dec[size][None], batch, axis=0)
        for _ in range(2):
            engine.restore_batch(canvas, egress="yuv420")
        before = counters.snapshot()
        times = []
        for _ in range(10):
            t = time.perf_counter()
            engine.restore_batch(canvas, egress="yuv420")
            times.append(time.perf_counter() - t)
        delta = _counter_delta(before, counters.snapshot())
        out[f"engine_{size}_b{batch}_ms"] = 1e3 * statistics.median(times)
        out[f"engine_{size}_b{batch}_per_step"] = {
            k: v / 10 for k, v in delta.items() if k.startswith(("host_syncs.", "stage_fires."))}

    # where the device time goes in one engine step of each cell: kernel
    # time from the profiler (the step's own annotation range excluded), idle
    # share against the unprofiled step time above
    self_us = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))  # noqa: E731
    cuda = torch.autograd.DeviceType.CUDA
    for size, batch in ((256, 1), (512, 8)):
        canvas = np.repeat(dec[size][None], batch, axis=0)
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        )
        with prof:
            engine.restore_batch(canvas, egress="yuv420")
        kernels = sorted(
            (e for e in prof.key_averages()
             if e.device_type == cuda and self_us(e) > 0 and not e.key.startswith("restore/")),
            key=self_us, reverse=True,
        )
        busy_ms = sum(self_us(e) for e in kernels) / 1e3
        step_ms = out[f"engine_{size}_b{batch}_ms"]
        out[f"profile_{size}_b{batch}"] = {
            "kernel_ms_total": busy_ms if kernels else "not measured",
            "kernel_launches": sum(e.count for e in kernels),
            "attention_kernel_ms": sum(self_us(e) for e in kernels if "flash_fwd" in e.key) / 1e3,
            "device_idle_share": 1.0 - busy_ms / step_ms if kernels else "not measured",
            "top": [{"name": e.key[:90], "device_ms": self_us(e) / 1e3, "count": e.count} for e in kernels[:15]],
        }
    print(json.dumps({"throughput": {k: v for k, v in out.items() if not k.startswith("profile_")}}), flush=True)
    for key in ("profile_256_b1", "profile_512_b8"):
        print(json.dumps({key: {**out[key], "top": out[key]["top"][:6]}}), flush=True)
    report["throughput"] = out


def phase_sr_throughput(torch, np, report, svc, engine, sr_reqs, card):
    """Warm wall time of one 2048 -> 4096 sr-x2 request and of
    ``engine.sr_tiled`` alone, the step's parts timed apart on the card, and
    the profiler's split of one step."""
    from image_restoration_platform_tpu_torch import imageio
    from image_restoration_platform_tpu_torch.models import srnet
    from image_restoration_platform_tpu_torch.ops import tile as T
    from image_restoration_platform_tpu_torch.ops.cuda.blend import blend_kernel
    from image_restoration_platform_tpu_torch.serve.programs.egress import to_yuv420

    out = {"card": card}
    data = sr_reqs["sr2048"][0]
    lat, dev = [], []
    for _ in range(4):
        t = time.perf_counter()
        res = svc.restore(data, options={"model": "sr-x2"})
        lat.append(time.perf_counter() - t)
        check(res["success"], "2048 sr-x2 request failed")
        dev.append(res["metadata"]["deviceSeconds"])
    out["request_2048_ms"] = 1e3 * statistics.median(lat)
    out["request_2048_engine_ms"] = 1e3 * statistics.median(dev)

    canvas = imageio.decode_image(data).pixels
    for output in ("rgb", "yuv420"):
        times = []
        for _ in range(5):
            t = time.perf_counter()
            engine.sr_tiled(canvas, "sr-x2", output=output)
            times.append(time.perf_counter() - t)
        out[f"sr_tiled_2048_{output}_ms"] = 1e3 * statistics.median(times)

    # the step's parts, each alone on the card at the step's shapes: eleven
    # SRNet forwards of eight 256 tiles (limiter inside), of which the limiter
    # alone; one blend; one egress
    model = engine.model("sr-x2")
    cfg = model.config
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.rand((8, 256, 256, 3), generator=gen, device="cuda").to(engine.dtype)
    forwards = -(-81 // 8)
    with torch.inference_mode():
        net_out = model(x)
        raw = (net_out + 0.01 * torch.randn(net_out.shape, generator=gen, device="cuda")).to(engine.dtype)
        blended = torch.rand((4096, 4096, 3), generator=gen, device="cuda") * 255.0
        forward_ms = time_ms(torch, lambda: model(x), groups=5, calls=3)
        limiter_ms = time_ms(torch, lambda: srnet.residual_limit(x, raw, cfg), groups=5, calls=3)
        rgb_ms = time_ms(torch, lambda: torch.round(torch.clamp(blended, 0.0, 255.0)).to(torch.uint8),
                         groups=5, calls=3)
        yuv_ms = time_ms(torch, lambda: to_yuv420(blended[None]), groups=5, calls=3)
    ys = T.tile_grid(2048, 256, 224)
    tiles = torch.rand((81, 512, 512, 3), generator=gen, device="cuda") * 255.0
    origins = tuple(y * 2 for y in ys)
    blend_ms = time_ms(torch, lambda: blend_kernel(tiles, (4096, 4096), origins, origins), groups=5, calls=3)
    del tiles, blended, raw, net_out
    out["parts_ms"] = {"srnet_forward_b8": forward_ms, "srnet_forwards": forwards,
                       "srnet_total": forwards * forward_ms,
                       "limiter_b8": limiter_ms, "limiter_total": forwards * limiter_ms,
                       "convolutions_and_rest_total": forwards * (forward_ms - limiter_ms),
                       "blend": blend_ms, "egress_rgb": rgb_ms, "egress_yuv420": yuv_ms}

    self_us = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))  # noqa: E731
    cuda = torch.autograd.DeviceType.CUDA
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    )
    with prof:
        engine.sr_tiled(canvas, "sr-x2", output="rgb")
    kernels = sorted(
        (e for e in prof.key_averages()
         if e.device_type == cuda and self_us(e) > 0 and not e.key.startswith("sr_tiled/")),
        key=self_us, reverse=True,
    )

    def kind(name: str) -> str:
        low = name.lower()
        if "blend_tiles_kernel" in low:
            return "blend"
        if "memcpy" in low or "memset" in low:
            return "copies"
        if any(k in low for k in ("conv", "gemm", "cudnn", "cutlass", "xmma", "implicit", "nhwc", "nchw")):
            return "convolutions"
        return "elementwise"

    split: dict = {}
    for e in kernels:
        split[kind(e.key)] = split.get(kind(e.key), 0.0) + self_us(e) / 1e3
    busy_ms = sum(split.values())
    step_ms = out["sr_tiled_2048_rgb_ms"]
    out["profile_sr_tiled_2048"] = {
        "kernel_ms_total": busy_ms if kernels else "not measured",
        "kernel_launches": sum(e.count for e in kernels),
        "by_kind_ms": split,
        "blend_kernel_ms": split.get("blend", 0.0),
        "device_idle_share": 1.0 - busy_ms / step_ms if kernels else "not measured",
        "top": [{"name": e.key[:90], "device_ms": self_us(e) / 1e3, "count": e.count} for e in kernels[:15]],
    }
    print(json.dumps({"sr_throughput": {k: v for k, v in out.items() if not k.startswith("profile_")}}), flush=True)
    print(json.dumps({"profile_sr_tiled_2048": {**out["profile_sr_tiled_2048"],
                                                "top": out["profile_sr_tiled_2048"]["top"][:8]}}), flush=True)
    report["sr_throughput"] = out


# the fold phase: the W-fold serving layout (models/folded.py) against the
# unfolded programs, both on CUDA graphs after their own warm-up. The bars on
# bytes are the reference's (tests/test_folded.py): SR in bf16 at most 2
# levels, under 1 % of the pixels above 1 and 25 % above 0; the transform
# itself in an f32 pair, at most 1 level on under 2 % of the pixels (SR:
# 25 %). The surfaces that run the full-width UNet (restore, diffusion,
# fusion) are held in bf16 to the bf16 bar above, as the card against the
# CPU is: in bf16 a rare pixel of the flagship's output moves by up to ~30
# levels under any change of summation order (folded or not, another batch
# size), so the reference's bf16 fusion bar (2 levels, set on
# restore-unet-small at 32 px and held there by tests/test_torch_folded.py)
# does not hold at full width: 6 levels on 0.03 % of the pixels, 1 in f32
FOLD_STEPS = 24  # timed calls of each engine a surface, the two in alternation
FOLD_SIZES = {"small": 256, "large": 512, "sr_direct": 384, "sr_tiled": 2048}
FOLD_BF16_BAR = (2, 0.01, 0.25)  # max levels, share above 1, share above 0
FOLD_F32_BAR = (1, 0.02)  # max levels, share above 0
# the surfaces also run on the CPU (the tiled 2048 canvas and the sampler's
# noise, drawn on the card, are left out there)
FOLD_CPU_SURFACES = ("restore/small/fire", "restore/small/clean", "restore/large/fire", "fusion/large",
                     "sr-x2/direct")


def _fold_levels(np, a, b) -> dict:
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return {"mean_levels": float(d.mean()), "max_levels": int(d.max()),
            "p99.9_levels": float(np.percentile(d, 99.9)), "above0": float((d > 0).mean()),
            "above1": float((d > 1).mean())}


def _fold_surfaces(np, imageio, motion_psf) -> dict:
    """{surface: (run(engine), kind, the hand kernel it launches)} at
    FOLD_SIZES: restore at the small size b1 and the large b8, each on a
    firing and a clean batch; diffusion at the small size; fusion k3 at the
    large; sr-x2 direct and tiled (2048 -> 4096)."""
    small, large = FOLD_SIZES["small"], FOLD_SIZES["large"]
    u8 = lambda x: np.clip(np.round(x * 255.0), 0, 255).astype(np.uint8)  # noqa: E731
    b_small = _graph_batches(np, _graph_inputs(np, imageio, motion_psf, small), 1)
    i_large = _graph_inputs(np, imageio, motion_psf, large)
    b_large = _graph_batches(np, i_large, 8)
    triple = np.stack([i_large[n] for n in ("clean", "jpeg", "blur")])
    valid3, jpeg3 = np.tile([[large, large]], (3, 1)).astype(np.int32), np.asarray([0, 1, 0], np.float32)
    direct = u8(_photo(np, 5, FOLD_SIZES["sr_direct"]))[None]
    tiled = _photo_large(np, 11, FOLD_SIZES["sr_tiled"], FOLD_SIZES["sr_tiled"])

    def restore(batch):
        return lambda e: e.restore_batch(batch[0], is_jpeg=batch[1])

    def diffusion(e):
        e._generator.manual_seed(small)  # both engines draw the same noise
        return e.restore_batch(b_small["clean"][0], is_jpeg=b_small["clean"][1], family_name="diffusion-restore")

    return {
        "restore/small/fire": (restore(b_small["fire_jpeg"]), "restore", "flash_attention"),
        "restore/small/clean": (restore(b_small["clean"]), "restore", "flash_attention"),
        "restore/large/fire": (restore(b_large["fire"]), "restore", "flash_attention"),
        "restore/large/clean": (restore(b_large["clean"]), "restore", "flash_attention"),
        "diffusion/small": (diffusion, "restore", "flash_attention"),
        "fusion/large": (lambda e: e.fuse_batch(triple, valid3, jpeg3), "fusion", "flash_attention"),
        "sr-x2/direct": (lambda e: e.sr_batch(direct, "sr-x2"), "sr", None),
        "sr-x2/tiled": (lambda e: e.sr_tiled(tiled, "sr-x2"), "sr", "blend_tiles"),
    }


def _fold_warmup(engine) -> dict:
    """``warmup_serving`` of every surface the fold phase drives."""
    t = time.perf_counter()
    engine.warmup_serving(families=("restore-unet",), sizes=(FOLD_SIZES["small"], FOLD_SIZES["large"]),
                          batches=(1, 8))
    engine.warmup_serving(families=("diffusion-restore",), sizes=(FOLD_SIZES["small"],), batches=(1,))
    engine.warmup_serving(families=("fusion",), sizes=(FOLD_SIZES["large"],))
    engine.warmup_serving(families=("sr-x2",), sizes=(FOLD_SIZES["sr_direct"],), sr_tiled_canvas=FOLD_SIZES["sr_tiled"])
    return {"s": time.perf_counter() - t, **engine.exec_stats()}


def phase_fold(torch, np, report, card):
    """The W-fold on the card (FOLD_SIZES): one bf16 engine with ``fold_w`` and
    ``fold_w_sr`` on and one with both off, shipped weights, full width and
    depth, both on CUDA graphs after ``warmup_serving``; on every surface of
    ``_fold_surfaces`` the folded bytes against the unfolded ones at the
    reference's bars, the attention and blend launches equal (and above 0
    where the surface launches the kernel), ``compile_count`` flat; the folded
    run against the port's unfolded CPU f32 run; an f32 engine pair (eager)
    on the restore and diffusion surfaces; then step times, the median of
    ``FOLD_STEPS`` calls of each engine taken in alternation, and one
    profiled step of each; and the defaults the card's times argue for."""
    from image_restoration_platform_tpu_torch import imageio
    from image_restoration_platform_tpu_torch.config import ServingConfig
    from image_restoration_platform_tpu_torch.models.folded import FoldedSRNet, FoldedUNet
    from image_restoration_platform_tpu_torch.ops.cuda.attention import flash_kernel
    from image_restoration_platform_tpu_torch.ops.cuda.blend import blend_kernel
    from image_restoration_platform_tpu_torch.ops.deblur import motion_psf
    from image_restoration_platform_tpu_torch.serve import RestorationEngine

    t_phase = time.perf_counter()
    fails: list = []  # every bar is read before the phase fails, so one run shows them all

    def hold(cond: bool, message: str) -> None:
        if not cond:
            fails.append(message)
            print(f"fold phase: FAILED: {message}", flush=True)

    base = ServingConfig(size_buckets=(FOLD_SIZES["small"], FOLD_SIZES["large"]), max_batch=8)
    cfgs = {"folded": dataclasses.replace(base, fold_w=True, fold_w_sr=True),
            "unfolded": dataclasses.replace(base, fold_w=False, fold_w_sr=False)}
    engines: dict = {}
    for name, cfg in cfgs.items():
        cache = engines["folded"].params_cache if engines else None
        engines[name] = RestorationEngine(device="cuda", dtype=torch.bfloat16, serving_config=cfg, param_cache=cache)
    out: dict = {"card": card, "warmup": {name: _fold_warmup(e) for name, e in engines.items()}, "surfaces": {}}
    builds = {name: e.compile_count for name, e in engines.items()}
    folded_models = {f: engines["folded"].model(f) for f in ("restore-unet", "diffusion-restore", "sr-x2")}
    check(isinstance(folded_models["restore-unet"], FoldedUNet) and isinstance(folded_models["sr-x2"], FoldedSRNet)
          and isinstance(folded_models["diffusion-restore"], FoldedUNet),
          f"the folded engine's models: {[type(m).__name__ for m in folded_models.values()]}")
    check(not any(getattr(engines["unfolded"].model(f), "folded", False) for f in folded_models),
          "the unfolded engine serves a folded model")
    keys = {name: [k for k in e._exec_cache._built if ("fold_w", True) in k] for name, e in engines.items()}
    check(len(keys["folded"]) == builds["folded"] and not keys["unfolded"],
          f"executable keys and the fold: {len(keys['folded'])} folded keys of {builds['folded']}; "
          f"{len(keys['unfolded'])} in the unfolded engine")
    print(json.dumps({"fold_warmup": out["warmup"]}), flush=True)

    surfaces = _fold_surfaces(np, imageio, motion_psf)
    launches = {"flash_attention": 0, "blend_tiles": 0}
    results: dict = {}
    for surface, (run, kind, kernel) in surfaces.items():
        got, n = {}, {}
        for name, engine in engines.items():
            _zero_launches(flash_kernel)
            _zero_launches(blend_kernel)
            _zero_gn()
            got[name] = _arrays(run(engine))
            n[name] = (_read_launches("flash_attention", flash_kernel), _read_launches("blend_tiles", blend_kernel))
            if name == "folded":  # the folded UNet's fused GroupNorm launches (SR runs none)
                for gn_name, gn_kernel in _gn_kernels().items():
                    GN_PATH_LAUNCHES[gn_name]["fold"] = (GN_PATH_LAUNCHES[gn_name].get("fold", 0)
                                                         + _read_launches(gn_name, gn_kernel))
        results[surface] = got["folded"]
        u8 = [i for i, a in enumerate(got["folded"]) if a.dtype == np.uint8]
        levels = [_fold_levels(np, got["folded"][i], got["unfolded"][i]) for i in u8]
        scores = [float(np.abs(got["folded"][i] - got["unfolded"][i]).max()) for i in range(len(got["folded"]))
                  if i not in u8]
        row = {"kind": kind, "levels": levels, "scores_max_abs": max(scores, default=0.0),
               "launches": n, "kernel": kernel}
        launches["flash_attention"] += n["folded"][0]
        launches["blend_tiles"] += n["folded"][1]
        out["surfaces"][surface] = row
        print(json.dumps({"fold_bytes": {surface: row}}), flush=True)
        hold(n["folded"] == n["unfolded"], f"fold {surface}: launches {n}")
        for k, index in (("flash_attention", 0), ("blend_tiles", 1)):
            hold((n["folded"][index] > 0) == (kernel == k), f"fold {surface}: {k} launches {n['folded'][index]}")
        hold(row["scores_max_abs"] <= CPU_SCORES_ATOL, f"fold {surface}: scores {row}")
        for lv in levels:
            if kind == "sr":
                hold(lv["max_levels"] <= FOLD_BF16_BAR[0] and lv["above1"] < FOLD_BF16_BAR[1]
                     and lv["above0"] < FOLD_BF16_BAR[2], f"fold {surface} against unfolded: {row}")
            else:  # the full-width UNet in bf16: the bf16 bar; the f32 pair below holds the transform
                hold(lv["mean_levels"] <= CPU_MEAN_LEVELS and lv["p99.9_levels"] <= CPU_P999_LEVELS,
                     f"fold {surface} against unfolded: {row}")

    # --- the folded card run against the port's unfolded CPU f32 run
    cpu = RestorationEngine(device="cpu", dtype=torch.float32, serving_config=cfgs["unfolded"],
                            param_cache=engines["folded"].params_cache)
    out["card_folded_vs_cpu_f32"] = {}
    for surface in FOLD_CPU_SURFACES:
        want = _arrays(surfaces[surface][0](cpu))
        cmp = [_fold_levels(np, a, b) for a, b in zip(results[surface], want) if a.dtype == np.uint8]
        out["card_folded_vs_cpu_f32"][surface] = cmp
        for lv in cmp:
            hold(lv["mean_levels"] <= CPU_MEAN_LEVELS and lv["p99.9_levels"] <= CPU_P999_LEVELS,
                 f"fold {surface}: the folded card run against the CPU's f32 {cmp}")
    del cpu
    print(json.dumps({"fold_card_vs_cpu_f32": out["card_folded_vs_cpu_f32"]}), flush=True)

    # --- an f32 engine pair on every surface: the transform itself, at the
    # reference's f32 bars (SR: under 25 % of the pixels above 0)
    f32 = {name: RestorationEngine(device="cuda", dtype=torch.float32, serving_config=cfg, eager=True,
                                   param_cache=engines["folded"].params_cache) for name, cfg in cfgs.items()}
    out["f32"] = {}
    for surface, (run, kind, _) in surfaces.items():
        a, b = (_arrays(run(f32[name]))[0] for name in ("folded", "unfolded"))
        lv = _fold_levels(np, a, b)
        out["f32"][surface] = lv
        hold(lv["max_levels"] <= FOLD_F32_BAR[0] and lv["above0"] < (0.25 if kind == "sr" else FOLD_F32_BAR[1]),
             f"fold {surface} in f32 against unfolded: {lv}")
    del f32
    torch.cuda.empty_cache()
    print(json.dumps({"fold_f32": out["f32"]}), flush=True)

    # --- step times in alternation, then one profiled step of each
    out["steps"] = {}
    skip = ("restore/", "fuse/", "sr/", "sr_tiled/")
    for surface, (run, _, _) in surfaces.items():
        times: dict = {"folded": [], "unfolded": []}
        for i in range(FOLD_STEPS):
            for name in (("folded", "unfolded") if i % 2 == 0 else ("unfolded", "folded")):
                t = time.perf_counter()
                run(engines[name])
                times[name].append(1e3 * (time.perf_counter() - t))
        row = {}
        for name, ts in times.items():
            q = statistics.quantiles(ts, n=4)
            step = statistics.median(ts)
            row[name] = {"step_ms": step, "iqr_ms": q[2] - q[0],
                         **_step_profile(torch, lambda e=engines[name]: run(e), step, skip=skip)}
        row["folded_over_unfolded"] = row["folded"]["step_ms"] / row["unfolded"]["step_ms"]
        out["steps"][surface] = row
        print(json.dumps({"fold_steps": {surface: row}}), flush=True)

    def verdict(surface: str) -> dict:
        r = out["steps"][surface]
        spread = max(r["folded"]["iqr_ms"], r["unfolded"]["iqr_ms"])
        delta = r["folded"]["step_ms"] - r["unfolded"]["step_ms"]
        return {"folded_ms": r["folded"]["step_ms"], "unfolded_ms": r["unfolded"]["step_ms"],
                "spread_ms": spread, "folded_minus_unfolded_ms": delta,
                "slower_beyond_spread": delta > spread, "faster_beyond_spread": -delta > spread}

    out["defaults"] = {"fold_w_sr": {**verdict("sr-x2/tiled"), "config": ServingConfig().fold_w_sr},
                       "fold_w": {**verdict("restore/large/clean"), "config": ServingConfig().fold_w}}
    out["defaults"]["fold_w_sr"]["card_says"] = not out["defaults"]["fold_w_sr"]["slower_beyond_spread"]
    out["defaults"]["fold_w"]["card_says"] = out["defaults"]["fold_w"]["faster_beyond_spread"]
    print(json.dumps({"fold_defaults": out["defaults"]}), flush=True)

    out["compile_count"] = {name: (builds[name], e.compile_count) for name, e in engines.items()}
    for name, (before, after) in out["compile_count"].items():
        hold(before == after, f"fold phase: the {name} engine built {after - before} executables after its warm-up")
    out["launches"] = launches
    hold(all(GN_PATH_LAUNCHES[name].get("fold", 0) > 0 for name in GN_PATH_LAUNCHES),
         f"fold: the folded UNet surfaces launched no fused GroupNorm kernel: {GN_PATH_LAUNCHES}")
    out["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"fold_phase": {k: out[k] for k in ("seconds", "launches", "compile_count")}}), flush=True)
    report["fold"] = {**out, "failed": fails}
    del engines
    torch.cuda.empty_cache()
    check(not fails, f"fold phase: {len(fails)} bars failed: {fails}")
    return {"flash_attention": {"fold": launches["flash_attention"]}, "blend_tiles": {"fold": launches["blend_tiles"]}}


# the promotion phase: the retrain-and-promote chain (retrain/) on the card,
# bf16, full width, the shipped weights. Reductions: each of the r5-anchor
# manifest's two chunks trains PROMOTION_TRAIN_STEPS steps (the manifest's
# 4000), and its min_remaining (1200 s) becomes PROMOTION_MIN_REMAINING_S
# under a cutoff PROMOTION_QUEUE_S ahead, so a payload that hangs ends
# inside the script's limit; the ranker scores at --n PROMOTION_RANK_N (its
# default 8); the gate runs at the reference's sizes (eval.quality 8 x 4
# seeds, eval.ood 48 a class)
PROMOTION_TRAIN_STEPS = 20
PROMOTION_QUEUE_S, PROMOTION_MIN_REMAINING_S = 480, 300
PROMOTION_RANK_N = 4
PROMOTION_FAMILY = "restore-unet"


def _payload_said(log_path: str) -> dict:
    """The context of the payload's last "training done" log line."""
    said = [line for line in open(log_path, errors="replace") if "training done" in line]
    check(bool(said), f"{log_path}: no 'training done' line")
    return json.loads(said[-1][said[-1].index("{"):])


def _payload_seconds(runner_log: str) -> dict:
    """Wall seconds of each payload's last attempt, from the runner's log
    (whole seconds: the log's clock)."""
    def clock(line):
        h, m, s = (int(x) for x in line.split(" ", 1)[0].split(":"))
        return 3600 * h + 60 * m + s

    starts, out = {}, {}
    for line in open(runner_log):
        msg = line.split(" ", 1)[1]
        name = msg.split(":", 1)[0]
        if ": start attempt " in msg:
            starts[name] = clock(line)
        elif ": rc=" in msg and name in starts:
            out[name] = (clock(line) - starts[name]) % 86400
    return out


def phase_promotion(torch, np, report, card):
    """The retrain-and-promote chain on the card with the shipped weights:

    1. the queue: a temporary staging directory seeded with a copy of
       weights/restore-unet.npz; the port's r5_anchor.json manifest with its
       IRP_WEIGHTS_DIR, skip_if and post pointed into that directory and
       TRAIN_STEPS cut to PROMOTION_TRAIN_STEPS (the recipe otherwise the
       manifest's: 128 b32, the r5-anchor mix, TRAIN_ANCHOR_COMP, warm
       start; ``python`` is this interpreter), run by
       ``retrain.chip_queue.Runner`` with the card probe "alive": both
       chunks end done, and each payload's "training done" line says the
       attention kernel launched (the payload is a subprocess: its count
       is read from its log);
    2. the ranker: ``rank_candidates --include-shipped`` over the directory
       at --n PROMOTION_RANK_N in this process: every candidate scored, no
       evaluation failed;
    3. the gate: ``validate_staging`` on a stage holding the ranker's
       winner (its row printed), then on a stage that is a byte copy of
       every npz under weights/ (the default family discovery): every
       family PROMOTEs with its gates green, no regression and no
       improvement beyond the tolerance, and the largest |staged - shipped|
       over the axes is printed: the card's check that the gate and the
       evaluations are deterministic enough to decide anything.

    The attention kernel's count is set to 0 before step 2 and read after
    step 3 (> 0). Each step's seconds and the phase's are printed beside
    the card's name and power limit; weights/ is unchanged (sha256)."""
    import glob
    import shutil
    import tempfile

    from image_restoration_platform_tpu_torch.ops.cuda.attention import flash_kernel
    from image_restoration_platform_tpu_torch.retrain import chip_queue, rank_candidates, validate_staging

    shipped_paths = sorted(glob.glob(os.path.join(REPO, "weights", "*.npz")))
    check(len(shipped_paths) == 5, f"weights/ holds {shipped_paths}")
    shipped_sha = {p: _sha256(p) for p in shipped_paths}
    flagship_npz = os.path.join(REPO, "weights", f"{PROMOTION_FAMILY}.npz")
    torch.cuda.empty_cache()
    out: dict = {"card": card, "train_steps": PROMOTION_TRAIN_STEPS, "rank_n": PROMOTION_RANK_N}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_promotion_")
    t_phase = time.perf_counter()
    try:
        # --- 1. the queue
        stage = os.path.join(tmp, "staging_anchor")
        os.makedirs(stage)
        shutil.copy(flagship_npz, stage)
        manifest = json.load(open(os.path.join(chip_queue.QUEUES, "r5_anchor.json")))
        for p in manifest:
            p["env"] = {**p["env"], "IRP_WEIGHTS_DIR": stage, "TRAIN_STEPS": str(PROMOTION_TRAIN_STEPS)}
            p["skip_if"] = p["skip_if"].replace(".staging_anchor", stage)
            p["post"] = p["post"].replace(".staging_anchor", stage)
            p["cmd"] = p["cmd"].replace("python ", f"{sys.executable} ", 1)
            p["min_remaining"] = PROMOTION_MIN_REMAINING_S
        logdir = os.path.join(tmp, "queue")
        t = time.perf_counter()
        chip_queue.Runner(manifest, time.time() + PROMOTION_QUEUE_S, logdir).run()
        out["queue_s"] = time.perf_counter() - t
        summary = json.load(open(os.path.join(logdir, "SUMMARY.json")))
        names = [p["name"] for p in manifest]
        if summary != {name: "done" for name in names}:
            for name in names:
                log_path = os.path.join(logdir, f"{name}.log")
                if os.path.exists(log_path):
                    print(f"  {name} log tail: {open(log_path, errors='replace').read()[-3000:]}", flush=True)
        check(summary == {name: "done" for name in names}, f"the queue's summary {summary}")
        said = {name: _payload_said(os.path.join(logdir, f"{name}.log")) for name in names}
        out["payload_wall_s"] = _payload_seconds(os.path.join(logdir, "runner.log"))
        out["payload_train_s"] = {name: s["seconds"] for name, s in said.items()}
        out["payload_attention_launches"] = {name: s["attentionLaunches"] for name, s in said.items()}
        out["payload_fused_norm_launches"] = {name: (s["gnMomentsLaunches"], s["gnAffineSiluLaunches"])
                                              for name, s in said.items()}
        for name, (moments, affine) in out["payload_fused_norm_launches"].items():
            check(moments > 0 and affine > 0, f"payload {name}: fused GroupNorm launches {moments}, {affine}")
        for name, s in said.items():
            check(s["steps"] == PROMOTION_TRAIN_STEPS and s["attentionLaunches"] >= PROMOTION_TRAIN_STEPS,
                  f"{name}: training done with {s}")
            check(os.path.exists(os.path.join(stage, f"{PROMOTION_FAMILY}.{name.split('_')[-1]}.npz")),
                  f"{name}: its post hook left no snapshot")
        print(json.dumps({"promotion_queue": {k: out[k] for k in ("queue_s", "payload_wall_s", "payload_train_s",
                                                                   "payload_attention_launches")},
                          "card": card}), flush=True)

        # --- 2. the ranker, in this process
        _zero_launches(flash_kernel)
        _zero_gn()
        t = time.perf_counter()
        results, failed = rank_candidates.rank(stage, PROMOTION_FAMILY, PROMOTION_RANK_N, True, "cuda")
        out["rank_s"] = time.perf_counter() - t
        candidates = sorted(f for f in os.listdir(stage) if f.startswith(PROMOTION_FAMILY) and f.endswith(".npz"))
        check(not failed, f"the ranker's evaluations failed for {failed}")
        check(sorted(r["candidate"] for r in results) == sorted(["__shipped__", *candidates]),
              f"the ranker scored {[r['candidate'] for r in results]} of {candidates}")
        out["rank"] = results
        out["rank_s_per_candidate"] = out["rank_s"] / len(results)
        print(json.dumps({"promotion_rank": [{k: r[k] for k in ("candidate", "score")} for r in results],
                          "rank_s": out["rank_s"], "card": card}), flush=True)

        # --- 3. the gate: the winner, then a byte copy of weights/
        winner = results[0]["candidate"]
        stage_w = os.path.join(tmp, "stage_winner")
        os.makedirs(stage_w)
        shutil.copy(flagship_npz if winner == "__shipped__" else os.path.join(stage, winner),
                    os.path.join(stage_w, f"{PROMOTION_FAMILY}.npz"))
        t = time.perf_counter()
        rows = validate_staging.validate(stage_w, device="cuda")
        out["gate_winner_s"] = time.perf_counter() - t
        out["gate_winner"] = {"candidate": winner, "rows": rows}
        print(json.dumps({"promotion_gate_winner": out["gate_winner"], "s": out["gate_winner_s"]}), flush=True)
        check([r["family"] for r in rows] == [PROMOTION_FAMILY], f"the winner's gate rows {rows}")

        stage_s = os.path.join(tmp, "stage_shipped")
        os.makedirs(stage_s)
        for path in shipped_paths:
            shutil.copy(path, stage_s)
        axes: dict = {}
        t = time.perf_counter()
        rows = validate_staging.validate(stage_s, device="cuda", axes=axes)
        out["gate_shipped_s"] = time.perf_counter() - t
        launches = _read_launches("flash_attention", flash_kernel)
        out["fused_norm_launches"] = _read_gn("promotion")
        deltas = {f"{fam}/{k}": abs(v["staged"][k] - v["shipped"][k])
                  for fam, v in axes.items() for k in v["shipped"] if k in v["staged"]}
        worst = max(deltas, key=deltas.get)
        out["gate_shipped"] = rows
        out["shipped_vs_shipped_max_delta"] = {"axis": worst, "delta": deltas[worst], "axes": len(deltas)}
        out["attention_launches"] = launches
        print(json.dumps({"promotion_gate_shipped": rows, "s": out["gate_shipped_s"],
                          "max_delta": out["shipped_vs_shipped_max_delta"]}), flush=True)
        families = sorted(os.path.basename(p)[: -len(".npz")] for p in shipped_paths)
        check([r["family"] for r in rows] == families, f"the gate found {[r['family'] for r in rows]}")
        for r in rows:
            check(r["verdict"] == "PROMOTE" and r["gates_green"] and not r["gate_failures"]
                  and not r["regressions"] and not r["improvements"], f"a byte copy of weights/ did not PROMOTE: {r}")
        check(launches > 0, "the ranker and the gate launched no attention kernel")
        out["seconds"] = time.perf_counter() - t_phase
        print(json.dumps({"promotion_phase": {k: out[k] for k in (
            "seconds", "queue_s", "rank_s", "rank_s_per_candidate", "gate_winner_s", "gate_shipped_s",
            "attention_launches")}, "card": card}), flush=True)
        report["promotion"] = out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check({p: _sha256(p) for p in shipped_paths} == shipped_sha, "the phase changed weights/")
    torch.cuda.empty_cache()
    return {"promotion": launches, "promotion_queue": sum(out["payload_attention_launches"].values())}


def main() -> int:
    parser = argparse.ArgumentParser(description="Drive the PyTorch/CUDA port on one NVIDIA card.")
    parser.add_argument("--report", help="also write the full report as JSON to this path")
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after the kernels' build and checks; prints no result lines")
    parser.add_argument("--plan-sweep", action="store_true",
                        help="after the kernels' checks, time every attention plan the wrapper weighs at "
                             "every launched shape; prints no result lines")
    parser.add_argument("--mesh-only", action="store_true",
                        help="build the kernels and run the mesh phase (7) alone; prints no result lines")
    parser.add_argument("--quality-only", action="store_true",
                        help="build the kernels and run the quality and bench phase (8) alone; prints no result lines")
    parser.add_argument("--graphs-only", action="store_true",
                        help="build the kernels, warm an engine and run the graph phase (9) alone; "
                             "prints no result lines")
    parser.add_argument("--train-only", action="store_true",
                        help="build the kernels and run the training phase (6) alone; prints no result lines")
    parser.add_argument("--fold-only", action="store_true",
                        help="build the kernels and run the W-fold phase (10) alone; prints no result lines")
    parser.add_argument("--promotion-only", action="store_true",
                        help="build the kernels and run the promotion phase (11) alone; prints no result lines")
    args = parser.parse_args()
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script needs an NVIDIA card")
    if not os.path.isdir(os.path.join(REPO, PKG)):
        fail(f"{PKG}/ is missing next to chip_smoke.py: run it from a checkout of the repository")
    sys.path.insert(0, REPO)
    import numpy as np

    from image_restoration_platform_tpu_torch import imageio
    from image_restoration_platform_tpu_torch.ops.cuda import attention as A
    from image_restoration_platform_tpu_torch.ops.cuda import blend as B
    from image_restoration_platform_tpu_torch.ops.cuda import build
    from image_restoration_platform_tpu_torch.ops.cuda import group_norm as G
    from image_restoration_platform_tpu_torch.ops.cuda import swin_add_norm as S
    from image_restoration_platform_tpu_torch.ops.cuda import swin_mlp as M
    from image_restoration_platform_tpu_torch.ops.cuda import window_attention as W

    t_start = time.perf_counter()
    report: dict = {}
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
          f"python {sys.version.split()[0]}", flush=True)

    report["codec"] = imageio.codec()
    print(f"image codec: {report['codec']}", flush=True)

    # phase 2a: the kernels' nvcc builds, one process per source, together
    def timed_build(source):
        t = time.perf_counter()
        return source, build.compile_source(source), time.perf_counter() - t

    t = time.perf_counter()
    with ThreadPoolExecutor(max_workers=4) as pool:
        builds = list(pool.map(timed_build, (A.SOURCE, B.SOURCE, G.SOURCE, W.SOURCE, S.SOURCE, M.SOURCE)))
    report["build_s"] = time.perf_counter() - t
    report["build_s_by_source"] = {source: seconds for source, _, seconds in builds}
    report["ptxas"] = {source: [line.strip() for line in log.splitlines()
                                if "registers" in line or "spill" in line or "Compiling entry" in line]
                       for source, log, _ in builds}
    for source, log, seconds in builds:
        print(f"kernel build: {source} {seconds:.1f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {line.strip()}", flush=True)

    if args.mesh_only:
        phase_mesh(torch, np, report, card)
        print(f"mesh only: {time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if args.quality_only:
        phase_quality_bench(torch, np, report, card)
        print(f"quality only: {time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if args.fold_only:
        phase_fold(torch, np, report, card)
        if args.report:
            os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
            with open(args.report, "w") as f:
                json.dump(report, f, indent=1, default=str)
        print(f"fold only: {time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if args.promotion_only:
        phase_promotion(torch, np, report, card)
        if args.report:
            os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
            with open(args.report, "w") as f:
                json.dump(report, f, indent=1, default=str)
        print(f"promotion only: {time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if args.train_only:
        phase_train(torch, np, report, card)
        if args.report:
            os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
            with open(args.report, "w") as f:
                json.dump(report, f, indent=1, default=str)
        print(f"train only: {time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if args.graphs_only:
        from image_restoration_platform_tpu_torch.config import ServingConfig
        from image_restoration_platform_tpu_torch.serve import RestorationEngine

        engine = RestorationEngine(device="cuda", dtype=torch.bfloat16,
                                   serving_config=ServingConfig(size_buckets=(256, 512, 1024), max_batch=8))
        serving_warmup(torch, engine, card, report)
        phase_graphs(torch, np, report, card, engine)
        if args.report:
            os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
            with open(args.report, "w") as f:
                json.dump(report, f, indent=1, default=str)
        print(f"graphs only: {time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    rows = phase_kernels(torch, report)
    blend_rows = phase_blend_kernel(torch, report)
    gn_rows = phase_gn_kernels(torch, report)
    san_rows = phase_swin_add_norm(torch, report)
    mlp_rows = phase_swin_mlp(torch, report)
    wa_rows = phase_window_attention(torch, report)
    if args.plan_sweep:
        phase_plan_sweep(torch, report)
        if args.report:
            os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
            with open(args.report, "w") as f:
                json.dump(report, f, indent=1, default=str)
        print(f"plan sweep: {time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if args.kernels_only:
        print(f"kernels only: {time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    launches, engine = phase_slice(torch, np, report, card)
    service = phase_service_graph(torch, np, report, card)
    for name, n in service.items():
        launches[name]["service_graph"] = n
    launches["flash_attention"].update(phase_train(torch, np, report, card))
    for name, by_path in phase_mesh(torch, np, report, card).items():
        launches[name].update(by_path)
    for name, by_path in phase_quality_bench(torch, np, report, card).items():
        launches[name].update(by_path)
    for name, by_path in phase_graphs(torch, np, report, card, engine).items():
        launches[name].update(by_path)
    del engine  # phase 3's graphs and their pool
    torch.cuda.empty_cache()
    for name, by_path in phase_fold(torch, np, report, card).items():
        launches[name].update(by_path)
    launches["flash_attention"].update(phase_promotion(torch, np, report, card))

    main_row = next(r for r in rows if r["shape"] == [8, 4, 4096, 64])
    blend_row = blend_rows[0]  # the 2K -> 4K grid the SR path runs
    keys = ("variant", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # every variant at every shape it was held at, with its launches on the driven paths
    attention_variants = [
        {**{k: r[k] for k in keys}, "schedule": r["schedule"], "splits": r["plan"]["splits"],
         "shape": r["shape"], "dtype": r["dtype"],
         "launches": PATH_LAUNCHES_BY_VARIANT["flash_attention"].get(r["variant"], 0)} for r in rows]
    blend_variants = [
        {**{k: r[k] for k in keys}, "variant": variant, **by, "canvas": r["canvas"], "tile": r["tile"],
         "overlap": r["overlap"], "scale": r["scale"],
         "launches": PATH_LAUNCHES_BY_VARIANT["blend_tiles"].get(variant, 0)}
        for r in blend_rows for variant, by in r["by_variant"].items()]
    kernels = [{
        "name": "flash_attention",
        "variant": main_row["variant"],
        "variants": attention_variants,
        "route": "cuda",
        "source": f"{PKG}/csrc/flash_attention.cu",
        "replaces": "image_restoration_platform_tpu/ops/pallas/attention.py:78",
        "launches": sum(launches["flash_attention"].values()),
        "launches_by_path": launches["flash_attention"],
        "max_abs_err": max(r["max_abs_err"] for r in rows if r["dtype"] == "bfloat16"),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }, {
        "name": "blend_tiles",
        "variant": blend_row["variant"],
        "variants": blend_variants,
        "route": "cuda",
        "source": f"{PKG}/csrc/blend_tiles.cu",
        "replaces": "image_restoration_platform_tpu/ops/pallas/blend.py:133",
        "launches": sum(launches["blend_tiles"].values()),
        "launches_by_path": launches["blend_tiles"],
        "max_abs_err": max(r["max_abs_err"] for r in blend_rows),
        "ms": blend_row["ms"],
        "plain_ms": blend_row["plain_ms"],
        "bound_ms": blend_row["bound_ms"],
        "bound_by": blend_row["bound_by"],
        "library_ms": blend_row["library_ms"],
    }]
    gn_main = next(r for r in gn_rows if tuple(r["shape"]) == GN_MAIN_SHAPE)
    gn_paths = ("restore", "diffusion", "fusion", "service_graph", "train", "mesh_restore_data4",
                "mesh_restore_data2_tensor2", "quality_gates", "bench", "graphs", "fold", "promotion")
    for name, variant, checked in (("gn_moments", "film", ("moments_unit", "moments_offset", "film")),
                                   ("gn_affine_silu", "affine", ("affine",))):
        kernels.append({
            "name": name,
            "variant": variant,
            "variants": [{"shape": r["shape"], "silu": r["silu"], "path": r["path"], "library_ms": r["library_ms"],
                          **{v: r[v] for v in (("moments", "film") if name == "gn_moments" else ("affine",))}}
                         for r in gn_rows],
            "route": "cuda",
            "source": f"{PKG}/csrc/group_norm.cu",
            "replaces": "image_restoration_platform_tpu/models/nn.py:81 (group_norm_stats .. _apply_affine :125: "
                        "the reference's XLA-fused GroupNorm, no Pallas kernel)",
            "launches": sum(GN_PATH_LAUNCHES[name].values()),
            "launches_by_path": GN_PATH_LAUNCHES[name],
            "max_abs_err": max(r["checks"][c]["max_abs_err"] for r in gn_rows for c in checked),
            "ms": gn_main[variant]["ms"],
            "plain_ms": gn_main[variant]["plain_ms"],
            "bound_ms": gn_main[variant]["bound_ms"],
            "bound_by": gn_main[variant]["bound_by"],
            "library_ms": gn_main["library_ms"],
            "library": f"{gn_main['library']} at {GN_MAIN_SHAPE}: the whole GroupNorm (+ SiLU) that the two "
                       "kernels compute together",
        })
        check(set(gn_paths) <= set(GN_PATH_LAUNCHES[name]), f"{name}: paths read {sorted(GN_PATH_LAUNCHES[name])}")
    wa_main = wa_rows[-1]  # the shifted layer's row
    kernels.append({
        "name": "window_attention",
        "variant": "mma_sync",
        "variants": [{k: r[k] for k in ("shift", "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")}
                     for r in wa_rows],
        "route": "cuda",
        "source": f"{PKG}/csrc/window_attention.cu",
        "replaces": "none: the JAX package has no transformer (SwinIR's W-MSA / SW-MSA)",
        "launches": wa_main["launches"],
        "launches_by_path": {f"sr_tiled_{WINDOW_ATTENTION_CANVAS}": wa_main["launches"]},
        **{k: wa_main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    })
    san_main = next(r for r in san_rows if r["form"] == "to_windows" and r["shift"] == 4)
    san_launches = report["window_attention_sr_tiled"]["swin_add_norm_launches"]
    kernels.append({
        "name": "swin_add_norm",
        "variant": "to_windows",
        "variants": [{k: r[k] for k in ("form", "shift", "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")}
                     for r in san_rows],
        "route": "cuda",
        "source": f"{PKG}/csrc/swin_add_norm.cu",
        "replaces": "none: the JAX package has no transformer (SwinIR's residual adds, LayerNorms, roll and "
                    "window partition and reverse)",
        "launches": san_launches,
        "launches_by_path": {f"sr_tiled_{WINDOW_ATTENTION_CANVAS}": san_launches},
        **{k: san_main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    })
    mlp_launches = report["window_attention_sr_tiled"]["swin_mlp_launches"]
    kernels.append({
        "name": "swin_mlp",
        "variant": "bf16",
        "variants": [{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")} for r in mlp_rows],
        "route": "cuda",
        "source": f"{PKG}/csrc/swin_mlp.cu",
        "replaces": "none: the JAX package has no transformer (SwinIR's MLP: fc1, GELU, fc2)",
        "launches": mlp_launches,
        "launches_by_path": {f"sr_tiled_{WINDOW_ATTENTION_CANVAS}": mlp_launches},
        **{k: mlp_rows[0][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    })
    for k in kernels:
        check(all(n > 0 for n in k["launches_by_path"].values()), f"{k['name']} was not launched on a path: {k}")
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, default=str)
    print(f"total {report['seconds']:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
