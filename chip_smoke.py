#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Phases, each fatal on failure:

1. device   -- the card's name and power limit (nvidia-smi), torch and
               CUDA versions; TF32 off for convolutions and matmuls.
2. build    -- nvcc builds the port's kernels from ``milnce_tpu_torch/csrc``
               (``milnce_stream.cu`` and ``softdtw.cu``, side by side) and
               prints each kernel's registers and spills (``-Xptxas -v``).
3. kernels  -- each MIL-NCE stream kernel against its plain PyTorch
               version on the card, values and all four gradients, at the
               recipe shape (B=128, Bg=8192, K=5, D=512), an uneven shape
               (Bg=8191, chunk 1000, K=1), a tiny one, the training run's
               own shape, three that stress the backward kernel's tiling
               (R=33 with D=13, R=640 against Bg=4097, D=700), one that
               splits lse_bwd_cols's streamed loop (B=2048 against Bg=40),
               one that splits lse_fwd's owned rows and its streamed
               loop with a ragged last tile (B=200 against Bg=3000, K=3),
               and the two distributed phases' own (train-full's with
               the gathered copies apart from the local rows, and ddp-2's
               B_local=4 against Bg=8, K=3); and the deep mode past
               D = 768 at the recipe shape with D = 1024, at D = 1000
               (B=200 against Bg=3000, K=3: the scalar path, ragged
               tiles), at D = 2048, D = 769 and D = 4096 (every
               kernel's cluster path: 2, 2, 4, 2 and 8 blocks a
               cluster) and at D = 4608 (past its reach: every kernel's
               slab path), each plan's mode printed;
               then the kernels', the plain versions' and the dense
               PyTorch form's times (median of 20 after warm-up, CUDA
               events) at the recipe shape, beside the card's bound, and
               each kernel launch by launch with TFLOP/s, share of the
               bound, kernel/library ratio and the launch plan its
               wrapper chose; the same for the deep mode at D = 1024,
               where each kernel's slab path is timed beside its
               cluster path (the wrapper's private plan argument) and
               each plan names its mode, nz and the clusters the card
               keeps resident.
   kernels (bf16) -- each MIL-NCE kernel's bf16 mode (the gathered
               operand B bf16, widened to f32 on the copy; the local A
               f32) against its plain twin on the same operands, both
               directions of a step at the recipe shape, train-full's,
               a ragged one (D = 13), ``split`` (lse_bwd_cols's split
               partials), D = 1024 (cluster paths) and D = 4608 (slab
               paths): the lse and dA within the f32 limit, the bf16 dB
               within it plus one bf16 ulp of each element, and every
               output equal bit for bit to the f32 mode's on B widened
               (dB rounded to bf16); the stream
               end to end under the ``_bf16`` launch keys with bf16
               gradients; then timed as above at the recipe shape, held at
               D = 512 and on the cluster and slab paths at D = 1024,
               beside the f32 mode (library: one f32 call on the upcast
               operands).
4. soft-DTW -- each soft-DTW kernel alone against its plain version (the
               forward's value and table; the backward's grad_D, fed the
               same table, under a random cotangent and under a stride-0
               expanded one) at the reference presets, past the
               reference's 1024 cap, past the backward's shared-memory
               ring, at the training shapes and at rectangular and 1x1
               ones, for gamma 0.1 and 1e-5, counting the cases that agree
               bit for bit (the forward's value and R, the backward's
               grad_D); then both kernels' and plain versions' times at
               the four presets and at a full-width training shape (per
               call, CUDA events; the kernel alone on the device,
               torch.profiler; for the forward also its whole call on the
               device, which must be that one kernel, and its launch plan;
               for the backward every kernel of the autograd backward's
               call on the device, and that call) beside the card's bound
               and each kernel's figures before its redesign.
5. reference-- a small model with the chunked loss on the kernels agrees
               with the dense loss: one step's gradients, three steps'
               losses; at embedding 512, at 1024, where the kernels
               run their deep mode (the run the deep launches are
               counted on), and at 4608, where the backward runs its
               slab paths (the run the slab launches are counted on).
   reference-bf16 -- the small model at ``model.dtype = bfloat16``
               (cuDNN deterministic), chunked MIL-NCE on the kernels' bf16
               mode against the same model on the plain twins: one step's
               gradients, all together, within 0.1 of the bf16 noise (the
               plain twins' distance from the f32 model's; the kernels'
               gathered gradients off by 8 unit roundoffs, a planted
               fault, must read above it), three losses
               within 4 bf16 unit roundoffs (2^-8) relative, each
               ``_bf16`` kernel twice a step; at embedding 512, 1024 (the
               deep ``_bf16`` launches are counted on it) and 4608 (the
               slab paths').
6. dtw-ref  -- the same small model with each DTW loss (cdtw, sdtw_cidm,
               sdtw_negative, sdtw_3) on the soft-DTW kernels against the
               plain recurrence: one step's gradients, three steps' losses.
   gc-ref   -- the same small model (cuDNN deterministic) with the
               grad-cache step (``train.grad_accum``) at M = 2 and 4
               against its one-graph form (the M microbatch forwards in
               one autograd graph, each with its own BatchNorm
               statistics, one loss, one backward), MIL-NCE on the stream
               kernels and sdtw_3 on the soft-DTW kernels: step 1's
               gradients, three steps' losses, the running statistics,
               each step's launches (the loss once a step, not M times);
               and a run armed with ``grad.nonfinite@2``, whose step 2
               must leave parameters, moments and buffers as they were.
7. train    -- ``run_training`` at full width (9 inception blocks,
               embedding 512, vocab 66250 x 300, text hidden 2048, 32
               frames at 224^2, K=5, 20 words), per-device batch 16, 4
               steps, its synthetic batches read through ``ShardedLoader``
               (20 reader threads) and ``device_prefetch`` (depth 2):
               chunked MIL-NCE on the stream kernels with chunk 8.  Each
               step's seconds and data wait, the displayed clips/s beside
               steps/s x batch; every loss finite, every kernel launched
               its expected count; one more step profiled.  Its span
               stream and goodput ledger: 4 step spans, at least 4
               data.wait spans, the ledger's categories within 5 % of the
               phase's wall time, the live MFU gauge equal to the roofline
               formula at the displayed steps/s, and the recorder's cost
               a step.
8. data     -- the loader and the prefetch alone at train-full's batch:
               batches/s with 20 reader threads and with 1, the synthetic
               source's samples/s on 1 and 20 threads, every batch on the
               card equal to the host's.
   ddp-1    -- train-full (phase 7's config, seed and steps) through the
               distributed path: an NCCL group of one rank from a
               FileStore rendezvous, the gathers, the all-reduce of the
               gradients, the BatchNorm merge; losses within rel 2e-4 of
               phase 7's, the kernels' launches, its stream under the
               run_id broadcast over the group, steps/s at least 0.95x
               phase 7's, idle share and peak memory beside it.
   ddp-2    -- two rank processes on the one card over gloo with CUDA
               tensors: the small model with sync BatchNorm and chunked
               MIL-NCE on the kernels at Bg = 2 B_local, two steps, each
               rank writing its span stream under rank 0's run_id
               (merged by ``obs/aggregate.py``),
               against one process on the concatenated batch: losses
               within rel 2e-4; the last step's reduced gradients and
               Adam's exp_avg within 1e-2 in norm, exp_avg_sq within
               2e-2 (beside one process with cuDNN off as a yardstick);
               each BatchNorm running mean and variance, and each
               parameter (vacuous at step 2's lr of 1e-6), within
               1e-5 + 1e-4 max; the kernels' launch counts.  Over NCCL
               too, a rank a card, when there are two cards.
   elastic-ddp -- two gloo ranks on the one card (ddp-2's model, sync
               BatchNorm) through ``run_training``: ``host.preempt`` on
               rank 1 alone, agreed every 2 steps
               (``train.preempt_sync_steps``), drains both at step 2 with
               one ``ELASTIC_STAMP.json`` of ``{"data": 2}``; resumed in
               this process at W = 1 (same global batch) to step 4, its
               losses within rel 2e-4 of one uninterrupted process's; a
               run with ``host.slow`` on rank 1 puts ``straggler`` events
               naming rank 1 in rank 0's stream.
9. resume   -- train-full stopped at step 2 and resumed to step 4 against
               the uninterrupted run (cuDNN deterministic): steps 3-4's
               losses within rel 2e-4, the batch cursor; in the resumed
               half SIGUSR1 arms the bounded torch.profiler capture,
               which must stop once, by its duration, with a trace that
               names the three stream kernels.
   drain    -- train-full drained at step 2 by ``train.drain_signal_file``
               (written from ``on_step``), resumed to step 4, cuDNN
               deterministic: ``drained``, both stamps at step 2, a
               non-zero drain bucket in the ledger, the losses within rel
               2e-4 of the resume phase's uninterrupted run.
10. eval    -- ``eval.cli msrvtt`` on that checkpoint at full width (fake
               decoder, 4 windows of 32 frames at 224^2, the first 256
               rows): R@1/5/10, MedR, videos/s; the metrics against the
               embeddings, the first batch against ``make_video_embed_fn``;
               the same eval over the device group ``["cuda:0",
               "cuda:0"]``, its embeddings within 1e-5 + 1e-4 max|e| of
               the one-card eval's, videos/s beside.
   eval-ddp -- the small model through ``run_training`` with
               ``train.evaluate`` (msrvtt, the fake decoder) on two gloo
               ranks on the one card: every rank gets the metrics one
               process gets, decodes its own slices alone and meets no
               barrier while it evaluates; rank 0 logs them once.
   serve-full -- serving's first half on that checkpoint: exported by
               ``milnce-export-torch``'s ``main`` (its arrays equal the
               checkpoint's state bit for bit), ``InferenceEngine.
               from_export`` on the card with a ladder of 1-16 (each
               bucket's embeddings against ``make_video_embed_fn`` /
               ``make_text_embed_fn`` within 1e-5 + 1e-4 max|e|, TF32 off;
               ms a call at each bucket), 64 clips of 32 frames at 224^2
               through a ``DynamicBatcher``, 64 caption queries from 4
               threads through a batcher and the cache (batched and cached
               replies against the direct call; a second pass all cache
               hits, the engine's call counts unchanged), and a
               ``DeviceRetrievalIndex``
               of the clips padded with seeded unit rows to 1,048,576 x 512
               f32 with planted duplicates (ties across the 10th place):
               the top-10 of 16 queries equal a float64 exhaustive ranking
               on the host, ties by the lower row; ms a query batch beside
               its bound; recompiles 0; peak device memory.  serve (bf16):
               an engine with ``dtype="bfloat16"`` on the same export
               (every float leaf bf16 on the card): each embedding row at
               buckets 1 and 16 within ``SERVE_BF16_REL`` of the f32
               engine's (a planted fault in each tower's last layer
               above it), ms a call beside f32's, and the index answering
               its bf16 queries with the exact top-10 of a float64
               ranking of them.
   serve-group -- the same export and corpus over the device group
               ``["cuda:0", "cuda:0"]`` (one card named twice, so one
               card runs the whole group path): the group engine (ladder
               2-16) at every bucket within 1e-5 + 1e-4 max|e| of the
               one-card engine on the same rows; the index over the
               group returns the one-card index's top-10, the float64
               ranking's; a live index over the group booted short of
               the corpus ingests the rest and answers the same; a pool
               of two such groups survives ``serve.replica_dead`` (one
               whole group quarantined, its request requeued, rankings
               identical).  Measured, in turns with one card: ms a
               bucket-16 video and text call, ms a query batch.
   serve-hosts -- the same export and corpus over a grid of two ranks,
               each serving on a group of two devices (two gloo rank
               processes on the one card, each ``["cuda:0", "cuda:0"]``;
               four shards, rank-major), rank 0 driving it through
               ``serving/lockstep.py`` and the other rank replaying:
               the grid engine's video and text calls at every rung
               within 1e-5 + 1e-4 max|e| of the one-card engine's; ties
               planted across a device and a rank boundary; the grid
               index's top-10 equal to the one-card index's and the
               float64 host ranking; a live index booted short of the
               corpus ingesting past its rung, at generation 1 on both
               ranks; ``milnce-serve-torch``'s ``main`` on two rank
               processes (16 queries and one ingest over rank 0's front,
               SIGTERM ending both with 0 after one snapshot).  Measured,
               in turns: ms a bucket-16 video call and a query batch, the
               grid against one card, rank 0's announcement a call.
   serve-live -- serving's second half on serve-full's export:
               ``milnce-serve-torch`` as a subprocess on 127.0.0.1 with a
               live index booted from a snapshot of 1,000,000 seeded unit
               rows plus serve-full's clips (ties planted across the 10th
               place; rung 1,048,576), continuous batching, two tiers, a
               small max_inflight: the top-10 of 16 token rows over HTTP
               equal a float64 host ranking at boot, after 1,000
               precomputed rows and 2 clips (through the video tower) are
               ingested within the rung, and after 48,000 one-hot rows
               carry it across to 2,097,152 (the generation advancing); a
               capture armed over HTTP holds the engine's kernels; a burst
               past max_inflight gets 429 with Retry-After; /healthz and
               /metrics answer throughout; after SIGTERM (flush, snapshot)
               a reboot answers bit for bit.  Then ``quant/`` at full
               width: ``calibrate_and_quantize`` with NUMERICS.md, the v2
               export, its engine against an f32 engine over the
               host-dequantized weights within 1e-5 + 1e-4 max|e| at
               buckets 1 and 16; ``distill_text_student`` at hidden 512;
               and a pool of two f32 replicas and one int8 edge replica on
               the card: ``serve.replica_dead`` mid-traffic, the killed
               request requeued, rankings identical; class pins strict.
               Measured: ms a query batch idle and while swaps run,
               seconds a swap, reserved memory across the crossing,
               int8/f32 ms a call, resident bytes, recall@10 of the int8
               and student towers against f32, the pool's counts.
   remat    -- train-full with ``model.remat``: losses within rel 2e-4
               of phase 7's, ``num_batches_tracked`` equal; peak memory
               and steps/s beside phase 7's.
   gc       -- train-full-gc: phase 7's model, data, seed, loader and obs
               at ``train.batch_size`` 128 in ``train.grad_accum`` 8
               microbatches of 16, chunked MIL-NCE on the stream kernels
               (chunk 8), 4 steps: every loss finite, each kernel twice a
               step, 4 step spans; steps/s, clips/s beside phase 7's,
               peak memory, idle share, data wait a step.
   curriculum -- train-full-curriculum: train-full under
               ``train.curriculum`` (2 steps of 8 frames at 112^2 and
               batch 32, the stream kernels at B_local = Bg = 32; then 2
               of 32 frames at 224^2 and batch 16): each step's clip shape
               the plan's, the kernels twice a step at each stage, each
               stage's steps/s, clips/s and peak memory beside the
               pre-flight's figure, the ledger's stage_switch share, the
               ledger within 5 % of the wall; then the same spec with
               ``MILNCE_HBM_GIB`` at 0.95 of stage 1's peak refused by
               the pre-flight, naming stage 1, before any step.
   native-data -- train-full's model through the HowTo100M source on a
               stub ffmpeg (seeded raw frames, no codec), with
               ``data.use_native_reader`` (the C++ pipe pump, built by
               g++ into ``build/torch_kernels/``) and without: the
               loader's batches on the card equal byte for byte over 3
               batches, batches/s of each, ``run_training`` through each
               (3 steps: data wait a step, losses within rel 2e-4, the
               stream kernels twice a step), ``bench_reader``'s MB/s; the
               host soft-DTW against the soft-DTW kernels at
               train-full-sdtw3's all-pairs shape.
   fsdp-2d  -- train-full on the (1 x 2) ``(data, model)`` grid: two gloo
               ranks on the one card, B_local 8 of Bg 16, 3 steps, under
               both settings of ``parallel.overlap_grad_reduce`` (a
               collective a leaf during the backward, or fused after it),
               against the (2 x 1) 1-D layout on the same ranks and
               batches and against each other: losses within rel 2e-4,
               parameters within 1e-5 + 1e-4 max|p|, Adam's moments in
               norm, a rank's bytes of sharded parameters and moments half
               the 1-D layout's, peak memory, steps/s of both settings
               beside train-full's, the stream kernels twice a rank a step
               under both; the small model's sdtw_3 case beside it.
   resume-2d -- the small model: 1-D (two ranks) for 2 steps, resumed for
               1 on the grid, resumed for 1 in one process: losses within
               rel 2e-4 of an uninterrupted 1-D run, cuDNN deterministic.
   analysis -- graftlint on the card: (a) Passes 1 and 3 over the port's
               tree, no finding; (b) one train-full step (full width,
               batch 16, the stream kernels, the finite guard) traced
               under ``analysis/optrace.py``: no float64, no host sync,
               no collective, and its kernel launches by name equal to the
               launch counters; (c) 3 steps under
               ``torch.cuda.set_sync_debug_mode("error")``, where any sync
               raises; (d) train-full and train-full-remat planned on
               meta (``memplan.what_if_step``) within 10 % of the card's
               peak for the same step; (e) train-full's guarded and plain
               steps in turns, windows of 8 steps back to back with one
               sync, and one profiled guarded step's idle share and
               optimizer time, beside phase 7's loop and PR 19's
               (measured only).
   softdtw-sp -- ``softdtw_seq_parallel`` (the full D on every rank) and
               ``softdtw_seq_parallel_rows`` (a rank's rows alone) on two
               gloo ranks on the one card at (2, 2048, 2048), gamma 0.1,
               with and without a band of 128: value and grad_D against
               the soft-DTW kernels on one device, within the
               kernel-versus-plain limit; the time a call; the bytes of D
               and grad_D a rank holds (rows-local: half) and its peak.
11. cudnn   -- train-full again with ``cudnn.benchmark = True``, steps/s
               beside phase 7's (measured only; the default stays off).
   train-full-bf16 -- phase 7's config and seed at ``model.dtype =
               bfloat16``: every loss finite, each ``_bf16`` kernel twice a
               step, the live MFU gauge equal to the formula over the
               card's bf16 peak; steps/s, peak memory, data wait, idle
               share of a profiled step and MFU beside phase 7's
               (measured only).
12. sdtw_3  -- train-full with ``sdtw_3`` on the soft-DTW kernels, each
               kernel's launch count checked; one more step profiled.

Prints one ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without a CUDA device or outside a checkout of the repository.

``python3 chip_smoke.py --serve-group``, on a machine with two cards or
more, runs only the device phase and serve-group over ``["cuda:0",
"cuda:1"]`` on a seeded full-width export (serving builds no kernel).
``--serve-hosts``, on four cards (it refuses fewer), runs only the
device phase and serve-hosts on a seeded full-width export over NCCL:
two ranks of two cards each (``initialize_serving``'s own join), timed
against one card and one process over the four cards.
``python3 chip_smoke.py --ddp-2``, on a machine with two cards or more,
runs only the device, build and ddp-2 phases: ddp-2's comparison over
NCCL with a rank a card beside its gloo one.  ``--fsdp-2d``, on two
cards or more, runs only the device, build and fsdp-2d phases, over
NCCL with a rank a card: the (1 x 2) grid against the 2-way 1-D layout
on two or three cards, the (2 x 2) grid against the 4-way one on four or
more, each under both settings of ``parallel.overlap_grad_reduce``.
None of the four prints a kernels line.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# FLOP/s and bytes/s of one H100 SXM at its 700 W limit (NVIDIA data
# sheet): f32 outside the tensor cores, HBM3.
H100_F32_FLOPS = 67e12
H100_HBM_BYTES = 3.35e12
TOL_RTOL, TOL_ATOL = 1e-4, 1e-5     # |kernel - plain| <= atol + rtol*max|plain|
TRAIN_STEPS, TRAIN_BATCH, TRAIN_CHUNK = 4, 16, 8
DATA_BATCHES = 12         # batches the data-alone phase reads, each pass
EVAL_ROWS = 256           # rows of csv/msrvtt_test.csv the eval phase scores
_STREAM_CU = "milnce_tpu_torch/csrc/milnce_stream.cu"
SOURCES = {"lse_fwd": _STREAM_CU, "lse_bwd_rows": _STREAM_CU,
           "lse_bwd_cols": _STREAM_CU, "lse_fwd_deep": _STREAM_CU,
           "lse_bwd_rows_deep": _STREAM_CU, "lse_bwd_cols_deep": _STREAM_CU,
           "lse_fwd_deep_slab": _STREAM_CU,
           "lse_bwd_rows_deep_slab": _STREAM_CU,
           "lse_bwd_cols_deep_slab": _STREAM_CU,
           **{f"{name}{mode}_bf16": _STREAM_CU
              for mode in ("", "_deep", "_deep_slab")
              for name in ("lse_fwd", "lse_bwd_rows", "lse_bwd_cols")},
           "softdtw_fwd": "milnce_tpu_torch/csrc/softdtw.cu",
           "softdtw_bwd": "milnce_tpu_torch/csrc/softdtw.cu"}
REPLACES = {"lse_fwd": "milnce_tpu/ops/milnce_pallas.py:131",
            "lse_bwd_rows": "milnce_tpu/ops/milnce_pallas.py:210",
            "lse_bwd_cols": "milnce_tpu/ops/milnce_pallas.py:210",
            "lse_fwd_deep": "milnce_tpu/ops/milnce_pallas.py:131",
            "lse_bwd_rows_deep": "milnce_tpu/ops/milnce_pallas.py:210",
            "lse_bwd_cols_deep": "milnce_tpu/ops/milnce_pallas.py:210",
            "lse_fwd_deep_slab": "milnce_tpu/ops/milnce_pallas.py:131",
            "lse_bwd_rows_deep_slab": "milnce_tpu/ops/milnce_pallas.py:210",
            "lse_bwd_cols_deep_slab": "milnce_tpu/ops/milnce_pallas.py:210",
            **{f"{name}{mode}_bf16": f"milnce_tpu/ops/milnce_pallas.py:{line}"
               for mode in ("", "_deep", "_deep_slab")
               for name, line in (("lse_fwd", 131), ("lse_bwd_rows", 210),
                                  ("lse_bwd_cols", 210))},
            "softdtw_fwd": "milnce_tpu/ops/softdtw_pallas.py:282 (B3), "
                           ":63 (B5), :106 (B7)",
            "softdtw_bwd": "milnce_tpu/ops/softdtw_pallas.py:340 (B4), "
                           ":593 (B6), :489 (B8)"}
# the name of each MIL-NCE kernel's CUDA function, for its device time
KERNEL_KEYS = {"lse_fwd": "lse_fwd_kernel", "lse_bwd_rows": "lse_bwd_kernel",
               "lse_bwd_cols": "lse_bwd_kernel"}
# each MIL-NCE kernel's name in a torch.profiler trace, demangled or not:
# the two backward modes are one function, told apart by OWN_COLS, its
# third template argument
TRACE_NAMES = {
    "lse_fwd": r"lse_fwd_kernel(<|I)",
    "lse_bwd_rows": r"lse_bwd_kernel(<\s*\d+,\s*\w+,\s*false,|ILi\d+ELb[01]ELb0E)",
    "lse_bwd_cols": r"lse_bwd_kernel(<\s*\d+,\s*\w+,\s*true,|ILi\d+ELb[01]ELb1E)"}
RECORDER_COST_SPANS = 2000   # spans written to time one, alone
DEEP_D = 1024             # the deep mode's timed and trained embedding
SLAB_D = 4608             # past the cluster path's reach: the slab path
# special-function (exp, log) results per clock per SM on Hopper
H100_SFU_PER_CLOCK_SM = 16
# (label, B, N, M, features): the soft-DTW presets of
# milnce_tpu/ops/softdtw_profile.py, the first timed as the kernels' line
SDTW_PRESETS = [("B3/B4 (1024,32,32)", 1024, 32, 32, 64),
                ("B3/B4 (128,17,15)", 128, 17, 15, 2),
                ("B5/B6 (512,64,64)", 512, 64, 64, 2),
                ("B7/B8 (32,256,256)", 32, 256, 256, 512)]
# timed besides the presets: the full-width sdtw_3 step's video-text
# all-pairs call (B^2 = 256 pairs of T' = 4 by K = 5, D = 512)
SDTW_TRAIN_TIMED = ("train v-t (256,4,5)", 256, 4, 5, 512)
# (label, B, N, M, features, bandwidth): past the reference's 1024 cap, the
# full-width sdtw_3 pairs (B^2 = 256, T' = 4 frames, K = 5 captions),
# rectangular / 1x1 cases, and a length past the backward's shared-memory
# ring (N > bwd_shared_max_n(), 1208 on an H100), with M small so that the
# plain versions take seconds
SDTW_EXTRA = [("B7/B8 past 1024", 2, 1500, 1300, 64, 0),
              ("B7/B8 banded", 2, 2048, 2048, 64, 128),
              ("train v-v", 256, 4, 4, 512, 0),
              ("train v-t", 256, 4, 5, 512, 0),
              ("train t-t", 256, 5, 5, 512, 0),
              ("rect", 5, 7, 3, 8, 0),
              ("rect-T banded", 5, 3, 7, 8, 4),
              ("1x1", 3, 1, 1, 8, 0),
              ("past the ring", 1, 2600, 24, 64, 0)]
# softdtw_bwd before its redesign, on an H100 80GB HBM3 at 700 W (the
# E-writing kernel that read R from global memory each step): ms a call
# and on the device, at the timed shapes
SDTW_BWD_BEFORE = {(1024, 32, 32): (0.1214, 0.0752),
                (128, 17, 15): (0.0661, 0.0325),
                (512, 64, 64): (0.2028, 0.1719),
                (32, 256, 256): (0.5523, 0.5341),
                (256, 4, 5): (0.0631, 0.0077)}
# softdtw_fwd before its redesign, on an H100 80GB HBM3 at 700 W (a block
# a pair, the diagonals read back from global memory, the value copied out
# by a second launch): ms a call and on the device
SDTW_FWD_BEFORE = {(1024, 32, 32): (0.0996, 0.0296),
                   (128, 17, 15): (0.1187, 0.0105),
                   (512, 64, 64): (0.0876, 0.0487),
                   (32, 256, 256): (0.2386, 0.2028),
                   (256, 4, 5): (0.0836, 0.0035)}
DTW_LOSSES = ("cdtw", "sdtw_cidm", "sdtw_negative", "sdtw_3")


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ phases
def phase_device():
    from milnce_tpu_torch.train.loop import disable_tf32

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    log(disable_tf32())
    return card


def phase_build():
    from milnce_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    built = cuda_build.build(["milnce_stream", "softdtw"])
    for name, (secs, out) in built.items():
        log(f"built {name}.cu in {secs:.1f} s")
        for line in _ptxas_summary(out):
            log(f"  {line}")
    log(f"build phase: {time.perf_counter() - t0:.1f} s "
        f"({'compiled' if built else 'cached'})")


def _ptxas_summary(out):
    """One line per kernel of nvcc's ``-Xptxas -v`` output: its name
    (demangled where ``c++filt`` is found), registers and spills."""
    entries, name, spill = [], None, ""
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), ""
        elif "spill stores" in line:
            spill = line.strip()
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            entries.append((name, m.group(1), spill))
            name = None
    names = [n for n, _, _ in entries]
    if names and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True, check=True,
                               timeout=60).stdout.splitlines()
        names = [n.replace("(anonymous namespace)::", "").split("(")[0]
                 for n in names]
    return [f"{n}: {regs} registers; {spill}"
            for n, (_, regs, spill) in zip(names, entries)]


def _case(b, bg, k, d, seed, shared):
    """Embeddings for one shape: the local v/t are the first rows of the
    gathered v_all/t_all (drawn apart when b > bg), or the same tensors
    when ``shared``."""
    rng = np.random.default_rng(seed)
    scale = d ** -0.25                    # logits of unit scale

    def draw(n):
        return torch.tensor(rng.standard_normal((n, d), np.float32) * scale,
                            device="cuda")

    v_all, t_all = draw(bg), draw(bg * k)
    if shared:
        return v_all, t_all, v_all, t_all
    if b > bg:
        return draw(b), draw(b * k), v_all, t_all
    return (v_all[:b].clone(), t_all[:b * k].clone(), v_all, t_all)


def _grads(stream, v, t, v_all, t_all, chunk, g_row, g_col):
    leaves = [x.detach().clone().requires_grad_(True)
              for x in (v, t, v_all, t_all)]
    shared = v_all is v
    if shared:
        leaves[2], leaves[3] = leaves[0], leaves[1]
    row, col = stream(*leaves, chunk)
    uniq = leaves[:2] if shared else leaves
    grads = torch.autograd.grad((row, col), uniq, (g_row, g_col))
    return [row.detach(), col.detach(), *grads]


def _err(got, want, scaled=False):
    """Max |got - want| and its limit, atol + rtol * max|want|.  With
    ``scaled`` the atol shrinks with outputs below 1, so that it never
    exceeds what it checks."""
    err, peak = float((got - want).abs().max()), float(want.abs().max())
    atol = TOL_ATOL * min(1.0, peak) if scaled else TOL_ATOL
    return err, atol + TOL_RTOL * peak


def phase_parity():
    """Kernel vs plain at eleven shapes; returns the worst error of each
    kernel.  The lses come from lse_fwd, g_v/g_t from lse_bwd_rows and
    g_v_all/g_t_all from lse_bwd_cols; where v_all is v (one device),
    g_v and g_t sum the outputs of both backward kernels.  Beside the
    recipe, uneven, tiny and training shapes, three stress the backward
    kernel's tiles: R = 33 rows (not a multiple of its 32-row tile) with
    D = 13 (not a multiple of 4), R = 640 (the columns direction, B*K)
    against an uneven Bg, and D = 700 near the largest instance; and
    B = 2048 against Bg = 40 gives lse_bwd_cols 2 owned tiles, so its
    streamed loop splits over 16 blocks; B = 200 against Bg = 3000 with
    K = 3 gives lse_fwd's rows launch 4 owned tiles (the last ragged) and
    splits of 3 streamed tiles, the last split of 2 ending on a ragged
    tile (its plans are printed); ddp-1 and ddp-2 are the distributed
    phases' shapes; the last six run the deep mode (D > 768): the
    recipe at D = 1024, D = 1000 (not a multiple of 4: the scalar copies;
    ragged owned and streamed tiles; depth parts of 512 and 488), D =
    2048 (clusters of 4 blocks), D = 769 (parts of 416 and 353), D =
    4096 (clusters of 8, the cluster path's reach), their errors the
    ``_deep`` kernels', and D = 4608, where the errors are the slab
    paths' (``_deep_slab``), each plan printed with its mode. The
    cotangents are of unit scale and each limit shrinks with its output
    (``_err(scaled=True)``), so that a kernel returning zeros fails.
    """
    from milnce_tpu_torch.ops import milnce_stream as ms

    cases = [("recipe", 128, 8192, 5, 512, 816, False),
             ("uneven", 128, 8191, 1, 512, 1000, False),
             ("tiny", 3, 3, 2, 16, 2, True),
             ("train", TRAIN_BATCH, TRAIN_BATCH, 5, 512, TRAIN_CHUNK, True),
             ("d13-r33", 33, 8191, 1, 13, 1000, False),
             ("r640-uneven", 128, 4097, 5, 512, 500, False),
             ("d700", 33, 2048, 5, 700, 256, False),
             ("split", 2048, 40, 1, 512, 40, False),
             ("fwd-split", 200, 3000, 3, 512, 300, False),
             ("ddp-1", TRAIN_BATCH, TRAIN_BATCH, 5, 512, TRAIN_CHUNK, False),
             ("ddp-2", 4, 8, 3, 512, 3, False),
             ("deep-recipe", 128, 8192, 5, DEEP_D, 816, False),
             ("deep-d1000", 200, 3000, 3, 1000, 300, False),
             ("deep-d2048", 8, 64, 2, 2048, 16, False),
             ("deep-d769", 4, 8, 3, 769, 3, False),
             ("deep-d4096", 16, 64, 2, 4096, 16, False),
             ("deep-d4608", 4, 8, 3, SLAB_D, 3, False)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst = {name: 0.0 for name in ms.LAUNCHES}
    for i, (label, b, bg, k, d, chunk, shared) in enumerate(cases):
        v, t, v_all, t_all = _case(b, bg, k, d, 100 + i, shared)
        if label == "fwd-split":
            for r, c in ((b, bg * k), (b * k, bg)):
                log(f"  [{label}] lse_fwd R={r} C={c}: "
                    f"{_plan_line(ms.fwd_plan(r, c, d, sms))}")
        if label.startswith("deep"):
            for r, c in ((b, bg * k), (b * k, bg)):
                for name, plan_of in (
                        ("lse_fwd", lambda r, c: ms.card_fwd_plan(
                            ms._lib(), r, c, d, "cuda")),
                        ("lse_bwd_rows", lambda r, c: ms.card_bwd_plan(
                            ms._lib(), False, r, c, d, "cuda")),
                        ("lse_bwd_cols", lambda r, c: ms.card_bwd_plan(
                            ms._lib(), True, r, c, d, "cuda"))):
                    plan = plan_of(r, c)
                    if name + "_" + plan.mode != ms.launch_key(name, d):
                        raise AssertionError(f"{label}: {name} took the "
                                             f"{plan.mode} mode at D={d}")
                    log(f"  [{label}] {name} R={r} C={c}: "
                        f"{_plan_line(plan)}")
        ms.reset_launches()
        g = torch.Generator(device="cuda").manual_seed(i)
        g_row = torch.randn(b, device="cuda", generator=g)
        g_col = torch.randn(b * k, device="cuda", generator=g)
        got = _grads(ms.milnce_stream_cuda, v, t, v_all, t_all, chunk,
                     g_row, g_col)
        want = _grads(ms.milnce_stream_plain, v, t, v_all, t_all, chunk,
                      g_row, g_col)
        torch.cuda.synchronize()
        fwd, rows, cols = (ms.launch_key(k, d) for k in ms.KERNELS)
        launched = {k: n for k, n in ms.LAUNCHES.items() if n}
        if launched != {fwd: 2, rows: 2, cols: 2}:
            raise AssertionError(f"{label}: launches {launched}")
        names = ["row_lse", "col_lse", "g_v", "g_t", "g_v_all", "g_t_all"]
        owners = [[fwd]] * 2 + [[rows]] * 2 + [[cols]] * 2
        if shared:          # v_all is v: g_v and g_t sum both kernels
            names = names[:4]
            owners = owners[:2] + [[rows, cols]] * 2
        for name, own, a, w in zip(names, owners, got, want):
            err, lim = _err(a, w, scaled=True)
            peak = float(w.abs().max())
            ok = err <= lim and bool(torch.isfinite(a).all())
            log(f"  [{label} B={b} Bg={bg} K={k} D={d} chunk={chunk}] "
                f"{name:8s} max_abs_err {err:.3e} (limit {lim:.3e}, "
                f"max|plain| {peak:.3e}) max_rel_err "
                f"{err / max(peak, 1e-30):.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{label} {name}: kernel disagrees with "
                                     f"its plain version ({err} > {lim})")
            for kern in own:
                worst[kern] = max(worst[kern], err)
    return worst


def _bf16_ulp(x):
    """One bf16 ulp of each element of ``x`` (2^(floor(log2 |x|) - 7);
    that of the smallest normal at 0)."""
    e = torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def phase_parity_bf16():
    """The bf16 mode of each MIL-NCE kernel (a bf16 gathered operand B,
    widened to f32 on the copy) against its plain twin on the same
    operands: the local A upcast to f32 as ``_StreamCuda`` does, B bf16.
    Both directions of a step at the recipe shape, train-full's own shape,
    a ragged one (D = 13, R = 33: the scalar copies), ``split`` (B = 2048
    against Bg = 40: lse_bwd_cols's f32 partials, summed, then rounded),
    the cluster path at D = 1024 and the slab path at D = 4608.  The lse
    and lse_bwd_rows's f32 dA within the f32 limit ``1e-5 min(1,
    max|plain|) + 1e-4 max|plain|``; lse_bwd_cols's bf16 dB within that
    plus one bf16 ulp of each |plain| element (the two round one f32 sum
    each, and the sums part in the last f32 bits).  Each output also
    equals, bit for bit, the f32 mode's on B widened to f32 (dB rounded
    to bf16): the bf16 mode stages the same numbers in shared memory and
    runs the same FMAs in the same order.  Then the stream end
    to end (autograd, bf16 leaves): its launches 2 + 2 + 2 under the
    ``_bf16`` keys, and every gradient in its leaf's dtype.  Returns the
    worst error of each ``_bf16`` key."""
    from milnce_tpu_torch.ops import milnce_stream as ms

    bf16 = torch.bfloat16
    cases = [("recipe", 128, 8192, 5, 512, False),
             ("train", TRAIN_BATCH, TRAIN_BATCH, 5, 512, True),
             ("d13-r33", 33, 8191, 1, 13, False),
             ("split", 2048, 40, 1, 512, False),
             ("deep-d1024", 128, 8192, 5, DEEP_D, False),
             ("deep-d4608", 4, 8, 3, SLAB_D, False)]
    worst = {k: 0.0 for k in ms.LAUNCHES if k.endswith("_bf16")}
    lib = ms._lib()
    for i, (label, b, bg, k, d, shared) in enumerate(cases):
        v, t, v_all, t_all = (x.to(bf16) for x in
                              _case(b, bg, k, d, 300 + i, shared))
        g = torch.Generator(device="cuda").manual_seed(50 + i)
        g_row = torch.randn(b, device="cuda", generator=g)
        g_col = torch.randn(b * k, device="cuda", generator=g)
        parts = ms.deep_parts(d) if d > ms.STREAM_DMAX else None
        chunk = min(bg, 1000)
        for a, bm, gg, width in ((v.float(), t_all, g_row, chunk * k),
                                 (t.float(), v_all, g_col, chunk)):
            ms.reset_launches()
            lse = ms.lse_fwd(a, bm)
            rows = ms.lse_bwd_rows(a, bm, lse, gg)
            cols = ms.lse_bwd_cols(a, bm, lse, gg)
            torch.cuda.synchronize()
            keys = [ms.launch_key(n, d, bf16) for n in ms.KERNELS]
            if {kk: n for kk, n in ms.LAUNCHES.items() if n} != dict.fromkeys(
                    keys, 1):
                raise AssertionError(f"{label}: launches {ms.LAUNCHES}")
            if rows.dtype != torch.float32 or cols.dtype != bf16:
                raise AssertionError(f"{label}: dtypes {rows.dtype} "
                                     f"{cols.dtype}")
            want = (ms.lse_plain(a, bm, width, parts),
                    ms.lse_bwd_rows_plain(a, bm, lse, gg, width, parts),
                    ms.lse_bwd_cols_plain(a, bm, lse, gg, width, parts))
            for key, got, w in zip(keys, (lse, rows, cols), want):
                err, lim = _err(got.float(), w.float(), scaled=True)
                excess = (got.float() - w.float()).abs() - lim
                if got.dtype == bf16:
                    excess = excess - _bf16_ulp(w)
                ok = (float(excess.max()) <= 0
                      and bool(torch.isfinite(got).all()))
                log(f"  [bf16 {label} R={a.shape[0]} C={bm.shape[0]} D={d}] "
                    f"{key:24s} max_abs_err {err:.3e} (limit {lim:.3e}"
                    f"{' + 1 bf16 ulp of |plain|' if got.dtype == bf16 else ''}"
                    f", max|plain| {float(w.float().abs().max()):.3e}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"bf16 {label} {key}: kernel "
                                         "disagrees with its plain version")
                worst[key] = max(worst[key], err)
            # the f32 mode on B widened (uncounted launches): each output
            # bit for bit, dB rounded to bf16
            wide = bm.float()
            f32_mode = (ms.launch_fwd(lib, a, wide)[0],
                        ms.launch_bwd(lib, a, wide, lse, gg, False)[0],
                        ms.launch_bwd(lib, a, wide, lse, gg, True)[0].to(bf16))
            for key, got, w in zip(keys, (lse, rows, cols), f32_mode):
                same = got.dtype == w.dtype and torch.equal(got, w)
                log(f"  [bf16 {label} R={a.shape[0]} C={bm.shape[0]} D={d}] "
                    f"{key:24s} = the f32 mode on B widened, bit for bit: "
                    f"{'ok' if same else 'FAIL'}")
                if not same:
                    raise AssertionError(
                        f"bf16 {label} {key}: not the f32 mode on B widened "
                        f"(max diff "
                        f"{float((got.float() - w.float()).abs().max())})")
        ms.reset_launches()
        leaves = [x.detach().clone().requires_grad_(True)
                  for x in (v, t, v_all, t_all)]
        if shared:
            leaves[2], leaves[3] = leaves[0], leaves[1]
        row, col = ms.milnce_stream_cuda(*leaves, chunk)
        uniq = leaves[:2] if shared else leaves
        grads = torch.autograd.grad((row, col), uniq, (g_row, g_col))
        torch.cuda.synchronize()
        keys = [ms.launch_key(n, d, bf16) for n in ms.KERNELS]
        if ({kk: n for kk, n in ms.LAUNCHES.items() if n}
                != dict.fromkeys(keys, 2)
                or any(gr.dtype != bf16 for gr in grads)
                or row.dtype != torch.float32):
            raise AssertionError(f"bf16 {label}: the stream's launches "
                                 f"{ms.LAUNCHES} or dtypes "
                                 f"{[gr.dtype for gr in grads]}")
        log(f"  [bf16 {label}] the stream: launches 2 + 2 + 2 "
            f"({', '.join(keys)}), lse f32, gradients bf16")
    return worst


def _time_ms(fn, reps=20, warm=3):
    """Median ms of a call on the card (``utils/timing.py::event_ms``)."""
    from milnce_tpu_torch.utils.timing import event_ms

    return event_ms(fn, reps=reps, warm=warm, device="cuda")


def _plan_line(plan):
    if plan.mode == "held":
        where = f"mode held, instance D<={plan.dmax}"
    elif plan.mode == "deep":
        where = (f"mode deep, cluster path: clusters of {plan.nz} blocks, "
                 f"depth parts {[w for _, w in plan.parts]}, "
                 f"{plan.clusters} clusters resident on the card")
    else:
        where = (f"mode {plan.mode}, slab path: both operands streamed in "
                 f"slabs, {len(plan.parts)} depth parts of <= "
                 f"{plan.parts[0][1]}, {plan.nz} grid z-slab(s) of <= "
                 f"{plan.dmax}")
    return (f"{where}, BM={plan.bm}, SN={plan.bn}, "
            f"threads={plan.threads}, grid {plan.row_tiles}x{plan.nsplit}"
            f"x{plan.nz}, streamed tiles/split {plan.tps} of "
            f"{plan.col_tiles}, {plan.smem_bytes} B shared, scratch "
            f"{plan.scratch}")


def _bound(flops, nbytes):
    t_ops, t_bytes = flops / H100_F32_FLOPS, nbytes / H100_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _stream_bytes(name, r, c, d, dtype=torch.float32):
    """Bytes one launch of MIL-NCE kernel ``name`` must move for A (r, d)
    f32 and B (c, d) of ``dtype``, each read once: the forward writes the
    lse (r), the backward reads lse and g (r each) and writes dA (f32) or
    dB (B's dtype)."""
    eb = torch.finfo(dtype).bits // 8
    ins = 4 * r * d + eb * c * d
    if name == "lse_fwd":
        return ins + 4 * r
    out = 4 * r * d if name == "lse_bwd_rows" else eb * c * d
    return ins + 4 * 2 * r + out


def phase_timing(d=512, dtype=torch.float32):
    """Times of each kernel's pair of launches per step (rows direction +
    columns direction) at the recipe shape with embedding ``d`` (past
    768, the deep mode's cluster path, keyed ``<kernel>_deep``; there
    each kernel's slab path too, through the wrappers' private plan
    argument, keyed ``<kernel>_deep_slab``), and of each kernel's two
    launches one by one,
    (R, C) = (128, 40960) and (640, 8192), with its launch plan (the
    clusters resident on the card on the cluster path).  Each is timed
    per call (CUDA events: the wrapper's host work and the sum of its
    split partials included) and on the device (torch.profiler: the
    kernel alone; every kernel of the wrapper's call, the combination of
    the partials included; and every kernel of the library call, which
    the whole call is compared with).  With ``dtype`` bf16 the gathered
    operands (B) are bf16 and each kernel runs its bf16 mode (keyed
    ``<kernel>_bf16``; its bound counts 2 bytes an element of B); the
    plain twins take the bf16 B, the library call one f32 PyTorch call on
    the upcast operands (upcast before the timing)."""
    from milnce_tpu_torch.losses.milnce_chunked import milnce_default_chunk
    from milnce_tpu_torch.ops import milnce_stream as ms

    b, bg, k = 128, 8192, 5
    chunk = milnce_default_chunk(b, k, bg)
    v, t, v_all, t_all = _case(b, bg, k, d, 7, False)
    v_all, t_all = v_all.to(dtype), t_all.to(dtype)
    wide = {id(v_all): v_all.float(), id(t_all): t_all.float()}
    row = ms.lse_fwd(v, t_all)
    col = ms.lse_fwd(t, v_all)
    g_row = torch.full((b,), 1.0 / b, device="cuda")
    g_col = torch.full((b * k,), 1.0 / b, device="cuda")
    pairs = [(v, t_all, row, g_row, chunk * k), (t, v_all, col, g_col, chunk)]

    def dense_w(a, bm, lse, g):
        bm = wide.get(id(bm), bm)         # the operands upcast beforehand
        return torch.exp(a @ bm.T - lse[:, None]) * g[:, None]

    def rows_library(a, bm, lse, g):
        return dense_w(a, bm, lse, g) @ wide.get(id(bm), bm)

    def cols_library(a, bm, lse, g):
        return dense_w(a, bm, lse, g).T @ a

    lib = ms._lib()
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def slab(name):
        """A kernel's slab path at a depth its cluster path takes, through
        its wrapper's private plan argument: (call, plan of (r, c))."""
        def plan_of(r, c):
            if name == "lse_fwd":
                return ms.fwd_plan(r, c, d, sms, slab=True)
            return (ms.cols_plan if name == "lse_bwd_cols" else ms.rows_plan)(
                r, c, d, sms, slab=True)

        def run(a, bm, lse, g):
            plan = plan_of(a.shape[0], bm.shape[0])
            if name == "lse_fwd":
                return ms.launch_fwd(lib, a, bm, _plan=plan)[0]
            return ms.launch_bwd(lib, a, bm, lse, g, name == "lse_bwd_cols",
                                 _plan=plan)[0]
        return run, plan_of

    # the plain twins sum the deep paths' parts as the kernels do
    parts = ms.deep_parts(d) if d > ms.STREAM_DMAX else None
    # kernel: (its wrapper, the card's plan, plain, library call, FLOPs per
    # logit and depth)
    funcs = {
        "lse_fwd": (
            lambda a, bm, lse, g: ms.lse_fwd(a, bm),
            lambda r, c: ms.card_fwd_plan(lib, r, c, d, "cuda"),
            lambda a, bm, lse, g, w: ms.lse_plain(a, bm, w, parts),
            lambda a, bm, lse, g: torch.logsumexp(
                a @ wide.get(id(bm), bm).T, dim=1),
            2),
        "lse_bwd_rows": (
            ms.lse_bwd_rows,
            lambda r, c: ms.card_bwd_plan(lib, False, r, c, d, "cuda"),
            lambda *x: ms.lse_bwd_rows_plain(*x, parts), rows_library, 4),
        "lse_bwd_cols": (
            ms.lse_bwd_cols,
            lambda r, c: ms.card_bwd_plan(lib, True, r, c, d, "cuda"),
            lambda *x: ms.lse_bwd_cols_plain(*x, parts), cols_library, 4)}
    # key: (call, kernel, plan, plain, library call, FLOPs)
    kernels = {}
    for name, (kern, plan_of, plain, library, per) in funcs.items():
        kernels[ms.launch_key(name, d, dtype)] = (kern, name, plan_of, plain,
                                                  library, per)
        if ms.launch_mode(name, d)[1] == "deep":
            run, slab_plan = slab(name)
            kernels[ms.launch_key(name, d, dtype, slab=True)] = (
                run, name, slab_plan, plain, library, per)
    out = {}
    for key, (kern, name, plan_of, _, library, per) in kernels.items():
        for a, bm, lse, g, _ in pairs:
            r, c = a.shape[0], bm.shape[0]
            plan = plan_of(r, c)
            ms_k = _time_ms(lambda: kern(a, bm, lse, g))
            ms_l = _time_ms(lambda: library(a, bm, lse, g))
            dev_k = _device_ms(lambda: kern(a, bm, lse, g),
                               KERNEL_KEYS[name])
            dev_c = _device_ms(lambda: kern(a, bm, lse, g), "")
            dev_l = _device_ms(lambda: library(a, bm, lse, g), "")
            flops = per * r * c * d
            bound_ms, bound_by = _bound(flops, _stream_bytes(name, r, c, d,
                                                             dtype))
            log(f"  {key} launch R={r} C={c} D={d}: kernel "
                f"{ms_k:.4f} ms, "
                f"{flops / ms_k / 1e9:.2f} TFLOP/s, {bound_ms / ms_k:.3f} of "
                f"the f32 bound ({bound_ms:.4f} ms, {bound_by}) | library "
                f"{ms_l:.4f} ms, kernel/library {ms_k / ms_l:.3f} | on the "
                f"device: kernel alone {dev_k:.4f} ms ({bound_ms / dev_k:.3f} "
                f"of the bound), whole call {dev_c:.4f} ms, library "
                f"{dev_l:.4f} ms, call/library {dev_c / dev_l:.3f} | plan: "
                f"{_plan_line(plan)}")
    for key, (kern, name, _, plain, library, _) in kernels.items():
        flops = nbytes = 0
        for a, bm, *_ in pairs:
            r, c = a.shape[0], bm.shape[0]
            # the backward recomputes the logits + one product
            flops += (2 if name == "lse_fwd" else 4) * r * c * d
            nbytes += _stream_bytes(name, r, c, d, dtype)
        bound_ms, bound_by = _bound(flops, nbytes)

        def pair_k(kern=kern):
            return [kern(a, bm, l, g) for a, bm, l, g, _ in pairs]

        def pair_l(library=library):
            return [library(a, bm, l, g) for a, bm, l, g, _ in pairs]

        ms_k = _time_ms(pair_k)
        ms_p = _time_ms(lambda: [plain(*x) for x in pairs])
        ms_l = _time_ms(pair_l)
        dev_k = _device_ms(pair_k, KERNEL_KEYS[name])
        dev_c = _device_ms(pair_k, "")
        dev_l = _device_ms(pair_l, "")
        out[key] = dict(
            ms=ms_k, plain_ms=ms_p, library_ms=ms_l, bound_ms=bound_ms,
            bound_by=bound_by, device_ms=dev_k, call_device_ms=dev_c,
            library_device_ms=dev_l)
        log(f"  {key}: kernel {ms_k:.4f} ms ({flops / ms_k / 1e9:.2f} "
            f"TFLOP/s, {bound_ms / ms_k:.3f} of the bound) | plain "
            f"{ms_p:.3f} ms | dense torch {ms_l:.4f} ms (kernel/library "
            f"{ms_k / ms_l:.3f}) | on the device: kernel alone "
            f"{dev_k:.4f} ms ({bound_ms / dev_k:.3f} of the bound), whole "
            f"call {dev_c:.4f} ms, dense torch {dev_l:.4f} ms (call/library "
            f"{dev_c / dev_l:.3f}) | bound "
            f"{bound_ms:.4f} ms ({bound_by}, {flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB) per step's pair of launches, B={b} "
            f"Bg={bg} K={k} D={d}")
    return out


def _sdtw_case(b, n, m, feat, gamma, seed):
    """A cost from the port's own distance functions: negative_dot (the
    sdtw_3 default) at gamma 0.1, cosine (the cdtw default) at 1e-5, on
    features of unit scale."""
    from milnce_tpu_torch.ops.softdtw import DIST_FUNCS

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, n, feat), generator=gen, device="cuda") / feat ** 0.5
    y = torch.randn((b, m, feat), generator=gen, device="cuda") / feat ** 0.5
    dist = "negative_dot" if gamma >= 0.1 else "cosine"
    return DIST_FUNCS[dist](x, y).contiguous()


def _table_err(got, want):
    """Error of a forward table: the BIG sentinel cells must be the same
    set, hold the same value to 1e-6 relative, and the real cells are held
    to the usual limit."""
    from milnce_tpu_torch.ops.softdtw import BIG

    big = want >= BIG / 2
    if not torch.equal(big, got >= BIG / 2):
        raise AssertionError("kernel and plain forward tables disagree on "
                             "which cells hold the BIG sentinel")
    if bool(big.any()):
        rel = float(((got - want).abs() / want)[big].max())
        if rel > 1e-6:
            raise AssertionError(f"sentinel cells differ by {rel:.2e} rel")
    return _err(got[~big], want[~big])


def phase_softdtw_parity():
    """Each soft-DTW kernel alone against its plain version: softdtw_fwd
    on the cost (value and table), softdtw_bwd on the plain forward's
    table (grad_D under a random cotangent and under ones(1).expand(B),
    the stride-0 cotangent autograd hands in for ``out.sum()``).  Returns
    the worst error of each kernel."""
    from milnce_tpu_torch.ops import softdtw_cuda as sd

    cases = [(label, b, n, m, f, 0) for label, b, n, m, f in SDTW_PRESETS]
    cases += SDTW_EXTRA
    worst = {name: 0.0 for name in sd.LAUNCHES}
    seed = bitwise = grads = fwd_bitwise = fwds = 0
    for label, b, n, m, feat, band in cases:
        plan = sd.bwd_plan(b, n, m)
        log(f"  [{label}] softdtw_fwd plan: {sd.fwd_plan(b, n, m)}")
        log(f"  [{label}] softdtw_bwd plan: {plan}")
        if label == "past the ring" and plan.ring != "global":
            raise AssertionError(f"{label}: N={n} does not pass the shared "
                                 f"ring (largest N {sd.bwd_shared_max_n()})")
        for gamma in (0.1, 1e-5):
            seed += 1
            D = _sdtw_case(b, n, m, feat, gamma, seed)
            cotangents = {
                "random": torch.randn(b, device="cuda", generator=torch
                                      .Generator(device="cuda")
                                      .manual_seed(seed)),
                "expanded": torch.ones(1, device="cuda").expand(b)}
            val_k, r_k = sd.softdtw_fwd(D, gamma, band)
            val_p, r_p = sd.softdtw_fwd_plain(D, gamma, band)
            torch.cuda.synchronize()
            same = torch.equal(val_k, val_p) and torch.equal(r_k, r_p)
            fwd_bitwise += same
            fwds += 1
            checks = [("softdtw_fwd", f"value{', bitwise' if same else ''}",
                       val_k, _err(val_k, val_p)),
                      ("softdtw_fwd", "R", r_k, _table_err(r_k, r_p))]
            for what, g in cotangents.items():
                got = sd.softdtw_bwd(r_p, g, gamma, band)
                want = sd.softdtw_bwd_plain(r_p, g, gamma, band)
                torch.cuda.synchronize()
                same = torch.equal(got, want)
                bitwise += same
                grads += 1
                checks.append(("softdtw_bwd",
                               f"grad_D[{what}{', bitwise' if same else ''}]",
                               got, _err(got, want)))
            line = []
            for kern, what, out, (err, lim) in checks:
                worst[kern] = max(worst[kern], err)
                line.append(f"{what} {err:.2e}/{lim:.2e}")
                finite = bool(torch.isfinite(out).all())
                if err > lim or not finite:
                    raise AssertionError(
                        f"{label} gamma={gamma}: {kern} {what} disagrees with "
                        f"its plain version ({err} > {lim}, finite={finite})")
            log(f"  [{label} B={b} N={n} M={m} band={band} gamma={gamma}] "
                f"err/limit: {', '.join(line)} ok")
    log(f"  softdtw_fwd: value and R bit for bit in {fwd_bitwise} of {fwds} "
        f"cases")
    log(f"  softdtw_bwd: grad_D bit for bit equal to the plain version's in "
        f"{bitwise} of {grads} cases")
    return worst


def _sfu_rate():
    """Special-function results per second: per-clock rate x SMs x the
    card's max SM clock (nvidia-smi)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return H100_SFU_PER_CLOCK_SM * sms * mhz * 1e6, mhz, sms


def _device_kernels(fn, key, reps=20):
    """Mean device time (ms) per call of ``fn`` of the kernels whose name
    holds ``key`` (the kernel alone, or with key '' every kernel the call
    launches), and those kernels' names: ``rows_probe.device_kernels``,
    the mean of a session's recorded launches times the launches a
    call."""
    from milnce_tpu_torch.ops.rows_probe import device_kernels

    return device_kernels(fn, key, reps, log)


def _device_ms(fn, key, reps=20):
    """The device time of :func:`_device_kernels`."""
    return _device_kernels(fn, key, reps)[0]


def phase_softdtw_timing():
    """Both soft-DTW kernels and their plain versions at the four presets
    and at a full-width training shape (gamma 0.1), beside the bound of
    what the function needs, not of what the kernels move: bytes (forward:
    read D, write the dense (N+1) x (M+1) table R that the backward
    needs; backward: read that R, write grad_D) at the HBM rate, and
    special-function operations (forward 3 exp + 1 log per cell; backward
    the 3 exp of a cell's Cuturi-Blondel weights) at the SFU rate; the
    larger wins.  The backward is timed three ways: the kernel alone on
    the device, every kernel of the autograd backward's call on the
    device, and a call (of ``softdtw_bwd``, and of the autograd backward),
    beside the previous backward's figures.  Returns the first preset's
    numbers."""
    from milnce_tpu_torch.ops import softdtw_cuda as sd

    sfu, mhz, sms = _sfu_rate()
    log(f"  SFU rate {sfu / 1e12:.3f} T/s ({H100_SFU_PER_CLOCK_SM}/clk/SM x "
        f"{sms} SMs x {mhz:.0f} MHz)")
    out = {}
    for label, b, n, m, feat in SDTW_PRESETS + [SDTW_TRAIN_TIMED]:
        D = _sdtw_case(b, n, m, feat, 0.1, 7)
        _, r = sd.softdtw_fwd(D, 0.1)
        g = torch.ones(1, device="cuda").expand(b)
        leaf = D.clone().requires_grad_(True)
        value = sd.softdtw_cuda(leaf, 0.1)

        def autograd_bwd():
            return torch.autograd.grad(value, leaf, g, retain_graph=True)

        cells = b * n * m
        d_bytes = 4 * cells                 # D, and grad_D of its shape
        r_bytes = 4 * b * (n + 1) * (m + 1)
        work = {"softdtw_fwd": (d_bytes + r_bytes, 4 * cells,
                                lambda: sd.softdtw_fwd(D, 0.1),
                                lambda: sd.softdtw_fwd_plain(D, 0.1)),
                "softdtw_bwd": (r_bytes + d_bytes, 3 * cells,
                                lambda: sd.softdtw_bwd(r, g, 0.1),
                                lambda: sd.softdtw_bwd_plain(r, g, 0.1))}
        for name, (nbytes, ops, kern, plain) in work.items():
            t_bytes, t_ops = nbytes / H100_HBM_BYTES, ops / sfu
            bound_ms = max(t_bytes, t_ops) * 1e3
            bound_by = "operations" if t_ops >= t_bytes else "bytes"
            ms_k, ms_p = _time_ms(kern), _time_ms(plain)
            dev = _device_ms(kern, f"{name}_kernel")
            extra = {}
            line = (f"  {name} {label}: kernel {ms_k:.4f} ms per call, "
                    f"{dev:.4f} ms on the device")
            if name == "softdtw_fwd":
                call_dev, launched = _device_kernels(kern, "")
                if len(launched) != 1 or name not in launched[0]:
                    raise AssertionError(f"a softdtw_fwd call launched "
                                         f"{launched}, not its one kernel")
                extra = dict(call_device_ms=call_dev)
                old_call, old_dev = SDTW_FWD_BEFORE[(b, n, m)]
                line += (f", whole call {call_dev:.4f} ms on the device "
                         f"(one kernel) (before: {old_call:.4f} per call, "
                         f"{old_dev:.4f} on the device; {old_dev / dev:.2f}x)"
                         f" | plan {sd.fwd_plan(b, n, m)}")
            if name == "softdtw_bwd":
                extra = dict(autograd_ms=_time_ms(autograd_bwd),
                             autograd_device_ms=_device_ms(autograd_bwd, ""))
                old_call, old_dev = SDTW_BWD_BEFORE[(b, n, m)]
                line += (f" (before: {old_call:.4f} per call, {old_dev:.4f} "
                         f"on the device; {old_dev / dev:.2f}x) | autograd "
                         f"backward {extra['autograd_ms']:.4f} ms per call, "
                         f"every kernel of it "
                         f"{extra['autograd_device_ms']:.4f} ms on the "
                         f"device | plan {sd.bwd_plan(b, n, m)}")
            log(f"{line} | plain {ms_p:.3f} ms | bound {bound_ms:.5f} ms "
                f"({bound_by}: {nbytes / 1e6:.2f} MB, {ops / 1e6:.2f} M SFU "
                f"ops) | {n + m - 1} dependent diagonal steps, "
                f"{dev / (n + m - 1) * 1e3:.4f} us each on the device")
            if name not in out:
                out[name] = dict(ms=ms_k, plain_ms=ms_p, library_ms=None,
                                 bound_ms=bound_ms, bound_by=bound_by,
                                 device_ms=dev, shape=[b, n, m, feat],
                                 **extra)
    return out


def _small_cfg(impl, backend, embedding_dim=512):
    from milnce_tpu_torch.config import tiny_preset

    cfg = tiny_preset()
    cfg.model.embedding_dim = embedding_dim
    cfg.parallel.platform = "cuda"
    cfg.model.inception_blocks = 2
    cfg.data.num_frames, cfg.data.video_size = 8, 64
    cfg.data.num_candidates = 3
    cfg.data.synthetic_num_samples = 24
    cfg.train.batch_size = 8
    cfg.train.max_steps = 3
    cfg.train.n_display = 1
    cfg.loss.milnce_impl, cfg.loss.milnce_backend = impl, backend
    cfg.loss.milnce_chunk = 3
    return cfg


def phase_reference(dim=512):
    """A small model with embedding ``dim`` on the card, chunked loss on the
    kernels against the dense loss, with cuDNN held deterministic so that
    the loss is the only difference: (1) every parameter's gradient of one
    step, within 1e-5 + 1e-4 * max|dense gradient| per tensor; (2) the
    losses of three training steps (warmup gives the first step lr 0, so
    the third loss is the first that sees an update), within rel 2e-4.
    Parameters after Adam are not compared element by element: Adam turns
    last-bit noise in a near-zero gradient into a visible part of an
    lr-sized step.  Past D = 768 the kernels run their deep mode (past
    D = 4096 the slab path), and the config check lets the
    run through.  Returns the launches of the chunked training run,
    counted from 0 just before it: each kernel of the mode twice a
    step."""
    from milnce_tpu_torch.losses.milnce_chunked import build_milnce_loss
    from milnce_tpu_torch.models.build import build_model
    from milnce_tpu_torch.ops import milnce_stream as ms

    torch.backends.cudnn.deterministic = True
    try:
        cfg = _small_cfg("chunked", "cuda", dim)
        model = build_model(cfg.model, seed=3).cuda().train()
        gen = torch.Generator(device="cuda").manual_seed(3)
        d = cfg.data
        video = torch.rand((cfg.train.batch_size, d.num_frames, d.video_size,
                            d.video_size, 3), generator=gen, device="cuda")
        text = torch.randint(1, cfg.model.vocab_size,
                             (cfg.train.batch_size * d.num_candidates,
                              d.max_words), generator=gen, device="cuda")
        grads = {}
        for impl in ("dense", "chunked"):
            cfg.loss.milnce_impl = impl
            model.zero_grad(set_to_none=True)
            build_milnce_loss(cfg.loss)(*model(video, text)).backward()
            grads[impl] = {n: p.grad.clone()
                           for n, p in model.named_parameters()
                           if p.grad is not None}
        worst = max(float((grads["chunked"][n] - g).abs().max())
                    / (1e-5 + 1e-4 * float(g.abs().max()))
                    for n, g in grads["dense"].items())
        log(f"  one step's gradients, {len(grads['dense'])} tensors: worst "
            f"|chunked - dense| / limit = {worst:.3e}")
        runs = {}
        for impl, backend in (("dense", "auto"), ("chunked", "cuda")):
            losses = []
            ms.reset_launches()
            _run_training(_small_cfg(impl, backend, dim), log=lambda _m: None,
                          on_step=lambda _s, _t, loss, _w: losses.append(loss))
            launches = dict(ms.LAUNCHES)
            runs[impl] = losses
    finally:
        torch.backends.cudnn.deterministic = False
    ld, lc = runs["dense"], runs["chunked"]
    err = max(abs(a - b) / abs(b) for a, b in zip(lc, ld))
    log(f"  D={dim}: losses dense {ld} chunked/cuda {lc}; max rel diff "
        f"{err:.2e}; the chunked run's launches {launches}")
    want = dict.fromkeys(launches, 0)
    want.update({ms.launch_key(name, dim): 2 * 3 for name in ms.KERNELS})
    if not (worst <= 1.0 and len(lc) == len(ld) == 3 and err <= 2e-4
            and all(map(math.isfinite, lc)) and launches == want):
        raise AssertionError("chunked/cuda training disagrees with dense")
    return launches


# reference-bf16's limits, from bf16's unit roundoff 2^-8.  The kernels and
# the plain twins compute the same f32 lse and gradients from the same bf16
# embeddings (to f32 summation order), so a bf16 embedding gradient they
# hand back differs in its last bit at most, in a few elements: each loss of
# three steps within REF_BF16_ULPS unit roundoffs of itself.  The bf16
# backward carries such a last-bit difference on and rounds it at every op
# after (to a few % of a gradient in places, so no limit per tensor in unit
# roundoffs holds), so the parameter gradients' difference is held to the
# bf16 rounding noise itself: over all the gradients, within REF_BF16_NOISE
# of the bf16 model's distance from the f32 model's on the same weights and
# clips.  On an H100 the sound runs read 0.030-0.032 of it; a planted fault,
# the kernels' bf16 gathered gradient off by 8 unit roundoffs
# (REF_BF16_FAULT), must read above the limit, or the check could not see
# one.
REF_BF16_ULPS = 4
REF_BF16_NOISE = 0.1
REF_BF16_FAULT = 2.0 ** -5


@contextlib.contextmanager
def _cols_off(ms, rel):
    """The stream's gathered gradients (``lse_bwd_cols``, which
    ``_StreamCuda`` looks up at each call) scaled by 1 + ``rel`` in their
    dtype: a planted fault."""
    kernel = ms.lse_bwd_cols
    ms.lse_bwd_cols = lambda a, b, lse, g: (
        kernel(a, b, lse, g).float() * (1 + rel)).to(b.dtype)
    try:
        yield
    finally:
        ms.lse_bwd_cols = kernel


def phase_reference_bf16(dim=512):
    """The small model with ``model.dtype = bfloat16`` (f32 weights, bf16
    compute) and embedding ``dim`` (past 768 the kernels' deep mode, past
    4096 the slab paths), cuDNN deterministic, chunked MIL-NCE on the
    stream kernels' bf16 mode against the same model on the plain twins
    (``scan``), so
    that the stream is the only difference: (1) one step's parameter
    gradients, all together, no farther from the plain twins' than
    REF_BF16_NOISE times the plain twins' distance from the f32 model's
    (same weights, the clip divided by 255 in f32), the bf16 rounding
    noise, while the kernels with a planted fault (:func:`_cols_off` by
    REF_BF16_FAULT) read above it; (2) three training steps' losses within
    REF_BF16_ULPS x 2^-8 relative; (3) the kernels' run launched each
    ``_bf16`` kernel twice a step, the plain run none.  Returns the
    kernels' run's launches."""
    from milnce_tpu_torch.losses.milnce_chunked import build_milnce_loss
    from milnce_tpu_torch.models.build import build_model
    from milnce_tpu_torch.ops import milnce_stream as ms

    eps = 2.0 ** -8
    torch.backends.cudnn.deterministic = True
    try:
        cfg = _small_cfg("chunked", "cuda", dim)
        cfg.model.dtype = "bfloat16"
        gen = torch.Generator(device="cuda").manual_seed(3)
        d = cfg.data
        video = torch.randint(0, 256, (cfg.train.batch_size, d.num_frames,
                                       d.video_size, d.video_size, 3),
                              generator=gen, device="cuda",
                              dtype=torch.uint8)
        text = torch.randint(1, cfg.model.vocab_size,
                             (cfg.train.batch_size * d.num_candidates,
                              d.max_words), generator=gen, device="cuda")
        grads = {}
        for label, dtype, backend in (("f32", "float32", "scan"),
                                      ("plain", "bfloat16", "scan"),
                                      ("kernels", "bfloat16", "cuda"),
                                      ("fault", "bfloat16", "cuda")):
            cfg.model.dtype, cfg.loss.milnce_backend = dtype, backend
            model = build_model(cfg.model, seed=3).cuda().train()
            clip = video.to(model.compute_dtype or torch.float32) / 255
            with (_cols_off(ms, REF_BF16_FAULT) if label == "fault"
                  else contextlib.nullcontext()):
                build_milnce_loss(cfg.loss)(*model(clip, text)).backward()
            grads[label] = {n: p.grad for n, p in model.named_parameters()
                            if p.grad is not None}

        def dist(a, b):
            return math.sqrt(sum(float((grads[a][n] - g).double().pow(2)
                                       .sum()) for n, g in grads[b].items()))

        d_kp, d_pf = dist("kernels", "plain"), dist("plain", "f32")
        d_fault = dist("fault", "plain")
        worst = max((float((grads["kernels"][n] - g).norm())
                     / float((g - grads["f32"][n]).norm()), n)
                    for n, g in grads["plain"].items())
        log(f"  bf16 model, D={dim}, one step's gradients, "
            f"{len(grads['plain'])} "
            f"tensors: |kernels - plain| {d_kp:.4e} against the bf16 noise "
            f"|plain - f32| {d_pf:.4e}: {d_kp / d_pf:.4f} (limit "
            f"{REF_BF16_NOISE}); the worst tensor {worst[1]} at "
            f"{worst[0]:.4f} of its own noise; a planted fault (the "
            f"gathered gradients scaled by 1 + 2^{math.log2(REF_BF16_FAULT):g}"
            f") {d_fault / d_pf:.4f}, which must exceed the limit")
        runs, launches = {}, {}
        for backend in ("scan", "cuda"):
            run_cfg = _small_cfg("chunked", backend, dim)
            run_cfg.model.dtype = "bfloat16"
            losses = []
            ms.reset_launches()
            _run_training(run_cfg, log=lambda _m: None,
                          on_step=lambda _s, _t, loss, _w: losses.append(loss))
            launches[backend] = {k: n for k, n in ms.LAUNCHES.items() if n}
            runs[backend] = losses
    finally:
        torch.backends.cudnn.deterministic = False
    lp, lk = runs["scan"], runs["cuda"]
    err = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    want = {ms.launch_key(name, dim, torch.bfloat16): 2 * 3
            for name in ms.KERNELS}
    log(f"  bf16 model, D={dim}: losses plain {lp} kernels {lk}; max rel diff "
        f"{err:.2e} (limit {REF_BF16_ULPS * eps:.2e}); launches: kernels' "
        f"run {launches['cuda']}, plain run {launches['scan']}")
    if not (d_kp <= REF_BF16_NOISE * d_pf < d_fault
            and len(lk) == len(lp) == 3
            and err <= REF_BF16_ULPS * eps and all(map(math.isfinite, lk))
            and launches["cuda"] == want and not launches["scan"]):
        raise AssertionError("the bf16 kernels disagree with the plain twins "
                             "in the small model")
    return launches["cuda"]


def phase_train_bf16(train):
    """train-full-bf16: phase 7's config and seed with ``model.dtype =
    bfloat16`` through ``run_training`` (batch 16, 4 steps, chunked MIL-NCE
    on the stream kernels' bf16 mode): every loss finite, each ``_bf16``
    kernel twice a step and no f32 one; the live MFU gauge equal to the
    roofline formula over the card's dense bf16 peak; steps/s, peak
    memory, the data wait, the idle share of one more profiled step and
    the MFU beside phase 7's f32 figures (measured only: no limit on
    speed).  Returns the run's figures."""
    from milnce_tpu_torch.obs import metrics as obs_metrics
    from milnce_tpu_torch.ops import milnce_stream as ms
    from milnce_tpu_torch.ops import softdtw_cuda as sd
    from milnce_tpu_torch.utils.roofline import (device_peak_flops, mfu,
                                                 train_step_flops)

    run = _train_full("milnce", _stream_loss, (ms, sd),
                      {ms.launch_key(k, 512, torch.bfloat16): 2
                       for k in ms.KERNELS}, dtype="bfloat16")
    reg = obs_metrics.registry()
    live = reg.gauge("milnce_train_mfu").value
    clips = reg.gauge("milnce_train_clips_per_sec").value
    name = torch.cuda.get_device_name(0)
    peak16 = device_peak_flops(name, "bfloat16")
    peak32 = device_peak_flops(name, "float32")
    flops = train_step_flops(TRAIN_BATCH, 32, 224, 5, 20)
    want = mfu(flops, clips / TRAIN_BATCH, peak16, 1)
    run["idle"], _ = _profile_step(run["res"].model, run["cfg"])
    del run["res"]
    run["mfu"] = mfu(flops, run["sps"], peak16, 1)
    log(f"  live MFU gauge {live:.6f} against {flops / 1e12:.4f} TFLOP a "
        f"step x {clips / TRAIN_BATCH:.4f} steps/s (last display) / "
        f"{peak16 / 1e12:g} TFLOP/s (bf16) = {want:.6f}")
    log(f"  train-full-bf16 against train-full (f32, phase 7): steps/s "
        f"{run['sps']:.4f} / {train['sps']:.4f} "
        f"({run['sps'] / train['sps']:.4f}x); peak memory "
        f"{run['peak'] / 2 ** 30:.3f} / {train['peak'] / 2 ** 30:.3f} GiB; "
        f"data wait {run['wait']:.4f} / {train['wait']:.4f} s a step; idle "
        f"share {run['idle']:.3f} / {train['idle']:.3f}; MFU at steps/s "
        f"after the first step {run['mfu']:.6f} of the bf16 peak / "
        f"{mfu(flops, train['sps'], peak32, 1):.6f} of the f32 peak; "
        f"losses {run['losses']}")
    if abs(live - want) > 1e-12 * want:
        raise AssertionError(f"MFU gauge {live} != {want}")
    return run


def phase_dtw_reference():
    """The small model with each DTW loss, the soft-DTW kernels
    (sdtw_backend=cuda) against the plain recurrence (scan), cuDNN held
    deterministic: (1) every parameter's gradient of one step, within
    1e-5 + 1e-4 * max|scan gradient| per tensor, with non-constant clip
    start times so that sdtw_cidm's interval terms are live; (2) the
    losses of three training steps, within rel 2e-4."""
    from milnce_tpu_torch.models.build import build_model
    from milnce_tpu_torch.ops import softdtw_cuda as sd
    from milnce_tpu_torch.train.step import _sequence_loss

    torch.backends.cudnn.deterministic = True
    try:
        for name in DTW_LOSSES:
            cfg = _small_cfg("dense", "auto")
            cfg.loss.name = name
            bsz, d = cfg.train.batch_size, cfg.data
            model = build_model(cfg.model, seed=3).cuda().train()
            gen = torch.Generator(device="cuda").manual_seed(3)
            video = torch.rand((bsz, d.num_frames, d.video_size,
                                d.video_size, 3), generator=gen,
                               device="cuda")
            text = torch.randint(1, cfg.model.vocab_size,
                                 (bsz * d.num_candidates, d.max_words),
                                 generator=gen, device="cuda")
            start = torch.arange(bsz, dtype=torch.float32, device="cuda") * 7
            grads, runs = {}, {}
            sd.reset_launches()
            for backend in ("scan", "cuda"):
                cfg.loss.sdtw_backend = backend
                model.zero_grad(set_to_none=True)
                v_seq, t_embd = model(video, text, mode="sequence")
                t_seq = t_embd.reshape(bsz, -1, t_embd.shape[-1])
                _sequence_loss(cfg.loss, v_seq, t_seq, start).backward()
                grads[backend] = {n: p.grad.clone()
                                  for n, p in model.named_parameters()
                                  if p.grad is not None}
            launched = dict(sd.LAUNCHES)
            worst = max(float((grads["cuda"][n] - g).abs().max())
                        / (1e-5 + 1e-4 * float(g.abs().max()))
                        for n, g in grads["scan"].items())
            for backend in ("scan", "cuda"):
                cfg.loss.sdtw_backend = backend
                losses = []
                _run_training(cfg, log=lambda _m: None,
                              on_step=lambda _s, _t, loss, _w:
                              losses.append(loss))
                runs[backend] = losses
            ls, lc = runs["scan"], runs["cuda"]
            err = max(abs(a - b) / abs(b) for a, b in zip(lc, ls))
            log(f"  {name}: {len(grads['scan'])} gradients, worst |cuda - "
                f"scan| / limit {worst:.3e}; kernel launches {launched}; "
                f"losses scan {ls} cuda {lc}, max rel diff {err:.2e}")
            if not (worst <= 1.0 and min(launched.values()) > 0
                    and len(lc) == len(ls) == 3 and err <= 2e-4
                    and all(map(math.isfinite, lc))):
                raise AssertionError(f"{name}: the soft-DTW kernels disagree "
                                     "with the plain recurrence in training")
    finally:
        torch.backends.cudnn.deterministic = False


def _virtual_shard_step(model, optimizer, lr, micro_batches, loss_cfg):
    """The one-graph form of the grad-cache step, its reference: the M
    microbatch forwards in one autograd graph, each with its own
    BatchNorm statistics (the running ones: the mean of the M folds of
    the old ones, as the JAX step's), one loss on the concatenated
    embeddings, one backward; then Adam and the schedule."""
    from milnce_tpu_torch.losses.milnce_chunked import build_milnce_loss
    from milnce_tpu_torch.models.s3dg import BatchNorm3d
    from milnce_tpu_torch.train.step import _running_stats, _sequence_loss

    running = _running_stats(model)
    norms = [m for m in model.modules() if isinstance(m, BatchNorm3d)]
    milnce = loss_cfg.name == "milnce"
    loss_fn = build_milnce_loss(loss_cfg) if milnce else None

    def step(video_u8, text, start):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        bm = video_u8.shape[0] // micro_batches
        rows = text.shape[0] // micro_batches
        old = [r.clone() for r in running]
        folds = [torch.zeros_like(r) for r in running]
        tracked = [m.num_batches_tracked.clone() for m in norms]
        vs, ts = [], []
        for m in range(micro_batches):
            with torch.no_grad():
                for r, o in zip(running, old):
                    r.copy_(o)
            v, t = model(video_u8[m * bm:(m + 1) * bm].float() / 255.0,
                         text[m * rows:(m + 1) * rows],
                         **({} if milnce else {"mode": "sequence"}))
            vs.append(v)
            ts.append(t)
            with torch.no_grad():
                for f, r in zip(folds, running):
                    f.add_(r)
        with torch.no_grad():
            for r, f in zip(running, folds):
                r.copy_(f / micro_batches)
            for m, n in zip(norms, tracked):
                m.num_batches_tracked.copy_(n + 1)
        v, t = torch.cat(vs), torch.cat(ts)
        loss = (loss_fn(v, t) if milnce else _sequence_loss(
            loss_cfg, v, t.reshape(v.shape[0], -1, t.shape[-1]), start))
        loss.backward()
        optimizer.step()
        lr.step()
        return loss.detach()

    return step


def _gc_run(loss_name, micro_batches, counter, poison=""):
    """Three steps of the small model (seed 3) with the grad-cache step at
    ``micro_batches`` and of its one-graph reference, on the same batches.
    Returns per step the grad-cache loss, the reference's, the grad-cache
    step's launches, and after step 1 both sets of gradients; then the
    final running statistics of both, and per step the grad-cache run's
    (parameters, Adam moments, statistics, skipped)."""
    from milnce_tpu_torch.models.build import build_model
    from milnce_tpu_torch.resilience import faults
    from milnce_tpu_torch.train.schedule import build_schedule_total
    from milnce_tpu_torch.train.state import build_optimizer
    from milnce_tpu_torch.train.step import (_running_stats,
                                             make_grad_cache_step)

    cfg = _small_cfg("chunked", "cuda")
    cfg.loss.name = loss_name
    cfg.loss.sdtw_backend = "cuda"
    models, steps = [], []
    for kind in ("gc", "ref"):
        model = build_model(cfg.model, seed=3).cuda().train()
        optimizer, lr = build_optimizer(
            model, cfg.optim, build_schedule_total(cfg.optim, 100))
        if kind == "gc":
            with faults.armed(poison) if poison else contextlib.nullcontext():
                steps.append(make_grad_cache_step(
                    model, optimizer, micro_batches, cfg.loss,
                    finite_guard=True, lr_scheduler=lr))
        else:
            steps.append(_virtual_shard_step(model, optimizer, lr,
                                             micro_batches, cfg.loss))
        models.append((model, optimizer))
    gen = torch.Generator(device="cuda").manual_seed(3)
    bsz, d = cfg.train.batch_size, cfg.data
    out = dict(losses=[], ref=[], launches=[], states=[])
    for i in range(3):
        video = torch.randint(0, 255, (bsz, d.num_frames, d.video_size,
                                       d.video_size, 3), generator=gen,
                              dtype=torch.uint8, device="cuda")
        text = torch.randint(1, cfg.model.vocab_size,
                             (bsz * d.num_candidates, d.max_words),
                             generator=gen, device="cuda")
        start = torch.arange(bsz, dtype=torch.float32, device="cuda") * 7
        counter.reset_launches()
        loss, skipped = steps[0](video, text, start)
        torch.cuda.synchronize()
        out["launches"].append(dict(counter.LAUNCHES))
        out["losses"].append(float(loss))
        out["ref"].append(float(steps[1](video, text, start)))
        model, optimizer = models[0]
        out["states"].append(dict(
            skipped=int(skipped),
            params=[p.detach().clone() for p in model.parameters()],
            moments=[t.clone() for st in optimizer.state.values()
                     for k, t in st.items() if k.startswith("exp_avg")],
            stats=[b.clone() for b in model.buffers()]))
        if i == 0:
            out["grads"] = [{n: p.grad.clone() for n, p in m.named_parameters()
                             if p.grad is not None} for m, _ in models]
    out["running"] = [_running_stats(m) for m, _ in models]
    return out


def phase_gc_reference():
    """The grad-cache step on the card against its one-graph form (the
    identity the JAX tests pin: M microbatches = M virtual shards), the
    small model with cuDNN deterministic and TF32 off, MIL-NCE chunked on
    the stream kernels and sdtw_3 on the soft-DTW kernels, at M = 2 and
    4: every parameter gradient of step 1 within 1e-5 + 1e-4 max|g|,
    three steps' losses within rel 2e-4, every BatchNorm running mean and
    variance after them within 1e-5 + 1e-4 max|x|; each step's launches:
    the stream kernels twice a step (the loss once, on the whole cache,
    not M times), the soft-DTW kernels 6 + 6 (sdtw_3's six DPs, once).
    Then one MIL-NCE run at M = 2 armed with ``grad.nonfinite@2``: step 2
    is skipped, and parameters, Adam's moments and every buffer are
    step 1's after it.  Returns the launches a step."""
    from milnce_tpu_torch.ops import milnce_stream as ms
    from milnce_tpu_torch.ops import softdtw_cuda as sd

    want = {"milnce": (ms, {k: 2 for k in ms.KERNELS}),
            "sdtw_3": (sd, {"softdtw_fwd": 6, "softdtw_bwd": 6})}
    seen = {}
    torch.backends.cudnn.deterministic = True
    try:
        for loss_name, (counter, per_step) in want.items():
            for m in (2, 4):
                run = _gc_run(loss_name, m, counter)
                got, ref = run["grads"]
                worst = max(float((got[n] - g).abs().max())
                            / (1e-5 + 1e-4 * float(g.abs().max()))
                            for n, g in ref.items())
                err = max(abs(a - b) / abs(b)
                          for a, b in zip(run["losses"], run["ref"]))
                stats = max(float((a - b).abs().max())
                            / (1e-5 + 1e-4 * float(b.abs().max()))
                            for a, b in zip(*run["running"]))
                launches = [{k: n for k, n in step.items() if n}
                            for step in run["launches"]]
                seen[loss_name] = launches[0]
                log(f"  {loss_name} M={m}: {len(ref)} gradients, worst |gc - "
                    f"one graph| / limit {worst:.3e}; losses gc "
                    f"{run['losses']} one graph {run['ref']}, max rel diff "
                    f"{err:.2e}; running statistics worst / limit "
                    f"{stats:.3e}; launches a step {launches}")
                if not (worst <= 1.0 and err <= 2e-4 and stats <= 1.0
                        and set(got) == set(ref)
                        and all(map(math.isfinite, run["losses"]))
                        and all(step == per_step for step in launches)):
                    raise AssertionError(f"{loss_name} M={m}: the grad-cache "
                                         "step differs from its one-graph "
                                         "form")
        run = _gc_run("milnce", 2, ms, poison="grad.nonfinite@2")
        before, skipped, after = run["states"]
        same = all(torch.equal(a, b) for key in ("params", "moments", "stats")
                   for a, b in zip(before[key], skipped[key]))
        moved = not all(torch.equal(a, b) for a, b in zip(skipped["params"],
                                                           after["params"]))
        log(f"  grad.nonfinite@2 at M=2: skipped "
            f"{[s['skipped'] for s in run['states']]}; step 2 left "
            f"parameters, moments and buffers as step 1 did: {same}; step 3 "
            f"moved them: {moved}")
        if [s["skipped"] for s in run["states"]] != [0, 1, 0] or not same \
                or not moved:
            raise AssertionError("grad.nonfinite@2 was not skipped cleanly")
    finally:
        torch.backends.cudnn.deterministic = False
    return seen


def _stream_loss(loss):
    """Chunked MIL-NCE on the stream kernels."""
    loss.milnce_impl, loss.milnce_backend = "chunked", "cuda"
    loss.milnce_chunk = TRAIN_CHUNK


def _sdtw_loss(loss):
    """The soft-DTW losses on their kernels."""
    loss.sdtw_backend = "cuda"


def _run_training(cfg, root=None, **kwargs):
    """``run_training`` checkpointing and logging under ``root``, or under
    a temporary directory removed after the run."""
    from milnce_tpu_torch.train.loop import run_training

    if root is not None:
        cfg.train.checkpoint_root = root
        cfg.train.log_root = f"{root}/log"
        return run_training(cfg, **kwargs)
    with tempfile.TemporaryDirectory() as tmp:
        cfg.train.checkpoint_root = f"{tmp}/checkpoints"
        cfg.train.log_root = f"{tmp}/log"
        return run_training(cfg, **kwargs)


def _full_cfg(loss_name, edit, batch=TRAIN_BATCH, accum=1):
    """The full-width training configuration with the loss ``edit``
    applies: TRAIN_STEPS steps at global batch ``batch`` in ``accum``
    microbatches (``train.grad_accum``) on synthetic data, read through
    ``ShardedLoader`` and ``device_prefetch`` with the data knobs'
    defaults (``num_reader_threads`` 20, ``prefetch_depth`` 2)."""
    from milnce_tpu_torch.config import full_preset

    cfg = full_preset()
    cfg.parallel.platform = "cuda"
    cfg.data.synthetic = True
    cfg.data.synthetic_num_samples = batch * TRAIN_STEPS
    cfg.train.batch_size = batch
    cfg.train.grad_accum = accum
    cfg.train.max_steps = TRAIN_STEPS
    cfg.train.n_display = 1
    cfg.loss.name = loss_name
    edit(cfg.loss)
    return cfg


def _train_full(loss_name, edit, counters, per_step, store=None, root=None,
                batch=TRAIN_BATCH, accum=1, remat=False, dtype="float32"):
    """``run_training`` on ``_full_cfg(loss_name, edit, batch, accum)``
    (with ``model.remat`` if ``remat``, ``model.dtype`` ``dtype``), every
    launch counter reset just
    before and read just after; with ``store``, through
    the distributed path: a group of one rank that meets at that
    ``file://`` rendezvous (NCCL on the card); with ``root``, checkpoints
    and logs (the span stream and the ledger) kept under it.
    Each kernel in ``per_step`` must have launched that many times per
    step.  Prints each step's seconds and the seconds the loop waited for
    its batch, and the displayed clips/s beside steps/s x batch.  Returns
    the result, the config, the launches of the run, steps/s after the
    first step, each step's loss, the peak memory allocated (bytes) and
    the run's wall time (host clock around ``run_training``)."""
    cfg = _full_cfg(loss_name, edit, batch, accum)
    cfg.model.remat = remat
    cfg.model.dtype = dtype
    if store is not None:
        cfg.parallel.coordinator_address = f"file://{store}"
        cfg.parallel.num_processes, cfg.parallel.process_id = 1, 0
    steps, shown = [], []

    def show(msg):
        log(f"  {msg}")
        m = re.search(r"Throughput: (\S+) clips/s", msg)
        if m:
            shown.append(float(m.group(1)))

    torch.cuda.reset_peak_memory_stats()
    for counter in counters:
        counter.reset_launches()
    t0 = time.perf_counter()
    res = _run_training(cfg, root, log=show,
                        on_step=lambda s, secs, loss, wait:
                        steps.append((s, secs, loss, wait)))
    wall = time.perf_counter() - t0
    launches = {k: v for counter in counters
                for k, v in counter.LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated()
    for s, secs, loss, wait in steps:
        log(f"  step {s}: {secs:.3f} s, waited {wait:.4f} s for data, "
            f"loss {loss:.6f}")
    later = [secs for _, secs, _, _ in steps[1:]]
    sps = len(later) / sum(later)
    log(f"  steps/s after the first step: {sps:.4f} (first step "
        f"{steps[0][1]:.3f} s); data wait after the first step "
        f"{statistics.mean(w for *_, w in steps[1:]):.4f} s a step; peak "
        f"memory allocated {peak / 2 ** 30:.3f} GiB; launches {launches}")
    log(f"  displayed clips/s after the first step "
        f"{statistics.mean(shown[1:]):.2f} against steps/s x batch "
        f"{sps * cfg.train.batch_size:.2f}")
    if res.steps != TRAIN_STEPS or not all(math.isfinite(x[2]) for x in steps):
        raise AssertionError(f"training failed: {steps}")
    expected = {k: per_step.get(k, 0) * TRAIN_STEPS for k in launches}
    if launches != expected:
        raise AssertionError(f"expected launches {expected} in "
                             f"{TRAIN_STEPS} steps, got {launches}")
    return dict(res=res, cfg=cfg, launches=launches, sps=sps,
                losses=[loss for _, _, loss, _ in steps], peak=peak,
                wall=wall, wait=statistics.mean(w for *_, w in steps[1:]))


def phase_train(work):
    """Chunked MIL-NCE on the stream kernels: each kernel launches twice a
    step (rows and columns direction); the run's stream and ledger are
    checked (``_check_run_obs``).  Returns the launches and steps/s."""
    from milnce_tpu_torch.ops import milnce_stream as ms
    from milnce_tpu_torch.ops import softdtw_cuda as sd
    from milnce_tpu_torch.train.step import make_video_embed_fn

    run = _train_full("milnce", _stream_loss, (ms, sd),
                      {k: 2 for k in ms.KERNELS}, root=f"{work}/train")
    _check_run_obs(run, work)
    res, cfg = run["res"], run["cfg"]
    if (cfg.data.prefetch_depth, cfg.data.num_reader_threads) != (2, 20):
        raise AssertionError("train-full reads through the default loader")
    clip = torch.zeros((2, 32, 224, 224, 3), dtype=torch.uint8, device="cuda")
    emb = make_video_embed_fn(res.model)(clip)
    if emb.shape != (2, 512) or not bool(torch.isfinite(emb).all()):
        raise AssertionError(f"video embedding {tuple(emb.shape)} not finite")
    run["tracked"] = _tracked(res.model)
    run["idle"], _ = _profile_step(res.model, cfg)
    del run["res"]      # the later phases' peak memory holds no stale model
    return run


def _tracked(model) -> dict:
    """Every BatchNorm's ``num_batches_tracked``, by name."""
    return {k: int(v) for k, v in model.state_dict().items()
            if k.endswith("num_batches_tracked")}


GC_BATCH, GC_ACCUM = 128, 8   # train-full-gc: microbatches of TRAIN_BATCH


def phase_train_gc(train, work):
    """train-full's model, frames, K, words, seed, loader and obs at
    ``train.batch_size`` GC_BATCH in ``train.grad_accum`` GC_ACCUM
    microbatches of train-full's 16, through the grad-cache step, chunked
    MIL-NCE on the stream kernels (chunk 8): the kernels run once a step
    at B_local = Bg = 128, so each launches twice a step as in
    train-full, not 2 x 8 times.  Checks every loss finite and 4 ``step``
    spans in its stream; prints steps/s, clips/s beside train-full's in
    this run, peak memory, the idle share of one profiled step and the
    data wait a step."""
    from milnce_tpu_torch.ops import milnce_stream as ms
    from milnce_tpu_torch.ops import softdtw_cuda as sd

    run = _train_full("milnce", _stream_loss, (ms, sd),
                      {k: 2 for k in ms.KERNELS}, root=f"{work}/train-gc",
                      batch=GC_BATCH, accum=GC_ACCUM)
    names = [r["name"] for r in _read_events(run["cfg"].train.log_root)]
    run["idle"], _ = _profile_step(run["res"].model, run["cfg"])
    clips, clips0 = run["sps"] * GC_BATCH, train["sps"] * TRAIN_BATCH
    log(f"  train-full-gc: {run['sps']:.4f} steps/s, {clips:.2f} clips/s "
        f"against train-full's {clips0:.2f} ({clips / clips0:.4f}x); peak "
        f"memory {run['peak'] / 2 ** 30:.3f} GiB (train-full "
        f"{train['peak'] / 2 ** 30:.3f}); idle share {run['idle']:.3f} "
        f"(train-full {train['idle']:.3f}); data wait {run['wait']:.4f} s a "
        f"step; launches a step "
        f"{ {k: n / TRAIN_STEPS for k, n in run['launches'].items() if n} }; "
        f"{names.count('step')} step spans")
    if names.count("step") != TRAIN_STEPS:
        raise AssertionError("train-full-gc's stream lacks its step spans")
    del run["res"]
    return run


def phase_train_remat(train):
    """train-full (phase 7's config, seed and steps) with ``model.remat``:
    each Inception block recomputed in the backward.  Losses within rel
    2e-4 of phase 7's (its run is not cuDNN deterministic), every
    BatchNorm's ``num_batches_tracked`` equal to phase 7's (the
    recomputation folds nothing); peak memory and steps/s beside phase
    7's."""
    from milnce_tpu_torch.ops import milnce_stream as ms
    from milnce_tpu_torch.ops import softdtw_cuda as sd

    run = _train_full("milnce", _stream_loss, (ms, sd),
                      {k: 2 for k in ms.KERNELS}, remat=True)
    tracked = _tracked(run["res"].model)
    del run["res"]
    err = max(abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                                   train["losses"]))
    log(f"  remat against phase 7: losses max rel diff {err:.3e} (limit "
        f"2e-4); steps/s {run['sps']:.4f} / {train['sps']:.4f} "
        f"({run['sps'] / train['sps']:.4f}x); peak memory "
        f"{run['peak'] / 2 ** 30:.3f} / {train['peak'] / 2 ** 30:.3f} GiB; "
        f"num_batches_tracked {sorted(set(tracked.values()))} in "
        f"{len(tracked)} BatchNorms, equal: {tracked == train['tracked']}")
    if not (len(run["losses"]) == len(train["losses"]) == TRAIN_STEPS
            and err <= 2e-4 and tracked == train["tracked"]):
        raise AssertionError("train-full with remat differs from phase 7")
    return run


def _read_events(log_root, name="RUN_EVENTS.jsonl"):
    with open(f"{log_root}/{name}") as fh:
        return [json.loads(line) for line in fh]


def _check_run_obs(run, work):
    """Phase 7's span stream and goodput ledger (``GOODPUT.json``): 4
    ``step`` spans, at least 4 ``data.wait`` spans, one run_id on every
    record; the ledger's categories sum to the phase's wall time (host
    clock around ``run_training``) within 5 %, the JAX test's bound; the
    live MFU gauge equals ``train_step_flops(16, 32, 224, 5, 20)`` times
    the last display's steps/s over the card's peak (rel 1e-12: one float
    expression); and the recorder's cost: its records a step times the
    µs of one span written alone (RECORDER_COST_SPANS to a file), as a
    share of the step, under 1 %."""
    from milnce_tpu_torch.obs import metrics as obs_metrics
    from milnce_tpu_torch.obs.spans import SpanRecorder
    from milnce_tpu_torch.utils.roofline import (device_peak_flops, mfu,
                                                 train_step_flops)

    log_root = run["cfg"].train.log_root
    records = _read_events(log_root)
    with open(f"{log_root}/GOODPUT.json") as fh:
        doc = json.load(fh)
    names = [r["name"] for r in records]
    cats = doc["categories_s"]
    total, wall = sum(cats.values()), run["wall"]
    log(f"  span stream: {len(records)} records ({names.count('step')} step, "
        f"{names.count('data.wait')} data.wait, {names.count('sync')} sync, "
        f"{names.count('display')} display, {names.count('ckpt.save')} "
        f"ckpt.save), run_id {doc.get('run_id')}")
    log(f"  goodput ledger: wall {doc['wall_s']:.4f} s of the phase's "
        f"{wall:.4f} s (categories sum {total:.4f} s, "
        f"{abs(total - wall) / wall:.4f} off, limit 0.05); goodput "
        f"{doc['goodput_fraction']}; "
        + ", ".join(f"{k} {v:.4f} s ({v / total:.4f})"
                    for k, v in sorted(cats.items(), key=lambda x: -x[1])
                    if v))
    reg = obs_metrics.registry()
    live = reg.gauge("milnce_train_mfu").value
    clips = reg.gauge("milnce_train_clips_per_sec").value
    peak = device_peak_flops(torch.cuda.get_device_name(0))
    flops = train_step_flops(TRAIN_BATCH, 32, 224, 5, 20)
    want = mfu(flops, clips / TRAIN_BATCH, peak, 1)
    log(f"  live MFU gauge {live:.6f} against {flops / 1e12:.4f} TFLOP a "
        f"step x {clips / TRAIN_BATCH:.4f} steps/s (last display) / "
        f"{peak / 1e12:g} TFLOP/s = {want:.6f}; at the phase's steps/s "
        f"after the first step ({run['sps']:.4f}): "
        f"{mfu(flops, run['sps'], peak, 1):.6f}")
    rec = SpanRecorder(path=f"{work}/recorder-cost.jsonl")
    t0 = time.perf_counter()
    for i in range(RECORDER_COST_SPANS):
        with rec.span("step", step=i):
            pass
    one_us = (time.perf_counter() - t0) / RECORDER_COST_SPANS * 1e6
    rec.close()
    per_step = len(records) / TRAIN_STEPS
    share = per_step * one_us / (1e6 / run["sps"])
    log(f"  recorder cost: {per_step:.2f} records a step x {one_us:.2f} us "
        f"a span written alone = {per_step * one_us:.1f} us, {share:.2e} "
        f"of a {1e3 / run['sps']:.1f} ms step")
    if not (names.count("step") == TRAIN_STEPS
            and names.count("data.wait") >= TRAIN_STEPS
            and len({r.get("run_id") for r in records}) == 1
            and doc["steps"] == TRAIN_STEPS
            and abs(total - wall) <= 0.05 * wall
            and peak is not None and abs(live - want) <= 1e-12 * want
            and share < 0.01):
        raise AssertionError("train-full's span stream, ledger or MFU "
                             "gauge is off")


def phase_data_alone():
    """The loader and the prefetch with no step, at train-full's batch:
    batches/s with the configured reader threads and with one, the
    synthetic source's samples/s on 1 and on N threads (its ``randint``
    must scale for the threads to help), and every batch that reached the
    card equal, byte for byte, to the same batch stacked on the host."""
    import concurrent.futures as cf

    from milnce_tpu_torch.data.pipeline import (ShardedLoader,
                                                device_prefetch, stack_batch)
    from milnce_tpu_torch.train.loop import build_source

    cfg = _full_cfg("milnce", _stream_loss)
    cfg.data.synthetic_num_samples = TRAIN_BATCH * DATA_BATCHES
    source = build_source(cfg)
    threads = cfg.data.num_reader_threads
    for n in (1, threads):
        with cf.ThreadPoolExecutor(n) as pool:
            t0 = time.perf_counter()
            list(pool.map(lambda i: source.sample(i, None), range(64)))
            dt = time.perf_counter() - t0
        log(f"  synthetic source, {n} thread(s): {64 / dt:.1f} samples/s")
    for n in (threads, 1):
        loader = ShardedLoader(source, TRAIN_BATCH, seed=cfg.train.seed,
                               num_threads=n,
                               lookahead_batches=cfg.data.decode_lookahead)
        t0 = time.perf_counter()
        got = list(device_prefetch(loader.epoch(0), "cuda",
                                   depth=cfg.data.prefetch_depth))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        log(f"  {n} reader thread(s), prefetch depth "
            f"{cfg.data.prefetch_depth}: {len(got)} batches of "
            f"{TRAIN_BATCH} x {cfg.data.num_frames} x {cfg.data.video_size}"
            f"^2 x 3 uint8 in {dt:.3f} s, "
            f"{len(got) / dt:.3f} batches/s ({len(got) * TRAIN_BATCH / dt:.1f}"
            " clips/s)")
        want = [stack_batch(b) for b in loader.epoch(0)]
        bad = [i for i, (g, w) in enumerate(zip(got, want))
               if any(not np.array_equal(g[k].cpu().numpy(), w[k]) for k in w)]
        if len(got) != DATA_BATCHES or len(want) != DATA_BATCHES or bad:
            raise AssertionError(f"batches {bad} on the card differ from "
                                 "the host's")
    log(f"  all {DATA_BATCHES} batches on the card equal the host's, twice")


def phase_resume(root):
    """train-full stopped at step 2 (a forced save of label 0) and resumed
    to step 4 under ``root``, against the same run uninterrupted: steps
    3-4's losses within rel 2e-4, the dtw-ref phase's limit.  cuDNN is
    held deterministic for all three runs, so that the two step-3 and
    step-4 computations run the same algorithms.  Checks the resumed
    batch cursor against ``resume_batch_offset`` and the kernels' launch
    counts (2 + 2 + 2 a step).  In the resumed half a SIGUSR1 after step
    3 arms the bounded capture (``train.capture_dir``, 100 ms), as an
    operator would; the phase compares losses only, so the capture cannot
    disturb it.  ``_check_capture`` holds what it wrote.  Returns the
    checkpoint directory and the uninterrupted run's {step: loss}."""
    from milnce_tpu_torch.ops import milnce_stream as ms
    from milnce_tpu_torch.train.checkpoint import CheckpointManager
    from milnce_tpu_torch.train.loop import resume_batch_offset

    def on_step(losses, s, loss, capture):
        losses[s] = loss
        if capture and s == 3:
            os.kill(os.getpid(), signal.SIGUSR1)

    torch.backends.cudnn.deterministic = True
    log("  cudnn.deterministic = True for the three runs of this phase")
    try:
        ms.reset_launches()
        runs, lines = {}, []
        for name, steps, resume, where in (
                ("whole", TRAIN_STEPS, False, None),
                ("stopped", 2, False, root),
                ("resumed", TRAIN_STEPS - 2, True, root)):
            cfg = _full_cfg("milnce", _stream_loss)
            cfg.train.max_steps, cfg.train.resume = steps, resume
            if resume:
                cfg.train.capture_dir = f"{root}/captures"
                cfg.train.capture_ms = 100.0
            losses = {}
            _run_training(cfg, where, log=lines.append,
                          on_step=lambda s, _t, loss, _w:
                          on_step(losses, s, loss, resume))
            runs[name] = losses
            if name == "stopped":
                ckpt = CheckpointManager(f"{root}/run", create=False)
                stopped_at = ckpt.restore(ckpt.latest_epoch())["step"]
        launches = dict(ms.LAUNCHES)
    finally:
        torch.backends.cudnn.deterministic = False
    want = resume_batch_offset(stopped_at, TRAIN_STEPS)
    shown = [m for m in lines if m.startswith("resumed from")]
    log(f"  losses {runs}; {shown}; launches {launches}")
    err = max(abs(runs["resumed"][s] - runs["whole"][s]) / abs(runs["whole"][s])
              for s in (3, 4))
    log(f"  steps 3-4 resumed against uninterrupted: max rel diff {err:.3e}")
    if not (sorted(runs["resumed"]) == [3, 4] and err <= 2e-4
            and shown == [f"resumed from epoch 0 at batch {want}"]
            and want == 2
            and launches == {k: 2 * 8 if k in ms.KERNELS else 0
                             for k in launches}):
        raise AssertionError("the resumed run differs from the "
                             "uninterrupted one")
    _check_capture(f"{root}/log", [m for m in lines
                                   if m.startswith("SIGUSR1 profiler")])
    return f"{root}/run", runs["whole"]


def _check_capture(log_root, shown):
    """The resumed run's capture: one ``capture.start`` (reason sigusr1)
    and one ``capture.stop`` by its duration (the timer marks it due, the
    loop's thread stops it at the next step boundary), and a Chrome trace
    that names the three stream kernels."""
    records = _read_events(log_root)
    starts = [r for r in records if r["name"] == "capture.start"]
    stops = [r for r in records if r["name"] == "capture.stop"]
    log(f"  capture: {shown}; events {[(r['name'], r.get('reason', r.get('cause'))) for r in starts + stops]}")
    if not (len(starts) == len(stops) == 1
            and starts[0]["reason"] == "sigusr1"
            and stops[0]["cause"] == "duration"):
        raise AssertionError("the resumed run's capture did not start and "
                             "stop once by its duration")
    path = f"{starts[0]['trace_dir']}/trace.json"
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = sorted({e.get("name", "") for e in events
                      if e.get("cat") == "kernel"})
    found = {name: [k for k in kernels if re.search(pat, k)]
             for name, pat in TRACE_NAMES.items()}
    log(f"  trace {path}: {os.path.getsize(path)} bytes, {len(kernels)} "
        f"kernel names; stream kernels: "
        + "; ".join(f"{n}: {v[:1]}" for n, v in found.items()))
    if not all(found.values()):
        raise AssertionError(f"the capture's trace misses a stream kernel: "
                             f"{ {n: bool(v) for n, v in found.items()} }")


def phase_eval(ckpt_dir, workdir):
    """``eval.cli msrvtt`` on the resumed checkpoint at full width with the
    fake decoder, 4 windows of 32 frames at 224^2, on the first
    EVAL_ROWS rows of ``csv/msrvtt_test.csv`` (cut for time).  Checks: the
    metrics equal ``compute_retrieval_metrics`` of the returned
    embeddings, recomputed here; the first batch's video embeddings equal
    ``make_video_embed_fn`` on the same clips within 1e-5 + 1e-4 max|e|.
    No MIL-NCE kernel launches in eval."""
    from milnce_tpu_torch.eval import cli, retrieval
    from milnce_tpu_torch.eval.metrics import compute_retrieval_metrics
    from milnce_tpu_torch.ops import milnce_stream as ms
    from milnce_tpu_torch.train.step import make_video_embed_fn

    with open(Path(__file__).resolve().parent / "csv" / "msrvtt_test.csv") as f:
        rows = f.read().splitlines()[:EVAL_ROWS + 1]
    csv_path = f"{workdir}/msrvtt_{EVAL_ROWS}.csv"
    with open(csv_path, "w") as f:
        f.write("\n".join(rows) + "\n")
    log(f"  eval cut to the first {EVAL_ROWS} of 1000 rows of "
        "csv/msrvtt_test.csv, for time")
    seen = {}
    real = retrieval.extract_retrieval_embeddings

    def spy(model, source, device, batch_size=16, process_group=None):
        seen.update(model=model, source=source, batch=batch_size,
                    devices=device)
        seen["out"] = real(model, source, device, batch_size, process_group)
        return seen["out"]

    ms.reset_launches()
    retrieval.extract_retrieval_embeddings = spy
    try:
        t0 = time.perf_counter()
        metrics = cli.main(["msrvtt", "--ckpt", ckpt_dir, "--csv", csv_path,
                            "--video_root", "videos", "--fake_decoder",
                            "--num_windows", "4", "--num_frames", "32",
                            "--video_size", "224"])
        dt = time.perf_counter() - t0
    finally:
        retrieval.extract_retrieval_embeddings = real
    t, v = seen["out"]
    recomputed = compute_retrieval_metrics(t @ v.T)
    source, bsz = seen["source"], seen["batch"]
    clips = torch.from_numpy(np.stack(
        [source.sample(i)["video"] for i in range(bsz)])).cuda()
    emb = make_video_embed_fn(seen["model"])(clips.flatten(0, 1))
    ref = emb.reshape(bsz, 4, -1).mean(1).cpu().numpy()
    err = float(np.abs(v[:bsz] - ref).max())
    limit = 1e-5 + 1e-4 * float(np.abs(ref).max())
    log(f"  R@1 {metrics['R1']:.4f} R@5 {metrics['R5']:.4f} R@10 "
        f"{metrics['R10']:.4f} MedR {metrics['MR']}; {EVAL_ROWS} videos "
        f"({EVAL_ROWS * 4} clips) in {dt:.3f} s: {EVAL_ROWS / dt:.2f} "
        "videos/s, load and decode included")
    log(f"  metrics recomputed from the embeddings {recomputed}; first "
        f"batch's {bsz} video embeddings against make_video_embed_fn: max "
        f"|diff| {err:.3e} (limit {limit:.3e}); launches {dict(ms.LAUNCHES)}")
    if not (recomputed == metrics and t.shape == v.shape == (EVAL_ROWS, 512)
            and err <= limit and not any(ms.LAUNCHES.values())):
        raise AssertionError("eval disagrees with its own embeddings")
    # the same eval over a device group: one card named twice, so the card
    # runs the whole group path (two model copies, each batch's halves)
    group = ["cuda:0", "cuda:0"]
    t0 = time.perf_counter()
    gt, gv = real(seen["model"], source, group, bsz)
    gdt = time.perf_counter() - t0
    errs = [(float(np.abs(g - w).max()), 1e-5 + 1e-4 * float(np.abs(w).max()))
            for g, w in ((gt, t), (gv, v))]
    log(f"  over the device group {group}: {EVAL_ROWS} videos in "
        f"{gdt:.3f} s: {EVAL_ROWS / gdt:.2f} videos/s against one card's "
        f"{EVAL_ROWS / dt:.2f} (the CLI's, over {seen['devices']}); text "
        f"and video embeddings against the one-card eval's: max |diff| "
        f"{errs[0][0]:.3e} (limit {errs[0][1]:.3e}), {errs[1][0]:.3e} "
        f"(limit {errs[1][1]:.3e})")
    if not (gt.shape == t.shape and gv.shape == v.shape
            and all(e <= lim for e, lim in errs)):
        raise AssertionError("eval over a device group disagrees with one "
                             "card")


EVAL_DDP_ROWS = 24        # rows of csv/msrvtt_test.csv eval-ddp scores


def _eval_ddp_rank(rank, world, store, cfg, out):
    """One rank of eval-ddp, in a process of its own: ``run_training`` of
    ``cfg`` over a gloo group with CUDA tensors on the one card (a
    stand-in for the loop's ``initialize_distributed``, as
    elastic-ddp's), recording each barrier the process meets and whether
    the in-training eval was running then, the rows its source decoded
    and the eval's seconds; then, in this process alone, the eval of the
    run's initial model (the seed's) with no group."""
    import torch.distributed as dist
    from datetime import timedelta

    from milnce_tpu_torch.data import datasets
    from milnce_tpu_torch.models.build import build_model
    from milnce_tpu_torch.parallel.dist import Ranks
    from milnce_tpu_torch.train import loop as loop_mod

    torch.cuda.set_device(0)

    def gloo_group(_parallel):
        dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                rank=rank, world_size=world,
                                timeout=timedelta(seconds=180))
        return Ranks(dist.group.WORLD, rank, world, 0)

    barriers, decoded, inside, secs = [], [], [False], []
    real_barrier, real_eval = dist.barrier, loop_mod._in_training_eval
    real_sample = datasets.MSRVTTSource.sample

    def barrier(*args, **kw):
        barriers.append(inside[0])
        return real_barrier(*args, **kw)

    def evaluate(*args, **kw):
        inside[0] = True
        t0 = time.perf_counter()
        try:
            return real_eval(*args, **kw)
        finally:
            secs.append(time.perf_counter() - t0)
            inside[0] = False

    def sample(self, idx, rng=None):
        decoded.append(idx)
        return real_sample(self, idx, rng)

    loop_mod.initialize_distributed = gloo_group
    dist.barrier, loop_mod._in_training_eval = barrier, evaluate
    datasets.MSRVTTSource.sample = sample
    lines = []
    try:
        res = loop_mod.run_training(cfg, log=lines.append)
    finally:
        dist.barrier, loop_mod._in_training_eval = real_barrier, real_eval
        datasets.MSRVTTSource.sample = real_sample
    model = build_model(cfg.model, seed=cfg.train.seed).to("cuda")
    alone = loop_mod._in_training_eval(cfg, model, torch.device("cuda", 0),
                                       lambda _m: None)
    torch.save(dict(metrics=res.eval_metrics, alone=alone, lines=lines,
                    barriers=barriers, decoded=sorted(set(decoded)),
                    secs=secs, steps=res.steps), out)


def phase_eval_ddp(work):
    """The small model (``_ddp2_cfg``) through ``run_training`` with
    ``train.evaluate`` on: msrvtt on the first EVAL_DDP_ROWS rows of
    ``csv/msrvtt_test.csv`` (the fake decoder, 2 windows, batch 8) before
    step 1, on two gloo ranks on the one card.  Passes when every rank's
    metrics equal the one-process eval's, each rank decoded only its own
    slices (together every row), no rank met a barrier inside its eval,
    rank 0 logged the metrics once and rank 1 not at all.  The ranks
    share ``PYTHONHASHSEED``: the fake decoder seeds by a path's hash."""
    with open(Path(__file__).resolve().parent / "csv" / "msrvtt_test.csv") as f:
        rows = f.read().splitlines()[:EVAL_DDP_ROWS + 1]
    csv_path = f"{work}/msrvtt_{EVAL_DDP_ROWS}.csv"
    with open(csv_path, "w") as f:
        f.write("\n".join(rows) + "\n")
    cfg = _ddp2_cfg()
    cfg.train.max_steps = 1
    cfg.train.evaluate, cfg.train.eval_task = True, "msrvtt"
    cfg.train.batch_size_val, cfg.train.num_windows_test = 8, 2
    cfg.data.eval_csv, cfg.data.eval_video_root = csv_path, "videos"
    cfg.train.checkpoint_root = f"{work}/eval-ddp"
    cfg.train.log_root = f"{work}/eval-ddp/log"
    outs = [f"{work}/eval-ddp-{r}.pt" for r in range(DDP2_WORLD)]
    seed = os.environ.get("PYTHONHASHSEED")
    os.environ["PYTHONHASHSEED"] = "0"
    try:
        _spawn_ranks(_eval_ddp_rank, [(r, DDP2_WORLD, f"{work}/eval-ddp-store",
                                       cfg, outs[r])
                                      for r in range(DDP2_WORLD)], "eval-ddp")
    finally:
        if seed is None:
            os.environ.pop("PYTHONHASHSEED")
        else:
            os.environ["PYTHONHASHSEED"] = seed
    ranks = [torch.load(out, weights_only=False) for out in outs]
    shown = [[m for m in r["lines"] if m.startswith("msrvtt retrieval:")]
             for r in ranks]
    decoded = [r["decoded"] for r in ranks]
    for i, r in enumerate(ranks):
        log(f"  rank {i}: metrics {r['metrics']}, one process {r['alone']}; "
            f"decoded {len(r['decoded'])} of {EVAL_DDP_ROWS} rows; eval "
            f"{r['secs'][0]:.3f} s; barriers met inside the eval "
            f"{sum(r['barriers'])} of {len(r['barriers'])}; lines logged "
            f"{shown[i]}")
    if not (all(r["metrics"] == r["alone"] == ranks[0]["alone"]
                and r["steps"] == 1 and not any(r["barriers"])
                for r in ranks)
            and [len(x) for x in shown] == [1, 0]
            and sorted(set(decoded[0]) | set(decoded[1]))
            == list(range(EVAL_DDP_ROWS))
            and all(len(d) < EVAL_DDP_ROWS for d in decoded)):
        raise AssertionError("eval-ddp failed its checks")


# ------------------------------------------------------------ serve-full
SERVE_MAX_BATCH = 16      # the engine's ladder: 1, 2, 4, 8, 16
# serve (bf16): a row of the bf16 engine's embeddings within this relative
# distance (L2) of the f32 engine's, four bf16 unit roundoffs (2^-8), both
# towers.  On an H100 the sound rows read 3.2e-3-3.7e-3 (under one unit
# roundoff: the roundings of ~20 layers do not add in the worst case); a
# planted fault, each tower's last layer off by 8 unit roundoffs
# (SERVE_BF16_FAULT), must read above the limit.
SERVE_BF16_REL = 4 * 2.0 ** -8
SERVE_BF16_FAULT = 2.0 ** -5
SERVE_BF16_BUCKETS = (1, 16)
SERVE_CLIPS = 64          # clips embedded through the video batcher
SERVE_DISTINCT = 48       # distinct captions among the 64 queries
SERVE_QUERIES = 64
SERVE_CLIENTS = 4         # client threads asking the queries
INDEX_ROWS = 1 << 20      # the corpus the index holds (HowTo100M ~1.2 M clips)
INDEX_K = 10
INDEX_QUERIES = 16


def _timed(fn, reps, warm=1):
    """Median seconds of ``fn()`` over ``reps`` calls after ``warm``, on
    the host clock (a serving call returns host arrays: it synchronizes)."""
    for _ in range(warm):
        fn()
    secs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        secs.append(time.perf_counter() - t0)
    return statistics.median(secs)


def _host_ranking(scores, k):
    """(Q, N) float64 scores -> (Q, k) rows ranked best first, ties by
    the lower row (every row tied with the k-th is a candidate)."""
    out = []
    for s in scores:
        kth = np.partition(-s, k - 1)[k - 1]
        cand = np.nonzero(-s <= kth)[0]           # ascending rows
        out.append(cand[np.argsort(-s[cand], kind="stable")][:k])
    return np.stack(out)


def _plant_ties(corpus, scores, k, protected):
    """Copy corpus rows (and their score columns) so that queries 0-3 each
    have a tie across the k-th place (the copy below the original where
    possible: the copy must win; else above it: the original must keep
    the place) and queries 4-5 a tie inside the top-k; every plant must
    leave the earlier ones standing.  No copy lands on a ``protected``
    row.  Returns [(query, place, lower row, higher row)]."""
    plants = []

    def holds(plant):
        q, place, lo, hi = plant
        order = _host_ranking(scores[q:q + 1], place + 2)[0]
        return (order[place], order[place + 1]) == (lo, hi)

    n = scores.shape[1]
    for q, place in [(q, k - 1) for q in range(4)] + [(4, 2), (5, 3)]:
        r = int(_host_ranking(scores[q:q + 1], place + 1)[0][place])
        taken = {int(x) for x in _host_ranking(scores, k + 1).ravel()}
        taken |= {x for p in plants for x in p[2:]} | set(protected)
        for rows in (range(r - 1, -1, -1), range(r + 1, n)):
            for p in [p for p in rows[:256] if p not in taken][:32]:
                col = scores[:, p].copy()
                scores[:, p] = scores[:, r]
                plant = (q, place, min(p, r), max(p, r))
                if all(holds(x) for x in plants + [plant]):
                    corpus[p] = corpus[r]
                    plants.append(plant)
                    break
                scores[:, p] = col
            if plants and plants[-1][0] == q:
                break
    return plants


def phase_serve_full(ckpt_dir, workdir, card):
    """Serving's first half on the resumed full-width checkpoint: export
    it with ``milnce-export-torch``'s ``main``, boot
    ``InferenceEngine.from_export`` on the card (ladder 1-16), embed
    SERVE_CLIPS clips at 32 frames of 224^2 through a ``DynamicBatcher``,
    answer SERVE_QUERIES caption queries from SERVE_CLIENTS threads through
    a batcher and the cache (twice: the second pass all hits), and index
    the clips padded with seeded unit rows to INDEX_ROWS x 512 f32 with
    planted duplicates.  Checks, each fatal: every bucket's embeddings
    equal ``make_video_embed_fn`` / ``make_text_embed_fn`` on the
    checkpoint's model within 1e-5 + 1e-4 max|e| (TF32 off); the exported
    arrays equal the checkpoint's state bit for bit; every batched or
    cached reply equals the direct call (same limit); cache hits leave
    the engine's call counts unchanged; the top-k of INDEX_QUERIES
    queries equals a numpy exhaustive ranking on the host, ties by the
    lower row; ``recompiles() == 0`` (0 by construction in eager PyTorch:
    a structural invariant, not a health signal); no hand kernel
    launches.  Measured only: the growth of the device memory reserved
    between the end of the ladder sweep and the end of the batched and
    cached passes, which use no new shape.  Prints each entry's
    ms a call at each bucket, videos/s and texts/s at the top bucket, the
    index's ms a query batch beside other selections' and its bound, the
    peak device memory, with the card's name and power limit."""
    import gc
    import threading

    from milnce_tpu_torch.config import full_preset
    from milnce_tpu_torch.models.build import build_model
    from milnce_tpu_torch.ops import milnce_stream as ms
    from milnce_tpu_torch.ops import softdtw_cuda as sd
    from milnce_tpu_torch.serving import export
    from milnce_tpu_torch.serving.batcher import DynamicBatcher
    from milnce_tpu_torch.serving.cache import EmbeddingLRUCache, token_key
    from milnce_tpu_torch.serving.engine import InferenceEngine
    from milnce_tpu_torch.serving.index import DeviceRetrievalIndex
    from milnce_tpu_torch.train.checkpoint import CheckpointManager
    from milnce_tpu_torch.train.step import (make_text_embed_fn,
                                             make_video_embed_fn)
    from milnce_tpu_torch.utils.torch_convert import torch_state_dict_to_flax

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    if any(flags):
        raise AssertionError(f"TF32 is on ({flags}): parity needs it off")
    torch.cuda.reset_peak_memory_stats()
    ms.reset_launches()
    sd.reset_launches()
    cfg = full_preset()
    out = f"{workdir}/export"
    t0 = time.perf_counter()
    export.main(["--checkpoint_dir", ckpt_dir, "--out", out,
                 "--preset", "full"])
    t_export = time.perf_counter() - t0
    _, state = CheckpointManager(ckpt_dir, create=False).restore_raw()
    tree = torch_state_dict_to_flax({k: v.numpy() for k, v in state.items()})
    want = {**export._flatten(tree["params"], "params"),
            **export._flatten(tree["batch_stats"], "batch_stats")}
    with np.load(f"{out}/{export.ARRAYS_FILE}") as z:
        got = {k: z[k] for k in z.files}
    exact = sorted(got) == sorted(want) and all(
        got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes()
        for k in want)
    log(f"  export {t_export:.2f} s: {len(got)} arrays, "
        f"{sum(v.nbytes for v in got.values()) / 2 ** 20:.1f} MiB; equal "
        f"to the checkpoint's state bit for bit: {exact}")

    t0 = time.perf_counter()
    engine = InferenceEngine.from_export(out, device="cuda",
                                         max_batch=SERVE_MAX_BATCH,
                                         min_bucket=1)
    log(f"  engine boot (load, build, move, warm-up sweep of "
        f"{engine.buckets}): {time.perf_counter() - t0:.2f} s")
    ref = build_model(cfg.model)
    ref.load_state_dict(state)
    ref = ref.cuda()
    video_fn, text_fn = make_video_embed_fn(ref), make_text_embed_fn(ref)
    rng = np.random.default_rng(16)
    d = cfg.data
    shape = (d.num_frames, d.video_size, d.video_size, 3)
    worst, rows = 0.0, []

    def check(got, want):
        nonlocal worst
        want = want.cpu().numpy()
        limit = 1e-5 + 1e-4 * float(np.abs(want).max())
        worst = max(worst, float(np.abs(got - want).max()) / limit)

    for b in engine.buckets:
        clips = rng.integers(0, 256, (b,) + shape, dtype=np.uint8)
        ids = rng.integers(1, cfg.model.vocab_size, (b, d.max_words),
                           dtype=np.int32)
        check(engine.embed_video(clips), video_fn(torch.from_numpy(clips)
                                                  .cuda()))
        check(engine.embed_text(ids), text_fn(torch.from_numpy(ids).cuda()))
        v_s = _timed(lambda: engine.embed_video(clips), 5)
        t_s = _timed(lambda: engine.embed_text(ids), 20)
        rows.append((b, v_s, t_s))
        log(f"  bucket {b:2d}: video {v_s * 1e3:8.3f} ms a call "
            f"({b / v_s:8.2f} videos/s), text {t_s * 1e3:7.3f} ms a call "
            f"({b / t_s:9.1f} texts/s)")
    log(f"  every bucket's embeddings against make_video_embed_fn / "
        f"make_text_embed_fn: worst {worst:.3f} of the limit")
    reserved = torch.cuda.memory_reserved()
    del ref, video_fn, text_fn

    clips = rng.integers(0, 256, (SERVE_CLIPS,) + shape, dtype=np.uint8)
    vb = DynamicBatcher(engine.embed_video, engine.bucket_for,
                        max_batch=engine.max_batch, max_delay_ms=5.0,
                        name="video")
    try:
        t0 = time.perf_counter()
        futs = [vb.submit(c) for c in clips]
        clip_emb = np.stack([f.result(timeout=600) for f in futs])
        t_clips = time.perf_counter() - t0
        v_stats = vb.stats()
    finally:
        vb.close()
    direct = np.concatenate([engine.embed_video(clips[i:i + 16])
                             for i in range(0, SERVE_CLIPS, 16)])
    batched_err = float(np.abs(clip_emb - direct).max()) / (
        1e-5 + 1e-4 * float(np.abs(direct).max()))
    log(f"  {SERVE_CLIPS} clips through the video batcher: {t_clips:.3f} s "
        f"({SERVE_CLIPS / t_clips:.2f} videos/s), {v_stats['flushes']} "
        f"flushes, occupancy {v_stats['occupancy']}")

    words = rng.integers(1, cfg.model.vocab_size,
                         (SERVE_DISTINCT, d.max_words), dtype=np.int32)
    queries = np.concatenate([words, words[rng.integers(
        0, SERVE_DISTINCT, SERVE_QUERIES - SERVE_DISTINCT)]])
    cache = EmbeddingLRUCache(4096)
    tb = DynamicBatcher(engine.embed_text, engine.bucket_for,
                        max_batch=engine.max_batch, max_delay_ms=2.0,
                        name="text")

    def ask(rows_out, i0):
        for i in range(i0, SERVE_QUERIES, SERVE_CLIENTS):
            key = token_key(queries[i])
            emb = cache.get(key)
            if emb is None:
                emb = tb.submit(queries[i]).result(timeout=600)
                cache.put(key, emb)
            rows_out[i] = emb

    passes = []
    try:
        for _ in range(2):
            replies = [None] * SERVE_QUERIES
            calls = dict(engine.stats()["calls"])
            hits = cache.stats()["hits"]
            threads = [threading.Thread(target=ask, args=(replies, c))
                       for c in range(SERVE_CLIENTS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            passes.append(dict(secs=time.perf_counter() - t0,
                               replies=np.stack(replies),
                               calls=engine.stats()["calls"] != calls,
                               hits=cache.stats()["hits"] - hits))
        t_stats = tb.stats()
    finally:
        tb.close()
    direct = np.concatenate([engine.embed_text(queries[i:i + 16])
                             for i in range(0, SERVE_QUERIES, 16)])
    # both passes against the direct call: a caption asked twice at once
    # may miss twice, in two buckets, and the later put is what pass 2
    # reads back
    batched_err = max(batched_err, *(float(
        np.abs(p["replies"] - direct).max()) / (
        1e-5 + 1e-4 * float(np.abs(direct).max())) for p in passes))
    log(f"  {SERVE_QUERIES} caption queries from {SERVE_CLIENTS} threads: "
        f"pass 1 {passes[0]['secs'] * 1e3:.2f} ms ({passes[0]['hits']} "
        f"cache hits, {t_stats['flushes']} flushes, occupancy "
        f"{t_stats['occupancy']}), pass 2 {passes[1]['secs'] * 1e3:.2f} ms "
        f"({passes[1]['hits']} hits, engine calls moved: "
        f"{passes[1]['calls']}); batched and cached replies against the "
        f"direct call {batched_err:.3f} of the limit")
    grown = torch.cuda.memory_reserved() - reserved
    log(f"  device memory reserved: {reserved / 2 ** 30:.3f} GiB after the "
        f"ladder sweep, grown by {grown / 2 ** 20:.1f} MiB over the batched "
        f"and cached passes")

    q = passes[0]["replies"][:INDEX_QUERIES]
    corpus, host, across = _index_corpus(clip_emb, q)
    t0 = time.perf_counter()
    index = DeviceRetrievalIndex(corpus, k=INDEX_K,
                                 query_buckets=engine.buckets, device="cuda")
    t_index = time.perf_counter() - t0
    s_dev, i_dev = index.topk(q)
    ranking_ok = np.array_equal(i_dev, host)
    q_s = _timed(lambda: index.topk(q), 20, warm=3)
    q1_s = _timed(lambda: index.topk(q[:1]), 20, warm=3)
    # the selection's share (CUDA events around the call): the matmul
    # alone, the exact selection, a plain f32 topk (ties unordered) and a
    # stable sort of every row
    from milnce_tpu_torch.serving.index import exact_topk

    qd = torch.from_numpy(q).cuda()
    corpus_d = index._shards[0][0]          # the one card's shard
    sc = qd @ corpus_d.T
    cols = torch.arange(INDEX_ROWS, device="cuda")[None]
    parts = {"matmul": lambda: qd @ corpus_d.T,
             "exact selection": lambda: exact_topk(sc, cols, INDEX_K),
             "f32 topk": lambda: torch.topk(sc, INDEX_K, dim=1),
             "stable sort": lambda: torch.sort(sc, dim=1, descending=True,
                                               stable=True)}
    part_ms = {name: _time_ms(fn) for name, fn in parts.items()}
    del qd, sc, cols, corpus_d
    bound = INDEX_ROWS * clip_emb.shape[1] * 4 / H100_HBM_BYTES * 1e3
    peak = torch.cuda.max_memory_allocated()
    launches = {**ms.LAUNCHES, **sd.LAUNCHES}
    log(f"  index: {INDEX_ROWS} x {clip_emb.shape[1]} f32 "
        f"({INDEX_ROWS * clip_emb.shape[1] * 4 / 2 ** 30:.2f} GiB on the "
        f"card) built in {t_index:.2f} s; top-{INDEX_K} of {INDEX_QUERIES} "
        f"queries {q_s * 1e3:.3f} ms a batch, 1 query {q1_s * 1e3:.3f} ms "
        f"(bound {bound:.3f} ms: the corpus read once at "
        f"{H100_HBM_BYTES / 1e12:.2f} TB/s); CUDA events: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in part_ms.items()))
    log(f"  top-{INDEX_K} against the host's exhaustive ranking: equal "
        f"{ranking_ok}; recompiles (0 by construction) engine "
        f"{engine.recompiles()} index {index.recompiles()}; peak device memory {peak / 2 ** 30:.3f} GiB; "
        f"hand kernel launches {launches}")
    top = rows[-1]
    log(f"  serve-full on {card}: video {top[1] * 1e3:.3f} ms / text "
        f"{top[2] * 1e3:.3f} ms a call at bucket {top[0]} ({top[0] / top[1]:.2f}"
        f" videos/s, {top[0] / top[2]:.1f} texts/s); index {q_s * 1e3:.3f} ms "
        f"a batch of {INDEX_QUERIES}; peak {peak / 2 ** 30:.3f} GiB")
    bf16_ok = _serve_bf16(out, engine, index, corpus, words, rng, shape, card)
    ok = (exact and worst <= 1 and batched_err <= 1 and bf16_ok
          and not passes[1]["calls"] and passes[1]["hits"] == SERVE_QUERIES
          and ranking_ok and across >= 2
          and engine.recompiles() == 0 and index.recompiles() == 0
          and not any(launches.values()))
    if not ok:
        raise AssertionError("serve-full failed its checks")
    log(f"== serve-group (serve-full's export and index over the device "
        f"group {list(SERVE_GROUP)}: one card named twice)")
    phase_serve_group(out, engine, index, corpus, host, q, SERVE_GROUP, card)
    log(f"== serve-hosts (serve-full's export and corpus over "
        f"{SERVE_HOSTS_WORLD} gloo ranks on the one card, each serving on "
        f"{list(SERVE_GROUP)}; milnce-serve-torch over them)")
    phase_serve_hosts(out, corpus, q, queries[:INDEX_QUERIES], workdir, card)
    del engine, index, corpus
    gc.collect()
    torch.cuda.empty_cache()
    return out, clip_emb


def _index_corpus(clip_emb, q):
    """The index's corpus: INDEX_ROWS seeded unit rows (made on the card)
    with ``clip_emb`` in the middle, ties planted for the queries ``q``
    across the INDEX_K-th place.  Returns (corpus, the float64 host
    ranking of ``q``, the plants across the k-th place)."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    unit = torch.randn((INDEX_ROWS, clip_emb.shape[1]), generator=gen,
                       device="cuda")
    unit /= unit.norm(dim=1, keepdim=True)
    corpus = unit.cpu().numpy()
    del unit
    mid = INDEX_ROWS // 2
    corpus[mid:mid + len(clip_emb)] = clip_emb
    t0 = time.perf_counter()
    scores = _host_scores(q, corpus)
    plants = _plant_ties(corpus, scores, INDEX_K,
                         range(mid, mid + len(clip_emb)))
    host = _host_ranking(scores, INDEX_K)
    across = sum(p[1] == INDEX_K - 1 for p in plants)
    log(f"  host ranking (float64, {INDEX_ROWS} rows): "
        f"{time.perf_counter() - t0:.2f} s; planted ties {plants} ({across} "
        f"across the k-th place)")
    return corpus, host, across


SERVE_GROUP = ("cuda:0", "cuda:0")   # the default run's group: one card twice
SERVE_GROUP_DEAD = 20                # the dispatch serve.replica_dead kills
SERVE_GROUP_INGEST = 4096            # the corpus's last rows, ingested live


def phase_serve_group(export_dir, engine, index, corpus, host, q, group,
                      card):
    """serve-group: the export served over the device ``group`` beside
    the one-card ``engine`` and ``index`` on the same export and corpus.
    ``InferenceEngine.from_export(device=group)``: both entries at every
    bucket of its ladder within ``1e-5 + 1e-4 max|e|`` of the one-card
    engine's on the same rows (the limit printed); a
    ``DeviceRetrievalIndex`` of ``corpus`` over ``group`` whose top-INDEX_K
    of ``q`` equal the one-card index's and the float64 ``host`` ranking;
    a ``LiveRetrievalIndex`` over ``group`` booted on all but the last
    SERVE_GROUP_INGEST rows of ``corpus``, which it then ingests, whose
    top-INDEX_K at generation 1 equal the ``host`` ranking;
    a pool of two such groups (``ReplicaPool.from_export`` over ``group``
    twice, so ``partition_devices`` makes the groups) under
    ``serve.replica_dead`` mid-traffic: one whole group dead and
    quarantined, its request requeued, every ranking unchanged; no hand
    kernel launched.  Measured, one card and the group in turns (one,
    group, group, one): ms a bucket-16 video and text call, ms a query
    batch of INDEX_QUERIES; and the host's ms to copy one bucket-16 video
    shard up and to launch its forward.  Each check fatal; returns the
    figures."""
    import threading

    from milnce_tpu_torch.ops import milnce_stream as ms
    from milnce_tpu_torch.ops import softdtw_cuda as sd
    from milnce_tpu_torch.resilience import faults
    from milnce_tpu_torch.serving.engine import InferenceEngine
    from milnce_tpu_torch.serving.export import read_export_metadata
    from milnce_tpu_torch.serving.index import DeviceRetrievalIndex
    from milnce_tpu_torch.serving.live_index import LiveRetrievalIndex
    from milnce_tpu_torch.serving.pool import QUARANTINED, ReplicaPool

    group = list(group)
    ms.reset_launches()
    sd.reset_launches()
    t0 = time.perf_counter()
    eng = InferenceEngine.from_export(export_dir, device=group,
                                      max_batch=SERVE_MAX_BATCH, min_bucket=1)
    log(f"  group engine over {group}: boot (load, {len(eng.models)} model "
        f"copies, warm-up sweep of {eng.buckets}) "
        f"{time.perf_counter() - t0:.2f} s")
    meta = read_export_metadata(export_dir)
    shape = tuple(meta["video_shape"])
    words, vocab = meta["tokenizer"]["max_words"], meta["model"]["vocab_size"]
    rng = np.random.default_rng(24)
    checks, m, worst, top = {}, {}, 0.0, {}
    for b in eng.buckets:
        rows = {"video": rng.integers(0, 256, (b,) + shape, dtype=np.uint8),
                "text": rng.integers(1, vocab, (b, words), dtype=np.int32)}
        for entry, x in rows.items():
            got = getattr(eng, f"embed_{entry}")(x)
            want = getattr(engine, f"embed_{entry}")(x)
            limit = 1e-5 + 1e-4 * float(np.abs(want).max())
            err = float(np.abs(got - want).max())
            worst = max(worst, err / limit)
            log(f"  bucket {b:2d} {entry}: max |group - one card| {err:.3e} "
                f"(limit 1e-5 + 1e-4 max|e| = {limit:.3e})")
            top[entry] = x
    checks["every bucket = the one-card engine"] = worst <= 1
    # where a group call's host time goes: a shard's pageable copy and its
    # forward's launches, both on the host before the next card starts
    shard = np.split(top["video"], len(group))[0]
    parts = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xd = torch.from_numpy(shard).to(group[0])
        t1 = time.perf_counter()
        y = eng._fns["video"][0](xd)
        t2 = time.perf_counter()
        y.cpu()
        parts.append((t1 - t0, t2 - t1, time.perf_counter() - t0))
    m["shard"] = [statistics.median(p[i] for p in parts) * 1e3
                  for i in range(3)]
    log(f"  a bucket-{eng.buckets[-1]} video shard of {len(shard)} rows on "
        f"{group[0]}, host clock: its pageable copy {m['shard'][0]:.3f} "
        f"ms, its forward's launches {m['shard'][1]:.3f} ms, the whole "
        f"shard {m['shard'][2]:.3f} ms")
    for entry, reps in (("video", 5), ("text", 20)):
        one_fn = getattr(engine, f"embed_{entry}")
        grp_fn = getattr(eng, f"embed_{entry}")
        x = top[entry]
        t = _abab(f"bucket {eng.buckets[-1]} {entry}",
                  {"one card": lambda: one_fn(x),
                   "group": lambda: grp_fn(x)}, reps)
        m[entry] = (t["one card"], t["group"])
        log(f"    group/one {m[entry][1] / m[entry][0]:.3f}")

    t0 = time.perf_counter()
    gidx = DeviceRetrievalIndex(corpus, k=INDEX_K,
                                query_buckets=eng.buckets, device=group)
    t_index = time.perf_counter() - t0
    _, i_grp = gidx.topk(q)
    _, i_one = index.topk(q)
    checks["index = one card = host ranking"] = (
        np.array_equal(i_grp, i_one) and np.array_equal(i_grp, host))
    log(f"  index over {group}: {[c.shape[0] for c, _, _ in gidx._shards]} "
        f"rows a card, built in {t_index:.2f} s; top-{INDEX_K} of "
        f"{len(q)} queries equal the one-card index's and the host's: "
        f"{checks['index = one card = host ranking']}")
    t = _abab(f"a batch of {len(q)} queries",
              {"one card": lambda: index.topk(q),
               "group": lambda: gidx.topk(q)}, 20, 3)
    m["index"] = (t["one card"], t["group"])
    del eng

    # the live index over the group: booted short of the corpus, the rest
    # ingested (each card's shard on its own copy stream), one swap
    live = LiveRetrievalIndex(corpus[:-SERVE_GROUP_INGEST], k=INDEX_K,
                              query_buckets=gidx.query_buckets, device=group)
    try:
        live.add(corpus[-SERVE_GROUP_INGEST:])
        flushed = live.flush(timeout=120.0)
        _, i_live, gen = live.topk_with_gen(q)
        checks["live index over the group = host ranking"] = (
            flushed and gen == 1 and np.array_equal(i_live, host))
        log(f"  live index over {group}: {SERVE_GROUP_INGEST} rows ingested "
            f"into {live.stats()['shard_rows']} rows a card, generation "
            f"{gen}; top-{INDEX_K} equal the host's: "
            f"{checks['live index over the group = host ranking']}")
    finally:
        live.close()
        del live

    tokens = rng.integers(1, vocab, (INDEX_QUERIES, words), dtype=np.int32)
    pool = ReplicaPool.from_export(
        export_dir, 2, devices=group * 2, max_batch=SERVE_MAX_BATCH,
        min_bucket=1, probe_interval_s=0.2, max_requeues=2)
    try:
        groups = [[str(d) for d in r.engine.group] for r in pool.replicas]
        before = gidx.topk(pool.embed_text(tokens))[1]
        errors, lock = [], threading.Lock()

        def client(n):
            for _ in range(n):
                try:
                    same = np.array_equal(
                        gidx.topk(pool.embed_text(tokens))[1], before)
                except Exception as exc:    # noqa: BLE001 - counted
                    same = f"{type(exc).__name__}: {exc}"
                with lock:
                    if same is not True:
                        errors.append(same)

        with faults.armed(f"serve.replica_dead@{SERVE_GROUP_DEAD}"):
            threads = [threading.Thread(target=client,
                                        args=(POOL_REQUESTS // 4,))
                       for _ in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
        time.sleep(0.5)                  # a few probe intervals
        dead = [r for r in pool.replicas if r.engine.dead]
        after = gidx.topk(pool.embed_text(tokens))[1]
        counts = pool.counts()
        checks["replica_dead: a whole group quarantined, requeued, rankings "
               "identical"] = (
            not errors and len(dead) == 1
            and pool._replica_state(dead[0]) == QUARANTINED
            and counts["requeued"] >= 1 and counts["recoveries"] == 0
            and np.array_equal(after, before))
        log(f"  pool of two groups {groups}: errors {errors[:3]}, dead "
            f"{[r.rid for r in dead]}, counts {counts}")
    finally:
        pool.close()
    launches = {**ms.LAUNCHES, **sd.LAUNCHES}
    checks["no hand kernel launched"] = not any(launches.values())
    log(f"  serve-group on {card} over {group}: video "
        f"{m['video'][1]:.3f} ms a call at bucket {SERVE_MAX_BATCH} (one "
        f"card {m['video'][0]:.3f}), text {m['text'][1]:.3f} (one card "
        f"{m['text'][0]:.3f}); index {m['index'][1]:.3f} ms a batch of "
        f"{len(q)} (one card {m['index'][0]:.3f}); checks {checks}")
    del gidx
    if not all(checks.values()):
        raise AssertionError(f"serve-group failed its checks: {checks}")
    return m


def phase_serve_group_cards(work, card, group=("cuda:0", "cuda:1")):
    """``--serve-group``: a seeded full-width model exported, served on
    cuda:0 alone (ladder 1-16, SERVE_CLIPS clips embedded, an index of
    the clips padded with seeded unit rows to INDEX_ROWS, ties planted,
    its top-INDEX_K of INDEX_QUERIES caption queries against the float64
    host ranking) and by :func:`phase_serve_group` over ``group``."""
    from milnce_tpu_torch.config import full_preset
    from milnce_tpu_torch.models.build import build_model
    from milnce_tpu_torch.serving import export
    from milnce_tpu_torch.serving.engine import InferenceEngine
    from milnce_tpu_torch.serving.index import DeviceRetrievalIndex
    from milnce_tpu_torch.utils.torch_convert import torch_state_dict_to_flax

    cfg = full_preset()
    d = cfg.data
    shape = (d.num_frames, d.video_size, d.video_size, 3)
    tree = torch_state_dict_to_flax({
        k: v.numpy() for k, v in build_model(cfg.model, seed=0)
        .state_dict().items()})
    out = export.export_inference_checkpoint(
        f"{work}/export", tree["params"], tree["batch_stats"], cfg.model,
        max_words=d.max_words, video_shape=shape)
    engine = InferenceEngine.from_export(out, device="cuda:0",
                                         max_batch=SERVE_MAX_BATCH,
                                         min_bucket=1)
    rng = np.random.default_rng(16)
    clip_emb = np.concatenate([engine.embed_video(rng.integers(
        0, 256, (SERVE_MAX_BATCH,) + shape, dtype=np.uint8))
        for _ in range(SERVE_CLIPS // SERVE_MAX_BATCH)])
    q = engine.embed_text(rng.integers(1, cfg.model.vocab_size,
                                       (INDEX_QUERIES, d.max_words),
                                       dtype=np.int32))
    corpus, host, across = _index_corpus(clip_emb, q)
    index = DeviceRetrievalIndex(corpus, k=INDEX_K,
                                 query_buckets=engine.buckets,
                                 device="cuda:0")
    ranked = np.array_equal(index.topk(q)[1], host)
    log(f"  one card (cuda:0): top-{INDEX_K} against the host ranking: "
        f"equal {ranked}")
    if not (ranked and across >= 2):
        raise AssertionError("serve-group: the one-card index failed")
    return phase_serve_group(out, engine, index, corpus, host, q, group,
                             card)


SERVE_HOSTS_WORLD = 2        # serve-hosts: ranks, each serving on 2 devices
SERVE_HOSTS_TIMEOUT = 300    # its process group's collective timeout, s
SERVE_HOSTS_FRONT_INGEST = 8  # rows the front ingests over HTTP


def _plant_across(corpus, scores, k, query, boundary, rows):
    """Copy query ``query``'s k-th row onto a row of the neighbouring
    shard across ``boundary`` ('device': the other device of its rank;
    'rank': the other rank's first shard), outside every query's top
    k + 1, with its score column, so the two tie across the k-th place
    across that boundary.  Returns (lower row, higher row)."""
    r = int(_host_ranking(scores[query:query + 1], k)[0][k - 1])
    rank, dev = divmod(r // rows, 2)
    target = (rank * 2 + 1 - dev if boundary == "device"
              else (1 - rank) * 2)
    taken = {int(x) for x in _host_ranking(scores, k + 1).ravel()}
    p = next(p for p in range(target * rows, (target + 1) * rows)
             if p not in taken)
    corpus[p] = corpus[r]
    scores[:, p] = scores[:, r]
    order = _host_ranking(scores[query:query + 1], k + 1)[0]
    if sorted(order[k - 1:k + 1].tolist()) != sorted([p, r]):
        raise AssertionError(f"the {boundary} plant did not hold")
    return min(p, r), max(p, r)


def _hosts_join(rank, world, backend, store):
    """serve-hosts' rank ``rank`` -> (Ranks, its device group).  ``nccl``:
    ``initialize_serving`` itself (the coordinator knobs over a FileStore,
    ``LOCAL_RANK``/``LOCAL_WORLD_SIZE``: the visible cards split evenly);
    ``gloo``: both ranks on one card, each with the group ``["cuda:0",
    "cuda:0"]``, over gloo (a stand-in for ``initialize_serving``, whose
    cuda ranks take NCCL, which wants a card a rank)."""
    import torch.distributed as dist
    from datetime import timedelta

    from milnce_tpu_torch.config import ParallelConfig
    from milnce_tpu_torch.parallel.dist import Ranks, initialize_serving

    if backend == "gloo":
        torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=timedelta(seconds=SERVE_HOSTS_TIMEOUT))
        return Ranks(dist.group.WORLD, rank, world, 0), ["cuda:0", "cuda:0"]
    os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    return initialize_serving(ParallelConfig(
        coordinator_address=f"file://{store}", num_processes=world,
        process_id=rank, platform="cuda",
        group_timeout_s=SERVE_HOSTS_TIMEOUT))


def _abab(label, fns, reps, warm=1, leader=None):
    """``fns`` {name: fn} timed in turns, in order and back (A B .. B A),
    each a median of ``reps`` calls (``_timed``) -> {name: ms, the mean of
    its two turns}; with ``leader``, the host's ms in its announcements a
    call of the grid's turns (``grid`` in ``fns``)."""
    names = list(fns)
    turns = {n: [] for n in names}
    sent = seconds = 0.0
    for n in names + names[::-1]:
        if n == "grid" and leader is not None:
            s0, c0 = leader.seconds, leader.sent
        turns[n].append(_timed(fns[n], reps, warm) * 1e3)
        if n == "grid" and leader is not None:
            seconds += leader.seconds - s0
            sent += leader.sent - c0
    ms = {n: sum(t) / 2 for n, t in turns.items()}
    if leader is not None:
        ms["announce"] = seconds / sent * 1e3
    log(f"  {label}: ms a call " + ", ".join(
        f"{n} {ms[n]:.3f} ({t[0]:.3f}, {t[1]:.3f})"
        for n, t in turns.items())
        + (f"; rank 0's announcement {ms['announce']:.3f} ms a call"
           if leader is not None else ""))
    return ms


def _hosts_lead(pg, devices, eng, idx, export_dir, corpus, plan):
    """serve-hosts on rank 0, the grid's other ranks replaying its calls
    (``serving/lockstep.py``): the grid engine at every rung against the
    one-card engine on the same rows, the grid index's top-k of the
    queries against the one-card index's, then the grid in turns with one
    card (and with one process over every card, ``plan['four']``)."""
    from milnce_tpu_torch.serving import lockstep
    from milnce_tpu_torch.serving.engine import InferenceEngine
    from milnce_tpu_torch.serving.index import DeviceRetrievalIndex

    leader = lockstep.Leader(pg, SERVE_HOSTS_TIMEOUT)
    eng.announce = idx.announce = leader.announce
    res = {}
    kw = dict(max_batch=SERVE_MAX_BATCH, min_bucket=1)
    one = InferenceEngine.from_export(export_dir, device=devices[0], **kw)
    one_idx = DeviceRetrievalIndex(corpus, k=INDEX_K,
                                   query_buckets=one.buckets,
                                   device=devices[0])
    rng = np.random.default_rng(plan["seed"])
    shape, words, vocab = plan["shape"], plan["words"], plan["vocab"]
    res["engine"], top = [], {}
    for b in eng.buckets:
        rows = {"video": rng.integers(0, 256, (b,) + shape, dtype=np.uint8),
                "text": rng.integers(1, vocab, (b, words), dtype=np.int32)}
        for entry, x in rows.items():
            got = getattr(eng, f"embed_{entry}")(x)
            want = getattr(one, f"embed_{entry}")(x)
            res["engine"].append((b, entry, float(np.abs(got - want).max()),
                                  1e-5 + 1e-4 * float(np.abs(want).max())))
            top[entry] = x
    q = plan["q"]
    res["index"] = (idx.topk(q)[1], one_idx.topk(q)[1])
    video = {"one card": lambda: one.embed_video(top["video"]),
             "grid": lambda: eng.embed_video(top["video"])}
    query = {"one card": lambda: one_idx.topk(q),
             "grid": lambda: idx.topk(q)}
    if plan["four"]:
        cards = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        four = InferenceEngine.from_export(export_dir, device=cards, **kw)
        four_idx = DeviceRetrievalIndex(corpus, k=INDEX_K,
                                        query_buckets=four.buckets,
                                        device=cards)
        res["index_four"] = four_idx.topk(q)[1]
        video["one process"] = lambda: four.embed_video(top["video"])
        query["one process"] = lambda: four_idx.topk(q)
    res["ms_video"] = _abab(f"bucket {eng.buckets[-1]} video", video, 5,
                            leader=leader)
    res["ms_query"] = _abab(f"a batch of {len(q)} queries", query, 20, 3,
                            leader=leader)
    res["closed"] = leader.close()
    return res


def _serve_hosts_rank(rank, world, backend, store, export_dir, corpus_npz,
                      plan, out):
    """One rank of serve-hosts, in a process of its own: the grid engine
    and index from ``export_dir`` and ``corpus_npz`` (``_hosts_lead`` on
    rank 0, ``lockstep.follow`` on the others), then a live index over the
    grid booted on all but the corpus's last SERVE_GROUP_INGEST rows, to
    which rank 0 alone adds them and as many zero rows (past the rung),
    the others replaying; every rank's generation and rung."""
    from milnce_tpu_torch.ops import milnce_stream as ms
    from milnce_tpu_torch.ops import softdtw_cuda as sd
    from milnce_tpu_torch.serving import lockstep
    from milnce_tpu_torch.serving.engine import InferenceEngine
    from milnce_tpu_torch.serving.index import DeviceRetrievalIndex
    from milnce_tpu_torch.serving.live_index import LiveRetrievalIndex
    from milnce_tpu_torch.train.loop import disable_tf32

    disable_tf32()
    ranks, devices = _hosts_join(rank, world, backend, store)
    pg = ranks.group
    with np.load(corpus_npz) as z:
        corpus = z["emb"]
    res = {"devices": devices}
    try:
        t0 = time.perf_counter()
        eng = InferenceEngine.from_export(
            export_dir, device=devices, max_batch=SERVE_MAX_BATCH,
            min_bucket=1, process_group=pg)
        idx = DeviceRetrievalIndex(corpus, k=INDEX_K,
                                   query_buckets=eng.buckets,
                                   device=devices, group=pg)
        res.update(boot_s=time.perf_counter() - t0, buckets=eng.buckets,
                   shards=idx.grid.shards,
                   rows=[int(c.shape[0]) for c, _, _ in idx._shards])
        if rank == 0:
            res.update(_hosts_lead(pg, devices, eng, idx, export_dir,
                                   corpus, plan))
        else:
            res["replayed"] = lockstep.follow(pg, SERVE_HOSTS_TIMEOUT, eng,
                                              idx)
        del idx
        live = LiveRetrievalIndex(corpus[:-SERVE_GROUP_INGEST], k=INDEX_K,
                                  query_buckets=eng.buckets, device=devices,
                                  group=pg)
        try:
            res["live_boot_rung"] = live.stats()["shard_rows"]
            if rank == 0:
                leader = lockstep.Leader(pg, SERVE_HOSTS_TIMEOUT)
                live.announce = leader.announce
                t0 = time.perf_counter()
                live.add(np.concatenate([
                    corpus[-SERVE_GROUP_INGEST:],
                    np.zeros((SERVE_GROUP_INGEST, corpus.shape[1]),
                             np.float32)]))
                flushed = live.flush(timeout=600.0)
                res["live_s"] = time.perf_counter() - t0
                _, rows, gen = live.topk_with_gen(plan["q"])
                res["live"] = dict(flushed=flushed, gen=gen, rows=rows,
                                   closed=leader.close())
            else:
                res["live_replayed"] = lockstep.follow(
                    pg, SERVE_HOSTS_TIMEOUT, eng, live)
            st = live.stats()
            res.update(live_gen=st["generation"], live_rung=st["shard_rows"])
        finally:
            live.close()
        res["launches"] = sum({**ms.LAUNCHES, **sd.LAUNCHES}.values())
    finally:
        ranks.close()
    torch.save(res, out)


def _serve_hosts_cli(rank, world, backend, store, argv, log_path):
    """One rank of ``milnce-serve-torch`` over serve-hosts' grid, in a
    process of its own, its output in ``log_path``: ``main`` joins the
    group itself over NCCL (``nccl``: the coordinator knobs and
    ``LOCAL_RANK``/``LOCAL_WORLD_SIZE``), or through ``_hosts_join``'s
    gloo stand-in."""
    import milnce_tpu_torch.parallel.dist as pdist
    from milnce_tpu_torch.serving import service

    sys.stdout = sys.stderr = open(log_path, "w", buffering=1)
    if backend == "gloo":
        pdist.initialize_serving = (
            lambda _cfg: _hosts_join(rank, world, "gloo", store))
    else:
        os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
        argv = argv + ["--parallel.coordinator_address", f"file://{store}",
                       "--parallel.num_processes", str(world),
                       "--parallel.process_id", str(rank)]
    service.main(argv)


def _hosts_front(export_dir, corpus_npz, backend, tokens, host, grown_host,
                 grow, work):
    """``milnce-serve-torch`` on SERVE_HOSTS_WORLD rank processes over the
    grid, a live index of ``corpus_npz``: rank 0's front answers the
    ``tokens`` query (its top-k against ``host``) and one ingest of
    ``grow`` (generation 1, then ``grown_host``); SIGTERM to rank 0 ends
    both with 0 after one snapshot.  Returns the checks and figures."""
    import torch.multiprocessing as mp

    snap = f"{work}/hosts-snap"
    argv = ["--preset", "full", "--serve.export_dir", export_dir,
            "--serve.corpus_npz", corpus_npz, "--serve.port", "0",
            "--serve.max_batch", str(SERVE_MAX_BATCH),
            "--serve.topk", str(INDEX_K), "--serve.live_index", "true",
            "--serve.index_snapshot_dir", snap,
            "--parallel.group_timeout_s", str(SERVE_HOSTS_TIMEOUT)]
    logs = [f"{work}/hosts-front-{r}.log" for r in range(SERVE_HOSTS_WORLD)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_serve_hosts_cli, args=(
        r, SERVE_HOSTS_WORLD, backend, f"{work}/hosts-front-store", argv,
        logs[r])) for r in range(SERVE_HOSTS_WORLD)]
    out, checks = {}, {}
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        base = None
        while time.perf_counter() - t0 < 600 and base is None:
            text = Path(logs[0]).read_text() if os.path.exists(
                logs[0]) else ""
            m = re.search(r"listening on (http://\S+) ", text)
            base = m.group(1) if m else None
            if base is None and any(not p.is_alive() for p in procs):
                break
            time.sleep(0.2)
        if base is None:
            raise AssertionError("serve-hosts: the front did not boot:\n"
                                 + "\n".join(Path(f).read_text()[-3000:]
                                             for f in logs))
        out["boot_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        code, body, _ = _http(base, "/v1/query",
                              {"token_ids": tokens.tolist()})
        out["query_ms"] = (time.perf_counter() - t1) * 1e3
        got = np.asarray([r["indices"] for r in body["results"]]) \
            if code == 200 else None
        checks["front: 16 queries = host ranking"] = (
            got is not None and np.array_equal(got, host))
        code, body, _ = _http(base, "/v1/index/add", {
            "embeddings": grow.tolist(), "wait": True})
        added = code == 200 and body.get("live") and body["generation"] == 1
        code, body, _ = _http(base, "/v1/query",
                              {"token_ids": tokens.tolist()})
        got = np.asarray([r["indices"] for r in body["results"]]) \
            if code == 200 else None
        checks["front: one ingest, generation 1 = host ranking"] = bool(
            added and got is not None and np.array_equal(got, grown_host)
            and body["index_generation"] == 1)
        t1 = time.perf_counter()
        os.kill(procs[0].pid, signal.SIGTERM)
        for p in procs:
            p.join(300)
        out["stop_s"] = time.perf_counter() - t1
        codes = [p.exitcode for p in procs]
        with open(f"{snap}/index_meta.json") as fh:
            meta = json.load(fh)
        shutil.rmtree(snap)              # 2 GiB the later phases need not
        checks["SIGTERM: every rank exits 0, one snapshot at generation 1"] \
            = codes == [0] * SERVE_HOSTS_WORLD and meta["generation"] == 1
        log(f"  front over {SERVE_HOSTS_WORLD} ranks ({backend}): booted in "
            f"{out['boot_s']:.2f} s, the 16-row query {out['query_ms']:.3f} "
            f"ms over HTTP; exit codes {codes} {out['stop_s']:.2f} s after "
            f"SIGTERM; snapshot generation {meta['generation']}, "
            f"{meta['size']} rows; rank 1: "
            f"{Path(logs[1]).read_text().strip().splitlines()[-1]}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return out, checks


def phase_serve_hosts(export_dir, corpus, q, tokens, work, card,
                      backend="gloo"):
    """serve-hosts: serve-full's export and corpus over a grid of
    SERVE_HOSTS_WORLD ranks, each serving on a group of two devices (four
    shards, rank-major): ``gloo`` -- two rank processes on the one card,
    each with ``["cuda:0", "cuda:0"]``; ``nccl`` -- two of two cards
    each, ``initialize_serving``'s own join (``--serve-hosts``, four
    cards).  Rank 0 drives the grid through ``serving/lockstep.py`` and
    the other rank replays its calls.  Two ties planted across the k-th
    place of queries 6 and 7, across a device boundary and across a rank
    boundary of the grid's shards.  Checks, each fatal: the grid engine's
    video and text calls at every rung within 1e-5 + 1e-4 max|e| of the
    one-card engine's (the limit printed); the grid index's top-INDEX_K
    of ``q`` equal to the one-card index's and the float64 host
    ranking's; a live index over the grid booted on all but the last
    SERVE_GROUP_INGEST rows, which rank 0 ingests with as many zero rows
    past the rung, at generation 1 on every rank, its top-k the host
    ranking's; ``milnce-serve-torch`` over the grid (``_hosts_front``);
    no hand kernel launched.  Measured in turns (``_abab``): ms a
    bucket-16 video call and a query batch, the grid against one card
    (and, over NCCL, against one process over the four cards), rank 0's
    ms in its announcements a call (a header, then an embed's rows
    scattered or a query batch broadcast).  Returns the figures."""
    import torch.multiprocessing as mp

    from milnce_tpu_torch.ops import milnce_stream as ms
    from milnce_tpu_torch.ops import softdtw_cuda as sd
    from milnce_tpu_torch.serving.export import read_export_metadata

    ms.reset_launches()
    sd.reset_launches()
    t0 = time.perf_counter()
    corpus = corpus.copy()
    scores = _host_scores(q, corpus)
    rows = -(-len(corpus) // (2 * SERVE_HOSTS_WORLD))
    plants = {kind: _plant_across(corpus, scores, INDEX_K, query, kind, rows)
              for query, kind in ((6, "device"), (7, "rank"))}
    host = _host_ranking(scores, INDEX_K)
    grown_host = _host_ranking(np.concatenate(
        [scores, np.zeros((len(q), SERVE_GROUP_INGEST))], axis=1), INDEX_K)
    grow = (4.0 * q[:SERVE_HOSTS_FRONT_INGEST] / np.linalg.norm(
        q[:SERVE_HOSTS_FRONT_INGEST], axis=1, keepdims=True)).astype(
        np.float32)
    front_host = _host_ranking(np.concatenate(
        [scores, q.astype(np.float64) @ grow.astype(np.float64).T], axis=1),
        INDEX_K)
    del scores
    npz = f"{work}/hosts-corpus.npz"
    np.savez(npz, emb=corpus)
    log(f"  planted ties across a device boundary {plants['device']} and a "
        f"rank boundary {plants['rank']} ({rows} rows a shard); host "
        f"rankings and the corpus file in {time.perf_counter() - t0:.2f} s")
    meta = read_export_metadata(export_dir)
    plan = dict(q=q, seed=26, shape=tuple(meta["video_shape"]),
                words=meta["tokenizer"]["max_words"],
                vocab=meta["model"]["vocab_size"], four=backend == "nccl")
    outs = [f"{work}/hosts-{r}.pt" for r in range(SERVE_HOSTS_WORLD)]
    _spawn_ranks(_serve_hosts_rank, [
        (r, SERVE_HOSTS_WORLD, backend, f"{work}/hosts-store", export_dir,
         npz, plan, outs[r]) for r in range(SERVE_HOSTS_WORLD)],
        f"serve-hosts over {backend}")
    ranks = [torch.load(o, weights_only=False) for o in outs]
    lead = ranks[0]
    checks = {}
    worst = 0.0
    for b, entry, err, limit in lead["engine"]:
        worst = max(worst, err / limit)
        log(f"  bucket {b:2d} {entry}: max |grid - one card| {err:.3e} "
            f"(limit 1e-5 + 1e-4 max|e| = {limit:.3e})")
    checks["every rung = the one-card engine"] = worst <= 1
    i_grid, i_one = lead["index"]
    checks["index = one card = host ranking"] = (
        np.array_equal(i_grid, i_one) and np.array_equal(i_grid, host))
    if backend == "nccl":
        checks["index = one process over the cards"] = np.array_equal(
            i_grid, lead["index_four"])
    live = lead["live"]
    checks["live: across a rung, generation 1 on every rank = host"] = (
        live["flushed"] and live["closed"] and lead["closed"]
        and np.array_equal(live["rows"], grown_host)
        and [r["live_gen"] for r in ranks] == [1] * SERVE_HOSTS_WORLD
        and all(r["live_rung"] == 2 * r["live_boot_rung"] for r in ranks))
    checks["no hand kernel launched"] = not any(
        r["launches"] for r in ranks) and not any(
        {**ms.LAUNCHES, **sd.LAUNCHES}.values())
    log(f"  grid {[r['devices'] for r in ranks]} over {backend}: buckets "
        f"{lead['buckets']}, shards {[r['shards'] for r in ranks]} of "
        f"{lead['rows']} rows, boot {[round(r['boot_s'], 2) for r in ranks]}"
        f" s; rank 1 replayed {ranks[1]['replayed']} calls, then "
        f"{ranks[1]['live_replayed']} of the live index's; live index "
        f"{SERVE_GROUP_INGEST} + {SERVE_GROUP_INGEST} rows ingested in "
        f"{lead['live_s']:.2f} s, rung {lead['live_boot_rung']} -> "
        f"{lead['live_rung']}, generations {[r['live_gen'] for r in ranks]}")
    front, front_checks = _hosts_front(export_dir, npz, backend, tokens,
                                       host, front_host, grow, work)
    checks.update(front_checks)
    os.remove(npz)
    m = dict(video=lead["ms_video"], query=lead["ms_query"], front=front)
    log(f"  serve-hosts on {card} ({backend}): video "
        f"{m['video']['grid']:.3f} ms a call at bucket {SERVE_MAX_BATCH} "
        f"(one card {m['video']['one card']:.3f}"
        + (f", one process {m['video']['one process']:.3f}"
           if backend == "nccl" else "")
        + f"; announcement {m['video']['announce']:.3f}), query batch "
        f"{m['query']['grid']:.3f} (one card {m['query']['one card']:.3f}"
        + (f", one process {m['query']['one process']:.3f}"
           if backend == "nccl" else "")
        + f"; announcement {m['query']['announce']:.3f}); checks {checks}")
    if not all(checks.values()):
        raise AssertionError(f"serve-hosts failed its checks: {checks}")
    return m


def phase_serve_hosts_cards(work, card, backend="nccl"):
    """``--serve-hosts``: a seeded full-width model exported, its corpus
    made as ``--serve-group``'s, served by :func:`phase_serve_hosts` over
    ``backend`` (``nccl``: two ranks of two cards each)."""
    from milnce_tpu_torch.config import full_preset
    from milnce_tpu_torch.models.build import build_model
    from milnce_tpu_torch.serving import export
    from milnce_tpu_torch.serving.engine import InferenceEngine
    from milnce_tpu_torch.utils.torch_convert import torch_state_dict_to_flax

    cfg = full_preset()
    d = cfg.data
    shape = (d.num_frames, d.video_size, d.video_size, 3)
    tree = torch_state_dict_to_flax({
        k: v.numpy() for k, v in build_model(cfg.model, seed=0)
        .state_dict().items()})
    out = export.export_inference_checkpoint(
        f"{work}/export", tree["params"], tree["batch_stats"], cfg.model,
        max_words=d.max_words, video_shape=shape)
    engine = InferenceEngine.from_export(out, device="cuda:0",
                                         max_batch=SERVE_MAX_BATCH,
                                         min_bucket=1)
    rng = np.random.default_rng(16)
    clip_emb = np.concatenate([engine.embed_video(rng.integers(
        0, 256, (SERVE_MAX_BATCH,) + shape, dtype=np.uint8))
        for _ in range(SERVE_CLIPS // SERVE_MAX_BATCH)])
    tokens = rng.integers(1, cfg.model.vocab_size,
                          (INDEX_QUERIES, d.max_words), dtype=np.int32)
    q = engine.embed_text(tokens)
    corpus, _, _ = _index_corpus(clip_emb, q)
    del engine
    return phase_serve_hosts(out, corpus, q, tokens, work, card, backend)


def _serve_bf16(out, engine, index, corpus, words, rng, shape, card):
    """serve (bf16): ``InferenceEngine.from_export(dtype="bfloat16")`` on
    serve-full's export (every float leaf cast to bf16 on the card, the
    model computing in bf16) beside the f32 ``engine``: at buckets
    SERVE_BF16_BUCKETS each row of its video and text embeddings within
    SERVE_BF16_REL (relative L2) of the f32 engine's, and ms a call of
    each, the two engines in turns (f32, bf16, bf16, f32); at the top
    bucket a planted fault (each tower's last layer, video ``fc`` and text
    ``fc2``, its weight rows and bias scaled by 1 + SERVE_BF16_FAULT and
    1 - SERVE_BF16_FAULT in turn, then restored) above the limit; then
    ``index``
    (serve-full's corpus, ties planted) answers INDEX_QUERIES bf16 text
    queries (float32 arrays of bf16 values) with the exact top-INDEX_K of
    a float64 ranking of the same queries on the host.  Returns whether
    every check held."""
    from milnce_tpu_torch.serving.engine import InferenceEngine

    t0 = time.perf_counter()
    bf16 = InferenceEngine.from_export(out, device="cuda", dtype="bfloat16",
                                       max_batch=SERVE_MAX_BATCH,
                                       min_bucket=1)
    dtypes = {p.dtype for p in bf16.model.parameters()} | {
        b.dtype for b in bf16.model.buffers() if b.is_floating_point()}
    log(f"  serve (bf16): engine boot {time.perf_counter() - t0:.2f} s, "
        f"its parameters and statistics {sorted(map(str, dtypes))}")
    ok = dtypes == {torch.bfloat16}

    def worst_rel(e16, e32):
        return float((np.linalg.norm(e16 - e32, axis=1)
                      / np.linalg.norm(e32, axis=1)).max())

    top = {}      # entry: (the top bucket's rows, their f32 embeddings)
    for b in SERVE_BF16_BUCKETS:
        rows = {"video": rng.integers(0, 256, (b,) + shape, dtype=np.uint8),
                "text": words[:b]}
        for entry, x in rows.items():
            f32_fn = getattr(engine, f"embed_{entry}")
            bf_fn = getattr(bf16, f"embed_{entry}")
            e32, e16 = f32_fn(x), bf_fn(x)
            top[entry] = x, e32
            rel = worst_rel(e16, e32)
            reps = 5 if entry == "video" else 20
            t32a, t16a = _timed(lambda: f32_fn(x), reps), _timed(
                lambda: bf_fn(x), reps)
            t16b, t32b = _timed(lambda: bf_fn(x), reps), _timed(
                lambda: f32_fn(x), reps)
            t32, t16 = (t32a + t32b) / 2, (t16a + t16b) / 2
            ok = ok and rel <= SERVE_BF16_REL and np.isfinite(e16).all()
            log(f"  serve (bf16) bucket {b:2d} {entry}: worst row's relative "
                f"distance from f32 {rel:.4e} (limit "
                f"{SERVE_BF16_REL:.4e}); ms a call bf16 "
                f"{t16 * 1e3:.3f} ({t16a * 1e3:.3f}, {t16b * 1e3:.3f}) "
                f"against f32 {t32 * 1e3:.3f} ({t32a * 1e3:.3f}, "
                f"{t32b * 1e3:.3f}), bf16/f32 {t16 / t32:.3f}")
    for entry, layer in (("video", bf16.model.fc),
                         ("text", bf16.model.text_module.fc2)):
        x, e32 = top[entry]
        keep = [p.detach().clone() for p in layer.parameters()]
        turn = 1 - 2 * (torch.arange(layer.out_features, device="cuda") % 2)
        scale = (1 + SERVE_BF16_FAULT * turn).to(torch.bfloat16)
        with torch.no_grad():
            layer.weight.mul_(scale[:, None])
            layer.bias.mul_(scale)
        try:
            rel = worst_rel(getattr(bf16, f"embed_{entry}")(x), e32)
        finally:
            with torch.no_grad():
                for p, k in zip(layer.parameters(), keep):
                    p.copy_(k)
        ok = ok and rel > SERVE_BF16_REL
        log(f"  serve (bf16) bucket {SERVE_BF16_BUCKETS[-1]:2d} {entry}, a "
            f"planted fault (the last layer's outputs scaled by 1 +- "
            f"2^{math.log2(SERVE_BF16_FAULT):g} in turn): worst row's "
            f"relative distance from f32 {rel:.4e}, which must exceed the "
            f"limit")
    q = bf16.embed_text(words[:INDEX_QUERIES])
    widened = torch.from_numpy(q)
    ok = ok and torch.equal(widened.bfloat16().float(), widened)
    scores = np.concatenate([q.astype(np.float64) @ corpus[i:i + 65536]
                             .astype(np.float64).T
                             for i in range(0, INDEX_ROWS, 65536)], axis=1)
    host = _host_ranking(scores, INDEX_K)
    _, got = index.topk(q)
    ranked = np.array_equal(got, host)
    ok = ok and ranked and bf16.recompiles() == 0
    log(f"  serve (bf16) on {card}: the {INDEX_ROWS}-row index's top-"
        f"{INDEX_K} of {INDEX_QUERIES} bf16 queries equal the float64 host "
        f"ranking: {ranked}; recompiles {bf16.recompiles()}")
    del bf16
    return ok


SERVE_LIVE_ROWS = 1_000_000   # seeded unit rows in the live index's snapshot
SERVE_LIVE_INGEST = 1000      # precomputed rows ingested within the rung
SERVE_LIVE_CLIPS = 2          # clips ingested through the video tower
SERVE_LIVE_CROSS = 48_000     # one-hot rows that carry the corpus past 2**20
SERVE_LIVE_CHUNK = 12_000     # rows a request while crossing
SERVE_LIVE_INFLIGHT = 24      # --serve.max_inflight (a request is 16 rows)
POOL_REQUESTS = 48            # class-pinned query batches through the pool


def _http(base, route, payload=None, timeout=600):
    """(code, JSON body, Retry-After header) of one request; ``payload``
    a JSON-able object or its encoded bytes."""
    import urllib.error
    import urllib.request

    data = (payload if payload is None or isinstance(payload, bytes)
            else json.dumps(payload).encode())
    req = urllib.request.Request(base + route, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            body, code, headers = r.read(), r.status, r.headers
    except urllib.error.HTTPError as e:
        body, code, headers = e.read(), e.code, e.headers
    try:
        body = json.loads(body)
    except ValueError:
        body = body.decode()
    return code, body, headers.get("Retry-After")


def _boot_service(args, log_path, timeout=600):
    """Start ``milnce-serve-torch`` (``python -m``) from this checkout and
    wait for its listening line -> (process, base URL, boot seconds)."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "milnce_tpu_torch.serving.service"] + args,
        stdout=open(log_path, "w"), stderr=subprocess.STDOUT, env=env,
        cwd=str(Path(__file__).resolve().parent))
    while time.perf_counter() - t0 < timeout:
        text = Path(log_path).read_text()
        m = re.search(r"listening on (http://\S+) ", text)
        if m:
            return proc, m.group(1), time.perf_counter() - t0
        if proc.poll() is not None:
            break
        time.sleep(0.2)
    proc.kill()
    raise AssertionError(f"milnce-serve-torch did not boot:\n"
                         f"{Path(log_path).read_text()[-4000:]}")


def _stop_service(proc, timeout=300):
    """SIGTERM (the graceful path: flush, snapshot) -> seconds to exit."""
    t0 = time.perf_counter()
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    if proc.returncode != 0:
        raise AssertionError(f"milnce-serve-torch exited {proc.returncode}")
    return time.perf_counter() - t0


def _metric(text, name):
    """The value of metric ``name`` in a Prometheus scrape, summed over
    its labelled children (one a card for the device-memory gauges)."""
    values = [float(line.split()[-1]) for line in text.splitlines()
              if line.startswith((name + " ", name + "{"))]
    return sum(values) if values else float("nan")


def _host_scores(q, corpus):
    return np.concatenate([q.astype(np.float64) @ corpus[i:i + 65536]
                           .astype(np.float64).T
                           for i in range(0, len(corpus), 65536)], axis=1)


def _ranked_as_host(results, q, corpus, k):
    got = np.asarray([r["indices"] for r in results])
    return bool(np.array_equal(got, _host_ranking(_host_scores(q, corpus),
                                                  k)))


def _unit_rows(n, dim, seed, device="cuda"):
    gen = torch.Generator(device=device).manual_seed(seed)
    unit = torch.randn((n, dim), generator=gen, device=device)
    unit /= unit.norm(dim=1, keepdim=True)
    return unit.cpu().numpy()


def _serve_live_service(export_dir, clip_emb, engine, workdir, rng, tokens,
                        clips, preset="full", device="cuda"):
    """The ``milnce-serve-torch`` half of serve-live -> its measurements
    and checks."""
    import threading

    from milnce_tpu_torch.serving.export import export_corpus_snapshot
    from milnce_tpu_torch.serving.live_index import shard_rung

    dim = clip_emb.shape[1]
    snap = f"{workdir}/live-snap"
    corpus = _unit_rows(SERVE_LIVE_ROWS, dim, 18, device)
    mid = SERVE_LIVE_ROWS // 2
    corpus = np.concatenate([corpus[:mid], clip_emb, corpus[mid:]])
    # ties planted for this process's query embeddings; the service's
    # are read back below and the host ranks with those
    q = engine.embed_text(tokens)
    plants = _plant_ties(corpus, _host_scores(q, corpus), INDEX_K,
                         range(mid, mid + len(clip_emb)))
    export_corpus_snapshot(snap, corpus, generation=0, k=INDEX_K,
                           source="chip_smoke")
    args = ["--preset", preset, "--parallel.platform", device,
            "--serve.export_dir", export_dir,
            "--serve.port", "0", "--serve.max_batch", str(SERVE_MAX_BATCH),
            "--serve.min_bucket", "1", "--serve.topk", str(INDEX_K),
            "--serve.live_index", "true",
            "--serve.index_snapshot_dir", snap,
            "--serve.continuous_batching", "true",
            "--serve.tiers", "interactive:1.0,batch:0.5",
            "--serve.max_inflight", str(SERVE_LIVE_INFLIGHT),
            "--serve.capture_dir", f"{workdir}/live-captures",
            "--serve.capture_ms", "1500"]
    m, checks, failures = {}, {}, []
    m["across"] = sum(p[1] == INDEX_K - 1 for p in plants)
    checks["ties planted across the k-th place"] = m["across"] >= 2
    boot_rung = shard_rung(len(corpus), 1, INDEX_K)
    proc, base = None, None
    stop = threading.Event()

    def watch():
        """/healthz and /metrics answer throughout."""
        while not stop.wait(0.25):
            for route in ("/healthz", "/metrics"):
                try:
                    code, _, _ = _http(base, route, timeout=30)
                except Exception as exc:    # noqa: BLE001 - recorded
                    failures.append(f"{route}: {exc}")
                    continue
                if code != 200:
                    failures.append(f"{route}: {code}")

    try:
        proc, base, m["boot_s"] = _boot_service(args,
                                                f"{workdir}/serve-1.log")
        _, body, _ = _http(base, "/v1/embed_text",
                           {"token_ids": tokens.tolist()})
        served_q = np.asarray(body["embeddings"], np.float32)
        m["embeddings_equal"] = bool(np.array_equal(served_q, q))
        q = served_q
        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        t0 = time.perf_counter()
        code, first, _ = _http(base, "/v1/query", {"token_ids":
                                                   tokens.tolist()})
        m["query_cold_ms"] = (time.perf_counter() - t0) * 1e3
        checks["boot ranking"] = (code == 200 and _ranked_as_host(
            first["results"], q, corpus, INDEX_K))
        gens = [first["index_generation"]]
        lat = []
        for _ in range(10):
            t0 = time.perf_counter()
            _http(base, "/v1/query", {"token_ids": tokens.tolist()})
            lat.append(time.perf_counter() - t0)
        m["query_idle_ms"] = statistics.median(lat) * 1e3
        _, metrics0, _ = _http(base, "/metrics")
        m["reserved_boot"] = _metric(
            metrics0, "milnce_serve_device_memory_reserved_bytes")

        # the capture: armed over HTTP, queries meanwhile (the batcher's
        # thread launches the engine's kernels), its trace read back
        code, armed, _ = _http(base, "/obs/capture", {"reason": "live"})
        for _ in range(5):
            _http(base, "/v1/query", {"token_ids": rng.integers(
                1, 1000, (8, tokens.shape[1])).tolist(), "tier": "batch"})
        trace = Path(armed.get("trace_dir", "-"), "trace.json")
        t0 = time.perf_counter()
        while not trace.exists() and time.perf_counter() - t0 < 120:
            time.sleep(0.5)
        time.sleep(1.0)                 # the export's last write
        kernels = 0
        if trace.exists():
            events = json.loads(trace.read_text()).get("traceEvents", [])
            kernels = sum(1 for e in events if e.get("cat") == "kernel")
        m["capture_kernels"] = kernels
        checks["capture"] = bool(armed.get("armed")) and (
            kernels > 0 or device == "cpu")

        # within the rung: precomputed rows, then clips through the tower
        grow = _unit_rows(SERVE_LIVE_INGEST, dim, 19, device)
        t0 = time.perf_counter()
        code, added, _ = _http(base, "/v1/index/add", {
            "embeddings": grow.tolist(), "wait": True})
        m["swap_in_rung_s"] = time.perf_counter() - t0
        corpus = np.concatenate([corpus, grow])
        clip_rows = engine.embed_video(clips)
        code2, added2, _ = _http(base, "/v1/index/add", {
            "clips": clips.tolist(), "wait": True})
        corpus = np.concatenate([corpus, clip_rows])
        code, after, _ = _http(base, "/v1/query", {"token_ids":
                                                   tokens.tolist()})
        gens.append(after["index_generation"])
        checks["in-rung ranking"] = (
            code == code2 == 200 and added["live"] and added2["live"]
            and added2["size"] == len(corpus)
            and _ranked_as_host(after["results"], q, corpus, INDEX_K))

        # across the rung, queries running beside the swap
        cross = np.zeros((SERVE_LIVE_CROSS, dim), np.int8)
        cross[np.arange(SERVE_LIVE_CROSS),
              rng.integers(0, dim, SERVE_LIVE_CROSS)] = 1
        cross *= rng.choice(np.array([-1, 1], np.int8),
                            (SERVE_LIVE_CROSS, 1))
        # encoded before the querier starts: this process's encoding would
        # otherwise hold the interpreter against its own querier thread
        bodies = [json.dumps({
            "embeddings": cross[lo:lo + SERVE_LIVE_CHUNK].tolist(),
            "wait": lo + SERVE_LIVE_CHUNK >= SERVE_LIVE_CROSS}).encode()
            for lo in range(0, SERVE_LIVE_CROSS, SERVE_LIVE_CHUNK)]
        busy, swapping = [], threading.Event()

        def query_while_swapping():
            while swapping.is_set():
                t0 = time.perf_counter()
                _http(base, "/v1/query", {"token_ids": tokens.tolist()})
                busy.append(time.perf_counter() - t0)

        swapping.set()
        querier = threading.Thread(target=query_while_swapping, daemon=True)
        querier.start()
        t0 = time.perf_counter()
        for body in bodies:
            code, added, _ = _http(base, "/v1/index/add", body)
        m["cross_s"] = time.perf_counter() - t0
        swapping.clear()
        querier.join(600)
        corpus = np.concatenate([corpus, cross.astype(np.float32)])
        m["query_busy_ms"] = (statistics.median(busy) * 1e3 if busy
                              else float("nan"))
        m["query_busy_max_ms"] = max(busy, default=float("nan")) * 1e3
        m["busy_queries"] = len(busy)
        code, crossed, _ = _http(base, "/v1/query", {"token_ids":
                                                     tokens.tolist()})
        gens.append(crossed["index_generation"])
        _, health, _ = _http(base, "/healthz")
        _, metrics1, _ = _http(base, "/metrics")
        _, events, _ = _http(base, "/obs/events?n=2000")
        builds = [(e.get("rows"), e.get("dur_ms"), e.get("host_ms"),
                   e.get("upload_ms"))
                  for e in events["events"] if e.get("name") == "index.build"]
        m["builds"] = builds
        m["reserved_cross"] = _metric(
            metrics1, "milnce_serve_device_memory_reserved_bytes")
        m["max_reserved"] = _metric(
            metrics1, "milnce_serve_device_memory_max_reserved_bytes")
        idx = health["index"]
        m["index"] = {k: idx[k] for k in ("size", "generation", "swaps",
                                          "swap_failures", "shard_rows",
                                          "recompiles")}
        checks["across ranking"] = (
            code == 200 and added["live"] and idx["size"] == len(corpus)
            and idx["shard_rows"] == shard_rung(len(corpus), 1, INDEX_K)
            > boot_rung and idx["recompiles"] == 0
            and _ranked_as_host(crossed["results"], q, corpus, INDEX_K))
        checks["generations advance"] = gens == sorted(set(gens)) \
            and len(gens) == 3

        # a burst past max_inflight: 429 with Retry-After, nothing else
        replies = []

        many = np.concatenate([tokens] * 4)

        def burst(n_rows):
            replies.append(_http(base, "/v1/query", {
                "token_ids": many[:n_rows].tolist()}))

        threads = [threading.Thread(target=burst, args=(n,))
                   for n in [SERVE_LIVE_INFLIGHT + 1] + [12] * 8]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        shed = [r for r in replies if r[0] == 429]
        m["burst"] = (len(shed), len(replies))
        checks["burst sheds"] = (
            len(replies) == len(threads) and len(shed) >= 1
            and all(r[2] is not None and r[1]["kind"] == "shed"
                    for r in shed)
            and all(r[0] == 200 for r in replies if r[0] != 429))
        stop.set()
        watcher.join(30)
        checks["healthz and metrics throughout"] = not failures
        m["watch_failures"] = failures[:3]
        m["stop_s"] = _stop_service(proc)
        proc = None
        proc, base, m["reboot_s"] = _boot_service(args,
                                                  f"{workdir}/serve-3.log")
        code, again, _ = _http(base, "/v1/query", {"token_ids":
                                                   tokens.tolist()})
        checks["reboot bit-exact"] = (code == 200 and again == crossed)
        m["stop2_s"] = _stop_service(proc)
        proc = None
    finally:
        stop.set()
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(30)
    return m, checks


def _pool_phase(export_dir, v2_dir, index, tokens, device="cuda:0"):
    """Two f32 replicas and one int8 edge replica on the one card."""
    import threading

    from milnce_tpu_torch.resilience import faults
    from milnce_tpu_torch.serving.pool import ReplicaPool

    pool = ReplicaPool.from_export(
        export_dir, 2, devices=[device] * 3, max_batch=SERVE_MAX_BATCH,
        min_bucket=1, edge_export_dir=v2_dir, edge_replicas=1,
        probe_interval_s=0.2, max_requeues=2, hedge_quantile=0.95,
        hedge_min_ms=5.0)
    checks, m = {}, {}
    try:
        before = index.topk(pool.embed_text(tokens, cls="f32"))[1]
        errors, lock = [], threading.Lock()

        def client(n):
            for _ in range(n):
                try:
                    emb = pool.embed_text(tokens, cls="f32")
                    same = np.array_equal(index.topk(emb)[1], before)
                except Exception as exc:    # noqa: BLE001 - counted
                    same = f"{type(exc).__name__}: {exc}"
                with lock:
                    if same is not True:
                        errors.append(same)

        with faults.armed("serve.replica_dead@20"):
            threads = [threading.Thread(target=client,
                                        args=(POOL_REQUESTS // 4,))
                       for _ in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
        after = index.topk(pool.embed_text(tokens, cls="f32"))[1]
        stats = pool.pool_stats()
        dead = [r for r in stats["replicas"] if r["dead"]]
        checks["replica_dead requeued, rankings identical"] = (
            not errors and len(dead) == 1 and dead[0]["class"] == "f32"
            and stats["requeued"] >= 1 and np.array_equal(after, before))
        calls = {r.rid: dict(r.engine.stats()["calls"])
                 for r in pool.replicas}
        for _ in range(4):
            pool.embed_text(tokens, cls="edge")
        moved = {r.rid: r.engine.stats()["calls"] != calls[r.rid]
                 for r in pool.replicas}
        checks["class pins strict"] = all(
            moved[r.rid] == (r.cls == "edge") for r in pool.replicas)
        m.update(errors=errors[:3], counts=pool.counts(),
                 states=[(r["id"], r["class"], r["state"], r["dispatches"])
                         for r in stats["replicas"]])
    finally:
        pool.close()
    return m, checks


def _swap_overlap(dim, q, device="cuda"):
    """In process, with no HTTP and no JSON: ms a top-k batch of ``q``
    on a live index of SERVE_LIVE_ROWS unit rows, run in a loop on a
    thread of its own (a) beside nothing, (b) beside a pageable copy of
    the same rows on a side stream, the upload as it was before the
    pinned staging, and (c) beside a swap of SERVE_LIVE_INGEST rows within
    the rung (host concatenate, pinned staged upload, warm) -> ({case:
    (median ms, max ms, batches, s of the work)}, the swap's (host ms,
    upload ms, build ms), checks)."""
    import threading

    from milnce_tpu_torch.obs.spans import SpanRecorder
    from milnce_tpu_torch.serving.live_index import LiveRetrievalIndex

    rows = _unit_rows(SERVE_LIVE_ROWS, dim, 21, device)
    rec = SpanRecorder()
    index = LiveRetrievalIndex(rows, k=INDEX_K, query_buckets=(len(q),),
                               device=device, recorder=rec)

    def beside(work):
        lat, stop = [], threading.Event()

        def loop():
            while not stop.is_set():
                t0 = time.perf_counter()
                index.topk(q)
                lat.append(time.perf_counter() - t0)

        th = threading.Thread(target=loop, daemon=True)
        th.start()
        time.sleep(0.1)
        t0 = time.perf_counter()
        work()
        took = time.perf_counter() - t0
        stop.set()
        th.join(60)
        return (statistics.median(lat) * 1e3, max(lat) * 1e3, len(lat),
                took)

    def pageable():
        side = torch.cuda.Stream(device)
        with torch.cuda.stream(side):
            up = torch.from_numpy(rows).to(device, non_blocking=True)
        side.synchronize()
        del up

    grow = _unit_rows(SERVE_LIVE_INGEST, dim, 22, device)

    def swap():
        index.add(grow)
        if not index.flush(120):
            raise AssertionError("the in-process swap did not go live")

    out = {"idle": beside(lambda: time.sleep(0.5)),
           "pageable": beside(pageable), "staged": beside(swap)}
    build = [e for e in rec.tail() if e["name"] == "index.build"][-1]
    split = (build["host_ms"], build["upload_ms"], build["dur_ms"])
    corpus = np.concatenate([rows, grow])
    _, got = index.topk(q)
    checks = {"in-process swap ranking": bool(
        index.generation == 1 and index.size == len(corpus)
        and np.array_equal(got, _host_ranking(_host_scores(q, corpus),
                                              INDEX_K)))}
    index.close()
    return out, split, checks


def phase_serve_live(export_dir, clip_emb, workdir, card):
    """Serving's second half on serve-full's export (the resumed
    full-width checkpoint).  The service: ``milnce-serve-torch`` as a
    subprocess on 127.0.0.1 with a live index booted from a snapshot of
    SERVE_LIVE_ROWS seeded unit rows plus serve-full's clips (ties planted
    across the 10th place; rung 1,048,576), continuous batching, two
    tiers, max_inflight SERVE_LIVE_INFLIGHT, a snapshot directory and a
    capture directory: the top-10 of 16 token rows equal a float64 host
    ranking at boot, after ingesting precomputed rows and clips through
    the video tower within the rung, and after one-hot rows carry it
    across to 2,097,152 (the generation advancing each time); a capture
    armed over HTTP holds the engine's kernels; a burst past max_inflight
    gets 429 with Retry-After; /healthz and /metrics answer throughout;
    after SIGTERM a reboot from the snapshot answers bit for bit.  Quant:
    ``calibrate_and_quantize`` with NUMERICS.md, the v2 export, the int8
    engine against an f32 engine over the host-dequantized weights within
    1e-5 + 1e-4 max|e| at buckets 1 and 16 (TF32 off), ``distill_text_
    student`` at hidden 512.  Pool: two f32 replicas and one int8 edge
    replica on the card; ``serve.replica_dead`` mid-traffic, requeued,
    rankings identical; class pins strict.  Measured only, printed with
    the card: ms a query batch idle and while swaps run, seconds a swap,
    reserved memory across the crossing, int8 and student recall@10
    against f32, ms a call of the int8 and f32 engines, resident bytes,
    the pool's hedge and requeue counts."""
    import gc

    from milnce_tpu_torch.config import full_preset
    from milnce_tpu_torch.quant.calibrate import calibrate_and_quantize
    from milnce_tpu_torch.quant.distill import (build_student_variables,
                                                distill_text_student,
                                                student_model_config)
    from milnce_tpu_torch.quant.quantize import (dequantize_params,
                                                 resident_bytes)
    from milnce_tpu_torch.serving.engine import InferenceEngine
    from milnce_tpu_torch.serving.export import (export_inference_checkpoint,
                                                 export_quantized_checkpoint,
                                                 load_inference_checkpoint)
    from milnce_tpu_torch.serving.index import DeviceRetrievalIndex
    from milnce_tpu_torch.models.build import build_model

    cfg = full_preset()
    d = cfg.data
    shape = (d.num_frames, d.video_size, d.video_size, 3)
    rng = np.random.default_rng(170)
    tokens = rng.integers(1, cfg.model.vocab_size, (INDEX_QUERIES,
                                                    d.max_words),
                          dtype=np.int32)
    clips = rng.integers(0, 256, (SERVE_LIVE_CLIPS,) + shape, dtype=np.uint8)
    t_phase = time.perf_counter()
    f32 = InferenceEngine.from_export(export_dir, device="cuda",
                                      max_batch=SERVE_MAX_BATCH, min_bucket=1)
    m, checks = _serve_live_service(export_dir, clip_emb, f32, workdir, rng,
                                    tokens, clips)
    t_service = time.perf_counter() - t_phase
    overlap, split, overlap_checks = _swap_overlap(
        clip_emb.shape[1], f32.embed_text(tokens))
    checks.update(overlap_checks)
    gc.collect()
    torch.cuda.empty_cache()

    # quant at full width
    _, variables = load_inference_checkpoint(export_dir)
    t0 = time.perf_counter()
    qvars, cal = calibrate_and_quantize(
        f32.model, variables, video_batches=[clips.astype(np.float32)],
        text_batches=[tokens], numerics_report="NUMERICS.md")
    t_cal = time.perf_counter() - t0
    v2_dir = f"{workdir}/export-int8"
    export_quantized_checkpoint(v2_dir, qvars, cfg.model,
                                max_words=d.max_words, video_shape=shape,
                                calibration=cal)
    int8 = InferenceEngine.from_export(v2_dir, device="cuda",
                                       max_batch=SERVE_MAX_BATCH,
                                       min_bucket=1)
    deq = InferenceEngine(build_model(cfg.model), {
        "params": dequantize_params(qvars["params"], qvars["quant_scales"]),
        "batch_stats": qvars["batch_stats"]}, device="cuda",
        text_words=d.max_words, video_shape=shape,
        max_batch=SERVE_MAX_BATCH, min_bucket=1)
    worst, timing = 0.0, []
    for b in (1, SERVE_MAX_BATCH):
        vb = rng.integers(0, 256, (b,) + shape, dtype=np.uint8)
        tb = rng.integers(1, cfg.model.vocab_size, (b, d.max_words),
                          dtype=np.int32)
        for got, want in ((int8.embed_video(vb), deq.embed_video(vb)),
                          (int8.embed_text(tb), deq.embed_text(tb))):
            limit = 1e-5 + 1e-4 * float(np.abs(want).max())
            worst = max(worst, float(np.abs(got - want).max()) / limit)
        timing.append((b, *(_timed(lambda e=e, x=x, f=f: getattr(e, f)(x),
                                   5 if f == "embed_video" else 20) * 1e3
                            for e in (int8, f32)
                            for f, x in (("embed_video", vb),
                                         ("embed_text", tb)))))
    checks["int8 equals f32 over the dequantized weights"] = worst <= 1
    m["resident"] = (resident_bytes(int8.model), resident_bytes(f32.model))
    del deq
    t0 = time.perf_counter()
    sparams, sinfo = distill_text_student(
        f32.model, variables, max_words=d.max_words, hidden_dim=512)
    t_distill = time.perf_counter() - t0
    svars = build_student_variables(variables, sparams)
    s_dir = f"{workdir}/export-student"
    export_inference_checkpoint(
        s_dir, svars["params"], svars["batch_stats"],
        student_model_config(cfg.model, 512), max_words=d.max_words,
        video_shape=shape)
    student = InferenceEngine.from_export(s_dir, device="cuda",
                                          max_batch=SERVE_MAX_BATCH,
                                          min_bucket=1)
    corpus = np.concatenate([_unit_rows(INDEX_ROWS - len(clip_emb),
                                        clip_emb.shape[1], 20), clip_emb])
    index = DeviceRetrievalIndex(corpus, k=INDEX_K,
                                 query_buckets=f32.buckets, device="cuda")
    top = {name: index.topk(e.embed_text(tokens))[1]
           for name, e in (("f32", f32), ("int8", int8),
                           ("student", student))}
    recall = {name: float(np.mean([len(set(a) & set(b)) / INDEX_K
                                   for a, b in zip(top[name], top["f32"])]))
              for name in ("int8", "student")}
    del int8, student
    gc.collect()
    pool_m, pool_checks = _pool_phase(export_dir, v2_dir, index, tokens)
    checks.update(pool_checks)
    del f32, index, corpus
    gc.collect()
    torch.cuda.empty_cache()

    log(f"  service: boot {m['boot_s']:.2f} s (snapshot of "
        f"{SERVE_LIVE_ROWS + len(clip_emb)} rows, ladder 1-16), planted "
        f"ties across the 10th place {m['across']}, its embeddings equal "
        f"this process's engine's: {m['embeddings_equal']}; a batch of "
        f"{INDEX_QUERIES} queries over HTTP {m['query_idle_ms']:.3f} ms "
        f"idle (first {m['query_cold_ms']:.3f} ms), "
        f"{m['query_busy_ms']:.3f} ms median / {m['query_busy_max_ms']:.3f}"
        f" ms max while the crossing swapped ({m['busy_queries']} batches)")
    log(f"  swaps: {SERVE_LIVE_INGEST} rows within the rung "
        f"{m['swap_in_rung_s']:.3f} s (add + flush over HTTP); "
        f"{SERVE_LIVE_CROSS} rows across it in "
        f"{SERVE_LIVE_CROSS // SERVE_LIVE_CHUNK} requests "
        f"{m['cross_s']:.3f} s; builder spans (rows, ms; host concatenate "
        f"ms, upload ms): {m['builds']}")
    log("  in process, no HTTP: a batch of "
        f"{INDEX_QUERIES} top-k (median ms, max ms, batches, s of the "
        f"work) {overlap}; the swap's host concatenate / staged upload / "
        f"build {split} ms")
    log(f"  index {m['index']}; device memory reserved "
        f"{m['reserved_boot'] / 2 ** 30:.3f} GiB at boot, "
        f"{m['reserved_cross'] / 2 ** 30:.3f} GiB after the crossing, peak "
        f"{m['max_reserved'] / 2 ** 30:.3f} GiB; burst {m['burst'][0]} of "
        f"{m['burst'][1]} shed; capture kernels {m['capture_kernels']}; "
        f"SIGTERM (flush, snapshot) {m['stop_s']:.2f} s, reboot "
        f"{m['reboot_s']:.2f} s; watch failures {m['watch_failures']}")
    log(f"  quant: calibrate {t_cal:.2f} s, per-channel "
        f"{len(cal['per_channel'])} of {len(qvars['quant_scales'])} "
        f"(verdicts from {cal['verdict_source']}), quality "
        f"{cal['quality']}; int8 against f32 over the dequantized weights "
        f"{worst:.3f} of the limit; resident model state int8 "
        f"{m['resident'][0] / 2 ** 20:.1f} MiB against f32 "
        f"{m['resident'][1] / 2 ** 20:.1f} MiB")
    for b, iv, it, fv, ft in timing:
        log(f"  bucket {b:2d}: int8 video {iv:.3f} ms / text {it:.3f} ms a "
            f"call, f32 video {fv:.3f} ms / text {ft:.3f} ms")
    log(f"  distill (hidden 512, {sinfo['steps']} steps, batch "
        f"{sinfo['batch_size']}): {t_distill:.2f} s, final cosine "
        f"{sinfo['final_cosine']:.4f}, loss {sinfo['final_loss']:.4f}")
    log(f"  recall@10 against f32 on the {INDEX_ROWS}-row index: int8 "
        f"{recall['int8']:.4f}, student {recall['student']:.4f}")
    log(f"  pool: {pool_m['counts']}; replicas {pool_m['states']}; errors "
        f"{pool_m['errors']}")
    log(f"  serve-live on {card}: service part {t_service:.1f} s, phase "
        f"{time.perf_counter() - t_phase:.1f} s; checks {checks}")
    if not all(checks.values()):
        raise AssertionError(f"serve-live failed its checks: "
                             f"{[k for k, v in checks.items() if not v]}")


def phase_cudnn_benchmark(default_sps):
    """One more train-full run with ``torch.backends.cudnn.benchmark =
    True``, measured only (the default stays off)."""
    from milnce_tpu_torch.ops import milnce_stream as ms
    from milnce_tpu_torch.ops import softdtw_cuda as sd

    torch.backends.cudnn.benchmark = True
    try:
        sps = _train_full("milnce", _stream_loss, (ms, sd),
                          {k: 2 for k in ms.KERNELS})["sps"]
    finally:
        torch.backends.cudnn.benchmark = False
    log(f"  cudnn.benchmark=True: {sps:.4f} steps/s after the first step, "
        f"against {default_sps:.4f} with it off (train phase, same call)")


def phase_train_sdtw3():
    """sdtw_3 on the soft-DTW kernels: 3 NCE terms, each one DP over the B
    positive pairs and one over the B^2 pairs (pair_chunk 0), so 6 forward
    and 6 backward launches a step."""
    from milnce_tpu_torch.ops import milnce_stream as ms
    from milnce_tpu_torch.ops import softdtw_cuda as sd

    run = _train_full("sdtw_3", _sdtw_loss, (ms, sd),
                      {k: 6 for k in sd.LAUNCHES})
    res, cfg, launches = run["res"], run["cfg"], run["launches"]
    clip = torch.zeros((2, 32, 224, 224, 3), dtype=torch.uint8, device="cuda")
    text = torch.ones((2 * cfg.data.num_candidates, cfg.data.max_words),
                      dtype=torch.int64, device="cuda")
    with torch.no_grad():
        res.model.eval()
        v_seq, t_embd = res.model(clip.float() / 255.0, text, mode="sequence")
    if v_seq.shape != (2, 4, 512) or t_embd.shape != (10, 512) or not (
            bool(torch.isfinite(v_seq).all())):
        raise AssertionError(f"sequence embeddings {tuple(v_seq.shape)}, "
                             f"{tuple(t_embd.shape)} not as expected")
    _profile_step(res.model, cfg)
    return launches


def phase_ddp1(train, work):
    """train-full through the distributed path: an NCCL group of one rank
    made in this process from a ``FileStore`` rendezvous, the gathers,
    the all-reduce of the gradients and the BatchNorm merge.  Every loss
    within rel 2e-4 of phase 7's (its train run is not cuDNN
    deterministic), each MIL-NCE kernel twice a step, steps/s at least
    0.95x phase 7's; steps/s, idle share and peak memory beside phase
    7's.  One more step profiled in a group of its own.  The run's model
    is dropped on return, so that no later phase's peak memory holds it."""
    from milnce_tpu_torch.ops import milnce_stream as ms
    from milnce_tpu_torch.ops import softdtw_cuda as sd
    from milnce_tpu_torch.parallel.dist import initialize_distributed

    run = _train_full("milnce", _stream_loss, (ms, sd),
                      {k: 2 for k in ms.KERNELS}, store=f"{work}/ddp1-train",
                      root=f"{work}/ddp1")
    records = _read_events(run["cfg"].train.log_root)
    run_ids = {r.get("run_id") for r in records}
    log(f"  stream of the one-rank group: {len(records)} records, run_ids "
        f"{run_ids} (broadcast over NCCL), process_index "
        f"{ {r.get('process_index') for r in records} }")
    if (len(run_ids) != 1 or None in run_ids
            or {r.get("process_index") for r in records} != {0}):
        raise AssertionError("ddp-1's stream lacks its run identity")
    cfg = run["cfg"]
    cfg.parallel.coordinator_address = f"file://{work}/ddp1-profile"
    ranks = initialize_distributed(cfg.parallel)
    try:
        run["idle"], _ = _profile_step(run["res"].model, cfg,
                                        ranks.group)
    finally:
        ranks.close()
    err = max(abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                                   train["losses"]))
    ratio = run["sps"] / train["sps"]
    log(f"  losses {run['losses']} against phase 7's {train['losses']}: "
        f"max rel diff {err:.3e} (limit 2e-4)")
    log(f"  ddp-1 against phase 7: steps/s {run['sps']:.4f} / "
        f"{train['sps']:.4f} ({ratio:.4f}x, limit 0.95x); idle share "
        f"{run['idle']:.3f} / {train['idle']:.3f}; peak memory "
        f"{run['peak'] / 2 ** 30:.3f} / {train['peak'] / 2 ** 30:.3f} GiB")
    if not (len(run["losses"]) == len(train["losses"]) == TRAIN_STEPS
            and err <= 2e-4 and ratio >= 0.95):
        raise AssertionError("train-full through the distributed path "
                             "differs from phase 7's run")


DDP2_WORLD, DDP2_STEPS = 2, 2


def _ddp2_cfg():
    """The reference phase's small model with sync BatchNorm and chunked
    MIL-NCE on the kernels; warmup 1000, so that step 1 runs at lr 0 and
    step 2 at 1e-6.  Adam turns last-bit noise in a near-zero gradient
    into an lr-sized step, so at a real lr the parameters of two correct
    runs part by about 2 lr; at 1e-6 they cannot part by more than the
    parameters' limit, which therefore proves nothing about the
    reduction.  What does: the gradients, and Adam's moments, which
    Adam keeps whatever the lr (``exp_avg`` is linear in the gradients
    of both steps, ``exp_avg_sq`` quadratic)."""
    cfg = _small_cfg("chunked", "cuda")
    cfg.model.sync_batchnorm = True
    cfg.optim.warmup_steps = 1000
    return cfg


def _ddp2_steps(group, rank, world, device="cuda"):
    """DDP2_STEPS steps of ``_ddp2_cfg`` on this rank's rows of the global
    batches (every row without a group): the losses, the parameters and
    the reduced gradients after the last step, and the kernels' launches
    (counted from 0 just before the steps)."""
    from milnce_tpu_torch.models.build import build_model
    from milnce_tpu_torch.ops import milnce_stream as ms
    from milnce_tpu_torch.train.loop import disable_tf32
    from milnce_tpu_torch.train.schedule import build_schedule_total
    from milnce_tpu_torch.train.state import build_optimizer
    from milnce_tpu_torch.train.step import make_train_step

    disable_tf32()
    cfg = _ddp2_cfg()
    model = build_model(cfg.model, seed=3, group=group).to(device)
    optimizer, lr = build_optimizer(model, cfg.optim,
                                    build_schedule_total(cfg.optim, 100))
    step = make_train_step(model, optimizer, cfg.loss, finite_guard=True,
                           lr_scheduler=lr, group=group)
    b = cfg.train.batch_size // world
    losses = []
    ms.reset_launches()
    torch.backends.cudnn.deterministic = True
    try:
        _ddp2_loop(step, cfg, rank, b, device, losses)
    finally:
        torch.backends.cudnn.deterministic = False
    launches = dict(ms.LAUNCHES)
    named = list(model.named_parameters())
    params = {n: p.detach().cpu() for n, p in named}
    grads = {n: p.grad.detach().cpu() for n, p in named if p.grad is not None}
    moments = {key: {n: optimizer.state[p][key].detach().cpu()
                     for n, p in named if p in optimizer.state}
               for key in ("exp_avg", "exp_avg_sq")}
    stats = {n: b.detach().cpu() for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    return dict(losses=losses, params=params, grads=grads,
                launches=launches, stats=stats, **moments)


def _ddp2_loop(step, cfg, rank, b, device, losses):
    from milnce_tpu_torch.obs import spans as obs_spans

    d, bg, k = cfg.data, cfg.train.batch_size, cfg.data.num_candidates
    rec = obs_spans.get_recorder()
    for i in range(DDP2_STEPS):
        gen = torch.Generator(device=device).manual_seed(7 + i)
        video = torch.randint(0, 255, (bg, d.num_frames, d.video_size,
                                       d.video_size, 3), generator=gen,
                              dtype=torch.uint8, device=device)
        text = torch.randint(1, cfg.model.vocab_size, (bg * k, d.max_words),
                             generator=gen, device=device)
        with rec.span("step", step=i + 1):
            loss, skipped = step(video[rank * b:(rank + 1) * b],
                                 text[rank * b * k:(rank + 1) * b * k],
                                 torch.zeros(b, device=device))
        if skipped:
            raise AssertionError(f"rank {rank}: step {i + 1} skipped")
        losses.append(float(loss))


def _ddp2_rank(rank, world, backend, store, out):
    """One rank of the ddp-2 phase, in a process of its own: its span
    stream (``RUN_EVENTS.jsonl``, rank r ``RUN_EVENTS.p{r}.jsonl``, beside
    ``out``) under rank 0's run_id, broadcast over the group."""
    import torch.distributed as dist
    from datetime import timedelta

    from milnce_tpu_torch.obs import runctx, spans
    from milnce_tpu_torch.parallel.dist import broadcast_str

    device = 0 if backend == "gloo" else rank
    torch.cuda.set_device(device)
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=180))
    try:
        runctx.set_run_context(
            broadcast_str(runctx.auto_run_id(), dist.group.WORLD), rank)
        rec = spans.SpanRecorder(path=_ddp2_stream(out, rank))
        spans.install(rec)
        rec.event("run.start", processes=world)
        result = _ddp2_steps(dist.group.WORLD, rank, world)
        rec.event("run.end", steps=DDP2_STEPS)
        rec.close()
    finally:
        dist.destroy_process_group()
    torch.save(result, out)


def _ddp2_stream(out, rank):
    return (os.path.join(os.path.dirname(out), os.path.basename(out)
                         + ".RUN_EVENTS" + (f".p{rank}" if rank else "")
                         + ".jsonl"))


def _spawn_ranks(target, args, label):
    """One process a rank (start method ``spawn``), rank r running
    ``target(*args[r])``, joined within 600 s (killed past it); fails
    unless every rank exits 0."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=a) for a in args]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + 600
    for proc in procs:
        proc.join(max(0.0, deadline - time.monotonic()))
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join(10)
    codes = [proc.exitcode for proc in procs]
    if codes != [0] * len(procs):
        raise AssertionError(f"{label} ranks exited {codes}")


def _ddp2_spawn(backend, work):
    """DDP2_WORLD rank processes of ``_ddp2_rank``; their results in rank
    order."""
    outs = [f"{work}/ddp2-{backend}-{r}.pt" for r in range(DDP2_WORLD)]
    _spawn_ranks(_ddp2_rank, [(r, DDP2_WORLD, backend,
                               f"{work}/ddp2-{backend}-store", outs[r])
                              for r in range(DDP2_WORLD)],
                 f"ddp-2 over {backend}")
    _merge_ddp2_streams(backend, [_ddp2_stream(out, r)
                                  for r, out in enumerate(outs)])
    return [torch.load(out, weights_only=True) for out in outs]


def _merge_ddp2_streams(backend, paths):
    """The ranks' streams merge under one run_id (``obs/aggregate.py``):
    one step span a step on each rank."""
    from milnce_tpu_torch.obs.aggregate import merge_event_streams

    streams = []
    for path in paths:
        with open(path) as fh:
            streams.append([json.loads(line) for line in fh])
    merged = merge_event_streams(streams)
    log(f"  ranks' streams over {backend} merged: run_id "
        f"{merged['run_id']}, processes {merged['process_indices']}, "
        f"steps {[p['steps'] for p in merged['per_process'].values()]}, "
        f"step p50 skew {merged['step_p50_skew']}")
    if [p["steps"] for p in merged["per_process"].values()] != [
            DDP2_STEPS] * DDP2_WORLD:
        raise AssertionError("a ddp-2 rank's stream misses its steps")


def _grad_gap(got, want):
    """|got - want| / |want| over every tensor of ``want`` (gradients or
    Adam moments), flattened together; and the three tensors whose
    largest difference is the largest share of their largest
    element."""
    num = sum(float((got[n] - w).double().square().sum()) for n, w in want.items())
    den = sum(float(w.double().square().sum()) for w in want.values())
    worst = sorted(((float((got[n] - w).abs().max()) / float(w.abs().max()),
                     n) for n, w in want.items()), reverse=True)[:3]
    return (num / den) ** 0.5, worst


def _ddp2_compare(label, ranks, one, yardstick):
    """Each rank's losses within rel 2e-4 of the one-process run's; the
    ranks' parameters, moments and BatchNorm statistics equal.  Against
    the one-process run: the last step's reduced gradients and Adam's
    ``exp_avg`` within 1e-2, |x - x_one| / |x_one| over all of them, and
    ``exp_avg_sq`` within 2e-2 (quadratic in the gradients, so twice
    their relative error).  The gradients are ill-conditioned in f32
    here (a tensor's largest element moves by per cents between two
    correct one-process runs, cuDNN on and off, ``yardstick``, printed
    beside), while a MEAN where MIL-NCE needs the SUM moves the
    gradients and ``exp_avg`` by 0.5 and ``exp_avg_sq`` by 0.75, and a
    gradient left unreduced moves them by about 0.7.  Each BatchNorm
    running mean and variance within 1e-5 + 1e-4 max|x| (sync BN makes
    them the concatenated batch's; local BN parts the variances by the
    spread between the shards' means).  The parameters within
    1e-5 + 1e-4 max|p|, which at lr 1e-6 no run can miss (see
    ``_ddp2_cfg``)."""
    loss_err = max(abs(a - b) / abs(b) for r in ranks
                   for a, b in zip(r["losses"], one["losses"]))
    params = sorted(((float((ranks[0]["params"][n] - w).abs().max())
                      / (1e-5 + 1e-4 * float(w.abs().max())), n)
                     for n, w in one["params"].items()), reverse=True)
    stats = sorted(((float((ranks[0]["stats"][n] - w).abs().max())
                     / (1e-5 + 1e-4 * float(w.abs().max())), n)
                    for n, w in one["stats"].items()), reverse=True)
    same = all(torch.equal(r[key][n], ranks[0][key][n])
               for r in ranks[1:]
               for key in ("params", "stats", "exp_avg", "exp_avg_sq")
               for n in one[key])
    gaps = {key: (_grad_gap(ranks[0][key], one[key]),
                  _grad_gap(yardstick[key], one[key]))
            for key in ("grads", "exp_avg", "exp_avg_sq")}
    limits = {"grads": 1e-2, "exp_avg": 1e-2, "exp_avg_sq": 2e-2}
    log(f"  [{label}] losses {[r['losses'] for r in ranks]} against one "
        f"process {one['losses']}: max rel diff {loss_err:.3e} (limit "
        f"2e-4); ranks' parameters, moments and BN statistics equal: "
        f"{same}")
    log(f"  [{label}] BN running mean/var, worst |x - one| / limit "
        f"{stats[0][0]:.3e} ({stats[0][1]}, {len(stats)} tensors); "
        f"parameters {params[0][0]:.3e} ({params[0][1]}; vacuous at lr "
        "1e-6)")
    for key, ((gap, worst), (ygap, yworst)) in gaps.items():
        log(f"  [{label}] {key}: |x - x_one| / |x_one| {gap:.3e} (limit "
            f"{limits[key]:g}), worst tensors "
            + ", ".join(f"{n} {e:.3e} of its max" for e, n in worst)
            + f"; yardstick, one process with cuDNN off against on: "
            f"{ygap:.3e}, worst "
            + ", ".join(f"{n} {e:.3e}" for e, n in yworst))
    if not (loss_err <= 2e-4 and params[0][0] <= 1.0 and stats[0][0] <= 1.0
            and same and stats
            and all(gaps[k][0][0] <= limits[k] for k in limits)
            and all(set(one[k]) == set(ranks[0][k]) and one[k]
                    for k in limits)):
        raise AssertionError(f"ddp-2 over {label} differs from one process "
                             "on the concatenated batch")


def phase_ddp2(work):
    """Two ranks on the one card over gloo with CUDA tensors (NCCL takes
    one rank a device): the small model with sync BatchNorm and chunked
    MIL-NCE on the kernels, DDP2_STEPS steps at Bg = 2 B_local, against
    one process stepping the rank-order concatenation of the shards.
    With two cards or more the same comparison runs over NCCL, one rank
    a card."""
    from milnce_tpu_torch.ops import milnce_stream as ms

    one = _ddp2_steps(None, 0, 1)
    torch.backends.cudnn.enabled = False
    try:
        yardstick = _ddp2_steps(None, 0, 1)
    finally:
        torch.backends.cudnn.enabled = True
    ranks = _ddp2_spawn("gloo", work)
    cfg = _ddp2_cfg()
    b = cfg.train.batch_size
    log(f"  MIL-NCE kernels' launches in {DDP2_STEPS} steps at B_local "
        f"{b // DDP2_WORLD}, Bg {b}: "
        f"{[r['launches'] for r in ranks]} (one process, B = Bg = {b}: "
        f"{one['launches']})")
    if any(r["launches"] != {k: 2 * DDP2_STEPS if k in ms.KERNELS else 0
                             for k in r["launches"]} for r in ranks):
        raise AssertionError("a MIL-NCE kernel missed its launches")
    _ddp2_compare("gloo, 2 ranks on one card", ranks, one, yardstick)
    if torch.cuda.device_count() >= DDP2_WORLD:
        _ddp2_compare("nccl, a rank a card", _ddp2_spawn("nccl", work), one,
                      yardstick)
    else:
        log(f"  nccl, a rank a card: not run ({torch.cuda.device_count()} "
            "card visible)")


# ------------------------------------------------------ curriculum, elastic
CURRICULUM = ("num_frames=8,resolution=112,batch_size=32,until_step=2;"
              "num_frames=32,resolution=224,batch_size=16")
CURRICULUM_SAMPLES = 96   # stage 0: batches 1-2 of 32; stage 1: after the
#                           64 samples consumed, batches 5-6 of 16
BUDGET_SHARE = 0.95       # the refused run's budget: this share of stage
#                           1's measured peak


def _curriculum_cfg():
    """train-full's model, loader, obs and seed under CURRICULUM, one
    epoch: the plan is the run's TRAIN_STEPS steps."""
    cfg = _full_cfg("milnce", _stream_loss)
    cfg.train.curriculum = CURRICULUM
    cfg.data.synthetic_num_samples = CURRICULUM_SAMPLES
    cfg.optim.epochs = 1
    return cfg


def _quiet(_msg):
    """A run's log, dropped."""


def _step_spy(loop_mod, seen):
    """Wrap ``loop_mod.make_train_step`` so that each step appends (its
    clip's shape, its peak memory allocated, the stream kernels' launches
    it made) to ``seen``; returns the original to put back."""
    from milnce_tpu_torch.ops import milnce_stream as ms

    real = loop_mod.make_train_step

    def spy(*args, **kwargs):
        step = real(*args, **kwargs)

        def counted(video, text, start):
            before = dict(ms.LAUNCHES)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = step(video, text, start)
            torch.cuda.synchronize()
            seen.append((tuple(video.shape), torch.cuda.max_memory_allocated(),
                         {k: ms.LAUNCHES[k] - before.get(k, 0)
                          for k in ms.KERNELS}))
            return out

        counted.fwd_bwd = step.fwd_bwd
        return counted

    loop_mod.make_train_step = spy
    return real


def phase_train_curriculum(train, work):
    """train-full under ``train.curriculum`` CURRICULUM, 4 steps: 2 at 8
    frames of 112^2 and batch 32 (the stream kernels at B_local = Bg =
    32), then 2 at train-full's 32 frames of 224^2 and batch 16.  Checks
    each step's clip shape against the plan, every loss finite, the
    stream kernels twice a step at each stage, one ``stage.switch`` span,
    and the goodput ledger's categories within 5 % of the phase's wall.
    Prints each stage's steps/s and clips/s, its peak memory beside the
    pre-flight's figure, the ledger's ``stage_switch`` share, and stage
    1's steps/s beside phase 7's (not held to a limit: phase order moves
    full-width speed).  Then the same spec with ``MILNCE_HBM_GIB`` at
    BUDGET_SHARE of stage 1's measured peak must be refused by the
    pre-flight, naming stage 1, before any step."""
    from milnce_tpu_torch.ops import milnce_stream as ms
    from milnce_tpu_torch.train import curriculum
    from milnce_tpu_torch.train import loop as loop_mod

    plan = curriculum.plan_curriculum(
        curriculum.parse_curriculum(CURRICULUM), CURRICULUM_SAMPLES, 1)
    want = []
    for step in range(plan.total_steps):
        st = plan.stages[plan.stage_at(step)]
        want.append((st.batch_size, st.num_frames, st.resolution,
                     st.resolution, 3))
    saved_env = os.environ.pop("MILNCE_HBM_GIB", None)
    seen, steps, lines = [], [], []
    real = _step_spy(loop_mod, seen)
    try:
        cfg = _curriculum_cfg()
        ms.reset_launches()
        t0 = time.perf_counter()
        res = _run_training(cfg, f"{work}/curriculum", log=lines.append,
                            on_step=lambda s, secs, loss, wait:
                            steps.append((s, secs, loss, wait)))
        wall = time.perf_counter() - t0
        launches = dict(ms.LAUNCHES)
        done, stage = res.steps, res.stage
        del res
    finally:
        loop_mod.make_train_step = real
    for m in lines:
        if m.startswith(("curriculum", "MIL-NCE", "Epoch")):
            log(f"  {m}")
    for (s, secs, loss, wait), (shape, peak, per) in zip(steps, seen):
        log(f"  step {s}: clip {shape}, {secs:.3f} s, waited {wait:.4f} s "
            f"for data, loss {loss:.6f}, peak {peak / 2 ** 30:.3f} GiB, "
            f"launches {per}")
    stats = {}
    for idx, st in enumerate(plan.stages):
        mine = [(secs, peak) for (_, secs, _, _), (shape, peak, _)
                in zip(steps, seen) if shape[0] == st.batch_size
                and shape[1] == st.num_frames]
        sps = len(mine) / sum(secs for secs, _ in mine)
        stats[idx] = dict(sps=sps, clips=sps * st.batch_size,
                          second=1 / mine[-1][0],
                          peak=max(peak for _, peak in mine))
        log(f"  stage {idx} ({st.label()}): {sps:.4f} steps/s over its "
            f"{len(mine)} steps ({stats[idx]['second']:.4f} at its second), "
            f"{stats[idx]['clips']:.2f} clips/s, peak memory "
            f"{stats[idx]['peak'] / 2 ** 30:.3f} GiB")
    preflight = [m for m in lines if m.startswith("curriculum pre-flight")]
    records = _read_events(f"{work}/curriculum/log")
    with open(f"{work}/curriculum/log/GOODPUT.json") as fh:
        doc = json.load(fh)
    cats = doc["categories_s"]
    total = sum(cats.values())
    names = [r["name"] for r in records]
    log(f"  stage 1 against phase 7: {stats[1]['second']:.4f} steps/s at its "
        f"second step, {train['sps']:.4f} phase 7 after its first "
        "(not held to a limit)")
    log(f"  goodput ledger: categories sum {total:.4f} s of the phase's "
        f"{wall:.4f} s ({abs(total - wall) / wall:.4f} off, limit 0.05); "
        f"stage_switch {cats.get('stage_switch', 0):.4f} s "
        f"({cats.get('stage_switch', 0) / total:.4f}); "
        f"{names.count('stage.switch')} stage.switch span(s); launches "
        f"{launches}")
    for m in preflight:
        log(f"  {m}")
    route0 = ("MIL-NCE: streamed on the CUDA kernels (B_local 32, Bg 32, "
              "K 5, D 512)")
    if not ([shape for shape, _, _ in seen] == want
            and done == plan.total_steps == TRAIN_STEPS and stage == 1
            and all(math.isfinite(x[2]) for x in steps)
            and all(per == {k: 2 for k in ms.KERNELS} for *_, per in seen)
            and route0 in lines and len(preflight) == 2
            and names.count("stage.switch") == 1
            and cats.get("stage_switch", 0) > 0
            and abs(total - wall) <= 0.05 * wall):
        raise AssertionError("train-full-curriculum failed its checks")
    budget = BUDGET_SHARE * stats[1]["peak"]
    os.environ["MILNCE_HBM_GIB"] = repr(budget / 2 ** 30)
    refused = None

    def no_step(*_):
        raise AssertionError("a step ran before the pre-flight's refusal")

    try:
        _run_training(_curriculum_cfg(), f"{work}/curriculum-refused",
                      log=_quiet, on_step=no_step)
    except ValueError as exc:
        refused = str(exc)
    finally:
        del os.environ["MILNCE_HBM_GIB"]
        if saved_env is not None:
            os.environ["MILNCE_HBM_GIB"] = saved_env
    log(f"  budget {budget / 2 ** 30:.3f} GiB ({BUDGET_SHARE} x stage 1's "
        f"peak): refused: {refused}")
    if not (refused or "").startswith("curriculum pre-flight refused "
                                      "curriculum stage 1 ("):
        raise AssertionError("the pre-flight did not refuse stage 1")
    return dict(stats=stats, share=cats.get("stage_switch", 0) / total,
                preflight=preflight)


def phase_drain(whole, root):
    """train-full drained at step 2 by ``train.drain_signal_file`` (the
    file written from the ``on_step`` callback), then resumed to step 4,
    cuDNN deterministic as in the resume phase: the result is
    ``drained``, both stamps say step 2 (the elastic one ``drained``),
    the ledger's drain bucket is non-zero, and steps 1-4 equal the resume
    phase's uninterrupted run within rel 2e-4."""
    from milnce_tpu_torch.ops import milnce_stream as ms

    flag = f"{root}/drain.now"
    losses, lines = {}, []

    def on_step(s, _t, loss, _w):
        losses[s] = loss
        if s == 2:
            open(flag, "w").close()

    torch.backends.cudnn.deterministic = True
    try:
        ms.reset_launches()
        cfg = _full_cfg("milnce", _stream_loss)
        cfg.train.drain_signal_file = flag
        res = _run_training(cfg, root, log=lines.append, on_step=on_step)
        drained, steps = res.drained, res.steps
        del res
        with open(f"{root}/log/GOODPUT.json") as fh:
            drain_s = json.load(fh)["categories_s"].get("drain", 0)
        with open(f"{root}/run/ELASTIC_STAMP.json") as fh:
            est = json.load(fh)
        with open(f"{root}/run/CURRICULUM_STAMP.json") as fh:
            cst = json.load(fh)
        cfg = _full_cfg("milnce", _stream_loss)
        cfg.train.resume, cfg.train.max_steps = True, TRAIN_STEPS - 2
        res = _run_training(cfg, root, log=lines.append,
                            on_step=lambda s, _t, loss, _w:
                            losses.__setitem__(s, loss))
        resumed = res.steps
        del res
        launches = dict(ms.LAUNCHES)
    finally:
        torch.backends.cudnn.deterministic = False
    err = max(abs(losses[s] - whole[s]) / abs(whole[s]) for s in whole)
    log(f"  {[m for m in lines if m.startswith(('drain', 'resumed'))]}")
    log(f"  drained {drained} after {steps} steps; stamps: elastic {est}, "
        f"curriculum step {cst['step']}; drain bucket {drain_s:.4f} s; "
        f"resumed {resumed} steps; losses {losses} against the "
        f"uninterrupted {whole}: max rel diff {err:.3e} (limit 2e-4); "
        f"launches {launches}")
    if not (drained and steps == 2 and resumed == 2
            and est["step"] == cst["step"] == 2 and est["drained"]
            and est["mesh"] == {"data": 1} and drain_s > 0
            and sorted(losses) == sorted(whole) and err <= 2e-4
            and launches == {k: 2 * TRAIN_STEPS if k in ms.KERNELS else 0
                             for k in launches}):
        raise AssertionError("the drained run or its resume is off")


ELASTIC_STEPS = 4
ELASTIC_SLOW_S = 0.25     # host.slow's sleep on rank 1 in the straggler run


def _elastic_cfg(root):
    """ddp-2's small model (sync BatchNorm, chunked MIL-NCE on the
    kernels, warmup 1000) through ``run_training``: ELASTIC_STEPS steps
    of its global batch on synthetic data, checkpoints and logs under
    ``root``."""
    cfg = _ddp2_cfg()
    cfg.data.synthetic_num_samples = cfg.train.batch_size * ELASTIC_STEPS
    cfg.train.max_steps = None
    cfg.train.preempt_sync_steps = 2
    cfg.train.straggler_window = 2
    cfg.train.checkpoint_root, cfg.train.log_root = root, f"{root}/log"
    return cfg


def _elastic_rank(rank, world, runs, out):
    """One rank of the elastic-ddp phase, in a process of its own: for
    each (label, store, {rank: faults}, root) of ``runs``, ``run_training``
    on ``_elastic_cfg(root)`` with this rank's ``train.faults``, its group
    a gloo one with CUDA tensors on the one card (as ddp-2's: NCCL takes
    one rank a device), made by a stand-in for the loop's
    ``initialize_distributed``.  Saves each run's losses, result and the
    stream kernels' launches."""
    import torch.distributed as dist
    from datetime import timedelta

    from milnce_tpu_torch.ops import milnce_stream as ms
    from milnce_tpu_torch.parallel.dist import Ranks
    from milnce_tpu_torch.train import loop as loop_mod

    torch.cuda.set_device(0)
    torch.backends.cudnn.deterministic = True
    results = {}
    for label, store, specs, root in runs:
        def gloo_group(_parallel, store=store):
            dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                    rank=rank, world_size=world,
                                    timeout=timedelta(seconds=180))
            return Ranks(dist.group.WORLD, rank, world, 0)

        loop_mod.initialize_distributed = gloo_group
        cfg = _elastic_cfg(root)
        cfg.train.faults = specs.get(rank, "")
        losses = {}
        ms.reset_launches()
        res = loop_mod.run_training(cfg, log=lambda _m: None,
                                    on_step=lambda s, _t, loss, _w:
                                    losses.__setitem__(s, loss))
        results[label] = dict(losses=losses, drained=res.drained,
                              steps=res.steps, launches=dict(ms.LAUNCHES))
    torch.save(results, out)


def phase_elastic_ddp(work):
    """Two gloo ranks on the one card (ddp-2's model, sync BatchNorm,
    B_local 4 of Bg 8), through ``run_training``: ``host.preempt@1`` on
    rank 1 alone with ``train.preempt_sync_steps`` 2 drains both ranks
    at step 2 with one stamp ``{"data": 2}``; resumed at W = 1 (this
    process, the same global batch) to step 4, its losses equal one
    uninterrupted process's within ddp-2's rel 2e-4.  A run with
    ``host.slow`` on rank 1 shows ``straggler`` events naming rank 1 in
    rank 0's stream.  cuDNN deterministic throughout."""
    from milnce_tpu_torch.ops import milnce_stream as ms

    runs = [("preempt", f"{work}/elastic-preempt-store",
             {1: "host.preempt@1"}, f"{work}/elastic-preempt"),
            ("slow", f"{work}/elastic-slow-store",
             {1: f"host.slow@*:x={ELASTIC_SLOW_S}"}, f"{work}/elastic-slow")]
    outs = [f"{work}/elastic-{r}.pt" for r in range(DDP2_WORLD)]
    _spawn_ranks(_elastic_rank, [(r, DDP2_WORLD, runs, outs[r])
                                 for r in range(DDP2_WORLD)], "elastic-ddp")
    ranks = [torch.load(out, weights_only=False) for out in outs]
    with open(f"{work}/elastic-preempt/run/ELASTIC_STAMP.json") as fh:
        est = json.load(fh)
    lines, resumed, one = [], {}, {}
    torch.backends.cudnn.deterministic = True
    try:
        from milnce_tpu_torch.train.loop import run_training

        cfg = _elastic_cfg(f"{work}/elastic-preempt")
        cfg.train.resume = True
        cfg.train.log_root = f"{work}/elastic-resumed-log"
        ms.reset_launches()
        res = run_training(cfg, log=lines.append,
                           on_step=lambda s, _t, loss, _w:
                           resumed.__setitem__(s, loss))
        launches = dict(ms.LAUNCHES)
        run_training(_elastic_cfg(f"{work}/elastic-one"), log=lambda _m: None,
                     on_step=lambda s, _t, loss, _w: one.__setitem__(s, loss))
    finally:
        torch.backends.cudnn.deterministic = False
    got = {**ranks[0]["preempt"]["losses"], **resumed}
    err = max(abs(got[s] - one[s]) / abs(one[s]) for s in one)
    events = _read_events(f"{work}/elastic-slow/log")
    flagged = [e for e in events if e["name"] == "straggler"]
    log(f"  preempt run: {[(r['preempt']['drained'], r['preempt']['steps'], r['preempt']['launches']) for r in ranks]} "
        f"(drained, steps, launches a rank); stamp {est}")
    log(f"  resumed at W = 1: {[m for m in lines if m.startswith(('elastic', 'resumed'))]}; "
        f"launches {launches}")
    log(f"  losses W = 2 then W = 1 {got} against one process {one}: max "
        f"rel diff {err:.3e} (limit 2e-4)")
    log(f"  straggler run (host.slow {ELASTIC_SLOW_S} s on rank 1): "
        f"{[(e['step'], e['process'], e['p50_ms'], e['skew']) for e in flagged]} "
        f"(step, rank, p50 ms, skew); demoted "
        f"{[e['process'] for e in events if e['name'] == 'straggler.demote']}")
    if not (all(r["preempt"]["drained"] and r["preempt"]["steps"] == 2
                for r in ranks)
            and est["mesh"] == {"data": 2} and est["step"] == 2
            and est["drained"] and not res.drained and res.steps == 2
            and sorted(got) == sorted(one) == list(range(1, ELASTIC_STEPS + 1))
            and err <= 2e-4
            and any(m.startswith("elastic resume: topology change "
                                 "{'data': 2} -> {'data': 1}") for m in lines)
            and flagged and {e["process"] for e in flagged} == {1}
            and all(r["slow"]["steps"] == ELASTIC_STEPS for r in ranks)
            and all(r["preempt"]["launches"] == {
                k: 2 * 2 if k in ms.KERNELS else 0
                for k in r["preempt"]["launches"]} for r in ranks)):
        raise AssertionError("elastic-ddp failed its checks")


# ------------------------------------------------------------ native-data
NATIVE_STEPS = 3
NATIVE_VIDEOS = 8         # stub videos behind the HowTo rows (raw bytes each)
SDTW3_PAIRS = (256, 4, 5)  # train-full-sdtw3's all-pairs shape, (B^2, T', K)


def _stub_howto(work, cfg):
    """A HowTo100M layout under ``work`` for ``cfg``'s batch and steps:
    a csv of NATIVE_VIDEOS videos repeated, a caption file each, and an
    executable ``bin/ffmpeg`` that ignores the decode and prints the raw
    rgb24 frames kept beside the video (``<path>.raw``, seeded bytes)."""
    d = cfg.data
    os.makedirs(f"{work}/videos", exist_ok=True)
    os.makedirs(f"{work}/captions", exist_ok=True)
    os.makedirs(f"{work}/bin", exist_ok=True)
    caps = {"start": [float(3 * i) for i in range(10)],
            "end": [float(3 * i + 3) for i in range(10)],
            "text": [f"step {i} of the recipe" for i in range(10)]}
    for v in range(NATIVE_VIDEOS):
        frames = np.random.RandomState(v).randint(
            0, 256, (d.num_frames, d.video_size, d.video_size, 3))
        with open(f"{work}/videos/vid{v}.mp4.raw", "wb") as fh:
            fh.write(frames.astype(np.uint8).tobytes())
        with open(f"{work}/captions/vid{v}.json", "w") as fh:
            json.dump(caps, fh)
    n_rows = cfg.train.batch_size * NATIVE_STEPS
    with open(f"{work}/train.csv", "w") as fh:
        fh.write("video_path\n" + "".join(
            f"vid{i % NATIVE_VIDEOS}.mp4\n" for i in range(n_rows)))
    with open(f"{work}/bin/ffmpeg", "w") as fh:
        fh.write('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                 '  if [ "$1" = "-i" ]; then f="$2"; fi\n  shift\ndone\n'
                 'exec cat "$f.raw"\n')
    os.chmod(f"{work}/bin/ffmpeg", 0o755)
    d.synthetic = False
    d.train_csv, d.video_root = f"{work}/train.csv", f"{work}/videos"
    d.caption_root = f"{work}/captions"
    d.synthetic_num_samples = n_rows


def phase_native_data(work):
    """train-full's model at full width (32 frames at 224^2, batch 16,
    K = 5, chunked MIL-NCE on the stream kernels) through the HowTo100M
    source on a stub ffmpeg, with ``data.use_native_reader`` (the C++
    pipe pump) and without (``FFmpegDecoder``'s subprocesses): the
    loader's batches on the card equal byte for byte over NATIVE_STEPS
    batches, its batches/s for each decoder, the data wait a step and the
    losses of a ``run_training`` through each, the stream kernels' launches
    in the native run; ``bench_reader``'s MB/s line; then the host soft-DTW
    against ``softdtw_fwd`` / ``softdtw_bwd`` on the card at
    train-full-sdtw3's all-pairs shape and a square one, within the
    kernel-versus-plain limit."""
    from milnce_tpu_torch.data.pipeline import ShardedLoader, device_prefetch
    from milnce_tpu_torch.data.video import NativeFFmpegDecoder
    from milnce_tpu_torch.native import bench_reader
    from milnce_tpu_torch.native.build import library_path
    from milnce_tpu_torch.ops import milnce_stream as ms
    from milnce_tpu_torch.train.loop import build_source

    cfg = _full_cfg("milnce", _stream_loss)
    cfg.train.max_steps = NATIVE_STEPS
    cfg.optim.warmup_steps = 1000
    _stub_howto(work, cfg)
    old_path = os.environ["PATH"]
    os.environ["PATH"] = f"{work}/bin:{old_path}"
    got, runs = {}, {}
    try:
        for native in (False, True):
            cfg.data.use_native_reader = native
            source = build_source(cfg)
            if isinstance(source.decoder, NativeFFmpegDecoder) != native:
                raise AssertionError("the source's decoder is not the one "
                                     "data.use_native_reader names")
            loader = ShardedLoader(source, cfg.train.batch_size,
                                   seed=cfg.train.seed,
                                   num_threads=cfg.data.num_reader_threads,
                                   lookahead_batches=cfg.data.decode_lookahead)
            t0 = time.perf_counter()
            got[native] = list(device_prefetch(loader.epoch(0), "cuda",
                                               depth=cfg.data.prefetch_depth))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            log(f"  {'native' if native else 'python'} decoder: "
                f"{len(got[native])} batches of {cfg.train.batch_size} x "
                f"{cfg.data.num_frames} x {cfg.data.video_size}^2 x 3 in "
                f"{dt:.3f} s, {len(got[native]) / dt:.3f} batches/s; "
                f"decode failures {source.decode_failures}")
            if source.decode_failures:
                raise AssertionError("the stub videos failed to decode")
            steps = []
            ms.reset_launches()
            torch.backends.cudnn.deterministic = True
            try:
                _run_training(cfg, f"{work}/run-{native}", log=_quiet,
                              on_step=lambda s, secs, loss, wait:
                              steps.append((secs, loss, wait)))
            finally:
                torch.backends.cudnn.deterministic = False
            runs[native] = dict(launches=dict(ms.LAUNCHES), steps=steps)
            log(f"  run_training through it: {len(steps)} steps, losses "
                f"{[round(x[1], 6) for x in steps]}, data wait a step after "
                f"the first {statistics.mean(x[2] for x in steps[1:]):.4f} s "
                f"(each {[round(x[2], 4) for x in steps]}), step seconds "
                f"{[round(x[0], 3) for x in steps]}")
    finally:
        os.environ["PATH"] = old_path
    bad = [i for i, (a, b) in enumerate(zip(got[False], got[True]))
           if any(not torch.equal(a[k], b[k]) for k in a)]
    log(f"  native library {library_path().name}; batches equal byte for "
        f"byte: {len(got[True]) - len(bad)} of {len(got[True])}")
    launches = runs[True]["launches"]
    loss_gap = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in
                   zip(runs[True]["steps"], runs[False]["steps"]))
    log(f"  native run's launches {launches}; losses native vs python max "
        f"rel diff {loss_gap:.3e}")
    rec = bench_reader.main(n_jobs=32, mb_per_job=8, workers=8)
    log(f"  bench_reader: {json.dumps(rec)}")
    worst = _host_softdtw_vs_kernels()
    if (bad or len(got[True]) != NATIVE_STEPS
            or len(runs[True]["steps"]) != NATIVE_STEPS
            or not all(math.isfinite(x[1]) for x in runs[True]["steps"])
            or loss_gap > 2e-4 or worst > 1
            or launches != {k: 2 * NATIVE_STEPS if k in ms.KERNELS else 0
                            for k in launches}):
        raise AssertionError("native-data failed its checks")


def _host_softdtw_vs_kernels() -> float:
    """The host soft-DTW (C++) against the card's kernels, value and
    grad_D: the largest share of the kernel-versus-plain limit."""
    from milnce_tpu_torch.native.softdtw_cpu import softdtw_native
    from milnce_tpu_torch.ops.softdtw_cuda import softdtw_bwd, softdtw_fwd

    worst = 0.0
    for shape, gamma, band in [(SDTW3_PAIRS, 0.1, 0), ((8, 64, 64), 0.1, 0),
                               ((8, 64, 64), 1.0, 16)]:
        gen = torch.Generator(device="cuda").manual_seed(sum(shape))
        D = torch.rand(shape, generator=gen, device="cuda")
        g = torch.rand(shape[0], generator=gen, device="cuda") + 0.5
        value, R = softdtw_fwd(D, gamma, band)
        grad = softdtw_bwd(R, g, gamma, band)
        x = D.cpu().requires_grad_()
        host = softdtw_native(x, gamma, band)
        (host * g.cpu()).sum().backward()
        shares = []
        for want, got_ in ((value.cpu(), host.detach()), (grad.cpu(), x.grad)):
            limit = TOL_ATOL + TOL_RTOL * float(want.abs().max())
            shares.append(float((got_ - want).abs().max()) / limit)
        worst = max(worst, *shares)
        log(f"  host soft-DTW vs softdtw_fwd/bwd at {shape}, gamma {gamma}, "
            f"band {band}: value {shares[0]:.3f}, grad_D {shares[1]:.3f} of "
            "the limit")
    return worst


# ------------------------------------------------------------ fsdp-2d
FSDP_WORLD, FSDP_STEPS = 2, 3


def _fsdp_cfg(loss_name):
    """fsdp-2d's configurations: train-full at full width with the stream
    kernels (MIL-NCE), or the small model with sdtw_3 on the soft-DTW
    kernels; a warmup of 1000 (see ``_ddp2_cfg``: the parameters are
    held to a limit only a tiny lr keeps meaningful; Adam's moments
    carry the gradients)."""
    if loss_name == "milnce":
        cfg = _full_cfg("milnce", _stream_loss)
    else:
        cfg = _small_cfg("dense", "auto")
        cfg.loss.name = "sdtw_3"
        _sdtw_loss(cfg.loss)
    cfg.optim.warmup_steps = 1000
    return cfg


def _fsdp_steps(rank, world, group, loss_name, model_size, overlap=True):
    """FSDP_STEPS steps of ``_fsdp_cfg(loss_name)`` on this rank's rows of
    the global batches, on the 1-D layout (``model_size`` 0) or the
    (world / model_size, model_size) grid, its gradients reduced a leaf
    at a time during the backward (``overlap``,
    ``parallel.overlap_grad_reduce``) or fused after it: the losses, the
    full parameters and Adam's moments after the last step (rank 0), the
    bytes of the sharded parameters and their moments on this rank, the
    peak memory, steps/s after the first step and the kernels' launches
    (counted from 0 just before the steps)."""
    from milnce_tpu_torch.config import ParallelConfig
    from milnce_tpu_torch.models.build import build_model
    from milnce_tpu_torch.ops import milnce_stream as ms
    from milnce_tpu_torch.ops import softdtw_cuda as sd
    from milnce_tpu_torch.parallel.mesh import build_mesh
    from milnce_tpu_torch.parallel.sharding_map import (ShardedPlacement,
                                                        build_param_map)
    from milnce_tpu_torch.train.loop import disable_tf32
    from milnce_tpu_torch.train.schedule import build_schedule_total
    from milnce_tpu_torch.train.state import (build_optimizer,
                                              local_state_bytes)
    from milnce_tpu_torch.train.step import make_train_step

    disable_tf32()
    cfg = _fsdp_cfg(loss_name)
    model = build_model(cfg.model, seed=3).to("cuda")
    placement = None
    min_size = cfg.parallel.fsdp_min_size
    if model_size:
        grid = build_mesh(ParallelConfig(model_axis="model",
                                         model_parallel_size=model_size),
                          group)
        placement = ShardedPlacement(model, grid, group, min_size=min_size,
                                     overlap=overlap)
        sharded = [p for p, _ in placement.sharded]
    else:
        names = {e.name for e in build_param_map(model, 2, min_size)
                 if e.torch_dim is not None}
        sharded = [p for n, p in model.named_parameters() if n in names]
    optimizer, lr = build_optimizer(model, cfg.optim,
                                    build_schedule_total(cfg.optim, 100))
    step = make_train_step(model, optimizer, cfg.loss, finite_guard=True,
                           lr_scheduler=lr, group=group, placement=placement)
    d, bg, k = cfg.data, cfg.train.batch_size, cfg.data.num_candidates
    b = bg // world
    losses, secs = [], []
    torch.cuda.reset_peak_memory_stats()
    ms.reset_launches()
    sd.reset_launches()
    for i in range(FSDP_STEPS):
        gen = torch.Generator(device="cuda").manual_seed(11 + i)
        video = torch.randint(0, 255, (bg, d.num_frames, d.video_size,
                                       d.video_size, 3), generator=gen,
                              dtype=torch.uint8, device="cuda")
        text = torch.randint(1, cfg.model.vocab_size, (bg * k, d.max_words),
                             generator=gen, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, skipped = step(video[rank * b:(rank + 1) * b],
                             text[rank * b * k:(rank + 1) * b * k],
                             torch.zeros(b, device="cuda"))
        losses.append(float(loss))
        secs.append(time.perf_counter() - t0)
        if skipped:
            raise AssertionError(f"rank {rank}: step {i + 1} skipped")
    launches = {**ms.LAUNCHES, **sd.LAUNCHES}
    out = dict(losses=losses, launches=launches,
               sharded_bytes=local_state_bytes(model, optimizer, sharded),
               peak=torch.cuda.max_memory_allocated(),
               sps=(FSDP_STEPS - 1) / sum(secs[1:]),
               n_sharded=len(sharded),
               hash=placement.hash if placement else None)
    if placement is not None:
        model_sd, opt_sd = placement.full_state(model, optimizer)
    else:
        model_sd, opt_sd = model.state_dict(), optimizer.state_dict()
    if rank == 0:
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        out["params"] = {n: model_sd[n].detach().cpu() for n in names}
        for key in ("exp_avg", "exp_avg_sq"):
            out[key] = {names[i]: st[key].detach().cpu()
                        for i, st in opt_sd["state"].items()}
    return out


def _fsdp_rank(rank, world, backend, store, cases, out):
    """One rank of the fsdp-2d phase, in a process of its own: a gloo
    group with CUDA tensors on the one card (NCCL takes one rank a card),
    or an NCCL group with a rank a card; ``_fsdp_steps`` for each (label,
    loss, model size, cuDNN deterministic, overlap) of ``cases``.  A
    collective that waits 120 s (a full-width step takes about one) fails
    the rank."""
    import torch.distributed as dist
    from datetime import timedelta

    torch.cuda.set_device(0 if backend == "gloo" else rank)
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    results = {}
    try:
        for label, loss, size, deterministic, overlap in cases:
            torch.backends.cudnn.deterministic = deterministic
            results[label] = _fsdp_steps(rank, world, dist.group.WORLD, loss,
                                         size, overlap)
    finally:
        dist.destroy_process_group()
    torch.save(results, out)


def phase_fsdp_2d(work, train=None, backend="gloo", world=FSDP_WORLD):
    """train-full at full width on the (1 x 2) grid (``parallel.model_axis``
    'model', ``model_parallel_size`` 2): two gloo ranks on the one card,
    B_local 8 of Bg 16, FSDP_STEPS steps, its gradients reduced a leaf at
    a time during the backward (``parallel.overlap_grad_reduce``, the
    default) and, as ``2d-fused``, after it, against the same ranks and
    batches on the (2 x 1) 1-D layout and each other: losses within rel
    2e-4; the
    parameters after the last step within 1e-5 + 1e-4 max|p|, Adam's
    moments within 1e-2 (exp_avg) and 2e-2 (exp_avg_sq) in norm (ddp-2's
    limits) for the small model; at full width the moments of two correct
    f32 runs part by about 1e-2 in norm (printed beside: the 1-D layout
    again with cuDNN not deterministic), so they are held within 0.1,
    which still catches a reduction fault (a SUM/MEAN slip moves them by
    0.5, an unreduced gradient by 0.7; ``_ddp2_compare``); a rank's bytes
    of sharded parameters plus their moments half the 1-D layout's,
    beside the peak memory; the stream kernels twice a rank a step;
    steps/s beside train-full's.  The small model's sdtw_3 on the
    soft-DTW kernels beside it.  cuDNN deterministic but for the
    yardstick.  With ``backend`` nccl, a rank a card: ``world`` 2 the
    (1 x 2) grid, ``world`` 4 the (2 x 2) grid against the 4-way 1-D
    layout, B_local 4.  The sharded gradients are reduce-scattered by
    ``reduce_scatter_tensor`` over gloo on CUDA tensors.  Steps/s and
    peak memory of both settings side by side (measured only); the stream
    kernels twice a rank a step under both."""
    from milnce_tpu_torch.ops import milnce_stream as ms

    cases = [("1d", "milnce", 0, True, True),
             ("2d", "milnce", 2, True, True),
             ("2d-fused", "milnce", 2, True, False),
             ("yardstick", "milnce", 0, False, True),
             ("sdtw-1d", "sdtw_3", 0, True, True),
             ("sdtw-2d", "sdtw_3", 2, True, True)]
    outs = [f"{work}/fsdp-{backend}-{r}.pt" for r in range(world)]
    _spawn_ranks(_fsdp_rank, [(r, world, backend,
                               f"{work}/fsdp-{backend}-store", cases, outs[r])
                              for r in range(world)],
                 f"fsdp-2d over {backend}")
    ranks = [torch.load(out, weights_only=False) for out in outs]
    log(f"  {world} ranks over {backend}; the sharded gradients go through "
        f"reduce_scatter_tensor on CUDA tensors, the gathers through "
        "all_gather, the replicated gradients an all_reduce a leaf issued "
        "during the backward (2d) or one flat all_reduce after it "
        "(2d-fused)")
    ok = True
    yard = [_grad_gap(ranks[0]["yardstick"][key], ranks[0]["1d"][key])[0]
            for key in ("exp_avg", "exp_avg_sq")]
    log(f"  yardstick, train-full 1-D with cuDNN not deterministic against "
        f"deterministic: exp_avg {yard[0]:.3e}, exp_avg_sq {yard[1]:.3e} in "
        "norm")
    limits = {"2d": (0.1, 0.1), "2d-fused": (0.1, 0.1),
              "sdtw-2d": (1e-2, 2e-2)}
    for one, two in (("1d", "2d"), ("2d-fused", "2d"), ("1d", "2d-fused"),
                     ("sdtw-1d", "sdtw-2d")):
        a, b = ranks[0][one], ranks[0][two]
        loss_err = max(abs(x - y) / abs(y) for x, y in zip(b["losses"],
                                                           a["losses"]))
        p_share = max(float((b["params"][n] - w).abs().max())
                      / (1e-5 + 1e-4 * float(w.abs().max()))
                      for n, w in a["params"].items())
        m1, worst1 = _grad_gap(b["exp_avg"], a["exp_avg"])
        m2, worst2 = _grad_gap(b["exp_avg_sq"], a["exp_avg_sq"])
        bytes_ok = all(r[two]["sharded_bytes"] * (2 if one.endswith("1d")
                                                  else 1)
                       == r[one]["sharded_bytes"] for r in ranks)
        log(f"  {two} vs {one}: losses {[round(x, 6) for x in b['losses']]} "
            f"against {[round(x, 6) for x in a['losses']]}, max rel diff "
            f"{loss_err:.3e} (limit 2e-4); parameters {p_share:.3f} of the "
            f"limit; exp_avg {m1:.3e}, exp_avg_sq {m2:.3e} in norm (worst "
            f"tensors {[(round(x, 4), n) for x, n in worst1]}, "
            f"{[(round(x, 4), n) for x, n in worst2]})")
        for r, res in enumerate(ranks):
            log(f"  rank {r} {two}: {res[two]['n_sharded']} sharded "
                f"parameters, {res[two]['sharded_bytes'] / 2 ** 20:.2f} MiB "
                f"of them and their moments against {one}'s "
                f"{res[one]['sharded_bytes'] / 2 ** 20:.2f} MiB; peak memory "
                f"{res[two]['peak'] / 2 ** 30:.3f} GiB against "
                f"{res[one]['peak'] / 2 ** 30:.3f} GiB; {res[two]['sps']:.4f} "
                f"steps/s against {res[one]['sps']:.4f}; map hash "
                f"{res[two]['hash']}; launches {res[two]['launches']}")
        ok &= (loss_err <= 2e-4 and p_share <= 1 and m1 <= limits[two][0]
               and m2 <= limits[two][1] and bytes_ok)
    if train is not None:
        log(f"  train-full (one process, Bg 16): {train['sps']:.4f} steps/s")
    stream = {k: 2 * FSDP_STEPS for k in ms.KERNELS}
    for r in ranks:
        for label in ("2d", "2d-fused"):
            got = {k: r[label]["launches"][k] for k in ms.KERNELS}
            ok &= got == stream
        ok &= r["sdtw-2d"]["launches"]["softdtw_fwd"] > 0
    for r, res in enumerate(ranks):
        log(f"  rank {r}, overlap_grad_reduce True against False: "
            f"{res['2d']['sps']:.4f} against {res['2d-fused']['sps']:.4f} "
            f"steps/s, peak memory {res['2d']['peak'] / 2 ** 30:.3f} against "
            f"{res['2d-fused']['peak'] / 2 ** 30:.3f} GiB (measured only); "
            f"stream launches {[res[k]['launches'][n] for k in ('2d', '2d-fused') for n in ms.KERNELS]}")
    if not ok:
        raise AssertionError("fsdp-2d failed its checks")
    return ranks[0]["2d"]["launches"]


# ------------------------------------------------------------ resume-2d
def _resume2d_cfg(root, steps, two_d=False, resume=False):
    """ddp-2's small model (sync BatchNorm, chunked MIL-NCE on the
    kernels, warmup 1000) through ``run_training`` over 4 global batches,
    ``steps`` steps of it, checkpoints under ``root``; with ``two_d`` on
    the (1 x 2) grid."""
    cfg = _ddp2_cfg()
    cfg.data.synthetic_num_samples = cfg.train.batch_size * 4
    cfg.train.max_steps = steps
    cfg.train.resume = resume
    cfg.train.checkpoint_root, cfg.train.log_root = root, f"{root}/log"
    if two_d:
        cfg.parallel.model_axis = "model"
        cfg.parallel.model_parallel_size = 2
    return cfg


def _resume2d_rank(rank, world, runs, out):
    """One rank of resume-2d: for each (label, store, cfg) of ``runs``,
    ``run_training`` with its group a gloo one on the one card (a
    stand-in for the loop's ``initialize_distributed``, as elastic-ddp's).
    Saves each run's {step: loss}, steps and log lines."""
    import torch.distributed as dist
    from datetime import timedelta

    from milnce_tpu_torch.parallel.dist import Ranks
    from milnce_tpu_torch.train import loop as loop_mod

    torch.cuda.set_device(0)
    torch.backends.cudnn.deterministic = True
    results = {}
    for label, store, cfg in runs:
        def gloo_group(_parallel, store=store):
            dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                    rank=rank, world_size=world,
                                    timeout=timedelta(seconds=180))
            return Ranks(dist.group.WORLD, rank, world, 0)

        loop_mod.initialize_distributed = gloo_group
        losses, lines = {}, []
        res = loop_mod.run_training(cfg, log=lines.append,
                                    on_step=lambda s, _t, loss, _w:
                                    losses.__setitem__(s, loss))
        results[label] = dict(losses=losses, steps=res.steps, lines=lines)
    torch.save(results, out)


def phase_resume_2d(work):
    """The small model: a 1-D run of 2 steps (two gloo ranks on the one
    card), resumed for 1 step on the (1 x 2) grid, whose checkpoint
    resumes for 1 step in one process: the step counter carries, each
    resume logs its topology change, and the losses match an
    uninterrupted 1-D run of 4 steps within rel 2e-4, cuDNN
    deterministic."""
    from milnce_tpu_torch.train.loop import run_training

    root = f"{work}/resume2d"
    runs = [("whole", f"{work}/r2d-whole-store",
             _resume2d_cfg(f"{root}-whole", 4)),
            ("seed", f"{work}/r2d-seed-store", _resume2d_cfg(root, 2)),
            ("to2d", f"{work}/r2d-to2d-store",
             _resume2d_cfg(root, 1, two_d=True, resume=True))]
    outs = [f"{work}/resume2d-{r}.pt" for r in range(DDP2_WORLD)]
    _spawn_ranks(_resume2d_rank, [(r, DDP2_WORLD, runs, outs[r])
                                  for r in range(DDP2_WORLD)], "resume-2d")
    ranks = [torch.load(out, weights_only=False) for out in outs]
    back, lines = {}, []
    torch.backends.cudnn.deterministic = True
    try:
        res = run_training(_resume2d_cfg(root, 1, resume=True),
                           log=lines.append,
                           on_step=lambda s, _t, loss, _w:
                           back.__setitem__(s, loss))
    finally:
        torch.backends.cudnn.deterministic = False
    r0 = ranks[0]
    chain = {**r0["seed"]["losses"], **r0["to2d"]["losses"], **back}
    whole = r0["whole"]["losses"]
    err = max(abs(chain[s] - whole[s]) / abs(whole[s]) for s in whole)
    notes = [m for m in r0["to2d"]["lines"] + lines
             if m.startswith(("elastic resume", "resumed", "sharding map"))]
    for note in notes:
        log(f"  {note}")
    log(f"  1-D, 2-D, one process {chain} against uninterrupted 1-D "
        f"{whole}: max rel diff {err:.3e} (limit 2e-4)")
    if not (sorted(chain) == sorted(whole) == [1, 2, 3, 4] and err <= 2e-4
            and res.steps == 1 and r0["to2d"]["steps"] == 1
            and sum(m.startswith("elastic resume: topology change")
                    for m in notes) == 2):
        raise AssertionError("resume-2d failed its checks")


# ------------------------------------------------------------ softdtw-sp
SP_SHAPE, SP_GAMMA, SP_BAND = (2, 2048, 2048), 0.1, 128


def _sp_rank(rank, world, store, out):
    """One rank of softdtw-sp at SP_SHAPE, without and with the band:
    ``softdtw_seq_parallel`` (the full D on every rank) and
    ``softdtw_seq_parallel_rows`` (the rank's rows alone) over a gloo
    group on the one card, the value and grad_D of ``sum(g * value)``
    (rows-local: the rank's gradient rows), each timed a call (forward,
    backward), with the bytes of D and of its gradient the rank holds and
    the rank's peak device memory through the call."""
    import torch.distributed as dist
    from datetime import timedelta

    from milnce_tpu_torch.ops import (softdtw_seq_parallel,
                                      softdtw_seq_parallel_rows)

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=300))
    n = SP_SHAPE[1]
    k = -(-n // world)
    results = {}
    try:
        for entry, band in [(e, b) for e in ("full", "rows")
                            for b in (0, SP_BAND)]:
            D, g = _sp_inputs()
            if entry == "full":
                x = D.clone().requires_grad_()
            else:
                x = D[:, rank * k:(rank + 1) * k].clone().requires_grad_()
            del D
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if entry == "full":
                value = softdtw_seq_parallel(x, SP_GAMMA, dist.group.WORLD,
                                             band)
            else:
                value = softdtw_seq_parallel_rows(x, n, SP_GAMMA,
                                                  dist.group.WORLD, band)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            (value * g).sum().backward()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            results[entry, band] = dict(
                value=value.detach().cpu(),
                grad=x.grad.cpu() if rank == 0 or entry == "rows" else None,
                held=x.numel() * x.element_size() * 2,
                peak=torch.cuda.max_memory_allocated(),
                fwd_s=t1 - t0, bwd_s=t2 - t1)
            del x, value
    finally:
        dist.destroy_process_group()
    torch.save(results, out)


def _sp_inputs():
    gen = torch.Generator(device="cuda").manual_seed(2048)
    D = torch.rand(SP_SHAPE, generator=gen, device="cuda")
    g = torch.rand(SP_SHAPE[0], generator=gen, device="cuda") + 0.5
    return D, g


def phase_softdtw_sp():
    """Two gloo ranks on the one card at (2, 2048, 2048), gamma 0.1,
    without and with a band of 128, through the full-D entry and the
    rows-local one: the value and grad_D (rows-local: the ranks' gradient
    rows put together) equal ``softdtw_fwd`` / ``softdtw_bwd`` on one
    device within the kernel-versus-plain limit; the time a call (a
    plain path: a few PyTorch ops and one exchange through host memory a
    diagonal); the bytes of D and grad_D a rank holds, 1/W of the full-D
    entry's in the rows-local one, and each rank's peak device memory."""
    from milnce_tpu_torch.ops.softdtw_cuda import softdtw_bwd, softdtw_fwd

    with tempfile.TemporaryDirectory() as tmp:
        outs = [f"{tmp}/sp-{r}.pt" for r in range(2)]
        _spawn_ranks(_sp_rank, [(r, 2, f"{tmp}/sp-store", outs[r])
                                for r in range(2)], "softdtw-sp")
        ranks = [torch.load(out, weights_only=False) for out in outs]
    worst = 0.0
    for band in (0, SP_BAND):
        D, g = _sp_inputs()
        value, R = softdtw_fwd(D, SP_GAMMA, band)
        grad = softdtw_bwd(R, g, SP_GAMMA, band).cpu()
        del D, R
        for entry in ("full", "rows"):
            r0, r1 = ranks[0][entry, band], ranks[1][entry, band]
            got = (r0["grad"] if entry == "full"
                   else torch.cat([r0["grad"], r1["grad"]], dim=1))
            shares = []
            for want, have in ((value.cpu(), r0["value"]),
                               (value.cpu(), r1["value"]), (grad, got)):
                limit = TOL_ATOL + TOL_RTOL * float(want.abs().max())
                shares.append(float((have - want).abs().max()) / limit)
            worst = max(worst, *shares)
            log(f"  {entry:4s} {SP_SHAPE} gamma {SP_GAMMA} band {band}: "
                f"value {shares[0]:.3f} / {shares[1]:.3f} (ranks 0/1), "
                f"grad_D {shares[2]:.3f} of the limit; forward "
                f"{r0['fwd_s']:.3f} s, backward {r0['bwd_s']:.3f} s a call "
                f"(rank 1: {r1['fwd_s']:.3f} / {r1['bwd_s']:.3f}); D and its "
                f"gradient held a rank {r0['held'] / 2 ** 20:.2f} MiB, peak "
                f"{r0['peak'] / 2 ** 20:.1f} / {r1['peak'] / 2 ** 20:.1f} MiB")
    held = {e: ranks[0][e, 0]["held"] for e in ("full", "rows")}
    log(f"  rows-local holds {held['rows'] / held['full']:.4f} of the full-D "
        f"entry's bytes of D and grad_D a rank (1/W = 0.5000)")
    if worst > 1 or held["rows"] * 2 != held["full"]:
        raise AssertionError("softdtw-sp differs from the kernels")


PLAN_TOLERANCE = 0.10        # memplan.PEAK_TOLERANCE, the JAX planner's
# train-full before the guard repair, a run of the loop that synced every
# step (steps/s, idle share of an unguarded profiled step; H100 80GB HBM3,
# 700 W)
BEFORE_SPS, BEFORE_IDLE = 2.7870, 0.022
WINDOW = 8                   # steps a timed window of (e)


def _analysis_step(cfg, seed=0):
    """train-full's model (seed ``seed``), fused Adam, DeviceLR and guarded
    step on the card, and one batch of its inputs there; -> (model,
    optimizer, lr, step, inputs)."""
    from milnce_tpu_torch.models.build import build_model
    from milnce_tpu_torch.train.schedule import build_schedule_total
    from milnce_tpu_torch.train.state import build_optimizer
    from milnce_tpu_torch.train.step import make_train_step

    model = build_model(cfg.model, seed=seed).to("cuda")
    optimizer, lr = build_optimizer(model, cfg.optim,
                                    build_schedule_total(cfg.optim, 100))
    step = make_train_step(model, optimizer, cfg.loss, finite_guard=True,
                           lr_scheduler=lr)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d, batch = cfg.data, cfg.train.batch_size
    inputs = (torch.randint(0, 255, (batch, d.num_frames, d.video_size,
                                     d.video_size, 3), generator=gen,
                            dtype=torch.uint8, device="cuda"),
              torch.randint(1, cfg.model.vocab_size,
                            (batch * d.num_candidates, d.max_words),
                            generator=gen, device="cuda",
                            dtype=torch.int32),
              torch.zeros(batch, device="cuda"))
    return model, optimizer, lr, step, inputs


def _window_sps(step, inputs, n=WINDOW) -> float:
    """Steps/s of ``n`` steps enqueued back to back after one warm step,
    with one sync at the end: no host read between them."""
    step(*inputs)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        step(*inputs)
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t)


def _step_peak(step, inputs, base: int) -> int:
    """The bytes allocated at the peak of one step, less ``base`` (what
    the process held before the step's model was built)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(*inputs)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def phase_analysis(train):
    """(a)-(e) of the module docstring's analysis phase."""
    from milnce_tpu_torch.analysis import memplan
    from milnce_tpu_torch.analysis.astlint import lint_paths_full
    from milnce_tpu_torch.analysis.optrace import trace_call
    from milnce_tpu_torch.ops import milnce_stream as ms
    from milnce_tpu_torch.train.step import make_train_step

    t0 = time.perf_counter()
    findings, graph = lint_paths_full(["milnce_tpu_torch"])
    active = [f for f in findings if not f.suppressed]
    log(f"  (a) passes 1+3: {len(active)} findings, "
        f"{len(findings) - len(active)} audited suppressions, "
        f"{len(graph.edges)} lock-order edges, "
        f"{time.perf_counter() - t0:.2f} s")
    if active:
        raise AssertionError("graftlint findings:\n" + "\n".join(
            f.format() for f in active))
    cfg = _full_cfg("milnce", _stream_loss)
    base = torch.cuda.memory_allocated()
    model, optimizer, lr, step, inputs = _analysis_step(cfg)
    step(*inputs)                                   # builds Adam's moments
    torch.cuda.synchronize()
    ms.reset_launches()
    trace, _ = trace_call(step, inputs, model=model, optimizer=optimizer)
    torch.cuda.synchronize()
    counted = {k: n for k, n in ms.LAUNCHES.items() if n}
    per_step = {k: 2 for k in ms.KERNELS}     # phase 7's launches a step
    f64 = [op.name for op in trace.ops
           if any(str(d) == "torch.float64" for d, _ in op.inputs
                  + op.outputs)]
    syncs = [f"{op.name} @ {op.owner}" for op in trace.syncs()]
    backward = sum(1 for op in trace.ops if op.owner.startswith("backward"))
    log(f"  (b) traced step: {len(trace.ops)} events ({backward} in the "
        f"backward), kernels {trace.kernels()}, counters {counted}, "
        f"train-full's per step {per_step}, collectives "
        f"{trace.collectives()}, host syncs {syncs}, float64 ops "
        f"{len(f64)}")
    if (f64 or syncs or trace.collectives() or trace.kernels() != counted
            or counted != per_step):
        raise AssertionError("the traced train-full step breaks an "
                             "invariant (above)")
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            step(*inputs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("  (c) 3 guarded steps under set_sync_debug_mode('error'): no sync")
    peaks = {"train-full": _step_peak(step, inputs, base)}
    steps = {"guarded": step, "plain": make_train_step(
        model, optimizer, cfg.loss, lr_scheduler=lr)}
    sps = {k: [] for k in steps}
    for name in ("guarded", "plain", "plain", "guarded"):
        sps[name].append(_window_sps(steps[name], inputs))
    idle, groups = _profile_step(model, cfg, finite_guard=True)
    guarded, plain = (statistics.mean(sps[k]) for k in ("guarded", "plain"))
    log(f"  (e) train-full, windows of {WINDOW} steps back to back with one "
        f"sync, in turns G P P G: guarded {guarded:.4f} steps/s "
        f"({', '.join(f'{x:.4f}' for x in sps['guarded'])}), plain "
        f"{plain:.4f} ({', '.join(f'{x:.4f}' for x in sps['plain'])}), "
        f"guarded/plain {guarded / plain:.4f}; one profiled guarded step: "
        f"idle share {idle:.3f}, optimizer group "
        f"{groups.get('optimizer', 0.0):.2f} ms; phase 7's loop (which "
        f"syncs every step for its on_step) {train['sps']:.4f} steps/s; "
        f"PR 19's loop {BEFORE_SPS} steps/s, idle share {BEFORE_IDLE} of an "
        "unguarded step (measured only)")
    del model, optimizer, lr, step, steps, inputs, trace
    torch.cuda.empty_cache()
    remat = _full_cfg("milnce", _stream_loss)
    remat.model.remat = True
    base = torch.cuda.memory_allocated()
    model, optimizer, lr, step, inputs = _analysis_step(remat)
    step(*inputs)
    peaks["train-full-remat"] = _step_peak(step, inputs, base)
    del model, optimizer, lr, step, inputs
    torch.cuda.empty_cache()
    for name, c in (("train-full", cfg), ("train-full-remat", remat)):
        t1 = time.perf_counter()
        plan = memplan.what_if_step(TRAIN_BATCH, c.data.num_frames,
                                    c.data.video_size, c, entry=name)
        err = (plan.peak_bytes - peaks[name]) / peaks[name]
        log(f"  (d) {plan.summary()}; the card's step peak "
            f"{peaks[name] / 2 ** 30:.4f} GiB; plan/card - 1 = {err:+.4f} "
            f"(limit {PLAN_TOLERANCE}); planned in "
            f"{time.perf_counter() - t1:.1f} s")
        if abs(err) > PLAN_TOLERANCE:
            raise AssertionError(f"{name}: the static plan misses the "
                                 "card's peak by more than 10 %")
    log(f"  analysis phase: {time.perf_counter() - t0:.1f} s")


def _kernel_group(name: str) -> str:
    low = name.lower()
    if "softdtw" in low:
        return "soft-DTW kernels"
    if "lse_" in low:
        return "milnce stream kernels"
    if "nccl" in low:
        return "collectives"
    if "conv" in low or "xmma" in low or "gemm" in low or "cudnn" in low \
            or "implicit" in low or "wgrad" in low or "dgrad" in low:
        return "convolution / matmul"
    if "norm" in low or "welford" in low or "bn_" in low:
        return "batchnorm"
    if "adam" in low or "foreach" in low:
        return "optimizer"
    return "other elementwise / reduction"


def _profile_step(model, cfg, group=None, finite_guard=False):
    """One more full-width train step of ``cfg.train.batch_size`` clips
    under torch.profiler (the grad-cache step under ``train.grad_accum``;
    the finite guard's under ``finite_guard``), after the counted run (its
    launches are not in the counts), over ``group``'s ranks when given:
    device time by kernel group and the device's idle share of the step.
    -> (idle share, {kernel group: device ms})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from milnce_tpu_torch.train.schedule import build_schedule_total
    from milnce_tpu_torch.train.state import build_optimizer
    from milnce_tpu_torch.train.step import (make_grad_cache_step,
                                             make_train_step)

    optimizer, lr = build_optimizer(model, cfg.optim,
                                    build_schedule_total(cfg.optim, 100))
    kw = dict(lr_scheduler=lr, group=group, finite_guard=finite_guard)
    if cfg.train.grad_accum > 1:
        step = make_grad_cache_step(model, optimizer, cfg.train.grad_accum,
                                    cfg.loss, **kw)
    else:
        step = make_train_step(model, optimizer, cfg.loss, **kw)
    gen = torch.Generator(device="cuda").manual_seed(0)
    d, batch = cfg.data, cfg.train.batch_size
    video = torch.randint(0, 255, (batch, d.num_frames, d.video_size,
                                   d.video_size, 3), generator=gen,
                          dtype=torch.uint8, device="cuda")
    text = torch.randint(1, cfg.model.vocab_size,
                         (batch * d.num_candidates, d.max_words),
                         generator=gen, device="cuda")
    start = torch.arange(batch, dtype=torch.float32, device="cuda")
    step(video, text, start)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(video, text, start)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups: dict = {}
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:     # kernels only, not the
            continue                               # CPU ops that launch them
        dev = getattr(evt, "self_device_time_total",
                      getattr(evt, "self_cuda_time_total", 0)) / 1e3
        rows.append((dev, evt.key, evt.count))
        grp = _kernel_group(evt.key)
        groups[grp] = groups.get(grp, 0.0) + dev
    busy = sum(groups.values())
    idle = max(0.0, 1 - busy / (wall * 1e3))
    log(f"  profiled step: wall {wall * 1e3:.1f} ms, device busy "
        f"{busy:.1f} ms, idle share {idle:.3f}")
    for grp, ms_ in sorted(groups.items(), key=lambda x: -x[1]):
        log(f"    {grp:32s} {ms_:9.2f} ms  {ms_ / busy:.3f}")
    for dev, key, count in sorted(rows, reverse=True)[:12]:
        log(f"    top: {dev:9.2f} ms x{count:<4d} {key[:100]}")
    return idle, groups


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    try:
        import milnce_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run from a checkout of the repository ({exc})",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    log("== device")
    card = phase_device()
    if sys.argv[1:] == ["--serve-hosts"]:
        # serving launches no hand kernel: no build
        if torch.cuda.device_count() < 2 * SERVE_HOSTS_WORLD:
            raise SystemExit(f"--serve-hosts needs {2 * SERVE_HOSTS_WORLD} "
                             "cards")
        with tempfile.TemporaryDirectory() as work:
            log(f"== serve-hosts (a seeded full-width export over "
                f"{SERVE_HOSTS_WORLD} nccl ranks of two cards each, against "
                "one card and one process over the four)")
            phase_serve_hosts_cards(work, card)
        return _finish(card, t0)
    if sys.argv[1:] == ["--serve-group"]:
        # serving launches no hand kernel: no build
        if torch.cuda.device_count() < 2:
            raise SystemExit("--serve-group needs 2 cards")
        with tempfile.TemporaryDirectory() as work:
            log("== serve-group (a seeded full-width export over cuda:0 "
                "and cuda:1, against cuda:0 alone)")
            phase_serve_group_cards(work, card)
        return _finish(card, t0)
    log("== build")
    phase_build()
    if sys.argv[1:] == ["--fsdp-2d"]:
        cards = torch.cuda.device_count()
        if cards < 2:
            raise SystemExit("--fsdp-2d needs 2 cards")
        world = 4 if cards >= 4 else 2
        with tempfile.TemporaryDirectory() as work:
            log(f"== fsdp-2d (nccl, a rank a card: the ({world // 2} x 2) "
                f"grid against the {world}-way 1-D layout, both settings of "
                "overlap_grad_reduce)")
            phase_fsdp_2d(work, backend="nccl", world=world)
        return _finish(card, t0)
    if sys.argv[1:] == ["--ddp-2"]:
        if torch.cuda.device_count() < DDP2_WORLD:
            raise SystemExit(f"--ddp-2 needs {DDP2_WORLD} cards")
        with tempfile.TemporaryDirectory() as work:
            log("== ddp-2 (gloo on one card, nccl a rank a card)")
            phase_ddp2(work)
        return _finish(card, t0)
    log("== MIL-NCE kernels vs plain")
    worst = phase_parity()
    log("== MIL-NCE kernel timing")
    times = phase_timing()
    log(f"== MIL-NCE kernel timing, deep mode (D = {DEEP_D})")
    times.update(phase_timing(DEEP_D))
    log("== MIL-NCE kernels (bf16) vs plain")
    worst.update(phase_parity_bf16())
    log("== MIL-NCE kernel timing (bf16 gathered operands)")
    times.update(phase_timing(512, torch.bfloat16))
    log(f"== MIL-NCE kernel timing (bf16 gathered operands), deep mode (D = "
        f"{DEEP_D})")
    times.update(phase_timing(DEEP_D, torch.bfloat16))
    log("== soft-DTW kernels vs plain")
    worst.update(phase_softdtw_parity())
    log("== soft-DTW kernel timing")
    times.update(phase_softdtw_timing())
    log("== reference (small model, chunked/cuda vs dense)")
    phase_reference()
    log(f"== reference at embedding {DEEP_D} (the kernels' deep mode)")
    deep_launches = phase_reference(DEEP_D)
    log(f"== reference at embedding {SLAB_D} (the slab paths)")
    slab_launches = phase_reference(SLAB_D)
    log("== reference-bf16 (small model at model.dtype bfloat16, the "
        "kernels' bf16 mode vs the plain twins)")
    phase_reference_bf16()
    log(f"== reference-bf16 at embedding {DEEP_D} and {SLAB_D} (the bf16 "
        "mode's deep and slab paths)")
    bf16_deep = {**phase_reference_bf16(DEEP_D),
                 **phase_reference_bf16(SLAB_D)}
    log("== dtw reference (small model, soft-DTW cuda vs scan)")
    phase_dtw_reference()
    log("== gc-ref (small model, grad-cache step vs its one-graph form)")
    phase_gc_reference()
    with tempfile.TemporaryDirectory() as work:
        log("== train (full width, MIL-NCE)")
        train = phase_train(work)
        launches = train["launches"]
        launches.update({k: n for k, n in deep_launches.items()
                         if k.endswith("_deep")})
        launches.update({k: n for k, n in slab_launches.items()
                         if k.endswith("_deep_slab")})
        launches.update(bf16_deep)
        log("== data alone (loader + prefetch, no step)")
        phase_data_alone()
        log("== ddp-1 (train-full through the distributed path, one rank)")
        phase_ddp1(train, work)
        log("== ddp-2 (two ranks on one card, sync BN, Bg = 2 B_local)")
        phase_ddp2(work)
        log("== elastic-ddp (two gloo ranks on one card: drain agreed "
            "across ranks, resumed at W = 1; a straggler)")
        phase_elastic_ddp(work)
        log("== resume (full width, stopped at step 2, resumed to step 4)")
        ckpt_dir, whole = phase_resume(work)
        log("== drain (full width, drained at step 2 by the signal file, "
            "resumed to step 4)")
        phase_drain(whole, f"{work}/drain")
        log("== eval (msrvtt, full width, on the resumed checkpoint; one "
            "card, then the device group [cuda:0, cuda:0])")
        phase_eval(ckpt_dir, work)
        log("== eval-ddp (the small model's in-training eval on two gloo "
            "ranks on one card)")
        phase_eval_ddp(work)
        log("== serve-full (export, engine, batchers, cache and a "
            f"{INDEX_ROWS}-row index on the resumed checkpoint)")
        export_dir, clip_emb = phase_serve_full(ckpt_dir, work, card)
        log("== serve-live (milnce-serve-torch with a live index across "
            "the 2**20 rung, the replica pool with an int8 edge replica, "
            "quant/ at full width)")
        phase_serve_live(export_dir, clip_emb, work, card)
        # after ddp-1, whose steps/s is held to phase 7's: run before it,
        # these two left ddp-1's step with other convolution kernels and
        # an idle share of 0.063 against phase 7's 0.022 (H100)
        log("== train-full-remat (train-full with model.remat)")
        phase_train_remat(train)
        log(f"== train-full-gc (batch {GC_BATCH} in {GC_ACCUM} microbatches, "
            "grad-cache)")
        phase_train_gc(train, work)
        log("== train-full-curriculum (8f@112 batch 32, then 32f@224 "
            "batch 16; the pre-flight's refusal)")
        phase_train_curriculum(train, work)
        log("== native-data (train-full through the HowTo source on a stub "
            "ffmpeg, data.use_native_reader; the host soft-DTW)")
        phase_native_data(f"{work}/native")
        log("== fsdp-2d (train-full on the (1 x 2) grid, two gloo ranks on "
            "one card, against the (2 x 1) 1-D layout)")
        phase_fsdp_2d(work, train)
        log("== resume-2d (small model: 1-D, resumed on the grid, resumed "
            "in one process)")
        phase_resume_2d(work)
    log("== analysis (graftlint: AST passes, a traced train-full step, "
        "sync debug mode, the static plan against the card's peak)")
    phase_analysis(train)
    log("== softdtw-sp (two gloo ranks on one card, (2, 2048, 2048))")
    phase_softdtw_sp()
    log("== cuDNN autotuning (measured only)")
    phase_cudnn_benchmark(train["sps"])
    log("== train-full-bf16 (train-full at model.dtype bfloat16)")
    launches.update({k: n for k, n in phase_train_bf16(train)[
        "launches"].items() if k.endswith("_bf16") and n})
    log("== train (full width, sdtw_3)")
    sdtw_launches = phase_train_sdtw3()
    launches.update({k: sdtw_launches[k] for k in ("softdtw_fwd",
                                                   "softdtw_bwd")})
    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name], launches=launches[name],
                    max_abs_err=worst[name], **times[name])
               for name in SOURCES]
    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        raise AssertionError(f"kernels never launched by their runs: {idle}")
    log(json.dumps({"kernels": kernels}))
    return _finish(card, t0)


def _finish(card, t0) -> int:
    log(f"card: {card}; total {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
