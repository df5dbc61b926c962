"""Typed configuration for the whole framework (the PyTorch port's own
copy of ``milnce_tpu/config.py``; the port imports nothing of the JAX
package).

Three knobs differ from the JAX copy: ``loss.milnce_backend`` and
``loss.sdtw_backend`` take ``auto | scan | cuda`` (``parse_cli`` refuses
anything else) and ``parallel.platform`` picks the torch device
(``cuda`` by default, ``cpu`` for hermetic runs).  Knobs of subsystems
the port has not reached yet are kept so that command lines stay the
same across the two packages; the port's trainer refuses those listed in
``train/loop.py::UNPORTED_KNOBS`` when they are set and ignores the
rest.

Replaces the reference's two near-duplicate argparse files (args.py:3-52,
args_small.py:3-52) with one dataclass tree + presets.  Every knob of the
reference CLI has a typed home here; nothing is hardcoded in library code
(the reference leaked node IPs into train.py:48 and checkpoint paths into
eval scripts — see SURVEY.md §2.4).
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import Optional

# choices of loss.milnce_backend and loss.sdtw_backend (the modules that
# dispatch on them import these)
MILNCE_BACKENDS = ("auto", "scan", "cuda")
SDTW_BACKENDS = ("auto", "scan", "cuda")


@dataclass
class DataConfig:
    """Input-pipeline knobs (reference: args.py:5-7,14,16,22-26,29,32)."""

    train_csv: str = ""                 # manifest csv with a `video_path` column
    video_root: str = ""
    caption_root: str = ""
    eval_video_root: str = ""
    eval_csv: str = "csv/hmdb51.csv"    # in-training eval manifest
    fps: int = 10
    num_frames: int = 32
    video_size: int = 224
    crop_only: bool = True
    center_crop: bool = False
    random_flip: bool = True
    min_time: float = 5.0
    max_words: int = 20                 # training caption length
    eval_max_words: int = 30            # eval caption length (youcook/msrvtt
                                        # loaders, youcook_loader.py:28)
    num_candidates: int = 5             # MIL candidate captions per clip
    num_reader_threads: int = 20        # host-side decode workers per process
    use_native_reader: bool = False     # C++ ReaderPool pipe pump for ffmpeg
                                        # decode (native/milnce_native.cpp)
    decoder_backend: str = "auto"       # auto | ffmpeg | cv2 (auto prefers
                                        # the ffmpeg binary, falls back to
                                        # in-process cv2 decode)
    prefetch_depth: int = 2             # device prefetch buffer (batches)
    decode_lookahead: int = 2           # extra batches of decode futures kept
                                        # in flight across batch boundaries
    sample_timeout: float = 120.0       # decode watchdog: per-sample timeout
                                        # (s), doubling per retry; a wedged
                                        # decode escalates to the black-frame
                                        # fallback instead of stalling the
                                        # pod's next collective.  0 disables.
    sample_timeout_retries: int = 2     # fresh decode attempts per sample
                                        # before the watchdog escalates
    max_failure_rate: float = 0.5       # abort the run (DataHealthError) when
                                        # the decode-failure fraction exceeds
                                        # this — a mostly-corrupt dataset must
                                        # not silently train on black frames.
                                        # 1.0 disables.
    synthetic: bool = False             # hermetic in-memory source (no ffmpeg)
    synthetic_num_samples: int = 256


@dataclass
class ModelConfig:
    """S3D-G + sentence tower (reference: s3dg.py:207-263)."""

    embedding_dim: int = 512            # args.py `--num_class`
    gating: bool = True
    space_to_depth: bool = False
    inception_blocks: int = 9           # trunk depth (9 = full S3D-G;
                                        # smaller for dryruns/ablations)
    weight_init: str = "uniform"        # 'uniform' (framework default) | 'kaiming_normal'
    vocab_size: int = 66250             # s3dg.py:152
    word_embedding_dim: int = 300
    text_hidden_dim: int = 2048
    text_max_words: int = 16            # s3dg.py:155 (train loader uses DataConfig.max_words)
    word2vec_path: str = ""             # .npy/.npz table; '' = trainable-from-scratch table
    token_dict_path: str = ""           # dict.npy vocab for the tokenizer
    sync_batchnorm: bool = False        # cross-replica BN (original TPU run); False = local
                                        # BN for parity with the GPU reference (README.md:13);
                                        # the port syncs over its ranks' group
    dtype: str = "float32"              # activation dtype ('bfloat16' for MXU speed)
    conv_impl: str = "native"           # 'native' 3D convs | 'fold2d' (same
                                        # math as 2D convs — layout XLA:TPU's
                                        # conv emitter is tuned for) |
                                        # 'im2col' (patches + one dot_general;
                                        # see models/conv3d.py, identical
                                        # params under all three)
    conv_impl_map: str = ""             # PER-STAGE impl override on top of
                                        # conv_impl: inline
                                        # 'conv1=im2col,mixed_3b=fold2d' or a
                                        # path to the autotune artifact
                                        # scripts/stage_probe.py --autotune
                                        # writes (JSON with an 'impl_map'
                                        # key); stages not named fall back to
                                        # conv_impl.  '' = uniform conv_impl.
    remat: bool = False                 # rematerialize Inception blocks
                                        # (jax.checkpoint) to fit big batches


CONV_IMPLS = ("native", "fold2d", "im2col")        # models/conv3d.py
# Stage names an impl map may address — the granularity the stage probe
# measures at (scripts/stage_probe.py; mirrors models/s3dg.py setup).
CONV_STAGES = ("conv1", "conv_2b", "conv_2c",
               "mixed_3b", "mixed_3c", "mixed_4b", "mixed_4c", "mixed_4d",
               "mixed_4e", "mixed_4f", "mixed_5b", "mixed_5c")


def parse_conv_impl_map(spec: str) -> dict:
    """ModelConfig.conv_impl_map -> {stage: impl}.

    Accepts '' (empty map), an inline 'stage=impl[,stage=impl...]' spec,
    or a path to a JSON file — either a raw map or the autotune artifact
    (``scripts/stage_probe.py --autotune``), whose map lives under the
    'impl_map' key.  Unknown stages or impls raise ValueError so a typo
    fails at config time, not as a silently-ignored key."""
    if not spec:
        return {}
    if "=" in spec:
        items = [item for item in spec.split(",") if item]
        bad = [item for item in items if "=" not in item]
        if bad:
            raise ValueError(f"impl map items missing '=': {bad} "
                             "(inline form is 'stage=impl[,stage=impl...]')")
        mapping = dict(item.split("=", 1) for item in items)
    else:
        import json

        with open(spec) as fh:
            payload = json.load(fh)
        mapping = payload.get("impl_map", payload)
    for stage, impl in mapping.items():
        if stage not in CONV_STAGES:
            raise ValueError(f"impl map names unknown stage {stage!r} "
                             f"(stages: {', '.join(CONV_STAGES)})")
        if impl not in CONV_IMPLS:
            raise ValueError(f"impl map stage {stage!r} names unknown impl "
                             f"{impl!r} (impls: {', '.join(CONV_IMPLS)})")
    return dict(mapping)


@dataclass
class LossConfig:
    """Loss selection + hyperparams (reference: loss.py)."""

    name: str = "milnce"                # milnce | cdtw | sdtw_cidm | sdtw_negative | sdtw_3
    milnce_impl: str = "dense"          # dense | chunked | auto: 'dense'
                                        # materializes the two
                                        # (B_local, Bg, K) similarity cubes
                                        # (losses/milnce.py — fewest matmul
                                        # passes, fine while the cubes are
                                        # small); 'chunked' streams negative
                                        # chunks with running logsumexps and
                                        # a recompute-in-backward custom VJP
                                        # (losses/milnce_chunked.py — the
                                        # Bg=8192 recipe's loss); 'auto'
                                        # switches to chunked once the cubes
                                        # + AD twins pass the 64 MiB budget
                                        # (prefers_chunked).  PERF.md
                                        # "Memory-efficient loss".
    milnce_chunk: int = 0               # global samples per streamed chunk
                                        # (0 = the milnce_default_chunk
                                        # rule, ~2 MiB of row logits per
                                        # block); Bg % chunk != 0 is padded
                                        # + masked
    milnce_backend: str = "auto"        # chunked impl inner backend: auto |
                                        # scan | cuda (scan = the plain
                                        # torch stream, cuda = the hand
                                        # kernels of ops/milnce_stream.py;
                                        # auto = the kernels for CUDA
                                        # tensors, the plain stream for
                                        # CPU tensors)
    sdtw_backend: str = "auto"          # soft-DTW recurrence: auto | scan |
                                        # cuda (scan = the plain torch
                                        # wavefront on any device, cuda =
                                        # the hand kernels of
                                        # ops/softdtw_cuda.py, CUDA tensors
                                        # only; auto = the kernels for CUDA
                                        # tensors, the plain wavefront for
                                        # CPU tensors)
    sdtw_gamma: Optional[float] = None  # None = each loss's reference
                                        # default: 1e-5 for cdtw (loss.py:
                                        # 26), 0.1 for the sdtw_* family
                                        # (loss.py:38,74,97)
    sdtw_dist: str = ""                 # '' = each loss's reference default
                                        # (cosine for cdtw/cidm/negative,
                                        # negative_dot for sdtw_3 — loss.py:
                                        # 26,38,74,97); override with any of
                                        # cosine | negative_dot |
                                        # negative_cosine | euclidean
    sdtw_bandwidth: int = 0             # Sakoe-Chiba band; 0 = off
    sdtw_pair_chunk: int = 0            # sdtw_3 only: stream each NCE
                                        # term's B x B pair logsumexp in
                                        # anchor-row chunks of this size
                                        # (jax.checkpoint'd scan — peak
                                        # pair batch O(B*chunk) instead
                                        # of the B^2 broadcast); 0 = the
                                        # dense all-pairs form
    cidm_sigma: float = 10.0            # loss.py:58
    cidm_lambda: float = 1.0            # loss.py:57


@dataclass
class OptimConfig:
    """Optimizer + schedule (reference: args.py:12,20,28,34,36-37; utils.py:26-38)."""

    name: str = "adam"                  # adam | sgd
    lr: float = 1e-3
    momentum: float = 0.9
    warmup_steps: int = 50_000
    epochs: int = 300
    num_cycles: float = 0.5


@dataclass
class ParallelConfig:
    """Mesh layout.  The port reads platform, the coordinator knobs,
    num_devices and its own group_timeout_s: one process a rank, joined
    in a torch.distributed group (parallel/dist.py), as the reference's
    NCCL/TCP rendezvous (main_distributed.py:50-75) did; and the 2-D
    layout's data_axis, model_axis, model_parallel_size, fsdp_min_size
    and sharding_map (parallel/mesh.py, parallel/sharding_map.py), with
    overlap_grad_reduce: on the 2-D layout True gives every leaf's
    gradient a collective of its own, issued as the gradient becomes
    final during the backward, and False reduces after the backward,
    the replicated leaves in one flat all-reduce; the 1-D layout keeps
    its one flat all-reduce under both."""

    data_axis: str = "data"             # batch-sharded axis (DP + global negatives)
    model_axis: Optional[str] = None    # FSDP/model axis: set (with
                                        # model_parallel_size > 1) to train
                                        # on a 2-D (data, model) mesh with
                                        # large params sharded per the
                                        # sharding map (parallel/
                                        # sharding_map.py, PERF.md)
    model_parallel_size: int = 1
    fsdp_min_size: int = 65536          # FSDP threshold (ELEMENTS): params
                                        # with >= this many elements shard
                                        # over model_axis on their largest
                                        # divisible dim; smaller ones
                                        # replicate (gather latency beats
                                        # the storage win below it)
    sharding_map: str = ""              # per-param overrides on top of the
                                        # size rule: inline 'glob=dim[,...]'
                                        # ('-' = force-replicate) or a JSON
                                        # artifact path, mirroring
                                        # model.conv_impl_map.  '' = pure
                                        # automatic rule.
    overlap_grad_reduce: bool = True    # 2-D mesh only: reduce grads
                                        # per-leaf (XLA can overlap each
                                        # reduction with the rest of the
                                        # backward) instead of one fused
                                        # terminal psum; the 1-D step keeps
                                        # its pinned fused reduction
    coordinator_address: Optional[str] = None   # the port's process-group
                                        # rendezvous: 'host:port' (TCP) or a
                                        # tcp:// or file:// URL, with
                                        # num_processes (world size) and
                                        # process_id (rank).  None = the
                                        # torchrun environment (RANK,
                                        # WORLD_SIZE, LOCAL_RANK) if set,
                                        # else one process, no group
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    platform: str = "cuda"              # torch device the trainer runs on:
                                        # 'cuda' (default; NCCL between
                                        # ranks, rank r on cuda:LOCAL_RANK)
                                        # | 'cpu' (gloo; hermetic runs and
                                        # tests)
    num_devices: int = 0                # 0 = every rank of the run; else
                                        # the port refuses a count past the
                                        # visible devices (CUDA: the cards;
                                        # CPU: the ranks) or other than its
                                        # world size (one rank a device).
                                        # The JAX package builds its mesh
                                        # over the FIRST N local devices.
    group_timeout_s: float = 7200.0     # the port's process group: how
                                        # long a collective or barrier
                                        # waits before the run fails (a
                                        # checkpoint save, which the other
                                        # ranks wait out at a barrier,
                                        # must fit in here)


@dataclass
class TrainConfig:
    batch_size: int = 128               # GLOBAL batch (reference splits per GPU at
                                        # main_distributed.py:88; we shard over the mesh)
    batch_size_val: int = 32
    seed: int = 1
    n_display: int = 400
    checkpoint_root: str = "checkpoint"
    checkpoint_dir: str = ""
    checkpoint_keep: int = 10           # sliding retention (main_distributed.py:289-294)
    log_root: str = "log"
    resume: bool = False
    pretrain_ckpt: str = ""             # load converted weights before training
    evaluate: bool = False
    eval_task: str = "hmdb"             # hmdb | youcook | msrvtt (in-training)
    num_windows_test: int = 4
    verbose: bool = True
    trace_dir: str = ""                 # torch.profiler trace output, a
                                        # Chrome trace.json ('' = off)
    obs_dir: str = ""                   # span/event stream: RUN_EVENTS.jsonl
                                        # is appended under this dir ('' =
                                        # log_root; written only when the
                                        # run logger is enabled).  Recording
                                        # is host-side only — obs/,
                                        # OBSERVABILITY.md
    obs_profiler_bridge: bool = False   # wrap spans in torch.profiler.
                                        # record_function so they land in
                                        # profiler traces (pairs with
                                        # trace_dir)
    run_id: str = ""                    # run identity stamped on every
                                        # RUN_EVENTS.jsonl line + obs
                                        # snapshot ('' = auto: process 0
                                        # generates one and broadcasts it
                                        # cluster-wide).  Pod aggregation
                                        # and obs_report split on it.
    anomaly_detect: bool = True         # EWMA step-time spike detector at
                                        # display cadence (host-side only:
                                        # fed from the window timing the
                                        # display already computes); emits
                                        # 'anomaly' events and arms the
                                        # profiler capture when configured
    anomaly_ratio: float = 2.0          # spike = window step time > ratio
                                        # x EWMA (and > 4 sigma; obs/
                                        # anomaly.py)
    anomaly_warmup: int = 3             # display windows before the
                                        # detector may fire (compile +
                                        # cache-cold windows)
    anomaly_cooldown_s: float = 300.0   # suppression window between
                                        # anomaly events
    capture_dir: str = ""               # anomaly-triggered bounded one-
                                        # shot torch.profiler capture root
                                        # ('' = no capture; also armable
                                        # via SIGUSR1)
    capture_ms: float = 2000.0          # capture stops itself after this
    capture_max: int = 1                # captures per run (a bad run
                                        # captures once, not forever)
    halt_on_nan: bool = True            # checkpoint + halt when the windowed
                                        # loss goes non-finite (divergence guard)
    max_steps: Optional[int] = None     # stop (with a checkpoint) after N
                                        # optimizer steps — bounded smoke /
                                        # bench runs; None = run all epochs
    finite_guard: bool = True           # fold a per-step all-finite gradient
                                        # check into the jitted step: a
                                        # non-finite update is SKIPPED (params
                                        # kept, jnp.where select — no host
                                        # sync, no new collectives) and
                                        # counted; surfaced at display cadence
    skip_rollback_after: int = 25       # circuit breaker: after K CONSECUTIVE
                                        # skipped updates, restore the last
                                        # rotation checkpoint and resume past
                                        # the poisoned data window instead of
                                        # halting.  Checked at display cadence
                                        # (the existing sync point), so keep
                                        # K <= n_display.  0 disables.
    faults: str = ""                    # fault-injection spec (chaos tests /
                                        # drills), e.g. 'decode.raise@1,2;
                                        # grad.nonfinite@3' — grammar and site
                                        # catalogue in resilience/faults.py;
                                        # also armable via MILNCE_FAULTS env
    checkpoint_save_retries: int = 2    # transient-I/O retries (exponential
                                        # backoff) before a checkpoint save
                                        # gives up — a SIGTERM save must not
                                        # race one flaky write for the whole
                                        # partial epoch
    grad_accum: int = 1                 # microbatches per optimizer step
                                        # (two-pass embedding-cache MIL-NCE:
                                        # FULL global-batch negatives at 1/M
                                        # activation memory — how the
                                        # reference's 8192-batch recipe runs
                                        # on a small mesh; train/step.py)
    preempt_sync_steps: int = 25        # multi-process runs all-reduce the
                                        # SIGTERM flag every N steps so ONE
                                        # preempted worker triggers a
                                        # cluster-wide cooperative checkpoint
                                        # (a unilateral exit would wedge the
                                        # others in their next collective);
                                        # the check costs one tiny collective
                                        # + host sync per N steps.  Single
                                        # process: checked locally every step.
                                        # TUNE to step time: a SIGTERM is only
                                        # acted on at the next boundary, so the
                                        # worst-case delay before checkpointing
                                        # begins is N*step_time — keep that
                                        # well inside the preemption grace
                                        # window (e.g. 300ms steps + 30s grace
                                        # -> N<=50; multi-second steps -> N<=5).
    drain_signal_file: str = ""         # drain trigger for orchestrators
                                        # that can't deliver SIGTERM: the
                                        # loop polls for this path once per
                                        # step and starts a cooperative
                                        # drain (checkpoint + ELASTIC_STAMP
                                        # + drained exit status) when it
                                        # appears ('' = SIGTERM/fault-site
                                        # only; milnce_tpu/elastic/)
    straggler_ratio: float = 1.25       # live straggler rule: a host whose
                                        # window step-time p50 exceeds
                                        # ratio x the fastest host's is
                                        # flagged (same rule obs_report
                                        # --merge applies post-hoc;
                                        # elastic/straggler.py)
    straggler_window: int = 3           # consecutive flagged display
                                        # windows before the host is
                                        # DEMOTED in the goodput ledger
                                        # (one slow window is noise; a
                                        # streak is a bad host)
    straggler_resize: bool = False      # on demotion, also emit a
                                        # straggler.resize_recommended
                                        # event (drain + resume without
                                        # the slow host) — recommendation
                                        # only: training can't evict a
                                        # host mid-collective
    curriculum: str = ""                # staged (frames, resolution, batch)
                                        # training schedule — ordered
                                        # 'num_frames=4,resolution=64,
                                        # until_step=1000;...' stages (or a
                                        # JSON artifact path); final stage
                                        # open-ended.  '' = flat run.
                                        # Grammar, plan semantics and the
                                        # per-stage mem_plan pre-flight:
                                        # train/curriculum.py + PERF.md
                                        # "Curriculum training"


@dataclass
class ServeConfig:
    """Online-serving knobs (milnce_tpu/serving/, SERVING.md).

    The three SLO levers: ``max_batch`` trades per-request latency for
    device efficiency (taller ladder = fuller MXU at high load),
    ``max_delay_ms`` bounds how long a lone request waits for batch
    company, ``default_timeout_ms`` bounds total queue wait before a
    request errors (DeadlineExpired) instead of silently aging.

    Resilience tier (serving/pool.py, ROBUSTNESS.md "Serving request
    path"): ``replicas`` > 1 serves through a ReplicaPool — per-replica
    dispatch locks, bounded queues, health-gated routing, quarantine +
    probe recovery, hedged dispatch — and ``max_inflight`` arms the
    admission controller's bounded global queue + deadline-feasibility
    load shedding (HTTP 429)."""

    max_batch: int = 64                 # top of the bucket ladder
    min_bucket: int = 0                 # smallest bucket (0 = mesh size)
    max_delay_ms: float = 5.0           # batcher flush-on-delay bound
    default_timeout_ms: float = 0.0     # per-request queue deadline (0 = none)
    cache_capacity: int = 4096          # LRU text-embedding cache entries
                                        # (<= 0 disables)
    topk: int = 10                      # retrieval depth (static in the
                                        # traced top-k program)
    dtype: str = ""                     # serve-time cast ('bfloat16' for
                                        # MXU-rate inference; '' = exported)
    host: str = "127.0.0.1"
    port: int = 8000
    export_dir: str = ""                # milnce-export artifact to serve
    corpus_npz: str = ""                # (N, D) f32 corpus embeddings to
                                        # index ('' = embed-only service)
    token_dict_path: str = ""           # dict.npy vocab for serve-time
                                        # sentence tokenization ('' = the
                                        # path recorded in the export's
                                        # metadata; without either, only
                                        # token_ids requests work)
    capture_dir: str = ""               # profiler-capture root for the
                                        # serving process ('' = POST
                                        # /obs/capture answers 404);
                                        # flush-latency anomalies arm it
                                        # too when set
    capture_ms: float = 2000.0          # bounded capture duration
    capture_max: int = 1                # captures per process
    anomaly_ratio: float = 3.0          # flush-latency spike ratio for
                                        # the serving EWMA detector
                                        # (queueing makes latency noisier
                                        # than step time — wider than the
                                        # train default)
    replicas: int = 1                   # engine replica pool size (1 = the
                                        # single-engine path; >1 = one
                                        # engine per device group, single-
                                        # device groups on the CPU backend
                                        # — serving/pool.py)
    replica_queue_depth: int = 16       # bounded per-replica work queue;
                                        # all queues full = HTTP 429
    error_threshold: int = 3            # consecutive dispatch errors
                                        # before a replica QUARANTINES
                                        # (ReplicaDead quarantines at once)
    slo_ms: float = 0.0                 # per-dispatch latency SLO driving
                                        # the DEGRADED breaker (0 = off)
    slo_breaches: int = 5               # consecutive SLO breaches before
                                        # SERVING -> DEGRADED (and the
                                        # in-SLO streak to recover)
    probe_interval_s: float = 1.0       # quarantined replicas re-probed
                                        # (synthetic embed at the smallest
                                        # bucket) at this cadence
    hedge_quantile: float = 0.0         # hedge a dispatch still pending
                                        # past this latency quantile to a
                                        # second healthy replica (first
                                        # result wins; 0 = off)
    hedge_min_ms: float = 20.0          # hedge threshold floor — never
                                        # hedge sooner than this
    max_requeues: int = 1               # dispatch errors retried on
                                        # another replica before the
                                        # caller sees the failure
    max_inflight: int = 0               # admission controller: bounded
                                        # global in-flight rows; past it
                                        # requests shed with HTTP 429 +
                                        # Retry-After (0 = unbounded).
                                        # /healthz and /metrics never shed.
    continuous_batching: bool = False   # admit requests into partially-
                                        # filled bucket slots: flush the
                                        # instant a dispatch lane is free,
                                        # accumulate while lanes are busy
                                        # (vLLM-style slot reuse on the
                                        # fixed ladder; max_delay_ms is
                                        # then ignored — serving/batcher.py)
    tiers: str = ""                     # per-tenant SLO classes on the
                                        # admission controller: priority-
                                        # ordered 'name:share[,...]' (e.g.
                                        # 'interactive:1.0,batch:0.5' —
                                        # each tier may hold at most
                                        # share*max_inflight rows, so a
                                        # batch backfill cannot starve
                                        # interactive traffic).  Requests
                                        # pick a class via the 'tier'
                                        # field; '' = untiered.
    live_index: bool = False            # serve a generation-swapped LIVE
                                        # index (serving/live_index.py):
                                        # POST /v1/index/add ingests while
                                        # serving; swaps are atomic and
                                        # recompile-free within a corpus
                                        # rung.  False = the frozen
                                        # DeviceRetrievalIndex.
    index_snapshot_dir: str = ""        # live-index corpus checkpoint dir
                                        # (corpus.npz + index_meta.json):
                                        # restored at boot when present,
                                        # written at shutdown ('' = no
                                        # snapshotting)
    index_min_shard_rows: int = 0       # live-index per-shard capacity
                                        # rung floor (0 = sized by k and
                                        # the boot corpus; raise it to
                                        # pre-provision headroom so early
                                        # growth never crosses a rung).
                                        # HowTo100M-scale default: 524288
                                        # (= 2**19; ~1.2M corpus rows /
                                        # 8-way data axis x 2 headroom —
                                        # recommended_min_shard_rows() in
                                        # serving/live_index.py computes
                                        # the rung for other corpora)
    edge_export_dir: str = ""           # quantized/student artifact the
                                        # edge replica class serves
                                        # (SERVING.md "Edge tier");
                                        # '' = no edge tier
    edge_replicas: int = 0              # edge-class replicas added to the
                                        # pool beside the f32 replicas;
                                        # requests pin a class via the
                                        # 'replica_class' field


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)


def full_preset() -> Config:
    """Defaults of the reference full run (args.py)."""
    return Config()


def small_preset() -> Config:
    """Scaled-down run: EXACTLY the args_small.py deltas over args.py
    (batch 12 :17, n_display 100 :21, warmup 1000 :28, 100 epochs :34)
    made actually runnable — the reference's train_small.py is
    import-broken (SURVEY.md §2.4).  Input shapes stay the full run's
    (32f@224, K=5), as args_small keeps them."""
    cfg = Config()
    cfg.train.batch_size = 12
    cfg.train.n_display = 100
    cfg.optim.warmup_steps = 1000
    cfg.optim.epochs = 100
    return cfg


def tiny_preset() -> Config:
    """Hermetic CPU/CI preset: synthetic data, tiny shapes, no external files."""
    cfg = small_preset()
    cfg.data.synthetic = True
    cfg.data.num_frames = 4
    cfg.data.video_size = 32
    cfg.data.max_words = 6
    cfg.data.num_candidates = 1
    cfg.train.batch_size = 4
    cfg.model.vocab_size = 128
    cfg.optim.warmup_steps = 2
    cfg.optim.epochs = 1
    cfg.train.n_display = 1
    return cfg


PRESETS = {"full": full_preset, "small": small_preset, "tiny": tiny_preset}


# knobs whose values the CLI checks while it parses
CHOICES = {"loss.milnce_backend": MILNCE_BACKENDS,
           "loss.sdtw_backend": SDTW_BACKENDS}


def _add_dataclass_args(parser: argparse.ArgumentParser, prefix: str, dc) -> None:
    import typing

    hints = typing.get_type_hints(type(dc))
    for f in dataclasses.fields(dc):
        typ = hints[f.name]
        if typing.get_origin(typ) is typing.Union:   # Optional[T] -> T
            typ = next(a for a in typing.get_args(typ) if a is not type(None))
        name = f"--{prefix}{f.name}"
        if typ is bool:
            parser.add_argument(name, type=lambda s: s.lower() in ("1", "true", "yes"),
                                default=None, metavar="BOOL")
        elif typ in (int, float, str):
            parser.add_argument(name, type=typ, default=None,
                                choices=CHOICES.get(name[2:]))


def parse_cli(argv: Optional[list[str]] = None,
              description: str = "milnce-tpu-torch") -> Config:
    """CLI front-end: `--preset {full,small,tiny}` then per-field overrides
    like `--train.batch_size 256` / `--optim.lr 1e-3`."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--preset", choices=sorted(PRESETS), default="full")
    base = Config()
    for section in dataclasses.fields(base):
        _add_dataclass_args(parser, f"{section.name}.", getattr(base, section.name))
    ns = parser.parse_args(argv)
    cfg = PRESETS[ns.preset]()
    for key, val in vars(ns).items():
        if key == "preset" or val is None:
            continue
        section, _, fname = key.partition(".")
        setattr(getattr(cfg, section), fname, val)
    return cfg
