"""Host input pipeline: sharded, threaded, device-prefetched (port of
``milnce_tpu/data/pipeline.py``).

- The global sample index space is shuffled per epoch with a seed and
  partitioned by process; each process draws only its shard
  (``process_index`` / ``process_count``, 0 / 1 by default).
- A thread pool of ``num_reader_threads`` builds samples concurrently,
  with a sliding window of decode futures across batch boundaries.
- Batches stay **uint8** up to the device: :class:`ShardedLoader` yields
  each batch as its list of samples, and :func:`device_prefetch` stacks
  them straight into a pinned host buffer, copies that on a side CUDA
  stream and keeps ``depth`` batches in flight.
- Only full global batches are emitted (drop_last semantics).

Batch order and contents are the JAX loader's exactly: sample content is
a pure function of (seed, epoch, index).  The watchdog's counters and
events and the ``data.wait`` span are the JAX pipeline's, under the same
names.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import sys
from typing import Iterator

import numpy as np
import torch

from milnce_tpu_torch.data.video import kill_inflight_decoders
from milnce_tpu_torch.obs import metrics as obs_metrics
from milnce_tpu_torch.obs import spans as obs_spans

# Decode-watchdog telemetry on the process-wide registry (host-side
# counters incremented from reader threads).
_OBS_TIMEOUTS = obs_metrics.registry().counter(
    "milnce_data_decode_timeouts_total",
    "decode futures that exceeded the watchdog timeout (wedged decodes)")
_OBS_RETRIES = obs_metrics.registry().counter(
    "milnce_data_decode_retries_total",
    "fresh decode attempts resubmitted by the watchdog")
# Data-wait attribution (the goodput ledger's data_wait category): seconds
# the consumer (the train loop pulling device_prefetch) spent blocked on
# the next batch, incremented on the consumer's thread; the loop reads
# window deltas off the same child for the live goodput gauge.
_OBS_DATA_WAIT = obs_metrics.registry().counter(
    "milnce_data_wait_seconds_total",
    "host seconds the training loop blocked waiting for batch data")

_EXHAUSTED = object()


class ShardedLoader:
    """Iterates a source (len + sample(idx, rng)) as per-process batches.

    Decode is pipelined across batch boundaries: a sliding window of
    ``(1 + lookahead_batches) * local_batch`` sample futures stays in
    flight, so the reader threads are already building batch k+1 (and
    k+2) while batch k is being consumed.  Scheduling never changes what
    a batch contains."""

    LOGGED_TIMEOUTS = 5                  # log detail for at most this many

    def __init__(self, source, global_batch_size: int, seed: int = 0,
                 num_threads: int = 8, shuffle: bool = True,
                 process_index: int = 0, process_count: int = 1,
                 lookahead_batches: int = 2,
                 sample_timeout: float = 0.0,
                 timeout_retries: int = 2,
                 log_fn=None):
        self.source = source
        self.global_batch = int(global_batch_size)
        self.seed = seed
        self.num_threads = max(1, int(num_threads))
        self.shuffle = shuffle
        self.pi, self.pc = int(process_index), int(process_count)
        if self.global_batch % self.pc:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {self.pc} processes")
        self.local_batch = self.global_batch // self.pc
        self.lookahead_batches = max(0, int(lookahead_batches))
        # Decode watchdog: a wedged decode (hung ffmpeg pipe, stuck NFS
        # read) would otherwise park the loader on fut.result() forever.
        # 0 disables.
        self.sample_timeout = float(sample_timeout)
        self.timeout_retries = max(0, int(timeout_retries))
        self.decode_timeouts = 0
        self._log = log_fn or (lambda m: print(m, file=sys.stderr))
        self._logged_timeouts = 0

    def _await_sample(self, fut, idx, pool, fetch):
        """Watchdog around one decode future: the timeout doubles per
        retry, each retry is a FRESH decode of the same index, and
        exhaustion escalates to the source's black-frame fallback.  A hung
        worker thread is left to finish in the background."""
        if not self.sample_timeout:
            return fut.result()
        for attempt in range(self.timeout_retries + 1):
            timeout = self.sample_timeout * (2 ** attempt)
            try:
                return fut.result(timeout=timeout)
            except cf.TimeoutError:
                # Cancel before resubmitting: a future still QUEUED would
                # otherwise run anyway beside its replacement.  A
                # successful cancel means the sample never started —
                # queue backlog, not a wedged decode, so it is not counted.
                if not fut.cancel():
                    self.decode_timeouts += 1
                    _OBS_TIMEOUTS.inc()
                    obs_spans.get_recorder().event(
                        "decode.timeout", sample=int(idx),
                        attempt=attempt + 1, timeout_s=timeout)
                    if self._logged_timeouts < self.LOGGED_TIMEOUTS:
                        self._logged_timeouts += 1
                        self._log(
                            f"[data] decode watchdog: sample {int(idx)} "
                            f"timed out after {timeout:.1f}s (attempt "
                            f"{attempt + 1}/{self.timeout_retries + 1}; "
                            f"total timeouts: {self.decode_timeouts})")
                if attempt < self.timeout_retries:
                    _OBS_RETRIES.inc()
                    obs_spans.get_recorder().event(
                        "decode.retry", sample=int(idx), attempt=attempt + 2)
                    fut = pool.submit(fetch, idx)
        fallback = getattr(self.source, "fallback_sample", None)
        if fallback is not None:
            return fallback()
        raise TimeoutError(
            f"decode of sample {int(idx)} exceeded the watchdog timeout "
            f"{self.timeout_retries + 1}x and the source has no "
            "fallback_sample()")

    def steps_per_epoch(self) -> int:
        # tail always dropped: the step runs one static batch shape
        return len(self.source) // self.global_batch

    def epoch(self, epoch: int, skip_batches: int = 0) -> Iterator[list]:
        """Yield this process's batches for one epoch, each as its list of
        ``local_batch`` sample dicts in order.

        ``skip_batches`` drops the first N global batches at the INDEX
        level — nothing is decoded for them — so a mid-epoch resume
        continues at the exact data position."""
        n = len(self.source)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(order)
        usable = (n // self.global_batch) * self.global_batch
        order = order[:usable]
        # process p takes rows p, p+pc, p+2pc... of each global batch
        local = order.reshape(-1, self.global_batch)[:, self.pi::self.pc]
        if skip_batches:
            local = local[skip_batches:]
        flat = local.reshape(-1)

        rng_base = self.seed * 100_003 + epoch
        pool = cf.ThreadPoolExecutor(self.num_threads)
        try:
            def fetch(idx):
                return self.source.sample(
                    int(idx), np.random.RandomState((rng_base + int(idx)) % (2**31)))

            futs: "collections.deque" = collections.deque()
            window = self.local_batch * (1 + self.lookahead_batches)
            submitted = 0
            for start in range(0, len(flat), self.local_batch):
                while submitted < len(flat) and submitted < start + window:
                    idx = flat[submitted]
                    futs.append((pool.submit(fetch, idx), idx))
                    submitted += 1
                samples = []
                for _ in range(self.local_batch):
                    fut, idx = futs.popleft()
                    samples.append(self._await_sample(fut, idx, pool, fetch))
                yield samples
        finally:
            # closed mid-epoch (max_steps): drop queued decodes instead of
            # draining them, and reap already-spawned ffmpeg children
            pool.shutdown(wait=False, cancel_futures=True)
            kill_inflight_decoders()


def stack_batch(samples: list, out: dict | None = None) -> dict:
    """List of sample dicts -> {key: stacked array}; each key is stacked
    into ``out[key]`` when given (one copy, no intermediate array)."""
    return {k: np.stack([s[k] for s in samples],
                        out=None if out is None else out[k])
            for k in samples[0]}


class _PinnedRing:
    """Pinned host buffers for ``slots`` batches, each copied to the card
    on a side stream.  A slot is written again only after the event of
    its previous copy has completed."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.slots = [None] * slots      # (host tensors, their numpy views)
        self.events = [None] * slots
        self.next = 0

    def _buffers(self, i: int, samples: list) -> dict:
        """Slot ``i``'s pinned tensors and their numpy views, allocated at
        first use for the batch's shapes (an epoch's batches share them)."""
        if self.slots[i] is None:
            slot = {}
            for k, v in samples[0].items():
                v = np.asarray(v)
                t = torch.empty((len(samples),) + v.shape, pin_memory=True,
                                dtype=torch.from_numpy(v[None]).dtype)
                slot[k] = (t, t.numpy())
            self.slots[i] = slot
        return self.slots[i]

    def put(self, samples: list) -> tuple:
        i = self.next
        self.next = (i + 1) % len(self.slots)
        if self.events[i] is not None:
            self.events[i].synchronize()
        slot = self._buffers(i, samples)
        stack_batch(samples, out={k: a for k, (_, a) in slot.items()})
        with torch.cuda.stream(self.stream):
            batch = {k: t.to(self.device, non_blocking=True)
                     for k, (t, _) in slot.items()}
            event = torch.cuda.Event()
            event.record(self.stream)
        self.events[i] = event
        return batch, event


def _host_put(samples: list) -> tuple:
    return {k: torch.from_numpy(v)
            for k, v in stack_batch(samples).items()}, None


def _ready(entry: tuple) -> dict:
    """The consumer's stream waits for the batch's copy, and the caching
    allocator learns that the consumer's stream uses its tensors."""
    batch, event = entry
    if event is not None:
        stream = torch.cuda.current_stream(next(iter(batch.values())).device)
        stream.wait_event(event)
        for t in batch.values():
            t.record_stream(stream)
    return batch


def device_prefetch(iterator: Iterator[list], device,
                    depth: int = 2) -> Iterator[dict]:
    """Batches of ``iterator`` (lists of samples) as dicts of tensors on
    ``device``, ``depth`` batches in flight ahead of the consumer.

    On a CUDA device each batch is stacked straight into a pinned buffer
    of a ring of ``depth + 1`` and copied on a side stream; the consumer's
    current stream waits on the copy's event before it gets the batch.
    On the CPU the stacked arrays are handed on as tensors, with no
    stream.

    Data-wait attribution: every pull of the upstream iterator (the host
    blocking on decode and stacking of the next batch) is timed as a
    ``data.wait`` span and added to ``milnce_data_wait_seconds_total``.
    The pulls run on the consumer's thread, between its steps, so the
    spans never overlap its ``step`` spans (the goodput ledger relies on
    that); the recorder is resolved per pull."""
    device = torch.device(device)
    put = (_PinnedRing(device, depth + 1).put if device.type == "cuda"
           else _host_put)
    queue: "collections.deque" = collections.deque()
    it = iter(iterator)
    n_pull = 0
    try:
        while True:
            with obs_spans.get_recorder().span("data.wait",
                                               batch=n_pull) as sp:
                samples = next(it, _EXHAUSTED)
                if samples is not _EXHAUSTED:
                    queue.append(put(samples))
            _OBS_DATA_WAIT.inc(sp["dur_ms"] / 1e3)
            if samples is _EXHAUSTED:
                break
            n_pull += 1
            if len(queue) > depth:
                yield _ready(queue.popleft())
        while queue:
            yield _ready(queue.popleft())
    finally:
        close = getattr(iterator, "close", None)
        if close is not None:
            close()


def flatten_text(batch: dict) -> tuple:
    """{'video': (B,T,H,W,3) u8, 'text': (B,K,W) i32} ->
    (video, text reshaped (B*K, W)) — the reference's flatten at
    main_distributed.py:229."""
    text = batch["text"]
    return batch["video"], text.reshape(-1, text.shape[-1])
