"""The lockstep of a serving grid: ``milnce-serve-torch`` over the ranks of
a process group, rank 0 running the front and every other rank replaying,
in order, the device calls rank 0 makes.

JAX's programs on a mesh that spans processes are SPMD: every process
calls the same program in the same order with the same host inputs, and
the JAX ``milnce-serve`` leaves that to its callers.  Here a call that
reached one rank only would hang the other ranks' collective, so the
order is made explicit: every device call rank 0 makes under the
dispatch lock (``serving/engine.py::DEVICE_DISPATCH_LOCK``) is announced
first --

- one broadcast of a small header over a gloo group: what the call is
  (an embed at a bucket, a query batch, a live-index ingest or swap, a
  heartbeat, close), its generation, its rows' dtype and shape;
- then its rows over the serving group, from the card over NCCL, from
  the host over gloo: an embed's bucket is scattered, each rank getting
  only the W-th of its rows that its own shards run (as JAX moves each
  process's shards onto the mesh); a query batch or an ingest, which
  every rank runs whole, is broadcast.

:func:`follow` receives both on every other rank, runs the same call
(``InferenceEngine.replay``, ``replay_query``, ``replay_ingest``,
``replay_swap``) and drops its result.  This adds no serving feature.

Nothing waits forever: the header rides gloo on every backend, so a rank
that has died makes rank 0's next announcement raise
(:class:`FollowerLost`), at once when its sockets close and within
``parallel.group_timeout_s`` when it hangs; from then on every call
raises at once.  An idle rank 0 sends a heartbeat every quarter of that
timeout, so an idle grid does not time its followers out.
"""

from __future__ import annotations

import threading
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from milnce_tpu_torch.serving.engine import DEVICE_DISPATCH_LOCK

KINDS = ("close", "beat", "text", "video", "query", "ingest", "swap")
_SCATTERED = ("text", "video")      # each rank runs its W-th of the rows
_DTYPES = (torch.uint8, torch.int32, torch.float32)
_HEADER = 12          # kind, generation, dtype, ndim, up to 8 dims


class FollowerLost(RuntimeError):
    """A serving rank stopped answering rank 0's announcements; the grid
    serves no more calls until the processes restart."""


class _Channel:
    """The two groups a message rides: ``control`` (gloo: the headers)
    and ``group`` (the serving group: the rows, on ``payload_device``).
    Every rank constructs it at the same point (over NCCL it forms a
    gloo group, a collective)."""

    def __init__(self, group, timeout_s: float):
        self.group = group
        self.src = dist.get_global_rank(group, 0)
        self.world = dist.get_world_size(group)
        self.payload_device = _payload_device(group)
        if dist.get_backend(group) == "nccl":
            self.control = dist.new_group(
                dist.get_process_group_ranks(group),
                timeout=timedelta(seconds=timeout_s), backend="gloo")
        else:
            self.control = group


def _payload_device(group) -> torch.device:
    """Where a group's rows travel: the current card over NCCL, the host
    over gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def share_boot(group, load) -> tuple:
    """Rank 0's boot corpus on every rank of ``group``: ``load()`` runs on
    rank 0 alone -> (generation, (N, D) rows or None), and every rank
    returns rank 0's pair, the rows as float32 on the host.  The ranks
    of a grid must number their global rows from one corpus and one
    generation; the files each rank's host holds (its snapshot, which
    rank 0 alone writes, or its corpus) need not agree."""
    src = dist.get_global_rank(group, 0)
    gen, rows = load() if dist.get_rank(group) == 0 else (0, None)
    if rows is not None:
        rows = np.ascontiguousarray(rows, dtype=np.float32)
    meta = [(int(gen), None if rows is None else tuple(rows.shape))]
    dist.broadcast_object_list(meta, src, group=group)
    gen, shape = meta[0]
    if shape is None:
        return gen, None
    dev = _payload_device(group)
    x = (torch.from_numpy(rows).to(dev) if rows is not None else
         torch.empty(shape, dtype=torch.float32, device=dev))
    dist.broadcast(x, src, group=group)
    return gen, (rows if rows is not None else x.cpu().numpy())


def _header(kind: str, gen: int, x) -> torch.Tensor:
    h = torch.zeros(_HEADER, dtype=torch.int64)
    h[0], h[1] = KINDS.index(kind), int(gen)
    if x is None:
        h[2] = -1
    else:
        h[2], h[3] = _DTYPES.index(x.dtype), x.ndim
        h[4:4 + x.ndim] = torch.tensor(x.shape)
    return h


class Leader(_Channel):
    """Rank 0's side: :meth:`announce` is the ``announce`` hook of its
    engine and index.  ``sent`` counts the messages and ``seconds`` the
    host's time in them."""

    def __init__(self, group, timeout_s: float):
        super().__init__(group, timeout_s)
        self.lost = None                # guarded-by: DEVICE_DISPATCH_LOCK
        self.sent = 0                   # guarded-by: DEVICE_DISPATCH_LOCK
        self.seconds = 0.0              # guarded-by: DEVICE_DISPATCH_LOCK
        self._beat_s = max(0.5, timeout_s / 4)
        self._last = time.monotonic()   # guarded-by: DEVICE_DISPATCH_LOCK
        self._closed = threading.Event()
        self._beat = threading.Thread(target=self._beat_loop, daemon=True,
                                      name="lockstep-beat")
        self._beat.start()

    # guarded-by: DEVICE_DISPATCH_LOCK
    def announce(self, kind: str, rows=None, gen: int = 0):
        """Send one call to every other rank (the dispatch lock held):
        its header, then its rows (a host array or tensor) if any.
        Returns the rows rank 0 runs the same call on, on the payload
        device: an embed's first W-th, else all of them."""
        if self.lost is not None:
            raise FollowerLost(f"the serving grid lost a rank earlier: "
                               f"{self.lost}") from self.lost
        x = None if rows is None else torch.as_tensor(rows)
        t0 = time.perf_counter()
        try:
            dist.broadcast(_header(kind, gen, x), self.src,
                           group=self.control)
            if x is not None:
                x = x.to(self.payload_device).contiguous()
                if kind in _SCATTERED:
                    parts = list(x.tensor_split(self.world))
                    x = parts[0]
                    dist.scatter(torch.empty_like(x), parts, self.src,
                                 group=self.group)
                else:
                    dist.broadcast(x, self.src, group=self.group)
        except Exception as exc:
            self.lost = exc
            raise FollowerLost(f"a serving rank did not take rank 0's "
                               f"{kind!r} call: {exc}") from exc
        self.seconds += time.perf_counter() - t0
        self.sent += 1
        self._last = time.monotonic()
        return x

    def _beat_loop(self) -> None:
        while not self._closed.wait(self._beat_s / 4):
            with DEVICE_DISPATCH_LOCK:
                if (self.lost is None and not self._closed.is_set()
                        and time.monotonic() - self._last >= self._beat_s):
                    try:
                        self.announce("beat")
                    except FollowerLost:
                        pass            # every later call raises

    def close(self) -> bool:
        """End the heartbeat and send ``close``: every other rank leaves
        :func:`follow`.  False when a rank was lost before."""
        self._closed.set()
        self._beat.join()
        with DEVICE_DISPATCH_LOCK:
            if self.lost is not None:
                return False
            try:
                self.announce("close")
            except FollowerLost:
                return False
        return True


def follow(group, timeout_s: float, engine, index=None) -> int:
    """Every other rank's side: replay rank 0's calls on ``engine`` and
    ``index`` (frozen, live or None), in order, until ``close``; returns
    the calls replayed.  Raises when rank 0 is gone."""
    ch = _Channel(group, timeout_s)
    calls = 0
    while True:
        h = torch.zeros(_HEADER, dtype=torch.int64)
        dist.broadcast(h, ch.src, group=ch.control)
        kind, gen, code, ndim = (int(v) for v in h[:4])
        kind = KINDS[kind]
        x = None
        if code >= 0:
            shape = [int(d) for d in h[4:4 + ndim]]
            if kind in _SCATTERED:
                shape[0] //= ch.world
            x = torch.empty(shape, dtype=_DTYPES[code],
                            device=ch.payload_device)
            if kind in _SCATTERED:
                dist.scatter(x, None, ch.src, group=ch.group)
            else:
                dist.broadcast(x, ch.src, group=ch.group)
        if kind == "close":
            return calls
        if kind in ("text", "video"):
            engine.replay(kind, x)
        elif kind == "query":
            index.replay_query(x)
        elif kind == "ingest":
            index.replay_ingest(gen, x)
        elif kind == "swap":
            index.replay_swap(gen, timeout_s)
        calls += kind != "beat"
