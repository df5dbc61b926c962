"""The FSDP per-parameter sharding map of the ``(data, model)`` layout
and the placement that carries it (port of
``milnce_tpu/parallel/sharding_map.py``).

The batch shards over both axes (every rank is a data shard), and LARGE
parameters also shard over the model axis, so every rank stores only
``1/model_parallel_size`` of each big tensor and of its Adam moments.

The map is the JAX package's, decided in the JAX names and layouts: the
port keeps the reference's PyTorch layouts (conv ``(O, I, t, h, w)``,
linear ``(O, I)``) where Flax holds ``(t, h, w, I, O)`` and ``(I, O)``, so
the automatic rule run on a torch shape could break a tie toward another
logical dimension.  :func:`build_param_map` therefore runs the rule on
each parameter's Flax path and shape (``utils/torch_convert.py``'s
bridge, the one the weight converter uses) and translates the chosen
Flax dimension back to the torch dimension.  ``parallel.sharding_map``
overrides are written in Flax paths and dimensions, and
:func:`describe_map` and :func:`map_hash` give the JAX strings and hash:
the same map means the same layout in both packages.

Default rule (the FSDP size threshold), as in JAX:

- a parameter with ``>= min_size`` elements shards on its largest
  Flax dimension divisible by the model-axis size (ties to the LAST
  dimension, channels-out for conv kernels);
- everything smaller (BatchNorm scales, biases, the small denses)
  replicates, and so does a large parameter with no divisible
  dimension;
- the frozen word table is a parameter of the map like any other: it
  shards, is gathered for the forward, and has no gradient.

:class:`ShardedPlacement` holds the layout at run time.  Between steps
each sharded parameter's ``.data`` is this rank's slice of it (the
optimizer steps those slices, so its moments are slices too);
:meth:`~ShardedPlacement.gather_params` puts the full tensors back for a
forward, :meth:`~ShardedPlacement.reduce_grads_2d` reduces the
gradients and returns each sharded parameter to its slice.

The reduction has the JAX step's two forms (``parallel.overlap_grad_reduce``,
JAX ``_reduce_grads_2d(overlap=...)``).  Fused (``False``): after the
backward, each sharded leaf is reduce-scattered then all-reduced over
data, and the replicated leaves share one flat all-reduce.  Per leaf
(``True``, the default): every leaf is a collective of its own, issued
asynchronously as soon as its gradient is final, so it runs while the
rest of the backward does.  A post-accumulate-grad hook on each trained
parameter (the gathered full tensor, for a sharded leaf) marks its leaf
final; the collectives go out in one fixed order, the reverse of the
map's, the same on every rank (:class:`~milnce_tpu_torch.parallel.dist.
IssueQueue`): the ready prefix as it grows, the rest after the backward.
The hooks act only inside :meth:`~ShardedPlacement.reducing`, which the
steps open around their last backward (the grad-cache step's last
microbatch), so the gradients are reduced once a step.

A collective over the whole group runs asynchronously: it shares one
communicator, and on a card one NCCL stream, with the backward's own
collectives (sync BatchNorm, the loss's gathers), which the backward
issues in its graph's order, the same on every rank, so the device runs
them all in the one order every rank issued them in.  A collective over
a proper sub-group (the model axis of a grid with more than one data
row, the data axis) is another communicator: NCCL orders no kernels
across communicators, and two ranks whose kernels of two communicators
reach the device in other orders wait on each other for ever (the first
NCCL run of the per-leaf form hung so, the replicated leaves then on a
group of their own).  So before such a collective the step waits for
every collective in flight, then runs it with the backward's stream
waiting on it: one communicator at a time is in flight.  On the (1 x M)
grid the model axis is the whole group and every leaf overlaps the
backward; on a grid with data rows the sharded leaves are reduced in
the backward's stream, in the fixed order.

A checkpoint holds full tensors and no layout:
:meth:`~ShardedPlacement.full_state` gathers them,
:meth:`~ShardedPlacement.load_full_state` slices them, so a 1-D
checkpoint opens on the grid and a 2-D one on 1-D or in one process.
"""

from __future__ import annotations

import contextlib
import fnmatch
import hashlib
import json
import math
from typing import Optional

import torch
import torch.distributed as dist

from milnce_tpu_torch.parallel.dist import IssueQueue, all_reduce_flat
from milnce_tpu_torch.train.state import load_optimizer_state
from milnce_tpu_torch.utils.torch_convert import flax_location

# Elements, not bytes: 65536 f32 elements = 256 KiB a replica; below it
# the per-step gather costs more than the storage saves.
DEFAULT_FSDP_MIN_SIZE = 65536


def _auto_dim(shape: tuple, axis_size: int, min_size: int) -> Optional[int]:
    """The dimension the automatic rule shards, or None (replicate)."""
    if math.prod(shape) < max(1, min_size):
        return None
    best = None
    for d, extent in enumerate(shape):
        if extent % axis_size == 0 and extent >= axis_size:
            if best is None or extent >= shape[best]:
                best = d
    return best


def parse_sharding_spec(spec: str) -> dict:
    """``ParallelConfig.sharding_map`` -> ``{path_glob: dim | None}``.

    Accepts '' (the automatic rule alone), an inline
    ``glob=dim[,glob=dim...]`` spec (``dim`` an integer, or ``-`` to
    force-replicate), or a path to a JSON file: a raw map or an
    artifact with the map under ``sharding_map``.  Globs match Flax
    paths joined by '/'; dims are Flax dims."""
    if not spec:
        return {}
    if "=" in spec:
        items = [item for item in spec.split(",") if item]
        bad = [item for item in items if "=" not in item]
        if bad:
            raise ValueError(f"sharding map items missing '=': {bad} "
                             "(inline form is 'glob=dim[,glob=dim...]')")
        mapping = dict(item.split("=", 1) for item in items)
    else:
        with open(spec) as fh:
            payload = json.load(fh)
        mapping = payload.get("sharding_map", payload)
    out: dict = {}
    for pattern, val in mapping.items():
        if val in ("-", None):
            out[pattern] = None
            continue
        try:
            out[pattern] = int(val)
        except (TypeError, ValueError):
            raise ValueError(
                f"sharding map entry {pattern!r} has dim {val!r} — "
                "expected an integer dim index or '-' (replicate)")
    return out


class ParamEntry:
    """One parameter of the map: its torch name, Flax path and shape, the
    Flax dimension it shards on (None: replicated) and the torch
    dimension that is."""

    def __init__(self, name, path, flax_shape, flax_dim, torch_dim):
        self.name, self.path, self.flax_shape = name, path, flax_shape
        self.flax_dim, self.torch_dim = flax_dim, torch_dim


def build_param_map(model: torch.nn.Module, axis_size: int,
                    min_size: int = DEFAULT_FSDP_MIN_SIZE,
                    spec: str = "") -> list:
    """The map of every parameter of ``model`` (full-size, as built), as
    :class:`ParamEntry` in ``named_parameters`` order.  Raises when an
    override pattern matches no parameter or names a dimension that is
    out of range or does not divide over the axis (JAX
    ``build_param_specs``)."""
    overrides = parse_sharding_spec(spec)
    matched: set = set()
    keys = set(model.state_dict())
    entries = []
    for name, p in model.named_parameters():
        _, path, perm = flax_location(name, p.dim(), keys)
        path = "/".join(path)
        shape = tuple(p.shape[d] for d in perm)
        dim = _auto_dim(shape, axis_size, min_size)
        for pattern, odim in overrides.items():
            if fnmatch.fnmatchcase(path, pattern):
                matched.add(pattern)
                dim = odim
                if dim is not None:
                    if not 0 <= dim < len(shape):
                        raise ValueError(
                            f"sharding map override {pattern!r}: dim {dim} "
                            f"out of range for {path} {shape}")
                    if shape[dim] % axis_size != 0:
                        raise ValueError(
                            f"sharding map override {pattern!r}: {path} dim "
                            f"{dim} (extent {shape[dim]}) does not divide "
                            f"the model axis size {axis_size}")
        entries.append(ParamEntry(name, path, shape, dim,
                                  None if dim is None else perm[dim]))
    unmatched = set(overrides) - matched
    if unmatched:
        raise ValueError(
            f"sharding map patterns matched no parameter: "
            f"{sorted(unmatched)} (typo'd glob — params are addressed by "
            "their '/'-joined Flax path)")
    return entries


def describe_map(entries: list, model_axis: str) -> dict:
    """``{flax path: 'model@dim (shape)' | 'replicated (shape)'}``, the
    JAX summary string for string."""
    out = {}
    for e in entries:
        shape = "x".join(str(s) for s in e.flax_shape)
        out[e.path] = (f"{model_axis}@{e.flax_dim} ({shape})"
                       if e.flax_dim is not None else f"replicated ({shape})")
    return out


def map_hash(summary: dict) -> str:
    """Stable 12-hex digest of a :func:`describe_map` summary (the JAX
    digest): two runs' layouts compare by it."""
    blob = json.dumps(summary, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


def sharded_count(entries: list) -> int:
    return sum(1 for e in entries if e.flax_dim is not None)


def _slice(full: torch.Tensor, dim: int, rank: int, size: int):
    k = full.shape[dim] // size
    return full.narrow(dim, rank * k, k)


class ShardedPlacement:
    """The map placed on a :class:`~milnce_tpu_torch.parallel.mesh.Grid`:
    the model's sharded parameters hold this rank's slices (see the
    module docstring), plus the map's identity (``summary``, ``hash``,
    ``n_sharded``) that the run records."""

    def __init__(self, model: torch.nn.Module, grid, group,
                 min_size: int = DEFAULT_FSDP_MIN_SIZE, spec: str = "",
                 overlap: bool = True):
        self.model, self.grid, self.group = model, grid, group
        self.overlap = overlap
        self.entries = build_param_map(model, grid.model_size, min_size,
                                       spec)
        self.summary = describe_map(self.entries, grid.model_axis)
        self.hash = map_hash(self.summary)
        self.n_sharded = sharded_count(self.entries)
        params = dict(model.named_parameters())
        self.sharded = [(params[e.name], e.torch_dim) for e in self.entries
                        if e.torch_dim is not None]
        ids = {id(p) for p, _ in self.sharded}
        self.replicated = [p for p in params.values() if id(p) not in ids]
        self._dims = {id(p): d for p, d in self.sharded}
        self._names = {e.name: e.torch_dim for e in self.entries
                       if e.torch_dim is not None}
        self._shards: Optional[list] = None
        with torch.no_grad():
            for p, d in self.sharded:
                p.data = self._local(p.data, d).clone()
        # the per-leaf reduction: the fixed issue order (the map's,
        # reversed) and a hook a trained leaf
        self._order = [params[e.name] for e in reversed(self.entries)
                       if params[e.name].requires_grad]
        self._queue = IssueQueue(len(self._order), self._issue)
        self._armed = False
        self._pending: list = []        # (param, work or None, (result,))
        if overlap:
            for i, p in enumerate(self._order):
                p.register_post_accumulate_grad_hook(
                    lambda _p, i=i: self._final(i))

    def _local(self, full: torch.Tensor, dim: int) -> torch.Tensor:
        return _slice(full, dim, self.grid.model_rank, self.grid.model_size)

    def dim_of(self, p: torch.Tensor) -> Optional[int]:
        """The torch dimension ``p`` shards on (None: replicated)."""
        return self._dims.get(id(p))

    def _gather(self, shard: torch.Tensor, dim: int) -> torch.Tensor:
        shard = shard.contiguous()
        parts = [torch.empty_like(shard)
                 for _ in range(self.grid.model_size)]
        dist.all_gather(parts, shard, group=self.grid.model_group)
        return torch.cat(parts, dim=dim)

    # ------------------------------------------------------- the step's side
    def gather_params(self) -> None:
        """FSDP gather (JAX ``_gather_params``): every sharded parameter
        becomes its full tensor, one all-gather over the model axis each,
        for the forward and backward.  Idempotent."""
        if self._shards is not None:
            return
        self._shards = [p.data for p, _ in self.sharded]
        with torch.no_grad():
            for p, d in self.sharded:
                p.data = self._gather(p.data, d)

    def release(self) -> None:
        """Back to the slices, dropping the full tensors and their
        gradients (a forward and backward that took no step)."""
        if self._shards is None:
            return
        for (p, _), shard in zip(self.sharded, self._shards):
            p.data = shard
            p.grad = None
        self._shards = None

    @contextlib.contextmanager
    def reducing(self):
        """The body's backward is the step's last: with ``overlap`` each
        leaf's reduction is issued as its gradient becomes final in it
        (module docstring); fused, nothing happens until
        :meth:`reduce_grads_2d`."""
        self._armed = self.overlap
        try:
            yield
        finally:
            self._armed = False

    def _final(self, i: int) -> None:
        """Leaf ``i``'s gradient is final (its post-accumulate-grad hook)."""
        if self._armed:
            self._queue.ready(i)

    def _issue(self, i: int) -> None:
        """Issue leaf ``i``'s reduction: one all-reduce over the whole
        group (a replicated leaf), or a reduce-scatter over the model axis
        then an all-reduce over data (a sharded one); asynchronously on
        the whole group's communicator, else one communicator at a time
        (module docstring).  A sharded leaf's full gradient lives on in
        its collective alone, as the fused form frees it leaf by leaf."""
        p = self._order[i]
        g = p.grad
        d = self._dims.get(id(p))
        if d is None:
            work = dist.all_reduce(g, group=self.group, async_op=True)
            self._pending.append((p, work, (g,)))
            return
        p.grad = None
        g = g.movedim(d, 0).contiguous()
        out = g.new_empty((g.shape[0] // self.grid.model_size,) + g.shape[1:])
        if self.grid.model_group is self.group:
            work = dist.reduce_scatter_tensor(out, g, group=self.group,
                                              async_op=True)
            self._pending.append((p, work, (out,)))
            return
        self._drain()
        dist.reduce_scatter_tensor(out, g, group=self.grid.model_group)
        if self.grid.data_size > 1:
            dist.all_reduce(out, group=self.grid.data_group)
        self._pending.append((p, None, (out,)))

    def _drain(self) -> None:
        """Wait for every collective in flight (on a card: the current
        stream waits on them)."""
        for k, (p, work, out) in enumerate(self._pending):
            if work is not None:
                work.wait()
                self._pending[k] = (p, None, out)

    def reduce_grads_2d(self, mean: bool) -> None:
        """The 2-D gradient reduction (JAX ``_reduce_grads_2d``): a
        sharded parameter's full gradient is reduce-scattered over the
        model axis along its dimension (this rank keeps its slice of the
        sum), then summed over the data axis, and the parameter returns
        to its slice with that gradient; the replicated gradients are
        summed over both axes.  ``mean`` (the DTW family) divides by the
        number of ranks.  With ``overlap`` every leaf not issued during
        the backward is issued now, in the fixed order, and the step waits
        on all of them; fused, the collectives run here in the map's order
        and the replicated leaves share one flat all-reduce."""
        if self.overlap:
            self._reduce_overlapped(mean)
            return
        world = dist.get_world_size(self.group)
        for (p, d), shard in zip(self.sharded, self._shards):
            g = p.grad
            p.data, p.grad = shard, None
            if g is None:
                continue
            g = g.movedim(d, 0).contiguous()
            out = g.new_empty((g.shape[0] // self.grid.model_size,)
                              + g.shape[1:])
            dist.reduce_scatter_tensor(out, g, group=self.grid.model_group)
            if self.grid.data_size > 1:
                dist.all_reduce(out, group=self.grid.data_group)
            if mean:
                out /= world
            p.grad = out.movedim(0, d).contiguous()
        self._shards = None
        all_reduce_flat([p.grad for p in self.replicated
                         if p.grad is not None], self.group, mean=mean)

    def _reduce_overlapped(self, mean: bool) -> None:
        self._queue.flush(lambda i: self._order[i].grad is not None)
        self._drain()
        reduced = {id(p): out for p, _, (out,) in self._pending}
        self._pending = []
        self._queue.reset()
        world = dist.get_world_size(self.group)
        for (p, d), shard in zip(self.sharded, self._shards):
            out = reduced.get(id(p))
            p.data, p.grad = shard, None
            if out is not None:
                if mean:
                    out /= world
                p.grad = out.movedim(0, d).contiguous()
        self._shards = None
        grads = [p.grad for p in self.replicated if id(p) in reduced]
        if mean and grads:
            torch._foreach_div_(grads, world)

    @contextlib.contextmanager
    def full_params(self):
        """The full parameters for the body (an eval, a state dict), back
        to the slices after; every rank must enter it together."""
        self.gather_params()
        try:
            yield
        finally:
            self.release()

    # ------------------------------------------------------ checkpoints
    def full_state(self, model: torch.nn.Module, optimizer) -> tuple:
        """(model state_dict, optimizer state_dict) with every sharded
        tensor gathered to its full size: the parameters and each of
        their per-parameter optimizer tensors (Adam's moments).  A
        collective: every rank calls it."""
        with self.full_params():
            model_sd = {k: v.detach().clone()
                        for k, v in model.state_dict().items()}
        opt_sd = optimizer.state_dict()
        order = [p for g in optimizer.param_groups for p in g["params"]]
        state = {}
        for idx, st in opt_sd["state"].items():
            p = order[idx]
            d = self.dim_of(p)
            state[idx] = {
                key: (self._gather(val, d) if d is not None
                      and torch.is_tensor(val) and val.shape == p.shape
                      and val.dim() > 0 else val)
                for key, val in st.items()}
        return model_sd, {**opt_sd, "state": state}

    def load_full_state(self, model: torch.nn.Module, optimizer,
                        model_sd: dict, opt_sd: dict) -> None:
        """Load full-tensor state (any layout's checkpoint) into this
        rank's slices.  A sliced optimizer tensor is made contiguous, as
        its parameter's slice is: the fused optimizer on the card takes
        a parameter's moments only at its strides."""
        local = {k: (self._local(v, self._names[k]) if k in self._names
                     else v) for k, v in model_sd.items()}
        model.load_state_dict(local)
        order = [p for g in optimizer.param_groups for p in g["params"]]
        state = {}
        for idx, st in opt_sd["state"].items():
            p = order[int(idx)]
            d = self.dim_of(p)
            full = None if d is None else p.shape[:d] + (
                p.shape[d] * self.grid.model_size,) + p.shape[d + 1:]
            state[idx] = {
                key: (self._local(val, d).contiguous() if d is not None
                      and torch.is_tensor(val) and val.shape == full
                      else val)
                for key, val in st.items()}
        load_optimizer_state(optimizer, {**opt_sd, "state": state})
