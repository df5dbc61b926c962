"""Eval batches over a device group and a process group, as the JAX evals
shard theirs over the mesh (``milnce_tpu/eval/retrieval.py``,
``milnce_tpu/eval/linear_probe.py``).

The shards are every device of the group (``parallel/devices.py``) on
every rank of the process group, rank-major: shard ``r * G + j`` is
device ``j`` of rank ``r``.  Each batch is padded with its last sample to
a multiple of the shard count and cut into that many equal contiguous
slices in order; each shard embeds its slice on its own device, and the
pad is dropped after.  A rank decodes only its own slices' samples, so
the decode is split over the ranks too; each device's forward is
launched before any output is read back, so the cards run side by side.
Under a process group every rank ends with every rank's rows, gathered
in rank order, so every rank computes the same metrics.
"""

from __future__ import annotations

import numpy as np
import torch.distributed as dist

from milnce_tpu_torch.parallel.devices import device_group, place_replicas
from milnce_tpu_torch.parallel.dist import gather_arrays, gather_objects


class EvalShards:
    """``model`` placed on ``devices`` (one device or a group), this rank's
    share of the ``process_group`` (None: this process alone)."""

    def __init__(self, model, devices, process_group=None):
        self.devices = device_group(devices)
        self.models = place_replicas(model, self.devices)
        self.group = process_group
        self.rank = 0 if process_group is None else dist.get_rank(
            process_group)
        self.world = 1 if process_group is None else dist.get_world_size(
            process_group)
        self.n = len(self.devices) * self.world

    def round(self, batch_size: int) -> int:
        """The JAX retrieval batch over ``n`` shards:
        ``max(n, (batch_size // n) * n)``."""
        return max(self.n, (batch_size // self.n) * self.n)

    def run(self, source, batch_size: int, launch, land) -> list:
        """Every sample of ``source`` in batches of ``batch_size``, each
        padded to a multiple of the shard count.  ``launch(j, samples)``
        starts device ``j``'s work on its slice's decoded samples and
        returns its device outputs; ``land(outputs)`` reads them back as
        a tuple of columns, each an array or a list of one row a sample.
        Returns the columns over the whole source, in source order, the
        pad dropped, on every rank."""
        g = len(self.devices)
        local, layout = [], []
        for start in range(0, len(source), batch_size):
            idx = list(range(start, min(start + batch_size, len(source))))
            real = len(idx)
            idx += [idx[-1]] * ((-real) % self.n)
            rows = len(idx) // self.n
            first = self.rank * g * rows
            mine = [idx[first + j * rows:first + (j + 1) * rows]
                    for j in range(g)]
            decoded = {i: source.sample(i) for i in sorted(set(sum(mine, [])))}
            outs = [launch(j, [decoded[i] for i in part])
                    for j, part in enumerate(mine)]
            local.append([land(o) for o in outs])
            layout.append((g * rows, real))
        columns = []
        for k in range(len(local[0][0])):
            parts = [part[k] for batch in local for part in batch]
            if isinstance(parts[0], list):
                ranks = gather_objects(sum(parts, []), self.group)
            else:
                ranks = gather_arrays(np.concatenate(parts), self.group)
            columns.append(_in_order(ranks, layout))
        return columns


def _in_order(ranks: list, layout: list):
    """Each rank's rows (its slices of every batch, in turn) -> the
    source's rows: batch by batch, the ranks' slices in rank order, the
    pad dropped."""
    out, offset = [], 0
    for rows, real in layout:
        batch = [r[offset:offset + rows] for r in ranks]
        if isinstance(ranks[0], list):
            out.extend(sum(batch, [])[:real])
        else:
            out.append(np.concatenate(batch)[:real])
        offset += rows
    return out if isinstance(ranks[0], list) else np.concatenate(out)
