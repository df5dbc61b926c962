"""ELASTIC_STAMP.json: the topology sidecar of a checkpoint rotation
(port of ``milnce_tpu/elastic/stamp.py``; the file is the JAX schema key
for key, so either package reads the other's stamp).

A data-parallel checkpoint holds whole tensors, never a layout — which
is what makes a resume at another world size possible, and why a resume
can't tell from the rotation alone what layout wrote it.  The stamp
records the writing run's mesh shape (``{"data": world}``, or ``{"data":
W / mp, "model": mp}`` on the 2-D layout), sharding-map hash ('' on a
data-parallel run) and plan cursor
next to the rotation (same atomic tmp+``os.replace`` discipline as
``CURRICULUM_STAMP.json``), so a resume at another world size is a
*logged, validated* topology change instead of a silent one, and the
two sidecars can be cross-checked: both must agree on the plan cursor,
or one of them is stale.

Stdlib-only, like train/curriculum.py's stamp half.
"""

from __future__ import annotations

import json
import os
from typing import Optional

#: checkpoint sidecar, written by rank 0 next to the checkpoint rotation
#: at every save (train/loop.py) — overwritten each time: it describes
#: the LATEST saved state, which is what ``restore_latest`` hands back.
ELASTIC_STAMP_NAME = "ELASTIC_STAMP.json"

SCHEMA = "milnce.elastic/v1"


def write_elastic_stamp(ckpt_dir: str, *, mesh_shape: dict,
                        sharding_hash: str, step: int, stage_index: int,
                        batch_offset: int, drained: bool) -> None:
    """Atomic sidecar write (rank 0 only — the caller gates).

    ``mesh_shape`` is the axis->size dict (``{"data": world}``, or
    ``{"data": 4, "model": 2}`` on the 2-D layout);
    ``sharding_hash`` is the FSDP sharding map's layout hash ('' on a
    data-parallel run);
    ``step``/``stage_index``/``batch_offset`` are the plan cursor —
    the global optimizer step plus where ``plan.locate(step)`` places
    it, pinned identical across topology changes."""
    payload = {
        "schema": SCHEMA,
        "mesh": {str(k): int(v) for k, v in mesh_shape.items()},
        "n_devices": int(_mesh_size(mesh_shape)),
        "sharding_hash": str(sharding_hash),
        "step": int(step),
        "stage": int(stage_index),
        "batch_offset": int(batch_offset),
        "drained": bool(drained),
    }
    path = os.path.join(ckpt_dir, ELASTIC_STAMP_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(payload, fh, indent=1)
    os.replace(tmp, path)


def read_elastic_stamp(ckpt_dir: str) -> Optional[dict]:
    path = os.path.join(ckpt_dir, ELASTIC_STAMP_NAME)
    if not os.path.exists(path):
        return None         # pre-elastic checkpoint: nothing to validate
    with open(path) as fh:
        return json.load(fh)


def _mesh_size(mesh_shape: dict) -> int:
    n = 1
    for v in mesh_shape.values():
        n *= int(v)
    return n


def check_topology_resume(stamp: Optional[dict], *, mesh_shape: dict,
                          batch_sizes, curriculum_stamp: Optional[dict]
                          ) -> Optional[str]:
    """Validate a resume against the stamp's topology; returns a log
    line describing the topology change (None when the layout is
    unchanged or there is no stamp to compare).

    Two loud refusals, both BEFORE any checkpoint is read:

    - **mesh-indivisible batch**: every stage's global batch must divide
      over the new world size — the loader would otherwise hand the
      ranks unequal shards, and a shape error deep in a collective never
      names the topology change that caused it;
    - **stale sidecar pair**: ``CURRICULUM_STAMP.json`` and
      ``ELASTIC_STAMP.json`` are written together at every save; a
      plan-cursor disagreement means one sidecar survived a crash the
      other didn't, and resuming on either cursor could skip or repeat
      batches.
    """
    n_dev = _mesh_size(mesh_shape)
    for i, b in enumerate(batch_sizes):
        if int(b) % n_dev != 0:
            raise ValueError(
                f"elastic resume refused: stage {i} batch_size {b} does "
                f"not divide over the {n_dev}-device mesh "
                f"{dict(mesh_shape)} — a resized resume must keep every "
                "stage's global batch divisible by the new device count "
                "(adjust parallel.num_devices or the batch sizes)")
    if stamp is None:
        return None
    if curriculum_stamp is not None:
        saved = int(stamp.get("step", -1))
        cur = int(curriculum_stamp.get("step", -1))
        if saved != cur:
            raise ValueError(
                "elastic resume refused: ELASTIC_STAMP.json (step "
                f"{saved}) and CURRICULUM_STAMP.json (step {cur}) "
                "disagree on the plan cursor — the sidecar pair is "
                "stale (a crash between stamp writes?); inspect the "
                "rotation and delete the stale stamp to proceed")
    old = {str(k): int(v) for k, v in (stamp.get("mesh") or {}).items()}
    new = {str(k): int(v) for k, v in mesh_shape.items()}
    if old == new:
        return None
    return (f"elastic resume: topology change {old or '?'} -> {new} "
            f"(checkpoint step {stamp.get('step')}, "
            f"sharding hash {stamp.get('sharding_hash') or 'none'} -> "
            "re-derived for the new layout; state reshards through the "
            "restore-template path)")
