"""The 2-D ``(data, model)`` layout's device mesh (port of
``milnce_tpu/parallel/mesh.py::build_mesh``).

The JAX package builds one ``Mesh`` over its devices, ``(data,)`` or,
with ``parallel.model_axis`` and ``model_parallel_size > 1``, ``(data,
model)`` with the model axis trailing (``devs.reshape(-1,
model_parallel_size)``).  Here one process is one rank of the run's
group, and :func:`build_mesh` lays the W ranks out as
``init_device_mesh(device_type, (W / mp, mp), mesh_dim_names=(data_axis,
model_axis))``: rank r sits at data index ``r // mp`` and model index
``r % mp``, the model axis the fast one, as in the JAX grid.  Its two
sub-groups carry the FSDP collectives (``parallel/sharding_map.py``);
the whole group still carries the gathers of the losses, since every
rank is a data shard.  With no model axis there is no mesh: the 1-D
layout is the group itself (``parallel/dist.py``).

The mesh's device type names the transport of its groups: ``cuda`` over
NCCL, ``cpu`` over gloo (which carries the layout's collectives on CUDA
tensors too: two ranks on one card run over gloo, since NCCL takes one
rank a card).  Every refusal happens in :func:`check_model_axis`, before
a model is built: nothing falls back to the 1-D layout silently.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch.distributed as dist

from milnce_tpu_torch.config import ParallelConfig


@dataclasses.dataclass(frozen=True)
class Grid:
    """The built 2-D layout: the DeviceMesh and the axis names."""
    mesh: object
    data_axis: str
    model_axis: str

    @property
    def model_group(self):
        return self.mesh.get_group(self.model_axis)

    @property
    def data_group(self):
        return self.mesh.get_group(self.data_axis)

    @property
    def model_size(self) -> int:
        return self.mesh.size(1)

    @property
    def data_size(self) -> int:
        return self.mesh.size(0)

    @property
    def model_rank(self) -> int:
        return self.mesh.get_local_rank(self.model_axis)

    @property
    def shape(self) -> dict:
        """``{data_axis: W / mp, model_axis: mp}``, the JAX mesh shape."""
        return {self.data_axis: self.data_size,
                self.model_axis: self.model_size}


def check_model_axis(cfg: ParallelConfig, world: int) -> None:
    """Refuse a 2-D request the run cannot carry (JAX
    ``train/loop.py:246-257``): a ``model_axis`` without
    ``model_parallel_size > 1`` (a silent 1-D run the config claims is
    FSDP), a ``model_parallel_size > 1`` without a ``model_axis`` (the
    JAX mesh drops the size and trains 1-D), a model axis named as the
    data axis, and a world size the model axis does not divide."""
    axis, mp = cfg.model_axis, int(cfg.model_parallel_size)
    if axis and mp <= 1:
        raise ValueError(
            f"parallel.model_axis={axis!r} is set but the mesh would have "
            f"no model axis — set parallel.model_parallel_size > 1 (it is "
            f"{mp})")
    if not axis and mp != 1:
        raise ValueError(
            f"parallel.model_parallel_size={mp} needs parallel.model_axis "
            "(the 2-D layout's axis name, e.g. 'model')")
    if axis and axis == cfg.data_axis:
        raise ValueError(f"parallel.model_axis={axis!r} is the data axis")
    if axis and world % mp:
        raise ValueError(
            f"parallel.model_parallel_size={mp} does not divide the run's "
            f"{world} ranks (the 2-D layout is (ranks / {mp}) x {mp})")


def build_mesh(cfg: ParallelConfig, group) -> Optional[Grid]:
    """The (data, model) DeviceMesh over the ranks of ``group`` (the run's
    default group), or None without a model axis (the 1-D layout).  Call
    :func:`check_model_axis` first."""
    if not cfg.model_axis:
        return None
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size(group)
    mp = int(cfg.model_parallel_size)
    device_type = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    mesh = init_device_mesh(device_type, (world // mp, mp),
                            mesh_dim_names=(cfg.data_axis, cfg.model_axis))
    return Grid(mesh, cfg.data_axis, cfg.model_axis)
