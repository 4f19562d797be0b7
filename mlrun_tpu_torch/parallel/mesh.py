"""Device meshes over ``torch.distributed`` — counterpart of
``mlrun_tpu/parallel/mesh.py``.

The reference builds a ``jax.sharding.Mesh`` over the devices of a TPU
slice; the port builds a ``torch.distributed.device_mesh.DeviceMesh`` over
the ranks of the default process group (one process per GPU), with the
reference's named axes in its order:

- ``data``   pure data parallelism (the batch)
- ``fsdp``   parameters sharded, batch split too
- ``tensor`` tensor parallelism (the layers' column- and row-parallel
  projections, parallel/tensor.py)
- ``seq``    context parallelism (ring or Ulysses attention)
- ``pipe``   pipeline stages (parallel/pipeline.py)

``initialize_distributed`` joins the process group the way the launcher
set it up (torchrun's environment, or an explicit address): NCCL for CUDA
devices, gloo for the CPU. A single process with no launcher gets a
world-size-1 group on an in-process store, so a mesh of size 1 runs the
sharded path too. A mesh may hold a subset of the group's ranks (the
survivors of an elastic reshard); every rank of the group builds it, as
it builds the process groups the mesh's collectives run on
(:func:`axes_group`). The reference's ``mesh_shape_for_topology`` maps
TPU topologies and has no counterpart here.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Sequence

import torch
import torch.distributed as dist

DEFAULT_AXES = ("data", "fsdp", "tensor")
# rendezvous and collective timeout of the groups this module creates
PROCESS_GROUP_TIMEOUT = timedelta(minutes=10)


@dataclass(frozen=True)
class MeshConfig:
    """Declarative logical mesh description."""

    shape: dict  # axis name -> size; -1 for "fill with remaining devices"

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape.keys())

    def resolve(self, n_devices: int) -> dict:
        """Resolve -1 axes against the available device count."""
        shape = dict(self.shape)
        known = 1
        fill_axis = None
        for axis, size in shape.items():
            if size == -1:
                if fill_axis is not None:
                    raise ValueError("only one mesh axis may be -1")
                fill_axis = axis
            else:
                known *= size
        if fill_axis is not None:
            if n_devices % known:
                raise ValueError(
                    f"cannot fill axis '{fill_axis}': {n_devices} devices "
                    f"not divisible by {known}")
            shape[fill_axis] = n_devices // known
            known *= shape[fill_axis]
        if known != n_devices:
            raise ValueError(
                f"mesh shape {shape} needs {known} devices, have {n_devices}")
        return shape


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device="cuda"):
    """Join the default process group (a no-op when it exists): at
    ``tcp://coordinator_address`` when given, else from torchrun's
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``; CUDA ranks take ``LOCAL_RANK``'s device), else as a
    world-size-1 group on an in-process store. The backend follows
    ``device``; a failure to initialise it raises."""
    if dist.is_initialized():
        return
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if coordinator_address or "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        kwargs = {}
        if coordinator_address:
            kwargs = {"init_method": f"tcp://{coordinator_address}",
                      "world_size": int(num_processes),
                      "rank": int(process_id)}
        dist.init_process_group(backend, timeout=PROCESS_GROUP_TIMEOUT,
                                **kwargs)
        return
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1, timeout=PROCESS_GROUP_TIMEOUT)


def make_mesh(shape: dict | None = None, device="cuda",
              axis_names: Sequence[str] | None = None,
              ranks: Sequence[int] | None = None):
    """A ``DeviceMesh`` over every rank of the default process group
    (joined first through :func:`initialize_distributed`), or over
    ``ranks`` of it, axes in ``shape``'s order, the i-th rank at the
    row-major coordinate i. ``shape=None`` puts every rank on the second
    default axis (``fsdp``); one axis may be -1 (the remaining ranks).
    Unlike the reference, a shape smaller than its ranks raises instead
    of taking a prefix: a rank outside the mesh would hold no part of the
    state. Every rank of the group calls it, members or not: it creates
    the process groups of the mesh's collectives."""
    from torch.distributed.device_mesh import DeviceMesh

    device = torch.device(device)
    # the world the group will have: a shape that does not fit raises
    # before any group is joined
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    ranks = sorted(int(r) for r in ranks) if ranks is not None \
        else list(range(world))
    n = len(ranks)
    if shape is None:
        names = tuple(axis_names or DEFAULT_AXES)
        shape = {name: 1 for name in names}
        shape[names[1] if len(names) > 1 else names[0]] = n
    resolved = MeshConfig(dict(shape)).resolve(n)
    initialize_distributed(device=device)
    layout = torch.tensor(ranks).reshape(tuple(resolved.values()))
    mesh = DeviceMesh(device.type, layout,
                      mesh_dim_names=tuple(resolved.keys()))
    _create_groups(mesh)
    return mesh


def _active(mesh, axes) -> tuple:
    return tuple(a for a in axes if mesh.size(a) > 1)


def _create_groups(mesh):
    """Create, on every rank of the group and in one order, the groups of
    :func:`axes_group` that no DeviceMesh dimension gives (every active
    axis of a mesh over part of the group; the data x fsdp plane of a
    mesh with further active axes), kept on the mesh by (axes, the
    coordinates of the other axes)."""
    import itertools

    everything = _active(mesh, range(mesh.ndim))
    groups = mesh.mlt_axis_groups = {}
    planes = [everything]
    names = mesh.mesh_dim_names
    batch = _active(mesh, [names.index(a) for a in ("data", "fsdp")
                           if a in names])
    if len(batch) > 1 and batch != everything:
        planes.append(batch)
    for axes in planes:
        if len(axes) < 2 or (axes == everything and mesh.mesh.numel()
                             == dist.get_world_size()):
            continue
        others = [a for a in range(mesh.ndim) if a not in axes]
        for fixed in itertools.product(*(range(mesh.size(a))
                                         for a in others)):
            index = [slice(None)] * mesh.ndim
            for axis, c in zip(others, fixed):
                index[axis] = c
            members = sorted(mesh.mesh[tuple(index)].flatten().tolist())
            groups[(axes, fixed)] = (dist.new_group(members), members)


def axes_group(mesh, axes) -> tuple:
    """(process group, its global ranks in group-rank order) of the ranks
    that share this rank's mesh coordinate outside ``axes`` (axis
    indices); axes of size 1 are dropped. No active axis: ``(None,
    [this rank])``, nothing to communicate. The whole mesh over every rank
    is the default group (``None``)."""
    active = _active(mesh, axes)
    if not active:
        return None, [dist.get_rank()]
    everything = _active(mesh, range(mesh.ndim))
    if active == everything and mesh.mesh.numel() == dist.get_world_size():
        return None, list(range(dist.get_world_size()))
    if len(active) == 1:
        group = mesh.get_group(active[0])
        return group, dist.get_process_group_ranks(group)
    coordinate = mesh.get_coordinate()
    fixed = tuple(coordinate[a] for a in range(mesh.ndim)
                  if a not in active)
    try:
        return mesh.mlt_axis_groups[(active, fixed)]
    except (AttributeError, KeyError):
        raise ValueError(
            f"no process group over mesh axes "
            f"{[mesh.mesh_dim_names[a] for a in active]}: build the mesh "
            "with parallel.mesh.make_mesh") from None


def mesh_group(mesh):
    """The process group over every rank of ``mesh`` (None: the default
    group)."""
    return axes_group(mesh, range(mesh.ndim))[0]


def refit_shape(shape: dict, n_devices: int,
                prefer_axis: str | None = None) -> dict:
    """Refit a resolved mesh shape onto a new device count by rescaling
    ONE axis — ``prefer_axis`` first, then declaration order. Raises
    ValueError when no single axis rescales evenly."""
    order = ([prefer_axis] if prefer_axis in shape else []) + list(shape)
    for axis in order:
        trial = dict(shape)
        trial[axis] = -1
        try:
            return MeshConfig(trial).resolve(n_devices)
        except ValueError:
            continue
    raise ValueError(
        f"cannot refit mesh shape {shape} onto {n_devices} devices: no "
        "single axis rescales evenly")


def local_mesh(n: int | None = None, axis_names: Sequence[str] = ("data",),
               device="cuda"):
    """A 1-axis mesh over the process group's ranks."""
    initialize_distributed(device=device)
    return make_mesh({axis_names[0]: n or dist.get_world_size()}, device)


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (or of a shape dict, as
    given)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_info(mesh) -> dict:
    shape = mesh_shape(mesh)
    return {
        "axis_names": list(shape),
        "shape": shape,
        "n_devices": math.prod(shape.values()),
        "devices": mesh.device_type,
    }
