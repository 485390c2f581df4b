"""Mesh construction (counterpart of ``repro/launch/mesh.py``).

The production meshes the dry run costs programs on:

- single pod: 256 devices as (data=16, model=16);
- multi-pod: 2 pods x 256 devices as (pod=2, data=16, model=16).

They are the reference's TPU v5e slices. On H100s they stand for 16 or
32 nodes of 16 cards each; the dry run takes the H100's peaks for every
device (``roofline/analysis.py``).

:func:`make_production_mesh` and :func:`make_host_mesh` return the port's
:class:`~repro_torch.dist.sharding.Mesh` (axis names and sizes), which
the placement rules read. :func:`fake_world` brings up a world of any
size inside this one process on PyTorch's fake process group, whose
collectives take tensors (meta tensors included) and move nothing, and
:func:`device_mesh` lays a ``DeviceMesh`` over it: the dry run's DTensors
live on that mesh. Nothing here touches CUDA.
"""
from __future__ import annotations

import contextlib
from math import prod

import torch.distributed as dist

from repro_torch.dist.sharding import MODEL_AXIS, Mesh, dp_axes_of


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(num_devices: int | None = None, axes=("data",)) -> Mesh:
    """A small mesh for tests and examples (paper scale: 8 workers); two
    axes split ``num_devices`` (default 1) about evenly."""
    n = num_devices or 1
    if len(axes) == 1:
        return Mesh(tuple(axes), (n,))
    a = int(n ** 0.5)
    while n % a:
        a -= 1
    return Mesh(tuple(axes), (n // a, a))


def mesh_label(mesh: Mesh) -> str:
    """``16x16``, ``2x16x16``, ``data=2`` for a one-axis mesh."""
    if len(mesh.sizes) == 1:
        return f"{mesh.axis_names[0]}={mesh.sizes[0]}"
    return "x".join(str(s) for s in mesh.sizes)


def _create_fake_pg(common_opts, backend_opts):
    from torch._C._distributed_c10d import FakeProcessGroup
    return FakeProcessGroup._create_internal(
        common_opts.group_rank, common_opts.group_size, backend_opts)


def _register_fake_backend() -> None:
    if "FAKE" not in getattr(dist.Backend, "_plugins", {}):
        dist.Backend.register_backend(dist.Backend.FAKE, _create_fake_pg,
                                      extended_api=True,
                                      devices=["cpu", "cuda"])


@contextlib.contextmanager
def fake_world(size: int):
    """A default process group of ``size`` ranks, this process rank 0, on
    the fake backend (every collective returns at once and moves nothing);
    destroyed on exit. Refuses to replace a group already initialised."""
    if dist.is_initialized():
        raise RuntimeError("fake_world needs a process with no process "
                           "group initialised")
    _register_fake_backend()
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def device_mesh(mesh: Mesh):
    """A ``DeviceMesh`` of ``mesh``'s axes over the initialised world
    (whose size is the mesh's), on the CPU device type: its groups are
    the fake backend's, and no card is touched."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(mesh.sizes),
                            mesh_dim_names=tuple(mesh.axis_names))


def data_group(mesh: Mesh):
    """The process group of rank 0's data-parallel peers: every rank
    whose ``model`` coordinate is 0, over all data axes (``pod`` x
    ``data``) in rank order; None on a mesh of one data rank."""
    if prod(mesh.shape[a] for a in dp_axes_of(mesh)) == 1:
        return None
    tp = mesh.shape.get(MODEL_AXIS, 1)
    ranks = list(range(0, prod(mesh.sizes), tp))
    if MODEL_AXIS in mesh.axis_names and \
            mesh.axis_names[-1] != MODEL_AXIS:
        raise ValueError("the model axis must be the mesh's last")
    return dist.new_group(ranks)
