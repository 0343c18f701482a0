"""Mesh axis conventions (counterpart of ``repro/parallel/mesh.py``).

Production meshes (``launch/mesh.py``):
  single-pod: (16, 16)    axes ("data", "model")
  multi-pod:  (2, 16, 16) axes ("pod", "data", "model")

A mesh is a ``DeviceMesh`` with ``mesh_dim_names``; it needs a default
process group of as many ranks. ``fake_process_group`` stands one up with no
peers for a capture (``core/capture.py`` traces rank 0's program);
``simulated_ranks`` adds ``LocalTensorMode``, under which one process runs
every rank's program and the collectives between them, on one device.
"""
from __future__ import annotations

import contextlib
import math
from collections.abc import Mapping

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS = "data"
MODEL_AXIS = "model"
POD_AXIS = "pod"

_SIMULATED = []          # the LocalTensorMode of each open simulated_ranks


def make_mesh(shape, axes, device_type=None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default process
    group, whose world size must be the product of ``shape``. The device
    type is ``cuda`` unless the caller asks for another."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a default process group "
                           "(init_process_group, or fake_process_group for a capture)")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks; the default "
                         f"process group has {dist.get_world_size()}")
    return init_device_mesh(device_type or "cuda", shape, mesh_dim_names=axes)


def mesh_shape(mesh) -> dict:
    """{axis: size} of a ``DeviceMesh``, a mapping of axis sizes, or None."""
    if mesh is None:
        return {}
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh, name: str) -> int:
    return mesh_shape(mesh).get(name, 1)


def dp_size(mesh) -> int:
    return axis_size(mesh, DATA_AXIS) * axis_size(mesh, POD_AXIS)


def model_size(mesh) -> int:
    return axis_size(mesh, MODEL_AXIS)


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A default process group of ``world_size`` ranks with no peers (the
    ``fake`` backend), this process rank 0: collectives return at once and
    move nothing. Made for captures, which trace rank 0's program;
    destroyed on exit. The default group is global to the process, so none
    may exist before."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group exists already")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def simulated_ranks(world_size: int):
    """Every rank of a world of ``world_size`` in this process: a fake
    process group and ``LocalTensorMode``, under which each tensor holds one
    value per rank, an operator runs once for each rank (a kernel launches
    ``world_size`` times) and a collective combines the ranks' values as the
    real one would. A private PyTorch API; it raises where it is missing."""
    from torch.distributed._local_tensor import LocalTensorMode
    with fake_process_group(world_size), LocalTensorMode(world_size) as mode:
        _SIMULATED.append(mode)
        try:
            yield mode
        finally:
            _SIMULATED.pop()


def rank_map(fn):
    """``fn(rank)`` for this process's rank: a tensor of each simulated
    rank's value under ``simulated_ranks``."""
    if _SIMULATED:
        return _SIMULATED[-1].rank_map(fn)
    return fn(dist.get_rank())


def coordinate(mesh: DeviceMesh, rank: int) -> list:
    """``rank``'s index along each dim of ``mesh``, whose ranks lie in
    row-major order, as ``init_device_mesh`` lays them out."""
    out = []
    for n in reversed(mesh.shape):
        rank, i = divmod(rank, n)
        out.append(i)
    return out[::-1]
