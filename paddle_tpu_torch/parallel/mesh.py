"""Device meshes over the ranks of a ``torch.distributed`` world (the
port's counterpart of ``paddle_tpu.parallel.mesh``, which builds a
``jax.sharding.Mesh``; reference ``platform/nccl_helper.h``
NCCLContextMap: device discovery and communicator setup).

A mesh here is a :class:`torch.distributed.device_mesh.DeviceMesh`
whose entries are ranks, one device each (``cuda:<local rank>`` under
NCCL, the CPU under gloo), with named axes.  ``init_parallel_env``
(:mod:`paddle_tpu_torch.parallel.distributed`) forms the world first;
a mesh needs one.

:class:`P` stands for ``jax.sharding.PartitionSpec``: a tuple of one
entry per tensor dim, each a mesh axis name, a tuple of axis names (the
dim split over their product, major axis first, in mesh order) or None
(not split).  :func:`placements` maps it to DTensor placements, one per
mesh axis: ``Shard(dim)`` where the axis splits ``dim``, else
``Replicate()``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

__all__ = ["make_mesh", "default_mesh", "set_default_mesh", "device_count",
           "P", "placements", "axis_sizes", "spec_fits", "mesh_size",
           "DATA_AXIS", "MODEL_AXIS", "PIPE_AXIS", "SEQ_AXIS"]

_default_mesh = None

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"
SEQ_AXIS = "seq"


class P(tuple):
    """A partition spec: ``P("data", None)`` splits dim 0 over the
    ``data`` axis and keeps dim 1 whole; ``P()`` is replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"



def device_count():
    """The world size (the JAX package's ``jax.device_count()``: one
    device a rank); 1 before ``init_parallel_env``."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _device_type():
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: no process group: call "
            "paddle_tpu_torch.parallel.init_parallel_env() first")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(mesh_shape=None, axis_names=None, devices=None):
    """A :class:`DeviceMesh` over ``devices`` (ranks; default: every rank
    of the world), reshaped to ``mesh_shape`` with ``axis_names``.
    Default: all ranks on one ``data`` axis.  Every rank of the world
    must call it (each axis gets its own process group)."""
    device_type = _device_type()
    ranks = list(devices) if devices is not None else \
        list(range(dist.get_world_size()))
    if mesh_shape is None:
        mesh_shape = (len(ranks),)
        axis_names = axis_names or (DATA_AXIS,)
    mesh_shape = tuple(int(d) for d in mesh_shape)
    axis_names = tuple(axis_names or (
        f"axis{i}" for i in range(len(mesh_shape))))
    n = int(np.prod(mesh_shape))
    if n > len(ranks):
        raise ValueError(f"make_mesh: a {mesh_shape} mesh needs {n} ranks, "
                         f"the world has {len(ranks)}")
    grid = torch.tensor(ranks[:n], dtype=torch.int64).reshape(mesh_shape)
    return DeviceMesh(device_type, grid, mesh_dim_names=axis_names)


def default_mesh():
    global _default_mesh
    if _default_mesh is None:
        _default_mesh = make_mesh()
    return _default_mesh


def set_default_mesh(mesh):
    global _default_mesh
    _default_mesh = mesh
    return mesh


def axis_sizes(mesh):
    """``{axis name: size}`` of ``mesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_size(mesh):
    return int(np.prod(mesh.shape))


def _axes_of(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(spec, mesh):
    """The DTensor placements of partition spec ``spec`` on ``mesh``: one
    per mesh axis.  Raises for an axis the mesh lacks, an axis named on
    two dims, or a tuple of axes out of mesh order."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(tuple(spec or ())):
        axes = _axes_of(entry)
        idx = []
        for ax in axes:
            if ax not in names:
                raise ValueError(f"partition spec {spec!r}: mesh has no "
                                 f"axis {ax!r} (axes {tuple(names)})")
            i = names.index(ax)
            if out[i] != Replicate():
                raise ValueError(f"partition spec {spec!r}: axis {ax!r} "
                                 f"splits two dims")
            out[i] = Shard(dim)
            idx.append(i)
        if idx != sorted(idx):
            raise ValueError(f"partition spec {spec!r}: the axes of dim "
                             f"{dim} must be in mesh order {tuple(names)}")
    return out


def spec_fits(spec, shape, mesh):
    """True when every split dim of ``shape`` divides evenly by the
    product of its axes' sizes (the JAX package's ``_spec_fits``)."""
    sizes = axis_sizes(mesh)
    spec = tuple(spec or ())
    if len(spec) > len(shape):
        return False
    for dim, entry in zip(shape, spec):
        axes = _axes_of(entry)
        if not axes:
            continue
        k = 1
        for a in axes:
            k *= sizes.get(a, 1)
        if dim is None or dim < 0 or dim % k:
            return False
    return True
