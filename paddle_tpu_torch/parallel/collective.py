"""Collective communication helpers over a mesh axis (the port's
counterpart of ``paddle_tpu.parallel.collective``; reference
``operators/nccl_op.cc``: NCCLAllReduce :94, NCCLReduce :140, NCCLBcast
:191).

The helpers take this rank's LOCAL tensor and the name of a mesh axis,
as the JAX package's take a shard inside ``shard_map``, and run over that
axis's process group through ``torch.distributed``'s functional
collectives (``torch.distributed._functional_collectives``), which a
CUDA graph can capture.  ``all_reduce`` (sum), ``all_gather``,
``reduce_scatter`` and ``all_to_all`` are differentiable, as the JAX
package's ``psum`` / ``all_gather`` / ``psum_scatter`` /
``all_to_all`` are: each backward is the transposed collective.

The eight ``c_*`` IR ops are registered by
:mod:`paddle_tpu_torch.ops.collective_ops` on these helpers.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

from paddle_tpu_torch.obs.trace import span as _span

__all__ = ["all_reduce", "all_gather", "reduce_scatter", "all_to_all",
           "broadcast", "axis_group"]


def _mesh(mesh):
    if mesh is not None:
        return mesh
    from paddle_tpu_torch.parallel.mesh import default_mesh
    return default_mesh()


def axis_group(axis_name, mesh=None):
    """The process group of ``mesh``'s axis ``axis_name`` that holds this
    rank."""
    return _mesh(mesh).get_group(axis_name)


# the differentiable gather and reduce-scatter: ``*_single_autograd``
# where torch has it, its older ``*_tensor_autograd`` name otherwise
_all_gather_autograd = getattr(funcol, "all_gather_single_autograd", None) \
    or funcol.all_gather_tensor_autograd
_reduce_scatter_autograd = getattr(
    funcol, "reduce_scatter_single_autograd", None) or \
    funcol.reduce_scatter_tensor_autograd


def _wait(t):
    return funcol.wait_tensor(t) if isinstance(
        t, funcol.AsyncCollectiveTensor) else t


class _AllReduceSum(torch.autograd.Function):
    """``psum``: its transpose is ``psum`` of the cotangent."""

    @staticmethod
    def forward(x, group):
        return _wait(funcol.all_reduce(x.contiguous(), "sum", group))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _wait(funcol.all_reduce(g.contiguous(), "sum",
                                       ctx.group)), None


def all_reduce(x, axis_name, op="sum", mesh=None):
    """Reduce ``x`` over the axis: ``sum`` (differentiable), ``max`` or
    ``min``; every member gets the result."""
    group = axis_group(axis_name, mesh)
    with _span("collective.all_reduce", axis=str(axis_name), op=op):
        if op == "sum":
            return _AllReduceSum.apply(x, group)
        if op not in ("max", "min"):
            raise ValueError(f"all_reduce: op {op!r} (sum, max, min)")
        return _wait(funcol.all_reduce(x.contiguous(), op, group))


def all_gather(x, axis_name, axis=0, tiled=True, mesh=None):
    """The members' ``x`` concatenated along ``axis`` (``tiled``), or
    stacked on a new leading ``axis`` (``tiled=False``)."""
    group = axis_group(axis_name, mesh)
    with _span("collective.all_gather", axis=str(axis_name)):
        if not tiled:
            x = x.unsqueeze(axis)
        return _wait(_all_gather_autograd(
            x.contiguous(), axis, group))


def reduce_scatter(x, axis_name, scatter_dimension=0, mesh=None):
    """The members' ``x`` summed, and this member's ``1/n`` slice of
    ``scatter_dimension`` kept (``psum_scatter(..., tiled=True)``)."""
    group = axis_group(axis_name, mesh)
    with _span("collective.reduce_scatter", axis=str(axis_name)):
        return _wait(_reduce_scatter_autograd(
            x.contiguous(), "sum", scatter_dimension, group))


def all_to_all(x, axis_name, split_axis, concat_axis, mesh=None):
    """``x`` cut into ``n`` blocks along ``split_axis``, block ``j`` sent to
    member ``j``, the received blocks concatenated along ``concat_axis``
    in member order (``lax.all_to_all(..., tiled=True)``)."""
    group = axis_group(axis_name, mesh)
    n = dist.get_world_size(group)
    with _span("collective.all_to_all", axis=str(axis_name)):
        if x.shape[split_axis] % n:
            raise ValueError(f"all_to_all: dim {split_axis} of "
                             f"{tuple(x.shape)} does not split {n} ways")
        front = x.movedim(split_axis, 0).contiguous()
        got = _wait(funcol.all_to_all_single_autograd(
            front, None, None, group))
        blocks = got.movedim(0, split_axis).chunk(n, dim=split_axis)
        return torch.cat(blocks, dim=concat_axis)


def broadcast(x, axis_name, root=0, mesh=None):
    """Member ``root``'s ``x`` on every member of the axis."""
    group = axis_group(axis_name, mesh)
    with _span("collective.broadcast", axis=str(axis_name)):
        src = dist.get_global_rank(group, int(root))
        return _wait(funcol.broadcast(x.contiguous(), src, group))
