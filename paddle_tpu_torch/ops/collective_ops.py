"""The eight ``c_*`` collective IR ops (the JAX package registers them in
``paddle_tpu/parallel/collective.py:83-131``), lowered on the helpers of
:mod:`paddle_tpu_torch.parallel.collective`.

The JAX package's rule: outside an axis context an op is the identity
(one logical device: the whole mesh, partitioned underneath); an
explicit ``axis`` attribute, or the run's ``aux["spmd_axis"]``, pins it
to a mesh axis, and it then acts on this rank's LOCAL value over that
axis's group, as ``lax.psum`` acts on a shard inside ``shard_map``.  A
pinned op needs the run's mesh (``aux["mesh"]``, which
``ParallelExecutor`` sets) and raises without one.  ``c_allreduce_prod``
keeps the reference's ``exp(psum(log x))``, so a non-positive input
gives NaN or 0 as the JAX package's does.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.registry import (ShapeInferenceSkip,
                                           infer_shape_unary, register_op)

__all__ = ["COLLECTIVE_OPS"]


def _axis(ctx):
    return ctx.attr("axis", None) or ctx.aux.get("spmd_axis")


def _local(ctx, x, ax):
    """This rank's local value of ``x`` and the run's mesh."""
    mesh = ctx.aux.get("mesh")
    if mesh is None:
        raise RuntimeError(
            f"{ctx.op.type}: pinned to mesh axis {ax!r} but the run has "
            f"no mesh (run the program through ParallelExecutor)")
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        x = x.to_local()
    return x, mesh


def _make_allreduce(op_name, reduce):
    @register_op(op_name, infer_shape=infer_shape_unary())
    def lower(ctx):
        x = ctx.input("X")
        ax = _axis(ctx)
        if ax is None:
            ctx.set_output("Out", x)
            return
        x, mesh = _local(ctx, x, ax)
        ctx.set_output("Out", reduce(x, ax, mesh))
    return lower


def _collective():
    from paddle_tpu_torch.parallel import collective
    return collective


_make_allreduce("c_allreduce_sum",
                lambda x, ax, m: _collective().all_reduce(x, ax, "sum", m))
_make_allreduce("c_allreduce_max",
                lambda x, ax, m: _collective().all_reduce(x, ax, "max", m))
_make_allreduce("c_allreduce_min",
                lambda x, ax, m: _collective().all_reduce(x, ax, "min", m))
_make_allreduce("c_allreduce_prod",
                lambda x, ax, m: torch.exp(_collective().all_reduce(
                    torch.log(x), ax, "sum", m)))


@register_op("c_broadcast", infer_shape=infer_shape_unary())
def c_broadcast_lower(ctx):
    x = ctx.input("X")
    ax = _axis(ctx)
    if ax is None:
        ctx.set_output("Out", x)
        return
    x, mesh = _local(ctx, x, ax)
    ctx.set_output("Out", _collective().broadcast(
        x, ax, ctx.attr("root", 0), mesh))


def _infer_skip(op, block):
    raise ShapeInferenceSkip()


@register_op("c_allgather", infer_shape=_infer_skip)
def c_allgather_lower(ctx):
    x = ctx.input("X")
    ax = _axis(ctx)
    if ax is None:
        ctx.set_output("Out", x)
        return
    x, mesh = _local(ctx, x, ax)
    ctx.set_output("Out", _collective().all_gather(x, ax, 0, True, mesh))


@register_op("c_reducescatter", infer_shape=_infer_skip)
def c_reducescatter_lower(ctx):
    x = ctx.input("X")
    ax = _axis(ctx)
    if ax is None:
        ctx.set_output("Out", x)
        return
    x, mesh = _local(ctx, x, ax)
    ctx.set_output("Out", _collective().reduce_scatter(x, ax, 0, mesh))


@register_op("c_alltoall", infer_shape=_infer_skip)
def c_alltoall_lower(ctx):
    x = ctx.input("X")
    ax = _axis(ctx)
    if ax is None:
        ctx.set_output("Out", x)
        return
    x, mesh = _local(ctx, x, ax)
    ctx.set_output("Out", _collective().all_to_all(x, ax, 0, 0, mesh))


COLLECTIVE_OPS = frozenset({
    "c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
    "c_allreduce_prod", "c_broadcast", "c_allgather", "c_reducescatter",
    "c_alltoall"})
