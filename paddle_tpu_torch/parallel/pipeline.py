"""Pipeline parallelism: a GPipe-style microbatched stage pipeline over a
mesh axis (the port's counterpart of ``paddle_tpu.parallel.pipeline``).

The reference has no pipeline parallelism (its inventory is dp and
pserver); the JAX package added this primitive to complete its
parallelism set, and the port keeps it.

Design, as in the JAX package:

* P homogeneous stages live on the ``pipe`` axis of the mesh; the stage
  parameters are STACKED on a leading [P] dim, and the rank at index
  ``p`` of the axis runs stage ``p`` with row ``p``.
* The schedule runs M + P - 1 ticks.  At tick t, stage p works on
  microbatch t - p (a bubble otherwise); its output hops p -> p+1
  (``batch_isend_irecv``, where the JAX package has ``ppermute``).
  Stage 0 ingests the microbatches, the last stage banks its outputs,
  and a sum over the axis (``collective.all_reduce``) gives every rank
  the same outputs.

Where the port differs in form:

* One process a stage: a rank runs only its own stage.  Every rank runs
  the same ticks and the same hops, so the point-to-point calls pair up.
  A bubble tick runs no stage: the rank knows on the host that the tick
  is idle and sends a zero carrier (the JAX package computes the stage
  on a masked input and zeroes its output, since every device traces
  the same program).
* Send and recv have no autograd, so the whole schedule is one
  :class:`torch.autograd.Function` (as ``RingAttentionFunction``): the
  forward keeps each tick's autograd graph, and the backward runs the
  reverse schedule explicitly, tick by tick in reverse order, the
  cotangents hopping p+1 -> p.  The parameter grads come back whole on
  every rank (each rank's row, summed over the axis), as the JAX
  package's ``jax.grad`` of a stacked array gives the whole array.
* The outputs are one value, the same on every rank: the backward takes
  each rank's cotangent of them as that value's (it is not summed over
  the ranks), as DTensor's ``full_tensor`` does.
* At an axis of size 1 there is nothing to send and nothing to sum, and
  no collective runs.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from paddle_tpu_torch.parallel.collective import _AllReduceSum

__all__ = ["gpipe", "stack_stage_params", "hop", "axis_ring", "axis_size"]


def stack_stage_params(per_stage_params):
    """``[{name: tensor}, ...]`` a stage -> ``{name: [P, ...] stacked}``."""
    keys = per_stage_params[0].keys()
    for p in per_stage_params[1:]:
        if p.keys() != keys:
            raise ValueError("pipeline stages must be homogeneous "
                             "(same parameter names/shapes)")
        for k in keys:
            if tuple(p[k].shape) != tuple(per_stage_params[0][k].shape):
                raise ValueError(
                    f"pipeline stages must be homogeneous: param {k!r} "
                    f"has shape {tuple(p[k].shape)} vs "
                    f"{tuple(per_stage_params[0][k].shape)}")
    return {k: torch.stack([torch.as_tensor(p[k]) for p in per_stage_params])
            for k in keys}


def axis_size(mesh, axis):
    """The number of ranks on ``mesh``'s ``axis``."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    if axis not in sizes:
        raise ValueError(f"mesh has no axis {axis!r} "
                         f"(axes: {list(mesh.mesh_dim_names)})")
    return int(sizes[axis])


def axis_ring(mesh, axis):
    """``(group, index, size)`` of this rank on ``mesh``'s ``axis``; the
    group is None at size 1 (nothing to send or sum)."""
    size = axis_size(mesh, axis)
    if size == 1:
        return None, 0, 1
    return mesh.get_group(axis), int(mesh.get_local_rank(axis)), size


def hop(tensors, group, send_to=None, recv_from=None):
    """Send ``tensors`` to index ``send_to`` of the axis ``group`` and
    receive their like from index ``recv_from`` (either may be None):
    the received tensors, or None where nothing is received."""
    ops, bufs = [], None
    if send_to is not None:
        dst = dist.get_global_rank(group, send_to)
        ops += [dist.P2POp(dist.isend, t.contiguous(), dst, group)
                for t in tensors]
    if recv_from is not None:
        src = dist.get_global_rank(group, recv_from)
        bufs = [torch.empty_like(t) for t in tensors]
        ops += [dist.P2POp(dist.irecv, b, src, group) for b in bufs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return bufs


def _all_reduce(t, group):
    """The sum of ``t`` over ``group``'s ranks (``t`` at no group)."""
    return t if group is None else _AllReduceSum.apply(t, group)


def _grads(outputs, inputs, cotangents):
    """``torch.autograd.grad`` of the tensors of ``outputs`` that carry a
    graph, zeros where an input took no part."""
    pairs = [(o, c) for o, c in zip(outputs, cotangents)
             if o.requires_grad]
    wanted = [i for i in inputs if i.requires_grad]
    got = torch.autograd.grad([o for o, _ in pairs], wanted,
                              [c for _, c in pairs],
                              allow_unused=True) if pairs and wanted else \
        [None] * len(wanted)
    it = iter(got)
    out = []
    for i in inputs:
        g = next(it) if i.requires_grad else None
        out.append(torch.zeros_like(i) if g is None else g)
    return out


class _GPipeFunction(torch.autograd.Function):
    """The GPipe schedule: ``(stacked param leaves..., xs) -> outputs``."""

    @staticmethod
    def forward(ctx, stage_fn, spec, group, stage, p_size, xs, *leaves):
        m = xs.shape[0]
        params = [leaf[stage].detach().requires_grad_(
            leaf.is_floating_point()) for leaf in leaves]
        tree = pytree.tree_unflatten(params, spec)
        received = torch.zeros_like(xs[0])
        outputs = torch.zeros_like(xs)
        ticks = {}
        n_ticks = m + p_size - 1
        for t in range(n_ticks):
            mb = t - stage
            sent = torch.zeros_like(received)
            if 0 <= mb < m:
                inp = (xs[t] if stage == 0 else received).detach()
                inp.requires_grad_(inp.is_floating_point())
                with torch.enable_grad():
                    out = stage_fn(tree, inp)
                ticks[t] = (inp, out)
                sent = out.detach()
                if stage == p_size - 1:
                    outputs[mb] = sent
            if group is not None and t < n_ticks - 1:
                got = hop([sent], group,
                          stage + 1 if stage < p_size - 1 else None,
                          stage - 1 if stage > 0 else None)
                if got is not None:
                    received = got[0]
        ctx.meta = (group, stage, p_size, m, n_ticks,
                    ctx.needs_input_grad[5])
        ctx.ticks, ctx.params = ticks, params
        ctx.leaf_shapes = [leaf.shape for leaf in leaves]
        return _all_reduce(outputs, group)

    @staticmethod
    def backward(ctx, g_out):
        group, stage, p_size, m, n_ticks, want_xs = ctx.meta
        params = ctx.params
        acc = [torch.zeros_like(p) for p in params]
        dxs = torch.zeros_like(g_out) if want_xs else None
        recv = None
        for t in reversed(range(n_ticks)):
            sent = torch.zeros_like(g_out[0])
            if t in ctx.ticks:
                inp, out = ctx.ticks.pop(t)
                cot = g_out[t - stage] if stage == p_size - 1 else recv
                gin, *gp = _grads([out], [inp] + params, [cot])
                acc = [a + g for a, g in zip(acc, gp)]
                sent = gin
                if stage == 0 and dxs is not None:
                    dxs[t] = gin
            if group is not None and t > 0:
                got = hop([sent], group,
                          stage - 1 if stage > 0 else None,
                          stage + 1 if stage < p_size - 1 else None)
                if got is not None:
                    recv = got[0]
        grads = []
        for a, p, shape in zip(acc, params, ctx.leaf_shapes):
            if not p.requires_grad:
                grads.append(None)
                continue
            full = a.new_zeros(shape)
            full[stage] = a
            grads.append(_all_reduce(full, group))
        if dxs is not None:
            dxs = _all_reduce(dxs, group)
        return (None, None, None, None, None, dxs, *grads)


def gpipe(stage_fn, stacked_params, microbatches, mesh, axis="pipe"):
    """Run ``microbatches`` [M, mb, ...] through P pipelined stages.

    ``stage_fn(params, x) -> y`` is one stage's computation (same shape
    in and out); ``stacked_params`` is a pytree whose leaves have a
    leading [P] stage dim, whole on every rank.  Returns the [M, mb, ...]
    outputs of the last stage, the same on every rank.  Differentiable
    with respect to ``stacked_params`` and ``microbatches``: the grads
    of the leaves come back whole on every rank.

    The microbatches are whole on every rank; stage 0 reads them (the
    pipeline transpiler feeds stage 0 only, rotating blocks of them
    toward it).
    """
    p_size = axis_size(mesh, axis)
    leaves, spec = pytree.tree_flatten(stacked_params)
    leading = {int(leaf.shape[0]) for leaf in leaves}
    if leading != {p_size}:
        raise ValueError(
            f"gpipe: stacked stage params have leading dim(s) "
            f"{sorted(leading)} but the {axis!r} mesh axis has {p_size} "
            f"ranks — one stage per rank")
    group, stage, p_size = axis_ring(mesh, axis)
    return _GPipeFunction.apply(stage_fn, spec, group, stage, p_size,
                                microbatches, *leaves)
