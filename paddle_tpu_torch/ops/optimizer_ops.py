"""Optimizer update ops (the port of ``paddle_tpu.ops.optimizer_ops``;
reference ``paddle/fluid/operators/{sgd,momentum,adam,adamax,adagrad,
adadelta,decayed_adagrad,rmsprop,ftrl,proximal_gd,proximal_adagrad}_op``
and ``average_accumulates_op``).

Each op consumes Param/Grad/state and emits ParamOut/state-out bound to
the SAME variable names, so the executor's persistable write-back gives
in-place update semantics.  As in the JAX package, the adam and adamax
ops emit Beta1PowOut/Beta2PowOut themselves (the reference appends
separate ``scale`` ops for them), and every op follows that package's
arithmetic step by step.

``sgd``, ``adam`` and ``adagrad`` also take a SelectedRows grad (a
sparse embedding's, ``selected_rows.py``; every other op and slot reads
it densified, ``registry.LowerContext``).  Their sparse branches touch
only the grad's rows, and update the state IN PLACE (``index_add_`` /
``index_copy_`` on the tensor bound to the output's name, which is the
input's): the JAX package's functional ``p.at[rows].set(...)`` would be
a copy of the whole table each step here, which defeats O(batch·dim).
Every slot of the grad takes part, its static count kept: a dead slot
adds a zero at a clamped row (``sgd``) or rewrites a live slot's row with
that slot's own new value (``adam``, ``adagrad``), so nothing is read on
the host and a step may be captured in a CUDA graph.  Under a sentinel
(``aux["undo"]`` a list) each in-place write first notes the rows it is
about to change with their old values, which the executor puts back
when the step's check trips, so a skipped step leaves the scope as it
was, as the JAX package's functional update does.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.convert import is_dtensor
from paddle_tpu_torch.ops.registry import register_op
from paddle_tpu_torch.selected_rows import (gate_dead_slots,
                                            is_selected_rows,
                                            redirect_dead_slots)


def _infer_param_out(op, block):
    for in_slot, out_slot in (("Param", "ParamOut"), ("Moment", "MomentOut"),
                              ("Moment1", "Moment1Out"),
                              ("Moment2", "Moment2Out"),
                              ("Velocity", "VelocityOut"),
                              ("InfNorm", "InfNormOut"),
                              ("AvgSquaredGrad", "AvgSquaredGradOut"),
                              ("AvgSquaredUpdate", "AvgSquaredUpdateOut"),
                              ("MeanSquare", "MeanSquareOut"),
                              ("SquaredAccumulator", "SquaredAccumOut"),
                              ("LinearAccumulator", "LinearAccumOut"),
                              ("Beta1Pow", "Beta1PowOut"),
                              ("Beta2Pow", "Beta2PowOut")):
        ins, outs = op.input(in_slot), op.output(out_slot)
        if ins and outs:
            try:
                iv = block.var(ins[0])
                ov = block.var(outs[0])
                ov.shape = iv.shape
                ov.dtype = iv.dtype
            except KeyError:
                pass


def _target(ctx, in_slot, out_slot, t):
    """The tensor a sparse branch updates in place for ``out_slot``:
    ``t`` (the ``in_slot`` input, or this rank's block of it) itself when
    both slots name one variable (as every optimizer binds them), else a
    copy of it."""
    if ctx.op.output(out_slot)[0] != ctx.op.input(in_slot)[0]:
        t = t.clone()
    return t


def _rows_in_place(ctx, target, source, rows, old):
    """``target.<index write>_(0, rows, ...)`` is about to run: under a
    guarded step note ``(target, rows, old)`` (``old`` the rows' values
    before the write) so that a tripped check can put them back; only a
    write into the input ``source`` itself (not its copy) needs it."""
    undo = ctx.aux.get("undo")
    if undo is not None and target is source:
        undo.append((target, rows, old))
    return target


def _row_blocks(g, *tables):
    """``(g, tables, wrap, local)`` of a sparse update: for a table on a
    mesh, split by rows over an axis or replicated (and its row-shaped
    state, placed alike), the grad over this rank's block and the local
    blocks, which the update writes, with ``wrap(block, like)`` giving
    the DTensor back (``embedding.sharded_table.row_blocks``) and
    ``local(x)`` a replicated value's local tensor (the learning rate,
    the beta powers); else everything as it is."""
    if not is_dtensor(tables[0]):
        return g, tables, lambda t, like: t, lambda x: x
    from paddle_tpu_torch.embedding import sharded_table
    return sharded_table.row_blocks(g, *tables) + (sharded_table.whole,)


def _lr(ctx, dtype=None):
    lr = ctx.input("LearningRate").reshape(())
    return lr if dtype is None else lr.to(dtype)


@register_op("sgd", infer_shape=_infer_param_out, no_gradient=True,
             stateful_outputs=("ParamOut",), selected_rows_inputs=("Grad",))
def sgd_lower(ctx):
    p, g = ctx.input("Param"), ctx.input("Grad")
    if is_selected_rows(g):
        # reference sgd_op.h's SelectedRows kernel: scatter-add at the
        # grad's rows, duplicates included
        g, (pb,), wrap, local = _row_blocks(g, p)
        rows, value = g.clamped()
        t = _target(ctx, "Param", "ParamOut", pb)
        if ctx.aux.get("undo") is not None:
            _rows_in_place(ctx, t, pb, rows, t.index_select(0, rows))
        ctx.set_output("ParamOut", wrap(t.index_add_(
            0, rows, (-local(_lr(ctx, t.dtype)) * value).to(t.dtype)), p))
        return
    ctx.set_output("ParamOut", p - _lr(ctx, p.dtype) * g)


@register_op("momentum", infer_shape=_infer_param_out, no_gradient=True,
             stateful_outputs=("ParamOut", "VelocityOut"))
def momentum_lower(ctx):
    p, g = ctx.input("Param"), ctx.input("Grad")
    v = ctx.input("Velocity")
    mu = ctx.attr("mu")
    lr = _lr(ctx, p.dtype)
    v_new = mu * v + g
    if ctx.attr("use_nesterov", False):
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    ctx.set_output("ParamOut", p_new)
    ctx.set_output("VelocityOut", v_new)


@register_op("adam", infer_shape=_infer_param_out, no_gradient=True,
             stateful_outputs=("ParamOut", "Moment1Out", "Moment2Out",
                               "Beta1PowOut", "Beta2PowOut"),
             selected_rows_inputs=("Grad",))
def adam_lower(ctx):
    """Bias-corrected Adam with the JAX package's arithmetic:
    ``lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t)``,
    ``p -= lr_t * m1 / (sqrt(m2) + eps)``.  A SelectedRows grad updates
    lazily (reference ``adam_op.h`` SparseAdamFunctor): its rows merged,
    only their moments and parameters change; the beta powers advance
    once a step all the same."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    m1, m2 = ctx.input("Moment1"), ctx.input("Moment2")
    b1p = ctx.input("Beta1Pow").reshape(())
    b2p = ctx.input("Beta2Pow").reshape(())
    lr = _lr(ctx, torch.float32)
    beta1 = ctx.attr("beta1", 0.9)
    beta2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    lr_t = lr * torch.sqrt(1.0 - b2p) / (1.0 - b1p)
    ctx.set_output("Beta1PowOut", (b1p * beta1).reshape(1))
    ctx.set_output("Beta2PowOut", (b2p * beta2).reshape(1))
    if is_selected_rows(g):
        g, (pb, m1b, m2b), wrap, local = _row_blocks(g, p, m1, m2)
        lr_t = local(lr_t)
        g = g.merge_duplicates()
        live, rows, first = redirect_dead_slots(g.rows, g.height)
        gv = g.value
        m1_old, m2_old = m1b.index_select(0, rows), m2b.index_select(0, rows)
        m1_rows = beta1 * m1_old + (1.0 - beta1) * gv
        m2_rows = beta2 * m2_old + (1.0 - beta2) * torch.square(gv)
        t = _target(ctx, "Param", "ParamOut", pb)
        p_old = t.index_select(0, rows)
        p_rows = p_old - (lr_t * m1_rows /
                          (torch.sqrt(m2_rows) + eps)).to(t.dtype)
        ctx.set_output("ParamOut", wrap(_rows_in_place(
            ctx, t, pb, rows, p_old).index_copy_(
                0, rows, gate_dead_slots(live, first, p_rows, p_old)), p))
        ctx.set_output("Moment1Out", wrap(_rows_in_place(
            ctx, _target(ctx, "Moment1", "Moment1Out", m1b), m1b, rows,
            m1_old).index_copy_(
                0, rows, gate_dead_slots(live, first, m1_rows, m1_old)), m1))
        ctx.set_output("Moment2Out", wrap(_rows_in_place(
            ctx, _target(ctx, "Moment2", "Moment2Out", m2b), m2b, rows,
            m2_old).index_copy_(
                0, rows, gate_dead_slots(live, first, m2_rows, m2_old)), m2))
        return
    m1n = beta1 * m1 + (1.0 - beta1) * g
    m2n = beta2 * m2 + (1.0 - beta2) * torch.square(g)
    p_new = p - (lr_t * m1n / (torch.sqrt(m2n) + eps)).to(p.dtype)
    ctx.set_output("ParamOut", p_new)
    ctx.set_output("Moment1Out", m1n)
    ctx.set_output("Moment2Out", m2n)


@register_op("adamax", infer_shape=_infer_param_out, no_gradient=True,
             stateful_outputs=("ParamOut", "MomentOut", "InfNormOut",
                               "Beta1PowOut"))
def adamax_lower(ctx):
    p, g = ctx.input("Param"), ctx.input("Grad")
    m = ctx.input("Moment")
    inf_norm = ctx.input("InfNorm")
    b1p = ctx.input("Beta1Pow").reshape(())
    lr = _lr(ctx)
    beta1 = ctx.attr("beta1", 0.9)
    beta2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    m_new = beta1 * m + (1.0 - beta1) * g
    inf_new = torch.maximum(beta2 * inf_norm, torch.abs(g) + eps)
    lr_t = lr / (1.0 - b1p)
    ctx.set_output("ParamOut", p - lr_t * m_new / inf_new)
    ctx.set_output("MomentOut", m_new)
    ctx.set_output("InfNormOut", inf_new)
    ctx.set_output("Beta1PowOut", (b1p * beta1).reshape(1))


@register_op("adagrad", infer_shape=_infer_param_out, no_gradient=True,
             stateful_outputs=("ParamOut", "MomentOut"),
             selected_rows_inputs=("Grad",))
def adagrad_lower(ctx):
    """A SelectedRows grad is merged first, then only its rows' moment
    and parameter change (reference ``adagrad_op.h``'s sparse kernel)."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    m = ctx.input("Moment")
    eps = ctx.attr("epsilon", 1e-6)
    if is_selected_rows(g):
        g, (pb, mb), wrap, local = _row_blocks(g, p, m)
        g = g.merge_duplicates()
        live, rows, first = redirect_dead_slots(g.rows, g.height)
        gv = g.value
        m_old = mb.index_select(0, rows)
        m_rows = m_old + torch.square(gv)
        t = _target(ctx, "Param", "ParamOut", pb)
        p_old = t.index_select(0, rows)
        p_rows = (p_old - local(_lr(ctx)) * gv /
                  (torch.sqrt(m_rows) + eps)).to(t.dtype)
        ctx.set_output("MomentOut", wrap(_rows_in_place(
            ctx, _target(ctx, "Moment", "MomentOut", mb), mb, rows,
            m_old).index_copy_(
                0, rows, gate_dead_slots(live, first, m_rows, m_old)), m))
        ctx.set_output("ParamOut", wrap(_rows_in_place(
            ctx, t, pb, rows, p_old).index_copy_(
                0, rows, gate_dead_slots(live, first, p_rows, p_old)), p))
        return
    m_new = m + torch.square(g)
    ctx.set_output("ParamOut", p - _lr(ctx) * g / (torch.sqrt(m_new) + eps))
    ctx.set_output("MomentOut", m_new)


@register_op("decayed_adagrad", infer_shape=_infer_param_out,
             no_gradient=True, stateful_outputs=("ParamOut", "MomentOut"))
def decayed_adagrad_lower(ctx):
    p, g = ctx.input("Param"), ctx.input("Grad")
    m = ctx.input("Moment")
    decay = ctx.attr("decay", 0.95)
    eps = ctx.attr("epsilon", 1e-6)
    m_new = decay * m + (1.0 - decay) * torch.square(g)
    ctx.set_output("ParamOut", p - _lr(ctx) * g / (torch.sqrt(m_new) + eps))
    ctx.set_output("MomentOut", m_new)


@register_op("adadelta", infer_shape=_infer_param_out, no_gradient=True,
             stateful_outputs=("ParamOut", "AvgSquaredGradOut",
                               "AvgSquaredUpdateOut"))
def adadelta_lower(ctx):
    p, g = ctx.input("Param"), ctx.input("Grad")
    asg = ctx.input("AvgSquaredGrad")
    asu = ctx.input("AvgSquaredUpdate")
    rho = ctx.attr("rho", 0.95)
    eps = ctx.attr("epsilon", 1e-6)
    asg_new = rho * asg + (1.0 - rho) * torch.square(g)
    update = -torch.sqrt((asu + eps) / (asg_new + eps)) * g
    asu_new = rho * asu + (1.0 - rho) * torch.square(update)
    ctx.set_output("ParamOut", p + update)
    ctx.set_output("AvgSquaredGradOut", asg_new)
    ctx.set_output("AvgSquaredUpdateOut", asu_new)


@register_op("rmsprop", infer_shape=_infer_param_out, no_gradient=True,
             stateful_outputs=("ParamOut", "MomentOut", "MeanSquareOut"))
def rmsprop_lower(ctx):
    p, g = ctx.input("Param"), ctx.input("Grad")
    m = ctx.input("Moment")
    ms = ctx.input("MeanSquare")
    rho = ctx.attr("decay", 0.9)
    eps = ctx.attr("epsilon", 1e-10)
    momentum = ctx.attr("momentum", 0.0)
    ms_new = rho * ms + (1.0 - rho) * torch.square(g)
    m_new = momentum * m + _lr(ctx) * g / torch.sqrt(ms_new + eps)
    ctx.set_output("ParamOut", p - m_new)
    ctx.set_output("MomentOut", m_new)
    ctx.set_output("MeanSquareOut", ms_new)


@register_op("ftrl", infer_shape=_infer_param_out, no_gradient=True,
             stateful_outputs=("ParamOut", "SquaredAccumOut",
                               "LinearAccumOut"))
def ftrl_lower(ctx):
    p, g = ctx.input("Param"), ctx.input("Grad")
    sq = ctx.input("SquaredAccumulator")
    lin = ctx.input("LinearAccumulator")
    lr = _lr(ctx)
    l1 = ctx.attr("l1", 0.0)
    l2 = ctx.attr("l2", 0.0)
    lr_power = ctx.attr("lr_power", -0.5)
    sq_new = sq + torch.square(g)
    sigma = (torch.pow(sq_new, -lr_power) - torch.pow(sq, -lr_power)) / lr
    lin_new = lin + g - sigma * p
    pre = torch.where(torch.abs(lin_new) > l1,
                      (torch.sign(lin_new) * l1 - lin_new) /
                      (torch.pow(sq_new, -lr_power) / lr + 2.0 * l2),
                      torch.zeros_like(p))
    ctx.set_output("ParamOut", pre)
    ctx.set_output("SquaredAccumOut", sq_new)
    ctx.set_output("LinearAccumOut", lin_new)


def _soft_threshold(prox, lr, l1, l2):
    """``sign(prox) * max(|prox| - lr * l1, 0) / (1 + lr * l2)``."""
    return torch.sign(prox) * torch.clamp(torch.abs(prox) - lr * l1,
                                          min=0.0) / (1.0 + lr * l2)


@register_op("proximal_gd", infer_shape=_infer_param_out, no_gradient=True,
             stateful_outputs=("ParamOut",))
def proximal_gd_lower(ctx):
    p, g = ctx.input("Param"), ctx.input("Grad")
    lr = _lr(ctx)
    ctx.set_output("ParamOut", _soft_threshold(
        p - lr * g, lr, ctx.attr("l1", 0.0), ctx.attr("l2", 0.0)))


@register_op("proximal_adagrad", infer_shape=_infer_param_out,
             no_gradient=True, stateful_outputs=("ParamOut", "MomentOut"))
def proximal_adagrad_lower(ctx):
    p, g = ctx.input("Param"), ctx.input("Grad")
    m_new = ctx.input("Moment") + torch.square(g)
    lr_t = _lr(ctx) / torch.sqrt(m_new)
    ctx.set_output("ParamOut", _soft_threshold(
        p - lr_t * g, lr_t, ctx.attr("l1", 0.0), ctx.attr("l2", 0.0)))
    ctx.set_output("MomentOut", m_new)


@register_op("average_accumulates", infer_shape=_infer_param_out,
             no_gradient=True, stateful_outputs=("SumOut", "CountOut"))
def average_accumulates_lower(ctx):
    """ModelAverage's accumulator, as the JAX package has it: one running
    sum and a count; once the count reaches ``max_average_window`` the
    sum restarts from the current parameter."""
    p = ctx.input("Param")
    s = ctx.input("Sum")
    c = ctx.input("Count").reshape(())
    restart = c >= ctx.attr("max_average_window", 10000)
    ctx.set_output("SumOut", torch.where(restart, p.to(s.dtype),
                                         s + p.to(s.dtype)))
    ctx.set_output("CountOut", torch.where(
        restart, torch.ones_like(c), c + 1.0).reshape(1))
