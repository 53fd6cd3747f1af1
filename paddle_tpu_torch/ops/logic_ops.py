"""Comparison, logical, increment and emptiness ops (the port of
``paddle_tpu.ops.logic_ops``; reference ``compare_op.cc``,
``logical_op.cc``, ``increment_op.cc``, ``is_empty_op.cc``,
``isfinite_op.cc``)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.registry import register_op, infer_shape_unary


def _infer_compare(op, block):
    x = block.var(op.input("X")[0])
    out = block.var(op.output("Out")[0])
    out.shape = x.shape
    out.dtype = "bool"


def _make_logic(name, fn, slots=("X", "Y")):
    @register_op(name, infer_shape=_infer_compare, no_gradient=True)
    def lower(ctx):
        ctx.set_output("Out", fn(*(ctx.input(s) for s in slots)))
    lower.__name__ = name + "_lower"


_make_logic("less_than", torch.lt)
_make_logic("less_equal", torch.le)
_make_logic("greater_than", torch.gt)
_make_logic("greater_equal", torch.ge)
_make_logic("equal", torch.eq)
_make_logic("not_equal", torch.ne)
_make_logic("logical_and", torch.logical_and)
_make_logic("logical_or", torch.logical_or)
_make_logic("logical_xor", torch.logical_xor)
_make_logic("logical_not", torch.logical_not, ("X",))


@register_op("increment", infer_shape=infer_shape_unary(), no_gradient=True)
def increment_lower(ctx):
    """``X + step`` in X's dtype (the int64 step counters stay int64)."""
    x = ctx.input("X")
    step = ctx.attr("step", 1.0)
    ctx.set_output("Out", x + (step if x.is_floating_point() else int(step)))


@register_op("is_empty", no_gradient=True)
def is_empty_lower(ctx):
    ctx.set_output("Out", torch.tensor(ctx.input("X").numel() == 0,
                                       device=ctx.device))


@register_op("isfinite", no_gradient=True)
def isfinite_lower(ctx):
    ctx.set_output("Out", torch.isfinite(ctx.input("X")).all().reshape(1))
