"""Comparison and increment ops (the port's counterpart of
``paddle_tpu.ops.logic_ops``; reference ``compare_op.cc``,
``increment_op.cc``).  The logical and emptiness ops wait for control
flow."""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.registry import register_op, infer_shape_unary


def _infer_compare(op, block):
    x = block.var(op.input("X")[0])
    out = block.var(op.output("Out")[0])
    out.shape = x.shape
    out.dtype = "bool"


def _make_compare(name, fn):
    @register_op(name, infer_shape=_infer_compare, no_gradient=True)
    def lower(ctx):
        ctx.set_output("Out", fn(ctx.input("X"), ctx.input("Y")))
    lower.__name__ = name + "_lower"


_make_compare("less_than", torch.lt)
_make_compare("less_equal", torch.le)
_make_compare("greater_than", torch.gt)
_make_compare("greater_equal", torch.ge)
_make_compare("equal", torch.eq)
_make_compare("not_equal", torch.ne)


@register_op("increment", infer_shape=infer_shape_unary(), no_gradient=True)
def increment_lower(ctx):
    """``X + step`` in X's dtype (the int64 step counters stay int64)."""
    x = ctx.input("X")
    step = ctx.attr("step", 1.0)
    ctx.set_output("Out", x + (step if x.is_floating_point() else int(step)))
