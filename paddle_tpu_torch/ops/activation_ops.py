"""Activations (the port's counterpart of ``paddle_tpu.ops.
activation_ops``; reference ``paddle/fluid/operators/activation_op.cc``).
Only those the ported slices run are here."""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.registry import register_op, infer_shape_unary


def _unary(name, fn):
    @register_op(name, infer_shape=infer_shape_unary())
    def lower(ctx):
        ctx.set_output("Out", fn(ctx.input("X")))
    lower.__name__ = name + "_lower"
    return lower


_unary("sigmoid", torch.sigmoid)
_unary("exp", torch.exp)
_unary("relu", torch.relu)
_unary("sqrt", torch.sqrt)
_unary("ceil", torch.ceil)
_unary("floor", torch.floor)


@register_op("pow", infer_shape=infer_shape_unary())
def pow_lower(ctx):
    ctx.set_output("Out", torch.pow(ctx.input("X"), ctx.attr("factor", 1.0)))
