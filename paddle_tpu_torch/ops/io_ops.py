"""The ``print`` op (the port of ``paddle_tpu.ops.io_ops``'s print;
reference ``print_op.cc``): ``layers.Print`` peeks at a tensor.  The
JAX package's ``feed``, ``fetch`` and ``assign_from_scope`` are not
ported (ROADMAP queue 1 item 6)."""

from __future__ import annotations

from paddle_tpu_torch.convert import fetch_numpy
from paddle_tpu_torch.ops.registry import (
    infer_shape_unary, register_grad_lower, register_op)


@register_op("print", infer_shape=infer_shape_unary("In", "Out"))
def print_lower(ctx):
    """Print ``message`` and the value (a device read) when
    ``print_phase`` is forward or both, in either case; Out is In."""
    x = ctx.input("In")
    if str(ctx.attr("print_phase", "BOTH")).upper() in ("FORWARD", "BOTH"):
        print(ctx.attr("message", ""), fetch_numpy(x.detach()))
    ctx.set_output("Out", x)


@register_grad_lower("print")
def print_grad_lower(ctx):
    """The grad passes through unchanged (and prints nothing)."""
    g_in = ctx.op.output("In@GRAD")
    g_out = ctx.op.input("Out@GRAD")
    if g_in and g_in[0] and g_out and g_out[0] in ctx.env:
        ctx.outputs[g_in[0]] = ctx.env[g_out[0]]
