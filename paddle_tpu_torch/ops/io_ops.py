"""IO-ish ops (the port of ``paddle_tpu.ops.io_ops``): ``print``
(reference ``print_op.cc``; ``layers.Print`` peeks at a tensor) and the
``feed`` / ``fetch`` placeholders (the executor handles feed and fetch at
the block boundary, reference ``feed_op.cc`` / ``fetch_op.cc``) and
``assign_from_scope``, registered for API parity as no-ops."""

from __future__ import annotations

from paddle_tpu_torch.convert import fetch_numpy
from paddle_tpu_torch.ops.registry import (
    infer_shape_unary, register_grad_lower, register_op)


@register_op("print", infer_shape=infer_shape_unary("In", "Out"),
             eager_only=True)
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


@register_op("feed", no_gradient=True)
def feed_lower(ctx):  # the executor skips feed ops
    pass


@register_op("fetch", no_gradient=True)
def fetch_lower(ctx):  # the executor skips fetch ops
    pass


@register_op("assign_from_scope", no_gradient=True)
def assign_from_scope_lower(ctx):  # internal helper, as in the JAX package
    pass
