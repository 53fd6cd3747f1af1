"""Linear-algebra / elementwise ops (the port's counterpart of
``paddle_tpu.ops.math_ops``; reference ``paddle/fluid/operators/{mul,
matmul,elementwise_*,scale}``).  Plain matrix products go to
``torch.matmul``, as the JAX package left them to XLA."""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.ops.registry import (
    register_op, infer_shape_elementwise, infer_shape_unary,
    ShapeInferenceSkip)


# ---------------------------------------------------------------------------
# mul / matmul  (reference: mul_op.cc, matmul_op.cc)
# ---------------------------------------------------------------------------

def _infer_mul(op, block):
    x = block.var(op.input("X")[0])
    y = block.var(op.input("Y")[0])
    if x.shape is None or y.shape is None:
        raise ShapeInferenceSkip()
    xn = op.attr("x_num_col_dims", 1)
    yn = op.attr("y_num_col_dims", 1)
    out = block.var(op.output("Out")[0])
    out.shape = tuple(x.shape[:xn]) + tuple(y.shape[yn:])
    out.dtype = x.dtype
    out.lod_level = x.lod_level


@register_op("mul", infer_shape=_infer_mul)
def mul_lower(ctx):
    """``x`` flattened to 2-D at ``x_num_col_dims``, ``y`` at
    ``y_num_col_dims``, multiplied, and unflattened."""
    x, y = ctx.input("X"), ctx.input("Y")
    xn = ctx.attr("x_num_col_dims", 1)
    yn = ctx.attr("y_num_col_dims", 1)
    lead = int(np.prod(x.shape[:xn])) if xn > 0 else 1
    x2 = x.reshape(lead, -1)
    y2 = y.reshape(int(np.prod(y.shape[:yn])), -1)
    out = torch.matmul(x2, y2)
    ctx.set_output("Out", out.reshape(tuple(x.shape[:xn]) +
                                      tuple(y.shape[yn:])))


def _infer_matmul(op, block):
    x = block.var(op.input("X")[0])
    y = block.var(op.input("Y")[0])
    if x.shape is None or y.shape is None:
        raise ShapeInferenceSkip()
    tx, ty = op.attr("transpose_X", False), op.attr("transpose_Y", False)
    xs = list(x.shape)
    ys = list(y.shape)
    if len(xs) >= 2 and tx:
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if len(ys) >= 2 and ty:
        ys[-1], ys[-2] = ys[-2], ys[-1]
    if len(xs) == 1 and len(ys) == 1:
        shape = (1,)
    elif len(xs) == 1:
        shape = tuple(ys[:-2]) + (ys[-1],)
    elif len(ys) == 1:
        shape = tuple(xs[:-1])
    else:
        batch = xs[:-2] if len(xs) > len(ys) else ys[:-2]
        shape = tuple(batch) + (xs[-2], ys[-1])
    out = block.var(op.output("Out")[0])
    out.shape = shape
    out.dtype = x.dtype


@register_op("matmul", infer_shape=_infer_matmul)
def matmul_lower(ctx):
    """Batched product with numpy broadcasting over the leading dims,
    optional transposes of the last two dims, and an ``alpha`` scale."""
    x, y = ctx.input("X"), ctx.input("Y")
    if ctx.attr("transpose_X", False) and x.ndim >= 2:
        x = x.transpose(-1, -2)
    if ctx.attr("transpose_Y", False) and y.ndim >= 2:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = ctx.attr("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    if out.ndim == 0:
        out = out.reshape(1)
    ctx.set_output("Out", out)


# ---------------------------------------------------------------------------
# elementwise family  (reference: elementwise_op_function.h broadcast)
# ---------------------------------------------------------------------------

def _elementwise_broadcast(x, y, axis):
    """Paddle broadcast: Y's shape aligns to X starting at ``axis``."""
    if y.ndim == x.ndim:
        return y
    if axis == -1:
        axis = x.ndim - y.ndim
    shape = [1] * x.ndim
    for i, d in enumerate(y.shape):
        shape[axis + i] = d
    return y.reshape(shape)


def _make_elementwise(name, fn):
    @register_op("elementwise_" + name, infer_shape=infer_shape_elementwise)
    def lower(ctx):
        x, y = ctx.input("X"), ctx.input("Y")
        yb = _elementwise_broadcast(x, y, ctx.attr("axis", -1))
        ctx.set_output("Out", fn(x, yb))
    lower.__name__ = f"elementwise_{name}_lower"
    return lower


_make_elementwise("add", torch.add)
_make_elementwise("mul", torch.mul)


# ---------------------------------------------------------------------------
# scale
# ---------------------------------------------------------------------------

@register_op("scale", infer_shape=infer_shape_unary())
def scale_lower(ctx):
    x = ctx.input("X")
    scale = ctx.attr("scale", 1.0)
    bias = ctx.attr("bias", 0.0)
    if ctx.attr("bias_after_scale", True):
        ctx.set_output("Out", x * scale + bias)
    else:
        ctx.set_output("Out", (x + bias) * scale)
