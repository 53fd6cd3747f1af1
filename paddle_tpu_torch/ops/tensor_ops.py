"""Creation / shape / gather ops (the port's counterpart of
``paddle_tpu.ops.tensor_ops``; reference ``paddle/fluid/operators/
{fill_constant,assign_value,uniform_random,reshape,transpose,
lookup_table}_op``)."""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.convert import to_tensor, torch_dtype
from paddle_tpu_torch.ops.registry import register_op


# ---------------------------------------------------------------------------
# creation ops
# ---------------------------------------------------------------------------

def _infer_fill_constant(op, block):
    out = block.var(op.output("Out")[0])
    out.shape = tuple(op.attr("shape"))
    out.dtype = op.attr("dtype", "float32")


@register_op("fill_constant", infer_shape=_infer_fill_constant)
def fill_constant_lower(ctx):
    ctx.set_output("Out", torch.full(
        tuple(ctx.attr("shape")), ctx.attr("value", 0.0),
        dtype=torch_dtype(ctx.attr("dtype", "float32")),
        device=ctx.device))


def _infer_assign_value(op, block):
    out = block.var(op.output("Out")[0])
    out.shape = tuple(op.attr("shape"))
    out.dtype = op.attr("dtype", "float32")


@register_op("assign_value", infer_shape=_infer_assign_value)
def assign_value_lower(ctx):
    dtype = ctx.attr("dtype", "float32")
    if dtype in ("float32", "float64", "bfloat16", "float16"):
        values = ctx.attr("fp32_values")
        host = np.asarray(values, np.float32)
    else:
        host = np.asarray(ctx.attr("int32_values"), np.int32)
    host = host.reshape(tuple(ctx.attr("shape")))
    ctx.set_output("Out", to_tensor(host, ctx.device, dtype))


@register_op("uniform_random", infer_shape=_infer_fill_constant)
def uniform_random_lower(ctx):
    """``U[min, max)`` drawn on the host from the run's seeded
    ``torch.Generator`` (or one seeded from the op's own ``seed`` attr),
    so the same seed gives the same values on every device."""
    seed = ctx.attr("seed", 0)
    gen = torch.Generator().manual_seed(int(seed)) if seed \
        else ctx.aux["generator"]
    lo = float(ctx.attr("min", -1.0))
    hi = float(ctx.attr("max", 1.0))
    u = torch.rand(tuple(ctx.attr("shape")), generator=gen,
                   dtype=torch.float32)
    ctx.set_output("Out", to_tensor(u * (hi - lo) + lo, ctx.device,
                                    ctx.attr("dtype", "float32")))


# ---------------------------------------------------------------------------
# reshape / transpose
# ---------------------------------------------------------------------------

def _resolve_reshape(shape, in_shape):
    """Paddle reshape: a 0 copies the input's dim at that index; one -1
    is inferred from the rest."""
    shape = list(shape)
    for i, d in enumerate(shape):
        if d == 0:
            shape[i] = in_shape[i]
    return shape


def _infer_reshape(op, block):
    x = block.var(op.input("X")[0])
    shape = op.attr("shape")
    out = block.var(op.output("Out")[0])
    if x.shape is None or any(d == -1 for d in x.shape):
        out.shape = tuple(shape)
    else:
        out.shape = tuple(np.reshape(np.empty(x.shape, dtype=np.int8),
                                     _resolve_reshape(shape, x.shape)).shape)
    out.dtype = x.dtype


@register_op("reshape", infer_shape=_infer_reshape)
def reshape_lower(ctx):
    x = ctx.input("X")
    ctx.set_output("Out", x.reshape(_resolve_reshape(ctx.attr("shape"),
                                                     tuple(x.shape))))


def _infer_transpose(op, block):
    x = block.var(op.input("X")[0])
    axis = op.attr("axis")
    out = block.var(op.output("Out")[0])
    if x.shape is not None:
        out.shape = tuple(x.shape[a] for a in axis)
    out.dtype = x.dtype


@register_op("transpose", infer_shape=_infer_transpose)
def transpose_lower(ctx):
    ctx.set_output("Out", ctx.input("X").permute(*ctx.attr("axis")))


# ---------------------------------------------------------------------------
# lookup_table (embedding), reference lookup_table_op.cc
# ---------------------------------------------------------------------------

def _infer_lookup_table(op, block):
    w = block.var(op.input("W")[0])
    ids = block.var(op.input("Ids")[0])
    out = block.var(op.output("Out")[0])
    if w.shape is not None and ids.shape is not None:
        ids_shape = ids.shape
        if ids_shape and ids_shape[-1] == 1:
            ids_shape = ids_shape[:-1]
        out.shape = tuple(ids_shape) + (w.shape[-1],)
    out.dtype = w.dtype
    out.lod_level = ids.lod_level


@register_op("lookup_table", infer_shape=_infer_lookup_table)
def lookup_table_lower(ctx):
    """Rows of ``W`` at ``Ids``; a trailing 1 of the ids is squeezed
    (``[S, 1]`` decode ids give ``[S, d]``), and rows at ``padding_idx``
    are zero."""
    w, ids = ctx.input("W"), ctx.input("Ids")
    if ids.ndim and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    ids = ids.long()
    out = w[ids]
    padding_idx = ctx.attr("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = out * (ids != padding_idx).unsqueeze(-1).to(out.dtype)
    ctx.set_output("Out", out)
