"""Creation / shape / gather ops (the port's counterpart of
``paddle_tpu.ops.tensor_ops``; reference ``paddle/fluid/operators/
{fill_constant,fill_constant_batch_size_like,assign_value,uniform_random,
gaussian_random,cast,reshape,transpose,concat,split,lookup_table,expand,
gather,top_k}_op``)."""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.convert import to_tensor, torch_dtype
from paddle_tpu_torch.ops.registry import (
    auto_vjp_grad_lower, infer_shape_unary, register_grad_lower, register_op)
from paddle_tpu_torch.selected_rows import SelectedRows


# ---------------------------------------------------------------------------
# creation ops
# ---------------------------------------------------------------------------

def _infer_fill_constant(op, block):
    out = block.var(op.output("Out")[0])
    out.shape = tuple(op.attr("shape"))
    out.dtype = op.attr("dtype", "float32")


@register_op("fill_constant", infer_shape=_infer_fill_constant,
             no_gradient=True)
def fill_constant_lower(ctx):
    ctx.set_output("Out", torch.full(
        tuple(ctx.attr("shape")), ctx.attr("value", 0.0),
        dtype=torch_dtype(ctx.attr("dtype", "float32")),
        device=ctx.device))


def _infer_fill_batch_like(op, block):
    x = block.var(op.input("Input")[0])
    shape = list(op.attr("shape"))
    in_idx = op.attr("input_dim_idx", 0)
    out_idx = op.attr("output_dim_idx", 0)
    if x.shape is not None:
        shape[out_idx] = x.shape[in_idx]
    out = block.var(op.output("Out")[0])
    out.shape = tuple(shape)
    out.dtype = op.attr("dtype", "float32")


@register_op("fill_constant_batch_size_like",
             infer_shape=_infer_fill_batch_like, no_gradient=True)
def fill_constant_batch_size_like_lower(ctx):
    """``fill_constant`` whose ``output_dim_idx`` dim is Input's
    ``input_dim_idx`` dim (a memory's batch: ``DynamicRNN.memory``)."""
    shape = list(ctx.attr("shape"))
    shape[ctx.attr("output_dim_idx", 0)] = \
        ctx.input("Input").shape[ctx.attr("input_dim_idx", 0)]
    ctx.set_output("Out", torch.full(
        tuple(shape), ctx.attr("value", 0.0),
        dtype=torch_dtype(ctx.attr("dtype", "float32")), device=ctx.device))


@register_op("assign", infer_shape=infer_shape_unary())
def assign_lower(ctx):
    ctx.set_output("Out", ctx.input("X"))


def _infer_assign_value(op, block):
    out = block.var(op.output("Out")[0])
    out.shape = tuple(op.attr("shape"))
    out.dtype = op.attr("dtype", "float32")


@register_op("assign_value", infer_shape=_infer_assign_value,
             no_gradient=True)
def assign_value_lower(ctx):
    dtype = ctx.attr("dtype", "float32")
    if dtype in ("float32", "float64", "bfloat16", "float16"):
        values = ctx.attr("fp32_values")
        host = np.asarray(values, np.float32)
    else:
        host = np.asarray(ctx.attr("int32_values"), np.int32)
    host = host.reshape(tuple(ctx.attr("shape")))
    ctx.set_output("Out", to_tensor(host, ctx.device, dtype))


def _host_generator(ctx):
    """The generator of a random creation op: the run's seeded host
    ``torch.Generator``, or one seeded from the op's own ``seed`` attr.
    Drawing on the host gives the same values on every device."""
    seed = ctx.attr("seed", 0)
    return torch.Generator().manual_seed(int(seed)) if seed \
        else ctx.aux["generator"]


@register_op("uniform_random", infer_shape=_infer_fill_constant,
             no_gradient=True, uses_rng=True)
def uniform_random_lower(ctx):
    """``U[min, max)`` in float32, cast to ``dtype`` (see
    :func:`_host_generator`)."""
    lo = float(ctx.attr("min", -1.0))
    hi = float(ctx.attr("max", 1.0))
    u = torch.rand(tuple(ctx.attr("shape")), generator=_host_generator(ctx),
                   dtype=torch.float32)
    ctx.set_output("Out", to_tensor(u * (hi - lo) + lo, ctx.device,
                                    ctx.attr("dtype", "float32")))


@register_op("gaussian_random", infer_shape=_infer_fill_constant,
             no_gradient=True, uses_rng=True)
def gaussian_random_lower(ctx):
    """``N(mean, std**2)`` in float32, cast to ``dtype``; seeded as
    ``uniform_random`` is (see :func:`_host_generator`)."""
    n = torch.randn(tuple(ctx.attr("shape")), generator=_host_generator(ctx),
                    dtype=torch.float32)
    out = n * float(ctx.attr("std", 1.0)) + float(ctx.attr("mean", 0.0))
    ctx.set_output("Out", to_tensor(out, ctx.device,
                                    ctx.attr("dtype", "float32")))


# ---------------------------------------------------------------------------
# cast
# ---------------------------------------------------------------------------

def _infer_cast(op, block):
    x = block.var(op.input("X")[0])
    out = block.var(op.output("Out")[0])
    out.shape = x.shape
    out.dtype = op.attr("out_dtype", "float32")


def _cast_grad_maker(op, block, no_grad_set):
    """cast grad = cast back (reference cast_op.cc CastOpGradMaker)."""
    from paddle_tpu_torch.framework import grad_var_name
    x = op.input("X")[0]
    if x in no_grad_set:
        return [], {}
    g_out = grad_var_name(op.output("Out")[0])
    g_x = grad_var_name(x)
    in_dtype = op.attr("in_dtype", "float32")
    desc = {"type": "cast", "inputs": {"X": [g_out]},
            "outputs": {"Out": [g_x]},
            "attrs": {"in_dtype": op.attr("out_dtype"), "out_dtype": in_dtype}}
    return [desc], {x: g_x}


def saturating_cast(x, dtype):
    """``x.to(dtype)``, saturating where a float goes to an integer type
    as XLA's convert does: NaN gives 0, and a value at or past either end
    of the target's range gives that end (``.to()`` alone is undefined
    there, and the CPU and the card disagree)."""
    if not x.is_floating_point() or dtype.is_floating_point or \
            dtype == torch.bool:
        return x.to(dtype)
    info = torch.iinfo(dtype)
    # compared in x's own dtype: float(info.max) rounds up to the next
    # representable value, which is past the range and saturates
    high, low = x >= float(info.max), x <= float(info.min)
    out = torch.where(high | low | torch.isnan(x),
                      torch.zeros((), dtype=x.dtype, device=x.device),
                      x).to(dtype)
    out = torch.where(high, torch.full((), info.max, dtype=dtype,
                                       device=x.device), out)
    return torch.where(low, torch.full((), info.min, dtype=dtype,
                                       device=x.device), out)


@register_op("cast", infer_shape=_infer_cast, grad_maker=_cast_grad_maker)
def cast_lower(ctx):
    ctx.set_output("Out", saturating_cast(
        ctx.input("X"), torch_dtype(ctx.attr("out_dtype", "float32"))))


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
    out = x.reshape(_resolve_reshape(ctx.attr("shape"), tuple(x.shape)))
    ctx.set_output("Out", out)
    # rows kept => the ragged metadata survives (the reference keeps LoD
    # through reshape when dim 0 is untouched)
    lod = ctx.input_lod("X")
    if lod is not None and out.ndim >= 1 and out.shape[0] == x.shape[0]:
        ctx.set_output_lod("Out", lod)


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
# concat / split
# ---------------------------------------------------------------------------

def _infer_concat(op, block):
    xs = [block.var(n) for n in op.input("X")]
    axis = op.attr("axis", 0)
    out = block.var(op.output("Out")[0])
    if all(x.shape is not None for x in xs):
        shape = list(xs[0].shape)
        shape[axis] = sum(x.shape[axis] for x in xs) \
            if all(x.shape[axis] != -1 for x in xs) else -1
        out.shape = tuple(shape)
    out.dtype = xs[0].dtype
    out.lod_level = xs[0].lod_level


@register_op("concat", infer_shape=_infer_concat)
def concat_lower(ctx):
    ctx.set_output("Out", torch.cat(ctx.inputs("X"),
                                    dim=ctx.attr("axis", 0)))


def _infer_split(op, block):
    x = block.var(op.input("X")[0])
    axis = op.attr("axis", 0)
    num = op.attr("num", 0)
    sections = op.attr("sections", [])
    outs = [block.var(n) for n in op.output("Out")]
    if x.shape is not None:
        for i, o in enumerate(outs):
            shape = list(x.shape)
            if num:
                shape[axis] = x.shape[axis] // num if x.shape[axis] != -1 else -1
            elif sections:
                shape[axis] = sections[i]
            o.shape = tuple(shape)
            o.dtype = x.dtype


@register_op("split", infer_shape=_infer_split)
def split_lower(ctx):
    """``num`` equal parts along ``axis``, or parts of ``sections``."""
    x = ctx.input("X")
    axis = ctx.attr("axis", 0)
    num = ctx.attr("num", 0)
    if num:
        if x.shape[axis] % num:
            raise ValueError(f"split: axis {axis} of {tuple(x.shape)} does "
                             f"not divide into {num} parts")
        parts = x.shape[axis] // num
    else:
        parts = list(ctx.attr("sections", []))
    ctx.set_outputs("Out", torch.split(x, parts, dim=axis))


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


@register_op("lookup_table", infer_shape=_infer_lookup_table,
             no_grad_inputs=("Ids",))
def lookup_table_lower(ctx):
    """Rows of ``W`` at ``Ids``; a trailing 1 of the ids is squeezed
    (``[S, 1]`` decode ids give ``[S, d]``), and rows at ``padding_idx``
    are zero."""
    w, ids = ctx.input("W"), ctx.input("Ids")
    if ids.ndim and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    ids = ids.long()
    out = take_rows(w, ids)
    padding_idx = ctx.attr("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = out * (ids != padding_idx).unsqueeze(-1).to(out.dtype)
    ctx.set_output("Out", out)


@register_grad_lower("lookup_table")
def lookup_table_grad_lower(ctx):
    """Grad of ``W``.  Dense: the auto-vjp of the gather, a scatter-add
    into a ``[vocab, dim]`` zero tensor.  ``is_sparse``: a SelectedRows
    (reference ``lookup_table_op.cc``'s SelectedRows branch) whose rows
    are the flattened ids, one slot each, and whose values are
    ``Out@GRAD`` as ``[N, dim]`` (zero at ``padding_idx``): O(batch·dim),
    no vocab-sized tensor."""
    if not ctx.attr("is_sparse", False):
        auto_vjp_grad_lower("lookup_table")(ctx)
        return
    gname = ctx.op.output("W@GRAD")
    if not gname or not gname[0]:
        return
    w = ctx.input("W")
    rows = ctx.input("Ids").reshape(-1).long()
    vals = ctx.input("Out@GRAD").reshape(-1, w.shape[-1])
    padding_idx = ctx.attr("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        vals = vals * (rows != padding_idx).unsqueeze(1).to(vals.dtype)
    # an id out of range gave a NaN row and takes no part in the grad:
    # its slot gets row ``height`` and value 0, the slot every sparse
    # update drops (``SelectedRows.live``); -1 is the last row
    rows, valid = _wrap_rows(rows, w.shape[0])
    vals = torch.where(valid.unsqueeze(1), vals, torch.zeros_like(vals))
    rows = torch.where(valid, rows, torch.full_like(rows, w.shape[0]))
    ctx.outputs[gname[0]] = SelectedRows(rows, vals, w.shape[0])


# ---------------------------------------------------------------------------
# expand / gather
# ---------------------------------------------------------------------------

def _infer_expand(op, block):
    x = block.var(op.input("X")[0])
    times = op.attr("expand_times")
    out = block.var(op.output("Out")[0])
    if x.shape is not None:
        out.shape = tuple(d * t if d != -1 else -1
                          for d, t in zip(x.shape, times))
    out.dtype = x.dtype


@register_op("expand", infer_shape=_infer_expand)
def expand_lower(ctx):
    """X tiled ``expand_times`` along each axis (``jnp.tile``)."""
    ctx.set_output("Out", ctx.input("X").repeat(
        *ctx.attr("expand_times")))


def _infer_gather(op, block):
    x = block.var(op.input("X")[0])
    ids = block.var(op.input("Index")[0])
    out = block.var(op.output("Out")[0])
    if x.shape is not None and ids.shape is not None:
        out.shape = (ids.shape[0],) + tuple(x.shape[1:])
    out.dtype = x.dtype


def _wrap_rows(idx, n):
    """``(idx, valid)``: negative indices wrapped once (``-1`` is the
    last row) and where each lies in ``[0, n)`` after that."""
    idx = torch.where(idx < 0, idx + n, idx)
    return idx, (idx >= 0) & (idx < n)


def _fill_value(dtype):
    """``jnp.take``'s fill for an index out of range: NaN for floats, the
    most negative value of a signed integer type, the largest of an
    unsigned one, True for bool."""
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


def take_rows(x, idx):
    """``x``'s rows at ``idx`` (any shape), as ``jnp.take(x, idx,
    axis=0)`` gives them: a negative index counts from the end, and an
    index still out of range gives a row of :func:`_fill_value`.  The
    index is clamped before the read, so nothing reads past the end (an
    out-of-range read is a device-side assert on the card) and no value
    goes to the host; the grad of a filled row is dropped."""
    n = x.shape[0]
    idx, valid = _wrap_rows(idx.long(), n)
    rows = x.index_select(0, idx.clamp(0, max(n - 1, 0)).reshape(-1))
    rows = rows.reshape(tuple(idx.shape) + tuple(x.shape[1:]))
    valid = valid.reshape(tuple(idx.shape) + (1,) * (x.ndim - 1))
    return torch.where(valid, rows, torch.full(
        (), _fill_value(x.dtype), dtype=x.dtype, device=x.device))


@register_op("gather", infer_shape=_infer_gather, no_grad_inputs=("Index",))
def gather_lower(ctx):
    """The rows of X at ``Index`` (flattened), by :func:`take_rows`."""
    ctx.set_output("Out", take_rows(ctx.input("X"),
                                    ctx.input("Index").reshape(-1)))


# ---------------------------------------------------------------------------
# top_k
# ---------------------------------------------------------------------------

def _infer_top_k(op, block):
    x = block.var(op.input("X")[0])
    k = op.attr("k", 1)
    out = block.var(op.output("Out")[0])
    idx = block.var(op.output("Indices")[0])
    if x.shape is not None:
        out.shape = tuple(x.shape[:-1]) + (k,)
        idx.shape = out.shape
    out.dtype = x.dtype
    idx.dtype = "int64"


@register_op("top_k", infer_shape=_infer_top_k, no_gradient=True)
def top_k_lower(ctx):
    """The ``k`` largest values of the last axis, largest first, and their
    int64 indices.  Equal values keep their index order (the lowest
    index first, as ``lax.top_k`` orders ties) on every device: a stable
    descending sort of the axis, cut to ``k``.  A NaN sorts above every
    number (``torch.sort``'s order), so NaNs come first."""
    k = int(ctx.attr("k", 1))
    vals, idx = torch.sort(ctx.input("X"), dim=-1, descending=True,
                           stable=True)
    ctx.set_output("Out", vals[..., :k].contiguous())
    ctx.set_output("Indices", idx[..., :k].contiguous())
