"""Creation / shape / gather ops (the port's counterpart of
``paddle_tpu.ops.tensor_ops``; reference ``paddle/fluid/operators/
{fill_constant,fill_constant_batch_size_like,assign_value,uniform_random,
gaussian_random,cast,reshape,transpose,concat,split,lookup_table,expand,
gather,top_k,fill,fill_zeros_like,shape,squeeze,unsqueeze,pad,crop,slice,
scatter,multiplex,one_hot,argsort,arg_min_max,sampling_id}_op``).  The
integer outputs (``shape``, ``argsort``, ``arg_max``, ``arg_min``,
``sampling_id``) are int64, as the port's integers are."""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.convert import is_dtensor, to_tensor, torch_dtype
from paddle_tpu_torch.ops.registry import (
    ShapeInferenceSkip, auto_vjp_grad_lower, infer_shape_unary,
    register_grad_lower, register_op)
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


def _constant(ctx, key, host, dtype=None):
    """A constant of the op on the device: ``host()`` (a numpy array),
    cast to ``dtype`` (an IR name; default its own), copied once per
    prepared step (``aux["constants"]``, keyed by the op and ``key``),
    so a CUDA graph reads the tensor its eager first run made."""
    constants = ctx.aux.get("constants")
    k = (id(ctx.op),) + tuple(key)
    out = None if constants is None else constants.get(k)
    if out is None:
        arr = host()
        out = to_tensor(arr, ctx.device, dtype or str(arr.dtype))
        if constants is not None:
            constants[k] = out
    return out


@register_op("assign_value", infer_shape=_infer_assign_value,
             no_gradient=True)
def assign_value_lower(ctx):
    """The op's constant on the device (:func:`_constant`)."""
    dtype = ctx.attr("dtype", "float32")

    def host():
        if dtype in ("float32", "float64", "bfloat16", "float16"):
            values = np.asarray(ctx.attr("fp32_values"), np.float32)
        else:
            values = np.asarray(ctx.attr("int32_values"), np.int32)
        return values.reshape(tuple(ctx.attr("shape")))
    ctx.set_output("Out", _constant(ctx, (), host, dtype))


def _host_generator(ctx):
    """The generator of a random creation op: the run's seeded host
    ``torch.Generator``, or one seeded from the op's own ``seed`` attr.
    Drawing on the host gives the same values on every device."""
    seed = ctx.attr("seed", 0)
    return torch.Generator().manual_seed(int(seed)) if seed \
        else ctx.aux["generator"]


# eager_only: drawn on the host (the run's generator), then copied over
@register_op("uniform_random", infer_shape=_infer_fill_constant,
             no_gradient=True, uses_rng=True, eager_only=True)
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
             no_gradient=True, uses_rng=True, eager_only=True)
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


def _sharded_table():
    from paddle_tpu_torch.embedding import sharded_table
    return sharded_table


def _table_shard(w):
    """``(mesh, axis)`` of a table split by rows over a mesh axis (a
    planned table under ``ParallelExecutor``), else None."""
    return _sharded_table().row_shard(w) if is_dtensor(w) else None


@register_op("lookup_table", infer_shape=_infer_lookup_table,
             no_grad_inputs=("Ids",))
def lookup_table_lower(ctx):
    """Rows of ``W`` at ``Ids``; a trailing 1 of the ids is squeezed
    (``[S, 1]`` decode ids give ``[S, d]``), and rows at ``padding_idx``
    are zero.  A table split by rows over a mesh axis gathers its rows by
    ownership (``embedding.sharded_table.lookup_rows``)."""
    w, ids = ctx.input("W"), ctx.input("Ids")
    if ids.ndim and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    ids = ids.long()
    shard = _table_shard(w)
    out = take_rows(w, ids) if shard is None else \
        _sharded_table().lookup_rows(w, ids, shard)
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
    no vocab-sized tensor; whole on every rank for a table on a
    mesh."""
    if not ctx.attr("is_sparse", False):
        auto_vjp_grad_lower("lookup_table")(ctx)
        return
    gname = ctx.op.output("W@GRAD")
    if not gname or not gname[0]:
        return
    w = ctx.input("W")
    ids, dout = ctx.input("Ids"), ctx.input("Out@GRAD")
    if is_dtensor(w):
        # a mesh's table: the grad whole on every rank; each rank's
        # update keeps the rows it holds (embedding.sharded_table)
        ids, dout = (_sharded_table().whole(t) for t in (ids, dout))
    rows = ids.reshape(-1).long()
    vals = dout.reshape(-1, w.shape[-1])
    padding_idx = ctx.attr("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        vals = vals * (rows != padding_idx).unsqueeze(1).to(vals.dtype)
    # an id out of range gave a NaN row and takes no part in the grad:
    # its slot gets row ``height`` and value 0, a dead slot that every
    # sparse update makes harmless (``selected_rows.py``); -1 is the
    # last row
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
    goes to the host; the grad of a filled row is dropped.  The read is
    ``F.embedding``'s, not ``index_select``'s: on the card its grad sums
    a row's duplicate indices in a fixed order, where ``index_select``'s
    is an atomic ``index_add`` (a dense embedding grad that moved from
    one run to the next)."""
    n = x.shape[0]
    idx, valid = _wrap_rows(idx.long(), n)
    rows = torch.nn.functional.embedding(
        idx.clamp(0, max(n - 1, 0)).reshape(-1),
        x.reshape(n, int(np.prod(x.shape[1:], dtype=np.int64))))
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


# ---------------------------------------------------------------------------
# the rest of the creation / shape / index ops (reference fill_op.cc,
# fill_zeros_like_op.cc, {uniform,gaussian}_random_batch_size_like_op.cc,
# shape_op.cc, squeeze_op.cc, unsqueeze_op.cc, pad_op.cc, crop_op.cc,
# slice_op.cc, scatter_op.cc, multiplex_op.cc, one_hot_op.cc,
# argsort_op.cc, arg_min_max_op.cc, sampling_id_op.cc)
# ---------------------------------------------------------------------------

@register_op("fill_zeros_like", infer_shape=infer_shape_unary(),
             no_gradient=True)
def fill_zeros_like_lower(ctx):
    ctx.set_output("Out", torch.zeros_like(ctx.input("X")))


@register_op("fill", infer_shape=_infer_fill_constant, no_gradient=True)
def fill_lower(ctx):
    """The ``value`` attr (a flat list) as a ``shape`` tensor of
    ``dtype``."""
    dtype = ctx.attr("dtype", "float32")

    def host():
        np_dtype = np.float32 if dtype == "bfloat16" else np.dtype(dtype)
        return np.asarray(ctx.attr("value"), np_dtype).reshape(
            tuple(ctx.attr("shape")))
    ctx.set_output("Out", _constant(ctx, (), host, dtype))


def _batch_like_shape(ctx):
    shape = list(ctx.attr("shape"))
    shape[ctx.attr("output_dim_idx", 0)] = \
        ctx.input("Input").shape[ctx.attr("input_dim_idx", 0)]
    return tuple(shape)


@register_op("uniform_random_batch_size_like",
             infer_shape=_infer_fill_batch_like, no_gradient=True,
             uses_rng=True)
def uniform_random_batch_size_like_lower(ctx):
    """``U[min, max)`` in float32, cast to ``dtype``, of ``shape`` with
    the batch dim of ``Input``; drawn on the device from this op's RNG
    slot (``LowerContext.generator``), as ``dropout`` draws."""
    lo = float(ctx.attr("min", -1.0))
    hi = float(ctx.attr("max", 1.0))
    u = torch.rand(_batch_like_shape(ctx), generator=ctx.generator(),
                   device=ctx.device, dtype=torch.float32)
    ctx.set_output("Out", (u * (hi - lo) + lo).to(
        torch_dtype(ctx.attr("dtype", "float32"))))


@register_op("gaussian_random_batch_size_like",
             infer_shape=_infer_fill_batch_like, no_gradient=True,
             uses_rng=True)
def gaussian_random_batch_size_like_lower(ctx):
    """``N(mean, std**2)`` in float32, cast to ``dtype``; drawn as
    ``uniform_random_batch_size_like`` is."""
    n = torch.randn(_batch_like_shape(ctx), generator=ctx.generator(),
                    device=ctx.device, dtype=torch.float32)
    out = n * float(ctx.attr("std", 1.0)) + float(ctx.attr("mean", 0.0))
    ctx.set_output("Out", out.to(torch_dtype(ctx.attr("dtype", "float32"))))


def _infer_shape_op(op, block):
    x = block.var(op.input("Input")[0])
    out = block.var(op.output("Out")[0])
    out.shape = (len(x.shape),) if x.shape is not None else None
    out.dtype = "int64"


@register_op("shape", infer_shape=_infer_shape_op, no_gradient=True)
def shape_lower(ctx):
    """``Input``'s shape, int64 (a constant of the step)."""
    shape = tuple(ctx.input("Input").shape)
    ctx.set_output("Out", _constant(
        ctx, shape, lambda: np.asarray(shape, np.int64)))


def _infer_squeeze(op, block):
    x = block.var(op.input("X")[0])
    axes = op.attr("axes", [])
    out = block.var(op.output("Out")[0])
    if x.shape is not None:
        if axes:
            out.shape = tuple(d for i, d in enumerate(x.shape)
                              if not (i in axes and d == 1))
        else:
            out.shape = tuple(d for d in x.shape if d != 1)
    out.dtype = x.dtype


@register_op("squeeze", infer_shape=_infer_squeeze)
def squeeze_lower(ctx):
    """Drop the size-1 dims among ``axes`` (every size-1 dim without
    them); a listed dim that is not 1 stays."""
    x = ctx.input("X")
    axes = ctx.attr("axes", [])
    if axes:
        out = x
        for a in sorted({a % x.ndim for a in axes}, reverse=True):
            if out.shape[a] == 1:
                out = out.squeeze(a)
    else:
        out = x.squeeze()
    ctx.set_output("Out", out)


def _infer_unsqueeze(op, block):
    x = block.var(op.input("X")[0])
    axes = op.attr("axes", [])
    out = block.var(op.output("Out")[0])
    if x.shape is not None:
        shape = list(x.shape)
        for a in sorted(axes):
            shape.insert(a, 1)
        out.shape = tuple(shape)
    out.dtype = x.dtype


@register_op("unsqueeze", infer_shape=_infer_unsqueeze)
def unsqueeze_lower(ctx):
    x = ctx.input("X")
    for a in sorted(ctx.attr("axes", [])):
        x = x.unsqueeze(a)
    ctx.set_output("Out", x)


def _infer_pad(op, block):
    x = block.var(op.input("X")[0])
    paddings = op.attr("paddings")
    out = block.var(op.output("Out")[0])
    if x.shape is not None:
        out.shape = tuple(
            d + paddings[2 * i] + paddings[2 * i + 1] if d != -1 else -1
            for i, d in enumerate(x.shape))
    out.dtype = x.dtype


@register_op("pad", infer_shape=_infer_pad)
def pad_lower(ctx):
    """``paddings`` = (before, after) per dim, filled with ``pad_value``."""
    x = ctx.input("X")
    p = ctx.attr("paddings")
    flat = []
    for i in reversed(range(x.ndim)):
        flat += [p[2 * i], p[2 * i + 1]]
    ctx.set_output("Out", torch.nn.functional.pad(
        x, flat, mode="constant", value=ctx.attr("pad_value", 0.0)))


def _infer_crop(op, block):
    out = block.var(op.output("Out")[0])
    out.shape = tuple(op.attr("shape"))
    out.dtype = block.var(op.input("X")[0]).dtype


@register_op("crop", infer_shape=_infer_crop)
def crop_lower(ctx):
    """The ``shape`` window of X at ``offsets``."""
    x = ctx.input("X")
    offsets = ctx.attr("offsets", [0] * x.ndim)
    shape = ctx.attr("shape")
    ctx.set_output("Out", x[tuple(slice(o, o + s)
                                  for o, s in zip(offsets, shape))])


def _infer_slice(op, block):
    x = block.var(op.input("Input")[0])
    out = block.var(op.output("Out")[0])
    if x.shape is not None:
        shape = list(x.shape)
        for ax, st, en in zip(op.attr("axes"), op.attr("starts"),
                              op.attr("ends")):
            d = shape[ax]
            if d == -1:
                continue
            st2 = st if st >= 0 else st + d
            en2 = min(en if en >= 0 else en + d, d)
            shape[ax] = max(en2 - st2, 0)
        out.shape = tuple(shape)
    out.dtype = x.dtype


@register_op("slice", infer_shape=_infer_slice)
def slice_lower(ctx):
    """``Input[starts:ends]`` along ``axes`` (Python slice semantics)."""
    x = ctx.input("Input")
    slices = [slice(None)] * x.ndim
    for ax, st, en in zip(ctx.attr("axes"), ctx.attr("starts"),
                          ctx.attr("ends")):
        slices[ax] = slice(st, en)
    ctx.set_output("Out", x[tuple(slices)])


@register_op("scatter", infer_shape=infer_shape_unary("X"),
             no_grad_inputs=("Ids",))
def scatter_lower(ctx):
    """X with its rows at ``Ids`` set to ``Updates`` (``x.at[ids].set``):
    a negative id counts from the end, and an id still out of range is
    dropped (its update goes to a spare row that is cut off).  Which of
    repeated ids wins is undefined in the JAX package (XLA's scatter
    order), as it is here."""
    x = ctx.input("X")
    n = x.shape[0]
    ids, valid = _wrap_rows(ctx.input("Ids").reshape(-1).long(), n)
    ids = torch.where(valid, ids, torch.full_like(ids, n))
    spare = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    out = spare.index_put((ids,), ctx.input("Updates").to(x.dtype))
    ctx.set_output("Out", out[:n])


def _infer_multiplex(op, block):
    x = block.var(op.input("X")[0])
    out = block.var(op.output("Out")[0])
    out.shape = x.shape
    out.dtype = x.dtype


@register_op("multiplex", infer_shape=_infer_multiplex,
             no_grad_inputs=("Ids",))
def multiplex_lower(ctx):
    """Row b of the output is row b of ``X[Ids[b]]``."""
    xs = torch.stack(ctx.inputs("X"))                    # [K, B, ...]
    ids = ctx.input("Ids").reshape(-1).long()            # [B]
    rows = torch.arange(ids.shape[0], device=ids.device)
    ctx.set_output("Out", xs[ids, rows])


def _infer_one_hot(op, block):
    x = block.var(op.input("X")[0])
    depth = op.attr("depth")
    out = block.var(op.output("Out")[0])
    if x.shape is not None:
        out.shape = tuple(x.shape[:-1]) + (depth,)
    out.dtype = "float32"


@register_op("one_hot", infer_shape=_infer_one_hot, no_gradient=True)
def one_hot_lower(ctx):
    """float32 one-hot rows of ``depth`` (a trailing 1 of X squeezed); an
    id outside ``[0, depth)`` gives a row of zeros, as
    ``jax.nn.one_hot``."""
    x = ctx.input("X")
    if x.ndim and x.shape[-1] == 1:
        x = x.reshape(x.shape[:-1])
    depth = int(ctx.attr("depth"))
    classes = torch.arange(depth, device=x.device)
    ctx.set_output("Out", (x.long().unsqueeze(-1) == classes).float())


@register_op("argsort", no_gradient=True)
def argsort_lower(ctx):
    """X sorted along ``axis`` (stable, NaN last) and the int64 indices."""
    vals, idx = torch.sort(ctx.input("X"), dim=ctx.attr("axis", -1),
                           stable=True)
    ctx.set_output("Out", vals)
    ctx.set_output("Indices", idx)


@register_op("arg_max", no_gradient=True)
def arg_max_lower(ctx):
    """The int64 index of the first largest value along ``axis``."""
    ctx.set_output("Out", torch.argmax(ctx.input("X"),
                                       dim=ctx.attr("axis", -1)))


@register_op("arg_min", no_gradient=True)
def arg_min_lower(ctx):
    """The int64 index of the first smallest value along ``axis``."""
    ctx.set_output("Out", torch.argmin(ctx.input("X"),
                                       dim=ctx.attr("axis", -1)))


def _infer_sampling_id(op, block):
    x = block.var(op.input("X")[0])
    if x.shape is None:
        raise ShapeInferenceSkip()
    out = block.var(op.output("Out")[0])
    out.shape = (x.shape[0], 1)
    out.dtype = "int64"


@register_op("sampling_id", infer_shape=_infer_sampling_id,
             no_gradient=True, uses_rng=True)
def sampling_id_lower(ctx):
    """One class id a row of the probabilities X ``[N, C]``, by the
    inverse CDF: the count of the row's float32 cumulative sums below a
    uniform draw of the op's RNG slot, clamped to ``C - 1``; ``[N, 1]``
    int64."""
    x = ctx.input("X")
    u = torch.rand((x.shape[0], 1), generator=ctx.generator(),
                   device=x.device, dtype=torch.float32)
    cdf = torch.cumsum(x.float(), dim=1)
    idx = (cdf < u).sum(dim=1, keepdim=True)
    ctx.set_output("Out", idx.clamp(0, x.shape[1] - 1))
