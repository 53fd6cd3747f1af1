"""Sequence (LoD) ops (the port of ``paddle_tpu.ops.sequence_ops``'s
static-LoD branches; reference ``paddle/fluid/operators/sequence_*_op.cc``,
``operators/math/sequence*``).

A LoD is host metadata of the run (``aux["lod"]``), so every lowering
knows its sizes without reading the device: it turns the LoD into index
tables on the device once per run (``lod.tables``; the auto-vjp
recompute reuses them) and runs dense torch ops over them.  An input
without a LoD reads as one row per sequence (``_require_lod``).  Each op
sets its output's LoD as the JAX package does; where it sets none, the
executor's row-count rule applies.

Four ops read an input's values on the host, because their output's
rows or LoD depend on them: the ``host`` ops ``sequence_slice`` (Offset,
Length), ``sequence_erase`` (the tokens of X) and ``sub_nested_seq``
(SelectedIndices), as in the JAX package, and ``lod_reset`` when Y is a
tensor of splits (which the JAX package can read only outside jit).

Every op here is ``eager_only``: its index tables are copied from the
host LoD each run, which a CUDA graph cannot replay.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.lod import (freeze, gather_index, segment_tables,
                                  tables, take_rows)
from paddle_tpu_torch.ops.registry import register_op, ShapeInferenceSkip

#: MaxIndex of an empty sequence: the JAX package's ``segment_min`` over
#: no int32 rows gives the identity of min, ``iinfo(int32).max``
_EMPTY_MAX_INDEX = 2 ** 31 - 1


def _infer_ragged(op, block):
    """Out is ragged: row count unknown at build time, features kept."""
    x = block.var(op.input("X")[0])
    out = block.var(op.output("Out")[0])
    if x.shape is None:
        raise ShapeInferenceSkip()
    out.shape = (-1,) + tuple(x.shape[1:])
    out.dtype = x.dtype
    out.lod_level = x.lod_level


def _infer_seq_conv(op, block):
    x = block.var(op.input("X")[0])
    filt = block.var(op.input("Filter")[0])
    out = block.var(op.output("Out")[0])
    out.shape = (-1 if x.shape is None else x.shape[0], filt.shape[1])
    out.dtype = x.dtype
    out.lod_level = x.lod_level


def _require_lod(ctx, slot="X"):
    """The LoD of ``slot``; without one each row is its own length-1
    sequence (the reference's reading of a ``lod_level = 0`` feed)."""
    lod = ctx.input_lod(slot)
    if lod is None:
        x = ctx.input(slot)
        if x.ndim >= 1:
            return [list(range(x.shape[0] + 1))]
        raise ValueError(
            f"op {ctx.op.type} requires LoD metadata on input {slot!r}")
    return lod


def _copy(lod):
    return [list(level) for level in lod]


def _index(ctx, kind, lod, device, build, *params):
    """An index table that ``build()`` makes in numpy from host
    metadata, on ``device`` once per run."""
    return tables(ctx.aux, kind, lod, device,
                  lambda: torch.as_tensor(build(), device=device), *params)


def _index_and_lod(ctx, kind, lod, device, build, *params):
    """``(index table on device, output LoD)`` from ``build() -> (numpy
    index, LoD)``, once per run."""
    def make():
        idx, out_lod = build()
        return torch.as_tensor(idx, device=device), out_lod
    return tables(ctx.aux, kind, lod, device, make, *params)


def _bcast(seg, x):
    """``seg`` ``[N]`` as an index broadcast over x's trailing dims."""
    return seg.view((-1,) + (1,) * (x.ndim - 1)).expand_as(x)


def _segment_sum(x, seg, num):
    return x.new_zeros((num,) + tuple(x.shape[1:])).index_add(0, seg, x)


def _segment_reduce(x, seg, num, reduce, empty):
    """``jax.ops.segment_max`` / ``segment_min``: ``empty`` in a segment
    with no rows; the grad of a max (min) splits among tied rows."""
    init = torch.full((num,) + tuple(x.shape[1:]), empty, dtype=x.dtype,
                      device=x.device)
    return init.scatter_reduce(0, _bcast(seg, x), x, reduce,
                               include_self=True)


# ---------------------------------------------------------------------------
# sequence_pool (sum/average/max/min/last/first/sqrt)
# ---------------------------------------------------------------------------

@register_op("sequence_pool", infer_shape=_infer_ragged,
             eager_only=True)
def sequence_pool_lower(ctx):
    x = ctx.input("X")                      # [N, D]
    lod = _require_lod(ctx)
    pooltype = ctx.attr("pooltype", "AVERAGE").upper()
    st = segment_tables(ctx.aux, lod, x.device)
    denom_shape = (-1,) + (1,) * (x.ndim - 1)
    if pooltype == "SUM":
        out = _segment_sum(x, st.seg, st.num)
    elif pooltype in ("AVERAGE", "MEAN"):
        out = _segment_sum(x, st.seg, st.num) / st.lengths.clamp(
            min=1).to(x.dtype).reshape(denom_shape)
    elif pooltype == "SQRT":
        out = _segment_sum(x, st.seg, st.num) / torch.sqrt(
            st.lengths.clamp(min=1).to(x.dtype)).reshape(denom_shape)
    elif pooltype == "MAX":
        out = _segment_reduce(x, st.seg, st.num, "amax", -float("inf"))
        # MaxIndex: per (sequence, feature) the first row holding the max,
        # as the reference's MaxSeqPoolFunctor stores it
        n = x.shape[0]
        rows = torch.arange(n, device=x.device).view(denom_shape)
        cand = torch.where(x == out[st.seg], rows, n)
        ctx.set_output("MaxIndex", _segment_reduce(
            cand, st.seg, st.num, "amin", _EMPTY_MAX_INDEX))
    elif pooltype == "MIN":
        out = _segment_reduce(x, st.seg, st.num, "amin", float("inf"))
    elif pooltype == "LAST":
        out = take_rows(x, *st.last)
    elif pooltype == "FIRST":
        out = take_rows(x, *st.first)
    else:
        raise NotImplementedError(f"sequence_pool type {pooltype}")
    ctx.set_output("Out", out)
    if len(lod) > 1:
        ctx.set_output_lod("Out", _copy(lod[:-1]))


# ---------------------------------------------------------------------------
# sequence_softmax
# ---------------------------------------------------------------------------

@register_op("sequence_softmax", infer_shape=_infer_ragged,
             eager_only=True)
def sequence_softmax_lower(ctx):
    x = ctx.input("X")          # [N] or [N, 1]
    lod = _require_lod(ctx)
    flat = x.reshape(-1)
    st = segment_tables(ctx.aux, lod, x.device)
    mx = _segment_reduce(flat, st.seg, st.num, "amax", -float("inf"))
    e = torch.exp(flat - mx[st.seg])
    denom = _segment_sum(e, st.seg, st.num)
    out = e / torch.clamp(denom[st.seg], min=1e-30)
    ctx.set_output("Out", out.reshape(x.shape))
    ctx.set_output_lod("Out", _copy(lod))


# ---------------------------------------------------------------------------
# sequence_expand: repeat x rows (or x's sequences) by y's LoD
# ---------------------------------------------------------------------------

def _expand_index(x_lod, y_lod, ref_level, n_rows):
    """``((indices, clamped), output LoD or None)`` of the expansion."""
    rep = np.diff(np.asarray(y_lod[ref_level], np.int64))
    if x_lod is None:
        # each x row i repeats rep[i] times
        return gather_index(np.repeat(np.arange(len(rep)), rep),
                            n_rows), None
    xs = np.asarray(x_lod[0], np.int64)
    idx, new_splits = [], [0]
    for i, r in enumerate(rep):
        seq = range(xs[i], xs[i + 1])
        for _ in range(r):
            idx.extend(seq)
            new_splits.append(new_splits[-1] + len(seq))
    return gather_index(idx, n_rows), [new_splits]


@register_op("sequence_expand", infer_shape=_infer_ragged,
             eager_only=True)
def sequence_expand_lower(ctx):
    x = ctx.input("X")
    x_lod = ctx.input_lod("X")
    y_lod = _require_lod(ctx, "Y")
    ref_level = ctx.attr("ref_level", -1)
    if ref_level == -1:
        ref_level = len(y_lod) - 1

    def build():
        (idx, clamped), out_lod = _expand_index(x_lod, y_lod, ref_level,
                                                x.shape[0])
        return tuple(None if t is None else torch.as_tensor(t,
                                                            device=x.device)
                     for t in (idx, clamped)), out_lod
    rows, out_lod = tables(ctx.aux, "expand", y_lod, x.device, build,
                           ref_level, None if x_lod is None
                           else freeze(x_lod), x.shape[0])
    ctx.set_output("Out", take_rows(x, *rows))
    ctx.set_output_lod("Out", _copy(out_lod) if out_lod is not None
                       else [list(y_lod[ref_level])])


# ---------------------------------------------------------------------------
# sequence_concat / sequence_reverse / sequence_reshape
# ---------------------------------------------------------------------------

def _concat_index(lods, rows):
    """Out sequence i = input 0's sequence i, then input 1's, ...: the
    rows of the inputs stacked in order, and the output splits."""
    splits = [np.asarray(l[0], np.int64) for l in lods]
    offsets = np.cumsum([0] + list(rows))
    order, new_splits = [], [0]
    for i in range(len(splits[0]) - 1):
        total = 0
        for k, sp in enumerate(splits):
            order.extend(range(offsets[k] + sp[i], offsets[k] + sp[i + 1]))
            total += int(sp[i + 1] - sp[i])
        new_splits.append(new_splits[-1] + total)
    return np.asarray(order, np.int64), [new_splits]


@register_op("sequence_concat", infer_shape=_infer_ragged,
             eager_only=True)
def sequence_concat_lower(ctx):
    xs = ctx.inputs("X")
    lods = [ctx.var_lod(n) for n in ctx.op.input("X")]
    allx = torch.cat(xs, dim=0)
    if any(l is None for l in lods):
        ctx.set_output("Out", allx)
        return
    rows = tuple(int(x.shape[0]) for x in xs)
    order, out_lod = _index_and_lod(
        ctx, "concat", lods[0], allx.device,
        lambda: _concat_index(lods, rows),
        tuple(freeze(l) for l in lods[1:]), rows)
    ctx.set_output("Out", allx[order])
    ctx.set_output_lod("Out", _copy(out_lod))


@register_op("sequence_reverse", infer_shape=_infer_ragged,
             eager_only=True)
def sequence_reverse_lower(ctx):
    """Reverse rows within each sequence (reference
    ``sequence_reverse_op.h``); the LoD is unchanged."""
    x = ctx.input("X")
    lod = ctx.var_lod(ctx.op.input("X")[0])
    if lod is None:
        ctx.set_output("Out", x.flip(0))
        return

    def build():
        splits = np.asarray(lod[0], np.int64)
        return np.concatenate([np.arange(splits[i + 1] - 1, splits[i] - 1, -1)
                               for i in range(len(splits) - 1)]
                              + [np.zeros(0, np.int64)])
    ctx.set_output("Out", x[_index(ctx, "reverse", lod, x.device, build)])
    ctx.set_output_lod("Out", [[int(s) for s in lod[0]]])


def _infer_seq_reshape(op, block):
    x = block.var(op.input("X")[0])
    out = block.var(op.output("Out")[0])
    out.shape = (-1, op.attr("new_dim"))
    out.dtype = x.dtype
    out.lod_level = x.lod_level


@register_op("sequence_reshape", infer_shape=_infer_seq_reshape,
             eager_only=True)
def sequence_reshape_lower(ctx):
    x = ctx.input("X")
    lod = _require_lod(ctx)
    new_dim = ctx.attr("new_dim")
    ratio = x.shape[1] / new_dim
    ctx.set_output("Out", x.reshape(-1, new_dim))
    ctx.set_output_lod("Out", [[int(s * ratio) for s in lod[0]]])


# ---------------------------------------------------------------------------
# host ops: sequence_slice / sequence_erase / lod_reset
# ---------------------------------------------------------------------------

def _host(t):
    """A small input read on the host (the host ops' data-dependent
    sizes; ``tolist``, which also works inside the auto-vjp's
    ``torch.func.vjp``)."""
    return np.asarray(t.tolist())


@register_op("sequence_slice", infer_shape=_infer_ragged,
             no_gradient=True, host=True,
             eager_only=True)
def sequence_slice_lower(ctx):
    x = ctx.input("X")
    lod = _require_lod(ctx)
    offset = _host(ctx.input("Offset")).reshape(-1)
    length = _host(ctx.input("Length")).reshape(-1)
    splits = np.asarray(lod[0], np.int64)
    idx, new_splits = [], [0]
    for i in range(len(splits) - 1):
        start = int(splits[i] + offset[i])
        idx.extend(range(start, start + int(length[i])))
        new_splits.append(new_splits[-1] + int(length[i]))
    ctx.set_output("Out", x[torch.as_tensor(
        gather_index(idx, x.shape[0])[0], device=x.device)])
    ctx.set_output_lod("Out", [new_splits])


@register_op("sequence_erase", infer_shape=_infer_ragged,
             no_gradient=True, host=True,
             eager_only=True)
def sequence_erase_lower(ctx):
    """Remove the ``tokens`` ids from each sequence (the output's rows
    depend on X's values: read on the host)."""
    x = ctx.input("X")
    tokens = set(ctx.attr("tokens", []))
    lod = _require_lod(ctx)
    vals = _host(x).reshape(-1)
    splits = np.asarray(lod[0], np.int64)
    keep, new_splits = [], [0]
    for i in range(len(splits) - 1):
        seq = [v for v in vals[splits[i]:splits[i + 1]]
               if int(v) not in tokens]
        keep.extend(seq)
        new_splits.append(new_splits[-1] + len(seq))
    out = torch.as_tensor(np.asarray(keep), dtype=x.dtype, device=x.device)
    ctx.set_output("Out", out.reshape(-1, *x.shape[1:]) if x.ndim > 1
                   else out)
    ctx.set_output_lod("Out", [new_splits])


@register_op("lod_reset", infer_shape=_infer_ragged,
             eager_only=True)
def lod_reset_lower(ctx):
    x = ctx.input("X")
    target = ctx.attr("target_lod", None)
    if ctx.op.input("Y"):
        y_lod = ctx.input_lod("Y")
        target = y_lod[0] if y_lod is not None else \
            [int(v) for v in _host(ctx.input("Y")).reshape(-1)]
    ctx.set_output("Out", x)
    ctx.set_output_lod("Out", [list(target)])


# ---------------------------------------------------------------------------
# sequence_conv / sequence_context: context windows inside each sequence
# ---------------------------------------------------------------------------

def _window_index(lod, n, ctx_len, ctx_start):
    """``[N, ctx_len]``: the row at offset ``ctx_start + j`` of row n if it
    lies in n's sequence, else N (the zero row)."""
    splits = np.asarray(lod[-1], np.int64)
    seg = np.repeat(np.arange(len(splits) - 1), np.diff(splits))
    lo, hi = splits[seg][:, None], splits[seg + 1][:, None]
    src = np.arange(n)[:, None] + ctx_start + np.arange(ctx_len)[None, :]
    return np.where((src >= lo) & (src < hi), src, n)


def _context_windows(ctx, x, lod, ctx_len, ctx_start):
    """``[N, ctx_len * D]``: the window around each row, zeros past its
    sequence's ends (reference ``operators/math/context_project.h``)."""
    n = x.shape[0]
    gather = _index(ctx, "window", lod, x.device,
                    lambda: _window_index(lod, n, ctx_len, ctx_start),
                    ctx_len, ctx_start)
    padded = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    return padded[gather].reshape(n, -1)


@register_op("sequence_conv", infer_shape=_infer_seq_conv,
             eager_only=True)
def sequence_conv_lower(ctx):
    """Each row's ``[contextLength, D]`` window, flattened, times the
    filter ``[contextLength * D, F]`` (no trainable boundary padding:
    zeros, as the JAX package)."""
    x = ctx.input("X")
    lod = _require_lod(ctx)
    ctx_len = ctx.attr("contextLength")
    ctx_start = ctx.attr("contextStart", -((ctx_len - 1) // 2))
    flat = _context_windows(ctx, x, lod, ctx_len, ctx_start)
    ctx.set_output("Out", flat @ ctx.input("Filter"))
    ctx.set_output_lod("Out", _copy(lod))


def _infer_seq_context(op, block):
    x = block.var(op.input("X")[0])
    out = block.var(op.output("Out")[0])
    if x.shape is None:
        raise ShapeInferenceSkip()
    out.shape = (x.shape[0], x.shape[1] * op.attr("contextLength"))
    out.dtype = x.dtype
    out.lod_level = x.lod_level


@register_op("sequence_context", infer_shape=_infer_seq_context,
             eager_only=True)
def sequence_context_lower(ctx):
    """The context windows without weights (the legacy DSL's
    ``context_projection``)."""
    x = ctx.input("X")
    lod = _require_lod(ctx)
    ctx_len = ctx.attr("contextLength")
    ctx_start = ctx.attr("contextStart", -((ctx_len - 1) // 2))
    ctx.set_output("Out", _context_windows(ctx, x, lod, ctx_len, ctx_start))
    ctx.set_output_lod("Out", _copy(lod))


@register_op("sequence_first_step", infer_shape=_infer_ragged,
             eager_only=True)
def sequence_first_step_lower(ctx):
    x = ctx.input("X")
    ctx.set_output("Out", take_rows(x, *segment_tables(
        ctx.aux, _require_lod(ctx), x.device).first))


@register_op("sequence_last_step", infer_shape=_infer_ragged,
             eager_only=True)
def sequence_last_step_lower(ctx):
    x = ctx.input("X")
    ctx.set_output("Out", take_rows(x, *segment_tables(
        ctx.aux, _require_lod(ctx), x.device).last))


# ---------------------------------------------------------------------------
# im2sequence (reference im2sequence_op.h): each image's patches as one
# sequence, rows ordered (oh, ow), features (C, kh, kw)
# ---------------------------------------------------------------------------

def _im2seq_out(size, k, pad0, pad1, stride):
    return (size + pad0 + pad1 - k) // stride + 1


def _infer_im2sequence(op, block):
    x = block.var(op.input("X")[0])
    if x.shape is None:
        raise ShapeInferenceSkip()
    n, c, h, w = x.shape
    k = op.attr("kernels")
    s = op.attr("strides", [1, 1])
    p = op.attr("paddings", [0, 0, 0, 0])
    oh = _im2seq_out(h, k[0], p[0], p[2], s[0])
    ow = _im2seq_out(w, k[1], p[1], p[3], s[1])
    out = block.var(op.output("Out")[0])
    out.shape = (n * oh * ow, c * k[0] * k[1])
    out.dtype = x.dtype
    out.lod_level = 1


@register_op("im2sequence", infer_shape=_infer_im2sequence,
             eager_only=True)
def im2sequence_lower(ctx):
    x = ctx.input("X")                   # [N, C, H, W]
    k = list(ctx.attr("kernels"))
    s = list(ctx.attr("strides", [1, 1]))
    p = list(ctx.attr("paddings", [0, 0, 0, 0]))   # up, left, down, right
    n, c = x.shape[0], x.shape[1]
    xp = F.pad(x, (p[1], p[3], p[0], p[2]))
    oh = _im2seq_out(x.shape[2], k[0], p[0], p[2], s[0])
    ow = _im2seq_out(x.shape[3], k[1], p[1], p[3], s[1])
    patches = F.unfold(xp, kernel_size=k, stride=s)   # [N, C*kh*kw, OH*OW]
    ctx.set_output("Out", patches.transpose(1, 2).reshape(
        n * oh * ow, c * k[0] * k[1]))
    ctx.set_output_lod("Out", [[i * oh * ow for i in range(n + 1)]])


# ---------------------------------------------------------------------------
# row_conv (reference row_conv_op.cc): lookahead convolution inside each
# sequence, out[t] = sum_w filter[w] * x[t + w]
# ---------------------------------------------------------------------------

def _infer_row_conv(op, block):
    x = block.var(op.input("X")[0])
    out = block.var(op.output("Out")[0])
    out.shape = x.shape
    out.dtype = x.dtype
    out.lod_level = x.lod_level


@register_op("row_conv", infer_shape=_infer_row_conv,
             eager_only=True)
def row_conv_lower(ctx):
    x = ctx.input("X")                   # [N, D] ragged
    filt = ctx.input("Filter")           # [future_context, D]
    lod = _require_lod(ctx, "X")
    fc, n = filt.shape[0], x.shape[0]
    gather = _index(ctx, "window", lod, x.device,
                    lambda: _window_index(lod, n, fc, 0), fc, 0)
    padded = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    out = torch.zeros_like(x)
    for w in range(fc):
        out = out + filt[w][None, :] * padded[gather[:, w]]
    ctx.set_output("Out", out)
    ctx.set_output_lod("Out", _copy(lod))


# ---------------------------------------------------------------------------
# kmax_seq_score / sub_nested_seq (beam training)
# ---------------------------------------------------------------------------

def _infer_kmax(op, block):
    x = block.var(op.input("X")[0])
    out = block.var(op.output("Out")[0])
    if x.shape is None:
        raise ShapeInferenceSkip()
    out.shape = (-1, op.attr("beam_size"))
    out.dtype = "int64"


@register_op("kmax_seq_score", infer_shape=_infer_kmax,
             eager_only=True)
def kmax_seq_score_lower(ctx):
    """Per-sequence top-k of ``[N, 1]`` scores: the winners' indexes
    inside their sequence, highest first, ties lowest index first (as
    ``lax.top_k``), padded with -1 (reference KmaxSeqScoreLayer.cpp)."""
    x = ctx.input("X").reshape(-1)
    lod = _require_lod(ctx)
    k = ctx.attr("beam_size")
    st = segment_tables(ctx.aux, lod, x.device)
    t = max(int(st.lens.max()) if st.num else 1, k)
    col = _index(ctx, "kmax_col", lod, x.device,
                 lambda: np.arange(int(st.splits[-1])) -
                 np.repeat(st.splits[:-1], st.lens))
    dense = torch.full((st.num, t), -1e30, dtype=x.dtype, device=x.device)
    dense[st.seg, col] = x
    top, idx = torch.sort(dense, dim=1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    ctx.set_output("Out", torch.where(top <= -1e29, -1, idx))


@register_op("sub_nested_seq", infer_shape=_infer_ragged,
             no_grad_inputs=("SelectedIndices",), host=True,
             eager_only=True)
def sub_nested_seq_lower(ctx):
    """Keep the sub-sequences of a 2-level sequence that
    ``SelectedIndices`` ``[B, k]`` names (within-outer-sequence ids, -1 =
    none), in (outer, selection) order, as a 1-level sequence (reference
    SubNestedSequenceLayer.cpp; the rows depend on the selection, read on
    the host)."""
    x = ctx.input("X")
    lod = _require_lod(ctx)
    if len(lod) < 2:
        raise ValueError("sub_nested_seq input must be a 2-level nested "
                         "sequence")
    sel = _host(ctx.input("SelectedIndices"))
    n_outer = len(lod[0]) - 1
    if sel.ndim != 2 or sel.shape[0] != n_outer:
        raise ValueError(
            f"sub_nested_seq: SelectedIndices must be [num_outer_seqs, k] "
            f"= [{n_outer}, k], got shape {tuple(sel.shape)} — one row of "
            f"selections per OUTER sequence")
    outer, inner = lod[0], lod[1]
    rows, new_splits = [], [0]
    for b in range(n_outer):
        for i in sel[b]:
            i = int(i)
            if i < 0:
                continue
            sub = outer[b] + i
            if sub >= outer[b + 1]:
                raise ValueError(
                    f"sub_nested_seq: selected index {i} out of range for "
                    f"outer sequence {b}")
            rows.extend(range(int(inner[sub]), int(inner[sub + 1])))
            new_splits.append(len(rows))
    ctx.set_output("Out", x[torch.as_tensor(rows, dtype=torch.int64,
                                            device=x.device)])
    ctx.set_output_lod("Out", [new_splits])
