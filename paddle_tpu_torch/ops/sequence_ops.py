"""Sequence (LoD) ops (the port of ``paddle_tpu.ops.sequence_ops``;
reference ``paddle/fluid/operators/sequence_*_op.cc``,
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

Bucketed LoD (``lod.DynLoD``, the JAX package's dynamic branches,
``paddle_tpu/ops/sequence_ops.py:83-600``): the input's rows are padded
to a bucket and its splits are a device tensor of the run's env, so
``sequence_pool`` (and the first / last step), ``sequence_softmax``,
``sequence_expand``, ``sequence_concat``, ``sequence_reshape``,
``sequence_slice``, ``sequence_erase``, ``lod_reset``, ``sequence_conv``
and ``sequence_context`` build their tables there with torch ops
(``lod.dyn_segment_tables``; padding rows in segment ``B``, which the
segment sums drop) and keep the padded row count; an op that changes
the row structure writes its output's splits as ``<Out>@lod0`` and sets
a ``DynLoD`` on it.  Those ops are ``eager_dyn_ok``: under the switch
they keep no block out of a CUDA graph.  ``sequence_reverse``,
``row_conv``, ``kmax_seq_score`` and ``sub_nested_seq`` have no such
branch and raise ``DynLoD``'s ``NotImplementedError``, as in the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.lod import (SPLITS_SUFFIX, DynLoD, dyn_segment_tables,
                                  dyn_tables, freeze, gather_index, is_dyn,
                                  segment_reduce, segment_sum,
                                  segment_tables, tables, take_rows)
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


# ---------------------------------------------------------------------------
# sequence_pool (sum/average/max/min/last/first/sqrt)
# ---------------------------------------------------------------------------

def _const_splits(ctx, level, device):
    """A static LoD level as an int32 splits tensor on ``device``, made
    once per prepared step (``aux["constants"]``) where there is one: a
    CUDA graph's capture reads the one its eager run made."""
    key = ("const_splits", tuple(int(v) for v in level), str(device))
    constants = ctx.aux.get("constants")
    t = None if constants is None else constants.get(key)
    if t is None:
        t = torch.as_tensor(np.asarray(level, np.int32), device=device)
        if constants is not None:
            constants[key] = t
    return t


class _ConstSplits:
    """A static LoD level presented through ``DynLoD``'s interface (the
    JAX package's ``_ConstSplits``): ``sequence_slice`` and
    ``sequence_erase`` take their bucketed branch over it in a block the
    JAX package traces, where a static LoD is a constant."""

    def __init__(self, ctx, level, device):
        self._splits = _const_splits(ctx, level, device)
        self.num_seqs = len(level) - 1
        lengths = np.diff(np.asarray(level, np.int64))
        self.maxlen_bucket = int(lengths.max()) if len(lengths) else 0

    def splits(self, env):
        return self._splits


def _splits_of(ctx, lod, device):
    """``(splits int64 [B + 1], B, length bound)`` of a bucketed LoD, or of
    a static one's last level (a constant)."""
    if is_dyn(lod):
        return lod.splits(ctx.env).long(), lod.num_seqs, lod.maxlen_bucket
    level = lod[0]
    lens = np.diff(np.asarray(level, np.int64))
    return (_const_splits(ctx, level, device).long(), len(level) - 1,
            int(lens.max()) if len(lens) else 0)


def _dyn_out(ctx, slot, out, splits, num, cap):
    """Set ``slot`` to ``out`` with new bucketed splits: ``<Out>@lod0``
    in the env, a ``DynLoD`` on the output."""
    name = ctx.op.output(slot)[0] + SPLITS_SUFFIX
    ctx.outputs[name] = splits.to(torch.int32)
    ctx.set_output(slot, out)
    ctx.set_output_lod(slot, DynLoD(name, num, cap))


def _zeros_where_not(valid, x):
    """``x`` with the rows where ``valid`` ``[N]`` is False zeroed."""
    return torch.where(valid.view((-1,) + (1,) * (x.ndim - 1)), x,
                       torch.zeros_like(x))


@register_op("sequence_pool", infer_shape=_infer_ragged,
             eager_only=True, eager_dyn_ok=True)
def sequence_pool_lower(ctx):
    x = ctx.input("X")                      # [N, D]
    lod = _require_lod(ctx)
    pooltype = ctx.attr("pooltype", "AVERAGE").upper()
    st = _step_tables(ctx, x, lod)
    denom_shape = (-1,) + (1,) * (x.ndim - 1)
    if pooltype == "SUM":
        out = segment_sum(x, st.seg, st.num)
    elif pooltype in ("AVERAGE", "MEAN"):
        out = segment_sum(x, st.seg, st.num) / st.lengths.clamp(
            min=1).to(x.dtype).reshape(denom_shape)
    elif pooltype == "SQRT":
        out = segment_sum(x, st.seg, st.num) / torch.sqrt(
            st.lengths.clamp(min=1).to(x.dtype)).reshape(denom_shape)
    elif pooltype == "MAX":
        out = segment_reduce(x, st.seg, st.num, "amax", -float("inf"))
        # MaxIndex: per (sequence, feature) the first row holding the max,
        # as the reference's MaxSeqPoolFunctor stores it (a padding row,
        # in segment B, holds none)
        n = x.shape[0]
        rows = torch.arange(n, device=x.device).view(denom_shape)
        is_max = (x == out[st.seg.clamp(max=st.num - 1)]) & \
            (st.seg < st.num).view(denom_shape)
        ctx.set_output("MaxIndex", segment_reduce(
            torch.where(is_max, rows, n), st.seg, st.num, "amin",
            _EMPTY_MAX_INDEX))
    elif pooltype == "MIN":
        out = segment_reduce(x, st.seg, st.num, "amin", float("inf"))
    elif pooltype == "LAST":
        out = take_rows(x, *st.last)
    elif pooltype == "FIRST":
        out = take_rows(x, *st.first)
    else:
        raise NotImplementedError(f"sequence_pool type {pooltype}")
    ctx.set_output("Out", out)
    if not is_dyn(lod) and len(lod) > 1:
        ctx.set_output_lod("Out", _copy(lod[:-1]))


# ---------------------------------------------------------------------------
# sequence_softmax
# ---------------------------------------------------------------------------

@register_op("sequence_softmax", infer_shape=_infer_ragged,
             eager_only=True, eager_dyn_ok=True)
def sequence_softmax_lower(ctx):
    x = ctx.input("X")          # [N] or [N, 1]
    lod = _require_lod(ctx)
    flat = x.reshape(-1)
    if is_dyn(lod):
        st = dyn_segment_tables(ctx.aux, lod, ctx.env, flat.shape[0])
        safe = st.seg.clamp(max=st.num - 1)
        mx = segment_reduce(flat, st.seg, st.num, "amax", -float("inf"))
        # a padding row's exponent is 0 before the exp: no inf there,
        # and so no NaN in the grad
        z = torch.where(st.valid, flat - mx[safe], torch.zeros_like(flat))
        e = torch.where(st.valid, torch.exp(z), torch.zeros_like(flat))
        denom = segment_sum(e, st.seg, st.num)
        out = e / torch.clamp(denom[safe], min=1e-30)
        ctx.set_output("Out", out.reshape(x.shape))
        ctx.set_output_lod("Out", lod)
        return
    st = segment_tables(ctx.aux, lod, x.device)
    mx = segment_reduce(flat, st.seg, st.num, "amax", -float("inf"))
    e = torch.exp(flat - mx[st.seg])
    denom = segment_sum(e, st.seg, st.num)
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


def _dyn_expand(ctx, x, x_lod, y_lod):
    """``sequence_expand`` with a bucketed Y: a dense X's row b broadcast
    over Y's sequence b (zeros on padding rows), or a ragged X's
    sequence b repeated by Y's length b into ``B * rep_cap`` sequence
    slots, slot (b, k) empty when k is past the repeat count, the real
    rows contiguous in the reference's order."""
    if x_lod is None:
        n = ctx.input("Y").shape[0]
        st = dyn_segment_tables(ctx.aux, y_lod, ctx.env, n)
        rows = x.index_select(0, st.seg.clamp(max=st.num - 1))
        ctx.set_output("Out", _zeros_where_not(st.valid, rows))
        ctx.set_output_lod("Out", y_lod)
        return
    x_splits, bx, x_cap = _splits_of(ctx, x_lod, x.device)
    y_splits = y_lod.splits(ctx.env).long()
    rep_cap = y_lod.maxlen_bucket
    if y_lod.num_seqs != bx:
        raise ValueError(
            f"sequence_expand: X has {bx} sequences but Y has "
            f"{y_lod.num_seqs}")
    dev = x.device
    len_x = x_splits[1:] - x_splits[:-1]
    rep = y_splits[1:] - y_splits[:-1]
    n_slots = bx * rep_cap
    slot = torch.arange(n_slots, device=dev)
    slot_i, slot_k = slot // rep_cap, slot % rep_cap
    slot_len = torch.where(slot_k < rep[slot_i], len_x[slot_i], 0)
    out_splits = torch.cat([slot_len.new_zeros(1), slot_len.cumsum(0)])
    n_out = int(x.shape[0]) * rep_cap
    r = torch.arange(n_out, device=dev)
    seg = torch.searchsorted(out_splits[1:].contiguous(), r, right=True)
    seg = seg.clamp(0, max(n_slots - 1, 0))
    t = r - out_splits[seg]
    src = (x_splits[seg // rep_cap] + t).clamp(0, x.shape[0] - 1)
    out = _zeros_where_not(r < out_splits[-1], x.index_select(0, src))
    _dyn_out(ctx, "Out", out, out_splits, n_slots, x_cap)


@register_op("sequence_expand", infer_shape=_infer_ragged,
             eager_only=True, eager_dyn_ok=True)
def sequence_expand_lower(ctx):
    x = ctx.input("X")
    x_lod = ctx.input_lod("X")
    y_lod = _require_lod(ctx, "Y")
    if is_dyn(y_lod):
        _dyn_expand(ctx, x, x_lod, y_lod)
        return
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


def _dyn_concat(ctx, xs, lods, allx):
    """``sequence_concat`` where an input is bucketed: out sequence i is
    every input's sequence i in turn, gathered by a table built from the
    splits (the inputs' padded rows stacked; padding rows last)."""
    dev = allx.device
    num = next(l for l in lods if is_dyn(l)).num_seqs
    n_out = int(allx.shape[0])
    offsets = np.cumsum([0] + [int(x.shape[0]) for x in xs])
    splits_k = [_splits_of(ctx, l, dev)[0] for l in lods]
    lengths_k = [sp[1:] - sp[:-1] for sp in splits_k]
    out_lengths = sum(lengths_k)
    out_splits = torch.cat([out_lengths.new_zeros(1), out_lengths.cumsum(0)])
    r = torch.arange(n_out, device=dev)
    seg = torch.searchsorted(out_splits[1:].contiguous(), r, right=True)
    segc = seg.clamp(0, num - 1)
    pos = r - out_splits[segc]
    src = torch.zeros_like(r)
    found = torch.zeros_like(r, dtype=torch.bool)
    acc = torch.zeros_like(r)
    for k in range(len(xs)):
        lk = lengths_k[k][segc]
        in_k = (pos >= acc) & (pos < acc + lk)
        src_k = int(offsets[k]) + splits_k[k][segc] + (pos - acc)
        src = torch.where(in_k & ~found, src_k, src)
        found = found | in_k
        acc = acc + lk
    gathered = allx.index_select(0, src.clamp(0, n_out - 1))
    # each input's length bound: a bucketed one's bucket, a static one's
    # longest sequence (the bound of a loop downstream)
    cap = sum(_splits_of(ctx, l, dev)[2] for l in lods)
    _dyn_out(ctx, "Out", _zeros_where_not(r < out_splits[-1], gathered),
             out_splits, num, cap)


@register_op("sequence_concat", infer_shape=_infer_ragged,
             eager_only=True, eager_dyn_ok=True)
def sequence_concat_lower(ctx):
    xs = ctx.inputs("X")
    lods = [ctx.var_lod(n) for n in ctx.op.input("X")]
    allx = torch.cat(xs, dim=0)
    if any(l is None for l in lods):
        ctx.set_output("Out", allx)
        return
    if any(is_dyn(l) for l in lods):
        _dyn_concat(ctx, xs, lods, allx)
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
             eager_only=True, eager_dyn_ok=True)
def sequence_reshape_lower(ctx):
    x = ctx.input("X")
    lod = _require_lod(ctx)
    new_dim = ctx.attr("new_dim")
    if is_dyn(lod):
        # the splits scale by the static ratio; padding rows stay last
        num, den = x.shape[1], new_dim
        splits = torch.div(lod.splits(ctx.env).long() * num, den,
                           rounding_mode="floor")
        _dyn_out(ctx, "Out", x.reshape(-1, new_dim), splits, lod.num_seqs,
                 lod.maxlen_bucket * num // den)
        return
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


def _traced_static(ctx, lod):
    """A static LoD in a block the JAX package traces: a host op's
    bucketed branch runs over it as constant splits."""
    if not is_dyn(lod) and ctx.aux.get("traced"):
        return _ConstSplits(ctx, lod[len(lod) - 1], ctx.device)
    return lod


@register_op("sequence_slice", infer_shape=_infer_ragged,
             no_gradient=True, host=True,
             eager_only=True, eager_dyn_ok=True)
def sequence_slice_lower(ctx):
    x = ctx.input("X")
    lod = _traced_static(ctx, _require_lod(ctx))
    if is_dyn(lod):
        # the output stays padded to the input's rows; the rows move by
        # a gather built from the splits, Offset and Length
        offset = ctx.input("Offset").reshape(-1).long()
        length = ctx.input("Length").reshape(-1).long()
        splits = lod.splits(ctx.env).long()
        n = x.shape[0]
        out_splits = torch.cat([length.new_zeros(1), length.cumsum(0)])
        r = torch.arange(n, device=x.device)
        seg = torch.searchsorted(out_splits[1:].contiguous(), r,
                                 right=True)
        segc = seg.clamp(0, lod.num_seqs - 1)
        src = splits[segc] + offset[segc] + (r - out_splits[segc])
        gathered = x.index_select(0, src.clamp(0, n - 1))
        _dyn_out(ctx, "Out", _zeros_where_not(r < out_splits[-1], gathered),
                 out_splits, lod.num_seqs, lod.maxlen_bucket)
        return
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
             eager_only=True, eager_dyn_ok=True)
def sequence_erase_lower(ctx):
    """Remove the ``tokens`` ids from each sequence (the output's rows
    depend on X's values: read on the host; bucketed, the kept rows move
    forward by a stable sort and the padded row count stays)."""
    x = ctx.input("X")
    tokens = set(ctx.attr("tokens", []))
    lod = _traced_static(ctx, _require_lod(ctx))
    if is_dyn(lod):
        n = x.shape[0]
        st = dyn_segment_tables(ctx.aux, lod, ctx.env, n)
        vals = x.reshape(n, -1)[:, 0]
        keep = st.valid
        for t in sorted(tokens):
            keep = keep & (vals != t)
        # kept rows first in their order; dropped and padding rows last
        order = torch.sort((~keep).int(), stable=True).indices
        kept = keep.sum()
        gathered = x.index_select(0, order)
        per_seq = segment_sum(keep.long(), st.seg, st.num)
        out_splits = torch.cat([per_seq.new_zeros(1), per_seq.cumsum(0)])
        _dyn_out(ctx, "Out", _zeros_where_not(
            torch.arange(n, device=x.device) < kept, gathered),
            out_splits, st.num, lod.maxlen_bucket)
        return
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
             eager_only=True, eager_dyn_ok=True)
def lod_reset_lower(ctx):
    x = ctx.input("X")
    x_lod = ctx.var_lod(ctx.op.input("X")[0])
    y_lod = ctx.input_lod("Y") if ctx.op.input("Y") else None
    if is_dyn(x_lod) or is_dyn(y_lod):
        # bucketed: the rows stay, only the splits move
        ctx.set_output("Out", x)
        if is_dyn(y_lod):
            ctx.set_output_lod("Out", y_lod)    # Y's splits, shared
            return
        target = ctx.attr("target_lod", None)
        if y_lod is not None:                  # Y carries a static LoD
            splits = _const_splits(ctx, y_lod[0], x.device)
        elif ctx.op.input("Y"):                # Y holds the splits
            splits = ctx.input("Y").reshape(-1)
        elif target is not None:
            splits = _const_splits(ctx, target, x.device)
        else:
            raise ValueError("lod_reset needs target_lod or Y")
        name = ctx.op.output("Out")[0] + SPLITS_SUFFIX
        ctx.outputs[name] = splits.to(torch.int32)
        ctx.set_output_lod("Out", DynLoD(
            name, splits.shape[0] - 1,
            x_lod.maxlen_bucket if is_dyn(x_lod) else x.shape[0]))
        return
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


def _dyn_window_index(splits, num, n, ctx_len, ctx_start):
    """:func:`_window_index` from a bucketed LoD's splits: a window slot
    is live where its row lies in the same (real) sequence."""
    dev = splits.device
    rows = torch.arange(n, device=dev)
    seg = torch.searchsorted(splits[1:].contiguous(), rows, right=True)
    seg = torch.where(rows < splits[-1], seg, num)
    src = rows[:, None] + ctx_start + torch.arange(ctx_len, device=dev)
    src_c = src.clamp(0, n - 1)
    live = (src >= 0) & (src < n) & (seg[src_c] == seg[:, None]) & \
        (seg[:, None] < num)
    return torch.where(live, src_c, n)


def _context_windows(ctx, x, lod, ctx_len, ctx_start):
    """``[N, ctx_len * D]``: the window around each row, zeros past its
    sequence's ends (reference ``operators/math/context_project.h``)."""
    n = x.shape[0]
    if is_dyn(lod):
        gather = dyn_tables(
            ctx.aux, "window", lod, ctx.env,
            lambda sp: _dyn_window_index(sp, lod.num_seqs, n, ctx_len,
                                         ctx_start), n, ctx_len, ctx_start)
    else:
        gather = _index(ctx, "window", lod, x.device,
                        lambda: _window_index(lod, n, ctx_len, ctx_start),
                        ctx_len, ctx_start)
    padded = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    return padded[gather].reshape(n, -1)


@register_op("sequence_conv", infer_shape=_infer_seq_conv,
             eager_only=True, eager_dyn_ok=True)
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
    ctx.set_output_lod("Out", lod if is_dyn(lod) else _copy(lod))


def _infer_seq_context(op, block):
    x = block.var(op.input("X")[0])
    out = block.var(op.output("Out")[0])
    if x.shape is None:
        raise ShapeInferenceSkip()
    out.shape = (x.shape[0], x.shape[1] * op.attr("contextLength"))
    out.dtype = x.dtype
    out.lod_level = x.lod_level


@register_op("sequence_context", infer_shape=_infer_seq_context,
             eager_only=True, eager_dyn_ok=True)
def sequence_context_lower(ctx):
    """The context windows without weights (the legacy DSL's
    ``context_projection``)."""
    x = ctx.input("X")
    lod = _require_lod(ctx)
    ctx_len = ctx.attr("contextLength")
    ctx_start = ctx.attr("contextStart", -((ctx_len - 1) // 2))
    ctx.set_output("Out", _context_windows(ctx, x, lod, ctx_len, ctx_start))
    ctx.set_output_lod("Out", lod if is_dyn(lod) else _copy(lod))


def _step_tables(ctx, x, lod=None):
    """The segment tables of X's LoD: from the splits on the device for
    a bucketed one (padding rows in segment B), else the host-made
    ones."""
    lod = _require_lod(ctx) if lod is None else lod
    if is_dyn(lod):
        return dyn_segment_tables(ctx.aux, lod, ctx.env, x.shape[0])
    return segment_tables(ctx.aux, lod, x.device)


@register_op("sequence_first_step", infer_shape=_infer_ragged,
             eager_only=True, eager_dyn_ok=True)
def sequence_first_step_lower(ctx):
    x = ctx.input("X")
    ctx.set_output("Out", take_rows(x, *_step_tables(ctx, x).first))


@register_op("sequence_last_step", infer_shape=_infer_ragged,
             eager_only=True, eager_dyn_ok=True)
def sequence_last_step_lower(ctx):
    x = ctx.input("X")
    ctx.set_output("Out", take_rows(x, *_step_tables(ctx, x).last))


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
