"""Control-flow ops, tensor arrays and the LoD rank-table plumbing of the
dynamic RNN (the port of ``paddle_tpu.ops.control_flow_ops``; reference
``paddle/fluid/operators/while_op.cc``, ``conditional_block_op.cc``,
``tensor_array_read_write_op.cc``, ``lod_rank_table_op.cc``,
``lod_tensor_to_array_op.cc``, ``shrink_rnn_memory_op.cc``,
``recurrent_op.cc``).

The port runs eagerly, so control flow is Python control flow:

* ``while`` is a Python loop over its sub-block (``aux["lower_block"]``)
  that reads its condition on the host once a trip
  (``registry.host_scalar``; an array read or write reads its index
  too: one device sync each on the card).  Only the loop carries (the
  names the body writes that exist before the loop, and the arrays it
  first writes) go back to the outer env.  ``max_iters``, else the
  largest capacity of an array the body reads, bounds the trips; a loop
  still true after them raises ``RuntimeError``.  Its grad is the
  auto-vjp of this lowering, re-run from the pre-loop values the forward
  leaves in ``aux["env_snapshots"]``, and from the RNG counter its
  forward started at, so a dropout in the body draws the forward's masks.
* A tensor array is a Python list of step tensors and a capacity
  (:class:`TensorArray`, a pytree): a write copies the list, not the
  steps.  A write or read past the capacity raises (the JAX package
  clamps the index to ``capacity - 1``).
* As in the JAX package (not Fluid), the dynamic RNN keeps the whole
  sorted batch at every step: ``lod_tensor_to_array`` zero-fills the
  steps past a sequence's end and ``shrink_rnn_memory`` is a mask.
  Rank tables are host metadata (:class:`RankTable`), static LoD only.
* ``conditional_block`` reads its predicate on the host and runs the
  branch or keeps the old values; ``split_lod_tensor`` /
  ``merge_lod_tensor`` hand both branches the full batch and the merge
  picks rows by the mask; ``recurrent`` (StaticRNN) is a Python loop over
  time.

Every op here but ``recurrent`` (a fixed number of steps, nothing read
on the host) is ``eager_only``: it reads the device on the host or
copies host tables to it, so its block runs outside a CUDA graph.

Bucketed LoD (``lod.DynLoD``): ``lod_rank_table`` makes a
:class:`DynRankTable` (the JAX package's, ``paddle_tpu/ops/
control_flow_ops.py:463``): the original order, the whole batch, the
splits on the device; ``max_sequence_len``, ``lod_tensor_to_array``
(an array of ``T_bucket`` steps), ``array_to_lod_tensor`` (the padded
rows back, the same splits), ``shrink_rnn_memory`` (a mask by the
runtime lengths) and ``reorder_lod_tensor_by_rank`` (the identity) read
it with torch ops, and are ``eager_dyn_ok``.  ``while`` still reads its
condition on the host each trip, so a bucketed DynamicRNN's block stays
eager.
"""

from __future__ import annotations

import collections

import numpy as np
import torch
import torch.utils._pytree as _pytree

from paddle_tpu_torch.lod import SPLITS_SUFFIX, DynLoD, is_dyn, tables
from paddle_tpu_torch.ops.registry import (
    ShapeInferenceSkip, host_scalar, infer_shape_unary, register_op,
    remember_rng_start)

__all__ = ["TensorArray", "RankTable", "DynRankTable",
           "DEFAULT_ARRAY_CAPACITY"]

DEFAULT_ARRAY_CAPACITY = 128


# ---------------------------------------------------------------------------
# TensorArray runtime value
# ---------------------------------------------------------------------------

class TensorArray:
    """The reference's ``LoDTensorArray``: a list of step tensors (index
    -> tensor) and a ``capacity``, the number of steps it may hold (the
    JAX package's buffer rows; ``_static_trip_bound`` reads it)."""

    def __init__(self, steps=(), capacity=DEFAULT_ARRAY_CAPACITY):
        self.steps = list(steps)
        self.capacity = int(capacity)

    @property
    def length(self):
        return len(self.steps)

    def like(self, steps):
        """An array of ``steps`` with this one's capacity."""
        return TensorArray(steps, self.capacity)

    def _check(self, index, what):
        if not 0 <= index < self.capacity:
            raise IndexError(
                f"TensorArray {what} at index {index}: outside its capacity "
                f"of {self.capacity} steps (the JAX package clamps the index "
                f"to capacity - 1 and overwrites that step); set a larger "
                f"'capacity' on the write_to_array op")

    def write(self, index, value):
        """A new array with ``value`` at ``index``; the steps between the
        old length and ``index`` are zeros, as the JAX buffer holds."""
        self._check(index, "write")
        if self.steps and value.dtype != self.steps[0].dtype:
            raise TypeError(f"TensorArray write: value dtype {value.dtype} "
                            f"!= the array's {self.steps[0].dtype}")
        steps = list(self.steps)
        while len(steps) < index:
            steps.append(torch.zeros_like(value))
        if index < len(steps):
            steps[index] = value
        else:
            steps.append(value)
        return self.like(steps)

    def read(self, index):
        """The step at ``index``; zeros for a step not written yet."""
        self._check(index, "read")
        if index < len(self.steps):
            return self.steps[index]
        if not self.steps:
            raise IndexError("read from an empty TensorArray")
        return torch.zeros_like(self.steps[0])

    def __add__(self, other):
        """Step-by-step sum (the ``sum`` of two array grads); a step one
        of them lacks counts as zero."""
        n = max(len(self.steps), len(other.steps))
        steps = []
        for i in range(n):
            a = self.steps[i] if i < len(self.steps) else None
            b = other.steps[i] if i < len(other.steps) else None
            steps.append(b if a is None else a if b is None else a + b)
        return TensorArray(steps, max(self.capacity, other.capacity))

    def __repr__(self):
        return (f"TensorArray(length={self.length}, "
                f"capacity={self.capacity})")


_register = getattr(_pytree, "register_pytree_node", None) or \
    _pytree._register_pytree_node
_register(TensorArray, lambda a: (list(a.steps), a.capacity),
          lambda steps, capacity: TensorArray(steps, capacity))


def _lookup(env, name):
    """``env[name]`` if the env (or, through it, the scope) holds it, else
    None."""
    try:
        return env[name]
    except (KeyError, RuntimeError):
        return None


def _infer_skip(op, block):
    raise ShapeInferenceSkip()


# ---------------------------------------------------------------------------
# array read / write / length  (tensor_array_read_write_op.cc)
# ---------------------------------------------------------------------------

@register_op("write_to_array", infer_shape=infer_shape_unary("X"),
             no_grad_inputs=("I",),
             eager_only=True)
def write_to_array_lower(ctx):
    out_name = ctx.op.output("Out")[0]
    arr = ctx.env.get(out_name)
    if not isinstance(arr, TensorArray):
        arr = TensorArray(capacity=ctx.attr("capacity",
                                            DEFAULT_ARRAY_CAPACITY))
    ctx.outputs[out_name] = arr.write(int(ctx.host_scalar("I")),
                                      ctx.input("X"))


@register_op("read_from_array", infer_shape=infer_shape_unary("X"),
             no_grad_inputs=("I",),
             eager_only=True)
def read_from_array_lower(ctx):
    arr = ctx.input("X")
    if not isinstance(arr, TensorArray):
        raise TypeError("read_from_array input is not a TensorArray")
    ctx.set_output("Out", arr.read(int(ctx.host_scalar("I"))))


@register_op("lod_array_length", infer_shape=_infer_skip, no_gradient=True,
             eager_only=True)
def lod_array_length_lower(ctx):
    n = ctx.input("X").length
    ctx.set_output("Out", torch.tensor([n], dtype=torch.int64,
                                       device=ctx.device))


# ---------------------------------------------------------------------------
# while  (while_op.cc)
# ---------------------------------------------------------------------------

def _sub_blocks(op):
    return [a for a in op.attrs.values() if hasattr(a, "ops")]


def _collect_written(block):
    """Every name the ops of ``block`` (and its nested blocks) write."""
    names = []
    for op in block.ops:
        for n in op.output_arg_names:
            if n and n not in names:
                names.append(n)
        for sub in _sub_blocks(op):
            for n in _collect_written(sub):
                if n not in names:
                    names.append(n)
    return names


def _array_outs(block):
    """``{name: capacity}`` of the arrays ``write_to_array`` ops of
    ``block`` (recursively) write."""
    out = {}
    for op in block.ops:
        if op.type == "write_to_array":
            for n in op.output("Out"):
                if n:
                    out.setdefault(n, op.attr("capacity",
                                              DEFAULT_ARRAY_CAPACITY))
        for sub in _sub_blocks(op):
            for n, cap in _array_outs(sub).items():
                out.setdefault(n, cap)
    return out


def _static_trip_bound(block, env):
    """The largest capacity of a TensorArray read in the loop body (None
    when it reads none)."""
    bound = None
    for op in block.ops:
        if op.type == "read_from_array":
            arr = env.get(op.input("X")[0])
            if isinstance(arr, TensorArray):
                bound = arr.capacity if bound is None else \
                    max(bound, arr.capacity)
        for sub in _sub_blocks(op):
            b = _static_trip_bound(sub, env)
            if b is not None:
                bound = b if bound is None else max(bound, b)
    return bound


def _truth(aux, value):
    """A condition on the host: a one-element tensor's value, else
    whether every element is true (one counted read either way)."""
    if value.numel() == 1:
        return bool(host_scalar(aux, value))
    aux["host_reads"] = aux.get("host_reads", 0) + 1
    return bool(value.all())


@register_op("while", infer_shape=_infer_skip, no_grad_inputs=("Condition",),
             eager_only=True)
def while_lower(ctx):
    """Run the sub-block while the condition holds (see the module
    docstring); the carries go to ``ctx.outputs``."""
    sub_block = ctx.attr("sub_block")
    cond_name = ctx.op.input("Condition")[0]
    pre = {}
    for n in _collect_written(sub_block):
        v = _lookup(ctx.env, n)
        if v is not None:
            pre[n] = v
    # an array the body writes first: an empty one, so that it is a carry
    for n, cap in _array_outs(sub_block).items():
        pre.setdefault(n, TensorArray(capacity=cap))
    pre[cond_name] = ctx.env[cond_name]
    # at backward time the env holds the final carries (the condition
    # false): the grad op re-runs the loop from these pre-loop values
    ctx.aux.setdefault("env_snapshots", {}).setdefault(id(sub_block), pre)
    remember_rng_start(ctx.aux, sub_block)

    env = collections.ChainMap(dict(pre), ctx.env)
    bound = ctx.attr("max_iters", None)
    if bound is None:
        bound = _static_trip_bound(sub_block, env)
    lower_block = ctx.aux["lower_block"]
    trips = 0
    while _truth(ctx.aux, env[cond_name]):
        if bound is not None and trips >= int(bound):
            raise RuntimeError(
                f"while loop did not terminate within its static trip bound "
                f"of {int(bound)} iterations (inferred from TensorArray "
                f"capacity or the 'max_iters' attr); raise 'max_iters' on "
                f"the while op")
        lower_block(sub_block, env, ctx.aux)
        trips += 1
    ctx.aux["while_trips"] = ctx.aux.get("while_trips", 0) + trips
    for n in pre:
        ctx.outputs[n] = env[n]


# ---------------------------------------------------------------------------
# conditional_block  (conditional_block_op.cc)
# ---------------------------------------------------------------------------

@register_op("conditional_block", infer_shape=_infer_skip, no_gradient=True,
             eager_only=True)
def conditional_block_lower(ctx):
    """Run the branch when every element of every condition holds (read
    on the host); else keep each output's old value, or zeros of the
    branch's shape for an output without one."""
    conds = ctx.inputs("Cond") if ctx.op.input("Cond") else ctx.inputs("X")
    pred = all(_truth(ctx.aux, c) for c in conds)
    out_names = [n for n in ctx.op.output("Out") if n]
    old = {n: _lookup(ctx.env, n) for n in out_names}
    env = collections.ChainMap({}, ctx.env)
    if pred or any(v is None for v in old.values()):
        ctx.aux["lower_block"](ctx.attr("sub_block"), env, ctx.aux)
    for n in out_names:
        if pred:
            ctx.outputs[n] = env[n]
        else:
            ctx.outputs[n] = old[n] if old[n] is not None else \
                torch.zeros_like(env[n])


# ---------------------------------------------------------------------------
# split / merge_lod_tensor  (IfElse batch routing, split_lod_tensor_op.cc)
# ---------------------------------------------------------------------------

@register_op("split_lod_tensor", infer_shape=_infer_skip, no_gradient=True,
             eager_only=True)
def split_lod_tensor_lower(ctx):
    """Both branches see the whole batch (the merge picks the rows)."""
    x = ctx.input("X")
    ctx.set_output("OutTrue", x)
    ctx.set_output("OutFalse", x)


@register_op("merge_lod_tensor", infer_shape=infer_shape_unary("InTrue"),
             no_grad_inputs=("Mask",),
             eager_only=True)
def merge_lod_tensor_lower(ctx):
    in_true = ctx.input("InTrue")
    mask = ctx.input("Mask").reshape((-1,) + (1,) * (in_true.ndim - 1))
    ctx.set_output("Out", torch.where(mask.bool(), in_true,
                                      ctx.input("InFalse")))


# ---------------------------------------------------------------------------
# LoD rank table machinery (lod_rank_table_op.cc, lod_tensor_to_array_op.cc)
# ---------------------------------------------------------------------------

class RankTable:
    """Sequence ``(index, length)`` pairs by decreasing length, ties in
    their original order (reference ``LoDRankTable``, lod_rank_table.h):
    host metadata."""

    def __init__(self, items):
        self.items = [(int(i), int(n)) for i, n in items]

    @property
    def lengths(self):
        return [n for _, n in self.items]

    @property
    def indices(self):
        return [i for i, _ in self.items]

    def key(self):
        return tuple(self.items)


class DynRankTable:
    """A rank table over runtime lengths (the bucketed LoD mode): a
    device sort is neither possible without a sync nor needed, since
    every step keeps the whole batch and masks by length, so the table
    keeps the ORIGINAL order and carries the splits (int64 ``[B + 1]``
    on the device), the sequence count, the length bucket ``cap`` and
    the padded rows ``n_rows`` of its input."""

    def __init__(self, splits, num_seqs, cap, n_rows):
        self.splits = splits
        self.num_seqs = int(num_seqs)
        self.cap = int(cap)
        self.n_rows = int(n_rows)

    @property
    def lengths_arr(self):
        return self.splits[1:] - self.splits[:-1]


def _table_tensor(ctx, kind, table, build):
    """The ``kind`` index tensor of ``table`` on the run's device:
    ``build()`` (numpy) once per run, as ``lod.tables`` caches LoD
    tables."""
    cache = ctx.aux.setdefault("lod_tables", {})
    key = (kind, table.key(), str(ctx.device))
    t = cache.get(key)
    if t is None:
        t = cache[key] = torch.as_tensor(build(), device=ctx.device)
    return t


@register_op("lod_rank_table", infer_shape=_infer_skip, no_gradient=True,
             eager_only=True, eager_dyn_ok=True)
def lod_rank_table_lower(ctx):
    lod = ctx.input_lod("X")
    level = ctx.attr("level", 0)
    if is_dyn(lod):
        if level != 0:
            raise NotImplementedError(
                "lod_rank_table over a non-zero lod level is not "
                "supported in bucketed dynamic-LoD mode — the bucketed "
                "feed carries a single (deepest) level of row splits")
        ctx.outputs[ctx.op.output("Out")[0]] = DynRankTable(
            lod.splits(ctx.env).long(), lod.num_seqs, lod.maxlen_bucket,
            ctx.input("X").shape[0])
        return
    if lod is None:
        # dense [B, T, ...]: every row has length T
        x = ctx.input("X")
        lengths = [x.shape[1] if x.ndim > 1 else 1] * x.shape[0]
    else:
        splits = lod[level]
        lengths = [b - a for a, b in zip(splits, splits[1:])]
    # Python's sort is stable: equal lengths keep their order
    ctx.outputs[ctx.op.output("Out")[0]] = RankTable(
        sorted(enumerate(lengths), key=lambda p: -p[1]))


@register_op("max_sequence_len", infer_shape=_infer_skip, no_gradient=True,
             eager_only=True, eager_dyn_ok=True)
def max_sequence_len_lower(ctx):
    table = ctx.input("RankTable")
    if isinstance(table, DynRankTable):
        ctx.set_output("Out", table.lengths_arr.max().reshape(1))
        return
    n = max(table.lengths)
    ctx.set_output("Out", torch.tensor([n], dtype=torch.int64,
                                       device=ctx.device))


@register_op("lod_tensor_to_array", infer_shape=infer_shape_unary("X"),
             no_grad_inputs=("RankTable",),
             eager_only=True, eager_dyn_ok=True)
def lod_tensor_to_array_lower(ctx):
    """Ragged ``[sum(T_i), ...]`` and a rank table -> a TensorArray of
    ``T`` time steps, each ``[B, ...]`` over the whole sorted batch, zero
    rows past a sequence's end; its capacity is ``T``.  From a
    :class:`DynRankTable`: ``T`` is the length bucket, the batch in its
    original order, one gather ``[T, B]`` from the splits."""
    x = ctx.input("X")
    table = ctx.input("RankTable")
    if isinstance(table, DynRankTable):
        ts = torch.arange(table.cap, device=x.device)[:, None]
        idx = (table.splits[:-1][None, :] + ts).clamp(0, x.shape[0] - 1)
        live = (ts < table.lengths_arr[None, :]).to(x.dtype)
        data = x.index_select(0, idx.reshape(-1)).reshape(
            tuple(idx.shape) + tuple(x.shape[1:]))
        data = data * live.reshape(tuple(live.shape) + (1,) * (x.ndim - 1))
        ctx.outputs[ctx.op.output("Out")[0]] = TensorArray(
            list(data.unbind(0)), table.cap)
        return
    lod = ctx.input_lod("X")
    lengths, indices = table.lengths, table.indices
    T, B = (max(lengths) if lengths else 0), len(lengths)
    out_name = ctx.op.output("Out")[0]
    if lod is None:
        # dense [B, T, ...]: rows in rank-table order
        rows = x.index_select(0, _table_tensor(
            ctx, "rank_rows", table, lambda: np.asarray(indices, np.int64)))
        ctx.outputs[out_name] = TensorArray(
            [rows[:, t] for t in range(T)], T)
        return
    splits = lod[0]
    n = x.shape[0]

    def build():
        t = np.arange(T)[:, None]
        starts = np.asarray([splits[i] for i in indices], np.int64)
        live = t < np.asarray(lengths)[None, :]
        return np.where(live, starts[None, :] + t, n).reshape(-1)

    idx = tables(ctx.aux, "to_array", lod, ctx.device,
                 lambda: torch.as_tensor(build(), device=ctx.device),
                 table.key())
    padded = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    steps = padded.index_select(0, idx).reshape(
        (T, B) + tuple(x.shape[1:]))
    ctx.outputs[out_name] = TensorArray(list(steps.unbind(0)), T)


@register_op("array_to_lod_tensor", infer_shape=infer_shape_unary("X"),
             no_grad_inputs=("RankTable",),
             eager_only=True, eager_dyn_ok=True)
def array_to_lod_tensor_lower(ctx):
    """Inverse of ``lod_tensor_to_array``: the steps' rows back to ragged
    ``[sum(T_i), ...]`` in the original sequence order, with that LoD.
    From a :class:`DynRankTable`: the table's padded rows, zeros past the
    last split, with the table's splits as ``<Out>@lod0``."""
    arr = ctx.input("X")
    table = ctx.input("RankTable")
    if isinstance(table, DynRankTable):
        data = torch.stack(arr.steps)                 # [L, B, ...]
        L, B = data.shape[0], data.shape[1]
        splits = table.splits
        r = torch.arange(table.n_rows, device=data.device)
        seg = torch.searchsorted(splits[1:].contiguous(), r, right=True)
        seg = seg.clamp(0, table.num_seqs - 1)
        t = (r - splits[seg]).clamp(0, L - 1)
        rows = data.reshape((L * B,) + tuple(data.shape[2:])).index_select(
            0, t * B + seg)
        valid = (r < splits[-1]).view((-1,) + (1,) * (rows.ndim - 1))
        ctx.set_output("Out", torch.where(valid, rows,
                                          torch.zeros_like(rows)))
        name = ctx.op.output("Out")[0] + SPLITS_SUFFIX
        ctx.outputs[name] = splits.to(torch.int32)
        ctx.set_output_lod("Out", DynLoD(name, table.num_seqs, table.cap))
        return
    lengths, indices = table.lengths, table.indices
    B, T = len(indices), max(lengths)
    order = sorted(range(B), key=lambda b: indices[b])

    def build():
        return np.asarray([t * B + b for b in order
                           for t in range(lengths[b])], np.int64)

    idx = _table_tensor(ctx, "from_array", table, build)
    data = torch.stack(arr.steps[:T])
    ctx.set_output("Out", data.reshape((T * B,) + tuple(data.shape[2:]))
                   .index_select(0, idx))
    splits = [0]
    for b in order:
        splits.append(splits[-1] + lengths[b])
    ctx.set_output_lod("Out", [splits])


@register_op("shrink_rnn_memory", infer_shape=infer_shape_unary("X"),
             no_grad_inputs=("RankTable", "I"),
             eager_only=True, eager_dyn_ok=True)
def shrink_rnn_memory_lower(ctx):
    """The reference shrinks the memory to the still-live prefix of the
    sorted batch; here the rows of finished sequences are zeroed."""
    x = ctx.input("X")
    table = ctx.input("RankTable")
    if isinstance(table, DynRankTable):
        lengths = table.lengths_arr
    else:
        lengths = _table_tensor(ctx, "rank_lengths", table,
                                lambda: np.asarray(table.lengths, np.int64))
    live = lengths > ctx.input("I").reshape(())
    ctx.set_output("Out", x * live.to(x.dtype).reshape(
        (x.shape[0],) + (1,) * (x.ndim - 1)))


@register_op("reorder_lod_tensor_by_rank",
             infer_shape=infer_shape_unary("X"),
             no_grad_inputs=("RankTable",),
             eager_only=True, eager_dyn_ok=True)
def reorder_lod_tensor_by_rank_lower(ctx):
    x = ctx.input("X")
    table = ctx.input("RankTable")
    if isinstance(table, DynRankTable):
        # a dynamic table keeps the original order: the identity
        ctx.set_output("Out", x)
        return
    lod = ctx.input_lod("X")
    if lod is None:
        # dense [B, ...]: one row per sequence
        ctx.set_output("Out", x.index_select(0, _table_tensor(
            ctx, "rank_rows", table,
            lambda: np.asarray(table.indices, np.int64))))
        return
    if len(lod) > 1:
        raise NotImplementedError(
            "reorder_lod_tensor_by_rank over a nested (multi-level) LoD "
            "tensor: level-0 splits index level-1 entries, not rows — "
            "flatten the nesting (sequence_reshape / sub_nested_seq) "
            "before reordering")
    # whole sub-sequences move into rank-table order
    splits = lod[0]
    rows, new_splits = [], [0]
    for i in table.indices:
        rows.extend(range(splits[i], splits[i + 1]))
        new_splits.append(len(rows))
    idx = tables(ctx.aux, "reorder", lod, ctx.device,
                 lambda: torch.as_tensor(np.asarray(rows, np.int64),
                                         device=ctx.device), table.key())
    ctx.set_output("Out", x.index_select(0, idx))
    ctx.set_output_lod("Out", [new_splits])


# ---------------------------------------------------------------------------
# recurrent (StaticRNN) — a Python loop over time
# ---------------------------------------------------------------------------

@register_op("recurrent", infer_shape=_infer_skip)
def recurrent_lower(ctx):
    """StaticRNN (reference ``recurrent_op.cc:222``): run the sub-block
    once per step of the time axis (axis 1 of the ``[B, T, ...]`` step
    inputs), the memories carried; the step outputs stack on axis 1.

    attrs: sub_block, step_inputs (outer name -> step name), memories
    ``[{pre, mem, init}]``, step_outputs (step name -> outer name)."""
    sub_block = ctx.attr("sub_block")
    step_inputs = ctx.attr("step_inputs")
    memories = ctx.attr("memories")
    step_outputs = ctx.attr("step_outputs")
    xs = {sn: ctx.env[on] for on, sn in step_inputs.items()}
    T = next(iter(xs.values())).shape[1]
    carry = [ctx.env[m["init"]] for m in memories]
    outs = {sn: [] for sn in step_outputs}
    remember_rng_start(ctx.aux, sub_block)
    for t in range(T):
        env = collections.ChainMap({}, ctx.env)
        for m, c in zip(memories, carry):
            env[m["pre"]] = c
        for sn, x in xs.items():
            env[sn] = x[:, t]
        ctx.aux["lower_block"](sub_block, env, ctx.aux)
        carry = [env[m["mem"]] for m in memories]
        for sn in step_outputs:
            outs[sn].append(env[sn])
    for sn, outer in step_outputs.items():
        ctx.outputs[outer] = torch.stack(outs[sn], 1)
    for m, c in zip(memories, carry):
        ctx.outputs[m["mem"] + "@FINAL"] = c
