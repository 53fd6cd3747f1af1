"""Control-flow ops, tensor arrays and the LoD rank-table plumbing of the
dynamic RNN (the port of ``paddle_tpu.ops.control_flow_ops``; reference
``paddle/fluid/operators/while_op.cc``, ``conditional_block_op.cc``,
``tensor_array_read_write_op.cc``, ``lod_rank_table_op.cc``,
``lod_tensor_to_array_op.cc``, ``shrink_rnn_memory_op.cc``,
``recurrent_op.cc``).

The JAX package's static-shape designs, run as a fixed sequence of
device ops, so that a block holding them can be captured in a CUDA
graph:

* A tensor array (:class:`TensorArray`, a pytree) is a ``[capacity,
  *elem]`` buffer on the device and a device ``length``, made at its
  first write, when the element's shape and dtype are known.  A write
  takes the index as a device tensor and, inside a loop body or a
  branch, the ``aux["loop_keep"]`` gate, which turns it into a row-level
  no-op (the JAX package's ``TensorArray.write``); a read is an
  ``index_select``.  Inside a loop or a branch a write changes the
  buffer IN PLACE: the loop clones each array it carries once at entry
  (the pre-loop value stays intact for the grad's re-run), never once a
  trip, since a copy a trip would cost O(capacity²) bytes (a loop or
  branch nested in one copies nothing: the writes go into the outer
  one's buffers).  Elsewhere a write copies the buffer.  An index
  outside the capacity reads or writes the clamped step (as the JAX
  package does) and records the index in the step's device fault word
  (``registry.record_range_fault``, compared once after the step); the
  executor raises ``IndexError``.
* ``while`` with a trip bound (the ``max_iters`` attr, else
  :func:`_static_trip_bound`) runs exactly ``bound`` trips of its
  sub-block in a Python loop that reads nothing from the device (the
  JAX package's bounded ``lax.scan`` with a done-mask): each trip's
  ``keep`` is the condition and the enclosing loop's keep, carries are
  merged with ``torch.where(keep, new, old)`` and array rows are gated
  inside their writes.  A loop still true after ``bound`` trips sets a
  fault and raises the reference's ``RuntimeError`` after the step.
  Only the loop carries (the names the body writes that exist before the
  loop, and the arrays it first writes) go back to the outer env.  Its
  grad is the auto-vjp of this lowering, the same bounded loop re-run
  from the pre-loop values the forward leaves in
  ``aux["env_snapshots"]``, and from the RNG counter its forward started
  at, so a dropout in the body draws the forward's masks.  A loop
  without a bound reads its condition on the host once a trip
  (``registry.host_scalar``) and is ``eager_only``.
* ``conditional_block`` always runs its branch and selects its outputs
  with ``torch.where(pred, new, old)`` (zeros of the branch's shape for
  an output without an old value), the JAX package's ``lax.cond``; an
  array write in the branch is gated as in a loop.  A branch with an op
  that must not run untaken (:func:`_not_pure`: a state update, a host
  op such as ``print``) reads its predicate (and an enclosing loop's
  keep) on the host and is ``eager_only``.  ``split_lod_tensor`` /
  ``merge_lod_tensor`` hand both branches the full batch and the merge
  picks rows by the mask.
* As in the JAX package (not Fluid), the dynamic RNN keeps the whole
  sorted batch at every step: ``lod_tensor_to_array`` zero-fills the
  steps past a sequence's end and ``shrink_rnn_memory`` is a mask.
  Rank tables are host metadata (:class:`RankTable`), static LoD only,
  and the ops that copy their tables to the device are ``eager_only``;
  ``recurrent`` (StaticRNN) is a Python loop over time.

Bucketed LoD (``lod.DynLoD``): ``lod_rank_table`` makes a
:class:`DynRankTable` (the JAX package's, ``paddle_tpu/ops/
control_flow_ops.py:463``): the original order, the whole batch, the
splits on the device; ``max_sequence_len``, ``lod_tensor_to_array``
(an array of ``T_bucket`` steps), ``array_to_lod_tensor`` (the padded
rows back, the same splits), ``shrink_rnn_memory`` (a mask by the
runtime lengths) and ``reorder_lod_tensor_by_rank`` (the identity) read
it with torch ops, and are ``eager_dyn_ok``: a bucketed DynamicRNN, its
``while`` bounded by the step array's ``T_bucket``, runs as one graph.
"""

from __future__ import annotations

import collections
import contextlib

import numpy as np
import torch
import torch.utils._pytree as _pytree

from paddle_tpu_torch.lod import SPLITS_SUFFIX, DynLoD, is_dyn, tables
from paddle_tpu_torch.ops.registry import (
    ShapeInferenceSkip, host_scalar, infer_shape_unary, lookup,
    eager_only, record_fault, record_range_fault, register_op,
    remember_rng_start)

__all__ = ["TensorArray", "RankTable", "DynRankTable",
           "DEFAULT_ARRAY_CAPACITY"]

DEFAULT_ARRAY_CAPACITY = 128


# ---------------------------------------------------------------------------
# TensorArray runtime value
# ---------------------------------------------------------------------------

def _capacity_message(what, capacity):
    return (f"TensorArray {what} outside its capacity of {capacity} steps "
            f"(the JAX package clamps the index to capacity - 1 and "
            f"overwrites that step); set a larger 'capacity' on the "
            f"write_to_array op")


class TensorArray:
    """The reference's ``LoDTensorArray`` as the JAX package holds it: a
    ``data`` buffer ``[capacity, *elem]`` and a device ``length`` (int64,
    the high-water mark of the writes), both None until the first
    write."""

    def __init__(self, data=None, length=None,
                 capacity=DEFAULT_ARRAY_CAPACITY):
        self.data = data
        self.length = length
        self.capacity = int(capacity if data is None else data.shape[0])

    def with_data(self, data):
        """This array with another buffer of the same shape."""
        return TensorArray(data, self.length, self.capacity)

    def owned(self):
        """A copy whose buffer a loop or a branch may write in place."""
        if self.data is None:
            return self
        return TensorArray(self.data.clone(), self.length, self.capacity)

    def _row(self, index, what, aux):
        """The index clamped into the buffer (a 0-d tensor of the index's
        dtype); an index outside the capacity records a fault."""
        record_range_fault(aux, IndexError,
                           _capacity_message(what, self.capacity), index,
                           self.capacity)
        return index.reshape(()).clamp(0, self.capacity - 1)

    def write(self, index, value, aux, keep=None, in_place=False):
        """This array with ``value`` at the device ``index``; a write
        that ``keep`` (a bool tensor) turns off leaves the row and the
        length as they were.  An index outside the capacity writes the
        clamped row and records a fault, so the step raises.
        ``in_place`` writes into this buffer (a fresh buffer always
        is)."""
        data, length = self.data, self.length
        if data is None:
            data = value.new_zeros((self.capacity,) + tuple(value.shape))
            length = torch.zeros((), dtype=torch.int64,
                                 device=value.device)
            in_place = True
        elif value.dtype != data.dtype:
            raise TypeError(f"TensorArray write: value dtype {value.dtype} "
                            f"!= the array's {data.dtype}")
        # index_put_ takes an int32 index as it is (index_copy_ would
        # need a copy to int64 each write)
        row = self._row(index, "write", aux)
        at = (row.reshape(1),)
        new = value if keep is None else \
            torch.where(keep, value, data.index_select(0, at[0])[0])
        data = data.index_put_(at, new[None]) if in_place else \
            data.index_put(at, new[None])
        grown = torch.maximum(length, row + 1)
        return TensorArray(data, grown if keep is None else
                           torch.where(keep, grown, length), self.capacity)

    def read(self, index, aux):
        """The step at the device ``index`` (zeros for a step not written
        yet); an index outside the capacity reads the clamped step and
        records a fault."""
        if self.data is None:
            raise IndexError("read from an empty TensorArray")
        row = self._row(index, "read", aux)
        return self.data.index_select(0, row.reshape(1))[0]

    def __add__(self, other):
        """The sum of two array grads, buffer by buffer (a shorter buffer
        padded with zero steps, an unwritten one zero)."""
        if self.data is None:
            return other
        if other.data is None:
            return self
        a, b = self.data, other.data
        n = max(a.shape[0], b.shape[0])
        a, b = (torch.cat([t, t.new_zeros((n - t.shape[0],) +
                                          tuple(t.shape[1:]))])
                if t.shape[0] < n else t for t in (a, b))
        return TensorArray(a + b, torch.maximum(self.length, other.length))

    def __repr__(self):
        elem = None if self.data is None else tuple(self.data.shape[1:])
        return f"TensorArray(capacity={self.capacity}, elem={elem})"


def _flatten(a):
    children = [] if a.data is None else [a.data, a.length]
    return children, (a.capacity, a.data is not None)


def _unflatten(children, context):
    capacity, made = context
    return TensorArray(*children, capacity=capacity) if made else \
        TensorArray(capacity=capacity)


_register = getattr(_pytree, "register_pytree_node", None) or \
    _pytree._register_pytree_node
_register(TensorArray, _flatten, _unflatten)


def _lookup(env, name):
    """``env[name]`` if the env (or, through it, the scope) holds it, else
    None."""
    try:
        return env[name]
    except (KeyError, RuntimeError):
        return None


def _infer_skip(op, block):
    raise ShapeInferenceSkip()


@contextlib.contextmanager
def _gated(aux, keep):
    """Run a loop body or a branch under ``keep``: its array writes are
    gated by it and change their (owned) buffers in place, and its
    faults count only where it holds."""
    saved = aux.get("loop_keep"), aux.get("arrays_in_place")
    aux["loop_keep"], aux["arrays_in_place"] = keep, True
    try:
        yield
    finally:
        aux["loop_keep"], aux["arrays_in_place"] = saved


def _own_arrays(values, aux):
    """The arrays among ``values`` as buffers a loop body or a branch may
    write in place: copies, made once at the loop's or the branch's
    entry, unless an enclosing loop or branch already owns them (then the
    writes go into its buffers, and a nested loop or branch copies
    nothing a trip)."""
    if aux.get("arrays_in_place"):
        return {}
    return {n: v.owned() for n, v in values.items()
            if isinstance(v, TensorArray)}


def _all(value):
    """A condition as a 0-d bool tensor: whether every element holds."""
    return value.reshape(-1).all()


# ---------------------------------------------------------------------------
# array read / write / length  (tensor_array_read_write_op.cc)
# ---------------------------------------------------------------------------

@register_op("write_to_array", infer_shape=infer_shape_unary("X"),
             no_grad_inputs=("I",))
def write_to_array_lower(ctx):
    out_name = ctx.op.output("Out")[0]
    arr = ctx.env.get(out_name)
    if not isinstance(arr, TensorArray):
        arr = TensorArray(capacity=ctx.attr("capacity",
                                            DEFAULT_ARRAY_CAPACITY))
    ctx.outputs[out_name] = arr.write(
        ctx.input("I"), ctx.input("X"), ctx.aux,
        keep=ctx.aux.get("loop_keep"),
        in_place=bool(ctx.aux.get("arrays_in_place")))


@register_op("read_from_array", infer_shape=infer_shape_unary("X"),
             no_grad_inputs=("I",))
def read_from_array_lower(ctx):
    arr = ctx.input("X")
    if not isinstance(arr, TensorArray):
        raise TypeError("read_from_array input is not a TensorArray")
    ctx.set_output("Out", arr.read(ctx.input("I"), ctx.aux))


@register_op("lod_array_length", infer_shape=_infer_skip, no_gradient=True)
def lod_array_length_lower(ctx):
    length = ctx.input("X").length
    ctx.set_output("Out", torch.zeros(1, dtype=torch.int64,
                                      device=ctx.device)
                   if length is None else length.reshape(1))


# ---------------------------------------------------------------------------
# while  (while_op.cc)
# ---------------------------------------------------------------------------

def _sub_blocks(op):
    return [a for a in op.attrs.values() if hasattr(a, "ops")]


def _walk(block):
    """The ops of ``block`` and of its nested blocks, depth first."""
    for op in block.ops:
        yield op
        for sub in _sub_blocks(op):
            yield from _walk(sub)


def _collect_written(block):
    """Every name the ops of ``block`` (and its nested blocks) write."""
    names = []
    for op in _walk(block):
        for n in op.output_arg_names:
            if n and n not in names:
                names.append(n)
    return names


def _array_outs(block):
    """``{name: capacity}`` of the arrays ``write_to_array`` ops of
    ``block`` (recursively) write."""
    out = {}
    for op in _walk(block):
        if op.type == "write_to_array":
            for n in op.output("Out"):
                if n:
                    out.setdefault(n, op.attr("capacity",
                                              DEFAULT_ARRAY_CAPACITY))
    return out


def _arrays_read(block):
    """The names of the arrays ``read_from_array`` ops of ``block``
    (recursively) read."""
    return [op.input("X")[0] for op in _walk(block)
            if op.type == "read_from_array"]


def _stepped(block):
    """The names the body itself (not a nested block) steps up in place
    by at least 1 every trip (``increment`` with X its Out)."""
    return {op.input("X")[0] for op in block.ops
            if op.type == "increment" and op.input("X") == op.output("Out")
            and op.attr("step", 1.0) >= 1}


def _static_trip_bound(block, env):
    """The JAX package's bound (``paddle_tpu/ops/control_flow_ops.py:
    341``): the largest capacity of an array the loop body reads; None
    when it reads none.  Tighter where that changes no result: the
    largest capacity of an array the body reads but does not write, when
    the body reads it itself at an index it steps up every trip (the
    DynamicRNN's step arrays, ``T`` steps, against 128 for its memory
    arrays).  A live trip past that capacity would read outside it, an
    ``IndexError`` of the port; there the loop raises its exhausted
    bound's ``RuntimeError`` instead."""
    written, stepped = _array_outs(block), _stepped(block)
    walked = [env.get(op.input("X")[0]) for op in block.ops
              if op.type == "read_from_array"
              and op.input("X")[0] not in written
              and op.input("I")[0] in stepped]
    caps = [a.capacity for a in walked if isinstance(a, TensorArray)]
    if not caps:
        caps = [a.capacity for a in map(env.get, _arrays_read(block))
                if isinstance(a, TensorArray)]
    return max(caps) if caps else None


def _unbounded(op):
    """A ``while`` (or ``while_grad``) without ``max_iters`` whose body
    reads no array has no trip bound: it reads its condition on the
    host, so its block stays eager."""
    return op.attr("max_iters", None) is None and \
        not _arrays_read(op.attr("sub_block"))


def _exhausted_message(bound):
    return (f"while loop did not terminate within its static trip bound "
            f"of {bound} iterations (inferred from TensorArray capacity or "
            f"the 'max_iters' attr); raise 'max_iters' on the while op")


def _merge(keep, new, old):
    """A carry after a bounded trip: the body's value where ``keep``
    holds, else the old one; an array's rows are gated in its writes."""
    if new is old or isinstance(new, TensorArray) or \
            not isinstance(new, torch.Tensor):
        return new
    return torch.where(keep, new, old)


@register_op("while", infer_shape=_infer_skip, no_grad_inputs=("Condition",),
             eager_only=_unbounded)
def while_lower(ctx):
    """Run the sub-block while the condition holds (see the module
    docstring): ``bound`` masked trips, else a host loop; the carries go
    to ``ctx.outputs``."""
    sub_block = ctx.attr("sub_block")
    cond_name = ctx.op.input("Condition")[0]
    aux = ctx.aux
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
    aux.setdefault("env_snapshots", {}).setdefault(id(sub_block), pre)
    remember_rng_start(aux, sub_block)

    # the loop's own arrays: written in place from here on
    carries = dict(pre, **_own_arrays(pre, aux))
    bound = ctx.attr("max_iters", None)
    if bound is None:
        bound = _static_trip_bound(sub_block,
                                   collections.ChainMap(carries, ctx.env))
    lower_block = aux["lower_block"]
    outer_keep = aux.get("loop_keep")
    if bound is None:
        env = collections.ChainMap(carries, ctx.env)
        trips = 0
        with _gated(aux, outer_keep):
            while bool(host_scalar(aux, _all(env[cond_name]))):
                lower_block(sub_block, env, aux)
                trips += 1
    else:
        trips = int(bound)
        for _ in range(trips):
            keep = _all(carries[cond_name])
            if outer_keep is not None:
                # a frozen outer trip re-derives a true inner condition:
                # the inherited mask keeps its writes off
                keep = keep & outer_keep
            env = collections.ChainMap({}, carries, ctx.env)
            with _gated(aux, keep):
                lower_block(sub_block, env, aux)
            carries = {n: _merge(keep, env[n], old)
                       for n, old in carries.items()}
        # the bound is a claim: a condition still true after it (and not
        # merely frozen by an outer trip that is over) is an error
        record_fault(aux, RuntimeError, _exhausted_message(trips),
                     _all(carries[cond_name]))
    aux["while_trips"] = aux.get("while_trips", 0) + trips
    for n in pre:
        ctx.outputs[n] = carries[n]


# ---------------------------------------------------------------------------
# conditional_block  (conditional_block_op.cc)
# ---------------------------------------------------------------------------

def _not_pure(op):
    """An op whose run leaves a trace outside its outputs, so that it
    must not run in a branch that is not taken: one that updates state
    in place or across steps (``stateful_outputs``: an optimizer, whose
    SelectedRows update writes its rows in place, the paged KV write), or
    one that does host work in either LoD mode (``registry.eager_only``
    with ``dyn``: ``print``, ``save_combine`` / ``load_combine``, the
    host generator's draws, an unbounded ``while``)."""
    opdef = lookup(op.type)
    return bool(opdef is not None and opdef.stateful_outputs) or \
        eager_only(op, dyn=True)


def _host_branch(op):
    """A branch holding an op that must not run untaken
    (:func:`_not_pure`): its predicate is read on the host."""
    return any(map(_not_pure, _walk(op.attr("sub_block"))))


@register_op("conditional_block", infer_shape=_infer_skip, no_gradient=True,
             eager_only=_host_branch)
def conditional_block_lower(ctx):
    """The branch runs whatever the condition (every element of every
    condition); each output is ``where(pred, new, old)``, zeros of the
    branch's shape for one without an old value, and an array the branch
    writes keeps its rows unless the predicate (and an enclosing loop's
    keep) holds.  A branch with an op that must not run untaken runs
    only when the predicate, read on the host, holds."""
    conds = ctx.inputs("Cond") if ctx.op.input("Cond") else ctx.inputs("X")
    pred = torch.stack([_all(c) for c in conds]).all()
    out_names = [n for n in ctx.op.output("Out") if n]
    old = {n: _lookup(ctx.env, n) for n in out_names}
    sub_block = ctx.attr("sub_block")
    keep = pred
    if ctx.aux.get("loop_keep") is not None:
        keep = keep & ctx.aux["loop_keep"]
    if _host_branch(ctx.op):
        # a frozen trip of an enclosing loop takes no branch either
        taken = bool(host_scalar(ctx.aux, keep))
        # untaken, the branch's own temporaries do not exist outside it;
        # only an outer name without a value needs the branch's shape
        outer = [n for n in out_names if old[n] is not None
                 or not sub_block.has_var_local(n)]
        env = collections.ChainMap({}, ctx.env)
        if taken or any(old[n] is None for n in outer):
            ctx.aux["lower_block"](sub_block, env, ctx.aux)
        for n in out_names if taken else outer:
            ctx.outputs[n] = env[n] if taken else old[n] \
                if old[n] is not None else torch.zeros_like(env[n])
        return
    env = collections.ChainMap(_own_arrays(old, ctx.aux), ctx.env)
    with _gated(ctx.aux, keep):
        ctx.aux["lower_block"](sub_block, env, ctx.aux)
    for n in out_names:
        new = env[n]
        if isinstance(new, TensorArray) or not isinstance(new, torch.Tensor):
            ctx.outputs[n] = new
        else:
            ctx.outputs[n] = torch.where(
                pred, new, old[n] if old[n] is not None
                else torch.zeros_like(new))


# ---------------------------------------------------------------------------
# split / merge_lod_tensor  (IfElse batch routing, split_lod_tensor_op.cc)
# ---------------------------------------------------------------------------

@register_op("split_lod_tensor", infer_shape=_infer_skip, no_gradient=True)
def split_lod_tensor_lower(ctx):
    """Both branches see the whole batch (the merge picks the rows)."""
    x = ctx.input("X")
    ctx.set_output("OutTrue", x)
    ctx.set_output("OutFalse", x)


@register_op("merge_lod_tensor", infer_shape=infer_shape_unary("InTrue"),
             no_grad_inputs=("Mask",))
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
            data, table.lengths_arr.max())
        return
    lod = ctx.input_lod("X")
    lengths, indices = table.lengths, table.indices
    T, B = (max(lengths) if lengths else 0), len(lengths)
    out_name = ctx.op.output("Out")[0]
    length = torch.full((), T, dtype=torch.int64, device=x.device)
    if lod is None:
        # dense [B, T, ...]: rows in rank-table order, time-major
        rows = x.index_select(0, _table_tensor(
            ctx, "rank_rows", table, lambda: np.asarray(indices, np.int64)))
        ctx.outputs[out_name] = TensorArray(
            rows[:, :T].transpose(0, 1).contiguous(), length)
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
    ctx.outputs[out_name] = TensorArray(steps, length)


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
        data = arr.data                               # [L, B, ...]
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
    data = arr.data[:T]
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
