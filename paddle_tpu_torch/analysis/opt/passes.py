"""The optimization passes (the port's copy of
``paddle_tpu.analysis.opt.passes``: the same passes, stats and
``__rng_slots__`` charging, so both packages optimize a program alike).

All passes mutate the program handed to them IN PLACE (the pipeline
clones first) and return a stats dict.  Eligibility always goes
through the shared op-metadata registry (``analysis/opmeta.py``) — the
same classification the dead-op lint exempts by, so a pass can never
delete what a lint protects.

RNG-slot bookkeeping: the executor seeds each random op's generator
from a counter that advances one slot per op in program order
(``executor.lower_block``).  A pass that removes or fuses ops must not
shift the counter positions of surviving RNG consumers (dropout masks
would silently change), so every removal charges its slots to the next
surviving op via the ``__rng_slots__`` attr — surviving ops draw from
the EXACT generator they would have in the unoptimized program, which
is what makes the optimized run equal the unoptimized one even for
programs with live dropout.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from paddle_tpu_torch import framework
from paddle_tpu_torch.analysis import opmeta
from paddle_tpu_torch.analysis.structural import _external_reads, _sub_blocks
from paddle_tpu_torch.framework import Operator

logger = logging.getLogger(__name__)

__all__ = ["PASS_REGISTRY", "PassContext", "constant_fold_pass",
           "cse_pass", "dce_pass", "fuse_elementwise_pass",
           "donation_plan_pass", "RNG_SLOTS_ATTR", "FUSED_OP_TYPE"]

RNG_SLOTS_ATTR = "__rng_slots__"
FUSED_OP_TYPE = "fused_elementwise"

#: largest element count a folded constant may embed in an op attr
MAX_FOLD_ELEMENTS = 4096

#: dtypes ``assign_value`` can carry losslessly through attr lists
_FOLDABLE_DTYPES = ("float32", "int32", "int64", "bool")


class PassContext:
    """What every pass may assume: the executor-declared feed/fetch
    names (roots the passes must preserve verbatim)."""

    def __init__(self, feed_names=(), fetch_names=()):
        self.feed_names = tuple(feed_names or ())
        self.fetch_names = tuple(fetch_names or ())


def _rng_slots(op):
    return int(op.attrs.get(RNG_SLOTS_ATTR, 1))


def _charge_slots(ops, removed_mask):
    """Fold the RNG slots of removed ops into the next surviving op
    (see module docstring); returns the surviving op list."""
    out = []
    pending = 0
    for op, removed in zip(ops, removed_mask):
        if removed:
            pending += _rng_slots(op)
            continue
        if pending:
            op.attrs[RNG_SLOTS_ATTR] = _rng_slots(op) + pending
            pending = 0
        out.append(op)
    return out


def _writer_counts(block):
    counts = {}
    for op in block.ops:
        for n in op.output_arg_names:
            if n:
                counts[n] = counts.get(n, 0) + 1
    return counts


def _sub_block_reads(block):
    """Every name read inside any sub-block of ``block``'s ops —
    renaming or removing producers of these is off-limits for the
    block-local passes."""
    reads = set()
    for op in block.ops:
        for sub in _sub_blocks(op):
            reads.update(_external_reads(sub))
    return reads


def _protected_names(block, ctx):
    """Names a pass may never orphan or rename away: fetch targets,
    feeds, persistables, and anything sub-blocks read."""
    names = set(ctx.fetch_names) | set(ctx.feed_names)
    for blk in block.program.blocks:
        for v in blk.vars.values():
            if getattr(v, "persistable", False):
                names.add(v.name)
    names |= _sub_block_reads(block)
    return names


# ---------------------------------------------------------------------------
# constant folding
# ---------------------------------------------------------------------------

def _const_of(op):
    """The literal an op provably produces, or None."""
    try:
        if op.type in ("fill_constant", "fill"):
            shape = op.attr("shape")
            dtype = str(op.attr("dtype", "float32"))
            if shape is None or any(int(d) < 0 for d in shape) or \
                    dtype not in _FOLDABLE_DTYPES:
                return None
            return np.full(tuple(int(d) for d in shape),
                           op.attr("value", 0.0), dtype=dtype)
        if op.type == "assign_value":
            shape = tuple(op.attr("shape"))
            dtype = str(op.attr("dtype", "float32"))
            if dtype not in _FOLDABLE_DTYPES:
                return None
            values = op.attr("fp32_values") if dtype.startswith("float") \
                else op.attr("int32_values")
            return np.asarray(values, dtype=dtype).reshape(shape)
    except (TypeError, ValueError, OverflowError):
        return None
    return None


def _evaluate_host(op, block, const_env):
    """Host-evaluate one pure op over concrete numpy inputs via its
    registered lowering on CPU tensors (exact semantics — the same code
    the executor runs), returning the output ndarray or None."""
    from paddle_tpu_torch.convert import to_numpy
    from paddle_tpu_torch.ops import registry
    opdef = registry.lookup(op.type)
    if opdef is None or opdef.lower is None:
        return None
    env = {n: torch.from_numpy(np.array(const_env[n]))
           for n in op.input_arg_names if n}
    ctx = registry.LowerContext(op, env, block,
                                aux={"device": torch.device("cpu")})
    try:
        with torch.no_grad():
            opdef.lower(ctx)
    except Exception:
        return None
    outs = op.output("Out")
    if len(outs) != 1 or outs[0] not in ctx.outputs:
        return None
    return to_numpy(ctx.outputs[outs[0]])


def _assign_value_op(block, name, value):
    dtype = str(value.dtype)
    if dtype.startswith("float"):
        attrs = {"fp32_values": [float(v) for v in value.ravel()]}
    else:
        attrs = {"int32_values": [int(v) for v in value.ravel()]}
    attrs["shape"] = [int(d) for d in value.shape]
    attrs["dtype"] = dtype
    return Operator(block, "assign_value", {}, {"Out": [name]}, attrs)


def constant_fold_pass(program, ctx):
    """Fold chains of pure ops rooted in literal producers
    (``fill_constant``/``assign_value``) by evaluating them host-side
    and replacing each with a single ``assign_value`` carrying the
    result — shape-arithmetic scaffolding becomes data instead of ops
    the executor runs every step.  Folded-away producers become dead and
    fall to the DCE pass."""
    from paddle_tpu_torch.ops import registry
    block = program.global_block()
    const_env = {}
    folded = 0
    new_ops = []
    for op in block.ops:
        value = _const_of(op)
        if value is not None:
            for n in op.output("Out"):
                const_env[n] = value
            new_ops.append(op)
            continue
        eligible = (
            op.type in opmeta.ELEMENTWISE_PURE_OPS | {
                "reshape", "reshape2", "transpose", "transpose2",
                "concat"}
            and opmeta.is_pure(op, block, registry)
            and not opmeta.has_sub_block(op)
            and len(op.output("Out")) == 1
            and all(n in const_env for n in op.input_arg_names if n)
            and op.input_arg_names)
        if eligible:
            out_name = op.output("Out")[0]
            result = _evaluate_host(op, block, const_env)
            if result is not None and result.size <= MAX_FOLD_ELEMENTS \
                    and str(result.dtype) in _FOLDABLE_DTYPES \
                    and _int_fits(result):
                const_env[out_name] = result
                rep = _assign_value_op(block, out_name, result)
                rep.attrs[RNG_SLOTS_ATTR] = _rng_slots(op)
                folded += 1
                new_ops.append(rep)
                continue
        # any other write invalidates a tracked constant: a later
        # consumer must not fold the stale value
        for n in op.output_arg_names:
            const_env.pop(n, None)
        new_ops.append(op)
    if folded:
        block.ops[:] = new_ops
        program.bump_version()
        from paddle_tpu_torch import profiler as _profiler
        _profiler.runtime_metrics.inc("opt.constants_folded", folded)
        # folding orphans the chains' producers (their values now live
        # in attrs) — sweep them here so this pass leaves no dead ops
        # behind (the verify-sandwich would rightly reject a pass that
        # INTRODUCES PTA007 findings)
        swept = dce_pass(program, ctx)
        return {"folded": folded, "swept": swept["removed"]}
    return {"folded": folded}


def _int_fits(value):
    """int64 results must survive the int32-valued attr round-trip
    (the same contract PTA010 lints)."""
    if value.dtype != np.int64:
        return True
    if value.size == 0:
        return True
    return bool(value.max() <= np.iinfo(np.int32).max and
                value.min() >= np.iinfo(np.int32).min)


# ---------------------------------------------------------------------------
# common subexpression elimination
# ---------------------------------------------------------------------------

def _attr_key(attrs):
    parts = []
    for k in sorted(attrs):
        if k == RNG_SLOTS_ATTR:
            continue
        v = attrs[k]
        if isinstance(v, framework.Block):
            return None  # sub-block ops are never CSE candidates
        if isinstance(v, np.ndarray):
            parts.append((k, "nd", str(v.dtype), v.shape,
                          v.tobytes()))
        elif isinstance(v, (list, tuple)):
            parts.append((k, tuple(map(repr, v))))
        else:
            parts.append((k, repr(v)))
    return tuple(parts)


def cse_pass(program, ctx):
    """Deduplicate pure ops with identical ``(type, inputs, attrs)``:
    the later op is dropped and its consumers read the earlier op's
    outputs.  Only single-writer names participate (renaming is unsafe
    off SSA), and protected names (fetches, feeds, persistables,
    sub-block reads) are never renamed away."""
    from paddle_tpu_torch.ops import registry
    block = program.global_block()
    writers = _writer_counts(block)
    protected = _protected_names(block, ctx)
    # names any op updates in place: two reads of such a name at
    # different program points may see different values, so ops reading
    # them never dedupe (value identity cannot be keyed by name)
    inplace = set()
    for op in block.ops:
        inplace.update(opmeta.stateful_output_names(op, registry))
    seen = {}        # key -> canonical op
    rename = {}      # dropped name -> canonical name
    removed_mask = []
    deduped = 0
    for op in block.ops:
        # apply pending renames to this op's reads first
        for slot, names in op.inputs.items():
            op.inputs[slot] = [rename.get(n, n) for n in names]
        ok = (opmeta.is_pure(op, block, registry)
              and not opmeta.has_sub_block(op)
              and not opmeta.uses_rng(op, registry)
              and op.output_arg_names
              and all(writers.get(n, 0) == 1 and n not in protected
                      for n in op.output_arg_names if n)
              and all(writers.get(n, 0) <= 1 and n not in inplace
                      for n in op.input_arg_names if n))
        if not ok:
            removed_mask.append(False)
            continue
        akey = _attr_key(op.attrs)
        if akey is None:
            removed_mask.append(False)
            continue
        key = (op.type,
               tuple(sorted((s, tuple(ns))
                            for s, ns in op.inputs.items())),
               akey)
        canon = seen.get(key)
        if canon is None:
            seen[key] = op
            removed_mask.append(False)
            continue
        # same slot layout guaranteed by the key; map name -> name
        for slot, names in op.outputs.items():
            for old, new in zip(names, canon.output(slot)):
                if old and new:
                    rename[old] = new
        deduped += 1
        removed_mask.append(True)
    if deduped:
        block.ops[:] = _charge_slots(block.ops, removed_mask)
        program.bump_version()
    return {"deduped": deduped}


# ---------------------------------------------------------------------------
# dead code elimination
# ---------------------------------------------------------------------------

def dce_pass(program, ctx):
    """Remove provably dead ops: reverse liveness from the fetch
    targets and persistable writes, keeping everything the shared
    metadata registry classifies as effectful.  Unlike the PTA007 lint
    (which exempts unconsumed pure ``@GRAD`` chains because callers
    fetch grad vars ad hoc), this pass KNOWS the fetch list — autodiff
    chains nothing fetches are ops the eager executor would run every
    step for nothing; removing them here is where the win comes
    from."""
    from paddle_tpu_torch.ops import registry
    block = program.global_block()
    ops = block.ops
    needed = set(ctx.fetch_names)
    for blk in program.blocks:
        for v in blk.vars.values():
            if getattr(v, "persistable", False):
                needed.add(v.name)
    live = [False] * len(ops)
    for i in range(len(ops) - 1, -1, -1):
        op = ops[i]
        outs = [n for n in op.output_arg_names if n]
        if opmeta.has_effects(op, registry) or \
                any(n in needed for n in outs):
            live[i] = True
            needed.update(n for n in op.input_arg_names if n)
            for sub in _sub_blocks(op):
                needed.update(_external_reads(sub))
    removed = live.count(False)
    if removed:
        block.ops[:] = _charge_slots(ops, [not l for l in live])
        program.bump_version()
    return {"removed": removed}


# ---------------------------------------------------------------------------
# elementwise-chain fusion
# ---------------------------------------------------------------------------

def fuse_elementwise_pass(program, ctx):
    """Collapse maximal runs of ADJACENT pure elementwise ops — each
    intermediate consumed only by the next op in the run — into one
    ``fused_elementwise`` op whose lowering replays the member
    lowerings in one dispatch: one op's worth of per-op executor
    overhead (context, RNG slot) instead of k, with identical array
    semantics (the member lowerings ARE the
    semantics)."""
    from paddle_tpu_torch.ops import registry
    block = program.global_block()
    ops = block.ops
    writers = _writer_counts(block)
    protected = _protected_names(block, ctx)

    consumers = {}   # name -> list of op indices reading it
    for i, op in enumerate(ops):
        for n in op.input_arg_names:
            if n:
                consumers.setdefault(n, []).append(i)

    def fusable(op):
        return (op.type in opmeta.ELEMENTWISE_PURE_OPS
                and opmeta.is_pure(op, block, registry)
                and not opmeta.has_sub_block(op)
                and len(op.output_arg_names) == 1
                and len(op.output("Out")) == 1)

    def internal(i):
        """Op i's output may vanish inside a fusion: single writer,
        consumed exactly by op i+1, protected nowhere."""
        out = ops[i].output("Out")[0]
        return (writers.get(out, 0) == 1 and out not in protected
                and set(consumers.get(out, [-1])) == {i + 1})

    new_ops = []
    fused = 0
    fused_members = 0
    i = 0
    while i < len(ops):
        if not fusable(ops[i]):
            new_ops.append(ops[i])
            i += 1
            continue
        j = i
        while j + 1 < len(ops) and fusable(ops[j + 1]) and internal(j):
            j += 1
        if j == i:
            new_ops.append(ops[i])
            i += 1
            continue
        run = ops[i:j + 1]
        internal_names = {op.output("Out")[0] for op in run[:-1]}
        ext_inputs = []
        for op in run:
            for n in op.input_arg_names:
                if n and n not in internal_names and \
                        n not in ext_inputs:
                    ext_inputs.append(n)
        out_name = run[-1].output("Out")[0]
        fop = Operator(block, FUSED_OP_TYPE,
                       {"X": ext_inputs}, {"Out": [out_name]},
                       {"sub_ops": [op.to_dict() for op in run],
                        RNG_SLOTS_ATTR: sum(_rng_slots(op)
                                            for op in run)})
        new_ops.append(fop)
        fused += 1
        fused_members += len(run)
        i = j + 1
    if fused:
        block.ops[:] = new_ops
        program.bump_version()
        from paddle_tpu_torch import profiler as _profiler
        _profiler.runtime_metrics.inc("opt.ops_fused", fused_members)
    return {"chains": fused, "members": fused_members}


# ---------------------------------------------------------------------------
# donation/aliasing planner
# ---------------------------------------------------------------------------

def donation_plan_pass(program, ctx):
    """Attach the donation/aliasing plan
    (``memory_optimization_transpiler.plan_donation``): which feed
    buffers die inside the step (donatable), which vars are declared
    in-place updates (``stateful_outputs`` facts the executor's
    donation path relies on) — each fact proven safe by the PTA009
    donation-hazard lint before it enters the plan.  Pure fact
    emission: the op list is untouched."""
    from paddle_tpu_torch.memory_optimization_transpiler import plan_donation
    plan = plan_donation(program, feed_names=ctx.feed_names,
                         fetch_names=ctx.fetch_names)
    return {"donatable_feeds": len(plan.donatable_feeds),
            "inplace_updates": len(plan.inplace_updates),
            "hazards_dropped": len(plan.dropped)}


# ---------------------------------------------------------------------------
# compile-amortization gate
# ---------------------------------------------------------------------------

#: static-FLOPs ceiling under which a run-once program is marked for
#: interpretation (the JAX package's threshold, kept so that both
#: packages report the same decision)
AMORTIZE_FLOPS_CEILING = int(1e7)

#: op-count floor for that decision (the JAX package's)
AMORTIZE_MIN_OPS = 48


def amortize_pass(program, ctx):
    """Decide — from the static cost model — whether this program
    should be INTERPRETED rather than captured whole: a program with no
    feeds and no fetches is structurally a run-once initializer
    (startup programs: every op exists to write persistable state), and
    when its total static FLOPs sit under
    :data:`AMORTIZE_FLOPS_CEILING` a capture buys nothing an op-by-op
    run does not.  Attaches ``program._opt_interpret``; the op list is
    untouched.  The port's executor is eager and ignores the mark until
    it captures steps in CUDA graphs (ROADMAP queue 1 item 5b), where it
    means "no graph"."""
    if ctx.fetch_names or ctx.feed_names:
        return {"interpret": 0}
    block = program.global_block()
    if len(block.ops) < AMORTIZE_MIN_OPS:
        return {"interpret": 0}
    reads = {n for op in block.ops for n in op.input_arg_names if n}
    for v in block.vars.values():
        if getattr(v, "is_data", False) and v.name in reads:
            # a program consuming declared data is a step program,
            # whatever its fetch list says
            return {"interpret": 0}
    from paddle_tpu_torch.analysis import cost
    est = cost.estimate(program)
    if est.total_flops > AMORTIZE_FLOPS_CEILING:
        return {"interpret": 0, "flops": est.total_flops}
    program._opt_interpret = True
    from paddle_tpu_torch import profiler as _profiler
    _profiler.runtime_metrics.inc("opt.compiles_avoided")
    return {"interpret": 1, "flops": est.total_flops}


PASS_REGISTRY = {
    "constant_fold": constant_fold_pass,
    "cse": cse_pass,
    "dce": dce_pass,
    "fuse_elementwise": fuse_elementwise_pass,
    "donation_plan": donation_plan_pass,
    "amortize": amortize_pass,
}
