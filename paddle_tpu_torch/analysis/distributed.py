"""Distributed-program verifier (the port's copy of
``paddle_tpu.analysis.distributed``): cross-program checks over the
FAMILIES a transpile produces, with the JAX package's codes and
messages.

* **collective matching** (PTA011/PTA012): every member of an SPMD
  family must emit the same ``c_*`` collective sequence (same ops, same
  program order, same axis/root/participants/shape/dtype); a member
  whose collectives are reordered is a static deadlock.
* **Send/Recv pairing** (PTA013): in a trainer/pserver pair every
  ``send`` has exactly one matching ``recv`` of the same variable in a
  peer, with agreeing declared shape and dtype.
* **split reassembly** (PTA014): pserver-side ``<name>.block<k>``
  pieces sum back to the original variable's shape.
* **stage boundary agreement** (PTA015): pipeline boundary carriers
  agree between producer and consumer stages (same names in the same
  order, since the carrier layout is positional; same shape and dtype),
  and every value a stage consumes from upstream rides the boundary
  before it (``check_stage_set``, ``check_pipeline_stages``,
  ``lint_pipeline``).
* **sharding propagation** (PTA016/PTA017): partition-spec placements
  validated against the mesh and propagated through per-op
  :func:`sharding_rule` functions; a provably invalid spec is an error,
  an implicit full reshard a warning.
* **recompile hazards** (PTA018/PTA019): the generation bundle's
  constant-signature contract against its ``gen_meta.json``.
  ``GenPredictor`` raises on the errors at load,
  ``models.gen_lm.export_gen_model`` after export
  (``verify_gen_bundle``).  On the port a bucket escape does not
  recompile (the executor is eager), but it runs a shape that warmup
  never built or checked, so the codes stay the JAX package's.

Like every analysis pass, the contract is ZERO false positives: checks
fire only on facts provable from the IR (and the declared metadata)
alone; unknown shapes/dtypes/specs stay silent.
"""

from __future__ import annotations

import json
import os
import re

from paddle_tpu_torch.analysis.analyzer import AnalysisResult, lint_program
from paddle_tpu_torch.analysis.diagnostics import (Diagnostic,
                                                   ProgramVerificationError)
from paddle_tpu_torch.framework import Program

__all__ = [
    "COLLECTIVE_OP_TYPES", "collective_signature",
    "check_collective_match", "check_send_recv", "check_param_splits",
    "check_transpiled_pair", "check_stage_set", "check_pipeline_stages",
    "sharding_rule", "sharding_rules", "check_sharding",
    "check_distributed_spec", "check_gen_bundle", "lint_gen_bundle",
    "lint_pipeline", "lint_pair", "verify_gen_bundle",
    "load_saved_program", "ShardEnv",
]

#: collective op family (parallel/collective.py) — blocking rendezvous
#: points every participant must reach in the same order
COLLECTIVE_OP_TYPES = frozenset({
    "c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
    "c_allreduce_prod", "c_broadcast", "c_allgather", "c_reducescatter",
    "c_alltoall",
})

_SPLIT_BLOCK = re.compile(r"^(?P<base>.+)\.block(?P<idx>\d+)$")


def _sub_blocks(op):
    for a in op.attrs.values():
        if a.__class__.__name__ == "Block":
            yield a


def _var_meta(block, name):
    """Declared (shape, dtype) of ``name`` or (None, None)."""
    try:
        v = block.var(name)
    except KeyError:
        return None, None
    shape = None if v.shape is None else tuple(int(d) for d in v.shape)
    return shape, v.dtype


# ---------------------------------------------------------------------------
# collective matching (PTA011 / PTA012)
# ---------------------------------------------------------------------------

def collective_signature(ops, block):
    """Program-order collective trace of an op list: one entry per
    collective op (sub-blocks recursed in order), carrying everything
    peers must agree on."""
    sig = []

    def walk(op_list):
        for i, op in enumerate(op_list):
            if op.type in COLLECTIVE_OP_TYPES:
                x = op.input("X")
                shape, dtype = _var_meta(block, x[0]) if x else (None, None)
                sig.append({
                    "type": op.type,
                    "axis": op.attr("axis"),
                    "root": op.attr("root"),
                    "nranks": op.attr("nranks"),
                    "var": x[0] if x else None,
                    "shape": shape, "dtype": dtype,
                    "op_index": i, "op": op,
                })
            for sub in _sub_blocks(op):
                walk(sub.ops)

    walk(list(ops))
    return sig


def program_collective_signature(program):
    block = program.global_block()
    return collective_signature(block.ops, block)


def _attrs_agree(a, b):
    """Both declared and different -> disagree; unknown matches all."""
    return a is None or b is None or a == b


def check_collective_match(members):
    """``members``: list of ``(label, ops, block)`` (or
    ``(label, program)``) — the SPMD family.  Returns diagnostics.

    Sequence-level divergence (count or op kind at a position) is
    PTA011 — a static deadlock: the members rendezvous in different
    orders.  A matched position whose axis/root/participants/shape/
    dtype provably differ is PTA012 — the rendezvous happens, on
    inconsistent data."""
    diags = []
    sigs = []
    for m in members:
        if len(m) == 2:
            label, program = m
            sigs.append((label, program_collective_signature(program)))
        else:
            label, ops, block = m
            sigs.append((label, collective_signature(ops, block)))
    if len(sigs) < 2:
        return diags
    ref_label, ref = sigs[0]
    for label, sig in sigs[1:]:
        n = min(len(ref), len(sig))
        divergence = None
        for i in range(n):
            if ref[i]["type"] != sig[i]["type"]:
                divergence = i
                break
        if divergence is not None:
            a, b = ref[divergence], sig[divergence]
            diags.append(Diagnostic(
                "PTA011",
                f"collective #{divergence} diverges between "
                f"`{ref_label}` and `{label}`: `{a['type']}` (on "
                f"`{a['var']}`) vs `{b['type']}` (on `{b['var']}`) — "
                f"the members rendezvous in different orders and "
                f"deadlock on device",
                op_index=b["op_index"], op_type=b["type"], var=b["var"],
                site=getattr(b["op"], "creation_site", None),
                program=label))
            continue
        if len(ref) != len(sig):
            longer_label = ref_label if len(ref) > len(sig) else label
            extra = (ref if len(ref) > len(sig) else sig)[n]
            diags.append(Diagnostic(
                "PTA011",
                f"`{ref_label}` emits {len(ref)} collective(s) but "
                f"`{label}` emits {len(sig)} — `{longer_label}`'s "
                f"`{extra['type']}` (on `{extra['var']}`) has no "
                f"rendezvous partner and blocks forever",
                op_index=extra["op_index"], op_type=extra["type"],
                var=extra["var"],
                site=getattr(extra["op"], "creation_site", None),
                program=longer_label))
            continue
        for i in range(n):
            a, b = ref[i], sig[i]
            bad = []
            if not _attrs_agree(a["axis"], b["axis"]):
                bad.append(f"axis {a['axis']!r} vs {b['axis']!r}")
            if not _attrs_agree(a["root"], b["root"]):
                bad.append(f"root {a['root']!r} vs {b['root']!r}")
            if not _attrs_agree(a["nranks"], b["nranks"]):
                bad.append(f"participants {a['nranks']!r} vs "
                           f"{b['nranks']!r}")
            if a["shape"] is not None and b["shape"] is not None and \
                    a["shape"] != b["shape"]:
                bad.append(f"shape {a['shape']} vs {b['shape']}")
            if not _attrs_agree(a["dtype"], b["dtype"]):
                bad.append(f"dtype {a['dtype']} vs {b['dtype']}")
            if bad:
                diags.append(Diagnostic(
                    "PTA012",
                    f"collective #{i} `{b['type']}` matches between "
                    f"`{ref_label}` and `{label}` but the members "
                    f"disagree on " + "; ".join(bad),
                    op_index=b["op_index"], op_type=b["type"],
                    var=b["var"],
                    site=getattr(b["op"], "creation_site", None),
                    program=label))
    return diags


# ---------------------------------------------------------------------------
# Send/Recv pairing (PTA013) + split reassembly (PTA014)
# ---------------------------------------------------------------------------

def _send_recv_sites(program):
    sends, recvs = [], []
    block = program.global_block()
    for i, op in enumerate(block.ops):
        if op.type == "send":
            for n in op.input("X"):
                sends.append((n, i, op))
        elif op.type == "recv":
            for n in op.output("Out"):
                recvs.append((n, i, op))
    return sends, recvs


def check_send_recv(members):
    """``members``: list of ``(label, program)`` — typically the
    trainer and its pserver program(s).  Every ``send`` of a variable
    must have a matching ``recv`` of the same name in a PEER program
    (and vice versa), with agreeing declared shape/dtype."""
    diags = []
    per = []
    for label, program in members:
        sends, recvs = _send_recv_sites(program)
        per.append((label, program, sends, recvs))
    for label, program, sends, recvs in per:
        peers_recv = {}
        peers_send = {}
        for plabel, pprog, psends, precvs in per:
            if plabel == label:
                continue
            for n, i, op in precvs:
                peers_recv.setdefault(n, []).append((plabel, pprog, i, op))
            for n, i, op in psends:
                peers_send.setdefault(n, []).append((plabel, pprog, i, op))
        block = program.global_block()
        for n, i, op in sends:
            matches = peers_recv.get(n, [])
            if not matches:
                diags.append(Diagnostic(
                    "PTA013",
                    f"`{label}` sends `{n}` (op #{i}) but no peer "
                    f"program receives it — the send blocks forever",
                    op_index=i, op_type="send", var=n,
                    site=getattr(op, "creation_site", None),
                    program=label))
                continue
            s_shape, s_dtype = _var_meta(block, n)
            for plabel, pprog, pi, pop in matches:
                r_shape, r_dtype = _var_meta(pprog.global_block(), n)
                bad = []
                if s_shape is not None and r_shape is not None and \
                        s_shape != r_shape:
                    bad.append(f"shape {s_shape} vs {r_shape}")
                if s_dtype is not None and r_dtype is not None and \
                        s_dtype != r_dtype:
                    bad.append(f"dtype {s_dtype} vs {r_dtype}")
                if bad:
                    diags.append(Diagnostic(
                        "PTA013",
                        f"`{label}` sends `{n}` but `{plabel}` "
                        f"receives it with disagreeing "
                        + "; ".join(bad),
                        op_index=pi, op_type="recv", var=n,
                        site=getattr(pop, "creation_site", None),
                        program=plabel))
        for n, i, op in recvs:
            if n not in peers_send:
                diags.append(Diagnostic(
                    "PTA013",
                    f"`{label}` receives `{n}` (op #{i}) but no peer "
                    f"program sends it — the recv blocks forever",
                    op_index=i, op_type="recv", var=n,
                    site=getattr(op, "creation_site", None),
                    program=label))
    return diags


def check_param_splits(trainer, pservers):
    """``trainer``: ``(label, program)``; ``pservers``: list of the
    same.  Pserver-side split blocks (``<name>.block<k>``) of a trainer
    variable must reassemble EXACTLY: contiguous block indices, equal
    tail dims, leading dims summing to the original (PTA014)."""
    diags = []
    t_label, t_prog = trainer
    t_block = t_prog.global_block()
    blocks = {}  # base name -> {idx: (shape, label)}
    for label, pprog in pservers:
        for blk in pprog.blocks:
            for v in blk.vars.values():
                m = _SPLIT_BLOCK.match(v.name)
                if not m:
                    continue
                base = m.group("base")
                if not t_block.has_var(base):
                    continue
                shape = None if v.shape is None else \
                    tuple(int(d) for d in v.shape)
                blocks.setdefault(base, {})[int(m.group("idx"))] = \
                    (shape, label)
    for base, parts in sorted(blocks.items()):
        orig_shape, _ = _var_meta(t_block, base)
        if orig_shape is None or any(d < 0 for d in orig_shape):
            continue
        idxs = sorted(parts)
        if idxs != list(range(len(idxs))):
            missing = sorted(set(range(idxs[-1] + 1)) - set(idxs))
            diags.append(Diagnostic(
                "PTA014",
                f"split of `{base}` {orig_shape} is missing block "
                f"index(es) {missing}: pserver programs hold blocks "
                f"{idxs}", var=base, program=t_label))
            continue
        shapes = [parts[i][0] for i in idxs]
        if any(s is None or any(d < 0 for d in s) for s in shapes):
            continue  # unknown block shapes: nothing provable
        tails = {tuple(s[1:]) for s in shapes}
        if len(tails) > 1 or (tails and
                              next(iter(tails)) != tuple(orig_shape[1:])):
            diags.append(Diagnostic(
                "PTA014",
                f"split blocks of `{base}` {orig_shape} disagree on "
                f"tail dims: {sorted(tails)} (original tail "
                f"{tuple(orig_shape[1:])})", var=base, program=t_label))
            continue
        total = sum(s[0] for s in shapes)
        if total != orig_shape[0]:
            diags.append(Diagnostic(
                "PTA014",
                f"split blocks of `{base}` sum to {total} rows but the "
                f"original is {orig_shape} — the splits do not "
                f"reassemble to the parameter",
                var=base, program=t_label))
    return diags


def check_transpiled_pair(trainer, pservers):
    """The whole trainer/pserver-pair contract: collective matching
    across the family, Send/Recv pairing, split reassembly."""
    members = [trainer] + list(pservers)
    diags = []
    diags.extend(check_send_recv(members))
    diags.extend(check_param_splits(trainer, pservers))
    return diags


# ---------------------------------------------------------------------------
# pipeline stage set (PTA011 across stages, PTA015 boundaries)
# ---------------------------------------------------------------------------

def check_stage_set(block, stage_ops, boundaries, feed_names=(),
                    param_names=None):
    """Validate a ``split_program`` stage set against its boundary
    carriers (the generalization of the i32 carrier-lane check):

    * every non-parameter value a stage consumes from upstream must
      ride the boundary immediately before it (PTA015 — it would
      simply be absent from the flat carrier at runtime);
    * every boundary name must be produced by an earlier stage or be a
      feed (PTA015 — the carrier would pack an undefined value);
    * the stages must emit matching collective sequences
      (PTA011/PTA012 — the JAX package runs them as ``lax.switch``
      branches on the same devices, and a branch-local collective its
      peers don't run deadlocks the mesh).
    """
    from paddle_tpu_torch.framework import Parameter

    def is_param(name):
        v = block.vars.get(name)
        return v is not None and (isinstance(v, Parameter) or
                                  getattr(v, "persistable", False))

    if param_names is None:
        param_names = {n for n in block.vars if is_param(n)}
    feed_set = set(feed_names)
    diags = []

    produced_by = {}
    for s, sops in enumerate(stage_ops):
        for op in sops:
            for n in op.output_arg_names:
                if n:
                    produced_by.setdefault(n, s)

    def external_inputs(op):
        names = [n for n in op.input_arg_names if n]
        for sub in _sub_blocks(op):
            for sop in sub.ops:
                names.extend(external_inputs(sop))
        return names

    for s, sops in enumerate(stage_ops):
        if s == 0:
            continue
        carried = set(boundaries[s]) if s < len(boundaries) else set()
        for op in sops:
            for n in external_inputs(op):
                if n in param_names or n in carried:
                    continue
                src = produced_by.get(n)
                if src is not None and src >= s:
                    continue  # produced locally or downstream-fed
                if src is None and n not in feed_set:
                    continue  # scope state, not a carrier concern
                diags.append(Diagnostic(
                    "PTA015",
                    f"stage {s} op `{op.type}` consumes `{n}` "
                    f"(produced by "
                    f"{'the feed' if src is None else f'stage {src}'}) "
                    f"but the boundary before stage {s} does not carry "
                    f"it — the value is absent from the flat carrier "
                    f"at runtime",
                    op_type=op.type, var=n,
                    site=getattr(op, "creation_site", None),
                    program=f"stage{s}"))
                break  # one finding per op keeps the report readable
    for b, names in enumerate(boundaries):
        for n in names:
            src = produced_by.get(n)
            if src is None and n not in feed_set:
                if block.has_var(n):  # scope state rides nothing
                    continue
                diags.append(Diagnostic(
                    "PTA015",
                    f"boundary {b} carries `{n}`, which no stage "
                    f"produces and no feed provides — the carrier "
                    f"would pack an undefined value", var=n,
                    program=f"boundary{b}"))
            elif src is not None and b <= src < len(stage_ops) and \
                    b != len(boundaries) - 1 and b > 0:
                diags.append(Diagnostic(
                    "PTA015",
                    f"boundary {b} carries `{n}` but it is only "
                    f"produced later, by stage {src} — the carrier "
                    f"would pack an undefined value", var=n,
                    program=f"boundary{b}"))

    members = [(f"stage{s}", sops, block)
               for s, sops in enumerate(stage_ops)]
    diags.extend(check_collective_match(members))
    return diags


def check_pipeline_stages(stages):
    """``stages``: ordered list of ``(label, program, in_names,
    out_names)`` — per-stage programs of one pipeline (the
    multi-program CLI unit).  Adjacent stages must agree on the
    carrier: the producer's out list IS the consumer's in list (the
    flat carrier layout is positional, so order matters), and
    same-named vars must declare agreeing shape/dtype (PTA015).
    Collectives must match across all stages (PTA011/PTA012)."""
    diags = []
    for (a_label, a_prog, _a_in, a_out), \
            (b_label, b_prog, b_in, _b_out) in zip(stages, stages[1:]):
        if list(a_out) != list(b_in):
            diags.append(Diagnostic(
                "PTA015",
                f"boundary between `{a_label}` and `{b_label}` "
                f"disagrees: producer emits {list(a_out)} but consumer "
                f"expects {list(b_in)} — the positional carrier layout "
                f"desyncs",
                var=next((n for n, m in zip(a_out, list(b_in) + [None])
                          if n != m), None),
                program=b_label))
            continue
        a_block = a_prog.global_block()
        b_block = b_prog.global_block()
        for n in a_out:
            a_shape, a_dtype = _var_meta(a_block, n)
            b_shape, b_dtype = _var_meta(b_block, n)
            bad = []
            if a_shape is not None and b_shape is not None and \
                    a_shape != b_shape:
                bad.append(f"shape {a_shape} vs {b_shape}")
            if a_dtype is not None and b_dtype is not None and \
                    a_dtype != b_dtype:
                bad.append(f"dtype {a_dtype} vs {b_dtype}")
            if bad:
                diags.append(Diagnostic(
                    "PTA015",
                    f"carrier `{n}` drifts between `{a_label}` "
                    f"(producer) and `{b_label}` (consumer): "
                    + "; ".join(bad), var=n, program=b_label))
    diags.extend(check_collective_match(
        [(label, prog) for label, prog, _i, _o in stages]))
    return diags


# ---------------------------------------------------------------------------
# sharding-spec propagation (PTA016 / PTA017)
# ---------------------------------------------------------------------------

_SHARDING_RULES = {}


def sharding_rule(*op_types):
    """Decorator registering ``fn(op, senv)`` as the sharding
    propagation rule for one or more op types — the distributed analog
    of ``typecheck.rule`` (same registry idiom, same degrade-on-error
    contract)."""

    def deco(fn):
        for t in op_types:
            _SHARDING_RULES[t] = fn
        return fn

    return deco


def sharding_rules():
    return set(_SHARDING_RULES)


def _norm_spec(spec):
    """PartitionSpec / tuple / list -> tuple of axis-or-None (None =
    replicated on that dim); None stays None (unknown placement)."""
    if spec is None:
        return None
    return tuple(spec)


class ShardEnv:
    """name -> placement environment threaded through one program.

    A placement is a tuple of mesh-axis names (or None) per tensor dim;
    ``None`` means *unknown* and matches anything; ``()`` means
    *replicated* (known)."""

    def __init__(self, block, diags, mesh_axes=None):
        self.block = block
        self.diags = diags
        self.mesh_axes = dict(mesh_axes) if mesh_axes else None
        self.op_index = None
        self._env = {}

    def spec(self, name):
        if not name:
            return None
        return self._env.get(name)

    def input_spec(self, op, slot):
        names = op.input(slot)
        return self.spec(names[0]) if names else None

    def set(self, name, spec):
        if name:
            self._env[name] = _norm_spec(spec)

    def set_output(self, op, slot, spec):
        for n in op.output(slot):
            self.set(n, spec)

    def report(self, code, message, op=None, var=None):
        self.diags.append(Diagnostic(
            code, message, block_idx=self.block.idx,
            op_index=self.op_index,
            op_type=op.type if op is not None else None, var=var,
            site=getattr(op, "creation_site", None)))

    def merge(self, op, slot_a, slot_b, out_slot="Out"):
        """Elementwise-style merge.  Both operands provably sharded,
        and differently, means GSPMD inserts a full reshard to align
        them (PTA017).  One-sided knowledge propagates nothing (the
        unknown operand could carry any placement — silence, not a
        guess)."""
        a = self.input_spec(op, slot_a)
        b = self.input_spec(op, slot_b)
        if a is not None and b is not None and a != b and \
                any(x is not None for x in a) and \
                any(x is not None for x in b):
            an = op.input(slot_a)[0] if op.input(slot_a) else "?"
            bn = op.input(slot_b)[0] if op.input(slot_b) else "?"
            self.report(
                "PTA017",
                f"{op.type} combines `{an}` (sharded {a}) with `{bn}` "
                f"(sharded {b}) — GSPMD will insert an implicit full "
                f"reshard; align the placements or reshard explicitly",
                op=op, var=an)
            self.set_output(op, out_slot, None)
            return
        self.set_output(op, out_slot, a if a == b else None)


def _validate_spec(name, spec, shape, mesh_axes, diags, program=None):
    """Provable ill-formedness of one declared placement (PTA016)."""
    spec = _norm_spec(spec)
    if spec is None:
        return
    if shape is not None and len(spec) > len(shape):
        diags.append(Diagnostic(
            "PTA016",
            f"sharding spec {spec} of `{name}` names "
            f"{len(spec)} dims but the variable has rank "
            f"{len(shape)} ({shape})", var=name, program=program))
        return
    seen_axes = set()
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        if axis in seen_axes:
            diags.append(Diagnostic(
                "PTA016",
                f"sharding spec {spec} of `{name}` uses mesh axis "
                f"`{axis}` on more than one dim", var=name,
                program=program))
            continue
        seen_axes.add(axis)
        if mesh_axes is not None and axis not in mesh_axes:
            diags.append(Diagnostic(
                "PTA016",
                f"sharding spec of `{name}` places dim {d} on mesh "
                f"axis `{axis}`, which the mesh does not have "
                f"(axes: {sorted(mesh_axes)})", var=name,
                program=program))
            continue
        if mesh_axes is not None and shape is not None and \
                d < len(shape) and shape[d] > 0 and \
                shape[d] % int(mesh_axes[axis]) != 0:
            diags.append(Diagnostic(
                "PTA016",
                f"`{name}` dim {d} of size {shape[d]} is not "
                f"divisible by mesh axis `{axis}` of size "
                f"{mesh_axes[axis]} — the shards would be ragged",
                var=name, program=program))


def check_sharding(program, placements, mesh_axes=None, program_label=None):
    """Validate declared ``placements`` (name -> PartitionSpec-like)
    against the program and optionally a mesh-axes size dict, then
    propagate them through the registered :func:`sharding_rule`
    functions.  Returns diagnostics (PTA016 errors, PTA017 warnings)."""
    diags = []
    block = program.global_block()
    for name, spec in sorted(placements.items()):
        shape, _ = _var_meta(block, name)
        if not block.has_var(name):
            diags.append(Diagnostic(
                "PTA016",
                f"sharding spec declared for `{name}`, which is not a "
                f"variable of the program", var=name,
                program=program_label))
            continue
        _validate_spec(name, spec, shape, mesh_axes, diags,
                       program=program_label)
    if any(d.code == "PTA016" for d in diags):
        return diags  # propagation over an invalid plan only cascades

    senv = ShardEnv(block, diags, mesh_axes=mesh_axes)
    for name, spec in placements.items():
        senv.set(name, spec)
    for i, op in enumerate(block.ops):
        if op.type in ("feed", "fetch"):
            continue
        senv.op_index = i
        fn = _SHARDING_RULES.get(op.type)
        if fn is None:
            for n in op.output_arg_names:
                if n and n not in placements:
                    senv.set(n, None)
            continue
        try:
            fn(op, senv)
        except Exception:
            for n in op.output_arg_names:
                senv.set(n, None)
    if program_label:
        for d in diags:
            if d.program is None:
                d.program = program_label
    return diags


def check_distributed_spec(program, spec, mesh_axes=None,
                           program_label=None):
    """Validate a :class:`DistributeTranspiler` plan: every declared
    param/grad placement well-formed against the program (+ mesh when
    given), param and grad placements agreeing, then the sharding
    propagation pass over the plan."""
    diags = []
    for name in sorted(set(spec.param_specs) & set(spec.grad_specs)):
        p = _norm_spec(spec.param_specs[name])
        g = _norm_spec(spec.grad_specs[name])
        if p is not None and g is not None and p != g:
            diags.append(Diagnostic(
                "PTA016",
                f"`{name}` is placed {p} as a parameter but its "
                f"gradient is placed {g} — the optimizer update would "
                f"combine differently-sharded tensors", var=name,
                program=program_label))
    diags.extend(check_sharding(program, dict(spec.param_specs),
                                mesh_axes=mesh_axes,
                                program_label=program_label))
    return diags


# -- core sharding rules ----------------------------------------------------

_ELEMENTWISE = ("elementwise_add", "elementwise_sub", "elementwise_mul",
                "elementwise_div", "elementwise_max", "elementwise_min",
                "elementwise_pow")


@sharding_rule(*_ELEMENTWISE)
def _s_elementwise(op, senv):
    senv.merge(op, "X", "Y")


@sharding_rule("relu", "sigmoid", "tanh", "exp", "log", "sqrt", "abs",
               "square", "softmax", "gelu", "scale", "assign", "dropout",
               "cast", "clip", "layer_norm", "batch_norm")
def _s_unary(op, senv):
    x = senv.input_spec(op, "X")
    for slot in ("Out", "Y"):
        if op.output(slot):
            senv.set_output(op, slot, x)


@sharding_rule("mul", "matmul")
def _s_matmul(op, senv):
    x = senv.input_spec(op, "X")
    y = senv.input_spec(op, "Y")
    # contraction sharded on ONE side only is the classic implicit
    # all-gather; sharded on both it lowers to a clean psum
    if x is not None and y is not None and len(x) >= 1 and len(y) >= 1:
        kx = x[-1]
        ky = y[-2] if len(y) >= 2 else y[0]
        if (kx or ky) and kx != ky:
            senv.report(
                "PTA017",
                f"{op.type} contracts `{op.input('X')[0]}` (last dim "
                f"on {kx!r}) against `{op.input('Y')[0]}` (contract "
                f"dim on {ky!r}) — one side must be resharded before "
                f"the matmul", op=op, var=op.input("X")[0])
            senv.set_output(op, "Out", None)
            return
    out = None
    if x is not None and y is not None and len(x) >= 1 and len(y) >= 1:
        out = tuple(x[:-1]) + (y[-1] if len(y) >= 1 else None,)
    senv.set_output(op, "Out", out)


@sharding_rule("transpose", "transpose2")
def _s_transpose(op, senv):
    x = senv.input_spec(op, "X")
    perm = op.attr("axis") or op.attr("perm")
    out = None
    if x is not None and perm and len(perm) == len(x):
        out = tuple(x[p] for p in perm)
    senv.set_output(op, "Out", out)


@sharding_rule("reshape", "reshape2")
def _s_reshape(op, senv):
    senv.set_output(op, "Out", None)  # dim mapping unknown: stay silent


@sharding_rule("lookup_table")
def _s_lookup_table(op, senv):
    # a vocab-sharded table gathers over the mesh (GSPMD's all-to-all,
    # the pserver prefetch analog) — the rows coming OUT follow the ids
    ids = senv.input_spec(op, "Ids")
    out = None
    if ids is not None:
        out = tuple(ids) + (None,)
    senv.set_output(op, "Out", out)


@sharding_rule("merge_selected_rows", "get_tensor_from_selected_rows")
def _s_selected_rows_unary(op, senv):
    # row-set transforms: the logical [height, dim] layout (and thus
    # the placement) carries through unchanged
    senv.set_output(op, "Out", senv.input_spec(op, "X"))


@sharding_rule("sgd", "momentum", "adam", "adamax", "adagrad",
               "rmsprop", "decayed_adagrad", "adadelta", "ftrl")
def _s_optimizer(op, senv):
    p = senv.input_spec(op, "Param")
    g = senv.input_spec(op, "Grad")
    if p is not None and g is not None and p != g:
        senv.report(
            "PTA016",
            f"{op.type} updates `{op.input('Param')[0]}` (placed {p}) "
            f"with a gradient placed {g} — param and grad shardings "
            f"must agree", op=op, var=op.input("Param")[0])
    # ZeRO discipline: every param-shaped state slot of ONE update op
    # must share one placement — a plan that shards moment1 but leaves
    # moment2 replicated (or splits them over different axes) computes
    # the update across misaligned slices.  Params replicated + state
    # sharded is the *intended* ZeRO shape, so param-vs-state
    # disagreement stays silent; only state-vs-state is provably wrong.
    from paddle_tpu_torch.parallel.zero import OPTIMIZER_STATE_SLOTS
    known = []
    for slot in OPTIMIZER_STATE_SLOTS.get(op.type, ()):
        if not op.input(slot):
            continue
        spec = senv.input_spec(op, slot)
        if spec is not None:
            known.append((slot, op.input(slot)[0], spec))
    for (a_slot, a_name, a_spec), (b_slot, b_name, b_spec) in \
            zip(known, known[1:]):
        if a_spec != b_spec:
            senv.report(
                "PTA016",
                f"{op.type} optimizer state is inconsistently sharded: "
                f"`{a_name}` ({a_slot}) placed {a_spec} but `{b_name}` "
                f"({b_slot}) placed {b_spec} — all state slots of one "
                f"update must share a placement (the ZeRO plan owns "
                f"them together)", op=op, var=b_name)
    senv.set_output(op, "ParamOut", p)


# ---------------------------------------------------------------------------
def check_gen_bundle(prefill, decode, meta):
    """``prefill``/``decode``: ``(program, feed_names, fetch_names)``;
    ``meta``: the parsed ``gen_meta.json``.  Proves the
    constant-jit-key contract of the pair."""
    def _names(targets):
        return None if targets is None else \
            [getattr(t, "name", t) for t in targets]

    diags = []
    pre_prog, pre_feeds, pre_fetches = prefill
    dec_prog, dec_feeds, dec_fetches = decode
    pre_feeds, pre_fetches = _names(pre_feeds), _names(pre_fetches)
    dec_feeds, dec_fetches = _names(dec_feeds), _names(dec_fetches)
    cache_vars = list(meta.get("cache_vars") or ())
    num_slots = meta.get("num_slots")
    max_len = meta.get("max_len")
    page_len = meta.get("page_len")
    paged = page_len is not None
    num_pages = meta.get("num_pages")
    pt_feed = meta.get("page_table_feed", "gen_page_table")
    pages_per_slot = None
    if paged and max_len is not None and int(page_len) > 0:
        pages_per_slot = -(-int(max_len) // int(page_len))

    # -- PTA018: prompt buckets must be sane and inside the cache ------
    buckets = list(meta.get("prompt_buckets") or ())
    if not buckets:
        diags.append(Diagnostic(
            "PTA018",
            "gen bundle declares no prompt_buckets — every distinct "
            "prompt length compiles a fresh prefill executable",
            program="gen_meta"))
    else:
        if any(b2 <= b1 for b1, b2 in zip(buckets, buckets[1:])):
            diags.append(Diagnostic(
                "PTA018",
                f"prompt_buckets {buckets} are not strictly "
                f"increasing — row_bucket's edge walk needs sorted "
                f"edges, so lookups past the disorder fall off the "
                f"declared (warmed) ladder", program="gen_meta"))
        if max_len is not None and buckets[-1] > int(max_len):
            diags.append(Diagnostic(
                "PTA018",
                f"largest prompt bucket {buckets[-1]} exceeds the "
                f"cache length {max_len} — the bucket is declared but "
                f"never warmed (warmup skips it), so a prompt landing "
                f"there compiles at request time",
                program="gen_meta"))

    # -- PTA018: page buckets — the paged decode jit-signature ladder --
    if paged:
        pbuckets = list(meta.get("page_buckets") or ())
        if not pbuckets:
            diags.append(Diagnostic(
                "PTA018",
                "paged gen bundle declares no page_buckets — every "
                "distinct live page count compiles a fresh decode "
                "executable", program="gen_meta"))
        else:
            if any(b2 <= b1 for b1, b2 in zip(pbuckets, pbuckets[1:])):
                diags.append(Diagnostic(
                    "PTA018",
                    f"page_buckets {pbuckets} are not strictly "
                    f"increasing — row_bucket's edge walk needs sorted "
                    f"edges, so lookups past the disorder fall off the "
                    f"declared (warmed) ladder", program="gen_meta"))
            if pages_per_slot is not None and \
                    pbuckets[-1] < pages_per_slot:
                diags.append(Diagnostic(
                    "PTA018",
                    f"largest page bucket {pbuckets[-1]} covers only "
                    f"{pbuckets[-1] * int(page_len)} of max_len "
                    f"{max_len} — a slot growing past it escapes the "
                    f"declared (warmed) ladder and compiles at request "
                    f"time", program="gen_meta"))
            if pages_per_slot is not None and \
                    pbuckets[-1] > pages_per_slot:
                diags.append(Diagnostic(
                    "PTA018",
                    f"largest page bucket {pbuckets[-1]} exceeds the "
                    f"per-slot page count {pages_per_slot} — the "
                    f"bucket is declared (and warmed) but no slot can "
                    f"ever reach it", program="gen_meta"))

    # -- PTA019: decode signature must be constant ---------------------
    # (the paged page-table feed is the ONE sanctioned dynamic dim: its
    # width is bucketed by the predictor, so the jit key is the bucket)
    dec_block = dec_prog.global_block()
    for name in dec_feeds or ():
        shape, _ = _var_meta(dec_block, name)
        if paged and name == pt_feed:
            if shape is not None and len(shape) == 2 and \
                    num_slots is not None and shape[0] != int(num_slots):
                diags.append(Diagnostic(
                    "PTA019",
                    f"page-table feed `{name}` is {shape} but must "
                    f"carry one row per slot "
                    f"(num_slots={num_slots})", var=name,
                    program="decode"))
            continue
        if shape is None or any(d < 0 for d in shape):
            diags.append(Diagnostic(
                "PTA019",
                f"decode feed `{name}` has dynamic shape "
                f"{shape} — every decode step must share ONE jit "
                f"signature; admission/eviction would recompile",
                var=name, program="decode"))
    if paged and pt_feed not in (dec_feeds or ()):
        diags.append(Diagnostic(
            "PTA019",
            f"paged gen bundle's decode program does not feed "
            f"`{pt_feed}` — page-bucketed decode cannot address the "
            f"pool", var=pt_feed, program="decode"))
    if paged and num_pages is not None and pages_per_slot is not None \
            and int(num_pages) < pages_per_slot:
        diags.append(Diagnostic(
            "PTA019",
            f"page pool has {num_pages} page(s) but one full-length "
            f"slot needs {pages_per_slot} — a single request hitting "
            f"max_len {max_len} cannot be served", program="gen_meta"))

    # -- PTA019: cache tensors must match the meta geometry ------------
    for name in cache_vars:
        if not dec_block.has_var(name):
            diags.append(Diagnostic(
                "PTA019",
                f"gen_meta names cache var `{name}` but the decode "
                f"program does not declare it", var=name,
                program="decode"))
            continue
        v = dec_block.var(name)
        if not getattr(v, "persistable", False):
            diags.append(Diagnostic(
                "PTA019",
                f"cache var `{name}` is not persistable in the decode "
                f"program — the KV pool would not live across steps",
                var=name, program="decode"))
        shape, _ = _var_meta(dec_block, name)
        if paged:
            if shape is not None and num_pages is not None and \
                    len(shape) >= 2 and \
                    (shape[0] != int(num_pages) or
                     shape[1] != int(page_len)):
                diags.append(Diagnostic(
                    "PTA019",
                    f"cache var `{name}` is {shape} but gen_meta "
                    f"declares [num_pages={num_pages}, "
                    f"page_len={page_len}, ...] — the bundle drifted "
                    f"between export and meta",
                    var=name, program="decode"))
        elif shape is not None and num_slots is not None and \
                max_len is not None and len(shape) >= 2 and \
                (shape[0] != int(num_slots) or shape[1] != int(max_len)):
            diags.append(Diagnostic(
                "PTA019",
                f"cache var `{name}` is {shape} but gen_meta declares "
                f"[num_slots={num_slots}, max_len={max_len}, ...] — "
                f"the bundle drifted between export and meta",
                var=name, program="decode"))

    # -- PTA019: prefill fetch list must seed exactly the cache --------
    if cache_vars and pre_fetches is not None:
        want = 1 + len(cache_vars)  # logits + per-layer K/V
        if len(pre_fetches) != want:
            diags.append(Diagnostic(
                "PTA019",
                f"prefill fetches {len(pre_fetches)} value(s) but the "
                f"decode cache needs {want} (logits + "
                f"{len(cache_vars)} K/V tensors) — the prefill/decode "
                f"signatures drifted", program="prefill"))
        else:
            pre_block = pre_prog.global_block()
            for fetch_name, cache_name in zip(pre_fetches[1:],
                                              cache_vars):
                f_shape, _ = _var_meta(pre_block, fetch_name)
                c_shape, _ = _var_meta(dec_block, cache_name)
                if f_shape is not None and c_shape is not None and \
                        f_shape[-1] > 0 and c_shape[-1] > 0 and \
                        f_shape[-1] != c_shape[-1]:
                    diags.append(Diagnostic(
                        "PTA019",
                        f"prefill K/V fetch `{fetch_name}` has feature "
                        f"dim {f_shape[-1]} but cache `{cache_name}` "
                        f"expects {c_shape[-1]} — seeding the slot "
                        f"would write misshapen rows",
                        var=fetch_name, program="prefill"))
    return diags


def load_saved_program(target):
    """(program, feed_names, fetch_names) from a save_inference_model
    dir (its ``__model__``) or a ``__model__`` json file — the shared
    static loader behind the bundle lint (no params,
    no executor).  Raises the underlying OSError/ValueError/KeyError
    on a malformed target; callers map those to exit code 2."""
    path = os.path.join(target, "__model__") \
        if os.path.isdir(target) else target
    with open(path) as f:
        model = json.load(f)
    return (Program.from_dict(model["program"]),
            model.get("feed_var_names"), model.get("fetch_var_names"))


def lint_gen_bundle(dirname):
    """Multi-program lint of an exported generation bundle
    (``<dirname>/prefill``, ``<dirname>/decode``, ``gen_meta.json``):
    each program through the single-program lint (the structural pass:
    ``analyzer.lint_program``), plus the cross-program PTA018/PTA019
    checks.  Returns a list of
    ``(label, AnalysisResult)`` plus a cross-check AnalysisResult."""
    with open(os.path.join(dirname, "gen_meta.json")) as f:
        meta = json.load(f)
    prefill = load_saved_program(os.path.join(dirname, "prefill"))
    decode = load_saved_program(os.path.join(dirname, "decode"))
    results = [
        ("prefill", lint_program(prefill[0], feed_names=prefill[1],
                                 fetch_names=prefill[2])),
        ("decode", lint_program(decode[0], feed_names=decode[1],
                                fetch_names=decode[2])),
        ("bundle", AnalysisResult(check_gen_bundle(prefill, decode,
                                                   meta))),
    ]
    return results


def verify_gen_bundle(dirname, where="gen.export"):
    """Raising form of :func:`lint_gen_bundle` — the post-export
    self-check ``export_gen_model`` runs, so a drifted bundle fails at
    export, not at the first ``/generate``.  Error-severity findings
    (PTA019 drift) raise; warning-severity recompile hazards (PTA018)
    are logged at warning level — the bundle works, but the operator
    should see the hazard at export time, not in a latency dashboard."""
    import logging

    errors = []
    for label, result in lint_gen_bundle(dirname):
        errors.extend(result.errors)
        for d in result.warnings:
            logging.getLogger(__name__).warning(
                "gen bundle %s: [%s] %s", dirname, label, d.format())
    if errors:
        raise ProgramVerificationError(errors, where=where)
    return errors


def lint_pipeline(program, n_stages, feed_names, fetch_names):
    """Multi-program lint of one program's pipeline split: split into
    stages and validate the stage set (boundary carriers, cross-stage
    collectives, i32 carrier lanes).  Returns an AnalysisResult."""
    from paddle_tpu_torch.analysis.analyzer import check_pipeline_carriers
    from paddle_tpu_torch.parallel.pipeline_transpiler import split_program

    block, stage_ops, _stage_params, boundaries = split_program(
        program, n_stages, list(feed_names or ()),
        list(fetch_names or ()))
    diags = check_stage_set(block, stage_ops, boundaries,
                            feed_names=feed_names or ())
    try:
        check_pipeline_carriers(block, boundaries)
    except ProgramVerificationError as e:
        diags.extend(e.diagnostics)
    return AnalysisResult(diags)


def lint_pair(trainer, pservers):
    """Multi-program lint of a transpiled trainer/pserver family:
    Send/Recv pairing + split reassembly.  ``trainer``/``pservers``
    entries are ``(label, program)``.

    Collective matching is deliberately NOT run here: trainer and
    pserver are different ROLES, not SPMD peers — a trainer's gradient
    all-reduce rendezvouses with the other trainers, never with the
    pserver, so requiring matching sequences across the pair would be
    a guaranteed false positive.  Collective matching applies to
    homogeneous families only (replicas of one role, pipeline stages):
    :func:`check_collective_match` / :func:`check_pipeline_stages`."""
    return AnalysisResult(check_transpiled_pair(trainer, pservers))
