"""Structural verifier: def-before-use, feed/fetch targets, persistable
re-definition (the port's copy of ``paddle_tpu.analysis.structural``).

This is the pass every program rewriter (``append_backward``) runs after
mutating a program — it needs no shape or dtype knowledge, only the op
list and the symbol tables, so it is cheap (one walk over the ops) and
has no false positives by construction:

* **PTA001** — an op input that is declared NOWHERE in the block's
  scope chain and produced by no op.  (Outputs are auto-declared by
  ``append_op``, so an undeclared read can only come from a broken
  hand-built rewrite — exactly what post-transpile verification exists
  to catch.)
* **PTA002** — an op input whose FIRST write in the same block comes
  after the reading op (reading scratch before it exists).  Declared
  vars that are never written at all are implicit feeds / scope state
  (the executor reads them from the scope) and stay silent.  Sub-blocks
  of loop ops (``while``/``recurrent``) are checked leniently: a loop
  body legitimately reads this-iteration values written later in the
  body (the carry), so every name the body writes counts as defined.
* **PTA003** — a requested feed/fetch name that resolves to no variable
  and no op output.
* **PTA004** — a persistable/parameter var overwritten by an op that
  neither reads it (the in-place self-update idiom: optimizers,
  batch_norm running stats) nor declares the slot in its opdef's
  ``stateful_outputs``, AFTER an earlier op already read the var.  A
  startup program initializing params (write, no prior read) is fine;
  a step program clobbering a param it already consumed is not.
"""

from __future__ import annotations

from paddle_tpu_torch import framework
from paddle_tpu_torch.analysis.diagnostics import Diagnostic

__all__ = ["check_structure"]

# sub-blocks of these op types carry loop semantics: a read inside the
# body may be satisfied by a later write in the SAME body (previous
# iteration's value) — def-before-use is checked leniently there
_LOOP_OP_TYPES = frozenset({"while", "recurrent", "while_grad",
                            "recurrent_grad"})


def _sub_blocks(op):
    for a in op.attrs.values():
        if isinstance(a, framework.Block):
            yield a


def _reads_of(op):
    """Input names of ``op`` plus every outer-name read inside its
    sub-blocks that the sub-blocks themselves do not produce."""
    reads = [n for n in op.input_arg_names if n]
    for blk in _sub_blocks(op):
        reads.extend(_external_reads(blk))
    return reads


def _external_reads(block):
    produced = set()
    ext = []
    for op in block.ops:
        for n in op.input_arg_names:
            if n and n not in produced and not block.has_var_local(n):
                ext.append(n)
        for n in op.output_arg_names:
            if n:
                produced.add(n)
        for sub in _sub_blocks(op):
            ext.extend(n for n in _external_reads(sub)
                       if n not in produced)
    return ext


def _declared(block, name):
    try:
        block.var(name)
        return True
    except KeyError:
        return False


def _state_like(block, name):
    """Names the executor serves from the scope without a producing op:
    persistable state (params, optimizer moments, running stats),
    declared feeds (``is_data``), and runtime objects (readers,
    tensor arrays built by earlier programs)."""
    try:
        v = block.var(name)
    except KeyError:
        return False
    return bool(getattr(v, "persistable", False) or
                getattr(v, "is_data", False) or
                getattr(v, "type", "lod_tensor") in ("reader",
                                                     "tensor_array"))


def check_structure(program, feed_names=None, fetch_names=None):
    """Run the structural checks; returns a list of Diagnostics."""
    diags = []
    gblock = program.global_block()

    produced_anywhere = set()
    for blk in program.blocks:
        for op in blk.ops:
            produced_anywhere.update(n for n in op.output_arg_names if n)

    for kind, names in (("feed", feed_names or ()),
                        ("fetch", fetch_names or ())):
        for name in names:
            if not gblock.has_var(name) and name not in produced_anywhere:
                diags.append(Diagnostic(
                    "PTA003",
                    f"{kind} target `{name}` is not a variable of the "
                    f"program and no op produces it",
                    block_idx=0, var=name))

    _check_block(gblock, set(), diags, lenient=False)
    return diags


def _writes_in(block):
    names = set()
    for op in block.ops:
        names.update(n for n in op.output_arg_names if n)
        for sub in _sub_blocks(op):
            names.update(_writes_in(sub))
    return names


def _check_block(block, outer_defined, diags, lenient):
    defined = set(outer_defined)
    if lenient:
        defined |= _writes_in(block)

    # first write index per name (this block only) for PTA002 messages
    first_write = {}
    for i, op in enumerate(block.ops):
        for n in op.output_arg_names:
            if n and n not in first_write:
                first_write[n] = i

    read_before = {}   # name -> first op index that read it (PTA004)
    written_by = {}    # persistable name -> first non-self-update writer

    from paddle_tpu_torch.ops import registry as _registry

    for i, op in enumerate(block.ops):
        if op.type in ("feed", "fetch"):
            continue
        site = getattr(op, "creation_site", None)
        for n in _reads_of(op):
            read_before.setdefault(n, i)
            if n in defined or _state_like(block, n):
                continue
            if not _declared(block, n) and n not in first_write:
                diags.append(Diagnostic(
                    "PTA001",
                    f"op `{op.type}` reads `{n}`, which is declared "
                    f"nowhere in block {block.idx}'s scope chain and "
                    f"produced by no op",
                    block_idx=block.idx, op_index=i, op_type=op.type,
                    var=n, site=site))
            elif first_write.get(n, -1) > i:
                diags.append(Diagnostic(
                    "PTA002",
                    f"op `{op.type}` reads `{n}` at op #{i}, but its "
                    f"first write is op #{first_write[n]} "
                    f"(`{block.ops[first_write[n]].type}`) — the value "
                    f"is undefined at the read",
                    block_idx=block.idx, op_index=i, op_type=op.type,
                    var=n, site=site))
            # declared but never written: implicit feed/scope state

        opdef = _registry.lookup(op.type)
        stateful = opdef.stateful_outputs if opdef is not None else ()
        op_reads = set(op.input_arg_names)
        for slot, names in op.outputs.items():
            for n in names:
                if not n:
                    continue
                defined.add(n)
                if slot in stateful or n in op_reads:
                    continue  # declared in-place state update
                try:
                    v = block.var(n)
                except KeyError:
                    continue
                if not getattr(v, "persistable", False):
                    continue
                prior_read = read_before.get(n)
                if prior_read is not None and prior_read < i:
                    diags.append(Diagnostic(
                        "PTA004",
                        f"persistable `{n}` "
                        f"{'(parameter) ' if isinstance(v, framework.Parameter) else ''}"
                        f"is overwritten by op `{op.type}` at op #{i} "
                        f"after op #{prior_read} already read it — a "
                        f"step must not re-define its own state "
                        f"(declare the slot in stateful_outputs if this "
                        f"is an intended in-place update)",
                        block_idx=block.idx, op_index=i, op_type=op.type,
                        var=n, site=site))
                elif n in written_by:
                    diags.append(Diagnostic(
                        "PTA004",
                        f"persistable `{n}` is defined twice: op "
                        f"#{written_by[n]} and op #{i} (`{op.type}`) "
                        f"both overwrite it within one step",
                        block_idx=block.idx, op_index=i, op_type=op.type,
                        var=n, site=site))
                else:
                    written_by[n] = i

        for sub in _sub_blocks(op):
            _check_block(sub, defined, diags,
                         lenient=op.type in _LOOP_OP_TYPES)
