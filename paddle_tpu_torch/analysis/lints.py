"""Graph lints: dead ops, unused feeds, donation/aliasing hazards (the
port's copy of ``paddle_tpu.analysis.lints``, messages included).

These are warnings, not errors — the program runs, but some of it is
wasted work (dead ops compile and execute for nothing) or quietly
dangerous (a donated buffer read after its in-place update poisons the
sentinel's skip-step discard).  The zero-false-positive contract
applies: an op with ANY effect besides its dataflow outputs (host ops,
sub-blocks, persistable writes, declared stateful/aliasing outputs,
RNG, readers/CSP/persistence) is never called dead.
"""

from __future__ import annotations

from paddle_tpu_torch.analysis.diagnostics import Diagnostic
from paddle_tpu_torch.analysis.structural import _external_reads, _sub_blocks

# op effect classification lives in the SHARED registry
# (analysis/opmeta.py) so this lint's exemptions, the opt passes'
# removal guards, and the cost model can never drift apart — the
# scanner test (tests/test_torch_optim.py) enforces single ownership
from paddle_tpu_torch.analysis.opmeta import has_effects as _has_effects

__all__ = ["check_graph"]


def check_graph(program, feed_names=None, fetch_names=None):
    diags = []
    block = program.global_block()
    from paddle_tpu_torch.ops import registry

    persistable = {v.name for blk in program.blocks
                   for v in blk.vars.values()
                   if getattr(v, "persistable", False)}

    # ---- dead ops (PTA007): reverse liveness sweep, prune()-style ----
    needed = set(fetch_names or ())
    needed |= persistable  # a persistable write IS an effect
    live = [False] * len(block.ops)
    for i in range(len(block.ops) - 1, -1, -1):
        op = block.ops[i]
        outs = [n for n in op.output_arg_names if n]
        if _has_effects(op, registry) or any(n in needed for n in outs):
            live[i] = True
            needed.update(n for n in op.input_arg_names if n)
            for sub in _sub_blocks(op):
                needed.update(_external_reads(sub))
    for i, op in enumerate(block.ops):
        if live[i]:
            continue
        outs = sorted({n for n in op.output_arg_names if n})
        if outs and all("@GRAD" in n for n in outs):
            # autodiff artifacts: append_backward emits grad chains for
            # every path even when only the param grads are consumed,
            # callers fetch arbitrary grad vars ad hoc (calc_gradient,
            # OpTest), and the DCE pass drops the unused ones —
            # flagging them would be all noise, so the dead-op lint
            # covers user/transpiler-authored ops only
            continue
        diags.append(Diagnostic(
            "PTA007",
            f"op `{op.type}` at op #{i} is dead: its output(s) "
            f"{outs} are never consumed by a later op, never fetched, "
            f"and not persistable — it compiles and runs for nothing",
            block_idx=block.idx, op_index=i, op_type=op.type,
            var=outs[0] if outs else None,
            site=getattr(op, "creation_site", None)))

    # ---- unused feeds (PTA008) ----
    reads = set()
    for blk in program.blocks:
        for op in blk.ops:
            reads.update(n for n in op.input_arg_names if n)
    if feed_names is not None:
        feeds = list(feed_names)
    else:
        feeds = [v.name for v in block.vars.values()
                 if getattr(v, "is_data", False)]
        if not any(n in reads for n in feeds):
            # a program that reads NO feed at all is not a step program
            # (startup/init programs carry mirrored data vars for parity)
            feeds = []
    for name in feeds:
        if name not in reads and name not in (fetch_names or ()):
            diags.append(Diagnostic(
                "PTA008",
                f"feed `{name}` is declared but no op reads it — "
                f"dropping it from the feed list saves a host->device "
                f"transfer per step",
                block_idx=block.idx, var=name))

    # ---- donation/aliasing hazards (PTA009) ----
    # An op whose opdef declares stateful_outputs updates those vars
    # IN PLACE (the executor donates their buffers across steps).  Any
    # later op reading such a var observes the post-update value — and
    # a sentinel skip-step (which discards the update) cannot give that
    # reader back the pre-step state it already consumed.
    donated_at = {}  # var name -> (op index, op type) of the donating op
    for i, op in enumerate(block.ops):
        for n in op.input_arg_names:
            if n in donated_at:
                j, jtype = donated_at[n]
                diags.append(Diagnostic(
                    "PTA009",
                    f"op `{op.type}` at op #{i} reads `{n}` after op "
                    f"#{j} (`{jtype}`) updated it in place — under "
                    f"buffer donation the reader sees the post-update "
                    f"buffer, and a sentinel skip-step discard cannot "
                    f"restore the value it consumed; read the var "
                    f"before the update, or fetch it instead",
                    block_idx=block.idx, op_index=i, op_type=op.type,
                    var=n, site=getattr(op, "creation_site", None)))
        opdef = registry.lookup(op.type)
        if opdef is not None and opdef.stateful_outputs:
            for slot in opdef.stateful_outputs:
                for n in op.output(slot):
                    if n:
                        donated_at[n] = (i, op.type)

    return diags
