"""Liveness over the Program IR and the donation/aliasing planner (the
part of ``paddle_tpu.memory_optimization_transpiler`` the optimization
pipeline needs; reference
``python/paddle/fluid/memory_optimization_transpiler.py``,
``ControlFlowGraph:40``).

* :class:`ControlFlowGraph` — liveness over one block's op list: the
  reads, writes, live sets and last use of every variable (its reuse
  pairs and live-byte curve come with ``memory_optimize``);
* :func:`plan_donation` (the ``donation_plan`` pass of
  ``analysis/opt``) — the ``stateful_outputs`` in-place-update facts and
  dead-feed donation candidates as a :class:`DonationPlan`, with every
  fact PROVEN safe by the analyzer's PTA009 donation-hazard lint before
  it enters the plan: a var some later op still reads after its in-place
  update is dropped (recorded in ``plan.dropped``), never planned.

``memory_optimize`` and ``release_memory`` (reuse plans and the early
release of dead intermediates) are not ported yet: ROADMAP queue 1
item 7.
"""

from __future__ import annotations

from paddle_tpu_torch.framework import default_main_program

__all__ = ["ControlFlowGraph", "DonationPlan", "plan_donation"]


class ControlFlowGraph:
    """Liveness over one block's op list (reference ``ControlFlowGraph:40``;
    the op list is a straight line — sub-blocks are separate graphs, like
    the reference's ``_get_cfgs``)."""

    def __init__(self, block):
        self.block = block
        self.ops = list(block.ops)
        self.uses = []   # per op: set of read var names
        self.defs = []   # per op: set of written var names
        self.live_in = []
        self.live_out = []
        for op in self.ops:
            self.uses.append({n for n in op.input_arg_names if n})
            self.defs.append({n for n in op.output_arg_names if n})
        self._dataflow()

    def _dataflow(self):
        n = len(self.ops)
        self.live_in = [set() for _ in range(n)]
        self.live_out = [set() for _ in range(n)]
        # single backward sweep suffices on a straight-line block
        succ_live_in = set()
        for i in range(n - 1, -1, -1):
            self.live_out[i] = set(succ_live_in)
            self.live_in[i] = self.uses[i] | (self.live_out[i] -
                                              self.defs[i])
            succ_live_in = self.live_in[i]

    def last_use_index(self):
        """var name -> index of the op after which it is dead."""
        last = {}
        for i, (u, d) in enumerate(zip(self.uses, self.defs)):
            for name in u | d:
                last[name] = i
        return last


# ---------------------------------------------------------------------------
# donation/aliasing planner (the analysis/opt ``donation_plan`` pass)
# ---------------------------------------------------------------------------

class DonationPlan:
    """Statically proven donation facts for one program.

    * ``donatable_feeds`` — feed vars whose value dies inside the step
      (their device buffer may be donated to the executable);
    * ``inplace_updates`` — ``{var: (op_index, op_type, slot)}`` for
      every declared ``stateful_outputs`` write whose post-update
      buffer is provably never read again in the step: exactly the
      aliasing the executor's donated in-out state path performs, now
      proven hazard-free instead of assumed;
    * ``dropped`` — facts the PTA009 donation-hazard lint REFUSED: the
      var is read after its in-place update, so donating it would hand
      the reader a poisoned buffer (and break the sentinel's skip-step
      discard).  These stay observable, never planned.
    """

    def __init__(self):
        self.donatable_feeds = []
        self.inplace_updates = {}
        self.dropped = []      # (var, reason) facts the lint rejected

    def to_dict(self):
        return {"donatable_feeds": sorted(self.donatable_feeds),
                "inplace_updates": {
                    n: {"op_index": i, "op_type": t, "slot": s}
                    for n, (i, t, s) in
                    sorted(self.inplace_updates.items())},
                "dropped": [{"var": v, "reason": r}
                            for v, r in self.dropped]}

    def report(self):
        lines = [f"donation plan: {len(self.donatable_feeds)} "
                 f"donatable feed(s), {len(self.inplace_updates)} "
                 f"proven in-place update(s), {len(self.dropped)} "
                 f"hazard(s) dropped"]
        for n in sorted(self.donatable_feeds):
            lines.append(f"  feed {n}: dies inside the step — donatable")
        for n, (i, t, slot) in sorted(self.inplace_updates.items()):
            lines.append(f"  state {n}: in-place update by op #{i} "
                         f"`{t}` ({slot}) — hazard-free")
        for v, r in self.dropped:
            lines.append(f"  DROPPED {v}: {r}")
        return "\n".join(lines)

    def __repr__(self):
        return (f"DonationPlan(feeds={len(self.donatable_feeds)}, "
                f"inplace={len(self.inplace_updates)}, "
                f"dropped={len(self.dropped)})")


def plan_donation(program, feed_names=None, fetch_names=None):
    """Build (and attach as ``program._donation_plan``) the donation/
    aliasing plan.  Every candidate fact is checked against the
    analyzer's PTA009 donation-hazard lint — a hazard on a var removes
    it from the plan rather than shipping an unsafe aliasing claim."""
    from paddle_tpu_torch.analysis import lints
    from paddle_tpu_torch.ops import registry

    program = program or default_main_program()
    block = program.global_block()
    plan = DonationPlan()

    # the existing PTA009 lint IS the proof obligation: collect the
    # vars it flags as read-after-in-place-update
    hazardous = {}
    for d in lints.check_graph(program, feed_names=feed_names,
                               fetch_names=fetch_names):
        if d.code == "PTA009" and d.var:
            hazardous.setdefault(d.var, d.message)

    # in-place update facts (slot declared stateful in the opdef)
    for i, op in enumerate(block.ops):
        opdef = registry.lookup(op.type)
        if opdef is None or not opdef.stateful_outputs:
            continue
        for slot in opdef.stateful_outputs:
            for n in op.output(slot):
                if not n:
                    continue
                if n in hazardous:
                    plan.dropped.append((n, hazardous[n]))
                elif n not in plan.inplace_updates:
                    plan.inplace_updates[n] = (i, op.type, slot)

    # feeds whose buffer dies inside the step: liveness says their last
    # use precedes the end of the block AND they are never fetched
    if feed_names is None:
        feed_names = [v.name for v in block.vars.values()
                      if getattr(v, "is_data", False)]
    fetch_set = set(fetch_names or ())
    cfg = ControlFlowGraph(block)
    last = cfg.last_use_index()
    n_ops = len(block.ops)
    for name in feed_names:
        if name in fetch_set or name in hazardous:
            continue
        if name in last and last[name] < n_ops - 1:
            plan.donatable_feeds.append(name)

    program._donation_plan = plan
    return plan
