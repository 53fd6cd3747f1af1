"""Memory-optimization pass: liveness over the Program IR (the port's
counterpart of ``paddle_tpu.memory_optimization_transpiler``; reference
``python/paddle/fluid/memory_optimization_transpiler.py``,
``ControlFlowGraph:40`` liveness, ``memory_optimize:332`` in-place var
reuse, ``release_memory:340`` early frees via delete_var ops).

* :class:`ControlFlowGraph` — liveness over one block's op list: the
  reads, writes, live sets and last use of every variable, its greedy
  reuse pairs and its live-byte curve;
* :func:`memory_optimize` — a :class:`MemoryPlan` (the per-block last
  use, the peak with and without reuse, the var -> var reuse pairs, the
  donatable feeds) equal to the JAX package's on the same program,
  attached as ``program._memory_plan``;
* :func:`release_memory` — early release: the executor drops env
  entries after each op once their last use has passed (the reference's
  ``delete_var`` ops).  The JAX package does this only in its op-by-op
  interpret mode, because XLA's buffer assignment frees dead values in
  its compiled step.  The port has no such pass: its env dict holds
  every intermediate until the step ends.  So the port honours the plan
  in every walk of the op list, eager or captured into a CUDA graph
  (whose private pool then reuses the freed blocks later in the same
  capture): its counterpart of XLA's reuse.  It changes no value;
* :func:`plan_donation` (the ``donation_plan`` pass of
  ``analysis/opt``) — the ``stateful_outputs`` in-place-update facts and
  dead-feed donation candidates as a :class:`DonationPlan`, with every
  fact PROVEN safe by the analyzer's PTA009 donation-hazard lint before
  it enters the plan: a var some later op still reads after its in-place
  update is dropped (recorded in ``plan.dropped``), never planned.
"""

from __future__ import annotations

from paddle_tpu_torch.framework import default_main_program

__all__ = ["ControlFlowGraph", "memory_optimize", "release_memory",
           "MemoryPlan", "DonationPlan", "plan_donation"]

_DTYPE_BYTES = {
    "float64": 8, "int64": 8, "float32": 4, "int32": 4, "float16": 2,
    "bfloat16": 2, "int16": 2, "int8": 1, "uint8": 1, "bool": 1,
}


def _var_bytes(var):
    if var is None or var.shape is None:
        return 0
    n = 1
    for d in var.shape:
        if d is None or d < 0:
            d = 1  # batch dim unknown at plan time; relative report only
        n *= d
    return n * _DTYPE_BYTES.get(str(var.dtype), 4)


class ControlFlowGraph:
    """Liveness over one block's op list (reference ``ControlFlowGraph:40``;
    the op list is a straight line — sub-blocks are separate graphs, like
    the reference's ``_get_cfgs``)."""

    def __init__(self, block, skip_vars=()):
        self.block = block
        self.ops = list(block.ops)
        self.skip = set(skip_vars)
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


    def _optimizable(self, name):
        if name in self.skip:
            return False
        try:
            var = self.block.var(name)
        except KeyError:
            return False
        if getattr(var, "persistable", False) or \
                getattr(var, "is_data", False):
            return False
        return var.shape is not None

    def reuse_pairs(self):
        """Greedy first-fit reuse: when var B is defined at op i and some
        dead var A has identical shape+dtype, B may take A's buffer
        (reference memory_optimize pool logic)."""
        pairs = []
        pool = []  # (name, shape, dtype) of dead vars
        last = self.last_use_index()
        reused = set()
        for i, op in enumerate(self.ops):
            for name in sorted(self.defs[i]):
                if not self._optimizable(name) or name in reused:
                    continue
                var = self.block.var(name)
                for j, (cand, shape, dtype) in enumerate(pool):
                    if shape == tuple(var.shape or ()) and \
                            dtype == str(var.dtype):
                        pairs.append((name, cand))
                        reused.add(name)
                        pool.pop(j)
                        break
            # vars that die at this op join the pool
            for name in sorted((self.uses[i] | self.defs[i])):
                if last.get(name) == i and self._optimizable(name) \
                        and name not in self.live_out[i]:
                    var = self.block.var(name)
                    pool.append((name, tuple(var.shape or ()),
                                 str(var.dtype)))
        return pairs

    def byte_curve(self):
        """Per-op live bytes (at op exit), without reuse."""
        curve = []
        for i in range(len(self.ops)):
            live = self.live_out[i] | self.defs[i]
            curve.append(sum(_var_bytes(self._safe_var(n))
                             for n in live if self._optimizable(n)))
        return curve

    def _safe_var(self, name):
        try:
            return self.block.var(name)
        except KeyError:
            return None


class MemoryPlan:
    def __init__(self, program):
        self.program = program
        self.reuse_pairs = []          # (new_var, reused_buffer_of)
        self.last_use = {}             # block idx -> {var: op idx}
        self.peak_bytes = 0
        self.peak_bytes_with_reuse = 0
        self.donatable_feeds = []

    def savings_bytes(self):
        return self.peak_bytes - self.peak_bytes_with_reuse

    def report(self):
        lines = [
            "memory plan for program:",
            f"  estimated peak (no reuse):   {self.peak_bytes:,} bytes",
            f"  estimated peak (with reuse): "
            f"{self.peak_bytes_with_reuse:,} bytes",
            f"  savings: {self.savings_bytes():,} bytes "
            f"({100.0 * self.savings_bytes() / max(self.peak_bytes, 1):.1f}%)",
            f"  reuse pairs: {len(self.reuse_pairs)}",
        ]
        for new, old in self.reuse_pairs[:32]:
            lines.append(f"    {new} <- buffer of {old}")
        if len(self.reuse_pairs) > 32:
            lines.append(f"    ... {len(self.reuse_pairs) - 32} more")
        if self.donatable_feeds:
            lines.append(f"  donatable feeds: "
                         f"{', '.join(sorted(self.donatable_feeds))}")
        return "\n".join(lines)


def memory_optimize(input_program=None, print_log=False, level=0):
    """Analyze and attach a MemoryPlan (reference ``memory_optimize:332``).

    Grad vars (``@GRAD``) are always candidates; ``level`` kept for API
    parity (the reference's level 0/1 = exact/compatible shape match; only
    exact matching is planned, as in the JAX package).
    """
    program = input_program or default_main_program()
    plan = MemoryPlan(program)
    peak = 0
    peak_reuse = 0
    for blk in program.blocks:
        cfg = ControlFlowGraph(blk)
        pairs = cfg.reuse_pairs()
        plan.reuse_pairs.extend(pairs)
        plan.last_use[blk.idx] = cfg.last_use_index()
        curve = cfg.byte_curve()
        if curve:
            peak += max(curve)
            # with-reuse curve: a var that claims a dead buffer costs no
            # new allocation WHILE LIVE, so subtract its bytes from every
            # live set containing it (its donor is dead there, and donor
            # chains are never co-live), then take the new peak
            reused = {new for new, _ in pairs}
            curve_reuse = []
            for i in range(len(cfg.ops)):
                live = cfg.live_out[i] | cfg.defs[i]
                saved = sum(_var_bytes(cfg._safe_var(nm))
                            for nm in live
                            if nm in reused and cfg._optimizable(nm))
                curve_reuse.append(max(curve[i] - saved, 0))
            peak_reuse += max(curve_reuse)
    plan.peak_bytes = peak
    plan.peak_bytes_with_reuse = peak_reuse

    # feeds whose value dies inside the step can be donated by the caller
    gb = program.global_block()
    last = plan.last_use.get(gb.idx, {})
    n_ops = len(gb.ops)
    for v in gb.vars.values():
        if getattr(v, "is_data", False) and v.name in last \
                and last[v.name] < n_ops - 1:
            plan.donatable_feeds.append(v.name)

    program._memory_plan = plan
    # the plan drives early release (the executor drops env entries per
    # last_use): guard it with the structural verifier so a liveness
    # plan is never attached to an ill-formed program
    from paddle_tpu_torch.analysis import verify_transpiled
    verify_transpiled(program, where="memory_optimize")
    if print_log:
        print(plan.report())
    return plan


def release_memory(input_program=None):
    """Enable early release: the executor drops dead env entries after
    each op per the plan (reference ``release_memory:340`` inserts
    delete_var ops), in every walk of the op list, a captured one too
    (see the module docstring).  A released program is a distinct
    executor signature; ``program._release_stats`` holds the bytes and
    vars the last walk dropped."""
    program = input_program or default_main_program()
    if getattr(program, "_memory_plan", None) is None:
        memory_optimize(program)
    program._release_memory = True
    return program._memory_plan


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
