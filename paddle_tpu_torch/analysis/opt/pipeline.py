"""Pass pipeline with per-pass verify-sandwich (the port's copy of
``paddle_tpu.analysis.opt.pipeline``).

The sandwich contract: the full analyzer (structure + types + lints)
runs over the program BEFORE the pipeline and AFTER every pass.  The
diagnostic set may only shrink — a pass that *introduces* any
``(code, var, op_type)`` finding not present before it ran is aborted:
its output is discarded, the program reverts to the pre-pass form, and
the abort lands in the report (``opt.pass_aborts``) instead of in a
user's step.  Passes therefore never need to be trusted, only checked.

Each pass mutates a clone; the input program is never touched.  The
pipeline's output carries the per-pass stats (:class:`OptReport`) plus
two statically proven fact attachments:

* ``program._opt_rng_plan = True`` — every op was classified through
  the shared op-metadata registry (``analysis/opmeta.py``), and
  removed/fused ops left ``__rng_slots__`` attrs behind, so surviving
  random ops keep their exact pre-optimization slots on the executor's
  RNG counter (and so their masks);
* ``program._donation_plan`` — the donation/aliasing planner's facts
  (``memory_optimization_transpiler.plan_donation``), proven safe by
  the PTA009 donation-hazard lint.
"""

from __future__ import annotations

import logging

from paddle_tpu_torch.framework import Program

logger = logging.getLogger(__name__)

__all__ = ["PassPipeline", "OptReport", "optimize_program",
           "DEFAULT_PASSES", "clone_program"]

#: the default pass order: fold first (turns arithmetic into
#: constants), CSE second (folding exposes duplicates), DCE third
#: (removes what folding/CSE orphaned plus unfetched autodiff chains),
#: fusion over the final op list, then the two fact emitters — the
#: donation planner and the cost-model compile-amortization gate
DEFAULT_PASSES = ("constant_fold", "cse", "dce", "fuse_elementwise",
                  "donation_plan", "amortize")

#: program attributes the executor/serving layers key behavior off
#: that ``Program.to_dict`` does not carry — the optimized clone must
#: behave identically in every respect but its op list
_RUNTIME_ATTRS = ("_is_inference", "lod_buckets", "check_nan_inf",
                  "_mfu_gauge", "expect_host_ops",
                  # facts earlier passes attached (clone-per-pass must
                  # not drop them)
                  "_donation_plan", "_opt_interpret")


def clone_program(program):
    """Deep-copy ``program`` including the runtime attributes the
    serialization round-trip drops."""
    p = Program.from_dict(program.to_dict())
    program._copy_param_attrs_to(p)
    for attr in _RUNTIME_ATTRS:
        if hasattr(program, attr):
            setattr(p, attr, getattr(program, attr))
    return p


def _diag_keys(result):
    """The sandwich's invariant set: op indices shift as passes remove
    ops, so findings are keyed structurally."""
    return {(d.code, d.var, d.op_type) for d in result.diagnostics}


class OptReport:
    """What the pipeline did: one entry per pass plus program-level
    before/after counts (the ``paddle_tpu_torch opt`` diff report)."""

    def __init__(self):
        self.passes = []          # per-pass dicts
        self.ops_before = 0
        self.ops_after = 0
        self.flops_before = None
        self.flops_after = None

    def add(self, name, status, ops_before, ops_after, stats=None,
            new_diagnostics=()):
        self.passes.append({
            "pass": name, "status": status,
            "ops_before": ops_before, "ops_after": ops_after,
            "stats": dict(stats or {}),
            "new_diagnostics": [d.to_dict() for d in new_diagnostics],
        })

    @property
    def aborted_passes(self):
        return [p["pass"] for p in self.passes
                if p["status"] == "aborted"]

    def ops_removed(self):
        return max(self.ops_before - self.ops_after, 0)

    def to_dict(self):
        return {"format": 1, "ops_before": self.ops_before,
                "ops_after": self.ops_after,
                "flops_before": self.flops_before,
                "flops_after": self.flops_after,
                "passes": self.passes}

    def format(self):
        lines = [f"optimization report: {self.ops_before} -> "
                 f"{self.ops_after} ops"]
        for p in self.passes:
            delta = p["ops_before"] - p["ops_after"]
            stats = ", ".join(f"{k}={v}" for k, v in
                              sorted(p["stats"].items()))
            line = (f"  {p['pass']:<18} {p['status']:<8} "
                    f"ops {p['ops_before']:>4} -> {p['ops_after']:<4}"
                    f" (-{delta})")
            if stats:
                line += f"  [{stats}]"
            lines.append(line)
            for d in p["new_diagnostics"]:
                lines.append(f"      rejected by sandwich: "
                             f"{d['severity']}[{d['code']}] {d['message']}")
        return "\n".join(lines)

    def __repr__(self):
        return (f"OptReport(ops {self.ops_before}->{self.ops_after}, "
                f"passes={[(p['pass'], p['status']) for p in self.passes]})")


class PassPipeline:
    """Ordered passes, each verify-sandwiched.

    ``passes``: iterable of names from
    :data:`~paddle_tpu_torch.analysis.opt.passes.PASS_REGISTRY` or callables
    ``fn(program, ctx) -> stats-dict`` (mutating ``program`` in
    place).  Callables are how the negative tests inject deliberately
    broken passes to prove the sandwich rejects them."""

    def __init__(self, passes=None):
        from paddle_tpu_torch.analysis.opt.passes import PASS_REGISTRY
        selected = DEFAULT_PASSES if passes is None else passes
        self.passes = []
        for p in selected:
            if callable(p):
                self.passes.append((getattr(p, "__name__", "custom"), p))
            else:
                if p not in PASS_REGISTRY:
                    raise ValueError(
                        f"unknown optimization pass {p!r}; known: "
                        f"{sorted(PASS_REGISTRY)}")
                self.passes.append((p, PASS_REGISTRY[p]))

    def run(self, program, feed_names=None, fetch_names=None):
        """Optimize a clone of ``program``; returns ``(optimized,
        OptReport)``.  The input program is never mutated."""
        from paddle_tpu_torch import profiler as _profiler
        from paddle_tpu_torch.analysis import analyzer
        from paddle_tpu_torch.analysis.opt.passes import PassContext

        feed_names = tuple(feed_names or ())
        fetch_names = tuple(fetch_names or ())
        report = OptReport()
        current = clone_program(program)
        report.ops_before = _op_count(current)

        baseline = analyzer.analyze_program(
            current, feed_names=feed_names, fetch_names=fetch_names)
        invariant = _diag_keys(baseline)
        ctx = PassContext(feed_names=feed_names, fetch_names=fetch_names)

        for name, fn in self.passes:
            candidate = clone_program(current)
            ops_before = _op_count(candidate)
            try:
                stats = fn(candidate, ctx) or {}
            except Exception:
                logger.warning("optimization pass %r raised; skipped",
                               name, exc_info=True)
                _profiler.runtime_metrics.inc("opt.pass_aborts")
                report.add(name, "aborted", ops_before, ops_before,
                           {"raised": 1})
                continue
            after = analyzer.analyze_program(
                candidate, feed_names=feed_names,
                fetch_names=fetch_names)
            introduced = [d for d in after.diagnostics
                          if (d.code, d.var, d.op_type) not in invariant]
            if introduced:
                # the sandwich: ANY new finding rejects the pass
                _profiler.runtime_metrics.inc("opt.pass_aborts")
                report.add(name, "aborted", ops_before, ops_before,
                           stats, new_diagnostics=introduced)
                logger.warning(
                    "optimization pass %r introduced %d diagnostic(s); "
                    "reverted to the pre-pass program", name,
                    len(introduced))
                continue
            status = "applied" if (stats or
                                   _op_count(candidate) != ops_before) \
                else "noop"
            report.add(name, status, ops_before, _op_count(candidate),
                       stats)
            current = candidate
            invariant = _diag_keys(after)

        report.ops_after = _op_count(current)
        _profiler.runtime_metrics.inc("opt.programs")
        _profiler.runtime_metrics.inc("opt.ops_removed",
                                      report.ops_removed())
        # statically proven facts: every op classified through the
        # shared op-metadata registry, RNG slots charged
        current._opt_rng_plan = True
        current._opt_report = report
        return current, report


def _op_count(program):
    return sum(len(b.ops) for b in program.blocks)


def optimize_program(program, feed_names=None, fetch_names=None,
                     passes=None):
    """Run the (default) pipeline over ``program``; returns
    ``(optimized_program, OptReport)``.  This is the entry
    ``Executor.run`` memoizes per ``(program, version, fetches)`` under
    ``PADDLE_TPU_OPT=1`` and ``paddle_tpu_torch opt`` exposes offline."""
    from paddle_tpu_torch import profiler as _profiler
    with _profiler.record_latency("opt.seconds"):
        pipe = PassPipeline(passes)
        optimized, report = pipe.run(program, feed_names=feed_names,
                                     fetch_names=fetch_names)
    try:
        from paddle_tpu_torch.analysis import cost
        report.flops_before = cost.estimate(program).total_flops
        report.flops_after = cost.estimate(optimized).total_flops
    except Exception:  # the report survives a cost-model gap
        logger.debug("cost estimate for the opt report failed",
                     exc_info=True)
    return optimized, report
