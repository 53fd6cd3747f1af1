"""Analyzer entry points (the port's copy of
``paddle_tpu.analysis.analyzer``): compose the passes, gate the
executor hook, verify transpiler output.

Three call sites, three shapes:

* ``lint_program`` — everything (structure + types + graph lints), for
  ``python -m paddle_tpu_torch lint`` and the model-zoo gate.  Returns
  an :class:`AnalysisResult`; never raises.
* ``verify_program`` — the structural pass only; raises
  :class:`ProgramVerificationError` on error-severity findings.  This
  is what ``PADDLE_TPU_VERIFY=1`` runs in ``Executor.run`` before a
  program's first run (memoized per program version — a cached step
  pays one set lookup).
* ``verify_transpiled`` — ``verify_program`` with a ``where=`` tag,
  called by every program rewriter (``backward.append_backward``) so a
  rewrite that emits an ill-formed program fails AT THE REWRITE with
  the pass named.

``check_pipeline_carriers`` checks what the pipeline transpiler
produces and comes with it (ROADMAP queue 1 item 7).
"""

from __future__ import annotations

from paddle_tpu_torch.analysis import lints, structural, typecheck
from paddle_tpu_torch.analysis.diagnostics import (ProgramVerificationError,
                                                   format_diagnostics)

__all__ = ["AnalysisResult", "analyze_program", "lint_program",
           "verify_program", "verify_transpiled"]


class AnalysisResult:
    """Findings of one analyzer run over a program."""

    def __init__(self, diagnostics, uncovered_op_types=()):
        self.diagnostics = list(diagnostics)
        #: the warn-list: op types with no registered inference rule —
        #: shapes/dtypes were not propagated through them (coverage gap,
        #: not a defect)
        self.uncovered_op_types = sorted(uncovered_op_types)

    @property
    def errors(self):
        return [d for d in self.diagnostics if d.severity == "error"]

    @property
    def warnings(self):
        return [d for d in self.diagnostics if d.severity == "warning"]

    def codes(self):
        return sorted({d.code for d in self.diagnostics})

    def format(self):
        return format_diagnostics(self.diagnostics)

    def raise_on_errors(self, where="verify_program"):
        if self.errors:
            raise ProgramVerificationError(self.diagnostics, where=where)
        return self

    def __repr__(self):
        return (f"AnalysisResult(errors={len(self.errors)}, "
                f"warnings={len(self.warnings)}, "
                f"uncovered={len(self.uncovered_op_types)})")


def analyze_program(program, feed_names=None, fetch_names=None,
                    passes=("structure", "types", "lints")):
    """Run the selected passes; returns an :class:`AnalysisResult`."""
    diags = []
    uncovered = set()
    if "structure" in passes:
        diags.extend(structural.check_structure(
            program, feed_names=feed_names, fetch_names=fetch_names))
    if "types" in passes:
        tdiags, uncovered = typecheck.check_types(program)
        diags.extend(tdiags)
    if "lints" in passes:
        diags.extend(lints.check_graph(program, feed_names=feed_names,
                                       fetch_names=fetch_names))
    order = {"error": 0, "warning": 1}
    diags.sort(key=lambda d: (order[d.severity], d.code,
                              d.op_index if d.op_index is not None else -1))
    return AnalysisResult(diags, uncovered)


def lint_program(program, feed_names=None, fetch_names=None):
    """All passes — what ``paddle_tpu lint`` and the zoo gate run."""
    return analyze_program(program, feed_names=feed_names,
                           fetch_names=fetch_names)


def verify_program(program, feed_names=None, fetch_names=None,
                   where="verify_program"):
    """Structural verification; raises ProgramVerificationError on
    errors.  Returns the AnalysisResult when clean."""
    result = analyze_program(program, feed_names=feed_names,
                             fetch_names=fetch_names,
                             passes=("structure",))
    return result.raise_on_errors(where=where)


def verify_transpiled(program, where):
    """Post-rewrite contract check for transpilers: a pass that emits a
    structurally broken program must fail HERE, naming itself."""
    return verify_program(program, where=where)
