"""Verifier entry points (the structural half of
``paddle_tpu.analysis.analyzer``): ``verify_program`` runs the
structural pass and raises on error findings; ``verify_transpiled`` is
the same with a ``where=`` tag, called by every program rewriter
(``backward.append_backward``) so a rewrite that emits an ill-formed
program fails AT THE REWRITE, with the pass named."""

from __future__ import annotations

from paddle_tpu_torch.analysis import structural
from paddle_tpu_torch.analysis.diagnostics import (ProgramVerificationError,
                                                   format_diagnostics)

__all__ = ["AnalysisResult", "lint_program", "verify_program",
           "verify_transpiled"]

_ORDER = {"error": 0, "warning": 1}


def _sorted(diags):
    return sorted(diags, key=lambda d: (
        _ORDER[d.severity], d.code,
        d.op_index if d.op_index is not None else -1))


class AnalysisResult:
    """Findings of one analyzer run over a program (or, for a generation
    bundle, over the prefill/decode pair)."""

    def __init__(self, diagnostics):
        self.diagnostics = list(diagnostics)

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
                f"warnings={len(self.warnings)})")


def lint_program(program, feed_names=None, fetch_names=None):
    """The structural pass as an :class:`AnalysisResult` (the JAX
    package's lint also runs its type and graph passes, which are not
    ported yet)."""
    return AnalysisResult(_sorted(structural.check_structure(
        program, feed_names=feed_names, fetch_names=fetch_names)))


def verify_program(program, feed_names=None, fetch_names=None,
                   where="verify_program"):
    """Structural verification; raises :class:`ProgramVerificationError`
    on errors and returns the (possibly empty) diagnostics otherwise."""
    diags = lint_program(program, feed_names, fetch_names).diagnostics
    if any(d.severity == "error" for d in diags):
        raise ProgramVerificationError(diags, where=where)
    return diags


def verify_transpiled(program, where):
    """Post-rewrite contract check: a pass that emits a structurally
    broken program must fail HERE, naming itself."""
    return verify_program(program, where=where)
