"""Verifier entry points (the structural half of
``paddle_tpu.analysis.analyzer``): ``verify_program`` runs the
structural pass and raises on error findings; ``verify_transpiled`` is
the same with a ``where=`` tag, called by every program rewriter
(``backward.append_backward``) so a rewrite that emits an ill-formed
program fails AT THE REWRITE, with the pass named."""

from __future__ import annotations

from paddle_tpu_torch.analysis import structural
from paddle_tpu_torch.analysis.diagnostics import ProgramVerificationError

__all__ = ["verify_program", "verify_transpiled"]


def verify_program(program, feed_names=None, fetch_names=None,
                   where="verify_program"):
    """Structural verification; raises :class:`ProgramVerificationError`
    on errors and returns the (possibly empty) diagnostics otherwise."""
    diags = structural.check_structure(program, feed_names=feed_names,
                                       fetch_names=fetch_names)
    order = {"error": 0, "warning": 1}
    diags.sort(key=lambda d: (order[d.severity], d.code,
                              d.op_index if d.op_index is not None else -1))
    if any(d.severity == "error" for d in diags):
        raise ProgramVerificationError(diags, where=where)
    return diags


def verify_transpiled(program, where):
    """Post-rewrite contract check: a pass that emits a structurally
    broken program must fail HERE, naming itself."""
    return verify_program(program, where=where)
