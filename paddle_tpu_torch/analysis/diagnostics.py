"""Diagnostic model for the Program IR static analyzer (the port's copy
of ``paddle_tpu.analysis.diagnostics``).

Every finding the analyzer can emit has a STABLE code (``PTA001``...),
a severity, and a one-line title.  The codes and titles are the JAX
package's, so a finding reads the same in both packages; codes are
never renumbered or reused.  The port emits PTA001–PTA010 and the
gen-bundle checks PTA018–PTA019; PTA011–PTA017 check what the
multi-device transpilers produce (ROADMAP queue 1 item 7).

Severities:
  * ``error``   — the program is provably ill-formed; ``verify_program``
    raises, ``python -m paddle_tpu_torch lint`` exits non-zero.
  * ``warning`` — the program will run but almost certainly not the way
    its author intended (dead ops, unused feeds, donation hazards).

The analyzer's contract is ZERO false positives: a check only fires on
facts provable from the IR alone (all participating shapes/dtypes
statically known, every alias accounted for).  Anything uncertain is
silent — uncovered op types land on the warn-list
(``AnalysisResult.uncovered_op_types``) instead of guessing.
"""

from __future__ import annotations

__all__ = ["DIAGNOSTIC_CODES", "Diagnostic", "ProgramVerificationError",
           "format_diagnostics"]

#: code -> (severity, one-line title).  Append-only; see module docstring.
DIAGNOSTIC_CODES = {
    "PTA001": ("error", "use of undefined variable"),
    "PTA002": ("error", "variable read before it is written"),
    "PTA003": ("error", "missing feed/fetch target"),
    "PTA004": ("error", "persistable variable re-defined inside a step"),
    "PTA005": ("error", "dtype mismatch"),
    "PTA006": ("error", "shape mismatch"),
    "PTA007": ("warning", "dead op (outputs never consumed nor fetched)"),
    "PTA008": ("warning", "unused feed"),
    "PTA009": ("warning", "donated buffer read after its donating op"),
    "PTA010": ("error", "int64 value will silently truncate to int32"),
    # distributed verifier (analysis/distributed.py): cross-program
    # checks over the families a transpile produces — SPMD replicas,
    # pipeline stage sets, trainer/pserver pairs, gen bundles
    "PTA011": ("error",
               "collectives desynced across distributed programs "
               "(static deadlock)"),
    "PTA012": ("error",
               "matched collectives disagree on axis/participants/"
               "shape/dtype"),
    "PTA013": ("error", "Send without matching Recv (or vice versa) "
                        "in a transpiled pair"),
    "PTA014": ("error",
               "parameter/gradient split blocks do not reassemble to "
               "the original shape"),
    "PTA015": ("error",
               "pipeline stage boundary carrier mismatch between "
               "producer and consumer"),
    "PTA016": ("error", "invalid or conflicting sharding spec"),
    "PTA017": ("warning",
               "implicit full reshard (operands sharded differently)"),
    "PTA018": ("warning",
               "recompile hazard: feed can escape its declared "
               "row-bucket edges"),
    "PTA019": ("error",
               "gen bundle prefill/decode signature drift"),
}


class Diagnostic:
    """One analyzer finding, formatted rustc-style by :meth:`format`."""

    __slots__ = ("code", "severity", "message", "block_idx", "op_index",
                 "op_type", "var", "site", "program")

    def __init__(self, code, message, block_idx=None, op_index=None,
                 op_type=None, var=None, site=None, program=None):
        if code not in DIAGNOSTIC_CODES:
            raise ValueError(f"unknown diagnostic code {code!r}")
        self.code = code
        self.severity = DIAGNOSTIC_CODES[code][0]
        self.message = message
        self.block_idx = block_idx
        self.op_index = op_index
        self.op_type = op_type
        self.var = var
        self.site = site  # (filename, lineno) construction site or None
        self.program = program  # member label in a multi-program lint

    @property
    def title(self):
        return DIAGNOSTIC_CODES[self.code][1]

    def location(self):
        parts = []
        if self.program is not None:
            parts.append(f"program `{self.program}`")
        if self.block_idx is not None:
            parts.append(f"block {self.block_idx}")
        if self.op_index is not None:
            parts.append(f"op #{self.op_index}"
                         + (f" `{self.op_type}`" if self.op_type else ""))
        elif self.op_type:
            parts.append(f"op `{self.op_type}`")
        if self.var:
            parts.append(f"var `{self.var}`")
        return ", ".join(parts)

    def format(self):
        lines = [f"{self.severity}[{self.code}]: {self.message}"]
        loc = self.location()
        if loc:
            lines.append(f"  --> {loc}")
        if self.site:
            lines.append(f"   = constructed at {self.site[0]}:{self.site[1]}")
        return "\n".join(lines)

    def to_dict(self):
        return {"code": self.code, "severity": self.severity,
                "message": self.message, "block": self.block_idx,
                "op_index": self.op_index, "op_type": self.op_type,
                "var": self.var, "program": self.program,
                "site": list(self.site) if self.site else None}

    def __repr__(self):
        return f"Diagnostic({self.code}, {self.message!r})"

    __str__ = format


def format_diagnostics(diags):
    """Render a diagnostic list the way ``python -m paddle_tpu_torch lint``
    prints it."""
    return "\n".join(d.format() for d in diags)


class ProgramVerificationError(Exception):
    """Raised when a verified program carries error-severity diagnostics.

    ``diagnostics`` holds every finding (warnings included); ``where``
    names the verification site (``executor.run``, ``append_backward``,
    a transpiler) so the traceback says WHICH rewrite emitted the
    ill-formed program."""

    def __init__(self, diagnostics, where="verify_program"):
        self.diagnostics = list(diagnostics)
        self.where = where
        errors = [d for d in self.diagnostics if d.severity == "error"]
        head = (f"{where}: program verification failed with "
                f"{len(errors)} error(s)")
        super().__init__(head + "\n" + format_diagnostics(self.diagnostics))
