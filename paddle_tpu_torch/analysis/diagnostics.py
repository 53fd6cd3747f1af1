"""Diagnostic model of the Program IR verifier (the part of
``paddle_tpu.analysis.diagnostics`` the structural pass uses).

Every finding has a STABLE code (``PTA001``...), a severity and a
one-line title; the codes are the JAX package's, so a finding reads the
same in both packages.  Severities: ``error`` — the program is provably
ill-formed and ``verify_program`` raises; ``warning`` — it runs, but not
the way its author meant.
"""

from __future__ import annotations

__all__ = ["DIAGNOSTIC_CODES", "Diagnostic", "ProgramVerificationError",
           "format_diagnostics"]

#: code -> (severity, one-line title): the structural pass's codes
DIAGNOSTIC_CODES = {
    "PTA001": ("error", "use of undefined variable"),
    "PTA002": ("error", "variable read before it is written"),
    "PTA003": ("error", "missing feed/fetch target"),
    "PTA004": ("error", "persistable variable re-defined inside a step"),
}


class Diagnostic:
    """One verifier finding, formatted rustc-style by :meth:`format`."""

    __slots__ = ("code", "severity", "message", "block_idx", "op_index",
                 "op_type", "var", "site")

    def __init__(self, code, message, block_idx=None, op_index=None,
                 op_type=None, var=None, site=None):
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

    @property
    def title(self):
        return DIAGNOSTIC_CODES[self.code][1]

    def location(self):
        parts = []
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

    def __repr__(self):
        return f"Diagnostic({self.code}, {self.message!r})"

    __str__ = format


def format_diagnostics(diags):
    return "\n".join(d.format() for d in diags)


class ProgramVerificationError(Exception):
    """Raised when a verified program carries error-severity diagnostics;
    ``where`` names the verification site (``append_backward``...)."""

    def __init__(self, diagnostics, where="verify_program"):
        self.diagnostics = list(diagnostics)
        self.where = where
        errors = [d for d in self.diagnostics if d.severity == "error"]
        head = (f"{where}: program verification failed with "
                f"{len(errors)} error(s)")
        super().__init__(head + "\n" + format_diagnostics(self.diagnostics))
