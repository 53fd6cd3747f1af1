"""Program IR verifier: the structural pass that program rewriters run
after they mutate a program (the part of ``paddle_tpu.analysis`` the
training slice uses)."""

from paddle_tpu_torch.analysis.analyzer import (  # noqa: F401
    verify_program, verify_transpiled)
from paddle_tpu_torch.analysis.diagnostics import (  # noqa: F401
    DIAGNOSTIC_CODES, Diagnostic, ProgramVerificationError)
