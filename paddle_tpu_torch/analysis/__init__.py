"""Program IR verifier: the structural pass that program rewriters run
after they mutate a program, the shared op-metadata registry
(``opmeta``) and the matrix-product FLOP count (``flops``): the parts of
``paddle_tpu.analysis`` (and ``bench_resnet.py``) ported so far."""

from paddle_tpu_torch.analysis import opmeta  # noqa: F401

from paddle_tpu_torch.analysis.analyzer import (  # noqa: F401
    verify_program, verify_transpiled)
from paddle_tpu_torch.analysis.diagnostics import (  # noqa: F401
    DIAGNOSTIC_CODES, Diagnostic, ProgramVerificationError)
