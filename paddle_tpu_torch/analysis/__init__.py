"""Program IR verifier: the structural pass that program rewriters run
after they mutate a program, the generation-bundle contract checks
(``distributed``), the shared op-metadata registry (``opmeta``) and the
matrix-product FLOP count (``flops``): the parts of
``paddle_tpu.analysis`` (and ``bench_resnet.py``) ported so far."""

from paddle_tpu_torch.analysis import opmeta  # noqa: F401

from paddle_tpu_torch.analysis.analyzer import (  # noqa: F401
    AnalysisResult, lint_program, verify_program, verify_transpiled)
from paddle_tpu_torch.analysis.diagnostics import (  # noqa: F401
    DIAGNOSTIC_CODES, Diagnostic, ProgramVerificationError)
from paddle_tpu_torch.analysis.distributed import (  # noqa: F401
    check_gen_bundle, lint_gen_bundle, load_saved_program,
    verify_gen_bundle)
