"""Static analysis over the Program IR (the port of
``paddle_tpu.analysis``): it proves what it can before a program runs.

* :mod:`~paddle_tpu_torch.analysis.structural` — def-before-use across
  nested control-flow blocks, feed/fetch targets, persistable
  re-definition (PTA001–PTA004);
* :mod:`~paddle_tpu_torch.analysis.typecheck` — per-op shape/dtype
  inference rules with a warn-list for uncovered ops (PTA005, PTA006,
  PTA010);
* :mod:`~paddle_tpu_torch.analysis.lints` — dead ops, unused feeds,
  donation/aliasing hazards (PTA007–PTA009);
* :mod:`~paddle_tpu_torch.analysis.distributed` — the generation
  bundle's cross-program checks (PTA018, PTA019);
* :mod:`~paddle_tpu_torch.analysis.opmeta` — the SHARED op-metadata
  registry (pure/effectful/stateful/sub-block classification) the lints,
  the optimization passes and the cost model all ride;
* :mod:`~paddle_tpu_torch.analysis.cost` — static per-op FLOPs/bytes
  cost model (``@cost.rule`` functions over the typecheck shape
  inference);
* :mod:`~paddle_tpu_torch.analysis.opt` — the verify-sandwiched
  optimization pass pipeline (``PADDLE_TPU_OPT=1``, ``python -m
  paddle_tpu_torch opt``);
* :mod:`~paddle_tpu_torch.analysis.visualize` — GraphViz DOT text of a
  Program and pseudo-code pretty printing;
* :mod:`~paddle_tpu_torch.analysis.flops` — the matrix-product FLOP
  count of the convnet MFU convention.

Entry points: ``lint_program`` (everything; ``python -m
paddle_tpu_torch lint``), ``verify_program`` (structural, raising — the
``PADDLE_TPU_VERIFY=1`` executor hook), ``verify_transpiled`` (the
post-rewrite contract every rewriter calls) and ``lint_gen_bundle``.
The cross-program checks of the multi-device transpilers (PTA011–PTA017)
and ``selfcheck`` are not ported yet (ROADMAP queue 1 items 7 and 10).
"""

from paddle_tpu_torch.analysis.analyzer import (  # noqa: F401
    AnalysisResult, analyze_program, lint_program, verify_program,
    verify_transpiled)
from paddle_tpu_torch.analysis.diagnostics import (  # noqa: F401
    DIAGNOSTIC_CODES, Diagnostic, ProgramVerificationError,
    format_diagnostics)
from paddle_tpu_torch.analysis import typecheck  # noqa: F401
from paddle_tpu_torch.analysis import distributed  # noqa: F401
from paddle_tpu_torch.analysis import cost  # noqa: F401
from paddle_tpu_torch.analysis import opmeta  # noqa: F401
from paddle_tpu_torch.analysis import visualize  # noqa: F401
from paddle_tpu_torch.analysis.distributed import (  # noqa: F401
    check_gen_bundle, lint_gen_bundle, load_saved_program,
    verify_gen_bundle)

__all__ = [
    "AnalysisResult", "analyze_program", "lint_program", "verify_program",
    "verify_transpiled", "DIAGNOSTIC_CODES", "Diagnostic",
    "ProgramVerificationError", "format_diagnostics", "typecheck",
    "distributed", "cost", "opmeta", "visualize", "check_gen_bundle",
    "lint_gen_bundle", "load_saved_program", "verify_gen_bundle",
]
