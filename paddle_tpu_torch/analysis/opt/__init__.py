"""Program-IR optimization passes (the port's copy of
``paddle_tpu.analysis.opt``): the analyzer's dataflow turned from
*checking* programs to *transforming* them before the executor runs
them.  They shrink the op list the eager executor dispatches and attach
statically proven facts (the donation plan, the RNG-slot plan).

Every pass runs inside a **verify-sandwich**: the full analyzer
(structure + types + lints) runs before the pipeline and after every
pass, with the PTA codes as invariants — any diagnostic a pass
*introduces* aborts that pass and the program reverts to its pre-pass
form (``opt.pass_aborts``).  Correctness never rests on a pass being
right; it rests on the sandwich.

Entry points: :func:`optimize_program` (what ``Executor.run`` calls
once per ``(program, version, feeds, fetches)`` under
``PADDLE_TPU_OPT=1``, and ``python -m paddle_tpu_torch opt`` wraps for
offline inspection), :class:`PassPipeline` (compose your own), and the
individual passes in :mod:`~paddle_tpu_torch.analysis.opt.passes`.
"""

from paddle_tpu_torch.analysis.opt.pipeline import (DEFAULT_PASSES,
                                                    OptReport, PassPipeline,
                                                    clone_program,
                                                    optimize_program)
from paddle_tpu_torch.analysis.opt import passes

__all__ = ["PassPipeline", "OptReport", "optimize_program",
           "DEFAULT_PASSES", "clone_program", "passes"]
