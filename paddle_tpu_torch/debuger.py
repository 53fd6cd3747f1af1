"""Deprecated alias for :mod:`paddle_tpu_torch.analysis.visualize` (the
port's copy of ``paddle_tpu.debuger``).

The reference repo shipped its visualizers under this (typo'd) path;
the implementation lives in ``paddle_tpu_torch.analysis.visualize``
beside the other static-analysis passes.  Importing this module keeps
working but warns once (at its first import; ``import paddle_tpu_torch``
does not import it) — update imports to::

    from paddle_tpu_torch.analysis.visualize import draw_block_graphviz
"""

from __future__ import annotations

import warnings

from paddle_tpu_torch.analysis.visualize import (  # noqa: F401
    draw_block_graphviz, pprint_block_codes, pprint_program_codes,
    program_dot)

__all__ = ["draw_block_graphviz", "pprint_program_codes",
           "pprint_block_codes", "program_dot"]

warnings.warn(
    "paddle_tpu_torch.debuger is deprecated; use "
    "paddle_tpu_torch.analysis.visualize",
    DeprecationWarning, stacklevel=2)
