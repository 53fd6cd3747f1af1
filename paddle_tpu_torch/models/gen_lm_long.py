"""Long-sequence flagship config of the generative LM: the
:mod:`gen_lm` architecture with ``max_len`` 256, the context length the
PAGED KV layout exists for."""

from paddle_tpu_torch.models import gen_lm

__all__ = ["GenLongConfig"]


class GenLongConfig(gen_lm.GenConfig):
    """``GenConfig`` at flagship context length (4x the base 64)."""
    max_len = 256
