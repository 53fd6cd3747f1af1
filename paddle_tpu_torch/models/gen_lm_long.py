"""Long-sequence flagship config of the generative LM: the
:mod:`gen_lm` architecture with ``max_len`` 256, the context length the
PAGED KV layout exists for.  Registered in ``ZOO_MODELS`` so the lint
and the optimization pipeline cover the long-sequence geometry."""

from paddle_tpu_torch.models import gen_lm

__all__ = ["GenLongConfig", "gen_lm_long_train_program"]


class GenLongConfig(gen_lm.GenConfig):
    """``GenConfig`` at flagship context length (4x the base 64)."""
    max_len = 256


def gen_lm_long_train_program(batch_size, seq_len, hp: GenLongConfig = None):
    """Teacher-forced training forward at the long-context geometry;
    returns ``(avg_cost, feed_names)`` like
    :func:`gen_lm.gen_lm_train_program`."""
    return gen_lm.gen_lm_train_program(batch_size, seq_len,
                                       hp or GenLongConfig())
