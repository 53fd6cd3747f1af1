"""Model programs of the serving slice: the generative LM
(:mod:`gen_lm`, :mod:`gen_lm_long`) and the position table it shares
with the Transformer (:mod:`transformer`)."""

from paddle_tpu_torch.models import gen_lm, gen_lm_long, transformer

__all__ = ["gen_lm", "gen_lm_long", "transformer"]
