"""Model programs of the port: the generative LM (:mod:`gen_lm`,
:mod:`gen_lm_long`), the Transformer (:mod:`transformer`) and the conv
zoo (:mod:`resnet`, :mod:`vgg`, :mod:`mnist`)."""

from paddle_tpu_torch.models import (gen_lm, gen_lm_long, mnist, resnet,
                                     transformer, vgg)

__all__ = ["gen_lm", "gen_lm_long", "mnist", "resnet", "transformer", "vgg"]
