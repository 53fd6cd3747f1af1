"""Model programs of the port: the generative LM (:mod:`gen_lm`,
:mod:`gen_lm_long`), the Transformer (:mod:`transformer`), the conv
zoo (:mod:`resnet`, :mod:`vgg`, :mod:`mnist`), the Wide & Deep CTR
model (:mod:`wide_and_deep`), the stacked dynamic-LSTM sentiment
classifier (:mod:`stacked_lstm`) and the attention seq2seq NMT model
(:mod:`seq2seq`)."""

from paddle_tpu_torch.models import (gen_lm, gen_lm_long, mnist, resnet,
                                     seq2seq, stacked_lstm, transformer, vgg,
                                     wide_and_deep)

__all__ = ["gen_lm", "gen_lm_long", "mnist", "resnet", "seq2seq",
           "stacked_lstm", "transformer", "vgg", "wide_and_deep"]
