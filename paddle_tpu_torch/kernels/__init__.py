"""The port's hand-written CUDA kernels (Hopper, ``sm_90a``): their
wrappers, their plain torch versions and their build (``build.py``).
Sources are under ``csrc/``; nothing is compiled at import."""

from paddle_tpu_torch.kernels.bias_softmax import (  # noqa: F401
    BIAS_SOFTMAX, bias_softmax, bias_softmax_reference)
from paddle_tpu_torch.kernels.paged_decode import (  # noqa: F401
    PAGED_DECODE, paged_attention, paged_attention_reference)

__all__ = ["BIAS_SOFTMAX", "PAGED_DECODE", "bias_softmax",
           "bias_softmax_reference", "paged_attention",
           "paged_attention_reference"]
