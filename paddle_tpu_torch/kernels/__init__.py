"""The port's hand-written CUDA kernels (Hopper, ``sm_90a``): their
wrappers, their plain torch versions and their build (``build.py``).
Sources are under ``csrc/``; nothing is compiled at import."""

from paddle_tpu_torch.kernels.bias_softmax import (  # noqa: F401
    BIAS_SOFTMAX, BIAS_SOFTMAX_GRAD, bias_softmax, bias_softmax_grad,
    bias_softmax_grad_reference, bias_softmax_reference)
from paddle_tpu_torch.kernels.flash_attention import (  # noqa: F401
    FLASH_DKDV, FLASH_DQ, FLASH_FWD, flash_attention_bwd,
    flash_attention_bwd_reference, flash_attention_fwd,
    flash_attention_fwd_reference)
from paddle_tpu_torch.kernels.paged_decode import (  # noqa: F401
    PAGED_DECODE, paged_attention, paged_attention_reference)

#: every kernel of the port, in the order of the TPU kernel table
ALL_KERNELS = (FLASH_FWD, FLASH_DKDV, FLASH_DQ, BIAS_SOFTMAX,
               BIAS_SOFTMAX_GRAD, PAGED_DECODE)

__all__ = ["ALL_KERNELS", "BIAS_SOFTMAX", "BIAS_SOFTMAX_GRAD", "FLASH_DKDV",
           "FLASH_DQ", "FLASH_FWD", "PAGED_DECODE", "bias_softmax",
           "bias_softmax_grad", "bias_softmax_grad_reference",
           "bias_softmax_reference", "flash_attention_bwd",
           "flash_attention_bwd_reference", "flash_attention_fwd",
           "flash_attention_fwd_reference", "paged_attention",
           "paged_attention_reference"]
