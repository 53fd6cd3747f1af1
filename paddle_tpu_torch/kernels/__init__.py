"""The port's hand-written CUDA kernels (Hopper, ``sm_90a``): their
wrappers, their plain torch versions and their build (``build.py``).
Sources are under ``csrc/``; nothing is compiled at import."""

from paddle_tpu_torch.kernels.bias_softmax import (  # noqa: F401
    BIAS_SOFTMAX, BIAS_SOFTMAX_GRAD, bias_softmax, bias_softmax_grad,
    bias_softmax_grad_reference, bias_softmax_reference)
from paddle_tpu_torch.kernels.bshd_attention import (  # noqa: F401
    BSHD_BWD, BSHD_FWD, BshdAttentionFunction, bshd_attention_bwd,
    bshd_attention_bwd_reference, bshd_attention_fwd,
    bshd_attention_fwd_reference)
from paddle_tpu_torch.kernels.conv3x3 import (  # noqa: F401
    CONV3X3, conv3x3_bn_act, conv3x3_bn_act_reference, fold_batch_norm)
from paddle_tpu_torch.kernels.flash_attention import (  # noqa: F401
    FLASH_DKDV, FLASH_DQ, FLASH_FWD, flash_attention_bwd,
    flash_attention_bwd_reference, flash_attention_fwd,
    flash_attention_fwd_reference)
from paddle_tpu_torch.kernels.paged_decode import (  # noqa: F401
    PAGED_DECODE, paged_attention, paged_attention_reference)
from paddle_tpu_torch.kernels.smalls_attention import (  # noqa: F401
    SMALLS_BWD, SMALLS_FWD, smalls_attention_bwd,
    smalls_attention_bwd_reference, smalls_attention_fwd,
    smalls_attention_fwd_reference, smalls_ok)

#: every kernel of the port, in the order of the TPU kernel table
ALL_KERNELS = (FLASH_FWD, FLASH_DKDV, FLASH_DQ, SMALLS_FWD, SMALLS_BWD,
               BIAS_SOFTMAX, BIAS_SOFTMAX_GRAD, PAGED_DECODE, BSHD_FWD,
               BSHD_BWD, CONV3X3)

__all__ = ["ALL_KERNELS", "BIAS_SOFTMAX", "BIAS_SOFTMAX_GRAD", "BSHD_BWD",
           "BSHD_FWD", "BshdAttentionFunction", "CONV3X3", "FLASH_DKDV",
           "FLASH_DQ", "FLASH_FWD", "PAGED_DECODE", "SMALLS_BWD",
           "SMALLS_FWD", "bias_softmax", "bias_softmax_grad",
           "bias_softmax_grad_reference", "bias_softmax_reference",
           "bshd_attention_bwd", "bshd_attention_bwd_reference",
           "bshd_attention_fwd", "bshd_attention_fwd_reference",
           "conv3x3_bn_act",
           "conv3x3_bn_act_reference", "fold_batch_norm",
           "flash_attention_bwd",
           "flash_attention_bwd_reference", "flash_attention_fwd",
           "flash_attention_fwd_reference", "paged_attention",
           "paged_attention_reference", "smalls_attention_bwd",
           "smalls_attention_bwd_reference", "smalls_attention_fwd",
           "smalls_attention_fwd_reference", "smalls_ok"]
