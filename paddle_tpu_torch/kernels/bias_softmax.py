"""Bias softmax: ``softmax(x + row_bias + tri_bias)`` over the last axis
of attention scores (the port of ``_fsm_fwd_kernel``,
``paddle_tpu/ops/attention_ops.py:755``).

:func:`bias_softmax` launches the CUDA kernel of ``csrc/bias_softmax.cu``
for tensors on the card and runs :func:`bias_softmax_reference`, the
plain torch version, for tensors on the CPU.  There is no ``Sk % 128``
gate: any row length up to :data:`MAX_ROW` runs the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.kernels.build import CudaKernel

__all__ = ["BIAS_SOFTMAX", "MAX_ROW", "bias_softmax",
           "bias_softmax_reference"]

BIAS_SOFTMAX = CudaKernel("bias_softmax", "bias_softmax.cu",
                          replaces="paddle_tpu/ops/attention_ops.py:755")

#: longest softmax row the kernel keeps in shared memory
MAX_ROW = 8192

_SYMBOLS = {torch.float32: "bias_softmax_f32",
            torch.bfloat16: "bias_softmax_bf16"}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_ARGTYPES = [_P, _P, _L, _P, _L, _P, _I, _I, _I, _I, _P]


def bias_softmax_reference(x, row_bias=None, tri_bias=None):
    """Plain torch version.  x: [B, H, Sq, Sk]; row_bias: [B|1, Sk] or
    None; tri_bias: [B|1, Sq, Sk] or [Sq, Sk] or None.  Biases are added
    in float32, the softmax runs in float32, the result is x's dtype."""
    xf = x.float()
    if row_bias is not None:
        xf = xf + row_bias.float()[:, None, None, :]
    if tri_bias is not None:
        tb = tri_bias.float()
        xf = xf + (tb[:, None] if tb.ndim == 3 else tb[None, None])
    return torch.softmax(xf, dim=-1).to(x.dtype)


def _bias_arg(bias, B, shape, name, device):
    """``(pointer, batch stride)`` of a float32 bias of ``shape`` (its
    leading dim B or 1), or ``(None, 0)``."""
    if bias is None:
        return None, 0
    if bias.device != device:
        raise ValueError(f"bias_softmax: {name} on {bias.device}, x on "
                         f"{device}")
    if bias.dtype != torch.float32:
        raise TypeError(f"bias_softmax: {name} must be float32, got "
                        f"{bias.dtype}")
    if tuple(bias.shape[1:]) != shape or bias.shape[0] not in (1, B):
        raise ValueError(
            f"bias_softmax: {name} must be [{B}|1, "
            f"{', '.join(map(str, shape))}], got {tuple(bias.shape)}")
    if not bias.is_contiguous():
        raise ValueError(f"bias_softmax: {name} must be contiguous")
    stride = 0 if bias.shape[0] == 1 else bias[0].numel()
    return bias.data_ptr(), stride


def bias_softmax(x, row_bias=None, tri_bias=None):
    """``softmax(x + biases)`` over the last axis; see
    :func:`bias_softmax_reference` for the contract.  On the CPU it is the
    plain version; on the card it launches the CUDA kernel (x float32 or
    bfloat16 and contiguous, biases float32 and contiguous) or raises."""
    if x.device.type == "cpu":
        return bias_softmax_reference(x, row_bias, tri_bias)
    if x.device.type != "cuda":
        raise ValueError(f"bias_softmax: no kernel for device {x.device}")
    if x.ndim != 4:
        raise ValueError(f"bias_softmax: x must be [B, H, Sq, Sk], got "
                         f"{tuple(x.shape)}")
    symbol = _SYMBOLS.get(x.dtype)
    if symbol is None:
        raise TypeError(f"bias_softmax: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("bias_softmax: x must be contiguous")
    B, H, Sq, Sk = x.shape
    if Sk > MAX_ROW:
        raise ValueError(f"bias_softmax: rows of {Sk} exceed the kernel's "
                         f"{MAX_ROW}")
    if tri_bias is not None and tri_bias.ndim == 2:
        tri_bias = tri_bias.unsqueeze(0)
    rb, rb_stride = _bias_arg(row_bias, B, (Sk,), "row_bias", x.device)
    tb, tb_stride = _bias_arg(tri_bias, B, (Sq, Sk), "tri_bias", x.device)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        BIAS_SOFTMAX.launch(symbol, _ARGTYPES, x.data_ptr(), rb, rb_stride,
                            tb, tb_stride, out.data_ptr(), B, H, Sq, Sk,
                            stream)
    return out
