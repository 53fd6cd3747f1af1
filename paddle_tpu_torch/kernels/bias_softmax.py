"""Bias softmax: ``softmax(x + row_bias + tri_bias)`` over the last axis
of attention scores and its backward ``dx = (dy - sum(dy * y)) * y``
(the ports of ``_fsm_fwd_kernel`` and ``_fsm_bwd_kernel``,
``paddle_tpu/ops/attention_ops.py:755`` and ``:767``).

:func:`bias_softmax` and :func:`bias_softmax_grad` launch the CUDA
kernels of ``csrc/bias_softmax.cu`` for tensors on the card and run
their plain torch versions (``*_reference``) for tensors on the CPU.
There is no ``Sk % 128`` gate: any row length up to :data:`MAX_ROW` runs
the kernels.  The forward picks its body by shape alone
(:func:`bias_softmax_body`): one warp a row in registers up to
:data:`WARP_MAX_ROW`, with 16-byte loads where the row is made of aligned
16-byte pieces, else one block a row.  :class:`BiasSoftmaxFunction`
puts the pair under torch autograd; the IR's ``softmax_grad`` op calls
the backward directly on the saved output.
"""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.kernels.build import CudaKernel

__all__ = ["BIAS_SOFTMAX", "BIAS_SOFTMAX_GRAD", "MAX_ROW", "WARP_MAX_ROW",
           "bias_softmax", "bias_softmax_body", "bias_softmax_body_of",
           "bias_softmax_reference", "bias_softmax_grad",
           "bias_softmax_grad_reference", "BiasSoftmaxFunction"]

BIAS_SOFTMAX = CudaKernel("bias_softmax", "bias_softmax.cu",
                          replaces="paddle_tpu/ops/attention_ops.py:755")
BIAS_SOFTMAX_GRAD = CudaKernel("bias_softmax_grad", "bias_softmax.cu",
                               replaces="paddle_tpu/ops/attention_ops.py:767")

#: longest softmax row the kernel keeps in shared memory
MAX_ROW = 8192
#: longest row the forward's warp body keeps in registers (one warp a
#: row); longer rows take the block body
WARP_MAX_ROW = 1024

_SYMBOLS = {torch.float32: "bias_softmax_f32",
            torch.bfloat16: "bias_softmax_bf16"}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_ARGTYPES = [_P, _P, _L, _P, _L, _P, _I, _I, _I, _I, _P]
_DTYPE_TAG = {torch.float32: "f32", torch.bfloat16: "bf16"}
_GRAD_ARGTYPES = [_P, _P, _P, _L, _I, _P]


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


def bias_softmax_body(Sk, dtype, aligned):
    """``(body, vec, kp)``: the forward body that rows of ``Sk`` values of
    ``dtype`` take, by the rule of ``pick_body`` in
    ``csrc/bias_softmax.cu``.  ``"block"`` (one block a row) above
    :data:`WARP_MAX_ROW`; else one warp a row whose lanes hold ``kp``
    pieces of ``vec`` values (``kp`` a power of two): ``"warp_vector"``
    with 16-byte pieces (8 bf16 or 4 float32 values) where the row is
    made of them and every pointer is ``aligned`` to 16 bytes,
    ``"warp_element"`` with one value a piece otherwise."""
    if Sk > WARP_MAX_ROW:
        return "block", 1, 0
    piece = 16 // torch.tensor([], dtype=dtype).element_size()
    vec = piece if aligned and Sk % piece == 0 else 1
    kp = 1
    while kp * 32 * vec < Sk:
        kp *= 2
    return ("warp_vector" if vec > 1 else "warp_element"), vec, kp


def bias_softmax_body_of(x, row_bias=None, tri_bias=None):
    """:func:`bias_softmax_body` of the card call ``bias_softmax(x,
    row_bias, tri_bias)`` (its output, a fresh allocation, is aligned)."""
    aligned = all(t.data_ptr() % 16 == 0
                  for t in (x, row_bias, tri_bias) if t is not None)
    return bias_softmax_body(x.shape[-1], x.dtype, aligned)


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


def bias_softmax_grad_reference(y, dy):
    """Plain torch version of the backward: ``y`` the softmax output (any
    shape, softmax over the last axis), ``dy`` its cotangent at its OWN
    dtype; both read in float32, ``dx`` returned in ``y``'s dtype."""
    yf, dyf = y.float(), dy.float()
    return ((dyf - (dyf * yf).sum(-1, keepdim=True)) * yf).to(y.dtype)


def bias_softmax_grad(y, dy):
    """``dx = (dy - sum(dy * y)) * y`` over the last axis; see
    :func:`bias_softmax_grad_reference`.  On the CPU it is the plain
    version; on the card it launches the CUDA kernel (y and dy float32 or
    bfloat16, same shape, contiguous) or raises."""
    if y.device.type == "cpu":
        return bias_softmax_grad_reference(y, dy)
    if y.device.type != "cuda" or dy.device != y.device:
        raise ValueError(f"bias_softmax_grad: no kernel for y on {y.device}"
                         f" and dy on {dy.device}")
    if y.shape != dy.shape or y.ndim < 1:
        raise ValueError(f"bias_softmax_grad: y {tuple(y.shape)} and dy "
                         f"{tuple(dy.shape)} must have one shape")
    ty, tdy = _DTYPE_TAG.get(y.dtype), _DTYPE_TAG.get(dy.dtype)
    if ty is None or tdy is None:
        raise TypeError(f"bias_softmax_grad: y and dy must be float32 or "
                        f"bfloat16, got {y.dtype} and {dy.dtype}")
    if not (y.is_contiguous() and dy.is_contiguous()):
        raise ValueError("bias_softmax_grad: y and dy must be contiguous")
    Sk = y.shape[-1]
    if Sk > MAX_ROW:
        raise ValueError(f"bias_softmax_grad: rows of {Sk} exceed the "
                         f"kernel's {MAX_ROW}")
    dx = torch.empty_like(y)
    rows = y.numel() // max(Sk, 1)
    if y.numel() == 0:
        return dx
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        BIAS_SOFTMAX_GRAD.launch(f"bias_softmax_grad_{ty}_{tdy}",
                                 _GRAD_ARGTYPES, y.data_ptr(), dy.data_ptr(),
                                 dx.data_ptr(), rows, Sk, stream)
    return dx


class BiasSoftmaxFunction(torch.autograd.Function):
    """``softmax(x + biases)`` under torch autograd: the forward kernel,
    and the backward kernel on the saved output (the biases are masks and
    get no grad).  ``setup_context`` form, so it also runs inside
    ``torch.no_grad()`` callers' ``torch.func`` transforms on the CPU."""

    @staticmethod
    def forward(x, row_bias=None, tri_bias=None):
        return bias_softmax(x, row_bias, tri_bias)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        return bias_softmax_grad(y, dy.contiguous()), None, None
