"""3x3 convolution with a folded batch norm and ReLU, NHWC (the port of
``_conv3x3_kernel``, ``exp_resnet_conv.py:41``).

:func:`conv3x3_bn_act` launches the CUDA kernel of ``csrc/conv3x3.cu``
for tensors on the card and runs its plain torch version
(:func:`conv3x3_bn_act_reference`) for tensors on the CPU.  Both compute
the stride-1 convolution with a zero padding of one pixel in float32,
then ``acc * scale + bias``, an optional ReLU and one rounding to x's
dtype.  :func:`fold_batch_norm` turns a batch norm's parameters and
running statistics into that ``scale`` and ``bias``.

On the card the C entry point is picked by dtype: ``conv3x3_bn_act_bf16``
runs every bfloat16 shape on the tensor cores (``conv3x3_kernel_tc``:
bf16 products summed in float32 by ``mma.sync``, 16 channels a step),
``conv3x3_bn_act_f32`` runs float32 on the CUDA cores
(``conv3x3_kernel``).
"""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.kernels.build import CudaKernel

__all__ = ["CONV3X3", "conv3x3_bn_act", "conv3x3_bn_act_reference",
           "f32_tolerance", "fold_batch_norm"]

CONV3X3 = CudaKernel("conv3x3", "conv3x3.cu",
                     replaces="exp_resnet_conv.py:41")

_SYMBOLS = {torch.float32: "conv3x3_bn_act_f32",
            torch.bfloat16: "conv3x3_bn_act_bf16"}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]


def fold_batch_norm(gamma, beta, mean, var, eps):
    """``(scale, bias)`` float32 of an inference batch norm after a conv:
    ``scale = gamma * rsqrt(var + eps)``, ``bias = beta - mean * scale``."""
    scale = gamma.float() * torch.rsqrt(var.float() + eps)
    return scale, beta.float() - mean.float() * scale


def conv3x3_bn_act_reference(x, w, scale, bias, relu=True):
    """Plain torch version, the TPU kernel's own formulation: nine shifted
    ``[N*H*W, C] @ [C, Co]`` products in float32 over a zero-padded copy
    of x, then the epilogue.  x: [N, H, W, C]; w: [3, 3, C, Co]; scale,
    bias: [Co] float32.  Returns [N, H, W, Co] in x's dtype."""
    N, H, W, C = x.shape
    Co = w.shape[3]
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = w.float()
    acc = torch.zeros(N * H * W, Co, dtype=torch.float32, device=x.device)
    for ky in range(3):
        for kx in range(3):
            tap = xp[:, ky:ky + H, kx:kx + W, :].reshape(N * H * W, C)
            acc += tap @ wf[ky, kx]
    out = acc * scale.float() + bias.float()
    if relu:
        out = torch.relu(out)
    return out.reshape(N, H, W, Co).to(x.dtype)


def f32_tolerance(x, w, scale):
    """Elementwise bound on how far two float32 computations of
    :func:`conv3x3_bn_act` that sum the ``K = 9 * C`` products in
    different orders may lie apart: ``8 * sqrt(K) * 2**-24`` times
    ``|scale| * sum |x * w|`` (the plain version on absolute values).  A
    sum of K float32 terms errs by about ``sqrt(K)`` roundings of its
    magnitude when the roundings are independent; 8 is the margin.  At
    ResNet-50's widths (K up to 4608) it is about 3e-5 of the sum of
    magnitudes, well below what one product left out or counted twice
    moves an output (about 1 / K of it)."""
    K = 9 * x.shape[3]
    mag = conv3x3_bn_act_reference(x.abs(), w.abs(), scale.abs(),
                                   torch.zeros_like(scale), relu=False)
    return 8.0 * K ** 0.5 * 2.0 ** -24 * mag.float()


def conv3x3_bn_act(x, w, scale, bias, relu=True):
    """See :func:`conv3x3_bn_act_reference` for the contract.  On the CPU
    it is the plain version; on the card it launches the CUDA kernel of
    x's dtype (x and w float32 or bfloat16 of one dtype and contiguous,
    scale and bias float32 and contiguous) or raises.  Tensors that do
    not start on 16 bytes, or rows whose width is no multiple of 8, take
    the kernel's element copies."""
    if x.device.type == "cpu":
        return conv3x3_bn_act_reference(x, w, scale, bias, relu)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_bn_act: no kernel for device {x.device}")
    if x.ndim != 4 or w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[3]):
        raise ValueError(f"conv3x3_bn_act: x must be [N, H, W, C] and w "
                         f"[3, 3, C, Co], got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    N, H, W, C = x.shape
    Co = w.shape[3]
    symbol = _SYMBOLS.get(x.dtype)
    if symbol is None or w.dtype != x.dtype:
        raise TypeError(f"conv3x3_bn_act: x and w must be float32 or "
                        f"bfloat16 of one dtype, got {x.dtype} and {w.dtype}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (Co,):
            raise TypeError(f"conv3x3_bn_act: {name} must be float32 [{Co}], "
                            f"got {t.dtype} {tuple(t.shape)}")
    tensors = (x, w, scale, bias)
    if any(t.device != x.device for t in tensors):
        raise ValueError("conv3x3_bn_act: x, w, scale and bias must lie on "
                         "one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("conv3x3_bn_act: inputs must be contiguous")
    out = torch.empty((N, H, W, Co), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        CONV3X3.launch(symbol, _ARGTYPES, x.data_ptr(), w.data_ptr(),
                       scale.data_ptr(), bias.data_ptr(), out.data_ptr(), N,
                       H, W, C, Co, int(bool(relu)), stream)
    return out
