"""Normalisation, dropout, softmax, convolution and pooling (the port of
``paddle_tpu.ops.nn_ops``; reference ``layer_norm_op.cc``,
``dropout_op.cc``, ``softmax_op.cc``, ``conv_op.cc``,
``conv_transpose_op.cc``, ``pool_op.cc``, ``pool_with_index_op.cc``,
``unpool_op.cc``, ``spp_op.h``, ``lrn_op.cc``, ``label_smooth_op.cc``,
``conv_shift_op.cc``, ``batch_norm_op.cc`` and gserver's
``BilinearInterpLayer.cpp`` for ``image_resize``).

The convolutions are ``torch.nn.functional.conv2d`` in NCHW/OIHW (and
``conv_transpose2d``, ``conv3d``, ``conv_transpose3d``), as the JAX
package leaves them to XLA's convolutions outside any kernel; conv2d's
grad runs ``aten.convolution_backward`` on the saved
operands (no forward recompute).  The JAX package's TPU layout knobs
``PADDLE_TPU_CONV_IM2COL`` and ``PADDLE_TPU_CONV_NHWC`` are not carried.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.kernels.bias_softmax import (BiasSoftmaxFunction,
                                                   bias_softmax,
                                                   bias_softmax_grad)
from paddle_tpu_torch.ops.math_ops import reduce_chooser
from paddle_tpu_torch.ops.registry import (
    ShapeInferenceSkip, auto_vjp_grad_lower, infer_shape_unary,
    register_grad_lower, register_op)


# ---------------------------------------------------------------------------
# layer_norm
# ---------------------------------------------------------------------------

def _infer_layer_norm(op, block):
    x = block.var(op.input("X")[0])
    y = block.var(op.output("Y")[0])
    y.shape = x.shape
    y.dtype = x.dtype


@register_op("layer_norm", infer_shape=_infer_layer_norm,
             amp_cast=("X",))
def layer_norm_lower(ctx):
    """Normalise over the dims from ``begin_norm_axis`` on, statistics in
    float32 (biased variance), then the optional scale and bias.  Under
    AMP the input, and so the output, is bfloat16."""
    x = ctx.input("X")
    begin = ctx.attr("begin_norm_axis", 1)
    eps = ctx.attr("epsilon", 1e-5)
    axes = tuple(range(begin, x.ndim))
    xf = x.float()
    mean = xf.mean(dim=axes, keepdim=True)
    var = (xf - mean).square().mean(dim=axes, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    scale, bias = ctx.input("Scale"), ctx.input("Bias")
    norm_shape = (1,) * begin + tuple(x.shape[begin:])
    if scale is not None:
        y = y * scale.reshape(norm_shape)
    if bias is not None:
        y = y + bias.reshape(norm_shape)
    ctx.set_output("Y", y.to(x.dtype))
    ctx.set_output("Mean", mean.reshape(x.shape[:begin]))
    ctx.set_output("Variance", var.reshape(x.shape[:begin]))


# ---------------------------------------------------------------------------
# dropout (reference dropout_op.cc; old-fluid "downgrade_in_infer": train
# multiplies by the 0/1 mask, inference scales by (1-p))
# ---------------------------------------------------------------------------

def _infer_dropout(op, block):
    x = block.var(op.input("X")[0])
    out = block.var(op.output("Out")[0])
    out.shape = x.shape
    out.dtype = x.dtype
    masks = op.output("Mask")
    if masks:
        m = block.var(masks[0])
        m.shape = x.shape
        m.dtype = x.dtype


def _dropout_grad_lower(ctx):
    g_out = ctx.env[ctx.op.input("Out@GRAD")[0]]
    mask = ctx.env[ctx.op.input("Mask")[0]]
    ctx.outputs[ctx.op.output("X@GRAD")[0]] = g_out * mask


def _dropout_grad_maker(op, block, no_grad_set):
    from paddle_tpu_torch.framework import grad_var_name
    x = op.input("X")[0]
    if x in no_grad_set:
        return [], {}
    g_x = grad_var_name(x)
    desc = {"type": "dropout_grad",
            "inputs": {"Out@GRAD": [grad_var_name(op.output("Out")[0])],
                       "Mask": [op.output("Mask")[0]]},
            "outputs": {"X@GRAD": [g_x]},
            "attrs": dict(op.attrs)}
    return [desc], {x: g_x}


@register_op("dropout", infer_shape=_infer_dropout, uses_rng=True,
             grad_maker=_dropout_grad_maker, grad_lower=_dropout_grad_lower)
def dropout_lower(ctx):
    """Keep each element with probability ``1 - dropout_prob``.  The keep
    draw comes from a generator on the run's device, seeded from the
    run's seed and this op's RNG slot (``LowerContext.generator``), or
    seeded with the op's own ``seed`` attr under ``fix_seed``; the grad
    multiplies by the saved ``Mask``."""
    x = ctx.input("X")
    p = ctx.attr("dropout_prob", 0.5)
    impl = ctx.attr("dropout_implementation", "downgrade_in_infer")
    if ctx.attr("is_test", False):
        out = x * (1.0 - p) if impl == "downgrade_in_infer" else x
        ctx.set_output("Out", out)
        ctx.set_output("Mask", torch.ones_like(x))
        return
    gen = ctx.generator(int(ctx.attr("seed", 0))
                        if ctx.attr("fix_seed", False) else None)
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= p
    mask = keep.to(x.dtype)
    if impl == "upscale_in_train":
        mask = mask / (1.0 - p)
    ctx.set_output("Out", x * mask)
    ctx.set_output("Mask", mask)


# ---------------------------------------------------------------------------
# softmax (last axis) with an optional additive Bias
# ---------------------------------------------------------------------------

def split_attention_bias(x, bias):
    """``(row_bias, tri_bias)`` when the 4-D ``bias`` is one the
    bias-softmax kernel takes for 4-D scores ``x`` [B,H,Sq,Sk]: a row
    bias ``[B|1,1,1,Sk]`` (returned ``[B|1,Sk]``) or one causal plane per
    batch row ``[B|1,1,Sq,Sk]`` (returned ``[B|1,Sq,Sk]``).  ``None`` for
    any other bias."""
    if x.ndim != 4 or bias.ndim != 4:
        return None
    B, _, Sq, Sk = x.shape
    Bb, one, rows, cols = bias.shape
    if one != 1 or cols != Sk or Bb not in (1, B):
        return None
    if rows == 1:
        return bias.reshape(Bb, Sk), None
    if rows == Sq:
        return None, bias.reshape(Bb, Sq, Sk)
    return None


@register_op("softmax", infer_shape=infer_shape_unary(),
             no_grad_inputs=("Bias",))
def softmax_lower(ctx):
    """Last-axis softmax, float32 inside, output in X's dtype.  Attention
    scores with a row or causal-plane bias go to the bias-softmax kernel
    (:mod:`paddle_tpu_torch.kernels.bias_softmax`); other shapes are a
    plain torch softmax, as in the JAX package."""
    x = ctx.input("X")
    bias = ctx.input("Bias")
    if bias is not None:
        split = split_attention_bias(x, bias)
        if split is not None:
            row_bias, tri_bias = split
            # under autograd (a pipeline stage) the kernel pair, whose
            # launches autograd cannot see through
            fn = BiasSoftmaxFunction.apply if torch.is_grad_enabled() and \
                x.requires_grad else bias_softmax
            ctx.set_output("Out", fn(x, row_bias, tri_bias))
            return
        x = x + bias.to(x.dtype)
    ctx.set_output("Out", torch.softmax(x.float(), dim=-1).to(x.dtype))


@register_grad_lower("softmax")
def softmax_grad_lower(ctx):
    """When the forward ran the bias-softmax kernel (attention-shaped
    scores with a row or causal-plane bias), the grad runs its backward
    kernel on the saved ``Out``: ``dy`` is read at its own dtype and only
    ``dx`` is cast to ``Out``'s (the reference's contract,
    ``attention_ops.py:844-851``, ``:903-917``).  Any other softmax takes
    the auto-vjp of the forward lowering, as in the JAX package."""
    op = ctx.op
    gnames = op.output("X@GRAD")
    if not gnames or not gnames[0]:
        return
    x = ctx.env[op.input("X")[0]]
    bias_names = op.input("Bias")
    bias = ctx.env[bias_names[0]] if bias_names else None
    dy_names = op.input("Out@GRAD")
    if bias is None or split_attention_bias(x, bias) is None or \
            not dy_names or not dy_names[0] or dy_names[0] not in ctx.env:
        auto_vjp_grad_lower("softmax")(ctx)
        return
    y = ctx.env[op.input("Out")[0]]
    dy = ctx.env[dy_names[0]]
    ctx.outputs[gnames[0]] = bias_softmax_grad(y.contiguous(),
                                               dy.contiguous())


# ---------------------------------------------------------------------------
# conv2d / depthwise_conv2d (NCHW input, OIHW filter)
# ---------------------------------------------------------------------------

def _conv_out_size(i, k, s, p, d=1):
    if i == -1:
        return -1
    ke = d * (k - 1) + 1
    return (i + 2 * p - ke) // s + 1


def _infer_conv2d(op, block):
    x = block.var(op.input("Input")[0])
    w = block.var(op.input("Filter")[0])
    if x.shape is None or w.shape is None:
        raise ShapeInferenceSkip()
    strides = op.attr("strides", [1, 1])
    paddings = op.attr("paddings", [0, 0])
    dilations = op.attr("dilations", [1, 1])
    n, _, h, wd = x.shape
    oc, _, kh, kw = w.shape
    out = block.var(op.output("Output")[0])
    out.shape = (n, oc,
                 _conv_out_size(h, kh, strides[0], paddings[0], dilations[0]),
                 _conv_out_size(wd, kw, strides[1], paddings[1], dilations[1]))
    out.dtype = x.dtype


def _conv_attrs(op, x):
    """``(stride, padding, dilation, groups)`` of a conv op on input x;
    ``depthwise_conv2d`` takes one group per input channel."""
    groups = x.shape[1] if op.type.startswith("depthwise_conv2d") \
        else (op.attr("groups", 1) or 1)
    paddings = op.attr("paddings", [0, 0])
    return (tuple(op.attr("strides", [1, 1])), (paddings[0], paddings[1]),
            tuple(op.attr("dilations", [1, 1])), groups)


def _conv2d_lower(ctx):
    """Symmetric zero padding; under AMP input and filter are bfloat16
    (``amp_cast``) and so is the output."""
    x, w = ctx.input("Input"), ctx.input("Filter")
    stride, padding, dilation, groups = _conv_attrs(ctx.op, x)
    out = F.conv2d(x, w, None, stride, padding, dilation, groups)
    ctx.set_output("Output", out.to(x.dtype))


def _amp_operand(ctx, x):
    """``x`` as an ``amp_cast`` slot hands it to the forward lowering."""
    if ctx.aux.get("amp") and x.dtype == torch.float32:
        return x.to(torch.bfloat16)
    return x


def _conv2d_grad_lower(ctx):
    """Input and filter grads from the saved operands (cast as the forward
    cast them) and the incoming grad in the operands' dtype; each grad is
    cast back to its primal's dtype (float32 master weights under AMP)."""
    op = ctx.op
    xe = ctx.env[op.input("Input")[0]]
    we = ctx.env[op.input("Filter")[0]]
    x, w = _amp_operand(ctx, xe), _amp_operand(ctx, we)
    dy = ctx.env[op.input("Output@GRAD")[0]].to(x.dtype)
    dx_names, dw_names = op.output("Input@GRAD"), op.output("Filter@GRAD")
    want_dx = bool(dx_names and dx_names[0])
    want_dw = bool(dw_names and dw_names[0])
    if not (want_dx or want_dw):
        return
    stride, padding, dilation, groups = _conv_attrs(op, x)
    dx, dw, _ = torch.ops.aten.convolution_backward(
        dy, x, w, None, stride, padding, dilation, False, (0, 0), groups,
        (want_dx, want_dw, False))
    if want_dx:
        ctx.outputs[dx_names[0]] = dx.to(xe.dtype)
    if want_dw:
        ctx.outputs[dw_names[0]] = dw.to(we.dtype)


for _type in ("conv2d", "depthwise_conv2d"):
    register_op(_type, infer_shape=_infer_conv2d,
                grad_lower=_conv2d_grad_lower,
                amp_cast=("Input", "Filter"))(_conv2d_lower)


# ---------------------------------------------------------------------------
# pool2d (max and avg; reference pool_op.cc + math/pooling.cc)
# ---------------------------------------------------------------------------

def _infer_pool2d(op, block):
    x = block.var(op.input("X")[0])
    if x.shape is None:
        raise ShapeInferenceSkip()
    ksize = op.attr("ksize")
    strides = op.attr("strides", [1, 1])
    paddings = op.attr("paddings", [0, 0])
    gp = op.attr("global_pooling", False)
    ceil_mode = op.attr("ceil_mode", False)
    n, c, h, w = x.shape
    if gp:
        oh = ow = 1
    else:
        def osize(i, k, s, p):
            if i == -1:
                return -1
            if ceil_mode:
                return (i - k + 2 * p + s - 1) // s + 1
            return (i - k + 2 * p) // s + 1
        oh = osize(h, ksize[0], strides[0], paddings[0])
        ow = osize(w, ksize[1], strides[1], paddings[1])
    out = block.var(op.output("Out")[0])
    out.shape = (n, c, oh, ow)
    out.dtype = x.dtype


def pool_windows(shape, ksize, strides, paddings, global_pooling, ceil_mode):
    """``(ksize, strides, ((top, bottom), (left, right)))`` of a pool over
    an NCHW ``shape``, as the JAX package pads it: symmetric padding, and
    under ``ceil_mode`` the bottom/right padding widened until the last
    window that starts inside the input (or its top/left padding) fits."""
    if global_pooling:
        return (shape[2], shape[3]), (1, 1), ((0, 0), (0, 0))

    def bottom(i, k, s, p):
        if not ceil_mode:
            return p
        out = (i - k + 2 * p + s - 1) // s + 1
        return max((out - 1) * s + k - i - p, p)

    pads = tuple((p, bottom(i, k, s, p)) for i, k, s, p in
                 zip(shape[2:], ksize, strides, paddings))
    return tuple(ksize), tuple(strides), pads


class _MaxPool(torch.autograd.Function):
    """Max pooling of an already padded ``x`` (N, C, spatial...) with
    ``ksize`` and ``strides``, NaN-propagating as the JAX package's
    ``reduce_window``; its grad goes to each window's largest non-NaN
    element (the first of ties), as the JAX package's select-and-scatter
    sends it, where torch's own goes to the window's NaN."""

    @staticmethod
    def forward(x, ksize, strides):
        pool = F.max_pool2d if x.ndim == 4 else F.max_pool3d
        return pool(x, ksize, strides)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ctx.ksize, ctx.strides = inputs
        ctx.save_for_backward(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        finite = torch.where(torch.isnan(x), float("-inf"), x)
        pool = F.max_pool2d if x.ndim == 4 else F.max_pool3d
        _, idx = pool(finite, ctx.ksize, ctx.strides, return_indices=True)
        n, c = x.shape[:2]
        # out of place: DTensor (ParallelExecutor) refuses a scatter into
        # a new plain tensor in place
        dx = g.new_zeros((n, c, x[0, 0].numel())).scatter_add(
            2, idx.reshape(n, c, -1), g.reshape(n, c, -1))
        return dx.reshape(x.shape), None, None


def max_pool(x, ksize, strides):
    """:class:`_MaxPool` of a padded ``x``."""
    return _MaxPool.apply(x, tuple(ksize), tuple(strides))


@register_op("pool2d", infer_shape=_infer_pool2d)
def pool2d_lower(ctx):
    """The input is padded as the JAX package pads it (``pool_windows``;
    torch's own ``ceil_mode`` would instead drop a last window that starts
    in the padding): with -inf for max pooling, with zeros for average
    pooling, which divides by the window's count of input elements
    (``exclusive``, the default) or by its full size.  The grad is the
    auto-vjp of this lowering."""
    x = ctx.input("X")
    ksize, strides, ((pt, pb), (pl, pr)) = pool_windows(
        x.shape, ctx.attr("ksize"), ctx.attr("strides", [1, 1]),
        ctx.attr("paddings", [0, 0]), ctx.attr("global_pooling", False),
        ctx.attr("ceil_mode", False))
    pad = (pl, pr, pt, pb)
    if ctx.attr("pooling_type", "max") == "max":
        out = max_pool(F.pad(x, pad, value=float("-inf")), ksize, strides)
    else:
        total = F.avg_pool2d(F.pad(x, pad), ksize, strides,
                             divisor_override=1)
        if ctx.attr("exclusive", True):
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            out = total / F.avg_pool2d(F.pad(ones, pad), ksize, strides,
                                       divisor_override=1)
        else:
            out = total / (ksize[0] * ksize[1])
    ctx.set_output("Out", out)


# ---------------------------------------------------------------------------
# batch_norm (reference batch_norm_op.cc)
# ---------------------------------------------------------------------------

def _infer_batch_norm(op, block):
    x = block.var(op.input("X")[0])
    y = block.var(op.output("Y")[0])
    y.shape = x.shape
    y.dtype = x.dtype
    if x.shape is not None:
        layout = op.attr("data_layout", "NCHW")
        c = x.shape[1] if layout == "NCHW" else x.shape[-1]
        for slot in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
            names = op.output(slot)
            if names:
                v = block.var(names[0])
                v.shape = (c,)
                v.dtype = "float32"


def _bn_layout(x, layout):
    """``(axes reduced over, broadcast shape of a per-channel vector)``."""
    caxis = 1 if layout == "NCHW" and x.ndim > 2 else x.ndim - 1
    shape = [1] * x.ndim
    shape[caxis] = x.shape[caxis]
    return tuple(i for i in range(x.ndim) if i != caxis), shape


def _batch_norm_grad_lower(ctx):
    """X, Scale and Bias grads from the saved statistics (no forward
    recompute).  Training: ``dx = scale * r / M * (M dy - sum(dy) - x_hat
    * sum(dy * x_hat))`` with the batch's ``r = SavedVariance`` (the
    inverse std) and ``M`` elements a channel; ``is_test``: ``dx = dy *
    scale * r`` with the running statistics.  ``dy`` is first rounded to
    Y's dtype (bfloat16 under AMP), the sums run in float32, and each
    grad is cast to its primal's dtype."""
    op = ctx.op
    x = ctx.env[op.input("X")[0]]
    scale = ctx.env[op.input("Scale")[0]]
    bias = ctx.env[op.input("Bias")[0]]
    dy = ctx.env[op.input("Y@GRAD")[0]].to(x.dtype).float()
    axes, bshape = _bn_layout(x, op.attr("data_layout", "NCHW"))
    xf = x.float()
    if op.attr("is_test", False):
        mean = ctx.env[op.input("Mean")[0]].float()
        inv_std = torch.rsqrt(ctx.env[op.input("Variance")[0]].float()
                              + op.attr("epsilon", 1e-5))
    else:
        mean = ctx.env[op.input("SavedMean")[0]]
        inv_std = ctx.env[op.input("SavedVariance")[0]]
    x_hat = (xf - mean.reshape(bshape)) * inv_std.reshape(bshape)
    sum_dy = dy.sum(dim=axes)
    sum_dy_xhat = (dy * x_hat).sum(dim=axes)
    grads = {"Scale@GRAD": (sum_dy_xhat, scale),
             "Bias@GRAD": (sum_dy, bias)}
    gx = op.output("X@GRAD")
    if gx and gx[0]:
        k = (scale.float() * inv_std).reshape(bshape)
        if op.attr("is_test", False):
            dx = dy * k
        else:
            m = xf.numel() // math.prod(bshape)      # elements a channel
            dx = k / m * (m * dy - sum_dy.reshape(bshape)
                          - x_hat * sum_dy_xhat.reshape(bshape))
        grads["X@GRAD"] = (dx, x)
    for slot, (g, prim) in grads.items():
        names = op.output(slot)
        if names and names[0]:
            ctx.outputs[names[0]] = g.to(prim.dtype)


@register_op("batch_norm", infer_shape=_infer_batch_norm,
             grad_lower=_batch_norm_grad_lower,
             no_grad_inputs=("Mean", "Variance"))
def batch_norm_lower(ctx):
    """Per-channel normalisation, statistics in float32, ``Y`` cast back to
    X's dtype (bfloat16 under AMP).  Training normalises by the batch's
    mean and BIASED variance ``mean((x - mean)**2)`` and moves the running
    statistics as ``running * momentum + batch * (1 - momentum)`` (not
    ``F.batch_norm``'s update, which folds in the unbiased variance);
    ``MeanOut``/``VarianceOut`` name the ``Mean``/``Variance`` variables
    themselves, so the scope's running statistics are replaced.
    ``SavedMean`` is the mean used, ``SavedVariance`` the inverse std
    ``rsqrt(var + epsilon)``.  ``is_test`` normalises by the running
    statistics and leaves them as they are."""
    x = ctx.input("X")
    scale, bias = ctx.input("Scale"), ctx.input("Bias")
    mean, var = ctx.input("Mean"), ctx.input("Variance")
    eps = ctx.attr("epsilon", 1e-5)
    momentum = ctx.attr("momentum", 0.9)
    axes, bshape = _bn_layout(x, ctx.attr("data_layout", "NCHW"))
    xf = x.float()
    if ctx.attr("is_test", False):
        use_mean, use_var = mean, var
        mean_out, var_out = mean, var
    else:
        use_mean = xf.mean(dim=axes)
        use_var = (xf - use_mean.reshape(bshape)).square().mean(dim=axes)
        mean_out = mean * momentum + use_mean * (1.0 - momentum)
        var_out = var * momentum + use_var * (1.0 - momentum)
    inv_std = torch.rsqrt(use_var + eps)
    y = (xf - use_mean.reshape(bshape)) * inv_std.reshape(bshape)
    y = y * scale.reshape(bshape) + bias.reshape(bshape)
    ctx.set_output("Y", y.to(x.dtype))
    ctx.set_output("MeanOut", mean_out)
    ctx.set_output("VarianceOut", var_out)
    ctx.set_output("SavedMean", use_mean)
    ctx.set_output("SavedVariance", inv_std)


# ---------------------------------------------------------------------------
# conv2d_transpose / conv3d_transpose / conv3d (reference
# conv_transpose_op.cc, conv_op.cc): cuDNN convolutions, as the JAX
# package leaves its own to XLA's; grads are the auto-vjp
# ---------------------------------------------------------------------------

def _infer_conv_transpose(op, block):
    x = block.var(op.input("Input")[0])
    w = block.var(op.input("Filter")[0])
    if x.shape is None or w.shape is None:
        raise ShapeInferenceSkip()
    nd = len(x.shape) - 2
    s = op.attr("strides", [1] * nd)
    p = op.attr("paddings", [0] * nd)
    d = op.attr("dilations", [1] * nd)

    def osize(i, k, st, pd, dl):
        if i == -1:
            return -1
        return (i - 1) * st - 2 * pd + dl * (k - 1) + 1

    out = block.var(op.output("Output")[0])
    # filter layout (C_in, C_out / groups, k...)
    out.shape = (x.shape[0], w.shape[1] * (op.attr("groups", 1) or 1)) + \
        tuple(osize(x.shape[2 + i], w.shape[2 + i], s[i], p[i], d[i])
              for i in range(nd))
    out.dtype = x.dtype


def _conv_transpose_lower(ctx):
    """The gradient of a forward convolution (``out = (i - 1) s - 2 p +
    d (k - 1) + 1``), filter ``(C_in, C_out / groups, k...)``: NCHW
    (``conv2d_transpose``) or NCDHW (``conv3d_transpose``)."""
    x, w = ctx.input("Input"), ctx.input("Filter")
    nd = x.ndim - 2
    fn = F.conv_transpose2d if nd == 2 else F.conv_transpose3d
    out = fn(x, w, None, tuple(ctx.attr("strides", [1] * nd)),
             tuple(ctx.attr("paddings", [0] * nd)[:nd]), 0,
             ctx.attr("groups", 1) or 1,
             tuple(ctx.attr("dilations", [1] * nd)))
    ctx.set_output("Output", out.to(x.dtype))


for _type in ("conv2d_transpose", "conv3d_transpose"):
    register_op(_type, infer_shape=_infer_conv_transpose,
                amp_cast=("Input", "Filter"))(_conv_transpose_lower)


def _infer_conv3d(op, block):
    x = block.var(op.input("Input")[0])
    w = block.var(op.input("Filter")[0])
    if x.shape is None or w.shape is None:
        raise ShapeInferenceSkip()
    s = op.attr("strides", [1, 1, 1])
    p = op.attr("paddings", [0, 0, 0])
    d = op.attr("dilations", [1, 1, 1])
    out = block.var(op.output("Output")[0])
    out.shape = (x.shape[0], w.shape[0]) + tuple(
        _conv_out_size(x.shape[2 + i], w.shape[2 + i], s[i], p[i], d[i])
        for i in range(3))
    out.dtype = x.dtype


@register_op("conv3d", infer_shape=_infer_conv3d,
             amp_cast=("Input", "Filter"))
def conv3d_lower(ctx):
    """NCDHW input, OIDHW filter, symmetric zero padding."""
    x, w = ctx.input("Input"), ctx.input("Filter")
    out = F.conv3d(x, w, None, tuple(ctx.attr("strides", [1, 1, 1])),
                   tuple(ctx.attr("paddings", [0, 0, 0])[:3]),
                   tuple(ctx.attr("dilations", [1, 1, 1])),
                   ctx.attr("groups", 1) or 1)
    ctx.set_output("Output", out.to(x.dtype))


# ---------------------------------------------------------------------------
# pool2d_with_index / pool3d / unpool / spp (reference pool_with_index_op.cc,
# pool_op.cc, unpool_op.cc, spp_op.h)
# ---------------------------------------------------------------------------

@register_op("pool2d_with_index")
def pool2d_with_index_lower(ctx):
    """Max pooling with symmetric padding and the int64 ``Mask``: each
    window's first largest element (a NaN is never chosen: the JAX
    package's paired reduce keeps a value only when a later one is
    strictly greater), as an index into its input's ``H x W`` plane.  The
    grad goes to that element."""
    x = ctx.input("X")
    n, c, h, w = x.shape
    if ctx.attr("global_pooling", False):
        ksize, strides, pads = (h, w), (1, 1), (0, 0)
    else:
        ksize = tuple(ctx.attr("ksize"))
        strides = tuple(ctx.attr("strides", [1, 1]))
        pads = tuple(ctx.attr("paddings", [0, 0]))
    xp = F.pad(torch.where(torch.isnan(x), float("-inf"), x),
               (pads[1], pads[1], pads[0], pads[0]), value=float("-inf"))
    _, idx = F.max_pool2d(xp.detach(), ksize, strides, return_indices=True)
    # padded-plane index -> input-plane index (a window wholly in the
    # padding keeps its first element's, clamped)
    wp = w + 2 * pads[1]
    row = (idx // wp - pads[0]).clamp(0, h - 1)
    col = (idx % wp - pads[1]).clamp(0, w - 1)
    mask = row * w + col
    vals = x.reshape(n, c, h * w).gather(2, mask.reshape(n, c, -1))
    ctx.set_output("Out", vals.reshape(mask.shape))
    ctx.set_output("Mask", mask)


def _infer_pool3d(op, block):
    x = block.var(op.input("X")[0])
    if x.shape is None:
        raise ShapeInferenceSkip()
    n, c, d, h, w = x.shape
    k = list(op.attr("ksize"))
    s = list(op.attr("strides", [1, 1, 1]))
    p = list(op.attr("paddings", [0, 0, 0, 0]))[:3] + [0, 0, 0]
    if op.attr("global_pooling", False):
        k, s, p = [d, h, w], [1, 1, 1], [0, 0, 0]
    ceil = op.attr("ceil_mode", False)
    dims = []
    for i, size in enumerate((d, h, w)):
        num = size - k[i] + 2 * p[i]
        dims.append((num + s[i] - 1) // s[i] + 1 if ceil
                    else num // s[i] + 1)
    out = block.var(op.output("Out")[0])
    out.shape = (n, c) + tuple(dims)
    out.dtype = x.dtype


@register_op("pool3d", infer_shape=_infer_pool3d)
def pool3d_lower(ctx):
    """``pool2d`` over NCDHW: symmetric padding, under ``ceil_mode`` the
    trailing padding widened until the last partial window fits; max
    pooling pads with -inf (grads as :class:`_MaxPool`), average pooling
    divides by the window's count of input elements (``exclusive``) or
    its full size."""
    x = ctx.input("X")
    if ctx.attr("global_pooling", False):
        ksize, strides, paddings = tuple(x.shape[2:]), (1, 1, 1), (0, 0, 0)
    else:
        ksize = tuple(ctx.attr("ksize"))
        strides = tuple(ctx.attr("strides", [1, 1, 1]))
        paddings = tuple(ctx.attr("paddings", [0, 0, 0])[:3])
    pads = [(p, p) for p in paddings]
    if ctx.attr("ceil_mode", False):
        for i, size in enumerate(x.shape[2:]):
            k, s, p = ksize[i], strides[i], paddings[i]
            out_dim = (size - k + 2 * p + s - 1) // s + 1
            pads[i] = (p, max((out_dim - 1) * s + k - size - p, p))
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    if ctx.attr("pooling_type", "max") == "max":
        out = max_pool(F.pad(x, flat, value=float("-inf")), ksize, strides)
    else:
        total = F.avg_pool3d(F.pad(x, flat), ksize, strides,
                             divisor_override=1)
        if ctx.attr("exclusive", True):
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            out = total / F.avg_pool3d(F.pad(ones, flat), ksize, strides,
                                       divisor_override=1)
        else:
            out = total / math.prod(ksize)
    ctx.set_output("Out", out)


def _unpool_size(h, w, k, s, p):
    return (h - 1) * s[0] - 2 * p[0] + k[0], (w - 1) * s[1] - 2 * p[1] + k[1]


def _infer_unpool(op, block):
    x = block.var(op.input("X")[0])
    if x.shape is None:
        raise ShapeInferenceSkip()
    n, c, h, w = x.shape
    oh, ow = _unpool_size(h, w, list(op.attr("ksize")),
                          list(op.attr("strides", [2, 2])),
                          list(op.attr("paddings", [0, 0])))
    out = block.var(op.output("Out")[0])
    out.shape = (n, c, oh, ow)
    out.dtype = x.dtype


@register_op("unpool", infer_shape=_infer_unpool,
             no_grad_inputs=("Indices",))
def unpool_lower(ctx):
    """Max-unpooling: each value of X added at its flat ``Indices``
    position of its output plane (``pool2d_with_index``'s Mask)."""
    x, indices = ctx.input("X"), ctx.input("Indices")
    n, c, h, w = x.shape
    oh, ow = _unpool_size(h, w, list(ctx.attr("ksize")),
                          list(ctx.attr("strides", [2, 2])),
                          list(ctx.attr("paddings", [0, 0])))
    out = x.new_zeros((n, c, oh * ow)).scatter_add(
        2, indices.reshape(n, c, h * w).long(), x.reshape(n, c, h * w))
    ctx.set_output("Out", out.reshape(n, c, oh, ow))


def _infer_spp(op, block):
    x = block.var(op.input("X")[0])
    if x.shape is None:
        raise ShapeInferenceSkip()
    n, c = x.shape[0], x.shape[1]
    ph = op.attr("pyramid_height")
    out = block.var(op.output("Out")[0])
    out.shape = (n, sum(c * 4 ** level for level in range(ph)))
    out.dtype = x.dtype


def _adaptive_pool_axis(x, axis, bins, ptype):
    """Pooling along ``axis`` into ``bins``: bin i covers ``[floor(i
    size / bins), ceil((i + 1) size / bins))``, never empty (the
    reference's spp bin edges)."""
    size = x.shape[axis]
    rows = np.arange(size)
    starts = np.floor(np.arange(bins) * size / bins).astype(int)
    ends = np.ceil((np.arange(bins) + 1) * size / bins).astype(int)
    mask = torch.as_tensor((rows[None, :] >= starts[:, None]) &
                           (rows[None, :] < ends[:, None]),
                           device=x.device)                # [bins, size]
    xm = x.movedim(axis, -1).unsqueeze(-2)                 # [..., 1, size]
    if ptype == "max":
        vals = torch.where(mask, xm, float("-inf"))
        out = reduce_chooser(vals, (vals.ndim - 1,), False, True)
    else:
        out = torch.where(mask, xm, 0.0).sum(-1) / mask.sum(-1).to(x.dtype)
    return out.movedim(-1, axis)


@register_op("spp", infer_shape=_infer_spp)
def spp_lower(ctx):
    """Spatial pyramid pooling: levels 0 .. pyramid_height - 1 of ``2**l
    x 2**l`` bins, each flattened, concatenated."""
    x = ctx.input("X")
    ptype = ctx.attr("pooling_type", "max")
    parts = []
    for level in range(int(ctx.attr("pyramid_height"))):
        o = _adaptive_pool_axis(x, 2, 2 ** level, ptype)
        o = _adaptive_pool_axis(o, 3, 2 ** level, ptype)
        parts.append(o.reshape(x.shape[0], -1))
    ctx.set_output("Out", torch.cat(parts, dim=1))


# ---------------------------------------------------------------------------
# lrn / log_softmax / label_smooth / conv_shift / image_resize
# ---------------------------------------------------------------------------

@register_op("lrn", infer_shape=infer_shape_unary())
def lrn_lower(ctx):
    """``x / (k + alpha * sum of x**2 over n channels)**beta``, NCHW, with
    ``MidOut`` the denominator's base.  ``alpha`` scales the sum itself
    (``F.local_response_norm`` divides it by n first)."""
    x = ctx.input("X")
    n = ctx.attr("n", 5)
    half = n // 2
    sq = F.pad(x * x, (0, 0, 0, 0, half, half))
    acc = sum(sq[:, i:i + x.shape[1]] for i in range(n))
    mid = ctx.attr("k", 2.0) + ctx.attr("alpha", 1e-4) * acc
    ctx.set_output("Out", x / torch.pow(mid, ctx.attr("beta", 0.75)))
    ctx.set_output("MidOut", mid)


@register_op("log_softmax", infer_shape=infer_shape_unary())
def log_softmax_lower(ctx):
    ctx.set_output("Out", torch.log_softmax(ctx.input("X"), dim=-1))


@register_op("label_smooth", infer_shape=infer_shape_unary())
def label_smooth_lower(ctx):
    """``(1 - epsilon) x + epsilon * PriorDist`` (uniform ``1 / K``
    without one)."""
    x = ctx.input("X")
    eps = ctx.attr("epsilon", 0.0)
    dist = ctx.input("PriorDist")
    prior = dist if dist is not None else 1.0 / x.shape[-1]
    ctx.set_output("Out", (1.0 - eps) * x + eps * prior)


def _infer_conv_shift(op, block):
    x = block.var(op.input("X")[0])
    out = block.var(op.output("Out")[0])
    out.shape = x.shape
    out.dtype = x.dtype


@register_op("conv_shift", infer_shape=_infer_conv_shift)
def conv_shift_lower(ctx):
    """Circular correlation ``out[i, j] = sum_k x[i, (j + k - M // 2)
    mod N] y[i, k]`` (X ``[B, N]``, Y ``[B, M]``)."""
    x, y = ctx.input("X"), ctx.input("Y")
    half = y.shape[1] // 2
    out = torch.zeros_like(x)
    for k in range(y.shape[1]):
        out = out + torch.roll(x, half - k, dims=1) * y[:, k:k + 1]
    ctx.set_output("Out", out)


def _infer_image_resize(op, block):
    x = block.var(op.input("X")[0])
    out = block.var(op.output("Out")[0])
    if x.shape is None:
        raise ShapeInferenceSkip()
    out.shape = (x.shape[0], x.shape[1], op.attr("out_h"), op.attr("out_w"))
    out.dtype = x.dtype


def _align_corners_axis(x, axis, out_sz):
    """Linear resampling of ``axis`` with the source coordinate ``i (in -
    1) / (out - 1)`` (the reference's align-corners ratio)."""
    in_sz = x.shape[axis]
    if out_sz == 1 or in_sz == 1:
        return x.index_select(axis, torch.zeros(out_sz, dtype=torch.long,
                                                device=x.device))
    pos = torch.arange(out_sz, dtype=x.dtype, device=x.device) * \
        ((in_sz - 1) / (out_sz - 1))
    lo = torch.floor(pos).long().clamp(max=in_sz - 2)
    frac = (pos - lo.to(x.dtype)).reshape(
        (-1,) + (1,) * (x.ndim - 1 - axis))
    return x.index_select(axis, lo) * (1 - frac) + \
        x.index_select(axis, lo + 1) * frac


def _linear_weights(in_sz, out_sz, device):
    """``jax.image.resize``'s "linear" weights ``[in, out]`` (half-pixel
    centres; a triangle kernel widened by the scale when it shrinks,
    which is its antialiasing; columns normalised; samples outside the
    input zeroed), in float64 on the host."""
    inv_scale = in_sz / out_sz
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(out_sz) + 0.5) * inv_scale - 0.5
    dist = np.abs(sample[None, :] - np.arange(in_sz)[:, None]) / kernel_scale
    weights = np.maximum(0.0, 1.0 - dist)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                       weights / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= in_sz - 0.5)
    return torch.as_tensor(np.where(inside[None, :], weights, 0.0)
                           .astype(np.float32), device=device)


@register_op("image_resize", infer_shape=_infer_image_resize)
def image_resize_lower(ctx):
    """NCHW maps resampled to ``out_h x out_w`` in float32: "bilinear"
    with ``align_corners`` (the default) by the reference's ratio, without
    it as ``jax.image.resize``'s "linear" (half-pixel, antialiased when
    shrinking); "nearest" takes source ``floor((i + 0.5) in / out)``."""
    x = ctx.input("X")
    out_hw = (ctx.attr("out_h"), ctx.attr("out_w"))
    method = ctx.attr("method", "bilinear")
    out = x.float()
    for axis, out_sz in zip((2, 3), out_hw):
        in_sz = out.shape[axis]
        if in_sz == out_sz:
            continue
        if method == "bilinear" and ctx.attr("align_corners", True):
            out = _align_corners_axis(out, axis, out_sz)
        elif method == "bilinear":
            wmat = _linear_weights(in_sz, out_sz, x.device)
            out = torch.tensordot(out.movedim(axis, -1), wmat,
                                  dims=1).movedim(-1, axis)
        elif method == "nearest":
            src = np.floor((np.arange(out_sz) + 0.5) * in_sz / out_sz)
            out = out.index_select(axis, torch.as_tensor(
                src.astype(np.int64), device=x.device))
        else:
            raise ValueError(f"image_resize: unknown method {method!r}")
    ctx.set_output("Out", out.to(x.dtype))
