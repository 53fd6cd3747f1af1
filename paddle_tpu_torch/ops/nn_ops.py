"""Normalisation, dropout, softmax, convolution and pooling (the port's
counterpart of the ``layer_norm``, ``dropout``, ``softmax``,
``conv2d``, ``depthwise_conv2d``, ``pool2d`` and ``batch_norm``
lowerings of ``paddle_tpu.ops.nn_ops``; reference ``layer_norm_op.cc``,
``dropout_op.cc``, ``softmax_op.cc``, ``conv_op.cc``, ``pool_op.cc``,
``batch_norm_op.cc``).

The convolutions are ``torch.nn.functional.conv2d`` in NCHW/OIHW, as the
JAX package leaves them to ``lax.conv_general_dilated`` outside any
kernel; their grad runs ``aten.convolution_backward`` on the saved
operands (no forward recompute).  The JAX package's TPU layout knobs
``PADDLE_TPU_CONV_IM2COL`` and ``PADDLE_TPU_CONV_NHWC`` are not carried.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from paddle_tpu_torch.kernels.bias_softmax import (bias_softmax,
                                                   bias_softmax_grad)
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
    from the op's own ``seed`` attr under ``fix_seed``; the grad
    multiplies by the saved ``Mask``."""
    x = ctx.input("X")
    p = ctx.attr("dropout_prob", 0.5)
    impl = ctx.attr("dropout_implementation", "downgrade_in_infer")
    if ctx.attr("is_test", False):
        out = x * (1.0 - p) if impl == "downgrade_in_infer" else x
        ctx.set_output("Out", out)
        ctx.set_output("Mask", torch.ones_like(x))
        return
    if ctx.attr("fix_seed", False):
        gen = torch.Generator(device=x.device)
        gen.manual_seed(int(ctx.attr("seed", 0)))
    else:
        gen = ctx.generator()
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
            ctx.set_output("Out", bias_softmax(x, row_bias, tri_bias))
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
        out = F.max_pool2d(F.pad(x, pad, value=float("-inf")), ksize,
                           strides)
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
