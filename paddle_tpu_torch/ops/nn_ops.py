"""Normalisation, dropout and softmax (the port's counterpart of the
``layer_norm``, ``dropout`` and ``softmax`` lowerings of
``paddle_tpu.ops.nn_ops``; reference ``layer_norm_op.cc``,
``dropout_op.cc``, ``softmax_op.cc``)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.kernels.bias_softmax import (bias_softmax,
                                                   bias_softmax_grad)
from paddle_tpu_torch.ops.registry import (
    auto_vjp_grad_lower, infer_shape_unary, register_grad_lower,
    register_op)


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
    run's seed and this op's position (``LowerContext.generator``), or
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
