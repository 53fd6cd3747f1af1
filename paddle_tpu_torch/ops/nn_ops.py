"""Normalisation and softmax (the port's counterpart of the
``layer_norm`` and ``softmax`` lowerings of ``paddle_tpu.ops.nn_ops``;
reference ``layer_norm_op.cc``, ``softmax_op.cc``)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.kernels.bias_softmax import bias_softmax
from paddle_tpu_torch.ops.registry import register_op, infer_shape_unary


# ---------------------------------------------------------------------------
# layer_norm
# ---------------------------------------------------------------------------

def _infer_layer_norm(op, block):
    x = block.var(op.input("X")[0])
    y = block.var(op.output("Y")[0])
    y.shape = x.shape
    y.dtype = x.dtype


@register_op("layer_norm", infer_shape=_infer_layer_norm)
def layer_norm_lower(ctx):
    """Normalise over the dims from ``begin_norm_axis`` on, statistics in
    float32 (biased variance), then the optional scale and bias."""
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


@register_op("softmax", infer_shape=infer_shape_unary())
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
