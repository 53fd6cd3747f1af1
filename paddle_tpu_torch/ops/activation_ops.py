"""Activations (the port's counterpart of ``paddle_tpu.ops.
activation_ops``; reference ``paddle/fluid/operators/activation_op.cc``).

Each lowering is the JAX package's formula in torch, written so that
its grad (the auto-vjp) takes JAX's value at a kink: a clip is
``minimum(maximum(x, lo), hi)``, whose vjp splits the cotangent of a
value on a bound in half as ``jnp.clip``'s does (``torch.clamp`` passes
all of it); ``abs`` has slope +1 at 0 as ``jnp.abs`` (torch: 0); a
``where`` sends the cotangent to the branch it picked, as
``jnp.where``; a max over a group splits it among ties (``amax``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from paddle_tpu_torch.ops.registry import register_op, infer_shape_unary


def _unary(name, fn):
    @register_op(name, infer_shape=infer_shape_unary())
    def lower(ctx):
        ctx.set_output("Out", fn(ctx.input("X")))
    lower.__name__ = name + "_lower"
    return lower


class _Abs(torch.autograd.Function):
    """``|x|`` whose grad at 0 (either sign) is the cotangent itself, as
    ``jax.grad(jnp.abs)(0.) == 1``."""

    @staticmethod
    def forward(x):
        return torch.abs(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def _clip(x, lo, hi):
    """``jnp.clip(x, lo, hi)`` with its tie-splitting vjp."""
    # bounds filled on the device (no host copy: graph-safe)
    lo = torch.full((), lo, dtype=x.dtype, device=x.device)
    hi = torch.full((), hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


_unary("sigmoid", torch.sigmoid)
_unary("logsigmoid", F.logsigmoid)
_unary("exp", torch.exp)
_unary("relu", torch.relu)
_unary("tanh", torch.tanh)
_unary("tanh_shrink", lambda x: x - torch.tanh(x))
_unary("sqrt", torch.sqrt)
_unary("abs", _Abs.apply)
_unary("ceil", torch.ceil)
_unary("floor", torch.floor)
_unary("round", torch.round)
_unary("reciprocal", lambda x: 1.0 / x)
_unary("log", torch.log)
_unary("square", torch.square)
_unary("softplus", F.softplus)
_unary("softsign", lambda x: x / (1.0 + _Abs.apply(x)))
_unary("sin", torch.sin)
_unary("cos", torch.cos)


@register_op("leaky_relu", infer_shape=infer_shape_unary())
def leaky_relu_lower(ctx):
    x = ctx.input("X")
    ctx.set_output("Out", torch.where(x > 0, x, ctx.attr("alpha", 0.02) * x))


@register_op("elu", infer_shape=infer_shape_unary())
def elu_lower(ctx):
    x = ctx.input("X")
    alpha = ctx.attr("alpha", 1.0)
    ctx.set_output("Out",
                   torch.where(x > 0, x, alpha * (torch.exp(x) - 1.0)))


@register_op("relu6", infer_shape=infer_shape_unary())
def relu6_lower(ctx):
    ctx.set_output("Out", _clip(ctx.input("X"), 0.0,
                                ctx.attr("threshold", 6.0)))


@register_op("pow", infer_shape=infer_shape_unary())
def pow_lower(ctx):
    from paddle_tpu_torch.ops.math_ops import power
    ctx.set_output("Out", power(ctx.input("X"), float(ctx.attr("factor",
                                                               1.0))))


@register_op("stanh", infer_shape=infer_shape_unary())
def stanh_lower(ctx):
    a = ctx.attr("scale_a", 2.0 / 3.0)
    b = ctx.attr("scale_b", 1.7159)
    ctx.set_output("Out", b * torch.tanh(a * ctx.input("X")))


@register_op("brelu", infer_shape=infer_shape_unary())
def brelu_lower(ctx):
    ctx.set_output("Out", _clip(ctx.input("X"), ctx.attr("t_min", 0.0),
                                ctx.attr("t_max", 24.0)))


@register_op("soft_relu", infer_shape=infer_shape_unary())
def soft_relu_lower(ctx):
    t = ctx.attr("threshold", 40.0)
    ctx.set_output("Out", torch.log(
        1.0 + torch.exp(_clip(ctx.input("X"), -t, t))))


@register_op("hard_sigmoid", infer_shape=infer_shape_unary())
def hard_sigmoid_lower(ctx):
    x = ctx.input("X")
    slope = ctx.attr("slope", 0.2)
    offset = ctx.attr("offset", 0.5)
    ctx.set_output("Out", _clip(slope * x + offset, 0.0, 1.0))


@register_op("swish", infer_shape=infer_shape_unary())
def swish_lower(ctx):
    x = ctx.input("X")
    ctx.set_output("Out", x * torch.sigmoid(ctx.attr("beta", 1.0) * x))


@register_op("hard_shrink", infer_shape=infer_shape_unary())
def hard_shrink_lower(ctx):
    x = ctx.input("X")
    t = ctx.attr("threshold", 0.5)
    ctx.set_output("Out", torch.where(torch.abs(x) > t, x, 0.0))


@register_op("softshrink", infer_shape=infer_shape_unary())
def softshrink_lower(ctx):
    x = ctx.input("X")
    lam = ctx.attr("lambda", 0.5)
    ctx.set_output("Out", torch.where(
        x > lam, x - lam, torch.where(x < -lam, x + lam, 0.0)))


@register_op("thresholded_relu", infer_shape=infer_shape_unary())
def thresholded_relu_lower(ctx):
    x = ctx.input("X")
    ctx.set_output("Out", torch.where(x > ctx.attr("threshold", 1.0), x, 0.0))


@register_op("prelu", infer_shape=infer_shape_unary())
def prelu_lower(ctx):
    x = ctx.input("X")
    alpha = ctx.input("Alpha")
    mode = ctx.attr("mode", "all")
    if mode == "all":
        a = alpha.reshape(())
    elif mode == "channel":
        a = alpha.reshape((1, -1) + (1,) * (x.ndim - 2))
    else:  # element
        a = alpha.reshape((1,) + tuple(x.shape[1:]))
    ctx.set_output("Out", torch.where(x > 0, x, a * x))


@register_op("gelu", infer_shape=infer_shape_unary())
def gelu_lower(ctx):
    approximate = "tanh" if ctx.attr("approximate", True) else "none"
    ctx.set_output("Out", F.gelu(ctx.input("X"), approximate=approximate))


@register_op("maxout", infer_shape=None)
def maxout_lower(ctx):
    x = ctx.input("X")  # NCHW
    groups = ctx.attr("groups")
    n, c, h, w = x.shape
    ctx.set_output("Out",
                   x.reshape(n, c // groups, groups, h, w).amax(dim=2))
