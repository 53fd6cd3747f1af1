"""Linear-algebra / elementwise / reduction ops (the port's counterpart
of ``paddle_tpu.ops.math_ops``; reference ``paddle/fluid/operators/{mul,
matmul,elementwise_*,scale,sum,mean,reduce_op,clip,minus,cum,l1_norm,
norm,cos_sim,bilinear_tensor_product}``).  Plain matrix
products go to ``torch.matmul``, as the JAX package left them to XLA.
Their grads are the auto-vjp of these lowerings; the max-like ones
(``elementwise_max`` / ``min``, ``clip``, ``reduce_max`` / ``min``) go
through :func:`maximum`, :func:`minimum` and :func:`reduce_chooser`,
which give the JAX package's vjp where torch's differs: at a NaN."""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.lod import is_dyn
from paddle_tpu_torch.ops.registry import (
    register_op, infer_shape_elementwise, infer_shape_unary,
    ShapeInferenceSkip)
from paddle_tpu_torch.selected_rows import (SelectedRows, is_selected_rows,
                                            to_dense)


# ---------------------------------------------------------------------------
# mul / matmul  (reference: mul_op.cc, matmul_op.cc)
# ---------------------------------------------------------------------------

def _infer_mul(op, block):
    x = block.var(op.input("X")[0])
    y = block.var(op.input("Y")[0])
    if x.shape is None or y.shape is None:
        raise ShapeInferenceSkip()
    xn = op.attr("x_num_col_dims", 1)
    yn = op.attr("y_num_col_dims", 1)
    out = block.var(op.output("Out")[0])
    out.shape = tuple(x.shape[:xn]) + tuple(y.shape[yn:])
    out.dtype = x.dtype
    out.lod_level = x.lod_level


@register_op("mul", infer_shape=_infer_mul, amp_cast=("X", "Y"))
def mul_lower(ctx):
    """``x`` flattened to 2-D at ``x_num_col_dims``, ``y`` at
    ``y_num_col_dims``, multiplied, and unflattened."""
    x, y = ctx.input("X"), ctx.input("Y")
    xn = ctx.attr("x_num_col_dims", 1)
    yn = ctx.attr("y_num_col_dims", 1)
    lead = int(np.prod(x.shape[:xn])) if xn > 0 else 1
    x2 = x.reshape(lead, -1)
    y2 = y.reshape(int(np.prod(y.shape[:yn])), -1)
    out = torch.matmul(x2, y2)
    ctx.set_output("Out", out.reshape(tuple(x.shape[:xn]) +
                                      tuple(y.shape[yn:])))


def _infer_matmul(op, block):
    x = block.var(op.input("X")[0])
    y = block.var(op.input("Y")[0])
    if x.shape is None or y.shape is None:
        raise ShapeInferenceSkip()
    tx, ty = op.attr("transpose_X", False), op.attr("transpose_Y", False)
    xs = list(x.shape)
    ys = list(y.shape)
    if len(xs) >= 2 and tx:
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if len(ys) >= 2 and ty:
        ys[-1], ys[-2] = ys[-2], ys[-1]
    if len(xs) == 1 and len(ys) == 1:
        shape = (1,)
    elif len(xs) == 1:
        shape = tuple(ys[:-2]) + (ys[-1],)
    elif len(ys) == 1:
        shape = tuple(xs[:-1])
    else:
        batch = xs[:-2] if len(xs) > len(ys) else ys[:-2]
        shape = tuple(batch) + (xs[-2], ys[-1])
    out = block.var(op.output("Out")[0])
    out.shape = shape
    out.dtype = x.dtype


@register_op("matmul", infer_shape=_infer_matmul, amp_cast=("X", "Y"))
def matmul_lower(ctx):
    """Batched product with numpy broadcasting over the leading dims,
    optional transposes of the last two dims, and an ``alpha`` scale."""
    x, y = ctx.input("X"), ctx.input("Y")
    if ctx.attr("transpose_X", False) and x.ndim >= 2:
        x = x.transpose(-1, -2)
    if ctx.attr("transpose_Y", False) and y.ndim >= 2:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = ctx.attr("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    if out.ndim == 0:
        out = out.reshape(1)
    ctx.set_output("Out", out)


# ---------------------------------------------------------------------------
# elementwise family  (reference: elementwise_op_function.h broadcast)
# ---------------------------------------------------------------------------

def _elementwise_broadcast(x, y, axis):
    """Paddle broadcast: Y's shape aligns to X starting at ``axis``."""
    if y.ndim == x.ndim:
        return y
    if axis == -1:
        axis = x.ndim - y.ndim
    shape = [1] * x.ndim
    for i, d in enumerate(y.shape):
        shape[axis + i] = d
    return y.reshape(shape)


def _make_elementwise(name, fn):
    @register_op("elementwise_" + name, infer_shape=infer_shape_elementwise)
    def lower(ctx):
        x, y = ctx.input("X"), ctx.input("Y")
        yb = _elementwise_broadcast(x, y, ctx.attr("axis", -1))
        ctx.set_output("Out", fn(x, yb))
    lower.__name__ = f"elementwise_{name}_lower"
    return lower


_make_elementwise("add", torch.add)
_make_elementwise("sub", torch.sub)
_make_elementwise("mul", torch.mul)
_make_elementwise("div", torch.div)
class _Chooser2(torch.autograd.Function):
    """``torch.maximum`` / ``torch.minimum`` with the JAX package's vjp:
    the cotangent goes to the operand that was chosen, half to each on a
    tie, and none to either where the comparison fails (a NaN), where
    torch's own passes it to both."""

    @staticmethod
    def forward(x, y, largest):
        return torch.maximum(x, y) if largest else torch.minimum(x, y)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, y, ctx.largest = inputs
        ctx.save_for_backward(x, y)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        x_wins = x > y if ctx.largest else x < y
        y_wins = y > x if ctx.largest else y < x
        half = torch.where(x == y, g * 0.5, torch.zeros_like(g))
        gx = torch.where(x_wins, g, half).sum_to_size(x.shape)
        gy = torch.where(y_wins, g, half).sum_to_size(y.shape)
        return gx, gy, None


def maximum(x, y):
    """``jnp.maximum``: NaN-propagating, with :class:`_Chooser2`'s grads."""
    return _Chooser2.apply(x, y, True)


def minimum(x, y):
    """``jnp.minimum``: NaN-propagating, with :class:`_Chooser2`'s grads."""
    return _Chooser2.apply(x, y, False)


class _Chooser(torch.autograd.Function):
    """``amax`` / ``amin`` over ``dims`` with the JAX package's vjp: a
    group's cotangent is split evenly among its elements equal to the
    result, and a group whose result is NaN (equal to none) takes none,
    where torch's own divides by a count of 0 and gives every element of
    the group NaN."""

    @staticmethod
    def forward(x, dims, keepdim, largest):
        fn = torch.amax if largest else torch.amin
        return fn(x, dim=dims, keepdim=keepdim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ctx.dims, ctx.keepdim, _ = inputs
        ctx.save_for_backward(x, output)

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        if not ctx.keepdim:
            for d in sorted(ctx.dims):
                out, g = out.unsqueeze(d), g.unsqueeze(d)
        loc = x == out
        count = loc.sum(dim=ctx.dims, keepdim=True).clamp(min=1)
        return (torch.where(loc, g / count.to(g.dtype), torch.zeros_like(g)),
                None, None, None)


def reduce_chooser(x, dims, keepdim, largest):
    """``jnp.max`` / ``jnp.min`` of ``x`` over ``dims`` (a tuple of
    non-negative axes) with :class:`_Chooser`'s grads."""
    if not x.is_floating_point():
        fn = torch.amax if largest else torch.amin
        return fn(x, dim=dims, keepdim=keepdim)
    return _Chooser.apply(x, tuple(dims), keepdim, largest)


_make_elementwise("max", maximum)
_make_elementwise("min", minimum)


class _Power(torch.autograd.Function):
    """``x ** y`` with the JAX package's grads at the poles, where
    torch's own differ: dX is ``y * x ** (y - 1)`` everywhere (NaN at
    x = y = 0, +inf at x = -0.0 for y = 0.5), and dY is ``log(x) * out``
    with log taken at 1 where x is 0.  ``y`` is a tensor or a float."""

    @staticmethod
    def forward(x, y):
        return torch.pow(x, y)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, y = inputs
        ctx.y_is_tensor = isinstance(y, torch.Tensor)
        if ctx.y_is_tensor:
            ctx.save_for_backward(x, y, output)
        else:
            ctx.save_for_backward(x, output)
            ctx.y = y

    @staticmethod
    def backward(ctx, g):
        if not ctx.y_is_tensor:
            x, _ = ctx.saved_tensors
            e = ctx.y - 1
            if e < 0 and not (float(e).is_integer() and e % 2):
                # IEEE pow(-0.0, e) is +inf here; torch's pow by a
                # scalar (an rsqrt at -0.5) gives -inf
                x = torch.where(x == 0, x.abs(), x)
            return g * ctx.y * torch.pow(x, e), None
        x, y, out = ctx.saved_tensors
        gx = gy = None
        if ctx.needs_input_grad[0]:
            gx = (g * y * torch.pow(x, y - 1)).sum_to_size(x.shape)
        if ctx.needs_input_grad[1]:
            log_x = torch.log(torch.where(x == 0, torch.ones_like(x), x))
            gy = (g * log_x * out).sum_to_size(y.shape)
        return gx, gy


def power(x, y):
    """``x ** y`` (``torch.pow``) with the grads of :class:`_Power`."""
    return _Power.apply(x, y)


_make_elementwise("pow", power)
# floor semantics with negative operands, as jnp.mod / jnp.floor_divide
# (torch.fmod and truncating division differ); floordiv has no grad
_make_elementwise("mod", torch.remainder)
_make_elementwise("floordiv",
                  lambda x, y: torch.div(x, y, rounding_mode="floor"))


# ---------------------------------------------------------------------------
# scale / sum / mean / sign / clip
# ---------------------------------------------------------------------------

@register_op("scale", infer_shape=infer_shape_unary())
def scale_lower(ctx):
    x = ctx.input("X")
    scale = ctx.attr("scale", 1.0)
    bias = ctx.attr("bias", 0.0)
    if ctx.attr("bias_after_scale", True):
        ctx.set_output("Out", x * scale + bias)
    else:
        ctx.set_output("Out", (x + bias) * scale)


@register_op("sum", infer_shape=infer_shape_unary(),
             selected_rows_inputs=("X",))
def sum_lower(ctx):
    """Elementwise sum of every ``X`` (dtypes promote, as in the JAX
    package: a bf16 and an f32 grad sum to f32).  SelectedRows inputs
    (reference ``sum_op.cc``): all sparse concatenate into one
    SelectedRows (duplicate rows stay, for the consumer to scatter-add or
    merge); mixed with dense ones, they are densified and added."""
    xs = ctx.inputs("X")
    if any(is_selected_rows(x) for x in xs):
        if all(is_selected_rows(x) for x in xs):
            ctx.set_output("Out", SelectedRows(
                torch.cat([x.rows for x in xs]),
                torch.cat([x.value for x in xs]), xs[0].height))
            return
        xs = [to_dense(x) for x in xs]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    ctx.set_output("Out", out)


def _infer_mean(op, block):
    out = block.var(op.output("Out")[0])
    out.shape = (1,)
    out.dtype = block.var(op.input("X")[0]).dtype


def _float_of_int(x):
    """An integer ``x`` as float32 (a mean of integers is a float32 in
    the JAX package), any other ``x`` as it is."""
    return x if x.is_floating_point() or x.is_complex() else x.float()


@register_op("mean", infer_shape=_infer_mean)
def mean_lower(ctx):
    x = _float_of_int(ctx.input("X"))
    lod = ctx.input_lod("X")
    if is_dyn(lod):
        # bucketed rows: the mean of the real rows only (rows past the
        # last split are padding); the count stays on the device
        n_real = lod.splits(ctx.env)[-1]
        rows = torch.arange(x.shape[0], device=x.device)
        mask = (rows < n_real).to(x.dtype).reshape(
            (-1,) + (1,) * (x.ndim - 1))
        per_row = int(np.prod(x.shape[1:])) if x.ndim > 1 else 1
        count = (n_real.to(x.dtype) * per_row).clamp(min=1)
        ctx.set_output("Out", ((x * mask).sum() / count).reshape(1))
        return
    ctx.set_output("Out", x.mean().reshape(1))


@register_op("sign", infer_shape=infer_shape_unary())
def sign_lower(ctx):
    # NaN stays NaN, as jnp.sign gives (torch.sign gives 0); an integer
    # keeps its dtype; no grad
    x = ctx.input("X")
    out = torch.sign(x)
    if x.is_floating_point():
        out = torch.where(torch.isnan(x), torch.nan, out)
    ctx.set_output("Out", out)


@register_op("clip", infer_shape=infer_shape_unary())
def clip_lower(ctx):
    # minimum(maximum(x, lo), hi) against tensor bounds, as jnp.clip: its
    # vjp splits the cotangent of a value on a bound in half, where
    # torch.clamp's passes all of it
    x = ctx.input("X")
    lo = torch.full((), ctx.attr("min"), dtype=x.dtype, device=x.device)
    hi = torch.full((), ctx.attr("max"), dtype=x.dtype, device=x.device)
    ctx.set_output("Out", minimum(maximum(x, lo), hi))


@register_op("clip_by_norm", infer_shape=infer_shape_unary())
def clip_by_norm_lower(ctx):
    x = ctx.input("X")
    max_norm = ctx.attr("max_norm")
    norm = torch.sqrt(torch.sum(x * x))
    scale = torch.where(norm > max_norm,
                        max_norm / torch.clamp(norm, min=1e-12),
                        torch.ones_like(norm)).to(x.dtype)
    ctx.set_output("Out", x * scale)


def _infer_scalar_out(op, block):
    out = block.var(op.output("Out")[0])
    out.shape = (1,)
    out.dtype = block.var(op.input("X")[0]).dtype


@register_op("squared_l2_norm", infer_shape=_infer_scalar_out)
def squared_l2_norm_lower(ctx):
    x = ctx.input("X")
    ctx.set_output("Out", torch.sum(x * x).reshape(1))


# ---------------------------------------------------------------------------
# reductions  (reference: reduce_op.cc functor family)
# ---------------------------------------------------------------------------

def _infer_reduce(op, block):
    x = block.var(op.input("X")[0])
    if x.shape is None:
        raise ShapeInferenceSkip()
    dim = op.attr("dim", [0])
    if isinstance(dim, int):
        dim = [dim]
    keep = op.attr("keep_dim", False)
    reduce_all = op.attr("reduce_all", False)
    out = block.var(op.output("Out")[0])
    if reduce_all:
        out.shape = tuple([1] * len(x.shape)) if keep else (1,)
    else:
        dims = [d % len(x.shape) for d in dim]
        if keep:
            out.shape = tuple(1 if i in dims else d
                              for i, d in enumerate(x.shape))
        else:
            shape = tuple(d for i, d in enumerate(x.shape) if i not in dims)
            out.shape = shape if shape else (1,)
    out.dtype = x.dtype


def _prod(x, dim, keepdim):
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _make_reduce(name, fn):
    @register_op("reduce_" + name, infer_shape=_infer_reduce)
    def lower(ctx):
        x = ctx.input("X")
        dim = ctx.attr("dim", [0])
        if isinstance(dim, int):
            dim = [dim]
        keep = ctx.attr("keep_dim", False)
        if ctx.attr("reduce_all", False):
            axes = tuple(range(x.ndim))
        else:
            axes = tuple(d % x.ndim for d in dim)
        # an empty dim reduces nothing (jnp.sum(x, axis=()) is x), where
        # torch reads dim=() as every axis
        out = fn(x, axes, keep) if axes else x
        if out.ndim == 0:
            out = out.reshape(1)
        ctx.set_output("Out", out)
    lower.__name__ = f"reduce_{name}_lower"
    return lower


def _sum(x, dim, keepdim):
    """``jnp.sum``: an integer sum keeps its dtype (an int32 wraps at
    2**31), where ``torch.sum`` promotes it to int64; a bool sum is
    int64 (the port's integers)."""
    keep = x.dtype if not (x.is_floating_point() or x.is_complex() or
                           x.dtype == torch.bool) else None
    return torch.sum(x, dim=dim, keepdim=keepdim, dtype=keep)


_make_reduce("sum", _sum)
_make_reduce("mean", lambda x, d, k: torch.mean(_float_of_int(x), dim=d,
                                               keepdim=k))
_make_reduce("max", lambda x, d, k: reduce_chooser(x, d, k, True))
_make_reduce("min", lambda x, d, k: reduce_chooser(x, d, k, False))
_make_reduce("prod", _prod)


@register_op("minus", infer_shape=infer_shape_unary())
def minus_lower(ctx):
    ctx.set_output("Out", ctx.input("X") - ctx.input("Y"))


@register_op("cumsum", infer_shape=infer_shape_unary())
def cumsum_lower(ctx):
    """Cumulative sum along ``axis``; ``exclusive`` drops each element's
    own term, ``reverse`` sums from the end."""
    x = ctx.input("X")
    axis = ctx.attr("axis", -1)
    reverse = ctx.attr("reverse", False)
    xs = torch.flip(x, (axis,)) if reverse else x
    out = torch.cumsum(xs, dim=axis)
    if ctx.attr("exclusive", False):
        out = out - xs
    ctx.set_output("Out", torch.flip(out, (axis,)) if reverse else out)


# ---------------------------------------------------------------------------
# norms / similarity / bilinear product
# ---------------------------------------------------------------------------

@register_op("l1_norm", infer_shape=_infer_scalar_out)
def l1_norm_lower(ctx):
    """``sum(|x|)``; the slope of ``|x|`` at 0 is +1 (``jnp.abs``)."""
    x = ctx.input("X")
    ctx.set_output("Out", torch.where(x >= 0, x, -x).sum().reshape(1))


def _infer_norm(op, block):
    x = block.var(op.input("X")[0])
    out = block.var(op.output("Out")[0])
    out.shape = x.shape
    out.dtype = x.dtype


@register_op("norm", infer_shape=_infer_norm)
def norm_lower(ctx):
    """X over its L2 norm along ``axis`` (``epsilon`` inside the root);
    ``Norm`` keeps the axis."""
    x = ctx.input("X")
    norm = torch.sqrt(torch.sum(x * x, dim=ctx.attr("axis", 1),
                                keepdim=True) + ctx.attr("epsilon", 1e-10))
    ctx.set_output("Out", x / norm)
    ctx.set_output("Norm", norm)


def _infer_cos_sim(op, block):
    x = block.var(op.input("X")[0])
    if x.shape is None:
        raise ShapeInferenceSkip()
    out = block.var(op.output("Out")[0])
    out.shape = (x.shape[0], 1)
    out.dtype = x.dtype


@register_op("cos_sim", infer_shape=_infer_cos_sim)
def cos_sim_lower(ctx):
    """Row-wise cosine of X ``[B, D]`` and Y ``[B or 1, D]`` (no
    epsilon: a zero row gives NaN, as in the JAX package), with the row
    norms ``XNorm`` and ``YNorm``."""
    x, y = ctx.input("X"), ctx.input("Y")
    xn = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    yn = torch.sqrt(torch.sum(y * y, dim=1, keepdim=True))
    dot = torch.sum(x * y, dim=1, keepdim=True)
    ctx.set_output("Out", dot / (xn * yn))
    ctx.set_output("XNorm", xn)
    ctx.set_output("YNorm", yn)


def _infer_bilinear(op, block):
    x = block.var(op.input("X")[0])
    w = block.var(op.input("Weight")[0])
    if x.shape is None or w.shape is None:
        raise ShapeInferenceSkip()
    out = block.var(op.output("Out")[0])
    out.shape = (x.shape[0], w.shape[0])
    out.dtype = x.dtype


@register_op("bilinear_tensor_product", infer_shape=_infer_bilinear)
def bilinear_tensor_product_lower(ctx):
    """``out[b, s] = x[b] . W[s] . y[b]`` (X ``[B, M]``, Y ``[B, N]``,
    Weight ``[S, M, N]``) plus the optional Bias."""
    x, y, w = ctx.input("X"), ctx.input("Y"), ctx.input("Weight")
    out = torch.einsum("bm,smn,bn->bs", x, w, y)
    b = ctx.input("Bias")
    if b is not None:
        out = out + b
    ctx.set_output("Out", out)
