"""Loss ops (the port of ``paddle_tpu.ops.loss_ops``; reference
``paddle/fluid/operators/softmax_with_cross_entropy_op.cc``,
``cross_entropy_op.cc``, ``sigmoid_cross_entropy_with_logits_op.cc``,
``squared_l2_distance_op.cc``, ``smooth_l1_loss_op.cc``,
``hinge_loss_op.cc``, ``huber_loss_op.cc``, ``log_loss_op.cc``,
``rank_loss_op.cc``, ``margin_rank_loss_op.cc``,
``modified_huber_loss_op.cc``).  ``cross_entropy`` has its own grad;
every other grad is the auto-vjp of the lowering, so a ``where`` sends
the cotangent to the branch it picked and a clip at 0 is
:func:`math_ops.maximum`'s (half the cotangent on a tie), as in the JAX
package."""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.math_ops import maximum
from paddle_tpu_torch.ops.registry import (infer_shape_unary,
                                           register_grad_lower, register_op,
                                           ShapeInferenceSkip)


def _infer_softmax_ce(op, block):
    logits = block.var(op.input("Logits")[0])
    if logits.shape is None:
        raise ShapeInferenceSkip()
    sm = block.var(op.output("Softmax")[0])
    sm.shape = logits.shape
    sm.dtype = logits.dtype
    loss = block.var(op.output("Loss")[0])
    loss.shape = tuple(logits.shape[:-1]) + (1,)
    loss.dtype = logits.dtype


@register_op("softmax_with_cross_entropy", infer_shape=_infer_softmax_ce,
             no_grad_inputs=("Label",),
             stop_gradient_outputs=("Softmax",), amp_upcast=("Logits",))
def softmax_with_cross_entropy_lower(ctx):
    """Loss = -log softmax(logits)[label] per row (hard labels, [N, 1]
    ids) or -sum(label * log softmax) (``soft_label``); under AMP the
    logits are upcast to float32 first."""
    logits = ctx.input("Logits")
    label = ctx.input("Label")
    log_sm = torch.log_softmax(logits, dim=-1)
    if ctx.attr("soft_label", False):
        loss = -torch.sum(label * log_sm, dim=-1, keepdim=True)
    else:
        lbl = label.reshape(label.shape[:-1]) if label.shape[-1] == 1 \
            else label
        loss = -torch.gather(log_sm, -1, lbl.long().unsqueeze(-1))
    ctx.set_output("Softmax", torch.exp(log_sm))
    ctx.set_output("Loss", loss)


# ---------------------------------------------------------------------------
# cross_entropy: -log(p[label]) of probabilities (after a softmax)
# ---------------------------------------------------------------------------

#: probabilities are clamped from below before the log
CE_MIN_PROB = 1e-20


def _infer_cross_entropy(op, block):
    x = block.var(op.input("X")[0])
    out = block.var(op.output("Out")[0] if op.output("Out")
                    else op.output("Loss")[0])
    if x.shape is not None:
        out.shape = (x.shape[0], 1)
    out.dtype = x.dtype


def _hard_label(label):
    """[N, 1] or [N] class ids as an [N, 1] int64 index."""
    return label.reshape(-1, 1).long()


@register_op("cross_entropy", infer_shape=_infer_cross_entropy,
             no_grad_inputs=("Label",), amp_upcast=("X",))
def cross_entropy_lower(ctx):
    """X: [N, D] probabilities (float32 under AMP); Label: [N, 1] class ids
    or, with ``soft_label``, [N, D] distributions.  ``Y`` and ``Out``
    (one variable in the builders) are ``[N, 1]``: ``-log(max(p, 1e-20))``
    of the label's probability, or ``-sum(label * log(max(p, 1e-20)))``."""
    x, label = ctx.input("X"), ctx.input("Label")
    logp = torch.log(torch.clamp(x, min=CE_MIN_PROB))
    if ctx.attr("soft_label", False):
        loss = -torch.sum(label * logp, dim=-1, keepdim=True)
    else:
        loss = -torch.gather(logp, 1, _hard_label(label))
    ctx.set_output("Y", loss)
    ctx.set_output("Out", loss)


@register_grad_lower("cross_entropy")
def cross_entropy_grad_lower(ctx):
    """``dX = -dY * label / p`` where ``p > 1e-20`` (0 where the clamp
    holds).  ``Y`` and ``Out`` name one variable, so its grad is counted
    once; the JAX package's auto-vjp counts it once for each slot and
    doubles ``dX`` (ROADMAP, faults of the reference)."""
    op = ctx.op
    gx = op.output("X@GRAD")
    if not gx or not gx[0]:
        return
    xe = ctx.env[op.input("X")[0]]
    x = xe.float()
    label = ctx.env[op.input("Label")[0]]
    dy = ctx.env[op.input("Y@GRAD")[0]].float()
    live = x > CE_MIN_PROB
    inv = torch.where(live, 1.0 / torch.clamp(x, min=CE_MIN_PROB), 0.0)
    if op.attr("soft_label", False):
        dx = -dy * label.float() * inv
    else:
        idx = _hard_label(label)
        dx = torch.zeros_like(x).scatter_(
            1, idx, -dy * torch.gather(inv, 1, idx))
    ctx.outputs[gx[0]] = dx.to(xe.dtype)


@register_op("sigmoid_cross_entropy_with_logits",
             infer_shape=infer_shape_unary(), no_grad_inputs=("Label",))
def sigmoid_cross_entropy_with_logits_lower(ctx):
    """``max(x, 0) - x * z + log(1 + exp(-|x|))``, elementwise (the
    numerically stable form of the JAX package).  Its auto-vjp is
    ``sigmoid(x) - z`` everywhere; at ``x = 0`` exactly the JAX package's
    gives ``-z`` (its ``abs`` takes slope +1 at 0, ROADMAP, faults of
    the reference)."""
    x, label = ctx.input("X"), ctx.input("Label")
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    ctx.set_output("Out", torch.maximum(x, zero) - x * label
                   + torch.log1p(torch.exp(-torch.abs(x))))


def _infer_sqdist(op, block):
    x = block.var(op.input("X")[0])
    if x.shape is not None:
        sub = block.var(op.output("sub_result")[0])
        sub.shape = x.shape
        sub.dtype = x.dtype
        out = block.var(op.output("Out")[0])
        out.shape = (x.shape[0], 1)
        out.dtype = x.dtype


@register_op("squared_l2_distance", infer_shape=_infer_sqdist)
def squared_l2_distance_lower(ctx):
    """``sum((x - y)**2)`` over the last axis, ``[N, 1]``; Y may be one
    row that broadcasts."""
    sub = ctx.input("X") - ctx.input("Y")
    ctx.set_output("sub_result", sub)
    ctx.set_output("Out", torch.sum(sub * sub, dim=-1, keepdim=True))


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


@register_op("smooth_l1_loss", no_grad_inputs=("InsideWeight",
                                               "OutsideWeight"))
def smooth_l1_loss_lower(ctx):
    """``0.5 sigma**2 d**2`` where ``|d| < 1 / sigma**2``, else ``|d| -
    0.5 / sigma**2``, of ``d = (x - y) * InsideWeight``, times
    ``OutsideWeight``, summed over all but the first axis: ``[N, 1]``."""
    x, y = ctx.input("X"), ctx.input("Y")
    s2 = ctx.attr("sigma", 1.0) ** 2
    inw, outw = ctx.input("InsideWeight"), ctx.input("OutsideWeight")
    diff = x - y
    if inw is not None:
        diff = diff * inw
    ad = torch.where(diff >= 0, diff, -diff)
    val = torch.where(ad < 1.0 / s2, 0.5 * s2 * diff * diff, ad - 0.5 / s2)
    ctx.set_output("Diff", diff)
    if outw is not None:
        val = val * outw
    ctx.set_output("Out", torch.sum(val, dim=tuple(range(1, x.ndim)))
                   .unsqueeze(1))


@register_op("hinge_loss", no_grad_inputs=("Labels",))
def hinge_loss_lower(ctx):
    """``max(1 - (2 label - 1) logit, 0)``."""
    logits, labels = ctx.input("Logits"), ctx.input("Labels")
    z = 1.0 - (2.0 * labels - 1.0) * logits
    ctx.set_output("Loss", maximum(z, _zero(z)))


@register_op("huber_loss")
def huber_loss_lower(ctx):
    """``0.5 r**2`` where ``|r| <= delta``, else ``delta (|r| - delta /
    2)``, of the residual ``r = y - x``."""
    x, y = ctx.input("X"), ctx.input("Y")
    delta = ctx.attr("delta", 1.0)
    r = y - x
    ar = torch.where(r >= 0, r, -r)
    ctx.set_output("Residual", r)
    ctx.set_output("Out", torch.where(ar <= delta, 0.5 * r * r,
                                      delta * (ar - 0.5 * delta)))


@register_op("log_loss", no_grad_inputs=("Labels",))
def log_loss_lower(ctx):
    p, y = ctx.input("Predicted"), ctx.input("Labels")
    eps = ctx.attr("epsilon", 1e-4)
    ctx.set_output("Loss", -y * torch.log(p + eps)
                   - (1.0 - y) * torch.log(1.0 - p + eps))


@register_op("rank_loss", no_grad_inputs=("Label",))
def rank_loss_lower(ctx):
    """``log(1 + exp(left - right)) - label (left - right)``."""
    d = ctx.input("Left") - ctx.input("Right")
    ctx.set_output("Out", torch.log1p(torch.exp(d)) - ctx.input("Label") * d)


@register_op("margin_rank_loss", no_grad_inputs=("Label",))
def margin_rank_loss_lower(ctx):
    """``max(0, -label (x1 - x2) + margin)`` and the 0/1 ``Activated``."""
    label = ctx.input("Label")
    x1, x2 = ctx.input("X1"), ctx.input("X2")
    z = -label * (x1 - x2) + ctx.attr("margin", 0.0)
    out = maximum(_zero(z), z)
    ctx.set_output("Out", out)
    ctx.set_output("Activated", (out > 0).to(x1.dtype))


@register_op("modified_huber_loss", no_grad_inputs=("Y",))
def modified_huber_loss_lower(ctx):
    """Of ``z = (2 y - 1) x``: ``-4 z`` where ``z < -1``, else
    ``max(1 - z, 0)**2``."""
    x, y = ctx.input("X"), ctx.input("Y")
    z = (2.0 * y - 1.0) * x
    m = maximum(1.0 - z, _zero(z))
    ctx.set_output("IntermediateVal", z)
    ctx.set_output("Out", torch.where(z < -1.0, -4.0 * z, m * m))
