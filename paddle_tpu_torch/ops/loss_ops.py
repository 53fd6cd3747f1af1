"""Loss ops (the port's counterpart of ``softmax_with_cross_entropy``,
``cross_entropy`` and ``sigmoid_cross_entropy_with_logits`` in
``paddle_tpu.ops.loss_ops``; reference
``paddle/fluid/operators/softmax_with_cross_entropy_op.cc``,
``cross_entropy_op.cc``, ``sigmoid_cross_entropy_with_logits_op.cc``).
The grads of ``softmax_with_cross_entropy`` and
``sigmoid_cross_entropy_with_logits`` are the auto-vjp of their
lowerings; ``cross_entropy`` has its own."""

from __future__ import annotations

import torch

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
