"""Loss ops (the port's counterpart of ``softmax_with_cross_entropy`` in
``paddle_tpu.ops.loss_ops``; reference
``paddle/fluid/operators/softmax_with_cross_entropy_op.cc``).  The grad
is the auto-vjp of the lowering."""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.registry import register_op, ShapeInferenceSkip


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
