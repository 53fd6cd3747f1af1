"""Optimizer update ops (the port of ``sgd`` and ``adam`` in
``paddle_tpu.ops.optimizer_ops``; reference
``paddle/fluid/operators/{sgd,adam}_op``).

Each op consumes Param/Grad/state and emits ParamOut/state-out bound to
the SAME variable names, so the executor's persistable write-back gives
in-place update semantics.  As in the JAX package, the adam op emits
Beta1PowOut/Beta2PowOut itself (the reference appends separate ``scale``
ops for them).  Dense grads only: SelectedRows grads wait for the sparse
subsystem.  The other optimizers' ops wait with them.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.registry import register_op


def _infer_param_out(op, block):
    for in_slot, out_slot in (("Param", "ParamOut"),
                              ("Moment1", "Moment1Out"),
                              ("Moment2", "Moment2Out"),
                              ("Beta1Pow", "Beta1PowOut"),
                              ("Beta2Pow", "Beta2PowOut")):
        ins, outs = op.input(in_slot), op.output(out_slot)
        if ins and outs:
            try:
                iv = block.var(ins[0])
                ov = block.var(outs[0])
                ov.shape = iv.shape
                ov.dtype = iv.dtype
            except KeyError:
                pass


@register_op("sgd", infer_shape=_infer_param_out, no_gradient=True,
             stateful_outputs=("ParamOut",))
def sgd_lower(ctx):
    p = ctx.input("Param")
    g = ctx.input("Grad")
    lr = ctx.input("LearningRate").reshape(()).to(p.dtype)
    ctx.set_output("ParamOut", p - lr * g)


@register_op("adam", infer_shape=_infer_param_out, no_gradient=True,
             stateful_outputs=("ParamOut", "Moment1Out", "Moment2Out",
                               "Beta1PowOut", "Beta2PowOut"))
def adam_lower(ctx):
    """Bias-corrected Adam with the JAX package's arithmetic:
    ``lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t)``,
    ``p -= lr_t * m1 / (sqrt(m2) + eps)``."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    m1, m2 = ctx.input("Moment1"), ctx.input("Moment2")
    b1p = ctx.input("Beta1Pow").reshape(())
    b2p = ctx.input("Beta2Pow").reshape(())
    lr = ctx.input("LearningRate").reshape(()).to(torch.float32)
    beta1 = ctx.attr("beta1", 0.9)
    beta2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    lr_t = lr * torch.sqrt(1.0 - b2p) / (1.0 - b1p)
    ctx.set_output("Beta1PowOut", (b1p * beta1).reshape(1))
    ctx.set_output("Beta2PowOut", (b2p * beta2).reshape(1))
    m1n = beta1 * m1 + (1.0 - beta1) * g
    m2n = beta2 * m2 + (1.0 - beta2) * torch.square(g)
    p_new = p - (lr_t * m1n / (torch.sqrt(m2n) + eps)).to(p.dtype)
    ctx.set_output("ParamOut", p_new)
    ctx.set_output("Moment1Out", m1n)
    ctx.set_output("Moment2Out", m2n)
