"""Activations (the port's counterpart of ``paddle_tpu.ops.
activation_ops``; reference ``paddle/fluid/operators/activation_op.cc``).
Only those the ported slices run are here."""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.registry import register_op, infer_shape_unary


@register_op("relu", infer_shape=infer_shape_unary())
def relu_lower(ctx):
    ctx.set_output("Out", torch.relu(ctx.input("X")))


@register_op("sqrt", infer_shape=infer_shape_unary())
def sqrt_lower(ctx):
    ctx.set_output("Out", torch.sqrt(ctx.input("X")))
