"""Activations (the port's counterpart of ``paddle_tpu.ops.
activation_ops``; reference ``paddle/fluid/operators/activation_op.cc``).
Only those the serving slice runs are ported."""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.registry import register_op, infer_shape_unary


@register_op("relu", infer_shape=infer_shape_unary())
def relu_lower(ctx):
    ctx.set_output("Out", torch.relu(ctx.input("X")))
