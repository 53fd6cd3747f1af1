"""Metric ops (the port's counterpart of ``accuracy`` in
``paddle_tpu.ops.metric_ops``; reference ``accuracy_op.cc``)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.registry import register_op


def _infer_accuracy(op, block):
    for slot in ("Accuracy", "Correct", "Total"):
        names = op.output(slot)
        if names:
            v = block.var(names[0])
            v.shape = (1,)
            v.dtype = "float32" if slot == "Accuracy" else "int64"


@register_op("accuracy", infer_shape=_infer_accuracy, no_gradient=True)
def accuracy_lower(ctx):
    """Indices: [N, k] top-k class ids (``top_k``); Label: [N, 1].  A row
    is correct when its label is among its k ids.  ``Accuracy`` [1]
    float32, ``Correct`` and ``Total`` [1] int64."""
    indices = ctx.input("Indices")
    label = ctx.input("Label").reshape(-1, 1)
    correct = (indices == label).any(dim=1).sum().to(torch.int64)
    total = torch.tensor(indices.shape[0], dtype=torch.int64,
                         device=indices.device)
    ctx.set_output("Accuracy", (correct.float() / total).reshape(1))
    ctx.set_output("Correct", correct.reshape(1))
    ctx.set_output("Total", total.reshape(1))
