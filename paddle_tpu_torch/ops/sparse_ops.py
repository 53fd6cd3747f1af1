"""Sparse / CTR ops (the port of ``paddle_tpu.ops.sparse_ops``; reference
``paddle/fluid/operators/nce_op.h``, ``split_ids_op.cc``,
``merge_selected_rows_op.cc``, ``get_tensor_from_selected_rows_op.cc``,
``split_selected_rows_op.cc``).

Shapes stay those of the JAX package, which keeps every output at the
input's length: ``split_ids`` pads a shard's ids with -1, and
``split_selected_rows`` gives each section all N slots, with row = the
section's height outside it (slots that :meth:`SelectedRows.live`
drops).
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.registry import (ShapeInferenceSkip,
                                           register_grad_lower, register_op)
from paddle_tpu_torch.selected_rows import SelectedRows, is_selected_rows


# ---------------------------------------------------------------------------
# nce
# ---------------------------------------------------------------------------

def _infer_nce(op, block):
    x = block.var(op.input("Input")[0])
    label = block.var(op.input("Label")[0])
    if x.shape is None or label.shape is None:
        raise ShapeInferenceSkip()
    n = x.shape[0]
    num_true = label.shape[1] if len(label.shape) == 2 else 1
    num_sampled = num_true + int(op.attr("num_neg_samples", 10))
    cost = block.var(op.output("Cost")[0])
    cost.shape = (n, 1)
    cost.dtype = x.dtype
    for slot, dt in (("SampleLogits", x.dtype), ("SampleLabels", "int64")):
        names = op.output(slot)
        if names:
            v = block.var(names[0])
            v.shape = (n, num_sampled)
            v.dtype = dt


def _nce_forward(x, w, bias, sample_labels, num_true, num_total_classes,
                 num_neg, sample_weight=None):
    """``(cost, o)`` for fixed sample labels (reference ``nce_op.h``
    NCEKernel): ``o = sigmoid(x·w[y] + b[y])``, ``b_q = num_neg /
    num_classes`` (the uniform sampler's density), ``cost_i = sum_true
    -log(o / (o + b_q)) + sum_neg -log(b_q / (o + b_q))``."""
    b_q = float(num_neg) / float(num_total_classes)
    logits = torch.einsum("nd,nsd->ns", x, w[sample_labels])
    if bias is not None:
        logits = logits + bias.reshape(-1)[sample_labels]
    o = torch.sigmoid(logits)
    is_true = (torch.arange(sample_labels.shape[1], device=x.device)
               < num_true).unsqueeze(0)
    eps = 1e-12
    cost = torch.where(is_true, -torch.log(o / (o + b_q) + eps),
                       -torch.log(b_q / (o + b_q) + eps)
                       ).sum(1, keepdim=True)
    if sample_weight is not None:
        cost = cost * sample_weight.reshape(-1, 1)
    return cost, o


@register_op("nce", infer_shape=_infer_nce, uses_rng=True,
             no_grad_inputs=("Label", "SampleWeight"),
             stop_gradient_outputs=("SampleLogits", "SampleLabels"))
def nce_lower(ctx):
    """Negatives are ``custom_neg_classes`` (exactly ``num_neg_samples``
    of them) or uniform draws from the op's device generator
    (``LowerContext.generator``; the JAX package draws from its own key,
    so only the custom path agrees bit for bit)."""
    x, label = ctx.input("Input"), ctx.input("Label").long()
    num_total = int(ctx.attr("num_total_classes"))
    num_neg = int(ctx.attr("num_neg_samples", 10))
    custom_neg = ctx.attr("custom_neg_classes", []) or []
    if label.ndim == 1:
        label = label.unsqueeze(1)
    n, num_true = label.shape
    if custom_neg:
        if len(custom_neg) != num_neg:
            raise ValueError(
                f"nce: len(custom_neg_classes)={len(custom_neg)} must "
                f"equal num_neg_samples={num_neg}")
        neg = torch.tensor(custom_neg, dtype=label.dtype,
                           device=label.device).expand(n, num_neg)
    else:
        neg = torch.randint(0, num_total, (n, num_neg),
                            generator=ctx.generator(), device=label.device,
                            dtype=label.dtype)
    sample_labels = torch.cat([label, neg], dim=1)     # [N, T + S]
    cost, o = _nce_forward(x, ctx.input("Weight"), ctx.input("Bias"),
                           sample_labels, num_true, num_total, num_neg,
                           ctx.input("SampleWeight"))
    ctx.set_output("Cost", cost)
    ctx.set_output("SampleLogits", o)
    ctx.set_output("SampleLabels", sample_labels)


@register_grad_lower("nce")
def nce_grad_lower(ctx):
    """The vjp of the forward with ``SampleLabels`` held as the forward
    drew them (drawing again would decouple the two)."""
    x, w, bias = ctx.input("Input"), ctx.input("Weight"), ctx.input("Bias")
    sample_weight = ctx.input("SampleWeight")
    sample_labels = ctx.input("SampleLabels").long()
    label = ctx.input("Label")
    num_true = label.shape[1] if label.ndim == 2 else 1
    num_total = int(ctx.attr("num_total_classes"))
    num_neg = int(ctx.attr("num_neg_samples", 10))

    def cost(*args):
        b = args[2] if len(args) == 3 else None
        return _nce_forward(args[0], args[1], b, sample_labels, num_true,
                            num_total, num_neg, sample_weight)[0]

    primals = (x, w) if bias is None else (x, w, bias)
    _, vjp = torch.func.vjp(cost, *primals)
    grads = vjp(ctx.input("Cost@GRAD"))
    for slot, g in zip(("Input@GRAD", "Weight@GRAD", "Bias@GRAD"), grads):
        names = ctx.op.output(slot)
        if names and names[0]:
            ctx.outputs[names[0]] = g


# ---------------------------------------------------------------------------
# split_ids, and the SelectedRows ops
# ---------------------------------------------------------------------------

@register_op("split_ids", no_gradient=True)
def split_ids_lower(ctx):
    """Ids by ``id % num_shards`` (reference ``split_ids_op.cc``): each
    shard's output keeps the input's length ``[N, 1]``, -1 where an id
    belongs to another shard."""
    ids = ctx.input("Ids").reshape(-1)
    out_names = ctx.op.output("Out")
    for i, name in enumerate(out_names):
        ctx.outputs[name] = torch.where(
            ids % len(out_names) == i, ids,
            torch.full_like(ids, -1)).reshape(-1, 1)


@register_op("merge_selected_rows", no_gradient=True,
             selected_rows_inputs=("X",))
def merge_selected_rows_lower(ctx):
    """Duplicate rows summed (:meth:`SelectedRows.merge_duplicates`); a
    dense input passes through, being merged already."""
    x = ctx.input("X")
    ctx.set_output("Out", x.merge_duplicates() if is_selected_rows(x)
                   else x)


@register_op("get_tensor_from_selected_rows", no_gradient=True,
             selected_rows_inputs=("X",))
def get_tensor_from_selected_rows_lower(ctx):
    """The ``[height, dim]`` tensor of a SelectedRows."""
    x = ctx.input("X")
    ctx.set_output("Out", x.to_dense() if is_selected_rows(x) else x)


@register_op("split_selected_rows", no_gradient=True,
             selected_rows_inputs=("X",))
def split_selected_rows_lower(ctx):
    """Rows split into ``height_sections`` (reference
    ``split_selected_rows_op.cc``): each output a SelectedRows with the
    rows local to its section and all N slots; a row outside the section
    becomes the section's height.  A dense X stands for rows 0..N-1."""
    x = ctx.input("X")
    if not is_selected_rows(x):
        x = SelectedRows(torch.arange(x.shape[0], device=x.device), x,
                         x.shape[0])
    offset = 0
    for name, h in zip(ctx.op.output("Out"), ctx.attr("height_sections")):
        in_sec = (x.rows >= offset) & (x.rows < offset + h)
        ctx.outputs[name] = SelectedRows(
            torch.where(in_sec, x.rows - offset, torch.full_like(x.rows, h)),
            x.value, int(h))
        offset += h
