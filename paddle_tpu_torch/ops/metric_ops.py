"""Metric ops (the port of ``paddle_tpu.ops.metric_ops``; reference
``accuracy_op.cc``, ``auc_op.cc``, ``precision_recall_op.cc``,
``chunk_eval_op.h``, ``positive_negative_pair_op.h``).

``accuracy``, ``auc`` and ``precision_recall`` run on the device;
``chunk_eval`` and ``positive_negative_pair`` are host ops, as in the
JAX package: they read their inputs on the host (one device sync each
on the card) and keep their block eager.  Counters are int64 (the
port's integers)."""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.ops.registry import register_op
from paddle_tpu_torch.ops.tensor_ops import saturating_cast


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
    total = torch.full((), indices.shape[0], dtype=torch.int64,
                       device=indices.device)
    ctx.set_output("Accuracy", (correct.float() / total).reshape(1))
    ctx.set_output("Correct", correct.reshape(1))
    ctx.set_output("Total", total.reshape(1))


@register_op("auc", no_gradient=True)
def auc_lower(ctx):
    """Streaming ROC AUC over ``num_thresholds + 1`` histogram buckets of
    the positive score (``Predict[:, -1]``): this batch's positive and
    negative counts a bucket, plus ``StatPos`` / ``StatNeg`` where given,
    then the trapezoid over the cumulative counts from the top bucket
    down.  ``StatPosOut`` / ``StatNegOut`` carry the histograms."""
    predict = ctx.input("Predict")
    label = ctx.input("Label").reshape(-1)
    num_buckets = ctx.attr("num_thresholds", 200) + 1
    bucket = saturating_cast(predict[:, -1] * (num_buckets - 1),
                             torch.int32).clamp(0, num_buckets - 1).long()
    is_pos = (label > 0).long()
    zeros = torch.zeros(num_buckets, dtype=torch.int64,
                        device=predict.device)
    tp_hist = zeros.index_add(0, bucket, is_pos)
    fp_hist = zeros.index_add(0, bucket, 1 - is_pos)
    stat_pos, stat_neg = ctx.input("StatPos"), ctx.input("StatNeg")
    if stat_pos is not None:
        tp_hist = tp_hist + stat_pos.reshape(-1).long()
        fp_hist = fp_hist + stat_neg.reshape(-1).long()
    tp_cum = torch.cumsum(tp_hist.flip(0), 0)
    fp_cum = torch.cumsum(fp_hist.flip(0), 0)
    tp_prev = torch.cat([zeros[:1], tp_cum[:-1]])
    fp_prev = torch.cat([zeros[:1], fp_cum[:-1]])
    area = ((fp_cum - fp_prev) * (tp_cum + tp_prev)).float().div(2.0).sum()
    denom = (tp_cum[-1] * fp_cum[-1]).float()
    auc = torch.where(denom > 0, area / denom.clamp(min=1.0),
                      torch.zeros_like(area))
    ctx.set_output("AUC", auc.reshape(1))
    ctx.set_output("StatPosOut", tp_hist)
    ctx.set_output("StatNegOut", fp_hist)


@register_op("precision_recall", no_gradient=True)
def precision_recall_lower(ctx):
    """Per-class weighted true-positive, false-positive and
    false-negative counts of ``Indices`` against ``Labels`` (plus the
    accumulated ``StatesInfo``), and their macro and micro precision,
    recall and F1 (``BatchMetrics`` = ``AccumMetrics``, six values)."""
    indices = ctx.input("Indices").reshape(-1).long()
    labels = ctx.input("Labels").reshape(-1).long()
    cls = int(ctx.attr("class_number"))
    weights = ctx.input("Weights")
    w = weights.reshape(-1).float() if weights is not None else \
        torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    hit = (indices == labels).float()
    zeros = torch.zeros(cls, dtype=torch.float32, device=labels.device)
    tp = zeros.index_add(0, labels, w * hit)
    fp = zeros.index_add(0, indices, w * (1.0 - hit))
    fn = zeros.index_add(0, labels, w * (1.0 - hit))
    states = ctx.input("StatesInfo")
    if states is not None:
        tp = tp + states[:, 0]
        fp = fp + states[:, 1]
        fn = fn + states[:, 3]
    eps = 1e-6
    prec = tp / (tp + fp).clamp(min=eps)
    rec = tp / (tp + fn).clamp(min=eps)
    f1 = 2 * prec * rec / (prec + rec).clamp(min=eps)
    mtp, mfp, mfn = tp.sum(), fp.sum(), fn.sum()
    mprec = mtp / (mtp + mfp).clamp(min=eps)
    mrec = mtp / (mtp + mfn).clamp(min=eps)
    metrics = torch.stack([prec.mean(), rec.mean(), f1.mean(), mprec, mrec,
                           2 * mprec * mrec / (mprec + mrec).clamp(min=eps)])
    ctx.set_output("BatchMetrics", metrics)
    ctx.set_output("AccumMetrics", metrics)
    ctx.set_output("AccumStatesInfo", torch.stack([tp, fp, zeros, fn],
                                                  dim=1))


# ---------------------------------------------------------------------------
# chunk_eval (NER chunk F1 under IOB / IOE / IOBES / plain) and
# positive_negative_pair: host ops over the LoD's segments
# ---------------------------------------------------------------------------

_CHUNK_SCHEMES = {
    # scheme: (num_tag_types, tag_begin, tag_inside, tag_end, tag_single)
    "IOB": (2, 0, 1, -1, -1),
    "IOE": (2, -1, 0, 1, -1),
    "IOBES": (4, 0, 1, 2, 3),
    "plain": (1, -1, -1, -1, 0),
}


def chunk_segments(labels, num_chunk_types, scheme):
    """The ``(begin, end, type)`` chunks of one tag sequence (reference
    ``GetSegments`` / ``ChunkBegin`` / ``ChunkEnd``); tag ``l`` is
    ``l % num_tag`` of type ``l // num_tag``, and type
    ``num_chunk_types`` is outside every chunk."""
    num_tag, tag_begin, tag_inside, tag_end, tag_single = \
        _CHUNK_SCHEMES[scheme]
    other = num_chunk_types

    def chunk_end(ptag, ptype, tag, type_):
        if ptype == other:
            return False
        if type_ == other or type_ != ptype:
            return True
        if ptag in (tag_begin, tag_inside):
            return tag in (tag_begin, tag_single)
        return ptag in (tag_end, tag_single)

    def chunk_begin(ptag, ptype, tag, type_):
        if ptype == other:
            return type_ != other
        if type_ == other:
            return False
        if type_ != ptype:
            return True
        if tag in (tag_begin, tag_single):
            return True
        if tag in (tag_inside, tag_end):
            return ptag in (tag_end, tag_single)
        return False

    segments = []
    in_chunk = False
    start = 0
    tag, type_ = -1, other
    for i, lab in enumerate(labels):
        ptag, ptype = tag, type_
        tag, type_ = int(lab) % num_tag, int(lab) // num_tag
        if in_chunk and chunk_end(ptag, ptype, tag, type_):
            segments.append((start, i - 1, ptype))
            in_chunk = False
        if chunk_begin(ptag, ptype, tag, type_):
            start = i
            in_chunk = True
    if in_chunk:
        segments.append((start, len(labels) - 1, type_))
    return segments


def host_values(t):
    """A host op's input as a flat numpy array of its own dtype (a
    device sync on the card)."""
    return t.detach().cpu().numpy().reshape(-1)


@register_op("chunk_eval", no_gradient=True, host=True)
def chunk_eval_lower(ctx):
    """Chunks of ``Inference`` and ``Label`` a sequence (the LoD of
    either; one sequence without), less ``excluded_chunk_types``: the
    counts and ``Precision``, ``Recall`` and ``F1-Score`` (float32)."""
    inference = host_values(ctx.input("Inference"))
    label = host_values(ctx.input("Label"))
    lod = ctx.input_lod("Inference") or ctx.input_lod("Label")
    splits = lod[0] if lod is not None else [0, len(label)]
    num_chunk_types = int(ctx.attr("num_chunk_types"))
    scheme = ctx.attr("chunk_scheme", "IOB")
    excluded = set(ctx.attr("excluded_chunk_types", []) or [])
    num_infer = num_label = num_correct = 0
    for lo, hi in zip(splits[:-1], splits[1:]):
        lo, hi = int(lo), int(hi)
        inf_seg = [s for s in chunk_segments(inference[lo:hi],
                                             num_chunk_types, scheme)
                   if s[2] not in excluded]
        lab_seg = [s for s in chunk_segments(label[lo:hi],
                                             num_chunk_types, scheme)
                   if s[2] not in excluded]
        num_infer += len(inf_seg)
        num_label += len(lab_seg)
        num_correct += len(set(inf_seg) & set(lab_seg))
    precision = num_correct / num_infer if num_infer else 0.0
    recall = num_correct / num_label if num_label else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if num_correct else 0.0)
    dev = ctx.device
    for slot, value, dtype in (
            ("Precision", precision, torch.float32),
            ("Recall", recall, torch.float32),
            ("F1-Score", f1, torch.float32),
            ("NumInferChunks", num_infer, torch.int64),
            ("NumLabelChunks", num_label, torch.int64),
            ("NumCorrectChunks", num_correct, torch.int64)):
        ctx.set_output(slot, torch.tensor([value], dtype=dtype, device=dev))


@register_op("positive_negative_pair", no_gradient=True, host=True)
def positive_negative_pair_lower(ctx):
    """Over each query's pairs of differently labelled items: the
    (weighted) count ranked right (``PositivePair``), wrong
    (``NegativePair``) and tied (``NeutralPair``), plus the
    ``Accumulate*`` inputs where given."""
    score = host_values(ctx.input("Score"))
    label = host_values(ctx.input("Label"))
    qid = host_values(ctx.input("QueryID"))
    weight = ctx.input("Weight")
    w = host_values(weight) if weight is not None else None
    pos = neg = neu = 0.0
    for q in np.unique(qid):
        idx = np.where(qid == q)[0]
        for a in range(len(idx)):
            for b in range(a + 1, len(idx)):
                i, j = idx[a], idx[b]
                if label[i] == label[j]:
                    continue
                pair_w = 1.0 if w is None else (w[i] + w[j]) / 2.0
                hi, lo = (i, j) if label[i] > label[j] else (j, i)
                if score[hi] > score[lo]:
                    pos += pair_w
                elif score[hi] == score[lo]:
                    neu += pair_w
                else:
                    neg += pair_w
    totals = {"PositivePair": pos, "NegativePair": neg, "NeutralPair": neu}
    for slot in totals:
        prev = ctx.input("Accumulate" + slot)
        if prev is not None:
            totals[slot] += float(host_values(prev)[0])
        ctx.set_output(slot, torch.tensor([totals[slot]],
                                          dtype=torch.float32,
                                          device=ctx.device))
