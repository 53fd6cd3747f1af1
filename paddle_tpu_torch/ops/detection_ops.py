"""Detection ops: the SSD pipeline (the port of
``paddle_tpu.ops.detection_ops``; reference ``prior_box_op.h``,
``box_coder_op.h``, ``iou_similarity_op.h``, ``bipartite_match_op.cc``,
``target_assign_op.h``, ``mine_hard_examples_op.cc``,
``multiclass_nms_op.cc``, ``roi_pool_op.h``, ``detection_map_op.h``).

On the device:

* ``prior_box`` depends on the input's and the image's shapes and the
  attrs only: its boxes are made once per prepared step on the device
  (``tensor_ops._constant``), never per step.
* ``bipartite_match`` pads every LoD instance's rows to the largest
  instance (padding rows take no match) and runs the greedy matching
  over the whole batch at once, ``min(rows, cols)`` trips of one
  row-major first-maximum each (the JAX package's ``jnp.argmax`` order),
  so its launches do not grow with the batch.  ``per_prediction`` then
  gives each unmatched column its best row (the first on a tie).
* ``target_assign`` gathers every instance's rows in one indexing op,
  and takes ``NegIndices`` dense ``[N, P]`` (-1 padded, as
  ``mine_hard_examples`` emits it) or flat with a LoD.
* ``mine_hard_examples`` sorts the losses with a stable sort (the JAX
  package's ``argsort`` is stable: a tie keeps the lower prior first).
* ``roi_pool`` masks each bin over the whole plane, with an explicit
  grad that adds ``Out@GRAD`` at ``Argmax``; ``scale_sub_region`` is a
  mask, its grad the auto-vjp.

``bipartite_match`` and ``target_assign`` copy their LoD's row tables
from the host each run, so a block holding them stays eager
(``eager_only``), as the sequence ops with a static LoD do.

On the host, as in the JAX package (their output rows depend on the
data): ``multiclass_nms`` (a stable sort by descending score a class,
greedy suppression, ``keep_top_k`` over the classes, ``[[-1]]`` with an
all-zero LoD when nothing is kept) and ``detection_map`` (streaming VOC
mAP whose ``AccumTruePos`` / ``AccumFalsePos`` carry a per-class LoD;
the executor keeps the LoD a lowering sets on persistable state in the
scope, so the next run reads it: the JAX package's executor seeds LoDs
from the feeds only and drops them).  Each reads its inputs on the host
(a device sync on the card)."""

from __future__ import annotations

import math

import numpy as np
import torch

from paddle_tpu_torch.ops.registry import (
    register_op, register_grad_lower, ShapeInferenceSkip)
from paddle_tpu_torch.ops.tensor_ops import _constant

_KEPS = 1e-6


def _host(t):
    """A host op's input as a numpy array (a device sync on the card)."""
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# iou_similarity
# ---------------------------------------------------------------------------

def _infer_iou(op, block):
    x = block.var(op.input("X")[0])
    y = block.var(op.input("Y")[0])
    out = block.var(op.output("Out")[0])
    if x.shape is None or y.shape is None:
        raise ShapeInferenceSkip()
    out.shape = (x.shape[0], y.shape[0])
    out.dtype = x.dtype
    out.lod_level = x.lod_level


def _iou_matrix(a, b):
    """Pairwise IoU of [N, 4] x [M, 4] corner boxes (reference
    ``IOUSimilarity``, ``iou_similarity_op.h:20``)."""
    area1 = (a[:, 3] - a[:, 1]) * (a[:, 2] - a[:, 0])
    area2 = (b[:, 3] - b[:, 1]) * (b[:, 2] - b[:, 0])
    ixmin = torch.maximum(a[:, None, 0], b[None, :, 0])
    iymin = torch.maximum(a[:, None, 1], b[None, :, 1])
    ixmax = torch.minimum(a[:, None, 2], b[None, :, 2])
    iymax = torch.minimum(a[:, None, 3], b[None, :, 3])
    iw = (ixmax - ixmin).clamp(min=0.0)
    ih = (iymax - iymin).clamp(min=0.0)
    inter = iw * ih
    union = area1[:, None] + area2[None, :] - inter
    return inter / union


@register_op("iou_similarity", infer_shape=_infer_iou, no_gradient=True)
def iou_similarity_lower(ctx):
    ctx.set_output("Out", _iou_matrix(ctx.input("X"), ctx.input("Y")))
    lod = ctx.input_lod("X")
    if lod is not None:
        ctx.set_output_lod("Out", lod)


# ---------------------------------------------------------------------------
# box_coder
# ---------------------------------------------------------------------------

def _infer_box_coder(op, block):
    tb = block.var(op.input("TargetBox")[0])
    pb = block.var(op.input("PriorBox")[0])
    out = block.var(op.output("OutputBox")[0])
    if tb.shape is None or pb.shape is None:
        raise ShapeInferenceSkip()
    if op.attr("code_type", "encode_center_size") == "encode_center_size":
        out.shape = (tb.shape[0], pb.shape[0], 4)
    else:
        out.shape = tuple(tb.shape)
    out.dtype = tb.dtype
    out.lod_level = tb.lod_level


@register_op("box_coder", infer_shape=_infer_box_coder, no_gradient=True)
def box_coder_lower(ctx):
    """``encode_center_size``: target ``[N, 4]`` corner boxes to ``[N, M,
    4]`` deltas against each of the ``M`` priors; ``decode_center_size``:
    ``[N, M, 4]`` deltas back to corner boxes (reference
    ``box_coder_op.h``)."""
    prior = ctx.input("PriorBox")
    pvar = ctx.input("PriorBoxVar")
    target = ctx.input("TargetBox")
    code_type = ctx.attr("code_type", "encode_center_size")
    if pvar is None:
        pvar = torch.ones_like(prior)
    pw = prior[:, 2] - prior[:, 0]
    ph = prior[:, 3] - prior[:, 1]
    pcx = (prior[:, 2] + prior[:, 0]) / 2
    pcy = (prior[:, 3] + prior[:, 1]) / 2
    if code_type == "encode_center_size":
        tcx = (target[:, 2] + target[:, 0]) / 2
        tcy = (target[:, 3] + target[:, 1]) / 2
        tw = target[:, 2] - target[:, 0]
        th = target[:, 3] - target[:, 1]
        ox = (tcx[:, None] - pcx[None, :]) / pw[None, :] / pvar[None, :, 0]
        oy = (tcy[:, None] - pcy[None, :]) / ph[None, :] / pvar[None, :, 1]
        ow = torch.log(torch.abs(tw[:, None] / pw[None, :])) / \
            pvar[None, :, 2]
        oh = torch.log(torch.abs(th[:, None] / ph[None, :])) / \
            pvar[None, :, 3]
        out = torch.stack([ox, oy, ow, oh], dim=-1)
    elif code_type == "decode_center_size":
        tcx = pvar[None, :, 0] * target[..., 0] * pw[None, :] + pcx[None, :]
        tcy = pvar[None, :, 1] * target[..., 1] * ph[None, :] + pcy[None, :]
        tw = torch.exp(pvar[None, :, 2] * target[..., 2]) * pw[None, :]
        th = torch.exp(pvar[None, :, 3] * target[..., 3]) * ph[None, :]
        out = torch.stack([tcx - tw / 2, tcy - th / 2,
                           tcx + tw / 2, tcy + th / 2], dim=-1)
    else:
        raise ValueError(f"box_coder: unknown code_type {code_type!r}")
    ctx.set_output("OutputBox", out)
    lod = ctx.input_lod("TargetBox")
    if lod is not None:
        ctx.set_output_lod("OutputBox", lod)


# ---------------------------------------------------------------------------
# prior_box
# ---------------------------------------------------------------------------

def _expand_aspect_ratios(aspect_ratios, flip):
    """Reference ``ExpandAspectRatios`` (``prior_box_op.h:23``)."""
    out = [1.0]
    for ar in aspect_ratios:
        if any(abs(ar - o) < 1e-6 for o in out):
            continue
        out.append(float(ar))
        if flip:
            out.append(1.0 / float(ar))
    return out


def _infer_prior_box(op, block):
    inp = block.var(op.input("Input")[0])
    if inp.shape is None:
        raise ShapeInferenceSkip()
    min_sizes = op.attr("min_sizes", [])
    max_sizes = op.attr("max_sizes", []) or []
    ars = _expand_aspect_ratios(op.attr("aspect_ratios", []),
                                op.attr("flip", False))
    num_priors = len(ars) * len(min_sizes) + len(max_sizes)
    h, w = inp.shape[2], inp.shape[3]
    for slot in ("Boxes", "Variances"):
        v = block.var(op.output(slot)[0])
        v.shape = (h, w, num_priors, 4)
        v.dtype = "float32"


def _prior_boxes(attr, fh, fw, ih, iw):
    """The ``[fh, fw, num_priors, 4]`` boxes and variances of a
    ``prior_box`` op with attrs ``attr(name, default)`` over a ``fh x
    fw`` map of an ``ih x iw`` image, in numpy (the priors of each
    min size in the reference's order: every aspect ratio, then the
    square of ``sqrt(min * max)``)."""
    min_sizes = [float(s) for s in attr("min_sizes", [])]
    max_sizes = [float(s) for s in (attr("max_sizes", []) or [])]
    ars = _expand_aspect_ratios(attr("aspect_ratios", []),
                                attr("flip", False))
    variances = [float(v) for v in attr("variances", [0.1, 0.1, 0.2, 0.2])]
    step_w = float(attr("step_w", 0.0) or 0.0)
    step_h = float(attr("step_h", 0.0) or 0.0)
    offset = float(attr("offset", 0.5))
    sw = step_w if step_w > 0 else iw / fw
    sh = step_h if step_h > 0 else ih / fh
    half_w, half_h = [], []
    for s, ms in enumerate(min_sizes):
        for ar in ars:
            half_w.append(ms * math.sqrt(ar) / 2.0)
            half_h.append(ms / math.sqrt(ar) / 2.0)
        if max_sizes:
            sq = math.sqrt(ms * max_sizes[s]) / 2.0
            half_w.append(sq)
            half_h.append(sq)
    hw = np.asarray(half_w, np.float32)[None, None, :]
    hh = np.asarray(half_h, np.float32)[None, None, :]
    cx = ((np.arange(fw, dtype=np.float32) + offset) * sw)[None, :, None]
    cy = ((np.arange(fh, dtype=np.float32) + offset) * sh)[:, None, None]
    boxes = np.stack(
        np.broadcast_arrays((cx - hw) / iw, (cy - hh) / ih,
                            (cx + hw) / iw, (cy + hh) / ih),
        axis=-1).astype(np.float32)
    if attr("clip", False):
        boxes = np.clip(boxes, 0.0, 1.0)
    vars_ = np.broadcast_to(np.asarray(variances, np.float32),
                            (fh, fw, len(half_w), 4)).copy()
    return boxes, vars_


@register_op("prior_box", infer_shape=_infer_prior_box, no_gradient=True)
def prior_box_lower(ctx):
    """A constant of the shapes and attrs: made on the device once per
    prepared step (reference ``prior_box_op.h:56`` loops over the pixels
    every run)."""
    inp, img = ctx.input("Input"), ctx.input("Image")
    shapes = (inp.shape[2], inp.shape[3], img.shape[2], img.shape[3])
    for slot, i in (("Boxes", 0), ("Variances", 1)):
        ctx.set_output(slot, _constant(
            ctx, ("prior_box", slot) + shapes,
            lambda: _prior_boxes(ctx.attr, *shapes)[i], "float32"))


# ---------------------------------------------------------------------------
# bipartite_match
# ---------------------------------------------------------------------------

def _infer_bipartite(op, block):
    d = block.var(op.input("DistMat")[0])
    if d.shape is None:
        raise ShapeInferenceSkip()
    for slot, dt in (("ColToRowMatchIndices", "int32"),
                     ("ColToRowMatchDist", d.dtype)):
        v = block.var(op.output(slot)[0])
        v.shape = (-1, d.shape[1])
        v.dtype = dt


def _segments(lod, rows):
    """``[(lo, hi)]`` of each LoD instance (one instance without a
    LoD)."""
    if lod is None:
        return [(0, rows)]
    splits = lod[-1]
    return [(int(splits[i]), int(splits[i + 1]))
            for i in range(len(splits) - 1)]


def _padded_rows(segments, device):
    """``[N, G]`` int64: instance ``i``'s ``g``-th row, -1 past its end
    (``G`` its largest row count): a table from the host LoD."""
    g = max(hi - lo for lo, hi in segments)
    idx = np.full((len(segments), g), -1, np.int64)
    for i, (lo, hi) in enumerate(segments):
        idx[i, :hi - lo] = np.arange(lo, hi)
    return torch.as_tensor(idx, device=device)


def bipartite_match_padded(dist, rows, match_type, threshold):
    """Greedy max matching of every instance at once (reference
    ``BipartiteMatchKernel::BipartiteMatch`` and ``ArgMaxMatch``):
    ``dist`` ``[R, P]``, ``rows`` ``[N, G]`` (:func:`_padded_rows`).
    Each trip matches, in every instance, the row-major first maximum
    of the distances of its unused rows and unmatched columns that are
    at least ``1e-6``; ``min(G, P)`` trips leave every instance where
    its own ``min(rows, P)`` trips leave it.  Returns ``[N, P]`` int32
    match indices and ``[N, P]`` distances."""
    n, g = rows.shape
    p = dist.shape[1]
    real = rows >= 0
    d = dist[rows.clamp(min=0)]                          # [N, G, P]
    valid = real[:, :, None] & (d >= _KEPS)
    match_idx = torch.full((n, p), -1, dtype=torch.int64,
                           device=dist.device)
    match_dist = torch.zeros((n, p), dtype=dist.dtype, device=dist.device)
    row_used = torch.zeros((n, g), dtype=torch.bool, device=dist.device)
    minus_one = torch.full((), -1.0, dtype=dist.dtype, device=dist.device)
    for _ in range(min(g, p)):
        eligible = valid & ~row_used[:, :, None] & \
            (match_idx == -1)[:, None, :]
        masked = torch.where(eligible, d, minus_one).reshape(n, g * p)
        flat = masked.argmax(dim=1, keepdim=True)        # first maximum
        best = masked.gather(1, flat)
        ok = best >= _KEPS
        r, c = flat // p, flat % p
        match_idx.scatter_(1, c, torch.where(ok, r,
                                             match_idx.gather(1, c)))
        match_dist.scatter_(1, c, torch.where(ok, best,
                                              match_dist.gather(1, c)))
        row_used.scatter_(1, r, ok | row_used.gather(1, r))
    if match_type == "per_prediction":
        neg_inf = torch.full((), float("-inf"), dtype=dist.dtype,
                             device=dist.device)
        rowwise = torch.where(real[:, :, None], d, neg_inf)
        col_best, col_arg = rowwise.amax(dim=1), rowwise.argmax(dim=1)
        cond = (match_idx == -1) & (col_best >= threshold) & \
            (col_best >= _KEPS)
        match_idx = torch.where(cond, col_arg, match_idx)
        match_dist = torch.where(cond, col_best, match_dist)
    return match_idx.to(torch.int32), match_dist


@register_op("bipartite_match", infer_shape=_infer_bipartite,
             no_gradient=True, eager_only=True)
def bipartite_match_lower(ctx):
    dist = ctx.input("DistMat")
    segments = _segments(ctx.input_lod("DistMat"), dist.shape[0])
    threshold = ctx.attr("dist_threshold")
    idx, dst = bipartite_match_padded(
        dist, _padded_rows(segments, dist.device),
        ctx.attr("match_type") or "bipartite",
        0.5 if threshold is None else float(threshold))
    ctx.set_output("ColToRowMatchIndices", idx)
    ctx.set_output("ColToRowMatchDist", dst)


# ---------------------------------------------------------------------------
# target_assign
# ---------------------------------------------------------------------------

def _infer_target_assign(op, block):
    x = block.var(op.input("X")[0])
    mi = block.var(op.input("MatchIndices")[0])
    if x.shape is None or mi.shape is None:
        raise ShapeInferenceSkip()
    out = block.var(op.output("Out")[0])
    out.shape = (mi.shape[0], mi.shape[1], x.shape[-1])
    out.dtype = x.dtype
    ow = block.var(op.output("OutWeight")[0])
    ow.shape = (mi.shape[0], mi.shape[1], 1)
    ow.dtype = "float32"


@register_op("target_assign", infer_shape=_infer_target_assign,
             no_gradient=True, eager_only=True)
def target_assign_lower(ctx):
    """``Out[i, j] = X[lod[i] + match[i, j], j % P]`` where matched, else
    ``mismatch_value``; ``OutWeight`` 1 where matched.  A negative of
    ``NegIndices`` takes ``mismatch_value`` with weight 1 (reference
    ``target_assign_op.h``)."""
    x = ctx.input("X")
    match = ctx.input("MatchIndices")
    mismatch = ctx.attr("mismatch_value", 0)
    mismatch = 0 if mismatch is None else mismatch
    lod = ctx.input_lod("X")
    n, pm = match.shape
    if x.ndim == 2:
        x = x[:, None, :]
    p_x = x.shape[1]
    dev = x.device
    if lod is None:
        if n != 1:
            # reference target_assign_op.h enforces a LoD on X: without
            # it the instances' row offsets are unknowable
            raise ValueError(
                "target_assign: X must carry LoD when MatchIndices has "
                f"{n} > 1 instances")
        starts = [0]
    else:
        starts = [int(s) for s in lod[-1][:-1]]
    if len(starts) < n:
        raise ValueError(f"target_assign: X's LoD has {len(starts)} "
                         f"instances for {n} rows of MatchIndices")
    start = torch.as_tensor(starts[:n], dtype=torch.int64, device=dev)
    rows = start[:, None] + match.long().clamp(min=0)    # [N, Pm]
    col = torch.arange(pm, device=dev) % p_x
    matched = (match >= 0)[:, :, None]
    fill = torch.full((), mismatch, dtype=x.dtype, device=dev)
    out = torch.where(matched, x[rows, col[None, :]], fill)
    w = matched.to(torch.float32)
    neg = ctx.input("NegIndices")
    if neg is not None:
        neg_lod = ctx.input_lod("NegIndices")
        if neg.ndim == 2 and neg.shape[0] == n and neg_lod is None:
            # dense [N, P] -1-padded form from mine_hard_examples
            ids = neg.long()
            neg_mask = torch.zeros((n, pm), dtype=torch.int32, device=dev)
            neg_mask = neg_mask.scatter_reduce(
                1, ids.clamp(min=0), (ids >= 0).to(torch.int32),
                reduce="amax") > 0
        else:
            # flat [Neg, 1] with a LoD (the reference's layout)
            ids = neg.reshape(-1).long()
            splits = neg_lod[-1] if neg_lod is not None \
                else [0, ids.shape[0]]
            counts = [int(splits[i + 1]) - int(splits[i]) for i in range(n)]
            owner = torch.as_tensor(np.repeat(np.arange(n), counts),
                                    device=dev)
            neg_mask = torch.zeros((n, pm), dtype=torch.bool, device=dev)
            neg_mask[owner, ids[int(splits[0]):int(splits[n])]] = True
        out = torch.where(neg_mask[:, :, None], fill, out)
        w = torch.where(neg_mask[:, :, None], torch.ones_like(w), w)
    ctx.set_output("Out", out)
    ctx.set_output("OutWeight", w)


# ---------------------------------------------------------------------------
# mine_hard_examples
# ---------------------------------------------------------------------------

def _infer_mine(op, block):
    mi = block.var(op.input("MatchIndices")[0])
    if mi.shape is None:
        raise ShapeInferenceSkip()
    for slot in ("NegIndices", "UpdatedMatchIndices"):
        names = op.output(slot)
        if names:
            v = block.var(names[0])
            v.shape = tuple(mi.shape)
            v.dtype = "int32"


@register_op("mine_hard_examples", infer_shape=_infer_mine, no_gradient=True)
def mine_hard_examples_lower(ctx):
    """Reference ``mine_hard_examples_op.cc``: ``NegIndices`` dense ``[N,
    P]``, -1 padded, by descending loss (a stable sort: a tie keeps the
    lower prior first, as ``jnp.argsort``)."""
    cls_loss = ctx.input("ClsLoss")
    loc_loss = ctx.input("LocLoss")
    match = ctx.input("MatchIndices")
    match_dist = ctx.input("MatchDist")
    neg_pos_ratio = float(ctx.attr("neg_pos_ratio", 3.0))
    neg_dist_threshold = float(ctx.attr("neg_dist_threshold", 0.5))
    mining_type = ctx.attr("mining_type", "max_negative")
    sample_size = ctx.attr("sample_size") or 0
    n, p = match.shape
    if mining_type == "hard_example":
        if sample_size <= 0:
            raise ValueError(
                "mine_hard_examples: sample_size must be > 0 in "
                "hard_example mode")
        eligible = torch.ones_like(match, dtype=torch.bool)
        loss = cls_loss + loc_loss if loc_loss is not None else cls_loss
    else:  # max_negative
        eligible = (match == -1) & (match_dist < neg_dist_threshold)
        loss = cls_loss
    masked = torch.where(eligible, loss,
                         torch.full((), float("-inf"), dtype=loss.dtype,
                                    device=loss.device))
    order = torch.sort(-masked, dim=1, stable=True).indices   # [N, P]
    num_elig = eligible.sum(dim=1)
    if mining_type == "hard_example":
        neg_sel = num_elig.clamp(max=int(sample_size))
    else:
        num_pos = (match != -1).sum(dim=1)
        neg_sel = torch.minimum(
            (num_pos.to(torch.float32) * neg_pos_ratio).to(torch.int64),
            num_elig)
    selected = torch.arange(p, device=match.device)[None, :] < \
        neg_sel[:, None]
    minus_one = torch.full((), -1, dtype=torch.int64, device=match.device)
    if mining_type == "hard_example":
        # selected and matched priors stay positive (not negatives);
        # unselected positives drop to -1
        neg_sel_mask = selected & (match.gather(1, order) == -1)
        neg_indices = torch.where(neg_sel_mask, order, minus_one)
        sel_mask = torch.zeros((n, p), dtype=torch.bool,
                               device=match.device).scatter(1, order,
                                                             selected)
        updated = torch.where((match > -1) & ~sel_mask,
                              minus_one.to(match.dtype), match)
    else:
        neg_indices = torch.where(selected, order, minus_one)
        updated = match
    ctx.set_output("NegIndices", neg_indices.to(torch.int32))
    ctx.set_output("UpdatedMatchIndices", updated)


# ---------------------------------------------------------------------------
# multiclass_nms (host op: its rows depend on the data, like the
# reference's CPU-only kernel)
# ---------------------------------------------------------------------------

def _jaccard(a, b):
    iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = iw * ih
    union = ((a[2] - a[0]) * (a[3] - a[1])
             + (b[2] - b[0]) * (b[3] - b[1]) - inter)
    return inter / union if union > 0 else 0.0


def _jaccard_row(boxes, i, others):
    """``_jaccard(boxes[i], boxes[j])`` for every ``j`` of ``others``, in
    the same float32 operations."""
    a, b = boxes[i], boxes[others]
    iw = np.minimum(a[2], b[:, 2]) - np.maximum(a[0], b[:, 0])
    ih = np.minimum(a[3], b[:, 3]) - np.maximum(a[1], b[:, 1])
    inter = np.where(iw > 0, iw, 0) * np.where(ih > 0, ih, 0)
    union = ((a[2] - a[0]) * (a[3] - a[1])
             + (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]) - inter)
    ok = union > 0
    return np.where(ok, inter / np.where(ok, union, 1), 0)


def _nms_one_class(boxes, scores, score_threshold, nms_top_k, nms_threshold,
                   nms_eta):
    """Greedy NMS of one class: the kept indices into ``boxes``, by
    descending score (stable).  A candidate is kept when its IoU with
    every box kept before it is at most the threshold, which shrinks by
    ``nms_eta`` after each keep while above 0.5: each candidate carries
    its largest IoU with a kept box (NaN where one was NaN), updated
    once a keep."""
    idx = np.where(scores > score_threshold)[0]
    idx = idx[np.argsort(-scores[idx], kind="stable")]
    if nms_top_k > -1 and len(idx) > nms_top_k:
        idx = idx[:nms_top_k]
    kept = []
    largest = np.full(len(idx), -np.inf, np.float32)
    adaptive_threshold = nms_threshold
    for k, i in enumerate(idx):
        if not largest[k] <= adaptive_threshold:
            continue
        kept.append(int(i))
        largest[k + 1:] = np.maximum(largest[k + 1:],
                                     _jaccard_row(boxes, i, idx[k + 1:]))
        if nms_eta < 1.0 and adaptive_threshold > 0.5:
            adaptive_threshold *= nms_eta
    return kept


@register_op("multiclass_nms", no_gradient=True, host=True)
def multiclass_nms_lower(ctx):
    """Reference ``multiclass_nms_op.cc``: ``[No, 6]`` rows ``[label,
    score, xmin, ymin, xmax, ymax]`` with an image LoD; ``[[-1]]`` and an
    all-zero LoD when no box is kept."""
    bboxes = _host(ctx.input("BBoxes"))     # [N, M, 4]
    scores = _host(ctx.input("Scores"))     # [N, C, M]
    background = ctx.attr("background_label", 0)
    score_threshold = float(ctx.attr("score_threshold", 0.01))
    nms_top_k = int(ctx.attr("nms_top_k", 400))
    keep_top_k = int(ctx.attr("keep_top_k", 200))
    nms_threshold = float(ctx.attr("nms_threshold", 0.3))
    nms_eta = float(ctx.attr("nms_eta", 1.0))
    n, c, _ = scores.shape
    all_rows, lod = [], [0]
    for i in range(n):
        dets = []  # (label, score, box)
        for cls in range(c):
            if cls == background:
                continue
            kept = _nms_one_class(bboxes[i], scores[i, cls], score_threshold,
                                  nms_top_k, nms_threshold, nms_eta)
            dets.extend((cls, float(scores[i, cls, k]), bboxes[i, k])
                        for k in kept)
        if keep_top_k > -1 and len(dets) > keep_top_k:
            dets.sort(key=lambda d: -d[1])
            dets = dets[:keep_top_k]
        for label, score, box in dets:
            all_rows.append([float(label), score] + [float(v) for v in box])
        lod.append(len(all_rows))
    if not all_rows:
        out = np.full((1, 1), -1.0, np.float32)
        lod = [0] * (n + 1)
    else:
        out = np.asarray(all_rows, np.float32)
    ctx.set_output("Out", torch.as_tensor(out, device=ctx.device))
    ctx.set_output_lod("Out", [lod])


# ---------------------------------------------------------------------------
# roi_pool
# ---------------------------------------------------------------------------

def _infer_roi_pool(op, block):
    x = block.var(op.input("X")[0])
    rois = block.var(op.input("ROIs")[0])
    if x.shape is None or rois.shape is None:
        raise ShapeInferenceSkip()
    out = block.var(op.output("Out")[0])
    out.shape = (rois.shape[0], x.shape[1], op.attr("pooled_height", 1),
                 op.attr("pooled_width", 1))
    out.dtype = x.dtype
    names = op.output("Argmax")
    if names:
        a = block.var(names[0])
        a.shape = out.shape
        a.dtype = "int64"


def _bin_edges(start, end, bins, size):
    """Each bin's ``[lo, hi)`` along one axis of every ROI (``[R,
    bins]``), clipped to the plane."""
    extent = (end - start + 1).clamp(min=1).to(torch.float32)
    step = extent / bins
    i = torch.arange(bins, dtype=torch.float32, device=start.device)
    lo = torch.floor(i[None, :] * step[:, None]).to(torch.int64) + \
        start[:, None]
    hi = torch.ceil((i[None, :] + 1) * step[:, None]).to(torch.int64) + \
        start[:, None]
    return lo.clamp(0, size), hi.clamp(0, size)


@register_op("roi_pool", infer_shape=_infer_roi_pool,
             no_grad_inputs=("ROIs",), stop_gradient_outputs=("Argmax",))
def roi_pool_lower(ctx):
    """Max pooling over each ROI's ``pooled_height x pooled_width`` bins
    (reference ``roi_pool_op.h:30``): each bin a mask over the ``H x W``
    plane; ``Argmax`` the flat ``h * W + w`` of the first maximum, -1 (and
    ``Out`` 0) for an empty bin."""
    x = ctx.input("X")                       # [B, C, H, W]
    rois = ctx.input("ROIs")                 # [R, 5] (batch, x1, y1, x2, y2)
    ph = int(ctx.attr("pooled_height", 1))
    pw = int(ctx.attr("pooled_width", 1))
    scale = float(ctx.attr("spatial_scale", 1.0))
    _, c, h, w = x.shape
    r = rois.shape[0]
    corner = torch.round(rois[:, 1:5].to(torch.float32) * scale).to(
        torch.int64)
    xs, ys, xe, ye = corner.unbind(1)
    hs, he = _bin_edges(ys, ye, ph, h)       # [R, PH]
    ws, we = _bin_edges(xs, xe, pw, w)       # [R, PW]
    hh = torch.arange(h, device=x.device)
    ww = torch.arange(w, device=x.device)
    hmask = (hh >= hs[:, :, None]) & (hh < he[:, :, None])   # [R, PH, H]
    wmask = (ww >= ws[:, :, None]) & (ww < we[:, :, None])   # [R, PW, W]
    mask = hmask[:, :, None, :, None] & wmask[:, None, :, None, :]
    feat = x[rois[:, 0].to(torch.int64)]     # [R, C, H, W]
    vals = torch.where(mask[:, None], feat[:, :, None, None],
                       torch.full((), float("-inf"), dtype=x.dtype,
                                  device=x.device))
    vals = vals.reshape(r, c, ph, pw, h * w)
    out, arg = vals.amax(dim=-1), vals.argmax(dim=-1)   # first maximum
    empty = ~mask.reshape(r, 1, ph, pw, h * w).any(dim=-1)
    ctx.set_output("Out", torch.where(empty, torch.zeros_like(out), out))
    ctx.set_output("Argmax", torch.where(empty, torch.full_like(arg, -1),
                                         arg))


@register_grad_lower("roi_pool")
def roi_pool_grad_lower(ctx):
    """``Out@GRAD`` added into ``X@GRAD`` at each bin's ``Argmax`` (none
    for an empty bin)."""
    gname = ctx.op.output("X@GRAD")
    if not gname or not gname[0]:
        return
    x = ctx.input("X")
    rois = ctx.input("ROIs")
    argmax = ctx.input("Argmax")             # [R, C, PH, PW], flat or -1
    dout = ctx.input("Out@GRAD")
    b, c, h, w = x.shape
    valid = argmax >= 0
    bidx = rois[:, 0].to(torch.int64)[:, None, None, None].expand_as(argmax)
    cidx = torch.arange(c, device=x.device)[None, :, None, None].expand_as(
        argmax)
    dx = torch.zeros((b, c, h * w), dtype=x.dtype, device=x.device)
    dx.index_put_((bidx[valid], cidx[valid], argmax[valid]),
                  dout[valid].to(x.dtype), accumulate=True)
    ctx.outputs[gname[0]] = dx.reshape(b, c, h, w)


# ---------------------------------------------------------------------------
# detection_map (host op; streaming mAP accumulators)
# ---------------------------------------------------------------------------

def _average_precision(tps, fps, num_pos, ap_type):
    """tps / fps: lists of (score, count) pairs; reference ``CalcMAP``."""
    pairs_tp = sorted(tps, key=lambda p: -p[0])
    pairs_fp = sorted(fps, key=lambda p: -p[0])
    tp_sum = np.cumsum([p[1] for p in pairs_tp])
    fp_sum = np.cumsum([p[1] for p in pairs_fp])
    if len(tp_sum) == 0 or num_pos == 0:
        return None
    precision = tp_sum / np.maximum(tp_sum + fp_sum, 1e-12)
    recall = tp_sum / float(num_pos)
    if ap_type == "11point":
        max_precisions = np.zeros(11)
        start_idx = len(recall) - 1
        for j in range(10, -1, -1):
            for i in range(start_idx, -1, -1):
                if recall[i] < j / 10.0:
                    start_idx = i
                    if j > 0:
                        max_precisions[j - 1] = max_precisions[j]
                    break
                if max_precisions[j] < precision[i]:
                    max_precisions[j] = precision[i]
        return float(np.sum(max_precisions) / 11.0)
    ap = 0.0
    prev_recall = 0.0
    for p, r in zip(precision, recall):
        if abs(r - prev_recall) > 1e-6:
            ap += p * abs(r - prev_recall)
        prev_recall = r
    return float(ap)


@register_op("detection_map", no_gradient=True, host=True)
def detection_map_lower(ctx):
    """Streaming VOC mAP (reference ``detection_map_op.h``).  The state:
    ``AccumPosCount`` ``[C, 1]`` int32; ``AccumTruePos`` /
    ``AccumFalsePos`` ``[K, 2]`` float32 ``(score, flag)`` rows with a
    per-class LoD, merged into this batch's where ``HasState`` is
    nonzero."""
    detect = _host(ctx.input("DetectRes"))   # [Nd, 6]
    label = _host(ctx.input("Label"))        # [Ng, 5 or 6]
    det_lod = ctx.input_lod("DetectRes")
    label_lod = ctx.input_lod("Label")
    class_num = int(ctx.attr("class_num"))
    overlap_threshold = float(ctx.attr("overlap_threshold", 0.3))
    evaluate_difficult = bool(ctx.attr("evaluate_difficult", True))
    ap_type = ctx.attr("ap_type", "integral")
    background = ctx.attr("background_label", 0)
    if det_lod is None or label_lod is None:
        raise ValueError("detection_map requires LoD on DetectRes and Label")
    det_splits = det_lod[0]
    lab_splits = label_lod[0]
    batch = len(lab_splits) - 1

    pos_count = {}
    true_pos = {i: [] for i in range(class_num)}
    false_pos = {i: [] for i in range(class_num)}

    has_state = ctx.input("HasState")
    state_on = has_state is not None and \
        int(_host(has_state).reshape(-1)[0]) != 0
    in_pos = ctx.input("PosCount")
    if in_pos is not None and state_on:
        arr = _host(in_pos).reshape(-1)
        for i in range(min(class_num, arr.shape[0])):
            pos_count[i] = int(arr[i])
        for slot, store in (("TruePos", true_pos), ("FalsePos", false_pos)):
            t = ctx.input(slot)
            tl = ctx.input_lod(slot)
            if t is None or tl is None:
                continue
            t = _host(t)
            sp = tl[0]
            for i in range(len(sp) - 1):
                for j in range(int(sp[i]), int(sp[i + 1])):
                    store[i].append((float(t[j, 0]), int(t[j, 1])))

    for n in range(batch):
        gts = {}
        for i in range(int(lab_splits[n]), int(lab_splits[n + 1])):
            row = label[i]
            if row.shape[0] == 6:
                cls, difficult, box = int(row[0]), bool(row[1]), row[2:6]
            else:
                cls, difficult, box = int(row[0]), False, row[1:5]
            gts.setdefault(cls, []).append((box, difficult))
        for cls, boxes in gts.items():
            cnt = (len(boxes) if evaluate_difficult
                   else sum(1 for _, d in boxes if not d))
            if cnt:
                pos_count[cls] = pos_count.get(cls, 0) + cnt

        dets = {}
        for i in range(int(det_splits[n]), int(det_splits[n + 1])):
            row = detect[i]
            if row.shape[0] < 6:
                continue  # the all-empty "-1" sentinel tensor
            dets.setdefault(int(row[0]), []).append(
                (float(row[1]), row[2:6]))
        for cls, preds in dets.items():
            gt_cls = gts.get(cls)
            if not gt_cls:
                for score, _ in preds:
                    true_pos[cls].append((score, 0))
                    false_pos[cls].append((score, 1))
                continue
            visited = [False] * len(gt_cls)
            preds = sorted(preds, key=lambda p: -p[0])
            for score, box in preds:
                box = np.clip(np.asarray(box, np.float64), 0.0, 1.0)
                overlaps = [_jaccard(box, np.asarray(g, np.float64))
                            for g, _ in gt_cls]
                max_idx = int(np.argmax(overlaps)) if overlaps else 0
                max_overlap = overlaps[max_idx] if overlaps else -1.0
                if max_overlap > overlap_threshold:
                    difficult = gt_cls[max_idx][1]
                    if evaluate_difficult or not difficult:
                        if not visited[max_idx]:
                            true_pos[cls].append((score, 1))
                            false_pos[cls].append((score, 0))
                            visited[max_idx] = True
                        else:
                            true_pos[cls].append((score, 0))
                            false_pos[cls].append((score, 1))
                else:
                    true_pos[cls].append((score, 0))
                    false_pos[cls].append((score, 1))

    aps = []
    for cls, num_pos in pos_count.items():
        if cls == background or num_pos == 0 or not true_pos.get(cls):
            continue
        ap = _average_precision(true_pos[cls], false_pos[cls], num_pos,
                                ap_type)
        if ap is not None:
            aps.append(ap)
    m_ap = float(np.mean(aps)) if aps else 0.0
    dev = ctx.device
    ctx.set_output("MAP", torch.tensor([m_ap], dtype=torch.float32,
                                       device=dev))
    pc = np.zeros((class_num, 1), np.int32)
    for cls, cnt in pos_count.items():
        if 0 <= cls < class_num:
            pc[cls, 0] = cnt
    ctx.set_output("AccumPosCount", torch.as_tensor(pc, device=dev))
    for slot, store in (("AccumTruePos", true_pos),
                        ("AccumFalsePos", false_pos)):
        rows, starts = [], [0]
        for i in range(class_num):
            rows.extend(store.get(i, []))
            starts.append(len(rows))
        arr = (np.asarray(rows, np.float32) if rows
               else np.zeros((0, 2), np.float32))
        ctx.set_output(slot, torch.as_tensor(arr, device=dev))
        ctx.set_output_lod(slot, [starts])


# ---------------------------------------------------------------------------
# scale_sub_region (reference gserver/layers/ScaleSubRegionLayer.cpp:1,
# function/ScaleSubRegionOp.cpp:22 — legacy v2 only)
# ---------------------------------------------------------------------------

def _infer_scale_sub_region(op, block):
    x = block.var(op.input("X")[0])
    out = block.var(op.output("Out")[0])
    out.shape = x.shape
    out.dtype = x.dtype


@register_op("scale_sub_region", infer_shape=_infer_scale_sub_region,
             no_grad_inputs=("Indices",))
def scale_sub_region_lower(ctx):
    """Multiply a per-sample ``[C, H, W]`` sub-region of ``X`` by attr
    ``value``: ``Indices`` ``[N, 6]`` holds one-based ranges ``(c0, c1,
    h0, h1, w0, w1)``, inclusive at both ends.  A mask of three
    broadcast ranges; the grad (auto-vjp) is the same select of the
    cotangent."""
    x = ctx.input("X")                      # [N, C, H, W]
    idx = ctx.input("Indices").to(torch.int32)
    value = float(ctx.attr("value", 1.0))
    _, c, h, w = x.shape

    def in_range(size, lo, hi):             # [N, size]
        r = torch.arange(size, device=x.device)
        return (r[None, :] >= (lo - 1)[:, None]) & \
            (r[None, :] <= (hi - 1)[:, None])

    mask = (in_range(c, idx[:, 0], idx[:, 1])[:, :, None, None]
            & in_range(h, idx[:, 2], idx[:, 3])[:, None, :, None]
            & in_range(w, idx[:, 4], idx[:, 5])[:, None, None, :])
    ctx.set_output("Out", torch.where(mask, x * value, x))
