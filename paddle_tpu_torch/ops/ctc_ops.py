"""CTC and edit-distance ops (the port of ``paddle_tpu.ops.ctc_ops``;
reference ``operators/warpctc_op.cc``, which wraps the warp-ctc library,
``ctc_align_op.cc`` and ``edit_distance_op.cc``).

``warpctc`` is the alpha recursion over each sequence's label lattice
(blanks between and around the labels), batched: the logits are
gathered time-major by the LoD's pad table, the lattices padded to the
longest, and a Python loop runs the longest sequence's steps on the
device, a finished sequence keeping its alphas.  Its grad is the
auto-vjp of the lowering, as the JAX package's is ``jax.vjp`` of its
scan.  ``ctc_align`` and ``edit_distance`` are host ops (their output
sizes depend on the data), as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.lod import is_dyn, pad_tables
from paddle_tpu_torch.ops.metric_ops import host_values
from paddle_tpu_torch.ops.registry import ShapeInferenceSkip, register_op
from paddle_tpu_torch.ops.rnn_ops import _to_padded
from paddle_tpu_torch.ops.sequence_ops import _require_lod

#: the log of an impossible lattice state
NEG = -1e30


def _infer_skip(op, block):
    raise ShapeInferenceSkip()


def _static(ctx, slot):
    lod = _require_lod(ctx, slot)
    if is_dyn(lod):
        raise NotImplementedError(
            f"{ctx.op.type}: a bucketed LoD (DynLoD) input is not "
            f"supported; feed a static LoD")
    return lod


def ctc_losses(logits, logit_lod, labels, label_lod, blank=0):
    """The CTC negative log-likelihood of each sequence, ``[B]``:
    ``logits`` ``[N_t, C]`` unnormalised (a log-softmax is taken here),
    ``labels`` ``[N_l]`` without blanks, each ragged by its LoD."""
    device = logits.device
    pad = pad_tables({}, logit_lod, device)
    log_probs = torch.log_softmax(
        _to_padded(logits, pad), dim=-1)                     # [T, B, C]
    T, B = pad.T, pad.B
    label_splits = np.asarray(label_lod[-1], np.int64)
    label_lens = np.diff(label_splits)
    L = int(label_lens.max()) if B else 0
    S = 2 * L + 1
    # the extended label sequences [blank, l1, blank, l2, ..., blank],
    # padded right with blanks (a state only reads states to its left)
    rows = label_splits[:-1, None] + np.arange(L)[None, :]
    live = np.arange(L)[None, :] < label_lens[:, None]
    flat = labels.reshape(-1).long()
    if flat.numel():
        gathered = flat.index_select(0, torch.as_tensor(
            np.where(live, rows, 0).reshape(-1), device=device))
    else:
        gathered = flat.new_full((B * L,), blank)
    live_t = torch.as_tensor(live, device=device)
    ext = torch.stack([torch.full((B, L), blank, dtype=torch.long,
                                  device=device),
                       torch.where(live_t, gathered.reshape(B, L),
                                   blank)], dim=2).reshape(B, 2 * L)
    ext = torch.cat([ext, ext.new_full((B, 1), blank)], dim=1)   # [B, S]
    same = torch.cat([torch.ones((B, min(S, 2)), dtype=torch.bool,
                                 device=device),
                      ext[:, 2:] == ext[:, :-2]], dim=1)
    neg = torch.full((B, 1), NEG, dtype=log_probs.dtype, device=device)
    # the blank state starts, and the first label's where there is one
    state = torch.arange(S, device=device).unsqueeze(0)
    starts = (state == 0) | ((state == 1) & torch.as_tensor(
        label_lens > 0, device=device).unsqueeze(1))
    first = log_probs[0].gather(1, ext)                      # [B, S]
    alpha = torch.where(starts, first, torch.full_like(first, NEG))
    lengths = torch.as_tensor(pad.lens, device=device).unsqueeze(1)
    for t in range(1, T):
        shift1 = torch.cat([neg, alpha[:, :-1]], dim=1)
        shift2 = torch.cat([neg, neg, alpha[:, :-2]], dim=1)[:, :S]
        shift2 = torch.where(same, torch.full_like(shift2, NEG), shift2)
        merged = torch.logaddexp(torch.logaddexp(alpha, shift1), shift2)
        new = merged + log_probs[t].gather(1, ext)
        alpha = torch.where(t < lengths, new, alpha)
    ends = torch.as_tensor(2 * label_lens, device=device)    # S_b - 1
    last = alpha.gather(1, ends.unsqueeze(1)).squeeze(1)
    before = alpha.gather(1, (ends - 1).clamp(min=0).unsqueeze(1)).squeeze(1)
    before = torch.where(ends > 0, before, torch.full_like(before, NEG))
    return -torch.logaddexp(last, before)


@register_op("warpctc", infer_shape=_infer_skip, no_grad_inputs=("Label",),
             eager_only=True)
def warpctc_lower(ctx):
    """``Loss`` ``[B, 1]``: each sequence's CTC loss of its ``Label``
    under its ``Logits``; ``norm_by_times`` divides it by the sequence's
    length (the loss itself, as the JAX package does, not only the
    grad)."""
    logit_lod = _static(ctx, "Logits")
    loss = ctc_losses(ctx.input("Logits"), logit_lod, ctx.input("Label"),
                      _static(ctx, "Label"), int(ctx.attr("blank", 0)))
    if ctx.attr("norm_by_times", False):
        lens = np.diff(np.asarray(logit_lod[-1], np.int64))
        loss = loss / torch.as_tensor(lens, dtype=loss.dtype,
                                      device=loss.device)
    ctx.set_output("Loss", loss.unsqueeze(1))


@register_op("ctc_align", infer_shape=_infer_skip, no_gradient=True,
             host=True)
def ctc_align_lower(ctx):
    """Greedy CTC decode of the ids ``Input`` ``[N, 1]``: repeats merged,
    then blanks dropped, a sequence at a time; the output's LoD holds the
    new lengths."""
    blank = ctx.attr("blank", 0)
    splits = _static(ctx, "Input")[0]
    vals = host_values(ctx.input("Input"))
    out, new_splits = [], [0]
    for lo, hi in zip(splits[:-1], splits[1:]):
        seq = vals[int(lo):int(hi)]
        out.extend(int(v) for i, v in enumerate(seq)
                   if (i == 0 or v != seq[i - 1]) and int(v) != blank)
        new_splits.append(len(out))
    ctx.set_output("Output", torch.tensor(out, dtype=torch.int64,
                                          device=ctx.device).reshape(-1, 1))
    ctx.set_output_lod("Output", [new_splits])


def levenshtein(a, b):
    """The edit distance of two sequences (insert, delete, substitute)."""
    dp = np.arange(len(b) + 1, dtype=np.float32)
    for i in range(1, len(a) + 1):
        prev = dp.copy()
        dp[0] = i
        for j in range(1, len(b) + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            dp[j] = min(prev[j] + 1, dp[j - 1] + 1, prev[j - 1] + cost)
    return float(dp[len(b)])


@register_op("edit_distance", infer_shape=_infer_skip, no_gradient=True,
             host=True)
def edit_distance_lower(ctx):
    """``Out`` ``[B, 1]`` float32: each ``Hyps`` sequence's edit distance
    to its ``Refs`` sequence (over the reference's length with
    ``normalized``, where it is not empty), and ``SequenceNum``."""
    hs = _static(ctx, "Hyps")[0]
    rs = _static(ctx, "Refs")[0]
    hv, rv = host_values(ctx.input("Hyps")), host_values(ctx.input("Refs"))
    dists = []
    for b in range(len(hs) - 1):
        ref = list(rv[rs[b]:rs[b + 1]])
        d = levenshtein(list(hv[hs[b]:hs[b + 1]]), ref)
        if ctx.attr("normalized", False) and ref:
            d /= len(ref)
        dists.append(d)
    ctx.set_output("Out", torch.tensor(dists, dtype=torch.float32,
                                       device=ctx.device).reshape(-1, 1))
    ctx.set_output("SequenceNum", torch.tensor(
        [len(dists)], dtype=torch.int64, device=ctx.device))
