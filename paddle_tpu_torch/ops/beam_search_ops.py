"""Beam search ops (the port of ``paddle_tpu.ops.beam_search_ops``;
reference ``paddle/fluid/operators/beam_search_op.cc``,
``beam_search_decode_op.cc``, ``paddle/gserver/layers/
CrossEntropyOverBeam.cpp``).

As in the JAX package, beams live in a static ``[batch, beam_size]``
layout for the whole decode: ``beam_search`` keeps a finished beam (last
id == end_id) as one ``(end_id, pre_score)`` candidate and picks the top
K over the flattened ``beam * cand`` axis, with an explicit
``parent_idx``; ``beam_search_decode`` follows the parent pointers back
through the step arrays (a Python loop over the steps).  Seed
``pre_scores`` with 0 for beam 0 and -1e9 for the others, so that K
identical first beams do not fill the top K.

``cross_entropy_over_beam`` and its grad are host ops, as in the JAX
package: they read their inputs with ``tolist()`` and compute in numpy
(see the JAX package's module for the padding contract of ``Ids``).
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.ops.control_flow_ops import TensorArray
from paddle_tpu_torch.ops.registry import ShapeInferenceSkip, register_op

NEG_INF = -1e9


def _infer_beam_search(op, block):
    pre = block.var(op.input("pre_ids")[0])
    if pre.shape is None:
        raise ShapeInferenceSkip()
    B, K = pre.shape[0], op.attr("beam_size")
    for slot, dtype in (("selected_ids", "int64"),
                        ("selected_scores", "float32"),
                        ("parent_idx", "int64")):
        names = op.output(slot)
        if names:
            v = block.var(names[0])
            v.shape = (B, K)
            v.dtype = dtype


@register_op("beam_search", infer_shape=_infer_beam_search,
             no_gradient=True)
def beam_search_lower(ctx):
    """One pruning step.  ``pre_ids`` / ``pre_scores`` ``[B, K]``,
    ``ids`` / ``scores`` ``[B, K, C]`` (candidate ids and ACCUMULATED
    log-probs); outputs ``selected_ids``, ``selected_scores`` and
    ``parent_idx``, each ``[B, K]``.  Equal scores keep their flat index
    order (the lowest first, as ``lax.top_k`` orders them): the first
    step and every finished beam offer exact ties at -1e9."""
    pre_ids = ctx.input("pre_ids")
    pre_scores = ctx.input("pre_scores")
    ids = ctx.input("ids")
    scores = ctx.input("scores")
    K = int(ctx.attr("beam_size"))
    end_id = int(ctx.attr("end_id"))
    B, Kb, C = scores.shape

    finished = (pre_ids == end_id)[:, :, None]               # [B, K, 1]
    cand_scores = torch.where(finished, torch.full_like(scores, NEG_INF),
                              scores)
    slot0 = torch.where(finished[:, :, 0], pre_scores.to(scores.dtype),
                        cand_scores[:, :, 0])
    cand_scores = torch.cat([slot0[:, :, None], cand_scores[:, :, 1:]], 2)
    cand_ids = torch.where(finished, torch.full_like(ids, end_id), ids)

    flat = cand_scores.reshape(B, Kb * C)
    vals, order = torch.sort(flat, dim=1, descending=True, stable=True)
    flat_idx = order[:, :K]
    ctx.set_output("selected_ids", cand_ids.reshape(B, Kb * C).gather(
        1, flat_idx).to(torch.int64))
    ctx.set_output("selected_scores", vals[:, :K].to(torch.float32))
    ctx.set_output("parent_idx", torch.div(flat_idx, C,
                                           rounding_mode="floor"))


def _infer_bs_decode(op, block):
    raise ShapeInferenceSkip()


@register_op("beam_search_decode", infer_shape=_infer_bs_decode,
             no_gradient=True)
def beam_search_decode_lower(ctx):
    """Backtrack the parent pointers of the ``Ids`` / ``ParentIdx`` step
    arrays (``T`` steps of ``[B, K]``; ``T`` = the ``max_len`` attr, else
    the arrays' length) into ``SentenceIds`` ``[B, K, T]`` and pass
    ``Scores`` ``[B, K]`` on as ``SentenceScores``.  The beams come in
    the last step's order (best first); a finished beam repeats end_id."""
    ids_arr = ctx.input("Ids")
    par_arr = ctx.input("ParentIdx")
    if not isinstance(ids_arr, TensorArray):
        raise TypeError("beam_search_decode Ids must be a TensorArray")
    T = ctx.attr("max_len", None)
    T = ids_arr.length if T is None else int(T)
    B, K = ids_arr.steps[0].shape
    ptr = torch.arange(K, device=ids_arr.steps[0].device).repeat(B, 1)
    toks = []
    for t in range(T - 1, -1, -1):
        toks.append(ids_arr.read(t).to(torch.int64).gather(1, ptr))
        ptr = par_arr.read(t).to(torch.int64).gather(1, ptr)
    ctx.set_output("SentenceIds", torch.stack(toks[::-1], -1))
    ctx.set_output("SentenceScores", ctx.input("Scores").to(torch.float32))


# ---------------------------------------------------------------------------
# cross_entropy_over_beam (reference CrossEntropyOverBeam.cpp:1-393)
# ---------------------------------------------------------------------------

def _beam_cost_one_seq(scores, row_starts, ids, golds, beam_size):
    """Cost and per-expansion score grads of ONE sequence.

    ``scores[i]``: 1-D candidate scores at expansion i; ``row_starts[i]``:
    each beam row's offset in ``scores[i]``; ``ids[i]``: ``[R_i,
    beam_size]`` (-1 padded); ``golds[i]``: the gold id."""
    E = len(scores)
    gold_rows, gold_col, valid = [], -1, 0
    for i in range(E):
        if i:
            prev_flat = ids[i - 1].reshape(-1)
            slot = gold_rows[-1] * beam_size + gold_col
            gold_rows.append(int(np.count_nonzero(prev_flat[:slot] != -1)))
        else:
            gold_rows.append(0)
        valid = i + 1
        hit = np.nonzero(ids[i][gold_rows[-1]] == golds[i])[0]
        if hit.size == 0:
            gold_col = -1
            break
        gold_col = int(hit[0])
    gold_extra = gold_col == -1
    last = valid - 1

    slots_last = np.argwhere(ids[last] != -1)       # row-major
    n_paths = len(slots_last) + (1 if gold_extra else 0)
    path_rows = np.zeros((valid, n_paths), np.int64)
    parents = [int(r) for r, _ in slots_last]
    for p, (r, c) in enumerate(slots_last):
        path_rows[last, p] = ids[last][r, c] + row_starts[last][r]
    if gold_extra:
        path_rows[last, -1] = golds[last] + \
            row_starts[last][gold_rows[last]]
        parents.append(gold_rows[last])
        gold_path = n_paths - 1
    else:
        flat = ids[last].reshape(-1)
        goff = gold_rows[last] * beam_size + gold_col
        gold_path = int(np.count_nonzero(flat[:goff] != -1))

    n_real = len(slots_last)
    for i in range(last - 1, -1, -1):
        slots_i = np.argwhere(ids[i] != -1)
        for p in range(n_real):
            r, c = slots_i[parents[p]]
            path_rows[i, p] = ids[i][r, c] + row_starts[i][r]
            parents[p] = int(r)
        if gold_extra:
            path_rows[i, -1] = golds[i] + row_starts[i][gold_rows[i]]
            parents[-1] = gold_rows[i]

    path_scores = np.zeros(n_paths, np.float64)
    for i in range(valid):
        path_scores += scores[i][path_rows[i]]
    z = path_scores - path_scores.max()
    p = np.exp(z)
    p /= p.sum()
    cost = -float(np.log(max(p[gold_path], 1e-30)))

    dp = p.copy()
    dp[gold_path] -= 1.0
    grads = [np.zeros_like(scores[i], dtype=np.float64) for i in range(E)]
    for i in range(valid):
        np.add.at(grads[i], path_rows[i], dp)
    return cost, grads


def _host(t, dtype=None):
    """A tensor's values as a numpy array, read with ``tolist()``."""
    return np.asarray(t.tolist(), dtype)


def _ceob_split(ctx):
    """Slice the batched LoD inputs into per-sequence views: ``(batch,
    beam_size, per_seq, score names)``, ``per_seq[j] = (scores,
    row_starts, ids, golds)``."""
    score_names = ctx.op.input("Scores")
    id_names = ctx.op.input("Ids")
    gold_names = ctx.op.input("Gold")
    E = len(score_names)
    if not (len(id_names) == len(gold_names) == E):
        raise ValueError("cross_entropy_over_beam wants E (Scores, Ids, "
                         "Gold) triples")
    scores = [_host(ctx.env[n], np.float64).reshape(-1) for n in score_names]
    ids = [_host(ctx.env[n], np.int64) for n in id_names]
    golds = [_host(ctx.env[n], np.int64).reshape(-1) for n in gold_names]
    beam_size = ids[0].shape[1]

    lods = [ctx.var_lod(n) for n in score_names]
    if lods[0] is None:
        raise ValueError("cross_entropy_over_beam: Scores[0] needs a "
                         "1-level LoD (one segment per sequence)")
    starts0 = np.asarray(lods[0][-1] if len(lods[0]) == 1 else lods[0][0])
    batch = len(starts0) - 1

    per_seq = []
    for j in range(batch):
        seq_scores, seq_starts, seq_ids, seq_golds = [], [], [], []
        for i in range(E):
            if i == 0:
                lo, hi = int(starts0[j]), int(starts0[j + 1])
                seq_scores.append(scores[0][lo:hi])
                seq_starts.append(np.zeros(1, np.int64))
                seq_ids.append(ids[0][j:j + 1])
            else:
                lod = lods[i]
                if lod is None or len(lod) < 2:
                    raise ValueError(
                        f"cross_entropy_over_beam: Scores[{i}] must be a "
                        f"2-level nested sequence")
                outer = np.asarray(lod[0])
                inner = np.asarray(lod[1])
                sub_lo, sub_hi = int(outer[j]), int(outer[j + 1])
                row_lo = int(inner[sub_lo])
                seq_scores.append(scores[i][row_lo:int(inner[sub_hi])])
                seq_starts.append(
                    np.asarray(inner[sub_lo:sub_hi], np.int64) - row_lo)
                seq_ids.append(ids[i][sub_lo:sub_hi])
            seq_golds.append(int(golds[i][j]))
        per_seq.append((seq_scores, seq_starts, seq_ids, seq_golds))
    return batch, beam_size, per_seq, score_names


def _ceob_grad_maker(op, block, no_grad_set):
    from paddle_tpu_torch.framework import grad_var_name
    score_names = op.input("Scores")
    g_scores = [grad_var_name(n) for n in score_names]
    desc = {"type": "cross_entropy_over_beam_grad",
            "inputs": {"Scores": list(score_names),
                       "Ids": list(op.input("Ids")),
                       "Gold": list(op.input("Gold")),
                       "Out@GRAD": [grad_var_name(op.output("Out")[0])]},
            "outputs": {"Scores@GRAD": g_scores},
            "attrs": dict(op.attrs)}
    return [desc], dict(zip(score_names, g_scores))


@register_op("cross_entropy_over_beam", host=True,
             grad_maker=_ceob_grad_maker)
def cross_entropy_over_beam_lower(ctx):
    batch, beam_size, per_seq, _ = _ceob_split(ctx)
    costs = np.zeros((batch, 1), np.float32)
    for j, (s, st, i_, g) in enumerate(per_seq):
        costs[j, 0], _ = _beam_cost_one_seq(s, st, i_, g, beam_size)
    ctx.set_output("Out", torch.as_tensor(costs, device=ctx.device))


@register_op("cross_entropy_over_beam_grad", no_gradient=True, host=True)
def cross_entropy_over_beam_grad_lower(ctx):
    batch, beam_size, per_seq, score_names = _ceob_split(ctx)
    g_out = _host(ctx.env[ctx.op.input("Out@GRAD")[0]],
                  np.float64).reshape(-1)
    full = [np.zeros(ctx.env[n].numel(), np.float64) for n in score_names]
    offs = [0] * len(score_names)
    for j, (s, st, i_, g) in enumerate(per_seq):
        _, grads = _beam_cost_one_seq(s, st, i_, g, beam_size)
        for i, gr in enumerate(grads):
            full[i][offs[i]:offs[i] + len(gr)] += gr * g_out[j]
            offs[i] += len(gr)
    for name, gname, arr in zip(score_names, ctx.op.output("Scores@GRAD"),
                                full):
        ctx.outputs[gname] = torch.as_tensor(
            arr.reshape(tuple(ctx.env[name].shape)).astype(np.float32),
            device=ctx.device)
