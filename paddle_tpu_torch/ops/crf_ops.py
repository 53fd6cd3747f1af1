"""Linear-chain CRF ops (the port of ``paddle_tpu.ops.crf_ops``;
reference ``operators/linear_chain_crf_op.cc``, ``crf_decoding_op.cc``:
the label_semantic_roles workload).

The ragged emissions ``[N, K]`` are gathered into time-major ``[T, B,
K]`` by the LoD's pad table (``lod.pad_tables``, zero rows past each
sequence's end), and the forward recursion (``linear_chain_crf``) or the
Viterbi recursion (``crf_decoding``) runs as a Python loop of ``T - 1``
steps on the device, a finished sequence keeping its state (a ``where``
on the step's live mask, as the JAX package's ``lax.scan`` masks its
carry, so padded steps pass no grad).  ``linear_chain_crf``'s grad is
the auto-vjp of the lowering, as the JAX package's is ``jax.vjp`` of its
scan.  ``Transition`` is ``[K + 2, K]``: row 0 the start weights, row 1
the stop weights, rows 2.. ``transition[from, to]``.

Both ops read their pad tables from the host LoD (``eager_only``); the
JAX package has no bucketed-LoD branch for them, and neither has the
port (a ``DynLoD`` input raises).
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.lod import is_dyn, pad_tables
from paddle_tpu_torch.ops.registry import ShapeInferenceSkip, register_op
from paddle_tpu_torch.ops.rnn_ops import _to_flat, _to_padded
from paddle_tpu_torch.ops.sequence_ops import _require_lod


def _infer_skip(op, block):
    raise ShapeInferenceSkip()


def _padded(ctx, x, lod):
    """``(x as [T, B, ...], lengths [B] on the device, pad tables)``."""
    if is_dyn(lod):
        raise NotImplementedError(
            f"{ctx.op.type}: a bucketed LoD (DynLoD) input is not "
            f"supported; feed a static LoD")
    pad = pad_tables(ctx.aux, lod, x.device)
    lengths = torch.as_tensor(pad.lens, device=x.device)
    return _to_padded(x, pad), lengths, pad


def crf_log_alphas(emission, transition, lengths):
    """``(log Z [B], the log forward variables: a list of T [B, K])`` of
    the padded ``emission`` ``[T, B, K]``."""
    start, stop, trans = transition[0], transition[1], transition[2:]
    alpha = start.unsqueeze(0) + emission[0]                 # [B, K]
    alphas = [alpha]
    for t in range(1, emission.shape[0]):
        new = torch.logsumexp(alpha.unsqueeze(2) + trans.unsqueeze(0),
                              dim=1) + emission[t]
        alpha = torch.where((t < lengths).unsqueeze(1), new, alpha)
        alphas.append(alpha)
    return torch.logsumexp(alpha + stop.unsqueeze(0), dim=1), alphas


def crf_gold_score(emission, transition, labels, lengths):
    """The score of each sequence's labelled path (``labels`` ``[T, B]``
    padded with 0)."""
    start, stop, trans = transition[0], transition[1], transition[2:]
    T, B = labels.shape
    valid = torch.arange(T, device=labels.device).unsqueeze(1) < \
        lengths.unsqueeze(0)                                  # [T, B]
    zero = torch.zeros((), dtype=emission.dtype, device=emission.device)
    emit = emission.gather(2, labels.unsqueeze(2)).squeeze(2)
    score = torch.where(valid, emit, zero).sum(0)
    last = labels.gather(0, (lengths - 1).clamp(min=0).unsqueeze(0))[0]
    score = score + start[labels[0]] + stop[last]
    if T > 1:
        pair = trans[labels[:-1], labels[1:]]                 # [T-1, B]
        score = score + torch.where(valid[1:], pair, zero).sum(0)
    return score


@register_op("linear_chain_crf", infer_shape=_infer_skip,
             no_grad_inputs=("Label",), eager_only=True)
def linear_chain_crf_lower(ctx):
    """``LogLikelihood`` ``[B, 1]``: each sequence's negative
    log-likelihood ``log Z - score(label path)``, minimised directly.
    The parity outputs: ``Alpha`` (the forward variables, each step
    L1-normalised: the softmax of the log alphas, flat), ``EmissionExps``
    (``exp`` of the row-max-normalised emissions) and
    ``TransitionExps``."""
    emission_flat = ctx.input("Emission")                    # [N, K]
    transition = ctx.input("Transition")                     # [K + 2, K]
    lod = _require_lod(ctx, "Emission")
    emission, lengths, pad = _padded(ctx, emission_flat, lod)
    labels = _to_padded(ctx.input("Label").reshape(-1, 1).long(),
                        pad)[..., 0]                         # [T, B]
    log_z, alphas = crf_log_alphas(emission, transition, lengths)
    gold = crf_gold_score(emission, transition, labels, lengths)
    ctx.set_output("LogLikelihood", (log_z - gold).unsqueeze(1))
    ctx.set_output("Alpha", _to_flat([torch.softmax(a, dim=-1)
                                      for a in alphas], pad))
    ctx.set_output("EmissionExps", torch.exp(
        emission_flat - emission_flat.amax(dim=-1, keepdim=True)))
    ctx.set_output("TransitionExps", torch.exp(transition))


def viterbi(emission, transition, lengths):
    """The best path of each padded sequence, ``[T, B]`` int64: the max
    recursion with back-pointers (the first best ``from`` of ties, as
    ``jnp.argmax``), a finished sequence keeping its scores and taking
    identity back-pointers, then the walk back from the best last tag."""
    start, stop, trans = transition[0], transition[1], transition[2:]
    K = emission.shape[2]
    identity = torch.arange(K, device=emission.device).unsqueeze(0)
    v = start.unsqueeze(0) + emission[0]                     # [B, K]
    pointers = []
    for t in range(1, emission.shape[0]):
        scores = v.unsqueeze(2) + trans.unsqueeze(0)         # [B, from, to]
        best, best_prev = torch.max(scores, dim=1)
        keep = (t < lengths).unsqueeze(1)
        v = torch.where(keep, best + emission[t], v)
        pointers.append(torch.where(keep, best_prev, identity))
    tag = torch.argmax(v + stop.unsqueeze(0), dim=1)         # [B]
    tags = [tag]
    for bp in reversed(pointers):
        tag = bp.gather(1, tag.unsqueeze(1)).squeeze(1)
        tags.append(tag)
    return torch.stack(tags[::-1])


@register_op("crf_decoding", infer_shape=_infer_skip, no_gradient=True,
             eager_only=True)
def crf_decoding_lower(ctx):
    """``ViterbiPath`` ``[N, 1]`` int64: the Viterbi tag of each token,
    or with ``Label`` given the 0/1 indicator of the tag equal to the
    label (reference ``crf_decoding_op.h``); the input's LoD."""
    emission_flat = ctx.input("Emission")
    lod = _require_lod(ctx, "Emission")
    emission, lengths, pad = _padded(ctx, emission_flat, lod)
    tags = viterbi(emission, ctx.input("Transition"), lengths)
    path = tags.reshape(-1).index_select(0, pad.scatter).unsqueeze(1)
    label = ctx.input("Label")
    if label is not None:
        path = (path == label.reshape(-1, 1).long()).long()
    ctx.set_output("ViterbiPath", path)
    ctx.set_output_lod("ViterbiPath", [list(level) for level in lod])
