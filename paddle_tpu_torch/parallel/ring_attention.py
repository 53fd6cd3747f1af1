"""Ring attention: exact attention over a sequence split across ranks
(the port's counterpart of ``paddle_tpu.parallel.ring_attention``; Liu
et al., "Ring Attention with Blockwise Transformers for Near-Infinite
Context").

Q stays local; the K/V shards rotate around the ``axis`` ring of the
mesh (``batch_isend_irecv`` to the next rank, from the previous one)
while an online softmax accumulates, as the JAX package's ``lax.scan``
over ``ppermute`` does.  The per-block products are ``torch.matmul`` (the
JAX package's are ``einsum`` outside any Pallas kernel), in the inputs'
dtype.  The JAX package differentiates its scan through ``ppermute``;
send and recv have no autograd, so :class:`RingAttentionFunction` has a
backward of its own: the K/V shards go round the ring again, each
carrying the dK/dV accumulators of its block, and a last hop brings
every block's accumulators home.

Inputs are DTensors on ``mesh`` (any placements: they are redistributed
so that ``axis`` splits dim 2 and no axis splits the others' reduction)
or plain tensors holding the whole array on every rank.  The result
takes the same form.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

__all__ = ["ring_attention", "ring_attention_fwd", "ring_attention_bwd",
           "RingAttentionFunction"]

NEG_INF = -1e30


def _ring_layout(x, mesh, axis):
    """``x`` as a DTensor split on dim 2 over ``axis``, other axes keeping
    a split of dims 0 or 1 and replicating otherwise."""
    names = list(mesh.mesh_dim_names)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * len(names),
                               run_check=False)
    target = []
    for name, pl in zip(names, x.placements):
        if name == axis:
            target.append(Shard(2))
        elif isinstance(pl, Shard) and pl.dim in (0, 1):
            target.append(pl)
        else:
            target.append(Replicate())
    return x.redistribute(mesh, target)


def _exchange(tensors, group, idx, p):
    """Send ``tensors`` to the next rank of the ring, receive the
    previous rank's."""
    nxt = dist.get_global_rank(group, (idx + 1) % p)
    prv = dist.get_global_rank(group, (idx - 1) % p)
    bufs = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, group)
           for t in tensors]
    ops += [dist.P2POp(dist.irecv, b, prv, group) for b in bufs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return bufs


def _scores(q, k, q_off, k_off, causal, scale):
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if causal:
        Sq, Sk = q.shape[2], k.shape[2]
        row = torch.arange(Sq, device=q.device)[:, None] + q_off
        col = torch.arange(Sk, device=q.device)[None, :] + k_off
        s = torch.where((col > row)[None, None],
                        torch.full((), NEG_INF, dtype=s.dtype,
                                   device=s.device), s)
    return s


def _fwd_local(q, k, v, group, idx, p, causal, scale):
    """``(out, lse)`` of the local Q shard [B, H, S/p, D] against every
    K/V shard of the ring."""
    s_local = q.shape[2]
    q_off = idx * s_local
    B, H, Sq, _ = q.shape
    m = torch.full((B, H, Sq, 1), NEG_INF, dtype=q.dtype, device=q.device)
    l = torch.zeros((B, H, Sq, 1), dtype=q.dtype, device=q.device)
    acc = torch.zeros((B, H, Sq, v.shape[3]), dtype=q.dtype,
                      device=q.device)
    k_cur, v_cur = k, v
    for step in range(p):
        src = (idx - step) % p
        s = _scores(q, k_cur, q_off, src * s_local, causal, scale)
        new_m = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - new_m)
        probs = torch.exp(s - new_m)
        l = l * corr + probs.sum(-1, keepdim=True)
        acc = acc * corr + torch.matmul(probs, v_cur)
        m = new_m
        if step < p - 1:
            k_cur, v_cur = _exchange((k_cur, v_cur), group, idx, p)
    l = torch.clamp_min(l, 1e-30)
    return acc / l, m + torch.log(l)


def _bwd_local(q, k, v, out, lse, dout, group, idx, p, causal, scale):
    """``(dq, dk, dv)`` of the local shards: the K/V shards go round the
    ring again with their dK/dV accumulators; after the last step one
    more hop brings each block's accumulators back to its rank."""
    s_local = q.shape[2]
    q_off = idx * s_local
    delta = (dout * out).sum(-1, keepdim=True)
    dq = torch.zeros_like(q)
    k_cur, v_cur = k, v
    dk_cur, dv_cur = torch.zeros_like(k), torch.zeros_like(v)
    for step in range(p):
        src = (idx - step) % p
        s = _scores(q, k_cur, q_off, src * s_local, causal, scale)
        prob = torch.exp(s - lse)
        dv_cur = dv_cur + torch.matmul(prob.transpose(-1, -2), dout)
        dp = torch.matmul(dout, v_cur.transpose(-1, -2))
        ds = prob * (dp - delta) * scale
        dq = dq + torch.matmul(ds, k_cur)
        dk_cur = dk_cur + torch.matmul(ds.transpose(-1, -2), q)
        if p > 1:
            carry = (dk_cur, dv_cur) if step == p - 1 else \
                (k_cur, v_cur, dk_cur, dv_cur)
            got = _exchange(carry, group, idx, p)
            if step < p - 1:
                k_cur, v_cur, dk_cur, dv_cur = got
            else:
                dk_cur, dv_cur = got
    return dq, dk_cur, dv_cur


def _ring(mesh, axis):
    group = mesh.get_group(axis)
    return group, mesh.get_local_rank(axis), dist.get_world_size(group)


def _scale(q, scale):
    return float(q.shape[-1]) ** -0.5 if scale is None else float(scale)


def _wrap(local, like, plain):
    out = DTensor.from_local(local, like.device_mesh, like.placements,
                             run_check=False)
    return out.full_tensor() if plain else out


def _check(q, mesh, axis):
    p = dict(zip(mesh.mesh_dim_names, mesh.shape))[axis]
    assert q.shape[2] % p == 0, \
        f"seq len {q.shape[2]} not divisible by mesh axis {axis}={p}"


def ring_attention_fwd(q, k, v, mesh, axis="seq", causal=False,
                       scale=None):
    """``(out, lse)`` of attention over q, k, v [B, H, S, D] with S split
    over ``axis``; ``lse`` is the softmax's log normalizer [B, H, S, 1]."""
    _check(q, mesh, axis)
    plain = not isinstance(q, DTensor)
    qd, kd, vd = (_ring_layout(t, mesh, axis) for t in (q, k, v))
    group, idx, p = _ring(mesh, axis)
    out, lse = _fwd_local(qd.to_local(), kd.to_local(), vd.to_local(),
                          group, idx, p, causal, _scale(q, scale))
    return _wrap(out, qd, plain), _wrap(lse, qd, plain)


def ring_attention_bwd(q, k, v, out, lse, dout, mesh, axis="seq",
                       causal=False, scale=None):
    """``(dq, dk, dv)`` of :func:`ring_attention_fwd` at ``dout``."""
    _check(q, mesh, axis)
    plain = not isinstance(q, DTensor)
    qd, kd, vd, od, ld, gd = (_ring_layout(t, mesh, axis)
                              for t in (q, k, v, out, lse, dout))
    group, idx, p = _ring(mesh, axis)
    dq, dk, dv = _bwd_local(qd.to_local(), kd.to_local(), vd.to_local(),
                            od.to_local(), ld.to_local(), gd.to_local(),
                            group, idx, p, causal, _scale(q, scale))
    return _wrap(dq, qd, plain), _wrap(dk, kd, plain), _wrap(dv, vd, plain)


class RingAttentionFunction(torch.autograd.Function):
    """:func:`ring_attention_fwd` under autograd, with
    :func:`ring_attention_bwd` as its backward."""

    @staticmethod
    def forward(q, k, v, mesh, axis, causal, scale):
        return ring_attention_fwd(q, k, v, mesh, axis, causal, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, mesh, axis, causal, scale = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (mesh, axis, causal, scale)
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ring_attention_bwd(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None


def ring_attention(q, k, v, mesh, axis="seq", causal=False, scale=None):
    """Exact attention with q, k, v [B, H, S, D] split on S over ``axis``
    of ``mesh``; differentiable.  Returns [B, H, S, D] in the inputs'
    form (a DTensor split on S, or the whole tensor)."""
    return RingAttentionFunction.apply(q, k, v, mesh, axis, causal,
                                       scale)[0]
