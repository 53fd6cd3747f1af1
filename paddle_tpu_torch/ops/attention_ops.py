"""Attention ops (the port's counterpart of
``paddle_tpu.ops.attention_ops``).

``scaled_dot_product_attention``: fused attention over [B, H, S, D]
tensors, saving ``Out`` and the ``(m, log l)`` residual ``Lse`` that its
grad op reuses.  As in the reference (``_pallas_attention`` and
``_pallas_attention_bwd``) the forward and the grad pick their route by
one rule on the same shapes (:func:`attention_kernels`): self-attention
shapes up to a measured length take the single-pass pair
(:mod:`paddle_tpu_torch.kernels.smalls_attention`), other shapes the
streaming flash kernels (:mod:`paddle_tpu_torch.kernels.
flash_attention`), on the CPU their plain versions; ``use_flash=False``
and head widths beyond the kernels' take the unfused route, the
reference's ``_reference_attention`` (:func:`unfused_attention_fwd`),
which sets no ``Lse``.

``paged_attention``: decode attention over the gen model's paged KV
pool.  The pool lives as ``[num_pages, page_len, H*D]`` persistable tensors plus
a per-slot page table.  Each decode step writes the new token's K/V row
into its slot's tail page, in place, then attends over ONLY the pages
covering ``[0, len)`` of each slot through the paged-decode kernel
(:mod:`paddle_tpu_torch.kernels.paged_decode`).
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.kernels.bias_softmax import (bias_softmax,
                                                   bias_softmax_grad)
from paddle_tpu_torch.kernels.flash_attention import (MAX_HEAD, NEG_INF,
                                                      flash_attention_bwd,
                                                      flash_attention_fwd)
from paddle_tpu_torch.kernels.paged_decode import paged_attention
from paddle_tpu_torch.kernels.smalls_attention import (smalls_attention_bwd,
                                                       smalls_attention_fwd,
                                                       smalls_ok)
from paddle_tpu_torch.ops.registry import register_op, ShapeInferenceSkip


# ---------------------------------------------------------------------------
# scaled_dot_product_attention
# ---------------------------------------------------------------------------

def _infer_attn(op, block):
    q = block.var(op.input("Q")[0])
    v = block.var(op.input("V")[0])
    out = block.var(op.output("Out")[0])
    if q.shape is None or v.shape is None:
        raise ShapeInferenceSkip()
    out.shape = tuple(q.shape[:3]) + (v.shape[3],)
    out.dtype = q.dtype
    lse_names = op.output("Lse")
    if lse_names:
        lse = block.var(lse_names[0])
        # packed flash residual: (softmax running max, log denominator)
        lse.shape = tuple(q.shape[:3]) + (2,)
        lse.dtype = "float32"


def _unfused_scores(q, k, k_mask, causal, scale):
    """float32 ``(q . k) * scale`` and the additive biases as the
    bias-softmax kernel takes them: ``(1 - mask) * NEG_INF`` [B, Sk] and
    the causal ``NEG_INF`` above the diagonal [Sq, Sk] (or None)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    row_bias = None if k_mask is None else \
        ((1.0 - k_mask.float()) * NEG_INF).contiguous()
    tri_bias = None
    if causal:
        Sq, Sk = q.shape[2], k.shape[2]
        row = torch.arange(Sq, device=q.device)[:, None]
        col = torch.arange(Sk, device=q.device)[None, :]
        tri_bias = torch.where(col > row, NEG_INF, 0.0).to(torch.float32)
    return s, row_bias, tri_bias


def unfused_attention_fwd(q, k, v, k_mask=None, causal=False, scale=1.0):
    """The reference's ``_reference_attention``: scores in float32,
    ``softmax(s + biases)`` in float32 through the bias-softmax kernel
    (its plain version on the CPU), the probabilities rounded to v's
    dtype, ``p . v`` summed in float32, the output in q's dtype.  Returns
    ``(out, None)``: this route keeps no ``Lse`` residual (the reference
    sets none on it); its grad recomputes what it needs."""
    s, row_bias, tri_bias = _unfused_scores(q, k, k_mask, causal, scale)
    p = bias_softmax(s, row_bias, tri_bias)
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    return out.to(q.dtype), None


def unfused_attention_bwd(q, k, v, k_mask, out, lse, dout, causal=False,
                          scale=1.0):
    """``(dq, dk, dv)`` of :func:`unfused_attention_fwd`: the vjp of the
    reference's route, cast for cast.  ``p`` is recomputed (``out`` and
    ``lse`` are not read); the grad of the rounded ``p`` and each input's
    grad are rounded to their primal's dtype, where the reference's
    transposed products round them; the softmax grad runs through the
    bias-softmax grad kernel."""
    s, row_bias, tri_bias = _unfused_scores(q, k, k_mask, causal, scale)
    p = bias_softmax(s, row_bias, tri_bias)
    g = dout.float()
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), g)
    dp = torch.matmul(g, v.float().transpose(-1, -2)).to(v.dtype)
    ds = bias_softmax_grad(p, dp.contiguous()) * scale
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_kernels(q, k, v, use_flash=True):
    """``(forward, backward)`` routes for attention over these q, k, v
    [B, H, S, D]: the unfused route (:func:`unfused_attention_fwd`) when
    ``use_flash`` is False or a head width exceeds the kernels'
    ``MAX_HEAD``, as the reference takes ``_reference_attention`` when
    ``use_flash`` is off or no kernel tiling fits; else the single-pass
    pair where :func:`smalls_ok` admits the shape, else the flash
    kernels.  Both lowerings call this on the same tensors and attrs, so
    a forward and its grad never mix routes, and a kernel forward's
    residual is read by the matching backward."""
    B, H, Sq, D = q.shape
    Dv = v.shape[3]
    if not use_flash or D > MAX_HEAD or Dv > MAX_HEAD:
        return unfused_attention_fwd, unfused_attention_bwd
    if smalls_ok(B * H, Sq, k.shape[2], D, Dv):
        return smalls_attention_fwd, smalls_attention_bwd
    return flash_attention_fwd, flash_attention_bwd


def _kernel_mask(k_mask):
    """The key mask as the kernels take it (contiguous float32), or None."""
    return None if k_mask is None else k_mask.float().contiguous()


def _attn_grad_lower(ctx):
    """dQ, dK, dV through the backward of the route the forward ran: the
    kernels' from the saved ``Out`` and ``Lse`` (no forward recompute),
    the unfused route's from q, k, v alone.  As in the reference, under
    AMP q/k/v are cast as the forward cast them, the incoming grad is
    cast to q's dtype, and each grad is cast back to its primal's
    dtype."""
    op = ctx.op
    qe = ctx.env[op.input("Q")[0]]
    ke = ctx.env[op.input("K")[0]]
    ve = ctx.env[op.input("V")[0]]
    mask_names = op.input("KMask")
    k_mask = ctx.env[mask_names[0]] if mask_names else None
    amp = bool(ctx.aux.get("amp"))

    def cast_in(x):
        return x.to(torch.bfloat16) if amp and x.dtype == torch.float32 \
            else x

    q, k, v = (cast_in(x).contiguous() for x in (qe, ke, ve))
    g = ctx.env[op.input("Out@GRAD")[0]]
    _, attention_bwd = attention_kernels(
        q, k, v, bool(ctx.attr("use_flash", True)))
    if attention_bwd is unfused_attention_bwd:
        o = lse = None
    else:
        o = ctx.env[op.input("Out")[0]].contiguous()
        lse = ctx.env[op.input("Lse")[0]].contiguous()
    dq, dk, dv = attention_bwd(
        q, k, v, _kernel_mask(k_mask), o, lse, g.to(q.dtype).contiguous(),
        bool(ctx.attr("causal", False)), float(ctx.attr("scale", 1.0)))
    for slot, val, prim in (("Q@GRAD", dq, qe), ("K@GRAD", dk, ke),
                            ("V@GRAD", dv, ve)):
        names = op.output(slot)
        if names and names[0]:
            ctx.outputs[names[0]] = val.to(prim.dtype)


@register_op("scaled_dot_product_attention", infer_shape=_infer_attn,
             grad_lower=_attn_grad_lower, no_grad_inputs=("KMask",),
             amp_cast=("Q", "K", "V"))
def sdpa_lower(ctx):
    """Q, K, V: [B, H, S, D]; KMask: [B, S_k] (1 = attend), optional;
    Out: [B, H, Sq, Dv] in Q's dtype; Lse: [B, H, Sq, 2] float32.

    attrs: causal (bool), scale (float), use_flash (bool, default True;
    False takes the unfused route, see :func:`attention_kernels`).
    """
    q, k, v = (ctx.input(s).contiguous() for s in ("Q", "K", "V"))
    attention_fwd, _ = attention_kernels(
        q, k, v, bool(ctx.attr("use_flash", True)))
    out, lse = attention_fwd(
        q, k, v, _kernel_mask(ctx.input("KMask")),
        bool(ctx.attr("causal", False)), float(ctx.attr("scale", 1.0)))
    ctx.set_output("Out", out)
    if lse is not None:
        # saved residual; consumed by the grad op
        ctx.set_output("Lse", lse)


# ---------------------------------------------------------------------------
# paged_attention
# ---------------------------------------------------------------------------


def paged_cache_update(kc, vc, k, v, page_table, lens):
    """Write this step's K/V row into each live slot's tail page, in
    place on the pools ``kc``/``vc`` [NP, PL, H*D].

    ``lens`` [S, 1] counts rows INCLUDING the token being decoded, so the
    row lands at position ``lens - 1``; a dead slot (``lens == 0``) writes
    nothing.  Without a host sync to find the live slots, every slot
    takes part in one ``index_put_``: a dead slot repeats the write of the
    first live slot (or, when no slot is live, writes a row's own value
    back), so duplicate indices always carry identical values.
    """
    NP, PL, HD = kc.shape
    S = page_table.shape[0]
    last = lens.reshape(S).long() - 1
    live = last >= 0
    idx = last.clamp(min=0)
    page = page_table.long().gather(1, (idx // PL).unsqueeze(1)).squeeze(1)
    flat = page.clamp(0, NP - 1) * PL + idx % PL          # [S] pool rows
    src = torch.where(live, torch.arange(S, device=flat.device),
                      live.long().argmax())
    target = flat[src]
    any_live = live.any()
    for pool, new in ((kc, k), (vc, v)):
        rows = pool.view(NP * PL, HD)
        vals = torch.where(any_live, new.reshape(S, HD)[src].to(pool.dtype),
                           rows[target])
        rows.index_put_((target,), vals)


def _infer_paged_attn(op, block):
    q = block.var(op.input("Q")[0])
    out = block.var(op.output("Out")[0])
    if q.shape is None:
        raise ShapeInferenceSkip()
    out.shape = tuple(q.shape)
    out.dtype = q.dtype
    # KCacheOut/VCacheOut alias the persistable cache vars (in-place
    # update idiom) — their shapes are already declared


@register_op("paged_attention", infer_shape=_infer_paged_attn,
             no_gradient=True,
             stateful_outputs=("KCacheOut", "VCacheOut"))
def paged_attention_lower(ctx):
    """Q/K/V: [S, 1, H*D] this step's projections; KCache/VCache:
    [num_pages, page_len, H*D] persistable pool; PageTable: [S, P] int32
    (P = the step's page bucket); Lens: [S, 1] int32 rows INCLUDING the
    current token (0 = free slot).  Out: [S, 1, H*D]; KCacheOut/
    VCacheOut name the cache vars themselves (updated in place).

    attrs: n_head (int), scale (float).
    """
    q = ctx.input("Q")
    kc, vc = ctx.input("KCache"), ctx.input("VCache")
    pt, lens = ctx.input("PageTable"), ctx.input("Lens")
    paged_cache_update(kc, vc, ctx.input("K"), ctx.input("V"), pt, lens)
    S = q.shape[0]
    out = paged_attention(q.reshape(S, -1).contiguous(), kc, vc,
                          pt.to(torch.int32).contiguous(),
                          lens.reshape(S).to(torch.int32).contiguous(),
                          int(ctx.attr("n_head", 1)),
                          float(ctx.attr("scale", 1.0)))
    ctx.set_output("Out", out.reshape(q.shape))
    ctx.set_output("KCacheOut", kc)
    ctx.set_output("VCacheOut", vc)
