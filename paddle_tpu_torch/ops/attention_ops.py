"""Attention ops (the port's counterpart of
``paddle_tpu.ops.attention_ops``).

``scaled_dot_product_attention``: fused attention over [B, H, S, D]
tensors through the flash kernels (:mod:`paddle_tpu_torch.kernels.
flash_attention`), saving ``Out`` and the ``(m, log l)`` residual
``Lse`` that its grad op reuses.  On the card every shape runs the
streaming kernels (the single-pass small-S kernels of the JAX package
are not ported yet); on the CPU their plain versions.

``paged_attention``: decode attention over the gen model's paged KV
pool.  The pool lives as ``[num_pages, page_len, H*D]`` persistable tensors plus
a per-slot page table.  Each decode step writes the new token's K/V row
into its slot's tail page, in place, then attends over ONLY the pages
covering ``[0, len)`` of each slot through the paged-decode kernel
(:mod:`paddle_tpu_torch.kernels.paged_decode`).
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.kernels.flash_attention import (flash_attention_bwd,
                                                      flash_attention_fwd)
from paddle_tpu_torch.kernels.paged_decode import paged_attention
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


def _kernel_mask(k_mask):
    """The key mask as the kernels take it (contiguous float32), or None."""
    return None if k_mask is None else k_mask.float().contiguous()


def _attn_grad_lower(ctx):
    """dQ, dK, dV from the forward's saved ``Out`` and ``Lse`` through the
    flash backward kernels (no forward recompute).  As in the reference,
    under AMP q/k/v are cast as the forward cast them, the incoming grad
    is cast to q's dtype, and each grad is cast back to its primal's
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
    o = ctx.env[op.input("Out")[0]]
    lse = ctx.env[op.input("Lse")[0]]
    g = ctx.env[op.input("Out@GRAD")[0]]
    dq, dk, dv = flash_attention_bwd(
        q, k, v, _kernel_mask(k_mask), o.contiguous(), lse.contiguous(),
        g.to(q.dtype).contiguous(), bool(ctx.attr("causal", False)),
        float(ctx.attr("scale", 1.0)))
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

    attrs: causal (bool), scale (float), use_flash (bool; the port has
    only the flash route, so the attr is kept for the IR and not read).
    """
    q, k, v = (ctx.input(s).contiguous() for s in ("Q", "K", "V"))
    out, lse = flash_attention_fwd(
        q, k, v, _kernel_mask(ctx.input("KMask")),
        bool(ctx.attr("causal", False)), float(ctx.attr("scale", 1.0)))
    ctx.set_output("Out", out)
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
