"""``paged_attention``: decode attention over the gen model's paged KV
pool (the port's counterpart of the op of the same name in
``paddle_tpu.ops.attention_ops``).

The pool lives as ``[num_pages, page_len, H*D]`` persistable tensors plus
a per-slot page table.  Each decode step writes the new token's K/V row
into its slot's tail page, in place, then attends over ONLY the pages
covering ``[0, len)`` of each slot through the paged-decode kernel
(:mod:`paddle_tpu_torch.kernels.paged_decode`).
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.kernels.paged_decode import paged_attention
from paddle_tpu_torch.ops.registry import register_op, ShapeInferenceSkip


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


@register_op("paged_attention", infer_shape=_infer_paged_attn)
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
