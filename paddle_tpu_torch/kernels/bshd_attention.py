"""Single-pass attention in the model's ``[B, S, H, D]`` layout: a forward
kernel and ONE backward kernel for dQ, dK and dV (the ports of
``_bshd_fwd_kernel`` and ``_bshd_bwd_kernel``, ``exp_bshd_attn.py:42`` and
``:69``).

q, k, v come as the projections give them, one reshape of ``[B, S,
H*D]``; the output and the grads go back in the same layout, so the
model's head transposes around the op are gone.  The forward saves the
``(m, log l)`` residual ``[B, S, H, 2]``; ``delta = rowsum(dO * out)`` is
a torch reduction outside the kernel, as in the reference
(``exp_bshd_attn.py:133``).

:func:`bshd_attention_fwd` and :func:`bshd_attention_bwd` launch the CUDA
kernels of ``csrc/bshd_attention.cu`` for tensors on the card and run
their plain torch versions (``*_reference``) for tensors on the CPU.
:func:`bshd_attn` (through :class:`BshdAttentionFunction`) is the
port of ``make_bshd_attention`` (``exp_bshd_attn.py:154``): attention
under torch autograd, no grad for the mask.

Masking as the reference: ``k_mask`` [B, S] (1 = attend) adds ``(1 -
mask) * -1e9`` and the causal flag ``-1e9`` where ``col > row``, so a row
with every key masked is the mean of v over all keys (causal: over keys
``0 .. row``).
"""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.kernels.build import CudaKernel
from paddle_tpu_torch.kernels.flash_attention import MAX_HEAD, NEG_INF
from paddle_tpu_torch.kernels.smalls_attention import (_KEY_TILE, _MAX_SMEM,
                                                       _dq_scratch, _ptr,
                                                       smalls_fwd_rows)

__all__ = ["BSHD_FWD", "BSHD_BWD", "bshd_max_s", "bshd_attention_fwd",
           "bshd_attention_bwd", "bshd_attention_fwd_reference",
           "bshd_attention_bwd_reference", "BshdAttentionFunction",
           "bshd_attn"]

BSHD_FWD = CudaKernel("bshd_fwd", "bshd_attention.cu",
                      replaces="exp_bshd_attn.py:42")
BSHD_BWD = CudaKernel("bshd_bwd", "bshd_attention.cu",
                      replaces="exp_bshd_attn.py:69")

_TAG = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SHAPE = [_I, _I, _I, _I, _F, _I]
_FWD_ARGS = [_P] * 6 + _SHAPE + [_I, _P]
_BWD_ARGS = [_P] * 11 + _SHAPE + [_P]


def bshd_max_s(D):
    """Longest sequence the forward takes at head width ``D``: 16 query
    rows' float32 scores against all S keys (rounded up to the key tile)
    in a block's shared memory (``fwd_smem`` of
    ``csrc/single_pass_attention.cuh``, as ``smalls_fwd_rows`` counts
    it)."""
    words = _MAX_SMEM // 4 - (16 + _KEY_TILE) * (D + 1) - 16 * 16
    return words // 17 // _KEY_TILE * _KEY_TILE


# ---------------------------------------------------------------------------
# plain torch versions (the reference's arithmetic and casts, step by step)
# ---------------------------------------------------------------------------

def _scores(q, k, k_mask, causal, scale):
    """float32 [B, H, S, S] masked, scaled scores of [B, S, H, D] q, k."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if k_mask is not None:
        s = s + (1.0 - k_mask.float())[:, None, None, :] * NEG_INF
    if causal:
        S = q.shape[1]
        row = torch.arange(S, device=q.device)[:, None]
        col = torch.arange(S, device=q.device)[None, :]
        s = s + torch.where(col > row, NEG_INF, 0.0).to(s.dtype)
    return s


def bshd_attention_fwd_reference(q, k, v, k_mask=None, causal=False,
                                 scale=1.0):
    """``(out, res)``: out [B,S,H,D] in q's dtype, res [B,S,H,2] float32
    holding the row max ``m`` and ``log l`` apart.  Scores, max, exp and
    sum in float32; ``exp(s - m)`` is rounded to v's dtype before the
    product with v, which sums in float32."""
    s = _scores(q, k, k_mask, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", e.to(v.dtype).float(), v.float())
    out = o / l.permute(0, 2, 1, 3)
    res = torch.cat([m, torch.log(l)], dim=-1).permute(0, 2, 1, 3)
    return out.to(q.dtype), res.contiguous()


def bshd_attention_bwd_reference(q, k, v, k_mask, out, res, dout,
                                 causal=False, scale=1.0):
    """``(dq, dk, dv)`` [B,S,H,D] from the saved ``out`` and ``res``, each
    in its primal's dtype.  ``p`` and ``dS`` are float32 and are rounded
    before each product that takes them: ``p`` to dO's dtype for dV,
    ``dS`` to k's for dQ and to q's for dK; ``delta`` is float32 from dO
    and out."""
    s = _scores(q, k, k_mask, causal, scale)
    r = res.permute(0, 2, 1, 3)                      # [B, H, S, 2]
    p = torch.exp((s - r[..., 0:1]) - r[..., 1:2])
    do = dout.float()
    delta = (do * out.float()).sum(dim=-1).permute(0, 2, 1)[..., None]
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).float(), do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.float())
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(q, k, v, k_mask, others=()):
    """Validate the kernels' arguments; returns ``(dtype tag, float32
    mask or None, (B, S, H, D))``.  A mask in q's dtype or float32 is
    converted to a contiguous float32 one (exactly: it holds 0 and 1)."""
    what = "bshd attention"
    if q.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {q.device}")
    for name, t in (("k", k), ("v", v)) + tuple(others):
        if t.device != q.device:
            raise ValueError(f"{what}: {name} on {t.device}, q on "
                             f"{q.device}")
    tag = _TAG.get(q.dtype)
    if tag is None or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: q, k, v must share float32 or bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or tuple(k.shape) != tuple(q.shape) or \
            tuple(v.shape) != tuple(q.shape):
        raise ValueError(f"{what}: q, k, v must share one [B, S, H, D] "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, D = q.shape
    if D > MAX_HEAD:
        raise ValueError(f"{what}: head width {D} exceeds the kernels' "
                         f"{MAX_HEAD}")
    if smalls_fwd_rows(S, D, D) is None:
        raise ValueError(f"{what}: S {S} exceeds the {bshd_max_s(D)} keys "
                         f"a block's shared memory holds at D {D}")
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(others):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    mask = None
    if k_mask is not None:
        if tuple(k_mask.shape) != (B, S) or \
                k_mask.dtype not in (q.dtype, torch.float32) or \
                k_mask.device != q.device:
            raise ValueError(f"{what}: k_mask must be a [{B}, {S}] tensor "
                             f"of {q.dtype} or float32 on {q.device}, got "
                             f"{k_mask.dtype} {tuple(k_mask.shape)} on "
                             f"{k_mask.device}")
        mask = k_mask.float().contiguous()
    return tag, mask, (B, S, H, D)


def bshd_attention_fwd(q, k, v, k_mask=None, causal=False, scale=1.0):
    """Attention forward; see :func:`bshd_attention_fwd_reference`.  On the
    card: q, k, v contiguous float32 or bfloat16 of one [B, S, H, D]
    shape, S within :func:`bshd_max_s`, k_mask None or [B, S] in q's dtype
    or float32; else raises."""
    if q.device.type == "cpu":
        return bshd_attention_fwd_reference(q, k, v, k_mask, causal, scale)
    tag, mask, shape = _check(q, k, v, k_mask)
    B, S, H, D = shape
    out = torch.empty_like(q)
    res = torch.empty((B, S, H, 2), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out, res
    rows = smalls_fwd_rows(S, D, D)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        BSHD_FWD.launch(f"bshd_fwd_{tag}", _FWD_ARGS, q.data_ptr(),
                        k.data_ptr(), v.data_ptr(), _ptr(mask),
                        out.data_ptr(), res.data_ptr(), *shape, float(scale),
                        int(causal), rows // 16, stream)
    return out, res


def bshd_attention_bwd(q, k, v, k_mask, out, res, dout, causal=False,
                       scale=1.0):
    """Attention backward from the forward's ``out`` and ``res``; see
    :func:`bshd_attention_bwd_reference`.  On the card ``dout`` and
    ``out`` must match q's dtype and shape, ``res`` the forward's;
    launches the one backward kernel (bfloat16: the tensor-core body;
    float32: the CUDA-core body with a float32 dQ scratch), or raises."""
    if q.device.type == "cpu":
        return bshd_attention_bwd_reference(q, k, v, k_mask, out, res, dout,
                                            causal, scale)
    tag, mask, shape = _check(q, k, v, k_mask,
                              (("out", out), ("res", res), ("dout", dout)))
    B, S, H, D = shape
    for name, t in (("dout", dout), ("out", out)):
        if t.dtype != q.dtype or tuple(t.shape) != shape:
            raise ValueError(f"bshd attention: {name} must be {q.dtype} "
                             f"[{B}, {S}, {H}, {D}]")
    if res.dtype != torch.float32 or tuple(res.shape) != (B, S, H, 2):
        raise ValueError(f"bshd attention: res must be float32 "
                         f"[{B}, {S}, {H}, 2]")
    delta = (dout.float() * out.float()).sum(dim=-1).contiguous()
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    dq_acc = _dq_scratch(q, B * H, S, D)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        BSHD_BWD.launch(f"bshd_bwd_{tag}", _BWD_ARGS, q.data_ptr(),
                        k.data_ptr(), v.data_ptr(), _ptr(mask),
                        dout.data_ptr(), res.data_ptr(), delta.data_ptr(),
                        _ptr(dq_acc), dq.data_ptr(), dk.data_ptr(),
                        dv.data_ptr(), *shape, float(scale), int(causal),
                        stream)
    return dq, dk, dv


class BshdAttentionFunction(torch.autograd.Function):
    """``(out, res) = attention(q, k, v)`` under torch autograd: the forward
    kernel, and the one backward kernel on the saved ``(q, k, v, k_mask,
    out, res)`` (``setup_context`` form).  ``res`` and the mask get no
    grad."""

    @staticmethod
    def forward(q, k, v, k_mask=None, causal=False, scale=1.0):
        return bshd_attention_fwd(q, k, v, k_mask, causal, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, k_mask, causal, scale = inputs
        out, res = output
        ctx.save_for_backward(q, k, v, k_mask, out, res)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(res)

    @staticmethod
    def backward(ctx, dout, _dres):
        q, k, v, k_mask, out, res = ctx.saved_tensors
        dq, dk, dv = bshd_attention_bwd(
            q, k, v, k_mask, out, res, dout.to(q.dtype).contiguous(),
            ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def bshd_attn(q, k, v, k_mask=None, causal=False, scale=1.0):
    """Attention output [B, S, H, D] of [B, S, H, D] q, k, v under torch
    autograd (the port of ``make_bshd_attention``'s ``attn``)."""
    return BshdAttentionFunction.apply(q, k, v, k_mask, causal, scale)[0]
