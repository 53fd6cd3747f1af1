"""Streaming (flash) attention: forward with the ``(m, log l)`` residual,
and the backward as a dQ kernel and a dK/dV kernel (the ports of
``_flash_fwd_kernel``, ``_flash_dq_kernel`` and ``_flash_dkdv_kernel``,
``paddle_tpu/ops/attention_ops.py:89``, ``:191`` and ``:140``).

:func:`flash_attention_fwd` and :func:`flash_attention_bwd` launch the
CUDA kernels of ``csrc/flash_attention.cu`` for tensors on the card and
run their plain torch versions (``*_reference``) for tensors on the CPU.
There is no tiling gate: any ``Sq``, ``Sk`` and head widths up to
:data:`MAX_HEAD`.  ``delta = rowsum(dO * out)`` is a torch reduction
outside the kernels, as in the reference (``attention_ops.py:491``).
:class:`FlashAttentionFunction` puts the trio under torch autograd; the
IR's ``scaled_dot_product_attention_grad`` op calls the backward
directly on the saved ``Out`` and ``Lse``.

Masking: ``k_mask`` [B, Sk] (1 = attend) adds ``(1 - mask) * -1e9``, the
causal flag adds ``-1e9`` where ``col > row``, exactly as the reference,
so a fully masked row attends uniformly.
"""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.kernels.build import CudaKernel

__all__ = ["FLASH_FWD", "FLASH_DQ", "FLASH_DKDV", "MAX_HEAD", "NEG_INF",
           "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_fwd_reference", "flash_attention_bwd_reference",
           "flash_attention_dq_reference", "flash_attention_dkdv_reference",
           "FlashAttentionFunction"]

FLASH_FWD = CudaKernel("flash_fwd", "flash_attention.cu",
                       replaces="paddle_tpu/ops/attention_ops.py:89")
FLASH_DQ = CudaKernel("flash_dq", "flash_attention.cu",
                      replaces="paddle_tpu/ops/attention_ops.py:191")
FLASH_DKDV = CudaKernel("flash_dkdv", "flash_attention.cu",
                        replaces="paddle_tpu/ops/attention_ops.py:140")

NEG_INF = -1e9
#: widest head (D and Dv) the kernels take
MAX_HEAD = 128

_TAG = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SHAPE = [_I, _I, _I, _I, _I, _I, _F, _I, _P]
_FWD_ARGS = [_P] * 6 + _SHAPE
_DQ_ARGS = [_P] * 8 + _SHAPE
_DKDV_ARGS = [_P] * 9 + _SHAPE


# ---------------------------------------------------------------------------
# plain torch versions (the kernels' arithmetic: float32 throughout)
# ---------------------------------------------------------------------------

def _scores(q, k, k_mask, causal, scale):
    """float32 [B, H, Sq, Sk] masked, scaled scores."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return _masked(s, k_mask, causal)


def _masked(s, k_mask, causal):
    """Scaled float32 scores [B, H, Sq, Sk] with the key mask's and the
    causal ``NEG_INF`` added, in the kernels' order."""
    if k_mask is not None:
        s = s + (1.0 - k_mask.float())[:, None, None, :] * NEG_INF
    if causal:
        Sq, Sk = s.shape[2], s.shape[3]
        row = torch.arange(Sq, device=s.device)[:, None]
        col = torch.arange(Sk, device=s.device)[None, :]
        s = s + torch.where(col > row, NEG_INF, 0.0).to(s.dtype)
    return s


def flash_attention_fwd_reference(q, k, v, k_mask=None, causal=False,
                                  scale=1.0):
    """``(out, lse)``: out [B,H,Sq,Dv] in q's dtype, lse [B,H,Sq,2]
    float32 holding the row max ``m`` and ``log l`` apart."""
    s = _scores(q, k, k_mask, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    out = torch.matmul(e, v.float()) / l
    return out.to(q.dtype), torch.cat([m, torch.log(l)], dim=-1)


def _probs_and_dscores(q, k, v, k_mask, out, lse, dout, causal, scale):
    """float32 ``p``, ``dS`` and ``dO``, recomputed from the saved lse as
    each backward kernel recomputes them."""
    s = _scores(q, k, k_mask, causal, scale)
    p = torch.exp((s - lse[..., 0:1]) - lse[..., 1:2])
    do = dout.float()
    delta = (do * out.float()).sum(dim=-1, keepdim=True)
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    return p, p * (dp - delta) * scale, do


def flash_attention_dq_reference(q, k, v, k_mask, out, lse, dout,
                                 causal=False, scale=1.0):
    """Plain version of the dQ kernel: ``dq`` in q's dtype."""
    _, ds, _ = _probs_and_dscores(q, k, v, k_mask, out, lse, dout, causal,
                                  scale)
    return torch.matmul(ds, k.float()).to(q.dtype)


def flash_attention_dkdv_reference(q, k, v, k_mask, out, lse, dout,
                                   causal=False, scale=1.0):
    """Plain version of the dK/dV kernel: ``(dk, dv)`` in k's and v's
    dtypes."""
    p, ds, do = _probs_and_dscores(q, k, v, k_mask, out, lse, dout, causal,
                                   scale)
    dv = torch.matmul(p.transpose(-1, -2), do)
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, k_mask, out, lse, dout,
                                  causal=False, scale=1.0):
    """``(dq, dk, dv)`` from the saved ``out`` and ``lse``, each in its
    primal's dtype: the two kernels' plain versions."""
    args = (q, k, v, k_mask, out, lse, dout, causal, scale)
    return (flash_attention_dq_reference(*args),
            *flash_attention_dkdv_reference(*args))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(q, k, v, k_mask, others=(), what="flash attention"):
    """Validate the kernels' arguments; returns ``(dtype tag, mask
    pointer or None, (B, H, Sq, Sk, D, Dv))``.  ``what`` names the
    caller in the messages."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {q.device}")
    for name, t in (("k", k), ("v", v)) + tuple(others):
        if t.device != q.device:
            raise ValueError(f"{what}: {name} on {t.device}, q on "
                             f"{q.device}")
    tag = _TAG.get(q.dtype)
    if tag is None or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: q, k, v must share float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"{what}: q, k, v must be [B, H, S, D]")
    B, H, Sq, D = q.shape
    Sk, Dv = k.shape[2], v.shape[3]
    if tuple(k.shape) != (B, H, Sk, D) or tuple(v.shape[:3]) != (B, H, Sk):
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if D > MAX_HEAD or Dv > MAX_HEAD:
        raise ValueError(f"{what}: head widths {D}, {Dv} exceed "
                         f"the kernels' {MAX_HEAD}")
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(others):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    mask = None
    if k_mask is not None:
        if tuple(k_mask.shape) != (B, Sk) or k_mask.dtype != torch.float32 \
                or not k_mask.is_contiguous() or k_mask.device != q.device:
            raise ValueError(f"{what}: k_mask must be a contiguous "
                             f"float32 [{B}, {Sk}] tensor on {q.device}")
        mask = k_mask.data_ptr()
    return tag, mask, (B, H, Sq, Sk, D, Dv)


def flash_attention_fwd(q, k, v, k_mask=None, causal=False, scale=1.0):
    """Attention forward; see :func:`flash_attention_fwd_reference`.  On
    the card: q, k, v contiguous float32 or bfloat16 [B,H,S,D], k_mask
    None or contiguous float32 [B, Sk]; else raises."""
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, k_mask, causal, scale)
    tag, mask, shape = _check(q, k, v, k_mask)
    B, H, Sq, Sk, D, Dv = shape
    out = torch.empty((B, H, Sq, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq, 2), dtype=torch.float32, device=q.device)
    if q.numel() == 0 or k.numel() == 0:
        return out, lse
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        FLASH_FWD.launch(f"flash_fwd_{tag}", _FWD_ARGS, q.data_ptr(),
                         k.data_ptr(), v.data_ptr(), mask, out.data_ptr(),
                         lse.data_ptr(), *shape, float(scale), int(causal),
                         stream)
    return out, lse


def flash_attention_bwd(q, k, v, k_mask, out, lse, dout, causal=False,
                        scale=1.0):
    """Attention backward from the forward's ``out`` and ``lse``; see
    :func:`flash_attention_bwd_reference`.  On the card ``dout`` must
    match q's dtype, ``out`` and ``lse`` the forward's; launches the dQ
    kernel and the dK/dV kernel, or raises."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, k_mask, out, lse,
                                             dout, causal, scale)
    tag, mask, shape = _check(q, k, v, k_mask,
                              (("out", out), ("lse", lse), ("dout", dout)))
    B, H, Sq, Sk, D, Dv = shape
    if dout.dtype != q.dtype or tuple(dout.shape) != (B, H, Sq, Dv) or \
            tuple(out.shape) != (B, H, Sq, Dv):
        raise ValueError(f"flash attention: dout / out must be {q.dtype} "
                         f"[{B}, {H}, {Sq}, {Dv}]")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, Sq, 2):
        raise ValueError(f"flash attention: lse must be float32 "
                         f"[{B}, {H}, {Sq}, 2]")
    delta = (dout.float() * out.float()).sum(dim=-1).contiguous()
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask,
              dout.data_ptr(), lse.data_ptr(), delta.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        FLASH_DQ.launch(f"flash_dq_{tag}", _DQ_ARGS, *common, dq.data_ptr(),
                        *shape, float(scale), int(causal), stream)
        FLASH_DKDV.launch(f"flash_dkdv_{tag}", _DKDV_ARGS, *common,
                          dk.data_ptr(), dv.data_ptr(), *shape, float(scale),
                          int(causal), stream)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """``(out, lse) = attention(q, k, v)`` under torch autograd: the
    forward kernel, and the dQ and dK/dV kernels on the saved ``out`` and
    ``lse`` (``setup_context`` form).  ``lse`` and the mask get no
    grad."""

    @staticmethod
    def forward(q, k, v, k_mask=None, causal=False, scale=1.0):
        return flash_attention_fwd(q, k, v, k_mask, causal, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, k_mask, causal, scale = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, k_mask, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, k_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, k_mask, out, lse, dout.to(q.dtype).contiguous(),
            ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None
