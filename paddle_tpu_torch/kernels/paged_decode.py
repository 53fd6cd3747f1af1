"""Paged decode attention: one query row per slot over the slot's
table-listed KV pages (the port of ``_paged_decode_kernel``,
``paddle_tpu/ops/attention_ops.py:980``).

:func:`paged_attention` launches the CUDA kernel of
``csrc/paged_decode.cu`` for tensors on the card and runs
:func:`paged_attention_reference`, the plain torch version, for tensors
on the CPU.  There is no gate on the head dim or the page length: any
``D <= 256`` runs the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.kernels.build import CudaKernel

__all__ = ["PAGED_DECODE", "MAX_HEAD_DIM", "paged_attention",
           "paged_attention_reference"]

PAGED_DECODE = CudaKernel("paged_decode", "paged_decode.cu",
                          replaces="paddle_tpu/ops/attention_ops.py:980")

#: largest head dim the kernel keeps in registers (8 values a lane)
MAX_HEAD_DIM = 256

#: additive mask of the plain version, as in the JAX package
NEG_INF = -1e9

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
             ctypes.c_float, _P]


def paged_attention_reference(q, kc, vc, page_table, lens, n_head, scale):
    """Plain torch version: gather the ``P`` table-listed pages of every
    slot, mask rows at or past ``lens``, softmax, weighted sum.

    q: [S, H*D]; kc/vc: [NP, PL, H*D]; page_table: [S, P] int;
    lens: [S, 1] (or [S]) int, rows INCLUDING the current token.
    Returns [S, H*D] in q's dtype.  A dead slot (``lens == 0``) gives a
    finite row that nothing reads."""
    S, P = page_table.shape
    NP, PL, HD = kc.shape
    H = int(n_head)
    D = HD // H
    T = P * PL
    pt = page_table.long().clamp(0, NP - 1)
    kg = kc[pt].reshape(S, T, H, D).float()
    vg = vc[pt].reshape(S, T, H, D).float()
    qh = q.reshape(S, H, D).float()
    sc = torch.einsum("shd,sthd->sht", qh, kg) * scale
    col = torch.arange(T, device=q.device).reshape(1, 1, T)
    sc = sc.masked_fill(col >= lens.reshape(S, 1, 1).long(), NEG_INF)
    probs = torch.softmax(sc, dim=-1)
    out = torch.einsum("sht,sthd->shd", probs, vg)
    return out.reshape(q.shape).to(q.dtype)


def _check(q, kc, vc, page_table, lens, n_head):
    S, HD = q.shape if q.ndim == 2 else (None, None)
    if S is None:
        raise ValueError(f"paged_attention: q must be [S, H*D], got "
                         f"{tuple(q.shape)}")
    for name, t in (("kc", kc), ("vc", vc), ("page_table", page_table),
                    ("lens", lens)):
        if t.device != q.device:
            raise ValueError(f"paged_attention: {name} on {t.device}, q on "
                             f"{q.device}")
    for name, t in (("q", q), ("kc", kc), ("vc", vc)):
        if t.dtype != torch.float32:
            raise TypeError(f"paged_attention: {name} must be float32, got "
                            f"{t.dtype}")
    for name, t in (("page_table", page_table), ("lens", lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"paged_attention: {name} must be int32, got "
                            f"{t.dtype}")
    if kc.ndim != 3 or kc.shape != vc.shape or kc.shape[2] != HD:
        raise ValueError(
            f"paged_attention: pools must be [NP, PL, {HD}] and equal, got "
            f"{tuple(kc.shape)} and {tuple(vc.shape)}")
    if page_table.ndim != 2 or page_table.shape[0] != S or \
            lens.numel() != S:
        raise ValueError(
            f"paged_attention: page_table must be [{S}, P] and lens hold "
            f"{S} values, got {tuple(page_table.shape)}, "
            f"{tuple(lens.shape)}")
    H = int(n_head)
    if H < 1 or HD % H or HD // H > MAX_HEAD_DIM:
        raise ValueError(
            f"paged_attention: H*D = {HD} with n_head {H} needs D = HD/H "
            f"an integer <= {MAX_HEAD_DIM}")
    for name, t in (("q", q), ("kc", kc), ("vc", vc),
                    ("page_table", page_table), ("lens", lens)):
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")


def paged_attention(q, kc, vc, page_table, lens, n_head, scale):
    """Decode attention over a paged KV pool; see
    :func:`paged_attention_reference` for the contract.  On the CPU it is
    the plain version; on the card it launches the CUDA kernel (float32
    q and pools, int32 page table and lens, contiguous) or raises."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, kc, vc, page_table, lens,
                                         n_head, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for device {q.device}")
    _check(q, kc, vc, page_table, lens, n_head)
    S, HD = q.shape
    P = page_table.shape[1]
    NP, PL, _ = kc.shape
    H = int(n_head)
    out = torch.empty_like(q)
    if S == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        PAGED_DECODE.launch(
            "paged_decode_f32", _ARGTYPES,
            q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
            page_table.data_ptr(), lens.data_ptr(), out.data_ptr(),
            S, P, NP, PL, H, HD // H, float(scale), stream)
    return out
