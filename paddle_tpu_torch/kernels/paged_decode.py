"""Paged decode attention: one query row per slot over the slot's
table-listed KV pages (the port of ``_paged_decode_kernel``,
``paddle_tpu/ops/attention_ops.py:980``).

:func:`paged_attention` launches the CUDA kernel of
``csrc/paged_decode.cu`` for tensors on the card and runs
:func:`paged_attention_reference`, the plain torch version, for tensors
on the CPU.  There is no gate on the head dim or the page length: any
``D <= 256`` runs the kernel.  The kernel splits each slot's rows
``[0, P * PL)`` into partitions of :data:`ROWS_PER_PART` rows, one block
each, and merges their partial softmax states in a second kernel when
there is more than one (:func:`paged_decode_partitions`).
"""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.kernels.build import CudaKernel

__all__ = ["PAGED_DECODE", "MAX_HEAD_DIM", "ROWS_PER_PART",
           "paged_attention", "paged_attention_reference",
           "paged_decode_partitions"]

PAGED_DECODE = CudaKernel("paged_decode", "paged_decode.cu",
                          replaces="paddle_tpu/ops/attention_ops.py:980")

#: largest head dim the kernel keeps in registers (8 values a lane)
MAX_HEAD_DIM = 256

#: rows of a slot's cache that one block of the kernel takes: 256, the
#: fastest of 32 … 1024 at the serving shape (one partition, no merge) and
#: over a long cache (``exp_torch_decode_kernels.py --rows-per-part``)
ROWS_PER_PART = 256
#: largest partition the kernel takes (its row indices in shared memory)
MAX_ROWS_PER_PART = 1024

#: additive mask of the plain version, as in the JAX package
NEG_INF = -1e9

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
             ctypes.c_float, _P]


def paged_decode_partitions(P, PL, rows_per_part=None):
    """``(rows_per_part, partitions)``: the kernel cuts the rows ``[0, P *
    PL)`` of each (slot, head) into ``ceil(P * PL / rows_per_part)``
    partitions (``rows_per_part`` :data:`ROWS_PER_PART` unless given),
    from the table's shape alone (the wrapper never reads ``lens``).
    With one partition the kernel writes ``out`` itself; with more, each
    writes a partial ``(m, l, acc[D])`` and a merge kernel combines
    them."""
    if rows_per_part is None:
        rows_per_part = ROWS_PER_PART
    if not 0 < rows_per_part <= MAX_ROWS_PER_PART:
        raise ValueError(f"paged_attention: rows_per_part must be in [1, "
                         f"{MAX_ROWS_PER_PART}], got {rows_per_part}")
    return rows_per_part, -(-(P * PL) // rows_per_part)


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
    q and pools, int32 page table and lens, contiguous) or raises; its
    partitions are :func:`paged_decode_partitions`'s."""
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
    D = HD // H
    R, parts = paged_decode_partitions(P, PL)
    out = torch.empty_like(q)
    if S == 0:
        return out
    # the partials: m and l of each (slot, head, partition), then acc[D]
    scratch = (torch.empty(S * H * parts * (D + 2), dtype=torch.float32,
                           device=q.device) if parts > 1 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        PAGED_DECODE.launch(
            "paged_decode_f32", _ARGTYPES,
            q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
            page_table.data_ptr(), lens.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            S, P, NP, PL, H, D, R, float(scale), stream)
    return out
