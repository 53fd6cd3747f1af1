"""Single-pass attention for ``Sq == Sk``: a forward kernel and ONE
backward kernel for dQ, dK and dV (the ports of ``_smalls_fwd_kernel`` and
``_smalls_bwd_kernel``, ``paddle_tpu/ops/attention_ops.py:309`` and
``:327``, and of the same two bodies in ``exp_smalls_attn.py:48``, ``:74``).

:func:`smalls_attention_fwd` and :func:`smalls_attention_bwd` launch the
CUDA kernels of ``csrc/smalls_attention.cu`` for tensors on the card and
run their plain torch versions (``*_reference``) for tensors on the CPU.
They compute what the flash kernels compute, with the same ``(m, log l)``
residual ``[B, H, S, 2]``, in one pass over all S keys of a tile of query
rows (no online softmax), and round the probabilities and ``dS`` to the
operands' type before each product, where the reference casts them.
``delta = rowsum(dO * out)`` is a torch reduction outside the kernel, as
in the reference (``attention_ops.py:397``).  The bfloat16 pair runs on
the tensor cores (``mma.sync``), the float32 pair on the CUDA cores
(``csrc/single_pass_attention.cuh``).  The bfloat16 backward sums
``q . k`` and ``dO . v`` in another order than the plain version, so
``T(p)`` and ``T(dS)`` may round the other way where they lie near a bf16
rounding boundary: the card checks allow
``flash_attention.flash_backward_rounding_slack`` for it, the flash
backward's bound for the same function.

:func:`smalls_ok` is the dispatch rule that the attention op's forward
and grad lowerings share (the port of ``_smalls_group``): which shapes
take this pair instead of the flash kernels.
"""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.kernels.build import CudaKernel
from paddle_tpu_torch.kernels.flash_attention import (MAX_HEAD, _masked,
                                                      _scores)
from paddle_tpu_torch.kernels.flash_attention import _check as _check_qkv

__all__ = ["SMALLS_FWD", "SMALLS_BWD", "SMALLS_MAX_S", "smalls_ok",
           "fwd_rows_fit", "smalls_fwd_rows", "smalls_attention_fwd",
           "smalls_attention_bwd",
           "smalls_attention_fwd_reference",
           "smalls_attention_bwd_reference", "forward_rounding_slack",
           "SmallsAttentionFunction"]

SMALLS_FWD = CudaKernel("smalls_fwd", "smalls_attention.cu",
                        replaces="paddle_tpu/ops/attention_ops.py:309")
SMALLS_BWD = CudaKernel("smalls_bwd", "smalls_attention.cu",
                        replaces="paddle_tpu/ops/attention_ops.py:327")

#: longest sequence that takes the single-pass pair.  Set from
#: ``exp_torch_smalls_attn.py`` on an H100 (PERF.md has the rows): forward
#: + backward, the pair beats the flash kernels at S = 128 and 256 (by
#: 5-9%), ties them at 512 (-2% causal, +5% key-masked) and loses from
#: 1024 on (+24-29%): its one backward kernel is faster than the flash
#: pair at every S, its forward slower, and the forward's share grows
#: with S.
SMALLS_MAX_S = 512

#: shared memory a block may use on sm_90 (227 KB)
_MAX_SMEM = 232448
_KEY_TILE = 64

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SHAPE = [_I, _I, _I, _I, _I, _F, _I, _P]
_FWD_ARGS = [_P] * 6 + _SHAPE[:-1] + [_I, _P]
_BWD_ARGS = [_P] * 11 + _SHAPE


def _fwd_smem_bytes(rows16, S, D, Dv, bf16=False):
    """Shared memory of the forward kernel with ``16 * rows16`` query rows
    a block (``fwd_smem`` of ``csrc/single_pass_attention.cuh``).  The
    float32 body: the query tile, one k / v tile, the key bias and the
    rows' float32 scores.  The bfloat16 (tensor-core) body: the rows'
    float32 scores at a row stride of the padded keys + 8, two bf16 k / v
    tiles of 64 rows at the head width rounded up to 16, + 8, and the
    rows' partial maxima (one for each of the 4 warps of a row group),
    maxima and sums."""
    keys = -(-S // _KEY_TILE) * _KEY_TILE
    if bf16:
        width = -(-max(D, Dv) // 16) * 16
        return (4 * 16 * rows16 * (keys + 8) + 2 * 2 * _KEY_TILE * (width + 8)
                + 4 * (4 + 2) * 16 * rows16)
    return 4 * (16 * rows16 * (D + 1) + _KEY_TILE * (max(D, Dv) + 1) + keys
                + 16 * rows16 * (keys + 16))


def fwd_rows_fit(rows, S, D, Dv):
    """Whether a forward block can own ``rows`` (16, 32 or 64) query rows
    at this shape in either dtype: their scores against all S keys fit
    shared memory in the float32 body and in the bfloat16 one (whose sum
    fits wherever the float32 one does, so the float32 sum decides)."""
    return rows in (16, 32, 64) and max(
        _fwd_smem_bytes(rows // 16, S, D, Dv),
        _fwd_smem_bytes(rows // 16, S, D, Dv, bf16=True)) <= _MAX_SMEM


def smalls_fwd_rows(S, D, Dv):
    """Query rows a forward block owns at this shape: 32 where their
    score rows against all S keys fit a block's shared memory, else 16,
    or None when not even 16 fit.  64 rows reuse a key tile more but
    leave an SM fewer blocks to hide latency with, and measured slower
    than 32 at every S from 128 to 512 on an H100 (twice as slow at 512,
    where they leave one block an SM; ``exp_torch_smalls_attn.py``), so
    they are taken only when asked for."""
    for rows in (32, 16):
        if fwd_rows_fit(rows, S, D, Dv):
            return rows
    return None


def smalls_ok(BH, Sq, Sk, D, Dv=None):
    """Whether attention over ``BH`` (batch, head) pairs of ``[Sq, D]``
    queries and ``[Sk, D]`` / ``[Sk, Dv]`` keys and values takes the
    single-pass pair (else the flash kernels).  The forward and the grad
    lowering both ask this, on the same shapes, so a forward's residual is
    always read by the matching backward.

    The rule on the H100: self-attention shapes only (``Sq == Sk``: the
    backward walks one square of tiles); head widths up to the kernels'
    128; any S, ragged too, up to :data:`SMALLS_MAX_S`, which is measured
    (beyond it the flash kernels are faster) and lies well inside what
    the forward's shared memory holds (16 score rows of S keys: S <= 3072
    at D = 64).  ``BH`` does not enter: the grid has a block per pair (and
    per query tile in the forward), there is no grouping of pairs.
    """
    Dv = D if Dv is None else Dv
    return (BH > 0 and Sq == Sk and 0 < Sq <= SMALLS_MAX_S
            and 0 < D <= MAX_HEAD and 0 < Dv <= MAX_HEAD
            and smalls_fwd_rows(Sq, D, Dv) is not None)


# ---------------------------------------------------------------------------
# plain torch versions (the kernels' arithmetic and casts, step by step)
# ---------------------------------------------------------------------------

def smalls_attention_fwd_reference(q, k, v, k_mask=None, causal=False,
                                   scale=1.0, tensor_core=False):
    """``(out, lse)``: out [B,H,S,Dv] in q's dtype, lse [B,H,S,2] float32
    holding the row max ``m`` and ``log l`` apart.  Scores, max, exp and
    sum in float32; ``exp(s - m)`` is rounded to v's dtype before the
    product with v, which sums in float32.

    The scores are a float32 product of the widened operands, or with
    ``tensor_core`` (bfloat16 on the card) a bf16 matrix product with
    float32 sums: the same sums in another order, as the tensor cores
    take them.  The bf16 kernel sums in a third order, so its ``T(e)``
    may round a key's weight the other way where ``e`` lies near a bf16
    rounding boundary (:func:`forward_rounding_slack`)."""
    if tensor_core:
        B, H, Sq, D = q.shape
        Sk = k.shape[2]
        s = torch.bmm(q.reshape(B * H, Sq, D),
                      k.reshape(B * H, Sk, D).transpose(1, 2),
                      out_dtype=torch.float32).view(B, H, Sq, Sk)
        s = _masked(s * scale, k_mask, causal)
    else:
        s = _scores(q, k, k_mask, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    out = torch.matmul(e.to(v.dtype).float(), v.float()) / l
    return out.to(q.dtype), torch.cat([m, torch.log(l)], dim=-1)


def forward_rounding_slack(q, k, v, k_mask=None, causal=False, scale=1.0):
    """[B, H, S, Dv] float32: how far a bfloat16 forward whose float32
    sums run in another order may lie from
    :func:`smalls_attention_fwd_reference` through ``T(e)`` alone.

    Two float32 sums of ``q . k`` (exact bf16 products; tensor cores
    truncate their sums) differ by at most ``ds = scale D 2**-22
    sum_d |q_d k_d|`` with the scale's rounding; ``x = s - m`` then moves
    by ``ds`` plus the row's largest ``ds`` (the max) plus its own
    rounding, and ``exp`` adds ``2**-20``: ``e = exp(x)`` moves by a
    relative ``rho`` at most.  Where ``e (1 - rho)`` and ``e (1 + rho)``
    round to two bf16 values, ``T(e)`` may round either way, and the
    output moves by at most their gap times ``|v| / l`` for that key
    (``l`` sums the unrounded ``e``).  The slack sums that over a row's
    keys: zero unless a key lies that close to a rounding boundary."""
    s = _scores(q, k, k_mask, causal, scale)
    ds = torch.matmul(q.float().abs(), k.float().abs().transpose(-1, -2)) \
        * (abs(scale) * q.shape[-1] * 2.0 ** -22)
    x = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(x)
    rho = ds + ds.amax(dim=-1, keepdim=True) + x.abs() * 2.0 ** -23 \
        + 2.0 ** -20
    gap = (e * (1 + rho)).to(v.dtype).float() - \
        (e * (1 - rho)).to(v.dtype).float()
    return torch.matmul(gap, v.float().abs()) / e.sum(dim=-1, keepdim=True)


def smalls_attention_bwd_reference(q, k, v, k_mask, out, lse, dout,
                                   causal=False, scale=1.0):
    """``(dq, dk, dv)`` from the saved ``out`` and ``lse``, each in its
    primal's dtype.  ``p`` and ``dS`` are float32 and are rounded to the
    operands' dtype before each of the three products that take them."""
    s = _scores(q, k, k_mask, causal, scale)
    p = torch.exp((s - lse[..., 0:1]) - lse[..., 1:2])
    do = dout.float()
    delta = (do * out.float()).sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.to(dout.dtype).float().transpose(-1, -2), do)
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    ds = p * (dp - delta) * scale
    dq = torch.matmul(ds.to(k.dtype).float(), k.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(q, k, v, k_mask, others=()):
    """The flash wrappers' argument checks plus this pair's: ``Sq == Sk``
    and a sequence the forward's shared memory holds."""
    tag, mask, (B, H, Sq, Sk, D, Dv) = _check_qkv(
        q, k, v, k_mask, others, what="single-pass attention")
    if Sq != Sk:
        raise ValueError(f"single-pass attention: Sq {Sq} != Sk {Sk}")
    if smalls_fwd_rows(Sq, D, Dv) is None:
        raise ValueError(f"single-pass attention: S {Sq} at head widths "
                         f"{D}, {Dv} exceeds a block's shared memory")
    return tag, mask, (B, H, Sq, D, Dv)


def smalls_attention_fwd(q, k, v, k_mask=None, causal=False, scale=1.0,
                         rows=None):
    """Attention forward; see :func:`smalls_attention_fwd_reference`.  On
    the card: q, k, v contiguous float32 or bfloat16 [B,H,S,D] with one S,
    k_mask None or contiguous float32 [B, S]; else raises.  ``rows``
    (64, 32 or 16) overrides :func:`smalls_fwd_rows`, for measuring it."""
    if q.device.type == "cpu":
        return smalls_attention_fwd_reference(q, k, v, k_mask, causal, scale)
    tag, mask, shape = _check(q, k, v, k_mask)
    B, H, S, D, Dv = shape
    rows = smalls_fwd_rows(S, D, Dv) if rows is None else int(rows)
    out = torch.empty((B, H, S, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S, 2), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out, lse
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        SMALLS_FWD.launch(f"smalls_fwd_{tag}", _FWD_ARGS, q.data_ptr(),
                          k.data_ptr(), v.data_ptr(), mask, out.data_ptr(),
                          lse.data_ptr(), *shape, float(scale), int(causal),
                          rows // 16, stream)
    return out, lse


def _dq_scratch(q, pairs, S, D):
    """The float32 backward's dQ scratch ``[pairs, S, D]`` (its CUDA-core
    body sums a query tile's dQ over the key tiles there, a pair's slice
    touched by that pair's block only), or None: the bfloat16 body sums
    each dQ element in one thread's registers and takes no scratch."""
    if q.dtype != torch.float32:
        return None
    return torch.empty((pairs, S, D), dtype=torch.float32, device=q.device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def smalls_attention_bwd(q, k, v, k_mask, out, lse, dout, causal=False,
                         scale=1.0):
    """Attention backward from the forward's ``out`` and ``lse``; see
    :func:`smalls_attention_bwd_reference`.  On the card ``dout`` must
    match q's dtype, ``out`` and ``lse`` the forward's; launches the one
    backward kernel (bfloat16: the tensor-core body, whose key and query
    blocks share one launch; float32: the CUDA-core body with a float32
    dQ scratch), or raises."""
    if q.device.type == "cpu":
        return smalls_attention_bwd_reference(q, k, v, k_mask, out, lse,
                                              dout, causal, scale)
    tag, mask, shape = _check(q, k, v, k_mask,
                              (("out", out), ("lse", lse), ("dout", dout)))
    B, H, S, D, Dv = shape
    if dout.dtype != q.dtype or tuple(dout.shape) != (B, H, S, Dv) or \
            tuple(out.shape) != (B, H, S, Dv):
        raise ValueError(f"single-pass attention: dout / out must be "
                         f"{q.dtype} [{B}, {H}, {S}, {Dv}]")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, S, 2):
        raise ValueError(f"single-pass attention: lse must be float32 "
                         f"[{B}, {H}, {S}, 2]")
    delta = (dout.float() * out.float()).sum(dim=-1).contiguous()
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    dq_acc = _dq_scratch(q, B * H, S, D)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        SMALLS_BWD.launch(f"smalls_bwd_{tag}", _BWD_ARGS, q.data_ptr(),
                          k.data_ptr(), v.data_ptr(), mask, dout.data_ptr(),
                          lse.data_ptr(), delta.data_ptr(),
                          _ptr(dq_acc), dq.data_ptr(), dk.data_ptr(),
                          dv.data_ptr(), *shape, float(scale), int(causal),
                          stream)
    return dq, dk, dv


class SmallsAttentionFunction(torch.autograd.Function):
    """``(out, lse) = attention(q, k, v)`` under torch autograd: the
    forward kernel, and the one backward kernel on the saved ``out`` and
    ``lse`` (``setup_context`` form).  ``lse`` and the mask get no grad."""

    @staticmethod
    def forward(q, k, v, k_mask=None, causal=False, scale=1.0):
        return smalls_attention_fwd(q, k, v, k_mask, causal, scale)

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
        dq, dk, dv = smalls_attention_bwd(
            q, k, v, k_mask, out, lse, dout.to(q.dtype).contiguous(),
            ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None
