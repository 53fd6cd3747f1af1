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

Casts: the probabilities and ``dS`` are rounded to the operands' type
before each product, where the reference casts them (``T(p) . v``,
``T(p)^T . dO``, ``T(dS)^T . q``, ``T(dS) . k``); every sum is float32,
and in float32 every cast is the identity.  The bodies by dtype: float32
runs CUDA-core kernels for all three; bfloat16 runs all three on the
tensor cores (``flash_fwd_kernel_tc``, ``flash_dq_kernel_tc``,
``flash_dkdv_kernel_tc``: ``mma.sync``, bf16 operands, float32 sums).
Their sums run in other orders than the plain versions', so a bf16
``T(p)`` or ``T(dS)`` may round the other way near a rounding boundary
(:func:`flash_backward_rounding_slack`, and ``tiled`` of
:func:`flash_forward_rounding_slack`), and the forward rounds ``exp(s -
m)`` against the running max of its key tiles
(:func:`flash_forward_rounding_slack`; ``key_tile`` of
:func:`flash_attention_fwd_reference` computes it so).
"""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.kernels.build import CudaKernel

__all__ = ["FLASH_FWD", "FLASH_DQ", "FLASH_DKDV", "MAX_HEAD", "NEG_INF",
           "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_fwd_reference", "flash_attention_bwd_reference",
           "flash_attention_dq_reference", "flash_attention_dkdv_reference",
           "flash_forward_rounding_slack", "flash_backward_rounding_slack",
           "KEY_TILE",
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
#: keys a tile of the kernels' loops (``kTile`` in ``csrc``)
KEY_TILE = 64
#: the online softmax's initial running max (``_M_INIT`` of the reference)
_M_INIT = -1e30

_TAG = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SHAPE = [_I, _I, _I, _I, _I, _I, _F, _I, _P]
_FWD_ARGS = [_P] * 6 + _SHAPE
_DQ_ARGS = [_P] * 8 + _SHAPE
_DKDV_ARGS = [_P] * 9 + _SHAPE


# ---------------------------------------------------------------------------
# plain torch versions (the kernels' arithmetic and casts, step by step)
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
                                  scale=1.0, key_tile=None):
    """``(out, lse)``: out [B,H,Sq,Dv] in q's dtype, lse [B,H,Sq,2]
    float32 holding the row max ``m`` and ``log l`` apart.  Scores, max,
    exp and sum in float32; ``e = exp(s - m)`` is rounded to v's dtype
    before the product with v (``p.astype(v.dtype)``,
    ``attention_ops.py:122``), which sums in float32, and ``l`` sums the
    unrounded ``e``.

    ``key_tile`` None takes ``m`` over the whole row, as
    ``_reference_attention`` and the Pallas kernel at one key block do.
    An int walks the keys in tiles of that many, as the kernels do
    (``KEY_TILE`` on the card, the block size in the Pallas kernel): an
    online softmax whose ``e`` is taken against the running max of the
    tiles so far and rounded there, the sums rescaled as the max grows.
    In float32 the two differ by the rescaling's float32 rounding; in
    bfloat16 a key's weight is rounded at another scale wherever the
    running max grew after its tile (:func:`flash_forward_rounding_slack`).
    """
    out, m, l = _attend(_scores(q, k, k_mask, causal, scale), v, key_tile)
    return out.to(q.dtype), torch.cat([m, torch.log(l)], dim=-1)


def _attend(s, v, key_tile=None):
    """float32 ``(out, m, l)`` of the float32 scores ``s`` against ``v``:
    the arithmetic of :func:`flash_attention_fwd_reference` after its
    scores."""
    if key_tile is None:
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - m)
        l = e.sum(dim=-1, keepdim=True)
        return torch.matmul(e.to(v.dtype).float(), v.float()) / l, m, l
    m = torch.full_like(s[..., :1], _M_INIT)
    l = torch.zeros_like(m)
    acc = torch.zeros(*s.shape[:-1], v.shape[-1], device=s.device)
    for k0 in range(0, s.shape[-1], key_tile):
        st = s[..., k0:k0 + key_tile]
        m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        e = torch.exp(st - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + e.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(
            e.to(v.dtype).float(), v[..., k0:k0 + key_tile, :].float())
        m = m_new
    return acc / l, m, l


def _tile_maxima(s, key_tile):
    """Two [..., Sk] maps of the scores ``s`` over tiles of ``key_tile``
    keys, each key taking its tile's value: the running max over its
    tile and the tiles before it (what the kernel's online softmax takes
    its ``e`` against), and the largest score of the tiles after it
    (-inf in the last tile)."""
    tiles = s.split(key_tile, dim=-1)
    tmax = torch.stack([t.amax(dim=-1) for t in tiles], dim=-1)
    run = torch.cummax(tmax, dim=-1).values
    later = torch.cat([tmax.flip(-1).cummax(dim=-1).values.flip(-1)[..., 1:],
                       torch.full_like(tmax[..., :1], -float("inf"))],
                      dim=-1)
    sizes = [t.shape[-1] for t in tiles]
    expand = lambda x: torch.repeat_interleave(  # noqa: E731
        x, torch.tensor(sizes, device=s.device), dim=-1)
    return expand(run), expand(later)


def flash_forward_rounding_slack(q, k, v, k_mask=None, causal=False,
                                 scale=1.0, tiled=False):
    """[B, H, Sq, Dv] float32: how far a bfloat16 forward that walks the
    keys in tiles of :data:`KEY_TILE` (the kernel) may lie from
    :func:`flash_attention_fwd_reference` through the rounding of its
    weights ``T(e)`` alone.

    The kernel's score sums run in another order than the plain
    version's float32 product: a score moves by at most ``ds = scale D
    2**-22 sum_d |q_d k_d|`` (with the scale's rounding), ``x = s -
    m_t`` by ``ds``, the row's largest ``ds`` and its own rounding, and
    ``e = exp(x)`` by a relative ``rho`` at most
    (``smalls_attention.forward_rounding_slack``, the same bound).
    With ``tiled``, against the plain version that tiles as the kernel
    does (``key_tile`` = :data:`KEY_TILE`), both round ``e`` at one
    scale: ``T(e)`` may round the other way only where ``e (1 - rho)``
    and ``e (1 + rho)`` round apart, and the slack is that gap, carried
    to the row's final max, times ``|v| / l``, summed over the row's
    keys: zero unless a key lies that close to a rounding boundary.
    Else, against the row-max plain version, a key whose running max may
    still grow after its tile (a later tile holds a score within ``2
    ds`` of it) is rounded at another scale: its weight may differ by
    both roundings, ``2**-7 e``, plus ``2 rho e``; every other key by the
    gap as above."""
    s = _scores(q, k, k_mask, causal, scale)
    ds = torch.matmul(q.float().abs(), k.float().abs().transpose(-1, -2)) \
        * (abs(scale) * q.shape[-1] * 2.0 ** -22)
    ds_row = ds.amax(dim=-1, keepdim=True)
    m = s.amax(dim=-1, keepdim=True)
    run, later = _tile_maxima(s, KEY_TILE)
    m_t = run if tiled else m
    x = s - m_t
    e = torch.exp(x)
    rho = ds + ds_row + x.abs() * 2.0 ** -23 + 2.0 ** -20
    gap = (e * (1 + rho)).to(v.dtype).float() - \
        (e * (1 - rho)).to(v.dtype).float()
    # carried to the final max: the weights the output sums
    w = torch.exp(m_t - m)
    gap = gap * w
    if not tiled:
        rescaled = later > run - 2 * ds_row
        gap = torch.where(rescaled, (2.0 ** -7 + 2 * rho) * e, gap)
    return torch.matmul(gap, v.float().abs()) / (e * w).sum(dim=-1,
                                                             keepdim=True)


def flash_backward_rounding_slack(q, k, v, k_mask, out, lse, dout,
                                  causal=False, scale=1.0):
    """``(dq, dk, dv)`` float32 slacks in the primals' shapes: how far a
    bfloat16 backward whose float32 sums run in another order than the
    plain versions' may lie from :func:`flash_attention_bwd_reference`
    through the rounding of ``T(p)`` and ``T(dS)`` alone.

    A score moves by at most ``scale D 2**-22 sum_d |q_d k_d|`` and
    ``dO . v`` by ``Dv 2**-22 sum |dO v|`` (``delta`` alike, from ``|dO
    out|``); ``p = exp((s - m) - log l)`` then moves by a relative
    ``rho`` (those, the two subtractions' rounding and ``exp``'s
    ``2**-20``), and ``dS = p (dP - delta) scale`` by ``err = (p ddp +
    rho p |dP - delta|) |scale| + 2**-22 |dS|``.  Where ``dS - err`` and
    ``dS + err`` (``p (1 -+ rho)``) round to two bf16 values, ``T(dS)``
    (``T(p)``) may round either way; the slack is that gap times the
    other operand's magnitude, summed as the product sums it: zero unless
    a ``dS`` or ``p`` lies that close to a rounding boundary."""
    s = _scores(q, k, k_mask, causal, scale)
    qa, ka, va = (x.float().abs() for x in (q, k, v))
    do, o = dout.float(), out.float()
    ds_s = torch.matmul(qa, ka.transpose(-1, -2)) \
        * (abs(scale) * q.shape[-1] * 2.0 ** -22)
    x = s - lse[..., 0:1]
    y = x - lse[..., 1:2]
    p = torch.exp(y)
    rho = ds_s + (x.abs() + y.abs()) * 2.0 ** -23 + 2.0 ** -20
    r = torch.matmul(do, v.float().transpose(-1, -2)) - \
        (do * o).sum(dim=-1, keepdim=True)
    ddp = (torch.matmul(do.abs(), va.transpose(-1, -2))
           + (do * o).abs().sum(dim=-1, keepdim=True)) \
        * (v.shape[-1] * 2.0 ** -22)
    ds = p * r * scale
    err = (p * ddp + rho * p * r.abs()) * abs(scale) + ds.abs() * 2.0 ** -22
    gap_ds = (ds + err).to(k.dtype).float() - (ds - err).to(k.dtype).float()
    gap_p = (p * (1 + rho)).to(dout.dtype).float() - \
        (p * (1 - rho)).to(dout.dtype).float()
    return (torch.matmul(gap_ds, ka),
            torch.matmul(gap_ds.transpose(-1, -2), qa),
            torch.matmul(gap_p.transpose(-1, -2), do.abs()))


def _probs_and_dscores(q, k, v, k_mask, out, lse, dout, causal, scale):
    """float32 ``p``, ``dS`` and ``dO``, recomputed from the saved lse as
    each backward kernel recomputes them (``p`` unrounded in ``dS``, as
    at ``attention_ops.py:174`` and ``:214``)."""
    s = _scores(q, k, k_mask, causal, scale)
    p = torch.exp((s - lse[..., 0:1]) - lse[..., 1:2])
    do = dout.float()
    delta = (do * out.float()).sum(dim=-1, keepdim=True)
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    return p, p * (dp - delta) * scale, do


def flash_attention_dq_reference(q, k, v, k_mask, out, lse, dout,
                                 causal=False, scale=1.0):
    """Plain version of the dQ kernel: ``dq = T(dS) . k`` in q's dtype,
    ``dS`` rounded to k's dtype first (``ds.astype(k.dtype)``,
    ``attention_ops.py:222``)."""
    _, ds, _ = _probs_and_dscores(q, k, v, k_mask, out, lse, dout, causal,
                                  scale)
    return torch.matmul(ds.to(k.dtype).float(), k.float()).to(q.dtype)


def flash_attention_dkdv_reference(q, k, v, k_mask, out, lse, dout,
                                   causal=False, scale=1.0):
    """Plain version of the dK/dV kernel: ``dv = T(p)^T . dO`` and ``dk =
    T(dS)^T . q`` in v's and k's dtypes, ``p`` rounded to dO's dtype and
    ``dS`` to q's first (``attention_ops.py:171`` and ``:181``)."""
    p, ds, do = _probs_and_dscores(q, k, v, k_mask, out, lse, dout, causal,
                                   scale)
    dv = torch.matmul(p.to(dout.dtype).float().transpose(-1, -2), do)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
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
