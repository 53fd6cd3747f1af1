"""The rules of the bias-softmax forward and the paged decode kernels that
the CPU can check: which body a bias-softmax row takes
(``bias_softmax_body``), how the paged decode cuts a slot's cache into
partitions (``paged_decode_partitions``), and the arithmetic of its
partitions and their merge, emulated in torch below as the kernel runs
it, against the plain version and the JAX package's paged attention (its
XLA route and its Pallas kernel in interpret mode).  The CUDA kernels
themselves are held against their plain versions in
``test_torch_cuda.py``.

Tolerance: float32 ``atol = rtol = 1e-5`` (different summation orders);
a dead slot (lens 0) must be the finite zero row of the 1e-30 floor in
the emulation, and is not compared with the others (nothing reads it)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import attention_ops as A
from paddle_tpu_torch.kernels.bias_softmax import (
    MAX_ROW, WARP_MAX_ROW, bias_softmax_body, bias_softmax_body_of)
from paddle_tpu_torch.kernels.paged_decode import (
    MAX_ROWS_PER_PART, ROWS_PER_PART, paged_attention_reference,
    paged_decode_partitions)

TOL = 1e-5
BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("Sk,dtype,aligned,want", [
    (256, BF16, True, ("warp_vector", 8, 1)),     # route A
    (256, F32, True, ("warp_vector", 4, 2)),      # serving, dense decode
    (8, F32, True, ("warp_vector", 4, 1)),
    (32, BF16, True, ("warp_vector", 8, 1)),
    (1000, BF16, True, ("warp_vector", 8, 4)),
    (1000, F32, True, ("warp_vector", 4, 8)),
    (1024, F32, True, ("warp_vector", 4, 8)),
    (250, BF16, True, ("warp_element", 1, 8)),    # not 16-byte pieces
    (250, F32, True, ("warp_element", 1, 8)),
    (256, BF16, False, ("warp_element", 1, 8)),   # off 16 bytes
    (1, F32, True, ("warp_element", 1, 1)),
    (7, BF16, True, ("warp_element", 1, 1)),
    (33, F32, True, ("warp_element", 1, 2)),
    (1023, BF16, True, ("warp_element", 1, 32)),
    (1025, BF16, True, ("block", 1, 0)),
    (2048, BF16, True, ("block", 1, 0)),
    (MAX_ROW, F32, False, ("block", 1, 0)),
])
def test_bias_softmax_body_by_shape(Sk, dtype, aligned, want):
    assert bias_softmax_body(Sk, dtype, aligned) == want


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_bias_softmax_body_covers_every_warp_row(dtype):
    """Every row up to ``WARP_MAX_ROW`` fits its lanes: ``kp`` pieces of
    ``vec`` values on each of 32 lanes hold the row, and half as many
    would not (``kp`` is the least power of two that does)."""
    for aligned in (False, True):
        for Sk in range(1, WARP_MAX_ROW + 1):
            body, vec, kp = bias_softmax_body(Sk, dtype, aligned)
            assert body.startswith("warp")
            assert Sk % vec == 0 and kp * 32 * vec >= Sk
            assert kp == 1 or (kp // 2) * 32 * vec < Sk
            assert kp * vec <= 32          # values a lane keeps
    assert bias_softmax_body(WARP_MAX_ROW + 1, dtype, True)[0] == "block"


def test_bias_softmax_body_of_reads_alignment():
    """A view that starts one element into its storage is off 16 bytes:
    its rows take the element body; the biases count too."""
    x = torch.zeros(2, 2, 4, 257, dtype=BF16).reshape(-1)[1:]
    x = x[:2 * 2 * 4 * 256].view(2, 2, 4, 256)
    assert bias_softmax_body_of(x)[0] == "warp_element"
    y = torch.zeros(2, 2, 4, 256, dtype=BF16)
    assert bias_softmax_body_of(y) == ("warp_vector", 8, 1)
    rb = torch.zeros(2 * 256 + 1)[1:].view(2, 256)
    assert bias_softmax_body_of(y, rb)[0] == "warp_element"


@pytest.mark.parametrize("P,PL,R,want", [
    (16, 16, ROWS_PER_PART, 1),   # serving's longest bucket
    (16, 16, 64, 4),
    (1, 16, 64, 1), (4, 16, 64, 1), (5, 16, 64, 2),
    (256, 16, 64, 64), (256, 16, ROWS_PER_PART, 16),   # the long cache
    (3, 8, 8, 3), (16, 16, 256, 1), (16, 16, 1024, 1), (1, 1, 1, 1),
    (7, 3, 5, 5),
])
def test_paged_partitions_by_cache_rows(P, PL, R, want):
    assert paged_decode_partitions(P, PL, R) == (R, want)


def test_paged_partitions_default_and_bounds():
    assert paged_decode_partitions(16, 16) == (ROWS_PER_PART,
                                               -(-256 // ROWS_PER_PART))
    for bad in (0, -1, MAX_ROWS_PER_PART + 1):
        with pytest.raises(ValueError):
            paged_decode_partitions(4, 16, bad)


def _paged_case(seed, S, H, D, PL, P, NP, lens):
    rng = np.random.RandomState(seed)
    q = rng.randn(S, H * D).astype("float32") * 0.4
    kc = rng.randn(NP, PL, H * D).astype("float32") * 0.4
    vc = rng.randn(NP, PL, H * D).astype("float32") * 0.4
    pt = rng.permutation(NP)[:S * P].reshape(S, P).astype("int32")
    return q, kc, vc, pt, np.asarray(lens, "int32").reshape(S, 1)


M_INIT = -1e30


def _split_merge(q, kc, vc, page_table, lens, H, scale, R):
    """The kernel's arithmetic in torch: each partition of ``R`` cache
    rows gives ``(m, l, acc)`` over its live rows (the empty state ``m =
    -1e30, l = 0`` where it has none); the merge weights each partition
    that saw a row by ``exp(m_p - M)`` and divides by the weighted ``l``
    floored at 1e-30."""
    S, P = page_table.shape
    NP, PL, HD = kc.shape
    D = HD // H
    T = P * PL
    _, parts = paged_decode_partitions(P, PL, R)
    n = lens.reshape(S).long().clamp(0, T)
    pool_row = (page_table.long().clamp(0, NP - 1)[:, :, None] * PL
                + torch.arange(PL)).reshape(S, T)
    k = kc.reshape(NP * PL, H, D)[pool_row]              # [S, T, H, D]
    v = vc.reshape(NP * PL, H, D)[pool_row]
    sc = torch.einsum("shd,sthd->sht", q.reshape(S, H, D), k) * scale
    m = torch.full((S, H, parts), M_INIT)
    l = torch.zeros(S, H, parts)
    acc = torch.zeros(S, H, parts, D)
    for p in range(parts):
        t0, t1 = p * R, min(p * R + R, T)
        live = (torch.arange(t0, t1)[None, :] < n[:, None])[:, None, :]
        s_p = sc[:, :, t0:t1].masked_fill(~live, -torch.inf)
        seen = live.any(-1)                                  # [S, 1]
        m[:, :, p] = torch.where(seen, s_p.amax(-1), M_INIT)
        e = torch.where(live, torch.exp(s_p - m[:, :, p, None]), 0.0)
        l[:, :, p] = e.sum(-1)
        acc[:, :, p] = torch.einsum("sht,sthd->shd", e, v[:, t0:t1])
    big = m.amax(-1, keepdim=True)
    w = torch.where(l > 0, torch.exp(m - big), 0.0)
    denom = (w * l).sum(-1).clamp_min(1e-30)
    out = (w[..., None] * acc).sum(2) / denom[..., None]
    return out.reshape(S, HD)


@pytest.mark.parametrize("R,P,PL", [(8, 6, 4), (8, 2, 4), (64, 5, 16),
                                    (ROWS_PER_PART, 17, 16), (5, 7, 3)])
def test_split_and_merge_match_plain_and_jax(R, P, PL):
    """lens 0, 1, R - 1, R, R + 1 and P * PL (clamped to the cache), on
    and around the partitions' edges, through the emulation, the plain
    version, the JAX package's XLA route and its Pallas kernel in
    interpret mode."""
    T, H, D = P * PL, 2, 8
    lens = [min(x, T) for x in (0, 1, R - 1, R, R + 1, T)]
    S = len(lens)
    case = _paged_case(R + P, S, H, D, PL, P, S * P + 3, lens)
    scale = float(D) ** -0.5
    tcase = [torch.from_numpy(a.copy()) for a in case]
    got = _split_merge(*tcase, H, scale, R).numpy()
    live = np.asarray(lens) > 0
    assert np.all(got[~live] == 0.0)       # the dead slot's zero row
    plain = paged_attention_reference(*tcase, H, scale).numpy()
    jcase = [jnp.asarray(a) for a in case]
    xla = np.asarray(A._xla_paged_attention(*jcase, H, scale))
    kernel = A._pallas_paged_attention(*jcase, H, scale, interpret=True)
    assert kernel is not None, "interpret kernel unexpectedly gated"
    for want in (plain, xla, np.asarray(kernel)):
        np.testing.assert_allclose(got[live], want[live], atol=TOL,
                                   rtol=TOL)


def test_split_and_merge_clamp_page_ids_as_plain_version():
    """Page ids outside ``[0, NP)`` read the clamped page in the
    emulation as in the plain version (the kernel clamps them too)."""
    case = _paged_case(3, 4, 2, 8, 4, 6, 30, [24, 9, 5, 1])
    case[3][0, 1], case[3][1, 0], case[3][2, 1] = -4, 30, 99
    tcase = [torch.from_numpy(a.copy()) for a in case]
    got = _split_merge(*tcase, 2, 0.35, 8).numpy()
    want = paged_attention_reference(*tcase, 2, 0.35).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
