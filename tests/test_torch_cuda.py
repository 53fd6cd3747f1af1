"""The PyTorch port's CUDA kernels on the card, each against its plain
torch version on the same inputs.  They need an NVIDIA GPU and ``nvcc``
and skip elsewhere, naming what was found; this file imports neither JAX
nor the JAX package, so it runs on a machine with the card alone:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerance: float32 ``atol = rtol = 1e-5`` (the kernels and their plain
versions sum in different orders); bfloat16 outputs one bf16 rounding of
the same float32 value, ``rtol = 2**-7`` (one ulp of the value) plus
``2**-8`` times the output's RMS for elements near zero (see
``_assert_matches``); the bfloat16 single-pass forward, whose tensor
cores sum the scores in another order, also within each element's
rounding-flip slack of the float32-product plain version and within one
rounding of the tensor-core-summed one (``_assert_forward_matches``);
the bfloat16 flash forward within one rounding plus its slack of the
row-max plain version and of the one that tiles as the kernel does, and
the bfloat16 backward bodies (tensor cores: the flash dQ and dK/dV, the
single-pass backward in both layouts) within one rounding plus the
rounding-flip slack of ``T(p)`` and ``T(dS)``
(``_assert_flash_forward_matches``, ``_assert_backward_matches``; the
slacks are zero unless a value lies near a bf16 rounding boundary or,
for the row-max forward, the running max grew after a key's tile); a
dead paged slot (lens 0) is compared for
finiteness only, as nothing reads it; the float32 3x3 conv sums 9 * C
products in another order than its plain version and is held to
``kernels.conv3x3.f32_tolerance``; the bfloat16 3x3 conv (tensor cores:
the products of bf16 values are exact in float32, only the order of the
sums differs) to one rounding, ``_assert_matches``."""

import ctypes

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels.bshd_attention import (
    BSHD_BWD, BSHD_FWD, BshdAttentionFunction, bshd_attention_bwd,
    bshd_attention_bwd_reference, bshd_attention_fwd,
    bshd_attention_fwd_reference, bshd_attn, bshd_max_s)
from paddle_tpu_torch.kernels.conv3x3 import (
    CONV3X3, conv3x3_bn_act, conv3x3_bn_act_reference, f32_tolerance,
    fold_batch_norm)
from paddle_tpu_torch.kernels.bias_softmax import (
    BIAS_SOFTMAX, BIAS_SOFTMAX_GRAD, MAX_ROW, bias_softmax,
    bias_softmax_body, bias_softmax_body_of, bias_softmax_grad,
    bias_softmax_grad_reference, bias_softmax_reference)
from paddle_tpu_torch.kernels.flash_attention import (
    FLASH_DKDV, FLASH_DQ, FLASH_FWD, KEY_TILE, flash_attention_bwd,
    flash_attention_bwd_reference, flash_attention_fwd,
    flash_attention_fwd_reference, flash_backward_rounding_slack,
    flash_forward_rounding_slack)
from paddle_tpu_torch.kernels.paged_decode import (
    PAGED_DECODE, ROWS_PER_PART, paged_attention, paged_attention_reference,
    paged_decode_partitions)
from paddle_tpu_torch.kernels.smalls_attention import (
    SMALLS_BWD, SMALLS_FWD, SmallsAttentionFunction, forward_rounding_slack,
    smalls_attention_bwd, smalls_attention_bwd_reference,
    smalls_attention_fwd, smalls_attention_fwd_reference)
from paddle_tpu_torch.ops import attention_ops

TOL = 1e-5


def _assert_matches(got, want):
    """float32 within ``TOL``; bfloat16 within one rounding of itself."""
    assert torch.isfinite(got).all()
    g, w = got.float(), want.float()
    if got.dtype == torch.bfloat16:
        rms = float(w.square().mean().sqrt())
        torch.testing.assert_close(g, w, atol=2.0 ** -8 * rms,
                                   rtol=2.0 ** -7)
    else:
        torch.testing.assert_close(g, w, atol=TOL, rtol=TOL)


def _bf16_tolerance(want):
    """One bf16 rounding of ``want`` (see the module's docstring)."""
    w = want.float()
    return 2.0 ** -8 * float(w.square().mean().sqrt()) + 2.0 ** -7 * w.abs()


def _assert_forward_matches(out, want, q, k, v, mask, causal, scale):
    """A single-pass forward's ``out`` [B, H, S, Dv] against ``want``,
    its plain version on the same [B, H, S, D] inputs (views of another
    layout will do).  float32 within ``TOL``.  bfloat16 (the tensor-core
    body, whose score sums run in another order than the plain
    version's float32 product) within one rounding plus each element's
    rounding-flip slack (``forward_rounding_slack``), and within one
    rounding of the plain version with tensor-core-summed scores."""
    if out.dtype != torch.bfloat16:
        _assert_matches(out, want)
        return
    assert torch.isfinite(out).all()
    slack = forward_rounding_slack(q, k, v, mask, causal, scale)
    err = (out.float() - want.float()).abs()
    assert (err <= _bf16_tolerance(want) + slack).all()
    _assert_matches(out, smalls_attention_fwd_reference(
        q, k, v, mask, causal, scale, tensor_core=True)[0])


def _assert_flash_forward_matches(out, want, q, k, v, mask, causal, scale):
    """The flash forward's ``out`` against ``want``, its row-max plain
    version.  float32 within ``TOL``.  bfloat16 (``e`` taken against the
    running max of 64-key tiles and rounded there) within one rounding
    plus ``flash_forward_rounding_slack`` of ``want``, and of the plain
    version that tiles as the kernel does plus the slack of the score
    sums' order alone."""
    if out.dtype != torch.bfloat16:
        _assert_matches(out, want)
        return
    assert torch.isfinite(out).all()
    args = (q, k, v, mask, causal, scale)
    tiled = flash_attention_fwd_reference(*args, key_tile=KEY_TILE)[0]
    for ref, slack in (
            (want, flash_forward_rounding_slack(*args)),
            (tiled, flash_forward_rounding_slack(*args, tiled=True))):
        err = (out.float() - ref.float()).abs()
        assert (err <= _bf16_tolerance(ref) + slack).all()


def _assert_backward_matches(grads, wants, args):
    """dq, dk, dv against their plain versions: float32 within ``TOL``;
    bfloat16 (the tensor-core bodies) within one rounding plus
    ``flash_backward_rounding_slack(*args)``.  ``args`` are the
    backward's ``(q, k, v, mask, out, lse, dout, causal, scale)`` in
    ``[B, H, S, .]``, ``grads`` and ``wants`` in the same layout (views of
    ``[B, S, H, .]`` tensors transposed to it will do)."""
    if grads[0].dtype != torch.bfloat16:
        for a, b in zip(grads, wants):
            _assert_matches(a, b)
        return
    for a, b, slack in zip(grads, wants,
                           flash_backward_rounding_slack(*args)):
        assert torch.isfinite(a).all()
        err = (a.float() - b.float()).abs()
        assert (err <= _bf16_tolerance(b) + slack).all()


def _paged_case(seed, S=4, H=2, D=8, PL=8, P=3, NP=16, lens=None):
    """Live prefixes spanning page boundaries, one row, and a dead slot."""
    rng = np.random.RandomState(seed)
    q = rng.randn(S, H * D).astype("float32") * 0.4
    kc = rng.randn(NP, PL, H * D).astype("float32") * 0.4
    vc = rng.randn(NP, PL, H * D).astype("float32") * 0.4
    pt = rng.permutation(NP)[:S * P].reshape(S, P).astype("int32")
    if lens is None:
        lens = [20, 8, 1, 0]
    lens = np.asarray(lens, "int32").reshape(S, 1)
    return q, kc, vc, pt, lens


def _torch(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def _softmax_case(seed, B=2, H=2, Sq=16, Sk=24):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, Sq, Sk).astype("float32")
    row = np.where(rng.rand(B, Sk) < 0.3, -1e9, 0.0).astype("float32")
    return x, row


def _flash_case(seed, B, H, Sq, Sk, D, Dv):
    """q/k/v/dO with a padded key row and a batch row with every key
    masked."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, Sq, D).astype("float32") * 0.3
    k = rng.randn(B, H, Sk, D).astype("float32") * 0.3
    v = rng.randn(B, H, Sk, Dv).astype("float32") * 0.3
    mask = np.ones((B, Sk), "float32")
    mask[0, -5:] = 0.0
    mask[-1] = 0.0
    g = rng.randn(B, H, Sq, Dv).astype("float32")
    return q, k, v, mask, g


@pytest.fixture()
def cuda_toolchain():
    nvcc = build.find_nvcc()
    if not torch.cuda.is_available() or nvcc is None:
        pytest.skip(f"needs an NVIDIA GPU and nvcc: "
                    f"torch.cuda.is_available()={torch.cuda.is_available()}"
                    f", nvcc={nvcc or 'not found'}, torch {torch.__version__}"
                    f" (CUDA {torch.version.cuda})")
    build.build_all()
    return nvcc


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 2, 4, 8, 16])
def test_paged_kernel_matches_plain_version_on_card(cuda_toolchain, P):
    PL = 16
    lens = [min(n, P * PL) for n in (0, 1, PL, 2 * PL, P * PL,
                                     P * PL - 1, PL + 1, P * PL // 2)]
    case = [t.cuda() for t in _torch(*_paged_case(
        P, S=8, H=2, D=16, PL=PL, P=P, NP=128, lens=lens))]
    before = PAGED_DECODE.launches
    got = paged_attention(*case, 2, 0.25)
    want = paged_attention_reference(*case, 2, 0.25)
    assert PAGED_DECODE.launches == before + 1
    live = case[4].reshape(-1) > 0
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[live], want[live], atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [8, 64, 256])
def test_bias_softmax_kernel_matches_plain_version_on_card(cuda_toolchain,
                                                           T, dtype):
    x, row = _softmax_case(T, B=2, H=2, Sq=T, Sk=T)
    row[0] = -1e9                           # a row with every key masked
    tri = np.triu(np.full((T, T), -1e9, "float32"), 1)[None]
    x = torch.from_numpy(x).to(getattr(torch, dtype)).cuda()
    row, tri = torch.from_numpy(row).cuda(), torch.from_numpy(tri).cuda()
    # the training path's two cases (a row bias, the decoder's causal
    # plane) and both together
    for args in ((x, row, None), (x, None, tri), (x, row, tri)):
        before = BIAS_SOFTMAX.launches
        got = bias_softmax(*args)
        assert BIAS_SOFTMAX.launches == before + 1
        assert got.dtype == x.dtype
        _assert_matches(got, bias_softmax_reference(*args))


def _masks(seed, B, Sq, Sk):
    """A padding row bias whose batch row 0 masks every key, and a
    causal plane per batch row (the last Sq of Sk keys) with padding."""
    rng = np.random.RandomState(seed)
    row = np.where(rng.rand(B, Sk) < 0.3, -1e9, 0.0).astype("float32")
    row[0] = -1e9
    tri = np.triu(np.full((Sq, Sk), -1e9, "float32"), 1 + max(Sk - Sq, 0))
    pad = np.where(rng.rand(B, 1, Sk) < 0.2, -1e9, 0.0).astype("float32")
    return row, (tri[None] + pad).astype("float32")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sk", [1, 7, 31, 32, 33, 256, 1000, 1024, 1025,
                                8192])
def test_bias_softmax_bodies_on_card(cuda_toolchain, Sk, dtype):
    """Each forward body (warp rows by 16-byte pieces or by elements, block
    rows above 1024) against its plain version: a row bias and a causal
    plane, each per batch row and shared (batch stride 0), and both
    together.  A batch row whose keys are all masked gives the uniform
    row.  float32 within ``TOL``, bfloat16 within one rounding
    (``_assert_matches``)."""
    B, H, Sq = 2, 2, 5
    x, _ = _softmax_case(Sk, B=B, H=H, Sq=Sq, Sk=Sk)
    row, tri = _masks(Sk, B, Sq, Sk)
    x = torch.from_numpy(x).to(getattr(torch, dtype)).cuda()
    row, tri = torch.from_numpy(row).cuda(), torch.from_numpy(tri).cuda()
    body = bias_softmax_body_of(x, row, tri)[0]
    assert body == ("block" if Sk > 1024 else "warp_vector"
                    if Sk % (16 // x.element_size()) == 0
                    else "warp_element")
    for args in ((x, row, None), (x, row[1:], None), (x, None, tri),
                 (x, None, tri[:1]), (x, row, tri)):
        before = BIAS_SOFTMAX.launches
        got = bias_softmax(*args)
        assert BIAS_SOFTMAX.launches == before + 1
        assert got.dtype == x.dtype
        _assert_matches(got, bias_softmax_reference(*args))
    got = bias_softmax(x, row, None)[0].float()     # every key masked
    torch.testing.assert_close(got, torch.full_like(got, 1.0 / Sk),
                               atol=TOL, rtol=2.0 ** -7)


@pytest.mark.cuda
def test_bias_softmax_body_rule_is_the_kernels_on_card(cuda_toolchain):
    """``bias_softmax_body`` states the rule of ``pick_body`` in
    ``csrc/bias_softmax.cu``: the two agree on every row length, dtype
    and alignment."""
    fn = build.load_library("bias_softmax.cu").bias_softmax_pick_body
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    vec, kp = ctypes.c_int(), ctypes.c_int()
    for dtype in (torch.float32, torch.bfloat16):
        size = torch.tensor([], dtype=dtype).element_size()
        for aligned in (0, 1):
            for Sk in range(1, MAX_ROW + 1):
                warp = fn(Sk, size, aligned, ctypes.byref(vec),
                          ctypes.byref(kp))
                body, v, k = bias_softmax_body(Sk, dtype, bool(aligned))
                assert (body != "block") == bool(warp), (Sk, dtype)
                if warp:
                    assert (vec.value, kp.value) == (v, k), (Sk, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,x_off,bias_off", [
    ("bfloat16", 1, 0), ("bfloat16", 3, 0), ("bfloat16", 0, 1),
    ("float32", 1, 0), ("float32", 2, 0), ("float32", 0, 3)])
def test_bias_softmax_unaligned_views_on_card(cuda_toolchain, dtype, x_off,
                                              bias_off):
    """Scores or biases that start off 16 bytes (contiguous views at an
    odd offset) take the element body and match the plain version."""
    x, _ = _softmax_case(9, B=2, H=2, Sq=8, Sk=256)
    row, tri = _masks(9, 2, 8, 256)
    xc = _placed(x, x_off, getattr(torch, dtype))
    rowc = _placed(row, bias_off, torch.float32)
    tric = _placed(tri, bias_off, torch.float32)
    for args in ((xc, rowc, None), (xc, None, tric)):
        assert bias_softmax_body_of(*args)[0] == "warp_element"
        _assert_matches(bias_softmax(*args), bias_softmax_reference(*args))


def _paged_on_card(case, H, D):
    """Kernel against plain version; the dead slots are the zero row."""
    case = [t.cuda() for t in _torch(*case)]
    scale = float(D) ** -0.5
    before = PAGED_DECODE.launches
    got = paged_attention(*case, H, scale)
    assert PAGED_DECODE.launches == before + 1     # one count a call
    want = paged_attention_reference(*case, H, scale)
    live = case[4].reshape(-1) > 0
    assert torch.isfinite(got).all()
    assert torch.equal(got[~live], torch.zeros_like(got[~live]))
    torch.testing.assert_close(got[live], want[live], atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [12, 40])
@pytest.mark.parametrize("D", [16, 24, 64, 128, 256])
def test_paged_kernel_partitions_on_card(cuda_toolchain, D, P):
    """lens on and around the partitions' edges, a dead slot, and page
    ids outside the pool (clamped, as the plain version gathers them),
    over one partition (12 pages of 16) and three (40 pages, merged)."""
    PL, H, R = 16, 2, ROWS_PER_PART
    T = P * PL
    assert paged_decode_partitions(P, PL)[1] == -(-T // R)
    lens = [min(x, T) for x in (0, 1, R - 1, R, R + 1, 2 * R, T - 1, T)]
    case = list(_paged_case(D, S=8, H=H, D=D, PL=PL, P=P, NP=8 * P + 4,
                            lens=lens))
    case[3][1, 0], case[3][6, 2], case[3][7, P - 1] = -5, 8 * P + 11, -1
    _paged_on_card(case, H, D)


@pytest.mark.cuda
@pytest.mark.parametrize("D,offset", [(10, 0), (3, 0), (16, 1), (128, 2)])
def test_paged_kernel_scalar_loads_on_card(cuda_toolchain, D, offset):
    """A head width that is no multiple of 4, or pools that start off 16
    bytes, take the scalar loads."""
    PL, P, H = 8, 10, 3
    lens = [0, 1, 63, 64, 65, 80]
    q, kc, vc, pt, ln = _paged_case(D + offset, S=6, H=H, D=D, PL=PL, P=P,
                                    NP=64, lens=lens)
    placed = [_placed(a, offset, torch.float32) for a in (q, kc, vc)]
    scale = float(D) ** -0.5
    tail = [t.cuda() for t in _torch(pt, ln)]
    got = paged_attention(*placed, *tail, H, scale)
    want = paged_attention_reference(*placed, *tail, H, scale)
    live = tail[1].reshape(-1) > 0
    assert torch.equal(got[~live], torch.zeros_like(got[~live]))
    torch.testing.assert_close(got[live], want[live], atol=TOL, rtol=TOL)


@pytest.mark.cuda
def test_wrappers_raise_on_arguments_the_kernels_do_not_take(
        cuda_toolchain):
    case = [t.cuda() for t in _torch(*_paged_case(2))]
    with pytest.raises(TypeError):
        paged_attention(case[0].double(), *case[1:], 2, 0.3)
    with pytest.raises(ValueError):
        paged_attention(case[0], case[1][:, :, :8].contiguous(), *case[2:],
                        2, 0.3)
    x = torch.randn(1, 2, 4, 8, device="cuda")
    with pytest.raises(ValueError):
        bias_softmax(x.transpose(2, 3), None, None)
    with pytest.raises(TypeError):
        bias_softmax(x.double(), None, None)


def _cuda(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype).cuda() for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("ydt", ["float32", "bfloat16"])
@pytest.mark.parametrize("dydt", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sk", [24, 256, 8192])
def test_bias_softmax_grad_kernel_matches_plain_version_on_card(
        cuda_toolchain, ydt, dydt, Sk):
    rng = np.random.RandomState(Sk)
    y = torch.softmax(torch.from_numpy(
        rng.randn(2, 2, 3, Sk).astype("float32")), -1)
    y = y.to(getattr(torch, ydt)).cuda()
    dy = torch.from_numpy(rng.randn(2, 2, 3, Sk).astype("float32"))
    dy = dy.to(getattr(torch, dydt)).cuda()
    before = BIAS_SOFTMAX_GRAD.launches
    got = bias_softmax_grad(y, dy)
    assert BIAS_SOFTMAX_GRAD.launches == before + 1
    want = bias_softmax_grad_reference(y, dy)
    assert got.dtype == y.dtype
    _assert_matches(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal", [
    ((2, 2, 40, 40, 16, 16), False), ((2, 2, 100, 100, 64, 64), True),
    ((1, 2, 96, 48, 16, 16), False), ((1, 1, 37, 130, 128, 96), False),
    ((2, 8, 256, 256, 64, 64), True), ((2, 4, 513, 257, 128, 128), True),
    ((2, 3, 70, 200, 40, 24), False), ((1, 2, 90, 75, 20, 36), True),
    ((8, 8, 2048, 2048, 64, 64), True), ((8, 8, 2048, 2048, 64, 64), False)])
def test_flash_kernels_match_plain_versions_on_card(cuda_toolchain, dtype,
                                                    shape, causal):
    """The trio at ragged, cross-attention and route B's shapes, head
    widths 16 to 128 (both builds of the bf16 backward bodies; rows of
    20 and 36 bf16 not on 16 bytes: element copies), a padded key row
    and a batch row with every key masked."""
    B, H, Sq, Sk, D, Dv = shape
    q, k, v, mask, g = _flash_case(Sq, B, H, Sq, Sk, D, Dv)
    dt = getattr(torch, dtype)
    tq, tk, tv, tg = _cuda(q, k, v, g, dtype=dt)
    tm = torch.from_numpy(mask).cuda()
    before = (FLASH_FWD.launches, FLASH_DQ.launches, FLASH_DKDV.launches)
    out, lse = flash_attention_fwd(tq, tk, tv, tm, causal, D ** -0.5)
    grads = flash_attention_bwd(tq, tk, tv, tm, out, lse, tg, causal,
                                D ** -0.5)
    torch.cuda.synchronize()
    assert (FLASH_FWD.launches, FLASH_DQ.launches, FLASH_DKDV.launches) == \
        tuple(n + 1 for n in before)
    want = flash_attention_fwd_reference(tq, tk, tv, tm, causal, D ** -0.5)
    args = (tq, tk, tv, tm, out, lse, tg, causal, D ** -0.5)
    _assert_flash_forward_matches(out, want[0], tq, tk, tv, tm, causal,
                                  D ** -0.5)
    torch.testing.assert_close(lse, want[1], atol=1e-5, rtol=1e-6)
    _assert_backward_matches(grads,
                                   flash_attention_bwd_reference(*args),
                                   args)


def _placed(x, offset, dtype):
    """``x`` on the card as a contiguous tensor that starts ``offset``
    elements into its storage."""
    t = torch.from_numpy(x).to(dtype).cuda().reshape(-1)
    buf = torch.empty(t.numel() + offset, dtype=dtype, device=t.device)
    buf[offset:] = t
    return buf[offset:].view(x.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,first_key_off,offset", [
    ((2, 2, 100, 100, 40, 40), False, False, 0),     # W = 64, D off 16
    ((2, 2, 100, 100, 40, 40), True, True, 1),       # rows off 16 bytes
    ((2, 4, 256, 256, 64, 64), True, True, 0),
    ((2, 3, 77, 300, 64, 64), False, False, 0),      # Sq != Sk, ragged
    ((1, 2, 300, 77, 64, 64), True, False, 0),
    ((2, 2, 200, 130, 128, 128), False, False, 0),   # W = 128
    ((2, 2, 130, 200, 128, 96), True, True, 1),
    ((2, 2, 70, 70, 20, 36), True, True, 0)])        # element copies
def test_flash_bf16_forward_tensor_core_body_on_card(
        cuda_toolchain, shape, causal, first_key_off, offset):
    """The bfloat16 forward (``flash_fwd_kernel_tc``) at both builds:
    head widths 20 to 128, Sq != Sk with ragged tails, rows not on 16
    bytes (element copies), causal with key 0 off (rows whose causal
    window is fully masked: the all-masked vote walks past the
    diagonal), a padded key row and a batch row with every key off; out
    within ``_assert_flash_forward_matches``' two readings, the
    residual to its float32 round-off."""
    B, H, Sq, Sk, D, Dv = shape
    q, k, v, mask, _ = _flash_case(Sq + Sk, B, H, Sq, Sk, D, Dv)
    if first_key_off:
        mask[:, 0] = 0.0
    tq, tk, tv = (_placed(x, offset, torch.bfloat16) for x in (q, k, v))
    tm = torch.from_numpy(mask).cuda()
    before = FLASH_FWD.launches
    out, lse = flash_attention_fwd(tq, tk, tv, tm, causal, D ** -0.5)
    torch.cuda.synchronize()
    assert FLASH_FWD.launches == before + 1
    want = flash_attention_fwd_reference(tq, tk, tv, tm, causal, D ** -0.5)
    _assert_flash_forward_matches(out, want[0], tq, tk, tv, tm, causal,
                                  D ** -0.5)
    torch.testing.assert_close(lse, want[1], atol=1e-5, rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_flash_forward_bodies_by_dtype_on_card(cuda_toolchain, causal):
    """float32 runs the CUDA-core forward (``flash_fwd_kernel<float>``)
    and bfloat16 the tensor-core one (``flash_fwd_kernel_tc``), each once
    a call; the float32 output is the CUDA-core body's, the same bits
    on every call and within ``TOL`` of the plain version."""
    from torch.profiler import ProfilerActivity, profile
    q, k, v, mask, _ = _flash_case(3, 2, 2, 150, 150, 64, 64)
    tm = torch.from_numpy(mask).cuda()
    names = {}
    for dtype in (torch.float32, torch.bfloat16):
        tq, tk, tv = _cuda(q, k, v, dtype=dtype)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out, _ = flash_attention_fwd(tq, tk, tv, tm, causal, 0.125)
            torch.cuda.synchronize()
        names[dtype] = [
            e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "flash_fwd_kernel" in e.name]
        if dtype == torch.float32:
            again, _ = flash_attention_fwd(tq, tk, tv, tm, causal, 0.125)
            assert torch.equal(out, again)
            _assert_matches(out, flash_attention_fwd_reference(
                tq, tk, tv, tm, causal, 0.125)[0])
    assert len(names[torch.float32]) == 1
    assert "_tc" not in names[torch.float32][0]
    assert len(names[torch.bfloat16]) == 1
    assert "flash_fwd_kernel_tc" in names[torch.bfloat16][0]


@pytest.mark.cuda
def test_flash_and_softmax_grad_wrappers_raise_on_bad_arguments(
        cuda_toolchain):
    q = torch.randn(1, 2, 8, 16, device="cuda")
    with pytest.raises(TypeError):
        flash_attention_fwd(q.double(), q.double(), q.double())
    with pytest.raises(ValueError):
        flash_attention_fwd(q.transpose(2, 3), q, q)
    with pytest.raises(ValueError):
        wide = torch.randn(1, 2, 8, 192, device="cuda")
        flash_attention_fwd(wide, wide, wide)
    with pytest.raises(ValueError):
        flash_attention_fwd(q, q, q, torch.ones(1, 8, device="cuda").half())
    y = torch.rand(2, 8, device="cuda")
    with pytest.raises(TypeError):
        bias_softmax_grad(y.double(), y.double())
    with pytest.raises(ValueError):
        bias_softmax_grad(y, y[:, :4].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal,first_key_off", [
    ((2, 4, 128, 16, 16), False, False), ((2, 4, 128, 16, 16), True, True),
    ((2, 2, 200, 64, 64), True, False), ((1, 2, 37, 128, 96), False, False),
    ((2, 8, 512, 64, 64), True, True), ((2, 8, 512, 64, 64), False, False),
    ((1, 2, 1024, 64, 64), True, False), ((1, 1, 2000, 64, 64), True, True)])
def test_single_pass_kernels_match_plain_versions_on_card(
        cuda_toolchain, dtype, shape, causal, first_key_off):
    """The forward and the one backward kernel, at 32 and 16 query rows a
    forward block (S up to 1024; 2000), ragged S, unequal head widths,
    and rows whose causal window is fully key-masked
    (``first_key_off``)."""
    B, H, S, D, Dv = shape
    q, k, v, mask, g = _flash_case(S, B, H, S, S, D, Dv)
    if first_key_off:
        mask[:, 0] = 0.0
    dt = getattr(torch, dtype)
    tq, tk, tv, tg = _cuda(q, k, v, g, dtype=dt)
    tm = torch.from_numpy(mask).cuda()
    before = (SMALLS_FWD.launches, SMALLS_BWD.launches)
    out, lse = smalls_attention_fwd(tq, tk, tv, tm, causal, D ** -0.5)
    grads = smalls_attention_bwd(tq, tk, tv, tm, out, lse, tg, causal,
                                 D ** -0.5)
    torch.cuda.synchronize()
    assert (SMALLS_FWD.launches, SMALLS_BWD.launches) == \
        tuple(n + 1 for n in before)
    want = smalls_attention_fwd_reference(tq, tk, tv, tm, causal, D ** -0.5)
    wgrads = smalls_attention_bwd_reference(tq, tk, tv, tm, out, lse, tg,
                                            causal, D ** -0.5)
    _assert_forward_matches(out, want[0], tq, tk, tv, tm, causal, D ** -0.5)
    torch.testing.assert_close(lse, want[1], atol=1e-5, rtol=1e-6)
    _assert_backward_matches(grads, wgrads, (tq, tk, tv, tm, out, lse, tg,
                                             causal, D ** -0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [16, 32, 64])
def test_single_pass_forward_at_each_row_count_on_card(cuda_toolchain, rows):
    q, k, v, mask, _ = _flash_case(rows, 2, 2, 300, 300, 64, 64)
    tq, tk, tv = _cuda(q, k, v, dtype=torch.bfloat16)
    tm = torch.from_numpy(mask).cuda()
    out, lse = smalls_attention_fwd(tq, tk, tv, tm, True, 0.125, rows=rows)
    want = smalls_attention_fwd_reference(tq, tk, tv, tm, True, 0.125)
    _assert_forward_matches(out, want[0], tq, tk, tv, tm, True, 0.125)
    torch.testing.assert_close(lse, want[1], atol=1e-5, rtol=1e-6)
    with pytest.raises(RuntimeError, match="invalid"):
        smalls_attention_fwd(tq, tk, tv, tm, True, 0.125, rows=48)


@pytest.mark.cuda
def test_single_pass_attention_under_torch_autograd_on_card(cuda_toolchain):
    q, k, v, mask, g = _flash_case(5, 2, 2, 96, 96, 32, 32)
    tq, tk, tv, tg = _cuda(q, k, v, g)
    tm = torch.from_numpy(mask).cuda()
    leaves = [t.requires_grad_() for t in (tq, tk, tv)]
    out, lse = SmallsAttentionFunction.apply(*leaves, tm, True, 0.2)
    got = torch.autograd.grad(out, leaves, tg)
    want = smalls_attention_bwd_reference(tq, tk, tv, tm, out.detach(), lse,
                                          tg, True, 0.2)
    for a, b in zip(got, want):
        _assert_matches(a, b)


@pytest.mark.cuda
def test_single_pass_wrappers_raise_on_bad_arguments(cuda_toolchain):
    q = torch.randn(1, 2, 8, 16, device="cuda")
    with pytest.raises(ValueError, match="Sq 8 != Sk 4"):
        smalls_attention_fwd(q, q[:, :, :4].contiguous(),
                             q[:, :, :4].contiguous())
    with pytest.raises(TypeError):
        smalls_attention_fwd(q.half(), q.half(), q.half())
    long = torch.randn(1, 1, 4096, 16, device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        smalls_attention_fwd(long, long, long)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,offset", [
    ((2, 2, 77, 12, 20), 0),        # widths off 8: element copies
    ((2, 4, 130, 64, 64), 1),       # rows off 16 bytes: element copies
    ((1, 2, 300, 96, 96), 0), ((1, 2, 200, 128, 128), 0)])
def test_single_pass_forward_tile_copies_on_card(cuda_toolchain, shape,
                                                 offset):
    """The bfloat16 forward's tiles come by 16-byte ``cp.async`` where
    every row starts on 16 bytes and the widths are multiples of 8, else
    by element copies; both give the plain version's output (causal and
    key-masked, a batch row fully masked)."""
    B, H, S, D, Dv = shape
    q, k, v, mask, _ = _flash_case(S + offset, B, H, S, S, D, Dv)
    tq, tk, tv = (_placed(x, offset, torch.bfloat16) for x in (q, k, v))
    tm = torch.from_numpy(mask).cuda()
    for causal in (False, True):
        out, lse = smalls_attention_fwd(tq, tk, tv, tm, causal, 0.15)
        want = smalls_attention_fwd_reference(tq, tk, tv, tm, causal, 0.15)
        _assert_forward_matches(out, want[0], tq, tk, tv, tm, causal, 0.15)
        torch.testing.assert_close(lse, want[1], atol=1e-5, rtol=1e-6)


@pytest.mark.cuda
def test_top_k_orders_ties_on_card(cuda_toolchain):
    """``top_k`` on the card: tied values lowest index first, as on the
    CPU and in ``lax.top_k``."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import registry
    d = {"blocks": [{"idx": 0, "parent_idx": -1, "vars": [
        {"name": "x", "shape": [3, 5], "dtype": "float32",
         "persistable": False},
        {"name": "out", "shape": None, "dtype": "float32"},
        {"name": "idx", "shape": None, "dtype": "int64"}],
        "ops": [{"type": "top_k", "inputs": {"X": ["x"]},
                 "outputs": {"Out": ["out"], "Indices": ["idx"]},
                 "attrs": {"k": 3}}]}]}
    block = pt.Program.from_dict(d).global_block()
    x = torch.tensor([[1, 3, 3, 2, 3], [0.5] * 5, [4, 4, 1, 9, 4]])
    got = {}
    for dev in ("cpu", "cuda"):
        env = {"x": x.to(dev)}
        registry.run_lowering(block.ops[0], env, block,
                              aux={"device": torch.device(dev)})
        got[dev] = (env["out"].cpu(), env["idx"].cpu())
    assert got["cuda"][1].tolist() == [[1, 2, 4], [0, 1, 2], [3, 0, 1]]
    for a, b in zip(got["cuda"], got["cpu"]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,use_flash", [(64, False), (256, True)])
@pytest.mark.parametrize("causal", [False, True])
def test_unfused_route_on_card(cuda_toolchain, dtype, D, use_flash, causal):
    """The unfused route (``use_flash=False``, or D over the kernels'
    128) on the card against itself on the CPU (the plain bias-softmax):
    float32 to 1e-5, bfloat16 to one rounding.  Its softmax runs the
    bias-softmax kernels and no attention kernel."""
    B, H, Sq, Sk = 2, 2, 48, 48 if causal else 80
    q, k, v, mask, g = _flash_case(D + causal, B, H, Sq, Sk, D, D)
    dt = getattr(torch, dtype)
    fwd, bwd = attention_ops.attention_kernels(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        use_flash)
    assert (fwd, bwd) == (attention_ops.unfused_attention_fwd,
                          attention_ops.unfused_attention_bwd)
    cpu = [torch.from_numpy(x).to(dt) for x in (q, k, v, g)]
    card = [x.cuda() for x in cpu]
    cm = torch.from_numpy(mask)
    kernels = (BIAS_SOFTMAX, BIAS_SOFTMAX_GRAD, SMALLS_FWD, SMALLS_BWD,
               FLASH_FWD, FLASH_DQ, FLASH_DKDV)
    before = [kern.launches for kern in kernels]
    out, lse = fwd(*card[:3], cm.cuda(), causal, D ** -0.5)
    grads = bwd(*card[:3], cm.cuda(), None, None, card[3], causal,
                D ** -0.5)
    torch.cuda.synchronize()
    assert lse is None
    assert [kern.launches - n for kern, n in zip(kernels, before)] == \
        [2, 1, 0, 0, 0, 0, 0]
    want_out, _ = fwd(*cpu[:3], cm, causal, D ** -0.5)
    want = bwd(*cpu[:3], cm, None, None, cpu[3], causal, D ** -0.5)
    for a, b in zip((out, *grads), (want_out, *want)):
        assert a.dtype == dt
        _assert_matches(a.cpu(), b)


# ---------------------------------------------------------------------------
# the single-pass pair in the [B, S, H, D] layout
# ---------------------------------------------------------------------------

def _bshd_case(seed, B, S, H, D, first_key_off=False):
    """q/k/v/dO [B, S, H, D] at unit variance; a key mask with a tenth of
    the keys off and the last batch row fully masked (or, with
    ``first_key_off``, key 0 off in every row: rows whose causal window
    is fully masked)."""
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(B, S, H, D).astype("float32") for _ in range(4))
    mask = (rng.rand(B, S) > 0.1).astype("float32")
    if first_key_off:
        mask[:, 0] = 0.0
    else:
        mask[-1] = 0.0
    return q, k, v, mask, g


def _assert_bshd_backward_matches(grads, wants, args):
    """``_assert_backward_matches`` on the head-transposed views of the
    [B, S, H, D] grads and of the backward's arguments ``(q, k, v, mask,
    out, res, dout, causal, scale)``."""
    q, k, v, mask, out, res, dout, causal, scale = args
    heads = [x.transpose(1, 2) for x in (q, k, v, out, res, dout)]
    _assert_backward_matches(
        [x.transpose(1, 2) for x in grads], [x.transpose(1, 2) for x in wants],
        (*heads[:3], mask, *heads[3:], causal, scale))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask_dtype", ["float32", "q"])
@pytest.mark.parametrize("shape,causal", [
    ((2, 33, 3, 8), False), ((2, 33, 3, 8), True),
    ((2, 200, 8, 64), True), ((3, 256, 8, 64), False),
    ((1, 97, 2, 128), True), ((1, 1000, 4, 64), False)])
def test_bshd_kernels_match_plain_versions_on_card(
        cuda_toolchain, dtype, mask_dtype, shape, causal):
    """The forward and the one backward kernel at odd and ragged S, head
    widths 8 to 128, rows with every key masked (key-masked: a whole
    batch row; causal: key 0 off), the mask in float32 or in q's dtype
    (as the original passes it)."""
    B, S, H, D = shape
    q, k, v, mask, g = _bshd_case(S, B, S, H, D, first_key_off=causal)
    dt = getattr(torch, dtype)
    tq, tk, tv, tg = _cuda(q, k, v, g, dtype=dt)
    tm = torch.from_numpy(mask).to(
        dt if mask_dtype == "q" else torch.float32).cuda()
    before = (BSHD_FWD.launches, BSHD_BWD.launches)
    out, res = bshd_attention_fwd(tq, tk, tv, tm, causal, D ** -0.5)
    grads = bshd_attention_bwd(tq, tk, tv, tm, out, res, tg, causal,
                               D ** -0.5)
    torch.cuda.synchronize()
    assert (BSHD_FWD.launches, BSHD_BWD.launches) == \
        tuple(n + 1 for n in before)
    assert out.shape == res.shape[:3] + (D,) and res.shape[3] == 2
    want = bshd_attention_fwd_reference(tq, tk, tv, tm, causal, D ** -0.5)
    wgrads = bshd_attention_bwd_reference(tq, tk, tv, tm, out, res, tg,
                                          causal, D ** -0.5)
    _assert_forward_matches(*(x.transpose(1, 2) for x in (
        out, want[0], tq, tk, tv)), tm, causal, D ** -0.5)
    torch.testing.assert_close(res, want[1], atol=1e-5, rtol=1e-6)
    _assert_bshd_backward_matches(grads, wgrads, (tq, tk, tv, tm, out, res,
                                                  tg, causal, D ** -0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_bshd_pair_equals_the_bhsd_pair_on_card(cuda_toolchain, dtype,
                                                causal):
    """One arithmetic in two layouts: the [B, S, H, D] kernels give, bit
    for bit, what the [B, H, S, D] single-pass kernels give on the
    transposed tensors (the same sums in the same order; only the
    addresses differ)."""
    B, S, H, D = 2, 150, 4, 32
    q, k, v, mask, g = _bshd_case(7, B, S, H, D, first_key_off=causal)
    dt = getattr(torch, dtype)
    tq, tk, tv, tg = _cuda(q, k, v, g, dtype=dt)
    tm = torch.from_numpy(mask).cuda()
    out, res = bshd_attention_fwd(tq, tk, tv, tm, causal, 0.2)
    grads = bshd_attention_bwd(tq, tk, tv, tm, out, res, tg, causal, 0.2)

    def heads_first(x):
        return x.transpose(1, 2).contiguous()

    hq, hk, hv, hg = (heads_first(x) for x in (tq, tk, tv, tg))
    hout, lse = smalls_attention_fwd(hq, hk, hv, tm, causal, 0.2)
    hgrads = smalls_attention_bwd(hq, hk, hv, tm, hout, lse, hg, causal,
                                  0.2)
    torch.cuda.synchronize()
    assert torch.equal(out, heads_first(hout))
    assert torch.equal(res, heads_first(lse))
    for a, b in zip(grads, hgrads):
        assert torch.equal(a, heads_first(b))


@pytest.mark.cuda
def test_bshd_attention_under_torch_autograd_on_card(cuda_toolchain):
    q, k, v, mask, g = _bshd_case(5, 2, 96, 3, 32)
    tq, tk, tv, tg = _cuda(q, k, v, g, dtype=torch.bfloat16)
    tm = torch.from_numpy(mask).to(torch.bfloat16).cuda()
    leaves = [t.requires_grad_() for t in (tq, tk, tv)]
    out = bshd_attn(*leaves, tm, True, 0.2)
    got = torch.autograd.grad(out, leaves, tg)
    _, res = BshdAttentionFunction.apply(*leaves, tm, True, 0.2)
    args = (*(t.detach() for t in (tq, tk, tv)), tm, out.detach(), res, tg,
            True, 0.2)
    _assert_bshd_backward_matches(got, bshd_attention_bwd_reference(*args),
                                  args)


@pytest.mark.cuda
def test_bshd_wrappers_raise_on_bad_arguments(cuda_toolchain):
    q = torch.randn(1, 8, 2, 16, device="cuda")
    with pytest.raises(ValueError, match="one \\[B, S, H, D\\] shape"):
        bshd_attention_fwd(q, q[:, :4].contiguous(), q)
    with pytest.raises(TypeError):
        bshd_attention_fwd(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="contiguous"):
        t = q.transpose(1, 2).contiguous().transpose(1, 2)
        bshd_attention_fwd(t, t, t)
    for bad in (torch.ones(1, 8, dtype=torch.int32, device="cuda"),
                torch.ones(1, 8, dtype=torch.float16, device="cuda"),
                torch.ones(1, 7, device="cuda")):
        with pytest.raises(ValueError, match="k_mask"):
            bshd_attention_fwd(q, q, q, bad)
    S = bshd_max_s(16) + 1
    long = torch.randn(1, S, 1, 16, device="cuda")
    with pytest.raises(ValueError, match=f"exceeds the {S - 1} keys"):
        bshd_attention_fwd(long, long, long)


# ---------------------------------------------------------------------------
# the single-pass backward by dtype, in both layouts
# ---------------------------------------------------------------------------

def _single_pass_backward(layout, q, k, v, mask, g, causal, scale):
    """Forward and backward through the layout's wrappers on ``[B, S, H,
    .]`` (``bshd``) or ``[B, H, S, .]`` (``bhsd``) tensors on the card:
    ``(grads, plain grads, the backward's args, its kernel)``."""
    if layout == "bhsd":
        out, lse = smalls_attention_fwd(q, k, v, mask, causal, scale)
        args = (q, k, v, mask, out, lse, g, causal, scale)
        return (smalls_attention_bwd(*args),
                smalls_attention_bwd_reference(*args), args, SMALLS_BWD)
    out, res = bshd_attention_fwd(q, k, v, mask, causal, scale)
    args = (q, k, v, mask, out, res, g, causal, scale)
    return (bshd_attention_bwd(*args), bshd_attention_bwd_reference(*args),
            args, BSHD_BWD)


_BF16_BACKWARD_CASES = [
    # (B, S, H, D, Dv, causal, first_key_off): head widths 16 to 128,
    # ragged S, rows whose causal window is fully masked
    (2, 128, 4, 16, 16, True, True), (2, 256, 4, 64, 64, False, False),
    (1, 300, 2, 96, 96, True, False), (1, 200, 2, 128, 128, False, False),
    (2, 200, 2, 64, 64, True, True), (2, 512, 8, 64, 64, True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout,case", [
    (layout, case) for layout in ("bhsd", "bshd")
    for case in _BF16_BACKWARD_CASES] + [
    ("bhsd", (1, 130, 2, 64, 32, False, False)),     # Dv != D
    ("bhsd", (1, 97, 2, 32, 128, True, True))])
def test_single_pass_bf16_backward_on_card(cuda_toolchain, layout, case):
    """The bfloat16 backward (the tensor-core body, one launch) against
    its plain version within one rounding plus
    ``flash_backward_rounding_slack``, in both layouts (on the
    head-transposed views for [B, S, H, D]); a key mask with a batch row
    fully masked, or key 0 off (causal)."""
    B, S, H, D, Dv, causal, first_key_off = case
    rng = np.random.RandomState(S + D)
    shape = (B, H, S) if layout == "bhsd" else (B, S, H)
    q, k = (rng.randn(*shape, D).astype("float32") for _ in range(2))
    v, g = (rng.randn(*shape, Dv).astype("float32") for _ in range(2))
    mask = (rng.rand(B, S) > 0.1).astype("float32")
    if first_key_off:
        mask[:, 0] = 0.0
    else:
        mask[-1] = 0.0
    tq, tk, tv, tg = _cuda(q, k, v, g, dtype=torch.bfloat16)
    tm = torch.from_numpy(mask).cuda()
    scale = D ** -0.5
    kernel = SMALLS_BWD if layout == "bhsd" else BSHD_BWD
    before = kernel.launches
    grads, wants, args, _ = _single_pass_backward(layout, tq, tk, tv, tm, tg,
                                                  causal, scale)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    if layout == "bhsd":
        _assert_backward_matches(grads, wants, args)
    else:
        _assert_bshd_backward_matches(grads, wants, args)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("causal", [False, True])
def test_single_pass_float32_backward_unchanged_on_card(cuda_toolchain,
                                                        layout, causal):
    """The float32 backward stays on the CUDA-core body: within ``TOL``
    (1e-5) of its plain version at route C's head width, S 512 and a
    ragged 200, key-masked (a batch row fully masked) and causal with key
    0 off."""
    for B, S, H in ((2, 512, 8), (2, 200, 4)):
        q, k, v, mask, g = _bshd_case(S + causal, B, S, H, 64,
                                      first_key_off=causal)
        if layout == "bhsd":
            q, k, v, g = (np.ascontiguousarray(x.transpose(0, 2, 1, 3))
                          for x in (q, k, v, g))
        tq, tk, tv, tg = _cuda(q, k, v, g)
        tm = torch.from_numpy(mask).cuda()
        grads, wants, _, _ = _single_pass_backward(layout, tq, tk, tv, tm,
                                                   tg, causal, 0.125)
        for a, b in zip(grads, wants):
            assert a.dtype == torch.float32
            torch.testing.assert_close(a, b, atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_single_pass_bf16_backward_takes_no_scratch_on_card(
        cuda_toolchain, monkeypatch, layout):
    """The wrappers pass the backward kernel a float32 dQ scratch in
    float32 only: a bfloat16 call passes NULL (the tensor-core body sums
    each dQ element in registers), read from the launch's arguments."""
    kernel = SMALLS_BWD if layout == "bhsd" else BSHD_BWD
    seen = []
    launch = kernel.launch

    def spy(symbol, argtypes, *args):
        seen.append((symbol, args[7]))     # q k v mask dout lse delta dq_acc
        return launch(symbol, argtypes, *args)

    monkeypatch.setattr(kernel, "launch", spy)
    q, k, v, mask, g = _bshd_case(3, 2, 96, 2, 32)
    if layout == "bhsd":
        q, k, v, g = (np.ascontiguousarray(x.transpose(0, 2, 1, 3))
                      for x in (q, k, v, g))
    tm = torch.from_numpy(mask).cuda()
    for dtype in (torch.bfloat16, torch.float32):
        tq, tk, tv, tg = _cuda(q, k, v, g, dtype=dtype)
        grads, wants, args, _ = _single_pass_backward(layout, tq, tk, tv, tm,
                                                      tg, True, 0.2)
        torch.cuda.synchronize()
        if layout == "bhsd":
            _assert_backward_matches(grads, wants, args)
        else:
            _assert_bshd_backward_matches(grads, wants, args)
    (sym16, acc16), (sym32, acc32) = seen
    assert sym16.endswith("_bf16") and acc16 is None
    assert sym32.endswith("_f32") and acc32 is not None


# ---------------------------------------------------------------------------
# the 3x3 conv + folded batch norm + ReLU kernel
# ---------------------------------------------------------------------------

def _conv3x3_case(seed, N, H, C, Co, dtype):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(N, H, H, C).astype("float32"))
    w = torch.from_numpy((rng.randn(3, 3, C, Co) * (2.0 / (9 * C)) ** 0.5)
                         .astype("float32"))
    scale = torch.from_numpy(rng.rand(Co).astype("float32") + 0.5)
    bias = torch.from_numpy(rng.randn(Co).astype("float32") * 0.1)
    return (x.to(dtype).cuda(), w.to(dtype).cuda(), scale.cuda(),
            bias.cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", [(2, 9, 24, 40), (4, 7, 512, 512)],
                         ids=["small", "stage4"])
def test_conv3x3_kernel_matches_plain_version_on_card(cuda_toolchain, shape,
                                                      relu, dtype):
    """A small ragged case (9x9 pixels, channels no multiple of the
    kernel's tiles) and ResNet-50's last stage (7x7x512 -> 512)."""
    x, w, scale, bias = _conv3x3_case(7, *shape, getattr(torch, dtype))
    before = CONV3X3.launches
    got = conv3x3_bn_act(x, w, scale, bias, relu)
    torch.cuda.synchronize()
    assert CONV3X3.launches == before + 1
    want = conv3x3_bn_act_reference(x, w, scale, bias, relu)
    assert got.dtype == x.dtype and got.shape == want.shape
    if dtype == "bfloat16":
        _assert_matches(got, want)
    else:
        assert torch.isfinite(got).all()
        assert bool(((got - want).abs() <= f32_tolerance(x, w, scale)).all())


def _conv3x3_ragged(seed, N, H, W, C, Co, dtype, offset=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, H, W, C).astype("float32")
    w = (rng.randn(3, 3, C, Co) * (2.0 / (9 * C)) ** 0.5).astype("float32")
    scale = torch.from_numpy(rng.rand(Co).astype("float32") + 0.5).cuda()
    bias = torch.from_numpy(rng.randn(Co).astype("float32") * 0.1).cuda()
    return (_placed(x, offset, dtype), _placed(w, 0, dtype), scale, bias)


#: N a pixel size, enough that the N * H * W pixel rows span images and
#: end inside a block's tile of 128 or 256 rows
_CONV_HW = {(1, 1): 300, (9, 9): 5, (7, 13): 4}


@pytest.mark.cuda
@pytest.mark.parametrize("hw", sorted(_CONV_HW), ids=lambda hw: "%dx%d" % hw)
@pytest.mark.parametrize("Co", [8, 40, 72])
@pytest.mark.parametrize("C", [3, 20, 24])
def test_conv3x3_bf16_tensor_core_body_ragged_on_card(cuda_toolchain, C, Co,
                                                      hw):
    """The bfloat16 body (``conv3x3_kernel_tc``) at the edges it guards:
    C = 3 and 20 (x's rows no 16-byte pieces: element copies), 24 (a
    chunk of 32 channels part zeros), Co = 8 and 40 (the 256 x 64 tile
    part empty) and 72 (the 128 x 128 tile), 1x1 images (only the centre
    tap), pixel rows spanning images; ReLU on and off, within one
    rounding."""
    H, W = hw
    x, w, scale, bias = _conv3x3_ragged(C * Co + H, _CONV_HW[hw], H, W, C,
                                        Co, torch.bfloat16)
    for relu in (True, False):
        before = CONV3X3.launches
        got = conv3x3_bn_act(x, w, scale, bias, relu)
        torch.cuda.synchronize()
        assert CONV3X3.launches == before + 1
        _assert_matches(got, conv3x3_bn_act_reference(x, w, scale, bias,
                                                      relu))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(56, 64, 64), (28, 128, 128),
                                   (14, 256, 256), (7, 512, 512)],
                         ids=["56x56x64", "28x28x128", "14x14x256",
                              "7x7x512"])
def test_conv3x3_bf16_resnet50_shapes_on_card(cuda_toolchain, shape):
    """ResNet-50's four 3x3 bodies at N = 2, both block tiles (256 x 64
    for Co = 64, 128 x 128 beyond), ReLU on and off."""
    H, C, Co = shape
    x, w, scale, bias = _conv3x3_case(H + C, 2, H, C, Co, torch.bfloat16)
    for relu in (True, False):
        got = conv3x3_bn_act(x, w, scale, bias, relu)
        torch.cuda.synchronize()
        _assert_matches(got, conv3x3_bn_act_reference(x, w, scale, bias,
                                                      relu))


@pytest.mark.cuda
@pytest.mark.parametrize("C,Co,offset", [(64, 64, 2), (20, 36, 0)])
def test_conv3x3_bf16_element_copies_on_card(cuda_toolchain, C, Co, offset):
    """x a view that starts 2 elements (4 bytes) into its storage, and Co
    = 36 (rows of w and out no 16-byte pieces), run on the kernel's
    element copies: one launch, within one rounding."""
    x, w, scale, bias = _conv3x3_ragged(11, 3, 9, 9, C, Co,
                                        torch.bfloat16, offset=offset)
    assert x.storage_offset() == offset and x.is_contiguous()
    before = CONV3X3.launches
    got = conv3x3_bn_act(x, w, scale, bias)
    torch.cuda.synchronize()
    assert CONV3X3.launches == before + 1
    _assert_matches(got, conv3x3_bn_act_reference(x, w, scale, bias))


@pytest.mark.cuda
def test_conv3x3_bodies_by_dtype_on_card(cuda_toolchain):
    """float32 runs the CUDA-core body (``conv3x3_kernel``), the
    same bits on every call and within ``f32_tolerance`` of the plain
    version; bfloat16 the tensor-core one (``conv3x3_kernel_tc``)."""
    from torch.profiler import ProfilerActivity, profile
    names = {}
    for dtype in (torch.float32, torch.bfloat16):
        x, w, scale, bias = _conv3x3_case(12, 2, 14, 64, 96, dtype)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            got = conv3x3_bn_act(x, w, scale, bias)
            torch.cuda.synchronize()
        names[dtype] = [
            e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "conv3x3_kernel" in e.name]
        if dtype == torch.float32:
            assert torch.equal(got, conv3x3_bn_act(x, w, scale, bias))
            want = conv3x3_bn_act_reference(x, w, scale, bias)
            assert bool(((got - want).abs()
                         <= f32_tolerance(x, w, scale)).all())
    assert len(names[torch.float32]) == 1
    assert "_tc" not in names[torch.float32][0]
    assert len(names[torch.bfloat16]) == 1
    assert "conv3x3_kernel_tc" in names[torch.bfloat16][0]


@pytest.mark.cuda
def test_conv3x3_entry_points_by_dtype_on_card(cuda_toolchain, monkeypatch):
    """The wrapper calls ``conv3x3_bn_act_bf16`` for bfloat16 and
    ``conv3x3_bn_act_f32`` for float32, once a call, and nothing else."""
    calls = []
    monkeypatch.setattr(CONV3X3, "launch",
                        lambda symbol, argtypes, *args: calls.append(symbol))
    for dtype in (torch.bfloat16, torch.float32):
        conv3x3_bn_act(*_conv3x3_case(13, 1, 7, 16, 8, dtype))
    assert calls == ["conv3x3_bn_act_bf16", "conv3x3_bn_act_f32"]


@pytest.mark.cuda
def test_conv3x3_wrapper_raises_on_bad_arguments(cuda_toolchain):
    x, w, scale, bias = _conv3x3_case(8, 1, 8, 16, 8, torch.float32)
    with pytest.raises(TypeError):
        conv3x3_bn_act(x, w.bfloat16(), scale, bias)
    with pytest.raises(TypeError):
        conv3x3_bn_act(x, w, scale.double(), bias)
    with pytest.raises(ValueError):
        conv3x3_bn_act(x, w[:2].contiguous(), scale, bias)
    with pytest.raises(ValueError):
        conv3x3_bn_act(x.transpose(1, 2), w, scale, bias)


@pytest.mark.cuda
def test_conv3x3_chains_of_a_resnet50_inference_program_on_card(
        cuda_toolchain):
    """The sixteen 3x3 conv -> batch norm -> relu chains of a ResNet-50
    inference program (64x64 images, random batch-norm statistics), each
    through the kernel with the batch norm folded, against the program's
    own output on the card (float32, TF32 off)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import resnet
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        image = pt.layers.data(name="image", shape=[2, 3, 64, 64],
                               dtype="float32", append_batch_size=False)
        predict = resnet.resnet_imagenet(image, 10, depth=50)
    test = main.clone(for_test=True)
    chains = resnet.conv3x3_bn_relu_chains(test)
    assert len(chains) == 16
    scope, exe = pt.Scope(), pt.Executor()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(3)
    for _, bn, _ in chains:
        C = scope.find_var(bn.input("Scale")[0]).shape[0]
        for slot, value in (("Scale", rng.rand(C) + 0.5),
                            ("Bias", rng.randn(C) * 0.1),
                            ("Mean", rng.randn(C) * 0.1),
                            ("Variance", rng.rand(C) + 0.5)):
            scope.set_var(bn.input(slot)[0], torch.tensor(
                value, dtype=torch.float32, device="cuda"))
    fetch = [predict.name]
    for conv, _, relu in chains:
        fetch += [conv.input("Input")[0], relu.output("Out")[0]]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = exe.run(test, feed={"image": rng.rand(2, 3, 64, 64).astype(
            "float32")}, fetch_list=fetch, scope=scope, return_numpy=False)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    before = CONV3X3.launches
    for i, (conv, bn, _) in enumerate(chains):
        x = got[1 + 2 * i].permute(0, 2, 3, 1).contiguous()
        w = scope.find_var(conv.input("Filter")[0]).permute(2, 3, 1, 0)
        w = w.contiguous()
        scale, bias = fold_batch_norm(
            *(scope.find_var(bn.input(s)[0])
              for s in ("Scale", "Bias", "Mean", "Variance")),
            bn.attr("epsilon"))
        out = conv3x3_bn_act(x, w, scale, bias)
        want = got[2 + 2 * i].permute(0, 2, 3, 1)
        tol = f32_tolerance(x, w, scale) + TOL * want.abs()
        assert bool(((out - want).abs() <= tol).all()), i
    assert CONV3X3.launches == before + 16


# ---------------------------------------------------------------------------
# sparse grads (SelectedRows): torch indexing ops, no hand-written kernel
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip(f"needs an NVIDIA GPU: torch.cuda.is_available()=False, "
                    f"torch {torch.__version__} (CUDA {torch.version.cuda})")


def _sparse_grad(height, dim, merged):
    """A SelectedRows grad on the CPU with duplicate rows (a hot row seven
    times) or, ``merged``, the same merged: tail slots of row ``height``,
    which a consumer must drop (on the card an index of ``height`` would
    be a device-side assert)."""
    from paddle_tpu_torch.selected_rows import SelectedRows
    g = torch.Generator().manual_seed(21)
    rows = torch.tensor([3, 0, 3, 7, 3, 9, 3, 0, 3, 3, 3])
    sr = SelectedRows(rows, torch.randn(len(rows), dim, generator=g), height)
    return sr.merge_duplicates() if merged else sr


def _on(sr, device):
    from paddle_tpu_torch.selected_rows import SelectedRows
    return SelectedRows(sr.rows.to(device), sr.value.to(device), sr.height)


@pytest.mark.cuda
@pytest.mark.parametrize("merged", [False, True])
def test_merge_duplicates_on_card(cuda_card, merged):
    sr = _sparse_grad(12, 5, merged)
    want = sr.merge_duplicates()
    got = _on(sr, "cuda").merge_duplicates()
    torch.cuda.synchronize()
    assert torch.equal(got.rows.cpu(), want.rows)
    torch.testing.assert_close(got.value.cpu(), want.value, atol=TOL,
                               rtol=TOL)
    torch.testing.assert_close(_on(sr, "cuda").to_dense().cpu(),
                               sr.to_dense(), atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("merged", [False, True])
@pytest.mark.parametrize("op_type", ["sgd", "adam", "adagrad"])
def test_sparse_updates_on_card(cuda_card, op_type, merged):
    """The sparse branches of the update ops on the card against the CPU,
    tail rows included (dropped, no device assert), in place on the
    card's tensors."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import registry
    H, D = 12, 5
    g = torch.Generator().manual_seed(22)
    state = {"p": torch.randn(H, D, generator=g),
             "lr": torch.tensor([0.05])}
    ins, outs = {"Param": ["p"], "Grad": ["g"], "LearningRate": ["lr"]}, \
        {"ParamOut": ["p"]}
    if op_type == "adagrad":
        state["m"] = torch.rand(H, D, generator=g)
        ins["Moment"], outs["MomentOut"] = ["m"], ["m"]
    if op_type == "adam":
        state.update(m1=torch.randn(H, D, generator=g) * 0.1,
                     m2=torch.rand(H, D, generator=g) * 0.01,
                     b1=torch.tensor([0.9 ** 2]),
                     b2=torch.tensor([0.999 ** 2]))
        ins.update(Moment1=["m1"], Moment2=["m2"], Beta1Pow=["b1"],
                   Beta2Pow=["b2"])
        outs.update(Moment1Out=["m1"], Moment2Out=["m2"],
                    Beta1PowOut=["b1"], Beta2PowOut=["b2"])
    sr = _sparse_grad(H, D, merged)
    results = []
    for device in ("cpu", "cuda"):
        block = pt.Program().global_block()
        env = {n: t.to(device).clone() for n, t in state.items()}
        env["g"] = _on(sr, device)
        held = {n: env[n] for n in ("p", "m", "m1", "m2") if n in env}
        op = pt.Operator(block, op_type, ins, outs, {})
        registry.run_lowering(op, env, block,
                              aux={"device": torch.device(device)})
        if device == "cuda":
            torch.cuda.synchronize()
        for n, t in held.items():
            assert env[n] is t, n
        results.append({n: env[n].cpu() for n in state})
    for n in state:
        torch.testing.assert_close(results[1][n], results[0][n], atol=TOL,
                                   rtol=TOL, msg=n)


@pytest.mark.cuda
def test_wide_and_deep_step_on_card(cuda_card):
    """One ``wide_and_deep_train_program(8)`` Adam step on the card and on
    the CPU from one scope: the loss and every persistable variable."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.convert import (persistable_names,
                                          scope_from_numpy, to_numpy)
    from paddle_tpu_torch.models import wide_and_deep
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 5
    with pt.program_guard(main, startup):
        cost, _, _ = wide_and_deep.wide_and_deep_train_program(8)
        pt.optimizer.Adam(learning_rate=0.01).minimize(cost)
    cpu, cpu_scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    cpu.run(startup, scope=cpu_scope)
    names = persistable_names(main)
    card_scope = scope_from_numpy(
        {n: to_numpy(cpu_scope.find_var(n)) for n in names}, None, main)
    rng = np.random.RandomState(6)
    feed = {"slot_ids": rng.randint(0, 12, (8, 4, 1)).astype("int64"),
            "dense": rng.rand(8, 8).astype("float32"),
            "label": rng.randint(0, 2, (8, 1)).astype("int64")}
    (a,) = cpu.run(main, feed=feed, fetch_list=[cost], scope=cpu_scope)
    (b,) = pt.Executor().run(main, feed=feed, fetch_list=[cost],
                             scope=card_scope)
    np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)
    for n in names:
        assert card_scope.find_var(n).device.type == "cuda", n
        np.testing.assert_allclose(to_numpy(card_scope.find_var(n)),
                                   to_numpy(cpu_scope.find_var(n)),
                                   rtol=TOL, atol=TOL, err_msg=n)


def _lstm_grad_program(peepholes, reverse):
    """``dynamic_lstm`` over a ragged x, ``loss = sum(h * w)``, and its
    backward: the fetches are h and the grads of x and both
    parameters."""
    import paddle_tpu_torch as pt
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 4
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=[-1, 64], append_batch_size=False,
                           lod_level=1, stop_gradient=False)
        w = pt.layers.data("w", shape=[-1, 16], append_batch_size=False)
        h, _ = pt.layers.dynamic_lstm(x, 64, use_peepholes=peepholes,
                                      is_reverse=reverse)
        loss = pt.layers.reduce_sum(pt.layers.elementwise_mul(h, w))
        pt.append_backward(loss)
    params = [p.name for p in main.global_block().all_parameters()]
    return main, startup, [h.name, "x@GRAD"] + [p + "@GRAD"
                                                for p in params]


@pytest.mark.cuda
@pytest.mark.parametrize("peepholes,reverse", [(True, False), (False, True)])
def test_lstm_and_its_grad_on_card_match_cpu(cuda_card, peepholes, reverse):
    """An ``lstm`` op and its auto-vjp grad (the recompute under
    ``torch.func.vjp``) on the card equal the CPU's on the same ragged
    batch (an empty sequence among them), from one scope."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.convert import (persistable_names,
                                          scope_from_numpy, to_numpy)
    main, startup, fetch = _lstm_grad_program(peepholes, reverse)
    cpu, cpu_scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    cpu.run(startup, scope=cpu_scope)
    card_scope = scope_from_numpy(
        {n: to_numpy(cpu_scope.find_var(n))
         for n in persistable_names(main)}, None, main)
    rng = np.random.RandomState(7)
    lod = [[0, 9, 9, 12, 30]]
    feed = {"x": (rng.randn(30, 64).astype("float32") * 0.5, lod),
            "w": rng.randn(30, 16).astype("float32")}
    want = cpu.run(main, feed=feed, fetch_list=fetch, scope=cpu_scope)
    got = pt.Executor().run(main, feed=feed, fetch_list=fetch,
                            scope=card_scope)
    for name, g, w in zip(fetch, got, want):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=name)


@pytest.mark.cuda
def test_max_pool_of_an_empty_sequence_on_card(cuda_card):
    """A zero-length sequence through MAX pooling on the card: -inf, a
    MaxIndex of ``iinfo(int32).max`` and no grad, as on the CPU (no
    out-of-range index reaches the device)."""
    import paddle_tpu_torch as pt
    results = []
    for place in (pt.CPUPlace(), None):
        main = pt.Program()
        with pt.program_guard(main, pt.Program()):
            x = pt.layers.data("x", shape=[-1, 3], append_batch_size=False,
                               lod_level=1, stop_gradient=False)
            out = pt.layers.sequence_pool(x, "max")
            last = pt.layers.sequence_last_step(x)
            first = pt.layers.sequence_first_step(x)
            loss = pt.layers.reduce_sum(pt.layers.elementwise_add(
                pt.layers.elementwise_add(last, first),
                pt.layers.scale(out, 0.0)))
            pt.append_backward(loss)
        max_index = next(op for op in main.global_block().ops
                         if op.type == "sequence_pool").output("MaxIndex")[0]
        x = np.random.RandomState(3).randn(7, 3).astype("float32")
        results.append(pt.Executor(place).run(
            main, feed={"x": (x, [[0, 0, 3, 7, 7]])},
            fetch_list=[out, max_index, last, first, "x@GRAD"],
            scope=pt.Scope()))
    want, got = results
    assert np.all(got[0][[0, 3]] == -np.inf)
    assert np.all(got[1][[0, 3]] == 2 ** 31 - 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _drnn_program(pt):
    """A DynamicRNN over a ragged batch (an ``fc`` of the step and the
    memory, tanh) and its grads through ``while_grad``."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        layers = pt.layers
        x = layers.data("x", shape=[-1, 8], append_batch_size=False,
                        lod_level=1, stop_gradient=False)
        drnn = layers.DynamicRNN()
        with drnn.block():
            word = drnn.step_input(x)
            prev = drnn.memory(shape=[16], value=0.0)
            h = layers.fc(input=[word, prev], size=16, act="tanh")
            drnn.update_memory(prev, h)
            drnn.output(h)
        out = drnn()
        loss = layers.reduce_sum(layers.sequence_last_step(out))
        pt.append_backward(loss)
    params = [p.name for p in main.global_block().all_parameters()]
    return main, startup, [out.name, "x@GRAD"] + [p + "@GRAD"
                                                  for p in params]


@pytest.mark.cuda
def test_dynamic_rnn_and_while_grad_on_card_match_cpu(cuda_card):
    """A ``while`` over a DynamicRNN's steps and its ``while_grad`` (the
    loop re-run under ``torch.func.vjp`` from its pre-loop values) on the
    card equal the CPU's from one scope; 7 trips and 7 re-run, each with
    5 device reads (2 array reads, 2 writes, the condition)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.convert import (persistable_names,
                                          scope_from_numpy, to_numpy)
    main, startup, fetch = _drnn_program(pt)
    cpu, cpu_scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    cpu.run(startup, scope=cpu_scope)
    card_scope = scope_from_numpy(
        {n: to_numpy(cpu_scope.find_var(n))
         for n in persistable_names(main)}, None, main)
    rng = np.random.RandomState(5)
    lod = [[0, 4, 5, 12, 14]]
    feed = {"x": (rng.randn(14, 8).astype("float32"), lod)}
    want = cpu.run(main, feed=feed, fetch_list=fetch, scope=cpu_scope)
    card = pt.Executor()
    got = card.run(main, feed=feed, fetch_list=fetch, scope=card_scope)
    for name, g, w in zip(fetch, got, want):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=name)
    assert card.last_run == {"while_trips": 14, "host_reads": 10 * 7 + 4}


@pytest.mark.cuda
def test_beam_search_ties_on_card(cuda_card):
    """``beam_search`` on the card breaks exact -1e9 ties by flat index,
    as on the CPU (and ``lax.top_k``)."""
    import paddle_tpu_torch as pt
    arrays = {"p_i": np.array([[0, 7, 0], [1, 1, 1]], "int64"),
              "p_s": np.array([[-0.5, -1e9, -2.0], [0.0, -1e9, -1e9]],
                              "float32"),
              "c_i": np.arange(12, dtype="int64").reshape(2, 3, 2) + 10,
              "c_s": np.array([[[-1e9] * 2] * 3,
                               [[-0.1, -0.3], [-1e9, -1e9], [-1e9, -1e9]]],
                              "float32")}
    results = []
    for place in (pt.CPUPlace(), None):
        main = pt.Program()
        with pt.program_guard(main, pt.Program()):
            ins = [pt.layers.data(n, shape=list(a.shape), dtype=str(a.dtype),
                                  append_batch_size=False)
                   for n, a in arrays.items()]
            outs = pt.layers.beam_search(*ins, 3, 0)
        results.append(pt.Executor(place).run(main, feed=arrays,
                                              fetch_list=list(outs)))
    for w, g in zip(*results):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(results[1][2], [[0, 2, 0], [0, 0, 1]])
