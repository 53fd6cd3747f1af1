"""The PyTorch port's CUDA kernels on the card, each against its plain
torch version on the same inputs.  They need an NVIDIA GPU and ``nvcc``
and skip elsewhere, naming what was found; this file imports neither JAX
nor the JAX package, so it runs on a machine with the card alone:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerance: float32 ``atol = rtol = 1e-5`` (the kernels and their plain
versions sum in different orders); bfloat16 outputs one bf16 rounding of
the same float32 value, ``rtol = 2**-7`` (one ulp of the value) plus
``2**-8`` times the output's RMS for elements near zero (see
``_assert_matches``); a dead paged slot (lens 0) is compared for
finiteness only, as nothing reads it."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels.bias_softmax import (
    BIAS_SOFTMAX, BIAS_SOFTMAX_GRAD, bias_softmax, bias_softmax_grad,
    bias_softmax_grad_reference, bias_softmax_reference)
from paddle_tpu_torch.kernels.flash_attention import (
    FLASH_DKDV, FLASH_DQ, FLASH_FWD, flash_attention_bwd,
    flash_attention_bwd_reference, flash_attention_fwd,
    flash_attention_fwd_reference)
from paddle_tpu_torch.kernels.paged_decode import (
    PAGED_DECODE, paged_attention, paged_attention_reference)

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
    ((2, 8, 256, 256, 64, 64), True)])
def test_flash_kernels_match_plain_versions_on_card(cuda_toolchain, dtype,
                                                    shape, causal):
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
    wgrads = flash_attention_bwd_reference(tq, tk, tv, tm, out, lse, tg,
                                           causal, D ** -0.5)
    # the kernels and their plain versions share every operation in
    # float32; only the order of the sums differs
    _assert_matches(out, want[0])
    torch.testing.assert_close(lse, want[1], atol=1e-5, rtol=1e-6)
    for a, b in zip(grads, wgrads):
        _assert_matches(a, b)


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
