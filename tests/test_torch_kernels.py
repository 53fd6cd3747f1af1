"""The PyTorch port's kernels: the plain torch versions against the JAX
package's kernels (the Pallas kernels in interpret mode and their XLA
fallbacks), the wrappers' CPU dispatch and argument checks, and cases
that launch the CUDA kernels, which need an NVIDIA GPU and skip here.

Tolerance: float32 ``atol = rtol = 1e-5`` (different summation orders);
a dead paged slot (lens 0) is compared for finiteness only, as nothing
reads it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import attention_ops as A
from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels.bias_softmax import (BIAS_SOFTMAX,
                                                   bias_softmax,
                                                   bias_softmax_reference)
from paddle_tpu_torch.kernels.paged_decode import (
    PAGED_DECODE, paged_attention, paged_attention_reference)
from paddle_tpu_torch.ops.attention_ops import paged_cache_update

TOL = 1e-5


def _paged_case(seed, S=4, H=2, D=8, PL=8, P=3, NP=16, lens=None):
    """TestPagedAttention's case (tests/test_attention.py): live
    prefixes spanning page boundaries, one row, and a dead slot."""
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


@pytest.mark.parametrize("seed", [11, 12])
def test_paged_reference_matches_jax_kernel_and_fallback(seed):
    H, D = 2, 8
    scale = float(D) ** -0.5
    case = _paged_case(seed)
    live = case[4][:, 0] > 0
    got = paged_attention_reference(*_torch(*case), H, scale).numpy()
    jcase = [jnp.asarray(a) for a in case]
    fallback = np.asarray(A._xla_paged_attention(*jcase, H, scale))
    kernel = A._pallas_paged_attention(*jcase, H, scale, interpret=True)
    assert kernel is not None, "interpret kernel unexpectedly gated"
    kernel = np.asarray(kernel)
    np.testing.assert_allclose(got[live], fallback[live], atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(got[live], kernel[live], atol=TOL, rtol=TOL)
    assert np.all(np.isfinite(got))


def test_paged_reference_at_serving_shape():
    """The serving path's shape (8 slots, H=2, D=16, page_len 16, 128
    pool pages, the 16-page bucket) with lens of 0, 1, page multiples and
    the full 256 rows."""
    H, D, PL, P = 2, 16, 16, 16
    lens = [0, 1, 16, 32, 256, 255, 17, 128]
    case = _paged_case(3, S=8, H=H, D=D, PL=PL, P=P, NP=128, lens=lens)
    scale = float(D) ** -0.5
    live = case[4][:, 0] > 0
    got = paged_attention_reference(*_torch(*case), H, scale).numpy()
    want = np.asarray(A._xla_paged_attention(
        *[jnp.asarray(a) for a in case], H, scale))
    np.testing.assert_allclose(got[live], want[live], atol=TOL, rtol=TOL)


def test_paged_wrapper_runs_plain_version_on_cpu():
    case = _torch(*_paged_case(5))
    before = PAGED_DECODE.launches
    got = paged_attention(*case, 2, 0.3)
    want = paged_attention_reference(*case, 2, 0.3)
    assert torch.equal(got, want)
    assert PAGED_DECODE.launches == before  # nothing launched on the CPU


@pytest.mark.parametrize("lens", [[20, 8, 1, 0], [0, 0, 0, 0],
                                  [24, 24, 9, 1]])
def test_paged_cache_update_matches_reference(lens):
    """The in-place torch scatter writes each live slot's row at
    ``lens - 1`` of its tail page and drops dead slots, exactly as the
    JAX package's ``_paged_cache_update``."""
    q, kc, vc, pt, lens = _paged_case(9, lens=lens)
    rng = np.random.RandomState(1)
    k = rng.randn(4, 1, 16).astype("float32")
    v = rng.randn(4, 1, 16).astype("float32")
    wk, wv = A._paged_cache_update(jnp.asarray(kc), jnp.asarray(vc),
                                   jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(pt), jnp.asarray(lens))
    tkc, tvc, tk, tv, tpt, tlens = _torch(kc, vc, k, v, pt, lens)
    paged_cache_update(tkc, tvc, tk, tv, tpt, tlens)
    np.testing.assert_array_equal(tkc.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(tvc.numpy(), np.asarray(wv))


def _softmax_case(seed, B=2, H=2, Sq=16, Sk=24):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, Sq, Sk).astype("float32")
    row = np.where(rng.rand(B, Sk) < 0.3, -1e9, 0.0).astype("float32")
    tri = np.triu(np.full((Sq, Sk), -1e9, "float32"), 1)
    tri = np.stack([tri, tri + np.where(np.arange(Sk) < Sk - 5, 0.0, -1e9)
                    .astype("float32")[None]])           # [B, Sq, Sk]
    return x, row, tri


@pytest.mark.parametrize("form", ["row", "causal_per_batch",
                                  "causal_shared", "both"])
def test_bias_softmax_reference_matches_jax_fused_softmax(form):
    x, row, tri = _softmax_case(4)
    rb = row if form in ("row", "both") else None
    tb = {"row": None, "causal_per_batch": tri, "causal_shared": tri[:1],
          "both": tri}[form]
    want = np.asarray(A.fused_softmax(
        jnp.asarray(x), None if rb is None else jnp.asarray(rb),
        None if tb is None else jnp.asarray(tb), True))
    got = bias_softmax_reference(
        torch.from_numpy(x), None if rb is None else torch.from_numpy(rb),
        None if tb is None else torch.from_numpy(tb)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_bias_softmax_wrapper_runs_plain_version_on_cpu():
    x, row, tri = _softmax_case(6)
    before = BIAS_SOFTMAX.launches
    args = (torch.from_numpy(x), None, torch.from_numpy(tri))
    assert torch.equal(bias_softmax(*args), bias_softmax_reference(*args))
    assert BIAS_SOFTMAX.launches == before


def test_library_path_is_keyed_by_source_and_under_the_package():
    paths = [build.library_path(s) for s in build.SOURCES]
    assert len(set(paths)) == len(paths)
    for p in paths:
        assert p.startswith(build.BUILD_DIR) and p.endswith(".so")
    assert "compute_90a,code=sm_90a" in " ".join(build.NVCC_FLAGS)


# ---------------------------------------------------------------------------
# CUDA kernels: need the card and nvcc; skip here naming what was found
# ---------------------------------------------------------------------------

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
@pytest.mark.parametrize("T", [8, 64, 256])
def test_bias_softmax_kernel_matches_plain_version_on_card(cuda_toolchain,
                                                           T):
    x, row, _ = _softmax_case(T, B=2, H=2, Sq=T, Sk=T)
    tri = np.triu(np.full((T, T), -1e9, "float32"), 1)[None]
    args = [torch.from_numpy(x).cuda(), torch.from_numpy(row).cuda(),
            torch.from_numpy(tri).cuda()]
    before = BIAS_SOFTMAX.launches
    got = bias_softmax(*args)
    assert BIAS_SOFTMAX.launches == before + 1
    torch.testing.assert_close(got, bias_softmax_reference(*args),
                               atol=TOL, rtol=TOL)


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
