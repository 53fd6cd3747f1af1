"""The PyTorch port's kernels: the plain torch versions against the JAX
package's kernels (the Pallas kernels in interpret mode and their XLA
fallbacks), the wrappers' CPU dispatch and argument checks, the
``autograd.Function``s.  The cases that launch the CUDA kernels are in
``test_torch_cuda.py``.

Tolerance: float32 ``atol = rtol = 1e-5`` (different summation orders);
a dead paged slot (lens 0) is compared for finiteness only, as nothing
reads it.  bfloat16 flash attention: see ``BF16_FLASH``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import attention_ops as A
from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels.bias_softmax import (
    BIAS_SOFTMAX, BIAS_SOFTMAX_GRAD, BiasSoftmaxFunction, bias_softmax,
    bias_softmax_grad, bias_softmax_grad_reference, bias_softmax_reference)
from paddle_tpu_torch.kernels.flash_attention import (
    FLASH_DKDV, FLASH_DQ, FLASH_FWD, FlashAttentionFunction,
    flash_attention_bwd, flash_attention_bwd_reference, flash_attention_fwd,
    flash_attention_fwd_reference)
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
# bias-softmax backward
# ---------------------------------------------------------------------------

def _softmax_grad_case(seed=3):
    """TestFusedSoftmaxGradPrecision's case (tests/test_attention.py):
    bf16 probabilities and an f32 cotangent of an O(1) constant plus an
    O(1e-3) signal that a bf16 cast of the cotangent would destroy."""
    rng = np.random.RandomState(seed)
    x = rng.randn(1, 2, 32, 128).astype("float32")
    y = jax.nn.softmax(jnp.asarray(x), axis=-1).astype(jnp.bfloat16)
    g = (1.0 + rng.randn(1, 2, 32, 128) * 1e-3).astype("float32")
    yf = np.asarray(y, np.float32)
    dx_true = (g - (g * yf).sum(-1, keepdims=True)) * yf
    return y, g, dx_true


def _bf16_torch(y):
    return torch.from_numpy(np.asarray(y, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("seed", [3, 4])
def test_bias_softmax_grad_reference_matches_pallas_bwd(seed):
    y, g, dx_true = _softmax_grad_case(seed)
    want = A._pallas_softmax_bwd(y, jnp.asarray(g), interpret=True)
    assert want is not None, "interpret kernel unexpectedly gated"
    got = bias_softmax_grad_reference(_bf16_torch(y), torch.from_numpy(g))
    assert got.dtype == torch.bfloat16      # dx cast on the way out only
    # both round the same f32 dx to bf16: equal up to one bf16 ulp
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=1e-2, atol=2e-6)
    # and the f32 cotangent is read at its own precision
    assert np.max(np.abs(got.float().numpy() - dx_true)) < 2e-5


def test_bias_softmax_grad_f32_matches_xla_vjp():
    """float32 scores: the plain backward equals the vjp of the JAX
    package's fused softmax (its custom-vjp path) to 1e-5."""
    x, row, tri = _softmax_case(8)
    rng = np.random.RandomState(2)
    g = rng.randn(*x.shape).astype("float32")
    y, vjp = jax.vjp(lambda x_: A.fused_softmax(x_, jnp.asarray(row),
                                                jnp.asarray(tri), True),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    got = bias_softmax_grad_reference(torch.from_numpy(np.array(y)),
                                      torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_bias_softmax_function_grads_on_cpu():
    """The autograd.Function: torch autograd and torch.func.vjp (inside
    no_grad, as the executor calls it) both give the plain backward."""
    x, row, tri = _softmax_case(9)
    xt = torch.from_numpy(x).requires_grad_()
    rb, tb = torch.from_numpy(row), torch.from_numpy(tri)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(1))
    y = BiasSoftmaxFunction.apply(xt, rb, tb)
    y.backward(g)
    want = bias_softmax_grad_reference(y.detach(), g)
    torch.testing.assert_close(xt.grad, want, atol=TOL, rtol=TOL)
    xr = torch.from_numpy(x).requires_grad_()
    bias_softmax_reference(xr, rb, tb).backward(g)
    torch.testing.assert_close(xt.grad, xr.grad, atol=TOL, rtol=TOL)
    with torch.no_grad():
        _, vjp = torch.func.vjp(
            lambda a: BiasSoftmaxFunction.apply(a, rb, tb),
            torch.from_numpy(x))
        (dx,) = vjp(g)
    torch.testing.assert_close(dx, want, atol=TOL, rtol=TOL)


def test_bias_softmax_grad_wrapper_runs_plain_version_on_cpu():
    y, g, _ = _softmax_grad_case()
    before = BIAS_SOFTMAX_GRAD.launches
    args = (_bf16_torch(y), torch.from_numpy(g))
    assert torch.equal(bias_softmax_grad(*args),
                       bias_softmax_grad_reference(*args))
    assert BIAS_SOFTMAX_GRAD.launches == before


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

#: bfloat16 flash attention against the JAX kernels.  The port's kernels
#: read bf16 q/k/v/dO and keep p, dS and every sum in float32; the Pallas
#: kernels round p and dS to bf16 before their products.  That is one
#: bf16 rounding (2**-8 relative) of values of order 1 in the outputs:
#: ``BF16_FLASH`` (the JAX package's own bf16 flash-backward tolerance,
#: tests/test_attention.py::TestFlashBackwardKernel).
BF16_FLASH = dict(rtol=2e-2, atol=3e-2)
F32_FLASH = dict(rtol=TOL, atol=TOL)


def _flash_case(seed, B=2, H=2, Sq=40, Sk=40, D=16, Dv=16,
                dtype="float32", masked=True, full_mask_row=False):
    """q/k/v at S = 40 (no multiple of 128, so the JAX package runs its
    streaming kernels), a padded key row, and optionally a batch row with
    every key masked."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, Sq, D).astype("float32") * 0.3
    k = rng.randn(B, H, Sk, D).astype("float32") * 0.3
    v = rng.randn(B, H, Sk, Dv).astype("float32") * 0.3
    mask = np.ones((B, Sk), "float32")
    if masked:
        mask[0, -5:] = 0.0
    if full_mask_row:
        mask[1] = 0.0
    g = rng.randn(B, H, Sq, Dv).astype("float32")
    if dtype == "bfloat16":
        q, k, v, g = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                      for a in (q, k, v, g))
    return q, k, v, mask, g


def _jax_flash(q, k, v, mask, g, causal, scale, dtype):
    dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jq, jk, jv, jg = (jnp.asarray(a, dt) for a in (q, k, v, g))
    out, lse = A._pallas_attention(jq, jk, jv, jnp.asarray(mask), causal,
                                   scale, interpret=True)
    dq, dk, dv = A._pallas_attention_bwd(jq, jk, jv, jnp.asarray(mask), out,
                                         lse, jg, causal, scale,
                                         interpret=True)
    return [np.asarray(x, np.float32) for x in (out, lse, dq, dk, dv)]


def _torch_flash(q, k, v, mask, g, causal, scale, dtype):
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tq, tk, tv, tg = (torch.from_numpy(a).to(dt) for a in (q, k, v, g))
    tm = torch.from_numpy(mask)
    out, lse = flash_attention_fwd_reference(tq, tk, tv, tm, causal, scale)
    assert out.dtype == dt and lse.dtype == torch.float32
    dq, dk, dv = flash_attention_bwd_reference(tq, tk, tv, tm, out, lse, tg,
                                               causal, scale)
    assert dq.dtype == dk.dtype == dv.dtype == dt
    return [x.float().numpy() for x in (out, lse, dq, dk, dv)]


def _assert_flash_close(got, want, dtype):
    tol = BF16_FLASH if dtype == "bfloat16" else F32_FLASH
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        if name == "lse":
            # m is exact (the same maxima); log l to f32 round-off
            np.testing.assert_allclose(a[..., 0], b[..., 0], rtol=1e-6,
                                       err_msg="m")
            np.testing.assert_allclose(a[..., 1], b[..., 1], **F32_FLASH,
                                       err_msg="log l")
        else:
            np.testing.assert_allclose(a, b, **tol, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_reference_matches_pallas_kernels(causal, dtype):
    case = _flash_case(7, dtype=dtype)
    args = (*case, causal, 0.25, dtype)
    A_blocks = A._flash_blocks(40, 40, interpret=True)
    assert A._smalls_group(4, 40) is None and A_blocks == (8, 8)
    _assert_flash_close(_torch_flash(*args), _jax_flash(*args), dtype)


def test_flash_uneven_blocks_and_cross_attention():
    """TestFlashBackwardKernel::test_uneven_blocks_and_cross_attention's
    case: 96 queries against 48 keys, no mask."""
    q, k, v, mask, g = _flash_case(11, B=1, Sq=96, Sk=48, masked=False)
    args = (q, k, v, mask, g, False, 0.25, "float32")
    _assert_flash_close(_torch_flash(*args), _jax_flash(*args), "float32")


@pytest.mark.parametrize("causal", [False, True])
def test_flash_fully_masked_row(causal):
    """A batch row with every key masked attends uniformly (1/n), as the
    reference does: the residual keeps m and log l apart."""
    case = _flash_case(5, full_mask_row=True)
    args = (*case, causal, 0.25, "float32")
    got = _torch_flash(*args)
    _assert_flash_close(got, _jax_flash(*args), "float32")
    v = case[2]
    if not causal:
        np.testing.assert_allclose(got[0][1], np.broadcast_to(
            v[1].mean(axis=1, keepdims=True), got[0][1].shape),
            rtol=TOL, atol=TOL)
    assert np.all(np.isfinite(got[2])) and np.all(np.isfinite(got[3]))


def test_flash_function_grads_match_autograd_on_cpu():
    """FlashAttentionFunction's backward (the dQ and dK/dV math on the
    saved out and lse) equals torch autograd through the plain forward,
    and torch.func.vjp runs it inside no_grad."""
    q, k, v, mask, g = (torch.from_numpy(a) for a in _flash_case(3))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out, _ = FlashAttentionFunction.apply(*leaves, mask, True, 0.25)
    out.backward(g)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention_fwd_reference(*ref, mask, True, 0.25)[0].backward(g)
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, atol=TOL, rtol=TOL)
    with torch.no_grad():
        _, vjp = torch.func.vjp(
            lambda *x: FlashAttentionFunction.apply(*x, mask, True, 0.25)[0],
            q, k, v)
        grads = vjp(g)
    for a, b in zip(grads, ref):
        torch.testing.assert_close(a, b.grad, atol=TOL, rtol=TOL)


def test_flash_wrappers_run_plain_versions_on_cpu():
    q, k, v, mask, g = (torch.from_numpy(a) for a in _flash_case(4))
    before = (FLASH_FWD.launches, FLASH_DQ.launches, FLASH_DKDV.launches)
    out, lse = flash_attention_fwd(q, k, v, mask, True, 0.25)
    want = flash_attention_fwd_reference(q, k, v, mask, True, 0.25)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
    grads = flash_attention_bwd(q, k, v, mask, out, lse, g, True, 0.25)
    for a, b in zip(grads, flash_attention_bwd_reference(
            q, k, v, mask, out, lse, g, True, 0.25)):
        assert torch.equal(a, b)
    assert (FLASH_FWD.launches, FLASH_DQ.launches,
            FLASH_DKDV.launches) == before
