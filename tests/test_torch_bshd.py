"""The PyTorch port's attention pair in the ``[B, S, H, D]`` layout
(``kernels/bshd_attention.py``) against the JAX package's
``_bshd_fwd_kernel`` / ``_bshd_bwd_kernel`` (``exp_bshd_attn.py``, Pallas,
run in interpret mode on the CPU: ``pl.pallas_call`` patched to
``interpret=True`` inside the test only), and the port of that script.

- Plain versions vs the Pallas pair at ``[2, S, 3, 8]``, S 16 and 33,
  causal and not, a random key mask with one batch row fully masked (so
  also rows that are masked and causal), the mask in q's dtype as the
  original passes it (and once in float32 beside bf16 q): float32 within
  ``atol = rtol = 1e-5`` (out, residual, dq, dk, dv; both sum in float32,
  in other orders); bfloat16 within one rounding of the output (``rtol =
  2**-7`` plus ``2**-8`` times its RMS), the float32 residual within
  1e-5.  Inputs come from a numpy seed.
- ``BshdAttentionFunction``'s grads vs ``jax.grad`` through
  ``make_bshd_attention()`` (float32, 1e-5).
- The ``[B, S, H, D]`` plain versions vs the ``[B, H, S, D]`` single-pass
  plain versions on transposed inputs (float32 1e-5, bf16 one rounding),
  so that the two layouts cannot drift apart.
- ``exp_torch_bshd_attn``'s ``check_numerics`` and its four routes run on
  the CPU at a small size (the wrappers' plain versions).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import jax
import exp_bshd_attn
import exp_torch_bshd_attn
from paddle_tpu_torch.kernels import bshd_attention as bshd
from paddle_tpu_torch.kernels import smalls_attention as smalls
from paddle_tpu_torch.kernels.smalls_attention import smalls_fwd_rows

F32_TOL = 1e-5
B, H, D = 2, 3, 8
SCALE = D ** -0.5


@pytest.fixture()
def interpret(monkeypatch):
    monkeypatch.setattr(exp_bshd_attn.pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=True))


def _case(S, seed=0):
    """q, k, v, dO [B, S, H, D] and a key mask [B, S] with a tenth of the
    keys off and batch row 1 fully masked."""
    rng = np.random.RandomState(seed + S)
    q, k, v, g = (rng.randn(B, S, H, D).astype("float32") for _ in range(4))
    mask = (rng.rand(B, S) > 0.1).astype("float32")
    mask[1] = 0.0
    return q, k, v, mask, g


def _close(got, want, dtype):
    got, want = torch.as_tensor(got).float(), torch.as_tensor(want).float()
    if dtype == "bfloat16":
        rms = float(want.square().mean().sqrt())
        torch.testing.assert_close(got, want, atol=2.0 ** -8 * rms,
                                   rtol=2.0 ** -7)
    else:
        torch.testing.assert_close(got, want, atol=F32_TOL, rtol=F32_TOL)


def _jax_pair(q, k, v, mask, g, causal, dtype, mask_dtype):
    """The Pallas pair: ``(out, res, dq, dk, dv)`` as numpy float32, and
    the (rounded) operands it read, as numpy float32."""
    jdt = jnp.dtype(dtype)
    jq, jk, jv, jg = (jnp.asarray(x).astype(jdt) for x in (q, k, v, g))
    jm = jnp.asarray(mask).astype(jdt if mask_dtype == "q" else jnp.float32)
    out, res = exp_bshd_attn.bshd_fwd(jq, jk, jv, jm, causal, SCALE)
    grads = exp_bshd_attn.bshd_bwd(jq, jk, jv, jm, out, res, jg, causal,
                                   SCALE)
    results = [np.array(x, np.float32) for x in (out, res, *grads)]
    operands = [np.array(x, np.float32) for x in (jq, jk, jv, jm, jg)]
    return results, operands


CASES = [(S, causal, dtype, "q") for S in (16, 33) for causal in (False, True)
         for dtype in ("float32", "bfloat16")] + [
    (33, True, "bfloat16", "float32")]


@pytest.mark.parametrize("S,causal,dtype,mask_dtype", CASES)
def test_plain_versions_match_the_pallas_pair(interpret, S, causal, dtype,
                                              mask_dtype):
    want, operands = _jax_pair(*_case(S), causal, dtype, mask_dtype)
    tdt = getattr(torch, dtype)
    tq, tk, tv, tm, tg = (torch.from_numpy(x) for x in operands)
    tq, tk, tv, tg = (x.to(tdt) for x in (tq, tk, tv, tg))
    if mask_dtype == "q":
        tm = tm.to(tdt)
    out, res = bshd.bshd_attention_fwd(tq, tk, tv, tm, causal, SCALE)
    grads = bshd.bshd_attention_bwd(tq, tk, tv, tm, out, res, tg, causal,
                                    SCALE)
    assert out.dtype == tdt and res.dtype == torch.float32
    assert tuple(res.shape) == (B, S, H, 2)
    assert all(x.dtype == tdt and tuple(x.shape) == (B, S, H, D)
               for x in grads)
    _close(out, want[0], dtype)
    torch.testing.assert_close(res, torch.from_numpy(want[1]), atol=F32_TOL,
                               rtol=F32_TOL)
    for got, w in zip(grads, want[2:]):
        _close(got, w, dtype)


def test_fully_masked_rows_attend_as_the_reference(interpret):
    """Batch row 1 has every key off: the -1e9 absorbs the scores, so a
    row's residual is (-1e9, log S) and its output the mean of v over all
    keys; under the causal mask the row's -1e9 entries beat the -2e9 ones
    above the diagonal, so row r averages keys 0 .. r (log l = log(r+1))."""
    S = 16
    q, k, v, mask, g = _case(S)
    for causal in (False, True):
        want, _ = _jax_pair(q, k, v, mask, g, causal, "float32", "q")
        out, res = bshd.bshd_attention_fwd(
            *(torch.from_numpy(x) for x in (q, k, v, mask)), causal, SCALE)
        torch.testing.assert_close(res, torch.from_numpy(want[1]),
                                   atol=F32_TOL, rtol=F32_TOL)
        assert bool((res[1, ..., 0] == -1e9).all())
        n = torch.arange(1, S + 1, dtype=torch.float32)[:, None] if causal \
            else torch.full((S, 1), float(S))
        torch.testing.assert_close(res[1, ..., 1], torch.log(n).expand(S, H))
        vmean = torch.from_numpy(v[1]).cumsum(0) / n[..., None] if causal \
            else torch.from_numpy(v[1]).mean(0).expand(S, H, D)
        torch.testing.assert_close(out[1], vmean, atol=F32_TOL,
                                   rtol=F32_TOL)


def test_autograd_function_matches_jax_grad_of_make_bshd_attention(
        interpret):
    S = 33
    q, k, v, mask, _ = _case(S, seed=4)
    w = np.random.RandomState(5).randn(B, S, H, D).astype("float32")
    attn = exp_bshd_attn.make_bshd_attention()
    for causal in (False, True):
        def loss(q, k, v):
            return jnp.sum(attn(q, k, v, jnp.asarray(mask), causal, SCALE)
                           * w)
        want = jax.grad(loss, argnums=(0, 1, 2))(
            *(jnp.asarray(x) for x in (q, k, v)))
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out = bshd.bshd_attn(*leaves, torch.from_numpy(mask), causal, SCALE)
        got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
        for a, b in zip(got, want):
            _close(a, np.array(b), "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_bshd_layout_equals_the_bhsd_pair_on_transposed_inputs(dtype,
                                                               causal):
    q, k, v, mask, g = _case(40, seed=9)
    tdt = getattr(torch, dtype)
    tq, tk, tv, tg = (torch.from_numpy(x).to(tdt) for x in (q, k, v, g))
    tm = torch.from_numpy(mask)
    out, res = bshd.bshd_attention_fwd(tq, tk, tv, tm, causal, SCALE)
    grads = bshd.bshd_attention_bwd(tq, tk, tv, tm, out, res, tg, causal,
                                    SCALE)

    def heads_first(x):
        return x.transpose(1, 2).contiguous()

    hq, hk, hv, hg = (heads_first(x) for x in (tq, tk, tv, tg))
    hout, lse = smalls.smalls_attention_fwd(hq, hk, hv, tm, causal, SCALE)
    hgrads = smalls.smalls_attention_bwd(hq, hk, hv, tm, hout, lse, hg,
                                         causal, SCALE)
    _close(out, heads_first(hout), dtype)
    torch.testing.assert_close(res, heads_first(lse), atol=F32_TOL,
                               rtol=F32_TOL)
    for a, b in zip(grads, hgrads):
        _close(a, heads_first(b), dtype)


def test_a_bf16_mask_gives_what_its_float32_values_give():
    q, k, v, mask, g = (torch.from_numpy(x) for x in _case(24, seed=2))
    q, k, v, g = (x.to(torch.bfloat16) for x in (q, k, v, g))
    for causal in (False, True):
        a = bshd.bshd_attention_fwd(q, k, v, mask, causal, SCALE)
        b = bshd.bshd_attention_fwd(q, k, v, mask.to(torch.bfloat16),
                                    causal, SCALE)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_max_s_is_the_shared_memory_limit_of_the_rule():
    for d in (8, 64, 128):
        s = bshd.bshd_max_s(d)
        assert smalls_fwd_rows(s, d, d) == 16
        assert smalls_fwd_rows(s + 1, d, d) is None


def test_cuda_tensors_never_take_the_plain_version(monkeypatch):
    """On a CUDA tensor a wrapper launches its kernel or raises; here,
    without a card, reaching for the kernel fails, and the plain version
    is not run in its place."""
    def no_plain(*a, **k):
        raise AssertionError("plain version run for a non-CPU tensor")
    monkeypatch.setattr(bshd, "bshd_attention_fwd_reference", no_plain)
    monkeypatch.setattr(bshd, "bshd_attention_bwd_reference", no_plain)
    q = torch.zeros(1, 8, 2, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        bshd.bshd_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        bshd.bshd_attention_bwd(q, q, q, None, q, q[..., :2], q)


def test_experiment_runs_on_the_plain_versions():
    """The port of the script: its numerics check and its four routes
    (grads against SDPA's) on the CPU at a small size."""
    errs = exp_torch_bshd_attn.check_numerics("cpu", batch=2, seq=24)
    assert errs["fwd"] < exp_torch_bshd_attn.FWD_LIMIT
    assert errs["bwd"] < exp_torch_bshd_attn.BWD_LIMIT
    assert errs["fwd_plain"] == errs["bwd_plain"] == 0.0
    inputs = exp_torch_bshd_attn.make_inputs(
        torch.Generator().manual_seed(3), "cpu", batch=2, seq=24)
    table = exp_torch_bshd_attn.routes(*inputs)
    assert sorted(table) == ["bshd", "composed_transposed", "sdpa",
                             "smalls_transposed"]
    errs = exp_torch_bshd_attn.compare_routes(table)
    assert max(errs.values()) < exp_torch_bshd_attn.BWD_LIMIT
    for x in table["bshd"]():
        assert tuple(x.shape) == tuple(inputs[0].shape)
