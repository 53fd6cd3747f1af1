"""The PyTorch port's single-pass attention pair against the JAX
package's ``_smalls_fwd_kernel`` / ``_smalls_bwd_kernel`` (Pallas, run in
interpret mode on the CPU, as ``tests/test_attention.py`` runs them), the
rule that picks between the pair and the flash kernels, and a narrow
Transformer trained through that rule in both packages.

- Plain versions vs the Pallas kernels at ``[2, 4, 128, 16]``, causal and
  not, and with a fully masked row (first key off, causal on): forward
  ``rtol 2e-4 / atol 2e-5``, grads ``rtol 1e-3 / atol 1e-4`` (the limits
  of ``TestSmallSSinglePass``); the ``(m, log l)`` residual to 1e-5.
  Inputs come from a numpy seed.
- In bfloat16 the plain versions round ``p`` and ``dS`` where the Pallas
  kernels cast them, so the two agree to bf16 rounding of the outputs.
- The rounding-flip slacks that the card checks allow the tensor-core
  bodies: a bf16 plain forward (backward) whose ``q . k`` (and ``dO .
  v``) sum in another order lies within one rounding plus
  ``forward_rounding_slack`` (``flash_backward_rounding_slack``) of the
  plain version.
- The dispatch rule: self-attention at S = 512 takes the pair,
  ``Sq != Sk`` and S = 2048 the flash kernels, and the forward and grad
  lowerings of one op always take the same family.
- A 2 + 2 layer Transformer (d_model 32) at S = 128 with the gate at 128
  in both packages: IR dicts equal, three Adam steps' losses, parameters
  and leaf grads within 1e-5 (float32; both sum in different orders).
- The rule's answers (``fwd_rows_fit``, ``smalls_fwd_rows``,
  ``smalls_ok``) on a grid of S 1 ... 3072 and head widths 16 ... 128,
  pinned against a table taken before the bfloat16 forward moved to the
  tensor cores, and that body's shared-memory sum.
- The unfused route (``use_flash=False``, or head widths beyond the
  kernels' 128) against the reference's ``scaled_dot_product_attention``
  through both packages' IR (forward and Q/K/V grads, float32, 1e-5),
  and a 1 + 1 layer Transformer at d_model 1024 over 4 heads (D = 256)
  at S = the gate for one Adam step.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.framework import unique_name_scope as jax_names
from paddle_tpu.models import transformer as JT
from paddle_tpu.ops import attention_ops as JA
from paddle_tpu_torch.convert import (persistable_names, scope_from_numpy,
                                      to_numpy)
from paddle_tpu_torch.framework import unique_name_scope as torch_names
from paddle_tpu_torch.kernels import flash_attention as flash
from paddle_tpu_torch.kernels import smalls_attention as smalls
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.ops import attention_ops

SHAPE = (2, 4, 128, 16)
SCALE = 0.25
FWD_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)
F32_TOL = 1e-5


def _case(seed, first_key_off=False):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(*SHAPE).astype("float32") * 0.3 for _ in range(3))
    mask = np.ones(SHAPE[::2], "float32")
    mask[0, -9:] = 0.0
    if first_key_off:
        mask[:, 0] = 0.0
    g = rng.randn(*SHAPE).astype("float32")
    return q, k, v, mask, g


def _jax_pair(q, k, v, mask, g, causal, dtype=jnp.float32):
    """The JAX package's single-pass kernels in interpret mode:
    ``(out, residual, dq, dk, dv)`` as numpy float32."""
    assert JA._smalls_group(SHAPE[0] * SHAPE[1], SHAPE[2]) is not None
    jq, jk, jv, jg = (jnp.asarray(x).astype(dtype) for x in (q, k, v, g))
    jm = jnp.asarray(mask)
    out, res = JA._pallas_attention(jq, jk, jv, jm, causal, SCALE,
                                    interpret=True)
    grads = JA._pallas_attention_bwd(jq, jk, jv, jm, out, res, jg, causal,
                                     SCALE, interpret=True)
    return [np.asarray(x, np.float32) for x in (out, res, *grads)]


def _torch_pair(q, k, v, mask, g, causal, dtype=torch.float32):
    tq, tk, tv, tg = (torch.from_numpy(x).to(dtype) for x in (q, k, v, g))
    tm = torch.from_numpy(mask)
    out, lse = smalls.smalls_attention_fwd(tq, tk, tv, tm, causal, SCALE)
    grads = smalls.smalls_attention_bwd(tq, tk, tv, tm, out, lse, tg, causal,
                                        SCALE)
    return [x.float().numpy() for x in (out, lse, *grads)]


@pytest.mark.parametrize("causal", [False, True])
def test_forward_matches_pallas_kernel(causal):
    case = _case(7)
    want = _jax_pair(*case, causal)
    got = _torch_pair(*case, causal)
    np.testing.assert_allclose(got[0], want[0], **FWD_TOL)
    assert got[1].shape == SHAPE[:3] + (2,)
    np.testing.assert_allclose(got[1], want[1], rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_grads_match_pallas_kernel(causal):
    case = _case(8)
    want = _jax_pair(*case, causal)
    got = _torch_pair(*case, causal)
    for a, b, name in zip(got[2:], want[2:], ("dq", "dk", "dv")):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)


def test_fully_masked_row_matches_pallas_kernel():
    """First key off and causal on: row 0 attends only masked keys, its
    softmax runs over ties at -1e9 and ``(m, log l)`` must stay two
    numbers (``TestSmallSSinglePass::test_fully_masked_row_grads``)."""
    case = _case(10, first_key_off=True)
    want = _jax_pair(*case, True)
    got = _torch_pair(*case, True)
    assert got[1][0, 0, 0, 0] < -5e8 and got[1][0, 0, 0, 1] > 0
    np.testing.assert_allclose(got[0], want[0], **FWD_TOL)
    np.testing.assert_allclose(got[1], want[1], rtol=F32_TOL, atol=F32_TOL)
    for a, b, name in zip(got[2:], want[2:], ("dq", "dk", "dv")):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)
    # and the grads equal those of plain softmax attention under autograd
    q, k, v, mask, g = case
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = torch.softmax(flash._scores(*leaves[:2], torch.from_numpy(mask),
                                      True, SCALE), -1) @ leaves[2]
    for a, b in zip(got[2:], torch.autograd.grad(out, leaves,
                                                 torch.from_numpy(g))):
        np.testing.assert_allclose(a, b.numpy(), **GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_rounds_where_the_pallas_kernel_casts(causal):
    """bfloat16 operands: outputs agree to bf16 rounding (``rtol 2**-7``
    of the value plus ``2**-7`` of the output's RMS: the two round the
    same float32 sums, which differ in their last bits), the float32
    residual to 1e-5."""
    case = _case(11)
    want = _jax_pair(*case, causal, jnp.bfloat16)
    got = _torch_pair(*case, causal, torch.bfloat16)
    np.testing.assert_allclose(got[1], want[1], rtol=F32_TOL, atol=F32_TOL)
    for a, b, name in zip([got[0]] + got[2:], [want[0]] + want[2:],
                          ("out", "dq", "dk", "dv")):
        rms = float(np.sqrt(np.mean(np.square(b))))
        np.testing.assert_allclose(a, b, rtol=2.0 ** -7, atol=2.0 ** -7 * rms,
                                   err_msg=name)


def test_plain_versions_differ_from_flash_only_by_the_casts():
    """float32: the pair's plain versions and the flash kernels' compute
    one function (the casts are no-ops)."""
    q, k, v, mask, g = (torch.from_numpy(x) for x in _case(12))
    out, lse = smalls.smalls_attention_fwd_reference(q, k, v, mask, True,
                                                     SCALE)
    fout, flse = flash.flash_attention_fwd_reference(q, k, v, mask, True,
                                                     SCALE)
    torch.testing.assert_close(out, fout, rtol=0, atol=0)
    torch.testing.assert_close(lse, flse, rtol=0, atol=0)
    for a, b in zip(
            smalls.smalls_attention_bwd_reference(q, k, v, mask, out, lse, g,
                                                  True, SCALE),
            flash.flash_attention_bwd_reference(q, k, v, mask, out, lse, g,
                                                True, SCALE)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("std", [0.5, 2.0])
def test_rounding_flip_slack_covers_another_order_of_the_sums(causal, std):
    """bfloat16 operands: the plain forward with its scores summed in
    another order (a float64 product, rounded once) rounds some keys'
    weights ``T(e)`` the other way, only where the slack allows it, and
    lies within one rounding plus the slack of the plain forward."""
    B, H, S, D = 2, 4, 256, 64
    gen = torch.Generator().manual_seed(31)
    q, k, v = ((torch.randn(B, H, S, D, generator=gen) * std).bfloat16()
               for _ in range(3))
    mask = (torch.rand(B, S, generator=gen) > 0.2).float()
    want, _ = smalls.smalls_attention_fwd_reference(q, k, v, mask, causal,
                                                    SCALE)
    slack = smalls.forward_rounding_slack(q, k, v, mask, causal, SCALE)
    weights = []
    for s in (flash._scores(q, k, mask, causal, SCALE),
              flash._masked((q.double() @ k.double().transpose(-1, -2))
                            .float() * SCALE, mask, causal)):
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        weights.append((e, e.sum(dim=-1, keepdim=True)))
    (e, _), (e64, l64) = weights
    flipped = e.bfloat16() != e64.bfloat16()
    assert flipped.any()                          # the case is not vacuous
    # a row with a flipped key has slack in every column
    assert (slack.amin(dim=-1) > 0)[flipped.any(dim=-1)].all()
    other = (e64.bfloat16().float() @ v.float() / l64).bfloat16().float()
    w = want.float()
    tol = 2.0 ** -8 * float(w.square().mean().sqrt()) + 2.0 ** -7 * w.abs()
    assert ((other - w).abs() <= tol + slack).all()


def _chunked_reversed(a, b):
    """float32 ``a . b^T`` over the last axis summed in another order than
    one matmul: 16-wide chunks of it, the last chunk first, as a
    tensor-core body may take them."""
    a, b = a.float(), b.float()
    out = torch.zeros(a.shape[:-1] + b.shape[-2:-1])
    for c in reversed(range(0, a.shape[-1], 16)):
        out = out + a[..., c:c + 16] @ b[..., c:c + 16].transpose(-1, -2)
    return out


@pytest.mark.parametrize("S,causal,mask_kind", [
    (256, True, "first_key_off"), (256, False, "batch_row_off"),
    (40, True, "batch_row_off")])
def test_backward_slack_covers_another_order_of_the_sums(S, causal,
                                                         mask_kind):
    """bfloat16 operands: a float32 plain backward whose ``q . k`` and
    ``dO . v`` sum in another order (16-wide chunks of D, last first)
    rounds some ``T(dS)`` and ``T(p)`` the other way; its dq, dk, dv lie
    within one bf16 rounding plus ``flash_backward_rounding_slack`` of
    :func:`smalls_attention_bwd_reference` (the bound the card checks
    hold the tensor-core backward to).  Causal with key 0 off (rows whose
    causal window is fully masked), key-masked with a batch row whose
    every key is off, and a ragged S = 40."""
    B, H, D = 2, 4, 64
    gen = torch.Generator().manual_seed(43 + S)
    q, k, v, do = (torch.randn(B, H, S, D, generator=gen).bfloat16()
                   for _ in range(4))
    mask = (torch.rand(B, S, generator=gen) > 0.2).float()
    if mask_kind == "first_key_off":
        mask[:, 0] = 0.0
    else:
        mask[0] = 0.0
    scale = D ** -0.5
    out, lse = smalls.smalls_attention_fwd_reference(q, k, v, mask, causal,
                                                     scale)
    args = (q, k, v, mask, out, lse, do, causal, scale)
    want = smalls.smalls_attention_bwd_reference(*args)
    slack = flash.flash_backward_rounding_slack(*args)

    s = flash._masked(_chunked_reversed(q, k) * scale, mask, causal)
    p = torch.exp((s - lse[..., 0:1]) - lse[..., 1:2])
    delta = (do.float() * out.float()).sum(dim=-1, keepdim=True)
    ds = p * (_chunked_reversed(do, v) - delta) * scale
    ds_plain = flash._probs_and_dscores(*args)[1]
    flipped = ds.bfloat16() != ds_plain.bfloat16()
    assert flipped.any()                      # the case is not vacuous
    # a key row with a flipped T(dS) has slack in every column of its dk
    assert (slack[1].amin(dim=-1) > 0)[flipped.any(dim=-2)].all()
    t = lambda x: x.bfloat16().float()  # noqa: E731
    other = (t(ds) @ k.float(), t(ds).transpose(-1, -2) @ q.float(),
             t(p).transpose(-1, -2) @ do.float())
    for a, b, sl in zip(other, want, slack):
        b = b.float()
        tol = 2.0 ** -8 * float(b.square().mean().sqrt()) + 2.0 ** -7 * b.abs()
        assert ((a.bfloat16().float() - b).abs() <= tol + sl).all()


def test_rounding_flip_slack_vanishes_far_from_rounding_boundaries():
    """Scores all 0: every weight is exactly 1, far from a bf16 rounding
    boundary, so no key can round otherwise and the slack is 0."""
    v = torch.randn(1, 2, 96, 32, generator=torch.Generator().manual_seed(
        32)).bfloat16()
    q = torch.zeros_like(v)
    assert not smalls.forward_rounding_slack(q, v, v, None, False,
                                             SCALE).any()


# ---------------------------------------------------------------------------
# the dispatch rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("BH,Sq,Sk,D,want", [
    (256, 512, 512, 64, True),       # route C: every attention of a step
    (256, 128, 128, 64, True),
    (8, 200, 200, 64, True),         # ragged S: no S % 128 rule
    (1, 512, 512, 128, True),
    (256, 512, 256, 64, False),      # Sq != Sk
    (64, 2048, 2048, 64, False),     # route B stays on the flash kernels
    (256, 512, 512, 192, False),     # wider than the kernels' heads
])
def test_smalls_ok(BH, Sq, Sk, D, want):
    assert smalls.smalls_ok(BH, Sq, Sk, D) is want
    assert smalls.smalls_ok(BH, Sq, Sk, D, D) is want


def test_smalls_ok_limit_lies_inside_shared_memory():
    S = smalls.SMALLS_MAX_S
    assert S >= 512
    assert smalls.smalls_ok(8, S, S, 128) and not \
        smalls.smalls_ok(8, S + 1, S + 1, 64)
    # 32 query rows a block at route C's shape, 16 where 32 do not fit
    assert smalls.smalls_fwd_rows(512, 64, 64) == 32
    assert smalls.smalls_fwd_rows(1024, 64, 64) == 32
    assert smalls.smalls_fwd_rows(2048, 64, 64) == 16
    assert smalls.smalls_fwd_rows(8192, 64, 64) is None
    assert smalls.fwd_rows_fit(64, 512, 64, 64) and not \
        smalls.fwd_rows_fit(64, 1024, 64, 64)


#: the longest S (of 1 ... 3072) at which a forward block of ``rows``
#: query rows fits, by head widths (D, Dv) of ``_WIDTHS``: taken from
#: ``fwd_rows_fit`` before the bfloat16 forward moved to the tensor
#: cores; the rule's answers may not move with the body
_WIDTHS = (16, 32, 48, 64, 96, 128)
_PINNED_MAX_S = {
    16: [[3072, 3072, 3072, 3072, 3008, 2880],
         [3072, 3072, 3072, 3072, 2944, 2880],
         [3072, 3072, 3072, 3072, 2944, 2816],
         [3072, 3072, 3072, 3072, 2944, 2816],
         [2944, 2944, 2944, 2944, 2944, 2816],
         [2752, 2752, 2752, 2752, 2752, 2752]],
    32: [[1664, 1664, 1600, 1600, 1536, 1472],
         [1600, 1600, 1600, 1536, 1472, 1408],
         [1600, 1600, 1600, 1536, 1472, 1408],
         [1536, 1536, 1536, 1536, 1472, 1408],
         [1408, 1408, 1408, 1408, 1408, 1344],
         [1344, 1344, 1344, 1344, 1344, 1344]],
    64: [[832, 768, 768, 768, 704, 704],
         [768, 768, 768, 768, 704, 704],
         [768, 768, 768, 704, 704, 640],
         [704, 704, 704, 704, 704, 640],
         [640, 640, 640, 640, 640, 640],
         [576, 576, 576, 576, 576, 576]],
}


@pytest.mark.parametrize("D", _WIDTHS)
def test_rule_answers_are_pinned(D):
    S = np.arange(1, 3073)
    for rows, table in _PINNED_MAX_S.items():
        for Dv, last in zip(_WIDTHS, table[_WIDTHS.index(D)]):
            got = [smalls.fwd_rows_fit(rows, int(s), D, Dv) for s in S]
            np.testing.assert_array_equal(got, S <= last,
                                          err_msg=f"{rows} {D} {Dv}")
    for Dv in _WIDTHS:
        fit32 = _PINNED_MAX_S[32][_WIDTHS.index(D)][_WIDTHS.index(Dv)]
        fit16 = _PINNED_MAX_S[16][_WIDTHS.index(D)][_WIDTHS.index(Dv)]
        for s in range(1, 3073, 7):
            want = 32 if s <= fit32 else 16 if s <= fit16 else None
            assert smalls.smalls_fwd_rows(s, D, Dv) == want, (s, D, Dv)
            assert smalls.smalls_ok(8, s, s, D, Dv) is (
                s <= smalls.SMALLS_MAX_S and want is not None), (s, D, Dv)


def test_bf16_forward_shared_memory_sum():
    """The tensor-core body's sum: 16 R rows of float32 scores at a row
    stride of the padded keys + 8, two bf16 k / v tiles of 64 rows at
    the padded width + 8, the rows' partial maxima (4 slices), maxima
    and sums.  It fits a block
    wherever the float32 body's sum fits (it exceeds that sum only at
    small shapes, by at most 5 KB), so the rule, which asks for both,
    answers as it did with the float32 sum alone."""
    # route C's [B, H, 512, 64] at 32 rows a block
    assert smalls._fwd_smem_bytes(2, 512, 64, 64, bf16=True) == \
        4 * 32 * (512 + 8) + 2 * 2 * 64 * (64 + 8) + 4 * (4 + 2) * 32
    # head widths round up to 16 (the mma's depth)
    assert smalls._fwd_smem_bytes(1, 200, 8, 8, bf16=True) == \
        4 * 16 * (256 + 8) + 2 * 2 * 64 * (16 + 8) + 4 * (4 + 2) * 16
    for R in (1, 2, 4):
        for S in range(64, 4097, 64):
            for D in (1, 8, 15, 16, 17, 64, 96, 127, 128):
                for Dv in (1, 16, 64, 100, 128):
                    f32 = smalls._fwd_smem_bytes(R, S, D, Dv)
                    bf16 = smalls._fwd_smem_bytes(R, S, D, Dv, bf16=True)
                    assert bf16 <= f32 + 5120, (R, S, D, Dv)
                    if f32 <= smalls._MAX_SMEM:
                        assert bf16 <= smalls._MAX_SMEM, (R, S, D, Dv)


def _attention_program(Sq, Sk):
    main, startup = pt.Program(), pt.Program()
    with torch_names("at_"), pt.program_guard(main, startup):
        q = pt.layers.data(name="q", shape=[1, 2, Sq, 8], dtype="float32",
                           append_batch_size=False)
        kv = pt.layers.data(name="kv", shape=[1, 2, Sk, 8], dtype="float32",
                            append_batch_size=False)
        q.stop_gradient = kv.stop_gradient = False
        out = pt.layers.fused_attention(q, kv, kv, causal=False, scale=0.3)
        pt.append_backward(pt.layers.reduce_mean(out))
    return main


@pytest.mark.parametrize("Sq,Sk,family", [
    (512, 512, "smalls"), (96, 96, "smalls"), (96, 48, "flash"),
    (2048, 2048, "flash")])
def test_forward_and_grad_take_the_same_family(Sq, Sk, family, monkeypatch):
    """Both lowerings of ``scaled_dot_product_attention`` go through one
    rule on the same shapes: counted here through the wrappers the
    lowerings call (on the CPU they run the plain versions)."""
    calls = []
    for name in ("smalls_attention_fwd", "smalls_attention_bwd",
                 "flash_attention_fwd", "flash_attention_bwd"):
        def counted(*args, _fn=getattr(attention_ops, name), _n=name):
            calls.append(_n)
            return _fn(*args)
        monkeypatch.setattr(attention_ops, name, counted)
    main = _attention_program(Sq, Sk)
    rng = np.random.RandomState(Sq + Sk)
    feed = {"q": rng.randn(1, 2, Sq, 8).astype("float32"),
            "kv": rng.randn(1, 2, Sk, 8).astype("float32")}
    gq, gkv = pt.Executor(pt.CPUPlace()).run(
        main, feed=feed, fetch_list=["q@GRAD", "kv@GRAD"], scope=pt.Scope())
    assert calls == [f"{family}_attention_fwd", f"{family}_attention_bwd"]
    assert np.isfinite(gq).all() and np.abs(gkv).sum() > 0


def test_rule_change_moves_forward_and_grad_together(monkeypatch):
    """Patching the rule flips both lowerings at once: neither keeps a
    copy of it."""
    monkeypatch.setattr(attention_ops, "smalls_ok", lambda *a: False)
    q = torch.zeros(1, 2, 96, 8)
    assert attention_ops.attention_kernels(q, q, q) == (
        attention_ops.flash_attention_fwd, attention_ops.flash_attention_bwd)
    monkeypatch.undo()
    assert attention_ops.attention_kernels(q, q, q) == (
        attention_ops.smalls_attention_fwd,
        attention_ops.smalls_attention_bwd)


def test_cuda_tensors_never_take_the_plain_version(monkeypatch):
    """On a CUDA tensor a wrapper launches its kernel or raises; here,
    without a card, reaching for the kernel fails, and the plain version
    is not run in its place."""
    def no_plain(*a, **k):
        raise AssertionError("plain version run for a non-CPU tensor")
    monkeypatch.setattr(smalls, "smalls_attention_fwd_reference", no_plain)
    monkeypatch.setattr(smalls, "smalls_attention_bwd_reference", no_plain)
    q = torch.zeros(1, 1, 8, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        smalls.smalls_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        smalls.smalls_attention_bwd(q, q, q, None, q, q[..., :2], q)


# ---------------------------------------------------------------------------
# the unfused route: use_flash=False, or heads wider than the kernels'
# ---------------------------------------------------------------------------

UNFUSED_B, UNFUSED_H, UNFUSED_SQ, UNFUSED_SK = 2, 2, 24, 40


def _unfused_program(pkg, names, D, masked, causal, use_flash):
    """One ``fused_attention`` op and its grad: ``loss = sum(out * g)``
    with the cotangent ``g`` fed.  Causal runs self-attention (Sq ==
    Sk), the key-masked case cross-attention (Sq != Sk)."""
    B, H, Sq = UNFUSED_B, UNFUSED_H, UNFUSED_SQ
    Sk = Sq if causal else UNFUSED_SK
    main, startup = pkg.Program(), pkg.Program()
    with names("un_"), pkg.program_guard(main, startup):
        def data(name, shape):
            return pkg.layers.data(name=name, shape=shape, dtype="float32",
                                   append_batch_size=False)
        q, k, v = (data(n, [B, H, S, D])
                   for n, S in (("q", Sq), ("k", Sk), ("v", Sk)))
        for x in (q, k, v):
            x.stop_gradient = False
        g = data("g", [B, H, Sq, D])
        mask = data("mask", [B, Sk]) if masked else None
        out = pkg.layers.fused_attention(q, k, v, k_mask=mask, causal=causal,
                                         scale=D ** -0.5,
                                         use_flash=use_flash)
        loss = pkg.layers.reduce_sum(pkg.layers.elementwise_mul(out, g))
        pkg.append_backward(loss)
    return main, out


def _unfused_feed(D, masked, causal, first_key_off):
    """Seeded inputs; a key mask with a quarter of the keys off and the
    last batch row fully masked, and key 0 off (``first_key_off``: row
    0's causal window fully masked, its -1e9 entries tied with the
    causal ones) or on in the other rows."""
    B, H, Sq = UNFUSED_B, UNFUSED_H, UNFUSED_SQ
    Sk = Sq if causal else UNFUSED_SK
    rng = np.random.RandomState(D + 2 * masked + causal)
    feed = {n: (rng.randn(B, H, S, D) * 0.5).astype("float32")
            for n, S in (("q", Sq), ("k", Sk), ("v", Sk), ("g", Sq))}
    if masked:
        mask = (rng.rand(B, Sk) > 0.25).astype("float32")
        mask[:-1, 0] = 0.0 if first_key_off else 1.0
        mask[-1] = 0.0                      # a batch row with every key off
        feed["mask"] = mask
    return feed


def _counted_routes(monkeypatch, calls):
    for name in ("smalls_attention_fwd", "smalls_attention_bwd",
                 "flash_attention_fwd", "flash_attention_bwd",
                 "unfused_attention_fwd", "unfused_attention_bwd"):
        def counted(*args, _fn=getattr(attention_ops, name), _n=name):
            calls.append(_n)
            return _fn(*args)
        monkeypatch.setattr(attention_ops, name, counted)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("D,use_flash", [(64, False), (256, True)])
def test_unfused_route_matches_reference(D, use_flash, masked, causal,
                                         monkeypatch):
    """The reference computes this op through ``_reference_attention``
    when ``use_flash`` is off, and through its Pallas kernels at D = 256
    (the same function); the port through its unfused route, forward and
    grad alike.  Rows whose causal window is fully key-masked take part
    where the reference runs ``_reference_attention``; its Pallas flash
    kernel averages such a row over the keys of its first key block
    only (a result that depends on its block size), so at D = 256 they
    are held against ``_reference_attention`` itself
    (``test_unfused_route_matches_reference_attention``)."""
    calls = []
    _counted_routes(monkeypatch, calls)
    feed = _unfused_feed(D, masked, causal, first_key_off=not use_flash)
    fetched = []
    for pkg, names in ((fluid, jax_names), (pt, torch_names)):
        main, out = _unfused_program(pkg, names, D, masked, causal,
                                     use_flash)
        fetch = [out.name, "q@GRAD", "k@GRAD", "v@GRAD"]
        fetched.append([np.asarray(x) for x in pkg.Executor(
            pkg.CPUPlace()).run(main, feed=feed, fetch_list=fetch,
                                scope=pkg.Scope())])
    assert calls == ["unfused_attention_fwd", "unfused_attention_bwd"]
    want, got = fetched
    for a, b, name in zip(got, want, ("out", "dq", "dk", "dv")):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=name)
    assert np.abs(got[1]).sum() > 0 and np.abs(got[3]).sum() > 0


@pytest.mark.parametrize("D,Dv,use_flash,family", [
    (64, 64, False, "unfused"), (256, 256, True, "unfused"),
    (64, 192, True, "unfused"), (64, 64, True, "smalls")])
def test_unfused_forward_and_grad_take_one_route(D, Dv, use_flash, family):
    """``attention_kernels`` answers alike for the forward's and the
    grad's call: the unfused pair for ``use_flash=False`` or a head
    width over 128, a kernel pair otherwise."""
    q = torch.zeros(1, 2, 96, D)
    v = torch.zeros(1, 2, 96, Dv)
    fwd, bwd = attention_ops.attention_kernels(q, q, v, use_flash)
    assert (fwd.__name__, bwd.__name__) == (f"{family}_attention_fwd",
                                            f"{family}_attention_bwd")
    assert attention_ops.attention_kernels(q, q, v, use_flash) == (fwd, bwd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unfused_route_matches_reference_attention(dtype):
    """The route against the reference's ``_reference_attention`` and its
    vjp, at D = 256, causal, with key 0 off (row 0's window fully
    masked: the mean of v over all keys) and a fully masked batch row:
    float32 to 1e-5; bfloat16 (AMP's operands) to one rounding of the
    outputs, the two rounding the same float32 values in the same
    places."""
    import jax
    rng = np.random.RandomState(31)
    B, H, S, D = 2, 2, 24, 256
    q, k, v, g = ((rng.randn(B, H, S, D) * 0.5).astype("float32")
                  for _ in range(4))
    mask = (rng.rand(B, S) > 0.25).astype("float32")
    mask[:, 0] = 0.0
    mask[-1] = 0.0
    jdt = getattr(jnp, dtype)
    jq, jk, jv, jg = (jnp.asarray(x).astype(jdt) for x in (q, k, v, g))
    jm = jnp.asarray(mask)
    out, vjp = jax.vjp(lambda a, b, c: JA._reference_attention(
        a, b, c, jm, True, 0.1), jq, jk, jv)
    want = [np.asarray(x, np.float32) for x in (out, *vjp(jg))]
    tdt = getattr(torch, dtype)
    tq, tk, tv, tg = (torch.from_numpy(x).to(tdt) for x in (q, k, v, g))
    tm = torch.from_numpy(mask)
    tout, lse = attention_ops.unfused_attention_fwd(tq, tk, tv, tm, True,
                                                    0.1)
    grads = attention_ops.unfused_attention_bwd(tq, tk, tv, tm, None, None,
                                                tg, True, 0.1)
    assert lse is None
    for a, b, name in zip([tout, *grads], want, ("out", "dq", "dk", "dv")):
        assert a.dtype == tdt, name
        a = a.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(a, b, rtol=F32_TOL, atol=F32_TOL,
                                       err_msg=name)
        else:
            rms = float(np.sqrt(np.mean(np.square(b))))
            np.testing.assert_allclose(a, b, rtol=2.0 ** -7,
                                       atol=2.0 ** -7 * rms, err_msg=name)
    # row 0: key 0 (masked) ties at -1e9 with the unmasked keys that the
    # causal mask takes; keys both masked and causal are at -2e9
    tied = (np.arange(S) == 0) | (mask[0] > 0)
    row0 = v[0][:, tied].mean(axis=1)                   # [H, D]
    np.testing.assert_allclose(want[0][0, :, 0], row0, rtol=2.0 ** -7,
                               atol=1e-2)


def test_unfused_route_sets_no_residual():
    """As in the reference, the unfused route leaves ``Lse`` unset; the
    grad reads q, k, v and the incoming grad only."""
    q = torch.randn(1, 2, 8, 160)
    out, lse = attention_ops.unfused_attention_fwd(q, q, q, None, True, 0.1)
    assert lse is None and out.shape == q.shape
    grads = attention_ops.unfused_attention_bwd(q, q, q, None, None, None,
                                                torch.ones_like(out), True,
                                                0.1)
    assert all(g.shape == q.shape and torch.isfinite(g).all()
               for g in grads)


# ---------------------------------------------------------------------------
# a narrow Transformer through the rule, both packages
# ---------------------------------------------------------------------------

B, S = 2, 128


def _hp(mod):
    hp = mod.ModelHyperParams()
    hp.d_model, hp.d_inner_hid, hp.n_layer = 32, 64, 2
    hp.n_head, hp.d_key, hp.d_value = 2, 16, 16
    hp.src_vocab_size = hp.trg_vocab_size = 64
    hp.max_length = S
    hp.dropout = 0.0
    return hp


def _strip(d):
    for block in d["blocks"]:
        for op in block["ops"]:
            op.pop("creation_site", None)
    return d


def _build(pkg, names, mod):
    main, startup = pkg.Program(), pkg.Program()
    with names("sm_"), pkg.program_guard(main, startup):
        cost, _ = mod.transformer(B, S, S, _hp(mod))
        pkg.optimizer.Adam(learning_rate=1e-3).minimize(cost)
    return main, startup, cost


def test_transformer_through_the_single_pass_pair(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_S", "128")
    jm, js, jc = _build(fluid, jax_names, JT)
    tm, ts, tc = _build(pt, torch_names, TT)
    assert _strip(tm.to_dict()) == _strip(jm.to_dict())
    assert _strip(ts.to_dict()) == _strip(js.to_dict())
    types = [op.type for op in tm.global_block().ops]
    assert types.count("scaled_dot_product_attention") == 6
    assert types.count("scaled_dot_product_attention_grad") == 6
    # the JAX package takes its single-pass kernels at this shape too
    assert JA._smalls_group(B * 2, S) is not None

    calls = []
    for name in ("smalls_attention_fwd", "smalls_attention_bwd",
                 "flash_attention_fwd", "flash_attention_bwd"):
        def counted(*args, _fn=getattr(attention_ops, name), _n=name):
            calls.append(_n)
            return _fn(*args)
        monkeypatch.setattr(attention_ops, name, counted)

    jexe = fluid.Executor(fluid.CPUPlace())
    jscope = fluid.Scope()
    jexe.run(js, scope=jscope)
    names = persistable_names(tm)
    tscope = scope_from_numpy(
        {n: np.asarray(jscope.find_var(n)) for n in names}, pt.CPUPlace(), tm)
    texe = pt.Executor(pt.CPUPlace())
    feed = JT.fake_batch(B, S, S, _hp(JT), seed=5)
    feed["src_mask"][1, -7:] = 0.0
    jl, tl = [], []
    for _ in range(3):
        (a,) = jexe.run(jm, feed=feed, fetch_list=[jc], scope=jscope)
        (b,) = texe.run(tm, feed=feed, fetch_list=[tc], scope=tscope)
        jl.append(float(np.asarray(a).reshape(())))
        tl.append(float(b.reshape(())))
    assert calls == (["smalls_attention_fwd"] * 6
                     + ["smalls_attention_bwd"] * 6) * 3
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=F32_TOL, atol=F32_TOL)
    moment1 = {op.input("Param")[0]: op.input("Moment1")[0]
               for op in tm.global_block().ops if op.type == "adam"}
    assert len(moment1) == len([p for p in tm.global_block().all_parameters()
                                if p.trainable])
    for p, m in moment1.items():
        np.testing.assert_allclose(
            to_numpy(tscope.find_var(p)),
            np.asarray(jscope.find_var(p), np.float32), rtol=F32_TOL,
            atol=F32_TOL, err_msg=p)
        want = np.asarray(jscope.find_var(m), np.float64)
        got = to_numpy(tscope.find_var(m)).astype(np.float64)
        assert np.linalg.norm(want) > 0, p
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < F32_TOL, (p, rel)


WIDE_B, WIDE_S = 2, 32


def _wide_hp(mod):
    """d_model 1024 over 4 heads: D = 256, wider than the kernels take."""
    hp = mod.ModelHyperParams()
    hp.d_model, hp.d_inner_hid, hp.n_layer = 1024, 64, 1
    hp.n_head, hp.d_key, hp.d_value = 4, 256, 256
    hp.src_vocab_size = hp.trg_vocab_size = 64
    hp.max_length = WIDE_S
    hp.dropout = 0.0
    return hp


def test_wide_heads_train_through_the_unfused_route(monkeypatch):
    """At S = the gate every attention is the fused op; at D = 256 the
    port runs it on the unfused route (before, it raised in the kernels'
    checks), and one Adam step equals the reference's."""
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_S", str(WIDE_S))
    built = []
    for pkg, names, mod in ((fluid, jax_names, JT), (pt, torch_names, TT)):
        main, startup = pkg.Program(), pkg.Program()
        with names("wd_"), pkg.program_guard(main, startup):
            cost, _ = mod.transformer(WIDE_B, WIDE_S, WIDE_S, _wide_hp(mod))
            pkg.optimizer.Adam(learning_rate=1e-3).minimize(cost)
        built.append((main, startup, cost))
    (jm, js, jc), (tm, ts, tc) = built
    assert _strip(tm.to_dict()) == _strip(jm.to_dict())
    types = [op.type for op in tm.global_block().ops]
    assert types.count("scaled_dot_product_attention") == 3

    calls = []
    _counted_routes(monkeypatch, calls)
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jexe.run(js, scope=jscope)
    names = persistable_names(tm)
    tscope = scope_from_numpy(
        {n: np.asarray(jscope.find_var(n)) for n in names}, pt.CPUPlace(), tm)
    feed = JT.fake_batch(WIDE_B, WIDE_S, WIDE_S, _wide_hp(JT), seed=3)
    feed["src_mask"][1, -5:] = 0.0
    (a,) = jexe.run(jm, feed=feed, fetch_list=[jc], scope=jscope)
    (b,) = pt.Executor(pt.CPUPlace()).run(tm, feed=feed, fetch_list=[tc],
                                          scope=tscope)
    assert calls == ["unfused_attention_fwd"] * 3 + \
        ["unfused_attention_bwd"] * 3
    np.testing.assert_allclose(float(b.reshape(())),
                               float(np.asarray(a).reshape(())),
                               rtol=F32_TOL, atol=F32_TOL)
    moment1 = {op.input("Param")[0]: op.input("Moment1")[0]
               for op in tm.global_block().ops if op.type == "adam"}
    for p, m in moment1.items():
        want = np.asarray(jscope.find_var(m), np.float64)
        got = to_numpy(tscope.find_var(m)).astype(np.float64)
        assert np.linalg.norm(want) > 0, p
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < F32_TOL, (p, rel)
