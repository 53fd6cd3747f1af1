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
- The dispatch rule: self-attention at S = 512 takes the pair,
  ``Sq != Sk`` and S = 2048 the flash kernels, and the forward and grad
  lowerings of one op always take the same family.
- A 2 + 2 layer Transformer (d_model 32) at S = 128 with the gate at 128
  in both packages: IR dicts equal, three Adam steps' losses, parameters
  and leaf grads within 1e-5 (float32; both sum in different orders).
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
