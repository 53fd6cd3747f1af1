"""The PyTorch port's Transformer training step against the JAX package's,
at a small size (2 + 2 layers, d_model 64, 4 heads x 16, vocab 64).

Both routes of the attention are covered: the composed route
(``matmul -> softmax(Bias) -> matmul``, the bias-softmax kernels) and
the flash route (the ``scaled_dot_product_attention`` op, the flash
kernels), the latter with ``PADDLE_TPU_FLASH_MIN_S`` set low on both
sides, a sequence length that is no multiple of 128 and a source length
unlike the target's, so the JAX package runs its streaming Pallas
kernels (interpret mode) and cross-attention has Sq != Sk.  In the port
the self-attentions of this route (Sq == Sk) take the single-pass pair's
plain versions and the cross-attentions the flash kernels'
(``smalls_ok``); ``tests/test_torch_smalls.py`` trains a model where both
packages take the single-pass kernels.

- The train programs (forward, IR backward, Adam) serialize to the same
  IR dicts, ignoring each op's ``creation_site``.
- Three Adam steps from one transplanted scope (parameters and Adam
  accumulators) give the same losses, parameters and grads (each
  parameter's first moment, leaf by leaf).  Tolerances: float32 ``1e-5``
  (both sum in different orders, nothing else differs); bfloat16 AMP,
  see ``test_adam_steps_match_reference_amp``.
- Dropout is random by design (threefry in JAX, a torch generator here):
  it is checked by keep rate and seeding, not bit for bit.  The parity
  runs use dropout 0.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.framework import unique_name_scope as jax_names
from paddle_tpu.models import transformer as JT
from paddle_tpu.ops import registry as fluid_registry
from paddle_tpu_torch.convert import (persistable_names, scope_from_numpy,
                                      to_numpy)
from paddle_tpu_torch.framework import unique_name_scope as torch_names
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.ops import attention_ops, nn_ops

B = 2
#: (src_len, trg_len, PADDLE_TPU_FLASH_MIN_S) of each attention route
ROUTES = {"composed": (16, 16, None), "flash": (24, 20, "8")}
F32_TOL = 1e-5


def _hp(mod, dropout=0.0):
    hp = mod.ModelHyperParams()
    hp.d_model, hp.d_inner_hid, hp.n_layer = 64, 128, 2
    hp.n_head, hp.d_key, hp.d_value = 4, 16, 16
    hp.src_vocab_size = hp.trg_vocab_size = 64
    hp.max_length = 32
    hp.dropout = dropout
    return hp


def _strip(d):
    for block in d["blocks"]:
        for op in block["ops"]:
            op.pop("creation_site", None)
    return d


def _build(pkg, names, mod, route, monkeypatch, dropout=0.0, amp=None,
           lr=1e-4):
    src, trg, min_s = ROUTES[route]
    if min_s is None:
        monkeypatch.delenv("PADDLE_TPU_FLASH_MIN_S", raising=False)
    else:
        monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_S", min_s)
    main, startup = pkg.Program(), pkg.Program()
    with names("tr_"), pkg.program_guard(main, startup):
        cost, feeds = mod.transformer(B, src, trg, _hp(mod, dropout))
        pkg.optimizer.Adam(learning_rate=lr).minimize(cost)
    main.amp = amp
    return main, startup, cost, feeds


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_train_program_matches_reference_ir(route, monkeypatch):
    jm, js, jc, jf = _build(fluid, jax_names, JT, route, monkeypatch)
    tm, ts, tc, tf = _build(pt, torch_names, TT, route, monkeypatch)
    assert (tc.name, tf) == (jc.name, jf)
    assert _strip(tm.to_dict()) == _strip(jm.to_dict())
    assert _strip(ts.to_dict()) == _strip(js.to_dict())
    types = [op.type for op in tm.global_block().ops]
    if route == "flash":
        # 2 encoder self, 2 decoder self, 2 cross attentions
        assert types.count("scaled_dot_product_attention") == 6
        assert types.count("scaled_dot_product_attention_grad") == 6
        assert "softmax" not in types
    else:
        assert types.count("softmax") == 6
        assert types.count("softmax_grad") == 6


def test_dropout_keeps_the_grad_chain(monkeypatch):
    """With dropout on, the port trains every parameter.  The JAX
    package's backward loses the grad at each ``dropout_grad`` (its maker
    leaves ``X`` out of the op's inputs, so ``X@GRAD`` is never recorded)
    and trains only the parameters downstream of the last dropout; the
    port's backward repairs that and otherwise appends the same ops."""
    jm, _, _, _ = _build(fluid, jax_names, JT, "composed", monkeypatch,
                         dropout=0.1)
    tm, _, _, _ = _build(pt, torch_names, TT, "composed", monkeypatch,
                         dropout=0.1)

    def trained(prog):
        block = prog.global_block()
        params = {p.name for p in block.all_parameters() if p.trainable}
        return params, {op.input("Param")[0] for op in block.ops
                        if op.type == "adam"}

    params, port_trained = trained(tm)
    jparams, ref_trained = trained(jm)
    assert params == jparams
    assert port_trained == params
    assert ref_trained < params and len(ref_trained) < len(params) // 2
    # the forward halves are the same program
    n_fwd = next(i for i, op in enumerate(jm.global_block().ops)
                 if op.type == "fill_constant")
    assert _strip(tm.to_dict())["blocks"][0]["ops"][:n_fwd] == \
        _strip(jm.to_dict())["blocks"][0]["ops"][:n_fwd]

    # the repair is exactly the recorded X@GRAD: with a maker that names
    # X among dropout_grad's inputs, the JAX package's backward appends
    # the port's program, op for op, once that extra input is dropped
    opdef = fluid_registry.lookup("dropout")
    maker = opdef.grad_maker

    def maker_naming_x(op, block, no_grad_set):
        descs, grad_map = maker(op, block, no_grad_set)
        for desc in descs:
            desc["inputs"]["X"] = list(op.input("X"))
        return descs, grad_map

    monkeypatch.setattr(opdef, "grad_maker", maker_naming_x)
    fixed, _, _, _ = _build(fluid, jax_names, JT, "composed", monkeypatch,
                            dropout=0.1)
    fixed = _strip(fixed.to_dict())
    n_dropout_grads = 0
    for op in fixed["blocks"][0]["ops"]:
        if op["type"] == "dropout_grad":
            op["inputs"].pop("X")
            n_dropout_grads += 1
    n_dropouts = [op.type for op in tm.global_block().ops].count("dropout")
    assert n_dropout_grads == n_dropouts > 0
    assert _strip(tm.to_dict()) == fixed


def _transplant(jm, js, tm):
    """Run the JAX startup program and carry its whole scope (parameters,
    learning rate, Adam moments and beta powers) into a port scope."""
    jexe = fluid.Executor(fluid.CPUPlace())
    jscope = fluid.Scope()
    jexe.run(js, scope=jscope)
    arrays = {n: np.asarray(jscope.find_var(n))
              for n in persistable_names(tm)}
    return jexe, jscope, scope_from_numpy(arrays, pt.CPUPlace(), tm)


def _three_steps(route, monkeypatch, amp, steps=3):
    jm, js, jc, _ = _build(fluid, jax_names, JT, route, monkeypatch,
                           amp=amp)
    tm, _, tc, _ = _build(pt, torch_names, TT, route, monkeypatch, amp=amp)
    jexe, jscope, tscope = _transplant(jm, js, tm)
    names = persistable_names(tm)
    assert any(n.startswith("tr_moment1") for n in names)
    assert any(n.startswith("tr_beta2_pow_acc") for n in names)
    texe = pt.Executor(pt.CPUPlace())
    src, trg, _ = ROUTES[route]
    feed = JT.fake_batch(B, src, trg, _hp(JT), seed=3)
    feed["src_mask"][1, -5:] = 0.0      # a padded source row
    feed["lbl_weight"][0, -3:] = 0.0    # and padded target tokens
    jl, tl = [], []
    for _ in range(steps):
        (a,) = jexe.run(jm, feed=feed, fetch_list=[jc], scope=jscope)
        (b,) = texe.run(tm, feed=feed, fetch_list=[tc], scope=tscope)
        jl.append(float(np.asarray(a).reshape(())))
        tl.append(float(b.reshape(())))
    params = [p.name for p in tm.global_block().all_parameters()
              if p.trainable]
    jp = {n: np.asarray(jscope.find_var(n), np.float32) for n in params}
    tp = {n: to_numpy(tscope.find_var(n)) for n in params}
    # each parameter's first moment, a running mean of its grads: an
    # early Adam step moves a parameter by about lr whatever its grad's
    # size, so the grads are compared through these
    moment1 = {op.input("Param")[0]: op.input("Moment1")[0]
               for op in tm.global_block().ops if op.type == "adam"}
    assert sorted(moment1) == sorted(params)
    jm1 = {n: np.asarray(jscope.find_var(moment1[n]), np.float32)
           for n in params}
    tm1 = {n: to_numpy(tscope.find_var(moment1[n])) for n in params}
    return np.array(jl), np.array(tl), jp, tp, jm1, tm1


def _leaf_rel_errors(got, want):
    """``|got - want| / |want|`` (2-norms) of each leaf."""
    out = {}
    for n, w in want.items():
        w = w.astype(np.float64)
        norm = float(np.linalg.norm(w))
        assert norm > 0, n                    # every parameter gets a grad
        out[n] = float(np.linalg.norm(got[n].astype(np.float64) - w)) / norm
    return out


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_adam_steps_match_reference_f32(route, monkeypatch):
    jl, tl, jp, tp, jm1, tm1 = _three_steps(route, monkeypatch, amp=None)
    assert np.all(np.isfinite(tl)) and tl[-1] < tl[0], tl
    np.testing.assert_allclose(tl, jl, rtol=F32_TOL, atol=F32_TOL)
    for n in jp:
        assert tp[n].dtype == np.float32, n
        np.testing.assert_allclose(tp[n], jp[n], rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=n)
    rel = _leaf_rel_errors(tm1, jm1)
    worst = max(rel, key=rel.get)
    assert rel[worst] < F32_TOL, (worst, rel[worst])


#: where the attention grad of the port is made wrong, by route
_ATTENTION_GRAD = {"composed": (nn_ops, ("bias_softmax_grad",)),
                   "flash": (attention_ops, ("flash_attention_bwd",
                                             "smalls_attention_bwd"))}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_leaf_grad_check_sees_one_wrong_attention(route, monkeypatch):
    """The leaf-by-leaf grad comparison (through the first moments) sees
    an attention grad 1% off in one of the six attentions, where the
    parameters after an Adam step hardly move: chip_smoke's card-vs-CPU
    check relies on it."""
    module, names = _ATTENTION_GRAD[route]
    calls = []

    def one_percent_off_once(right):
        def wrapped(*args):
            out = right(*args)
            calls.append(1)
            if len(calls) != 2:
                return out
            if isinstance(out, tuple):
                return tuple(t * 0.99 for t in out)
            return out * 0.99
        return wrapped

    for name in names:
        monkeypatch.setattr(module, name,
                            one_percent_off_once(getattr(module, name)))
    jl, tl, jp, tp, jm1, tm1 = _three_steps(route, monkeypatch, amp=None,
                                            steps=1)
    assert len(calls) == 6
    np.testing.assert_allclose(tl, jl, rtol=F32_TOL)   # the forward is right
    rel = _leaf_rel_errors(tm1, jm1)
    assert max(rel.values()) > 5e-3, rel
    # Adam's first step moves a parameter by at most lr whatever its
    # grad, so the parameters stay within 2 lr (plus rounding) regardless
    lr = 1e-4
    assert max(float(np.abs(tp[n] - jp[n]).max()) for n in jp) <= \
        2 * lr + 1e-7


#: bfloat16 AMP bounds.  Both packages cast the same operands to bf16
#: (8 bits of mantissa, 2**-8 relative) but round at different places
#: inside the fused ops (the JAX package's softmax adds the mask in bf16,
#: the port's kernel in f32; XLA and torch accumulate bf16 products
#: differently), so activations and grads agree to a few bf16 ulps.  The
#: loss, a mean over tokens, agrees to ``AMP_LOSS_RTOL`` (measured:
#: 3.1e-4).  Grads are compared through each parameter's first moment,
#: leaf by leaf, as ``|port - jax| / |jax|``: the bf16 roundings of
#: either package alone move a leaf 2.3-4.5% from its float32 value
#: (median 2.4-2.9%), and the two packages' leaves lie 2.8-4.7% apart
#: (median 3%), so ``AMP_GRAD_RTOL`` holds each leaf to twice that.
#: Parameters are not held element by element: an early Adam step moves
#: each by about lr (1e-4) whatever its grad's size, so only their mean
#: difference (measured: 6e-6 to 8e-6) says anything, and it reaches lr
#: only when many grads change sign.
AMP_LOSS_RTOL = 2e-3
AMP_GRAD_RTOL = 0.1
AMP_PARAM_MEAN = 5e-5


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_adam_steps_match_reference_amp(route, monkeypatch):
    jl, tl, jp, tp, jm1, tm1 = _three_steps(route, monkeypatch, amp=True)
    assert np.all(np.isfinite(tl)) and tl[-1] < tl[0], tl
    np.testing.assert_allclose(tl, jl, rtol=AMP_LOSS_RTOL)
    diffs = []
    for n in jp:
        assert tp[n].dtype == np.float32, n   # master weights stay f32
        diffs.append(np.abs(tp[n] - jp[n]).ravel())
    assert float(np.concatenate(diffs).mean()) < AMP_PARAM_MEAN
    rel = _leaf_rel_errors(tm1, jm1)
    worst = max(rel, key=rel.get)
    assert rel[worst] < AMP_GRAD_RTOL, (worst, rel[worst])


def _dropout_program(p, shape, seed=7):
    main, startup = pt.Program(), pt.Program()
    main.random_seed = seed
    with torch_names("do_"), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=list(shape), dtype="float32",
                           append_batch_size=False)
        x.stop_gradient = False
        y = pt.layers.dropout(x, dropout_prob=p)
        loss = pt.layers.reduce_sum(y)
        pt.append_backward(loss)
    return main, y


def test_dropout_keep_rate_seeding_and_grad():
    p, shape = 0.3, (64, 1024)
    main, y = _dropout_program(p, shape)
    x = np.ones(shape, np.float32)
    exe = pt.Executor(pt.CPUPlace())
    a, ga = exe.run(main, feed={"x": x}, fetch_list=[y, "x@GRAD"],
                    scope=pt.Scope())
    b, _ = exe.run(main, feed={"x": x}, fetch_list=[y, "x@GRAD"],
                   scope=pt.Scope())
    keep = float((a != 0).mean())
    # 65536 Bernoulli(0.7) draws: the keep rate is within 5 sigma
    sigma = (p * (1 - p) / a.size) ** 0.5
    assert abs(keep - (1 - p)) < 5 * sigma, keep
    assert set(np.unique(a)) <= {0.0, 1.0}       # downgrade_in_infer
    np.testing.assert_array_equal(ga, a)         # grad = Out@GRAD * Mask
    assert not np.array_equal(a, b)              # a new draw every step
    # a fresh executor on the same program repeats the first step's mask
    c, _ = pt.Executor(pt.CPUPlace()).run(
        main, feed={"x": x}, fetch_list=[y, "x@GRAD"], scope=pt.Scope())
    np.testing.assert_array_equal(c, a)
    # another program seed draws another mask
    other, y2 = _dropout_program(p, shape, seed=8)
    d, _ = pt.Executor(pt.CPUPlace()).run(
        other, feed={"x": x}, fetch_list=[y2, "x@GRAD"], scope=pt.Scope())
    assert not np.array_equal(d, a)


def test_run_steps_matches_run(monkeypatch):
    """``run_steps`` with one batch reused and with stacked batches gives
    the same losses as the same number of ``run`` calls."""
    tm, ts, tc, _ = _build(pt, torch_names, TT, "composed", monkeypatch)
    src, trg, _ = ROUTES["composed"]
    feeds = [TT.fake_batch(B, src, trg, _hp(TT), seed=s) for s in (1, 2, 3)]
    losses = {}
    for mode in ("run", "stacked", "reused"):
        scope = pt.Scope()
        exe = pt.Executor(pt.CPUPlace())
        exe.run(ts, scope=scope)
        if mode == "run":
            out = [exe.run(tm, feed=f, fetch_list=[tc], scope=scope)[0]
                   for f in feeds]
            losses[mode] = np.stack(out)
        elif mode == "stacked":
            stacked = {k: np.stack([f[k] for f in feeds]) for k in feeds[0]}
            (losses[mode],) = exe.run_steps(tm, feed=stacked,
                                            fetch_list=[tc], steps=3,
                                            scope=scope)
        else:
            (losses[mode],) = exe.run_steps(tm, feed=feeds[0],
                                            fetch_list=[tc], steps=3,
                                            scope=scope)
    assert losses["stacked"].shape == (3, 1)
    np.testing.assert_allclose(losses["stacked"], losses["run"],
                               rtol=F32_TOL, atol=F32_TOL)
    assert losses["reused"][0] == losses["run"][0]
    assert losses["reused"][2] < losses["reused"][0]


def test_training_entry_points_default_to_the_card(monkeypatch):
    """``Executor()`` (and so ``run`` and ``run_steps``) runs on cuda:0
    unless given ``CPUPlace()``; without CUDA it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.Executor()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        scope_from_numpy({"w": np.zeros(2, np.float32)})
    assert pt.Executor(pt.CPUPlace()).device.type == "cpu"


def test_scope_from_numpy_checks_the_program(monkeypatch):
    tm, _, _, _ = _build(pt, torch_names, TT, "composed", monkeypatch)
    names = persistable_names(tm)
    arrays = {n: np.zeros(tm.global_block().var(n).shape, np.float32)
              for n in names}
    missing = dict(arrays)
    missing.pop(next(n for n in names if n.startswith("tr_moment2")))
    with pytest.raises(KeyError, match="moment2"):
        scope_from_numpy(missing, pt.CPUPlace(), tm)
    bad = dict(arrays)
    bad[names[0]] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        scope_from_numpy(bad, pt.CPUPlace(), tm)
    scope = scope_from_numpy(arrays, pt.CPUPlace(), tm)
    assert all(scope.find_var(n) is not None for n in names)


def _clipped_sgd_program(pkg, names):
    """A two-layer MLP under SGD with an L2-decayed parameter, an L1
    decay on the rest and a global-norm gradient clip: every op that
    ``regularizer.py`` and ``clip.py`` append."""
    main, startup = pkg.Program(), pkg.Program()
    with names("cl_"), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[8, 6], dtype="float32",
                            append_batch_size=False)
        h = pkg.layers.fc(x, 16, act="relu", param_attr=pkg.ParamAttr(
            regularizer=pkg.regularizer.L2Decay(1e-2)))
        out = pkg.layers.fc(h, 1)
        loss = pkg.layers.mean(out * out)
        pkg.clip.set_gradient_clip(
            pkg.clip.GradientClipByGlobalNorm(clip_norm=0.5))
        pkg.optimizer.SGD(
            learning_rate=0.1,
            regularization=pkg.regularizer.L1Decay(1e-3)).minimize(loss)
    return main, startup, loss


def test_sgd_with_regularizers_and_clip_matches_reference():
    jm, js, jl = _clipped_sgd_program(fluid, jax_names)
    tm, ts, tl = _clipped_sgd_program(pt, torch_names)
    assert _strip(tm.to_dict()) == _strip(jm.to_dict())
    types = {op.type for op in tm.global_block().ops}
    assert {"sgd", "sign", "squared_l2_norm", "sqrt",
            "elementwise_max"} <= types
    jexe, jscope, tscope = _transplant(jm, js, tm)
    texe = pt.Executor(pt.CPUPlace())
    feed = {"x": np.random.RandomState(4).randn(8, 6).astype("float32")}
    for _ in range(2):
        (a,) = jexe.run(jm, feed=feed, fetch_list=[jl], scope=jscope)
        (b,) = texe.run(tm, feed=feed, fetch_list=[tl], scope=tscope)
        np.testing.assert_allclose(b, np.asarray(a), rtol=F32_TOL,
                                   atol=F32_TOL)
    for p in tm.global_block().all_parameters():
        np.testing.assert_allclose(to_numpy(tscope.find_var(p.name)),
                                   np.asarray(jscope.find_var(p.name)),
                                   rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=p.name)
