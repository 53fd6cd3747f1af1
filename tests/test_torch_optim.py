"""The rest of the port's training machinery against the JAX package's,
on the CPU: the eight further optimizers with their update ops, the six
learning-rate schedules, ``gaussian_random``, ``nets.glu`` and
``nets.scaled_dot_product_attention``, ``gen_lm_train_program`` and the
shared op-metadata registry (``analysis/opmeta.py``).

The same program is built in both packages inside ``unique_name_scope``
(equal IR dicts, ignoring ``creation_site``), the JAX startup program is
run and its whole scope (parameters, accumulators, the int64 step
counter) is moved into a port scope, and both take three steps on one
numpy-seeded feed.  Parameters, accumulators and the fetched learning
rate agree to ``rtol = atol = 1e-6`` (float32 elementwise arithmetic in
the same order; XLA and torch differ in the last bit of ``sqrt``, ``pow``
and division); ``ftrl`` to ``1e-5`` (its ``pow(sq, 0.5) / lr`` divides a
last-bit difference by a small learning rate).  Forward values and
grads of composed layers agree to ``1e-5`` (sums in different orders).
Random ops are checked by moments and seeding, not bit for bit.
"""

import os

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.analysis import opmeta as jax_opmeta
from paddle_tpu.framework import unique_name_scope as jax_names
from paddle_tpu.models import gen_lm as JG
from paddle_tpu_torch.analysis import opmeta
from paddle_tpu_torch.convert import (persistable_names, scope_from_numpy,
                                      to_numpy)
from paddle_tpu_torch.framework import unique_name_scope as torch_names
from paddle_tpu_torch.models import gen_lm as TG
from paddle_tpu_torch.ops import registry

STATE_TOL = 1e-6
FTRL_TOL = 1e-5
F32_TOL = 1e-5
PKGS = ((fluid, jax_names), (pt, torch_names))


def _strip(d):
    for block in d["blocks"]:
        for op in block["ops"]:
            op.pop("creation_site", None)
    return d


def _mlp_loss(pkg):
    x = pkg.layers.data(name="x", shape=[8, 6], dtype="float32",
                        append_batch_size=False)
    h = pkg.layers.fc(x, 16, act="relu")
    out = pkg.layers.fc(h, 1)
    return pkg.layers.mean(out * out)


def _build(pkg, names, make_lr, make_opt):
    main, startup = pkg.Program(), pkg.Program()
    with names("op_"), pkg.program_guard(main, startup):
        loss = _mlp_loss(pkg)
        lr = make_lr(pkg)
        make_opt(pkg, lr).minimize(loss)
    return main, startup, loss, lr


def _transplant(js, tm):
    """Run the JAX startup program and carry every persistable variable
    the port's program uses into a port scope."""
    jexe = fluid.Executor(fluid.CPUPlace())
    jscope = fluid.Scope()
    jexe.run(js, scope=jscope)
    arrays = {n: np.asarray(jscope.find_var(n))
              for n in persistable_names(tm)}
    return jexe, jscope, scope_from_numpy(arrays, pt.CPUPlace(), tm)


def _run_both(make_lr, make_opt, tol, steps=3):
    (jm, js, jl, jlr), (tm, ts, tl, tlr) = (
        _build(pkg, names, make_lr, make_opt) for pkg, names in PKGS)
    assert _strip(tm.to_dict()) == _strip(jm.to_dict())
    assert _strip(ts.to_dict()) == _strip(js.to_dict())
    jexe, jscope, tscope = _transplant(js, tm)
    texe = pt.Executor(pt.CPUPlace())
    feed = {"x": np.random.RandomState(4).randn(8, 6).astype("float32")}
    fetch = (lambda loss, lr: [loss] + ([lr] if not isinstance(lr, float)
                                        else []))
    losses = []
    for _ in range(steps):
        a = jexe.run(jm, feed=feed, fetch_list=fetch(jl, jlr), scope=jscope)
        b = texe.run(tm, feed=feed, fetch_list=fetch(tl, tlr), scope=tscope)
        for x, y in zip(a, b):          # the loss and the learning rate
            np.testing.assert_allclose(y, np.asarray(x), rtol=tol, atol=tol)
        losses.append(float(b[0].reshape(())))
    names = persistable_names(tm)
    for n in names:
        want = np.asarray(jscope.find_var(n))
        got = to_numpy(tscope.find_var(n))
        var = tm.global_block().var(n)
        assert str(got.dtype) == var.dtype, (n, got.dtype)
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=n)
    assert losses[-1] != losses[0]          # the parameters did move
    return tm, names, tscope


OPTIMIZERS = {
    "momentum": (lambda p, lr: p.optimizer.Momentum(lr, momentum=0.9),
                 "momentum", ["velocity"]),
    "nesterov": (lambda p, lr: p.optimizer.Momentum(lr, momentum=0.9,
                                                    use_nesterov=True),
                 "momentum", ["velocity"]),
    "adagrad": (lambda p, lr: p.optimizer.Adagrad(lr), "adagrad",
                ["moment"]),
    "adamax": (lambda p, lr: p.optimizer.Adamax(lr), "adamax",
               ["moment", "inf_norm", "beta1_pow_acc"]),
    "decayed_adagrad": (lambda p, lr: p.optimizer.DecayedAdagrad(lr),
                        "decayed_adagrad", ["moment"]),
    "adadelta": (lambda p, lr: p.optimizer.Adadelta(lr), "adadelta",
                 ["_avg_squared_grad", "_avg_squared_update"]),
    "rmsprop": (lambda p, lr: p.optimizer.RMSProp(lr, momentum=0.5),
                "rmsprop", ["momentum", "mean_square"]),
    "ftrl": (lambda p, lr: p.optimizer.Ftrl(lr, l1=0.01, l2=0.01), "ftrl",
             ["squared", "linear"]),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_steps_match_reference(name):
    make_opt, op_type, accumulators = OPTIMIZERS[name]
    tol = FTRL_TOL if name == "ftrl" else STATE_TOL
    tm, names, _ = _run_both(lambda p: 0.05, make_opt, tol)
    ops = [op for op in tm.global_block().ops if op.type == op_type]
    assert len(ops) == 4                    # two weights, two biases
    for acc in accumulators:                # moved across by name
        assert sum(n.startswith(f"op_{acc}.") for n in names) == 4, acc


SCHEDULES = {
    "noam": lambda p: p.layers.noam_decay(16, 4),
    "exponential": lambda p: p.layers.exponential_decay(0.1, 2, 0.5),
    "exponential_staircase": lambda p: p.layers.exponential_decay(
        0.1, 2, 0.5, staircase=True),
    "natural_exp": lambda p: p.layers.natural_exp_decay(0.1, 2, 0.5),
    "natural_exp_staircase": lambda p: p.layers.natural_exp_decay(
        0.1, 2, 0.5, staircase=True),
    "inverse_time": lambda p: p.layers.inverse_time_decay(0.1, 2, 0.5),
    "inverse_time_staircase": lambda p: p.layers.inverse_time_decay(
        0.1, 2, 0.5, staircase=True),
    "polynomial": lambda p: p.layers.polynomial_decay(0.1, 2, 0.01, 2.0),
    "polynomial_cycle": lambda p: p.layers.polynomial_decay(
        0.1, 2, 0.01, 2.0, cycle=True),
    "piecewise": lambda p: p.layers.piecewise_decay([1, 2], [0.1, 0.05,
                                                             0.01]),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedule_steps_match_reference(name):
    """Each schedule drives ``Momentum`` through a ``Variable`` learning
    rate; the fetched rate, the int64 step counter and the state agree
    over three steps."""
    tm, names, tscope = _run_both(SCHEDULES[name],
                                  OPTIMIZERS["momentum"][0], STATE_TOL)
    assert "@LR_DECAY_COUNTER@" in names
    counter = tscope.find_var("@LR_DECAY_COUNTER@")
    assert counter.dtype == torch.int64
    begin = 1 if name == "noam" else 0
    assert int(counter.reshape(())) == begin + 2


def test_piecewise_decay_values_and_length_check():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        lr = pt.layers.piecewise_decay([1, 3], [0.1, 0.05, 0.01])
        with pytest.raises(ValueError, match="len"):
            pt.layers.piecewise_decay([1, 3], [0.1])
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    got = [float(exe.run(main, fetch_list=[lr], scope=scope)[0].reshape(()))
           for _ in range(5)]
    np.testing.assert_allclose(got, [0.1, 0.05, 0.05, 0.01, 0.01],
                               rtol=1e-6)


def test_param_learning_rate_scales_a_variable_rate():
    """``ParamAttr(learning_rate=)`` scales the scheduled rate by a
    ``scale`` op, as in the reference."""
    def build(pkg, names):
        main, startup = pkg.Program(), pkg.Program()
        with names("pl_"), pkg.program_guard(main, startup):
            x = pkg.layers.data(name="x", shape=[4, 3], dtype="float32",
                                append_batch_size=False)
            out = pkg.layers.fc(x, 2, param_attr=pkg.ParamAttr(
                learning_rate=0.5))
            loss = pkg.layers.mean(out)
            pkg.optimizer.Adagrad(
                pkg.layers.inverse_time_decay(0.1, 2, 0.5)).minimize(loss)
        return main
    jm, tm = (build(pkg, names) for pkg, names in PKGS)
    assert _strip(tm.to_dict()) == _strip(jm.to_dict())
    assert "scale" in [op.type for op in tm.global_block().ops]


def test_optimizer_rejects_a_learning_rate_of_another_type():
    with pytest.raises(TypeError, match="float or Variable"):
        pt.optimizer.Momentum(1, momentum=0.9)


@pytest.mark.parametrize("op_type", ["proximal_gd", "proximal_adagrad"])
def test_proximal_ops_match_reference(op_type):
    """The two update ops no optimizer class appends, run as ops."""
    rng = np.random.RandomState(5)
    state = {"p": rng.randn(4, 3), "g": rng.randn(4, 3),
             "m": rng.rand(4, 3) + 0.1, "lr": np.asarray([0.1])}
    state = {k: v.astype("float32") for k, v in state.items()}

    def build(pkg):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            block = main.global_block()
            for n, v in state.items():
                block.create_var(name=n, shape=v.shape, dtype="float32",
                                 persistable=True)
            ins = {"Param": ["p"], "Grad": ["g"], "LearningRate": ["lr"]}
            outs = {"ParamOut": ["p"]}
            if op_type == "proximal_adagrad":
                ins["Moment"], outs["MomentOut"] = ["m"], ["m"]
            block.append_op(type=op_type, inputs=ins, outputs=outs,
                            attrs={"l1": 0.05, "l2": 0.1})
        return main
    jscope = fluid.Scope()
    for n, v in state.items():
        jscope.set_var(n, v)
    fluid.Executor(fluid.CPUPlace()).run(build(fluid), scope=jscope)
    tscope = scope_from_numpy(state, pt.CPUPlace())
    pt.Executor(pt.CPUPlace()).run(build(pt), scope=tscope)
    for n in ("p", "m"):
        got = to_numpy(tscope.find_var(n))
        np.testing.assert_allclose(got, np.asarray(jscope.find_var(n)),
                                   rtol=STATE_TOL, atol=STATE_TOL)
    assert not np.allclose(to_numpy(tscope.find_var("p")), state["p"])


def test_model_average_matches_reference():
    """``average_accumulates`` over four steps with a window of three
    (the sum restarts), then ``apply`` swaps the averages in and
    ``restore`` the parameters back, in both packages."""
    def build(pkg, names):
        main, startup = pkg.Program(), pkg.Program()
        with names("ma_"), pkg.program_guard(main, startup):
            loss = _mlp_loss(pkg)
            pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
            avg = pkg.optimizer.ModelAverage(max_average_window=3)
        return main, startup, loss, avg
    (jm, js, jl, javg), (tm, ts, tl, tavg) = (build(pkg, names)
                                              for pkg, names in PKGS)
    assert _strip(tm.to_dict()) == _strip(jm.to_dict())
    assert _strip(ts.to_dict()) == _strip(js.to_dict())
    jexe, jscope, tscope = _transplant(js, tm)
    texe = pt.Executor(pt.CPUPlace())
    feed = {"x": np.random.RandomState(4).randn(8, 6).astype("float32")}
    names = persistable_names(tm)
    assert sum(n.endswith("@SUM_ACC") for n in names) == 4
    assert sum(n.endswith("@CNT_ACC") for n in names) == 4
    for _ in range(4):
        jexe.run(jm, feed=feed, fetch_list=[jl], scope=jscope)
        texe.run(tm, feed=feed, fetch_list=[tl], scope=tscope)
    params = [p.name for p in tm.global_block().all_parameters()]

    def both(check):
        for n in names:
            check(n, to_numpy(tscope.find_var(n)),
                  np.asarray(jscope.find_var(n)))

    def close(n, got, want):
        np.testing.assert_allclose(got, want, rtol=STATE_TOL,
                                   atol=STATE_TOL, err_msg=n)
    both(close)
    count = to_numpy(tscope.find_var(params[0] + "@CNT_ACC"))
    assert float(count.reshape(())) == 1.0   # restarted at the fourth step
    before = {n: to_numpy(tscope.find_var(n)).copy() for n in params}
    with fluid.scope_guard(jscope), pt.scope_guard(tscope):
        with javg.apply(jexe), tavg.apply(texe):
            both(close)
            for n in params:                 # sum / count of one step
                np.testing.assert_allclose(
                    to_numpy(tscope.find_var(n)),
                    to_numpy(tscope.find_var(n + "@SUM_ACC")), rtol=1e-6)
    for n in params:
        np.testing.assert_array_equal(to_numpy(tscope.find_var(n)),
                                      before[n])


# ---------------------------------------------------------------------------
# gaussian_random
# ---------------------------------------------------------------------------

def _gaussian_program(seed, op_seed=0, shape=(256, 512)):
    main = pt.Program()
    main.random_seed = seed
    with pt.program_guard(main, pt.Program()):
        out = pt.layers.gaussian_random(list(shape), mean=1.5, std=0.5,
                                        seed=op_seed)
    return main, out


def test_gaussian_random_moments_and_seeding():
    def draw(seed, op_seed=0):
        main, out = _gaussian_program(seed, op_seed)
        return pt.Executor(pt.CPUPlace()).run(main, fetch_list=[out],
                                              scope=pt.Scope())[0]
    a = draw(7)
    assert a.shape == (256, 512) and a.dtype == np.float32
    n = a.size
    # 131072 draws: the mean within 5 sigma / sqrt(n), the std within 5
    # standard errors (sigma / sqrt(2 n)), skewness and excess kurtosis
    # within 5 of theirs (sqrt(6 / n), sqrt(24 / n))
    assert abs(a.mean() - 1.5) < 5 * 0.5 / n ** 0.5
    assert abs(a.std() - 0.5) < 5 * 0.5 / (2 * n) ** 0.5
    z = (a - a.mean()) / a.std()
    assert abs((z ** 3).mean()) < 5 * (6 / n) ** 0.5
    assert abs((z ** 4).mean() - 3) < 5 * (24 / n) ** 0.5
    np.testing.assert_array_equal(draw(7), a)       # the program's seed
    assert not np.array_equal(draw(8), a)
    b = draw(7, op_seed=3)                          # the op's own seed wins
    assert not np.array_equal(b, a)
    np.testing.assert_array_equal(draw(8, op_seed=3), b)


def test_normal_initializer_runs_and_matches_reference_ir():
    def build(pkg, names):
        main, startup = pkg.Program(), pkg.Program()
        with names("gi_"), pkg.program_guard(main, startup):
            x = pkg.layers.data(name="x", shape=[4, 8], dtype="float32",
                                append_batch_size=False)
            pkg.layers.fc(x, 64, param_attr=pkg.ParamAttr(
                initializer=pkg.initializer.Normal(0.0, 0.02)))
        return main, startup
    (jm, js), (tm, ts) = (build(pkg, names) for pkg, names in PKGS)
    assert _strip(ts.to_dict()) == _strip(js.to_dict())
    assert "gaussian_random" in [op.type for op in ts.global_block().ops]
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(ts, scope=scope)
    w = to_numpy(scope.find_var("gi_gi_fc_0.w_0"))
    assert w.shape == (8, 64)
    assert abs(w.std() - 0.02) < 0.004 and abs(w.mean()) < 0.005


# ---------------------------------------------------------------------------
# nets
# ---------------------------------------------------------------------------

def _forward_and_grads(build, feed):
    """Build ``loss = mean(net(inputs) * w)`` in both packages, compare
    the IR, the forward value and every input's grad."""
    results = []
    for pkg, names in PKGS:
        main, startup = pkg.Program(), pkg.Program()
        with names("nt_"), pkg.program_guard(main, startup):
            ins = []
            for n, v in feed.items():
                var = pkg.layers.data(name=n, shape=list(v.shape),
                                      dtype="float32",
                                      append_batch_size=False)
                var.stop_gradient = False
                ins.append(var)
            out = build(pkg, *ins)
            w = pkg.layers.assign(np.random.RandomState(1).rand(
                *[d for d in out.shape]).astype("float32"))
            pkg.append_backward(pkg.layers.mean(out * w))
        exe = pkg.Executor(pkg.CPUPlace())
        fetched = exe.run(main, feed=feed,
                          fetch_list=[out] + [n + "@GRAD" for n in feed],
                          scope=pkg.Scope())
        results.append((main, [np.asarray(x) for x in fetched]))
    (jm, want), (tm, got) = results
    assert _strip(tm.to_dict()) == _strip(jm.to_dict())
    for a, b in zip(got, want):
        assert a.shape == b.shape and np.abs(b).sum() > 0
        np.testing.assert_allclose(a, b, rtol=F32_TOL, atol=F32_TOL)
    return tm


def test_nets_glu_matches_reference():
    x = np.random.RandomState(2).randn(3, 5, 8).astype("float32")
    tm = _forward_and_grads(lambda pkg, v: pkg.nets.glu(v, dim=-1),
                            {"x": x})
    assert [op.type for op in tm.global_block().ops][:3] == \
        ["split", "sigmoid", "elementwise_mul"]


@pytest.mark.parametrize("num_heads", [1, 4])
def test_nets_scaled_dot_product_attention_matches_reference(num_heads):
    rng = np.random.RandomState(3)
    feed = {"q": rng.randn(2, 6, 16).astype("float32"),
            "k": rng.randn(2, 9, 16).astype("float32"),
            "v": rng.randn(2, 9, 8).astype("float32")}
    _forward_and_grads(
        lambda pkg, q, k, v: pkg.nets.scaled_dot_product_attention(
            q, k, v, num_heads=num_heads), feed)


def test_nets_concat_of_splits_roundtrips_with_grad():
    x = np.random.RandomState(6).randn(4, 6).astype("float32")

    def build(pkg, v):
        a, b, c = pkg.layers.split(v, [1, 2, 3], dim=1)
        return pkg.layers.concat([c, a, b], axis=1)
    _forward_and_grads(build, {"x": x})


def test_nets_validation_and_helpers_that_wait():
    with pt.program_guard(pt.Program(), pt.Program()):
        q = pt.layers.data(name="q", shape=[2, 6, 16], dtype="float32",
                           append_batch_size=False)
        k = pt.layers.data(name="k", shape=[2, 9, 12], dtype="float32",
                           append_batch_size=False)
        with pytest.raises(ValueError, match="same hidden size"):
            pt.nets.scaled_dot_product_attention(q, k, k)
        with pytest.raises(ValueError, match="divisible"):
            pt.nets.scaled_dot_product_attention(q, q, q, num_heads=5)
    # sequence_conv_pool no longer waits for layers.sequence: it builds
    # the reference's IR (tests/test_torch_stacked_lstm.py trains it)
    progs = []
    for pkg, names in PKGS:
        main, startup = pkg.Program(), pkg.Program()
        with names("sc_"), pkg.program_guard(main, startup):
            x = pkg.layers.data(name="x", shape=[-1, 16], dtype="float32",
                                append_batch_size=False, lod_level=1)
            pkg.nets.sequence_conv_pool(x, 4, 3)
        progs.append((_strip(main.to_dict()), _strip(startup.to_dict())))
    assert progs[0] == progs[1]


def test_nets_conv_helpers_build_reference_ir():
    """The convolution helpers build the reference's IR and, now that
    their ops lower, run: the inference clone (dropout and batch norm in
    test mode) gives the reference's output from one scope."""
    def build(pkg, names):
        main, startup = pkg.Program(), pkg.Program()
        with names("cv_"), pkg.program_guard(main, startup):
            img = pkg.layers.data(name="img", shape=[2, 3, 16, 16],
                                  dtype="float32", append_batch_size=False)
            a = pkg.nets.simple_img_conv_pool(img, 4, 3, 2, 2, "relu")
            out = pkg.nets.img_conv_group(
                a, [4, 4], 2, conv_act="relu",
                conv_with_batchnorm=[True, False],
                conv_batchnorm_drop_rate=[0.1, 0.0])
        return main, startup, out
    (jm, js, jo), (tm, ts, to) = (build(pkg, names) for pkg, names in PKGS)
    assert _strip(tm.to_dict()) == _strip(jm.to_dict())
    assert _strip(ts.to_dict()) == _strip(js.to_dict())
    jexe, jscope, tscope = _transplant(js, tm)
    feed = {"img": np.random.RandomState(5).randn(2, 3, 16, 16)
            .astype("float32")}
    (want,) = jexe.run(jm.clone(for_test=True), feed=feed, fetch_list=[jo],
                       scope=jscope)
    (got,) = pt.Executor(pt.CPUPlace()).run(
        tm.clone(for_test=True), feed=feed, fetch_list=[to], scope=tscope)
    assert got.shape == (2, 4, 6, 6)
    np.testing.assert_allclose(got, np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


# ---------------------------------------------------------------------------
# gen_lm_train_program
# ---------------------------------------------------------------------------

def _gen_train(pkg, names, mod, B=2, T=12):
    main, startup = pkg.Program(), pkg.Program()
    with names("gt_"), pkg.program_guard(main, startup):
        cost, feeds = mod.gen_lm_train_program(B, T)
        pkg.optimizer.Adam(learning_rate=1e-3).minimize(cost)
    return main, startup, cost, feeds


def test_gen_lm_train_program_matches_reference():
    jm, js, jc, jf = _gen_train(fluid, jax_names, JG)
    tm, ts, tc, tf = _gen_train(pt, torch_names, TG)
    assert tf == jf == ["gen_ids", "gen_labels"]
    assert _strip(tm.to_dict()) == _strip(jm.to_dict())
    assert _strip(ts.to_dict()) == _strip(js.to_dict())
    types = [op.type for op in tm.global_block().ops]
    assert types.count("softmax") == types.count("softmax_grad") == 2
    jexe, jscope, tscope = _transplant(js, tm)
    texe = pt.Executor(pt.CPUPlace())
    rng = np.random.RandomState(9)
    feed = {"gen_ids": rng.randint(0, 64, (2, 12)).astype("int32"),
            "gen_labels": rng.randint(0, 64, (2, 12)).astype("int32")}
    tl = []
    for _ in range(3):
        (a,) = jexe.run(jm, feed=feed, fetch_list=[jc], scope=jscope)
        (b,) = texe.run(tm, feed=feed, fetch_list=[tc], scope=tscope)
        np.testing.assert_allclose(b, np.asarray(a), rtol=F32_TOL,
                                   atol=F32_TOL)
        tl.append(float(b.reshape(())))
    assert tl[-1] < tl[0]
    for n in persistable_names(tm):
        np.testing.assert_allclose(
            to_numpy(tscope.find_var(n)), np.asarray(jscope.find_var(n)),
            rtol=F32_TOL, atol=F32_TOL, err_msg=n)


# ---------------------------------------------------------------------------
# analysis/opmeta.py
# ---------------------------------------------------------------------------

SRC_ROOT = os.path.dirname(os.path.abspath(pt.__file__))


def test_opmeta_lists_equal_the_reference():
    assert opmeta.EFFECT_OP_TYPES == jax_opmeta.EFFECT_OP_TYPES
    assert opmeta.ELEMENTWISE_PURE_OPS == jax_opmeta.ELEMENTWISE_PURE_OPS
    assert opmeta.__all__ == jax_opmeta.__all__


def test_effect_op_list_has_one_owner_in_the_port():
    """The scanner of ``tests/test_opmeta.py`` over the port: a module
    other than opmeta that names both marker ops is growing its own
    effect-op list."""
    owners = []
    for dirpath, _, files in os.walk(SRC_ROOT):
        for n in sorted(files):
            if n.endswith(".py"):
                path = os.path.join(dirpath, n)
                with open(path) as f:
                    text = f.read()
                if "channel_send" in text and "save_combine" in text:
                    owners.append(os.path.relpath(path, SRC_ROOT))
    assert owners == [os.path.join("analysis", "opmeta.py")]


def test_opmeta_classification_sanity():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=[4], dtype="float32")
        h = pt.layers.fc(x, 4, act="relu")
        pt.layers.dropout(h, dropout_prob=0.5)
        cost = pt.layers.mean(h)
        pt.optimizer.Momentum(pt.layers.noam_decay(4, 2),
                              momentum=0.9).minimize(cost)
    block = main.global_block()
    by_type = {}
    for op in block.ops:
        by_type.setdefault(op.type, op)

    relu = by_type["relu"]
    assert opmeta.is_pure(relu, block, registry)
    assert opmeta.is_pure(relu, block)              # the default registry
    assert not opmeta.needs_rng_key(relu, registry)
    assert not opmeta.is_host(relu) and not opmeta.uses_rng(relu)
    assert relu.type in opmeta.ELEMENTWISE_PURE_OPS

    dropout = by_type["dropout"]
    assert opmeta.has_effects(dropout, registry)    # RNG = effect
    assert opmeta.needs_rng_key(dropout, registry)
    assert dropout.type not in opmeta.ELEMENTWISE_PURE_OPS

    momentum = by_type["momentum"]
    assert opmeta.has_effects(momentum, registry)   # in-place state
    assert sorted(opmeta.stateful_output_names(momentum, registry)) == \
        sorted(momentum.output("ParamOut") + momentum.output("VelocityOut"))
    assert opmeta.writes_persistable(momentum, block)

    increment = by_type["increment"]                # the LR step counter
    assert opmeta.has_effects(increment) and \
        opmeta.writes_persistable(increment, block)
    assert not opmeta.is_pure(increment, block)

    mystery = pt.Operator(block, "never_registered", {"X": ["x"]},
                          {"Out": ["m"]}, {})
    assert opmeta.needs_rng_key(mystery, registry)
    assert opmeta.stateful_output_names(mystery) == []
    relu_grad = pt.Operator(block, "relu_grad", {}, {}, {})
    assert not opmeta.needs_rng_key(relu_grad, registry)

    # an op that carries a sub-block is effectful and keyed
    body = main.create_block()
    main.rollback()
    carrier = pt.Operator(block, "never_registered", {}, {},
                          {"sub_block": body})
    assert list(opmeta.sub_blocks(carrier)) == [body]
    assert opmeta.has_sub_block(carrier) and opmeta.has_effects(carrier)
