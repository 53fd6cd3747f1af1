"""Control flow in the port against the JAX package, on the CPU: the ten
cases of ``tests/test_control_flow.py`` (array read/write, the while sum,
the StaticRNN accumulate and grad, IfElse, Switch, the DynamicRNN
accumulate and train grad, the ragged reorder, nested bounded loops),
the grad through a loop from its pre-loop values, the array capacity,
the ``max_iters`` bound and rank-table ties.

Each program is built in both packages inside ``unique_name_scope``
(equal IR dicts, ignoring ``creation_site``), the JAX startup program is
run and its scope moved into a port scope, and both run the same feeds.
Integer results are equal (values: the port's counters are int64 where
the reference's are int32), float32 results agree to ``rtol = atol =
1e-6`` and grads to ``1e-5`` (float32 sums in another order through a
few steps of recurrence)."""

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.framework import unique_name_scope as jax_names
from paddle_tpu_torch.convert import persistable_names, scope_from_numpy
from paddle_tpu_torch.framework import unique_name_scope as torch_names

TOL, GRAD_TOL = 1e-6, 1e-5
PKGS = ((fluid, jax_names), (pt, torch_names))


def _strip(d):
    for block in d["blocks"]:
        for op in block["ops"]:
            op.pop("creation_site", None)
    return d


def _build(pkg, names, net):
    main, startup = pkg.Program(), pkg.Program()
    with names("cf_"), pkg.program_guard(main, startup):
        fetch = net(pkg)
    return main, startup, fetch


def _programs(net):
    """Both packages' programs of ``net``; their IR dicts are equal."""
    (jm, js, jf), (tm, ts, tf) = (_build(pkg, names, net)
                                  for pkg, names in PKGS)
    assert _strip(tm.to_dict()) == _strip(jm.to_dict())
    assert _strip(ts.to_dict()) == _strip(js.to_dict())
    return (jm, js, jf), (tm, ts, tf)


def _name(v):
    return v if isinstance(v, str) else v.name


def _run_both(net, feeds):
    """Run both packages from one state on each feed; every fetch agrees.
    Returns the port's fetches of the last feed and its executor."""
    (jm, js, jf), (tm, ts, tf) = _programs(net)
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jexe.run(js, scope=jscope)
    tscope = scope_from_numpy({n: np.asarray(jscope.find_var(n))
                               for n in persistable_names(tm)},
                              pt.CPUPlace(), tm)
    texe = pt.Executor(pt.CPUPlace())
    for step, feed in enumerate(feeds):
        want = jexe.run(jm, feed=feed, fetch_list=[_name(v) for v in jf],
                        scope=jscope)
        got = texe.run(tm, feed=feed, fetch_list=[_name(v) for v in tf],
                       scope=tscope)
        for v, w, g in zip(tf, want, got):
            w = np.asarray(w)
            assert g.shape == w.shape, _name(v)
            if np.issubdtype(w.dtype, np.floating):
                tol = GRAD_TOL if "@GRAD" in _name(v) else TOL
                np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                           err_msg=f"{step}: {_name(v)}")
            else:
                np.testing.assert_array_equal(g, w, err_msg=_name(v))
    return got, texe


def _f(seed, *shape):
    return np.random.RandomState(seed).rand(*shape).astype("float32")


# ---------------------------------------------------------------------------
# the ten cases of tests/test_control_flow.py
# ---------------------------------------------------------------------------

def test_array_read_write():
    def net(pkg):
        layers = pkg.layers
        x = layers.data(name="x", shape=[3, 4], append_batch_size=False)
        i = layers.zeros(shape=[1], dtype="int32")
        arr = layers.array_write(x, i)
        i2 = layers.fill_constant(shape=[1], dtype="int32", value=1)
        arr = layers.array_write(layers.scale(x, scale=2.0), i2, array=arr)
        total = layers.sums(input=[layers.array_read(arr, i),
                                   layers.array_read(arr, i2)])
        return [total, layers.array_length(arr)]

    xv = _f(0, 3, 4)
    (total, n), exe = _run_both(net, [{"x": xv}])
    np.testing.assert_allclose(total, xv * 3.0, rtol=1e-6)
    assert int(n[0]) == 2
    # the indices stay on the device: nothing is read on the host
    assert exe.last_run == {"while_trips": 0, "host_reads": 0}


def _while_sum(pkg):
    layers = pkg.layers
    d = [layers.data(name=f"d{k}", shape=[10], append_batch_size=False)
         for k in range(3)]
    i = layers.zeros(shape=[1], dtype="int32")
    i.stop_gradient = True
    init = layers.zeros(shape=[10], dtype="float32")
    mem_array = layers.array_write(x=init, i=i)
    data_array = layers.array_write(x=d[0], i=i)
    i = layers.increment(i)
    layers.array_write(d[1], i, array=data_array)
    i = layers.increment(i)
    layers.array_write(d[2], i, array=data_array)
    i = layers.zeros(shape=[1], dtype="int32")
    i.stop_gradient = True
    array_len = layers.fill_constant(shape=[1], dtype="int32", value=3)
    array_len.stop_gradient = True
    cond = layers.less_than(x=i, y=array_len)
    w = layers.While(cond=cond)
    with w.block():
        dv = layers.array_read(array=data_array, i=i)
        prev = layers.array_read(array=mem_array, i=i)
        result = layers.sums(input=[dv, prev])
        i = layers.increment(x=i, in_place=True)
        layers.array_write(result, i=i, array=mem_array)
        layers.less_than(x=i, y=array_len, cond=cond)
    return [layers.array_read(array=mem_array, i=array_len), i]


def test_while_sum():
    feed = {f"d{k}": _f(k, 10) for k in range(3)}
    (out, i), exe = _run_both(_while_sum, [feed])
    np.testing.assert_allclose(out, sum(feed.values()), rtol=1e-6)
    assert int(i[0]) == 3
    # the body reads data_array (capacity 128) and writes only
    # mem_array: 128 masked trips, the 3 live ones and 125 frozen, and
    # nothing read on the host
    assert exe.last_run == {"while_trips": 128, "host_reads": 0}


def test_static_rnn_accumulate():
    B, T, D = 4, 5, 3

    def net(pkg):
        layers = pkg.layers
        x = layers.data(name="x", shape=[B, T, D], append_batch_size=False)
        x.stop_gradient = False
        rnn = layers.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            mem = rnn.memory(shape=[D], batch_ref=x, init_value=0.0)
            s = layers.sums(input=[mem, xt])
            rnn.update_memory(mem, s)
            rnn.step_output(s)
        out = rnn()
        return [out, layers.reduce_sum(out)]

    xv = _f(1, B, T, D)
    (out, _), _ = _run_both(net, [{"x": xv}])
    np.testing.assert_allclose(out, np.cumsum(xv, axis=1), rtol=1e-5)


def test_static_rnn_grad():
    B, T, D, H = 2, 3, 4, 4

    def net(pkg):
        layers = pkg.layers
        x = layers.data(name="x", shape=[B, T, D], append_batch_size=False)
        x.stop_gradient = False
        rnn = layers.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            mem = rnn.memory(shape=[H], batch_ref=x, init_value=0.0)
            h = layers.fc(input=[xt, mem], size=H, act="tanh")
            rnn.update_memory(mem, h)
            rnn.step_output(h)
        loss = layers.reduce_mean(rnn())
        params = pkg.append_backward(loss)
        return [loss, "x@GRAD"] + [g.name for _, g in params]

    got, _ = _run_both(net, [{"x": _f(2, B, T, D)}])
    assert got[1].shape == (B, T, D) and np.abs(got[1]).sum() > 0


def test_ifelse_merge():
    def net(pkg):
        layers = pkg.layers
        x = layers.data(name="x", shape=[6, 1], append_batch_size=False)
        zero = layers.fill_constant(shape=[6, 1], dtype="float32",
                                    value=0.0)
        cond = layers.less_than(x=x, y=zero)
        ie = layers.IfElse(cond)
        with ie.true_block():
            ie.output(layers.scale(ie.input(x), scale=-1.0))
        with ie.false_block():
            ie.output(ie.input(x))
        return [ie()]

    xv = np.random.RandomState(3).randn(6, 1).astype("float32")
    (res,), _ = _run_both(net, [{"x": xv}])
    np.testing.assert_allclose(res, np.abs(xv), rtol=1e-6)


def test_switch_scalar():
    def net(pkg):
        layers = pkg.layers
        lr = layers.create_global_var(shape=[1], value=0.0, dtype="float32",
                                      persistable=True, name="lr")
        one = layers.fill_constant(shape=[1], dtype="float32", value=1.0)
        two = layers.fill_constant(shape=[1], dtype="float32", value=2.0)
        step = layers.data(name="step", shape=[1], append_batch_size=False)
        sw = layers.Switch()
        with sw.block():
            with sw.case(layers.less_than(step, one)):
                layers.assign(input=one, output=lr)
            with sw.default():
                layers.assign(input=two, output=lr)
        return [lr]

    feeds = [{"step": np.asarray([v], "float32")} for v in (0.5, 5.0)]
    (lr,), exe = _run_both(net, feeds)
    assert float(lr.reshape(())) == 2.0
    # each case runs and its outputs are selected on the device
    assert exe.last_run["host_reads"] == 0


SENT = (np.arange(18).reshape(9, 2).astype("float32") / 10.0,
        [[0, 3, 5, 9]])


def _sent(layers):
    sent = layers.data(name="sent", shape=[9, 2], append_batch_size=False,
                       lod_level=1)
    sent.stop_gradient = False
    return sent


def test_drnn_accumulate():
    def net(pkg):
        layers = pkg.layers
        drnn = layers.DynamicRNN()
        with drnn.block():
            word = drnn.step_input(_sent(layers))
            prev = drnn.memory(shape=[2], value=0.0)
            s = layers.sums(input=[word, prev])
            drnn.update_memory(prev, s)
            drnn.output(s)
        return [layers.sequence_last_step(drnn())]

    data, lod = SENT
    (last,), _ = _run_both(net, [{"sent": SENT}])
    np.testing.assert_allclose(
        last, np.stack([data[a:b].sum(0) for a, b in zip(lod[0],
                                                          lod[0][1:])]),
        rtol=1e-6)


def _drnn_train(pkg):
    layers = pkg.layers
    drnn = layers.DynamicRNN()
    with drnn.block():
        word = drnn.step_input(_sent(layers))
        prev = drnn.memory(shape=[4], value=0.0)
        h = layers.fc(input=[word, prev], size=4, act="tanh")
        drnn.update_memory(prev, h)
        drnn.output(h)
    loss = layers.reduce_mean(layers.sequence_last_step(drnn()))
    params = pkg.append_backward(loss)
    assert params, "no param grads generated through DynamicRNN"
    return [loss, "sent@GRAD"] + [g.name for _, g in params]


def test_drnn_train_grad():
    """The grads of the parameters inside the loop and of the fed
    sequence match the reference's, and none is zero: the grad op
    re-runs the loop from its pre-loop values (at backward time the env
    holds the final counter and a false condition, and a re-run from
    there would take no trip and give zero grads)."""
    got, exe = _run_both(_drnn_train, [{"sent": SENT}])
    for g in got[1:]:
        assert np.abs(g).sum() > 0
    # 4 forward trips (the step array's capacity, the longest sequence)
    # and 4 more in the grad's re-run, nothing read on the host
    assert exe.last_run == {"while_trips": 8, "host_reads": 0}


def test_while_grad_program_matches_reference():
    """``backward.py`` needs no new logic: the grad program, ``while_grad``
    with the sub-block, is the reference's (``_programs`` compares the IR
    dicts); ``while_grad`` takes grads for every float ``X``."""
    _, (tm, _, _) = _programs(_drnn_train)
    (wg,) = [op for op in tm.global_block().ops if op.type == "while_grad"]
    (w,) = [op for op in tm.global_block().ops if op.type == "while"]
    assert wg.attr("sub_block") is w.attr("sub_block")
    block = tm.global_block()
    floats = [n for n in w.input("X") if block.var(n).dtype == "float32"]
    assert [g for g in wg.output("X@GRAD") if g] == \
        [n + "@GRAD" for n in floats]


def _drnn_dropout(layers, data):
    drnn = layers.DynamicRNN()
    with drnn.block():
        word = drnn.step_input(data)
        prev = drnn.memory(shape=[data.shape[1]], value=0.0)
        s = layers.sums(input=[layers.dropout(word, dropout_prob=0.5), prev])
        drnn.update_memory(prev, s)
        drnn.output(s)
    return layers.sequence_last_step(drnn())


def _static_rnn_dropout(layers, data):
    rnn = layers.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(data)
        mem = rnn.memory(shape=[data.shape[2]], batch_ref=data,
                         init_value=0.0)
        s = layers.sums(input=[mem, layers.dropout(xt, dropout_prob=0.5)])
        rnn.update_memory(mem, s)
        rnn.step_output(s)
    return rnn()


@pytest.mark.parametrize("loop", ["dynamic_rnn", "static_rnn"])
def test_dropout_in_a_loop_body_grad_sees_the_forward_masks(loop):
    """The grad of a loop re-runs its body (auto-vjp of ``while`` /
    ``recurrent``); a dropout there must draw the masks the forward drew,
    although the run's RNG counter has moved on to the grad op by then.
    The loss is linear in the fed ``x`` (the masks fixed), so it equals
    ``<x@GRAD, x>`` only when the grad differentiates the forward that
    ran."""
    layers = pt.layers
    main, startup = pt.Program(), pt.Program()
    with torch_names("cfd_"), pt.program_guard(main, startup):
        if loop == "dynamic_rnn":
            x = layers.data(name="x", shape=[9, 16], append_batch_size=False,
                            lod_level=1)
            feed = {"x": (_f(5, 9, 16), [[0, 3, 5, 9]])}
        else:
            x = layers.data(name="x", shape=[3, 4, 16],
                            append_batch_size=False)
            feed = {"x": _f(5, 3, 4, 16)}
        x.stop_gradient = False
        loss = layers.reduce_sum(
            (_drnn_dropout if loop == "dynamic_rnn"
             else _static_rnn_dropout)(layers, x))
        pt.append_backward(loss)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    lv, gx = exe.run(main, feed=feed, fetch_list=[loss, "x@GRAD"],
                     scope=scope)
    xv = feed["x"][0] if loop == "dynamic_rnn" else feed["x"]
    # the dropout is live: some entries of x reach the loss, some do not
    assert (gx == 0).any() and (gx != 0).any()
    np.testing.assert_allclose(float(lv.reshape(())),
                               float((gx * xv).sum()), rtol=1e-5)


def test_reorder_lod_tensor_by_rank_ragged():
    def net(pkg):
        layers = pkg.layers
        x = layers.data(name="x", shape=[-1, 1], dtype="float32",
                        append_batch_size=False, lod_level=1)
        y = layers.data(name="y", shape=[-1, 1], dtype="float32",
                        append_batch_size=False, lod_level=1)
        table = layers.lod_rank_table(y)
        return [layers.reorder_lod_tensor_by_rank(x, table)]

    # y lengths [1, 3, 2] -> rank order (desc length): seq1, seq2, seq0
    lod = [[0, 1, 4, 6]]
    feed = {"x": (np.arange(6, dtype="f").reshape(6, 1), lod),
            "y": (np.zeros((6, 1), "f"), lod)}
    (out,), _ = _run_both(net, [feed])
    np.testing.assert_array_equal(out.reshape(-1), [1, 2, 3, 4, 5, 0])


def _nested(pkg, max_iters=7, n_outer=3):
    layers = pkg.layers
    i = layers.zeros(shape=[1], dtype="int32")
    i.stop_gradient = True
    n_o = layers.fill_constant(shape=[1], dtype="int32", value=n_outer)
    n_o.stop_gradient = True
    acc = layers.zeros(shape=[4], dtype="float32")
    cond = layers.less_than(x=i, y=n_o)
    w = layers.While(cond=cond)
    with w.block():
        j = layers.zeros(shape=[1], dtype="int32")
        j.stop_gradient = True
        n_i = layers.fill_constant(shape=[1], dtype="int32", value=2)
        n_i.stop_gradient = True
        icond = layers.less_than(x=j, y=n_i)
        iw = layers.While(cond=icond)
        with iw.block():
            layers.assign(acc + 1.0, output=acc)
            j2 = layers.increment(x=j, in_place=True)
            layers.less_than(x=j2, y=n_i, cond=icond)
        i2 = layers.increment(x=i, in_place=True)
        layers.less_than(x=i2, y=n_o, cond=cond)
    out = layers.reduce_sum(acc)
    prog = pkg.default_main_program()
    for blk in prog.blocks:
        for op in blk.ops:
            if op.type == "while":
                op.attrs["max_iters"] = max_iters
    return [out]


def test_nested_loops_with_slack_bounds():
    """Both loops bounded by a ``max_iters`` larger than their trip
    counts: 3 outer x 2 inner increments of a 4-vector sum to 24, and
    neither loop's bound check fires."""
    (out,), exe = _run_both(_nested, [{}])
    assert float(out.reshape(())) == 24.0
    # max_iters trips of each loop: 7 outer, each running 7 inner ones
    # (3 x 2 of them live), nothing read on the host
    assert exe.last_run == {"while_trips": 7 + 7 * 7, "host_reads": 0}


# ---------------------------------------------------------------------------
# bounds, capacity, ties
# ---------------------------------------------------------------------------

def test_max_iters_exhaustion_raises_in_both():
    """A loop still true after ``max_iters`` trips raises, naming the attr
    (the reference from its host callback after the bounded scan)."""
    (jm, js, jf), (tm, ts, tf) = _programs(
        lambda pkg: _nested(pkg, max_iters=2))
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(js, scope=fluid.Scope())
    with pytest.raises(Exception, match="max_iters"):
        jexe.run(jm, fetch_list=[jf[0].name], scope=fluid.Scope())
    with pytest.raises(RuntimeError, match="max_iters"):
        pt.Executor(pt.CPUPlace()).run(tm, fetch_list=[tf[0].name],
                                       scope=pt.Scope())


def _past_capacity(pkg):
    layers = pkg.layers
    x = layers.data(name="x", shape=[3], append_batch_size=False)
    arr = layers.array_write(x, layers.fill_constant(
        shape=[1], dtype="int64", value=128))
    return [layers.array_read(arr, layers.fill_constant(
        shape=[1], dtype="int64", value=127))]


def test_write_past_capacity():
    """The reference clamps a write at index >= capacity (128) to the last
    step and silently overwrites it (ROADMAP queue 3); the port raises."""
    (jm, _, jf), (tm, _, tf) = _programs(_past_capacity)
    xv = _f(4, 3)
    (got,) = fluid.Executor(fluid.CPUPlace()).run(
        jm, feed={"x": xv}, fetch_list=jf, scope=fluid.Scope())
    np.testing.assert_array_equal(np.asarray(got), xv)
    with pytest.raises(IndexError, match="capacity of 128"):
        pt.Executor(pt.CPUPlace()).run(tm, feed={"x": xv}, fetch_list=tf,
                                       scope=pt.Scope())


def test_rank_table_ties_keep_their_order():
    """Equal lengths keep the feed's order (a stable sort): the arrays,
    the reorder and the restored tensor agree with the reference."""
    def net(pkg):
        layers = pkg.layers
        x = layers.data(name="x", shape=[-1, 2], dtype="float32",
                        append_batch_size=False, lod_level=1)
        table = layers.lod_rank_table(x)
        arr = layers.lod_tensor_to_array(x, table)
        step0 = layers.array_read(arr, layers.zeros(shape=[1],
                                                    dtype="int64"))
        back = layers.array_to_lod_tensor(arr, table)
        return [layers.reorder_lod_tensor_by_rank(x, table), step0, back,
                layers.max_sequence_len(table)]

    # lengths 2, 3, 2, 3, 1: order 1, 3, 0, 2, 4
    lod = [[0, 2, 5, 7, 10, 11]]
    xv = np.arange(22, dtype="float32").reshape(11, 2)
    (reordered, step0, back, n), _ = _run_both(net, [{"x": (xv, lod)}])
    np.testing.assert_array_equal(step0[:, 0], xv[[2, 7, 0, 5, 10], 0])
    np.testing.assert_array_equal(back, xv)
    assert int(n[0]) == 3


def test_conditional_block_false_gives_zeros_of_the_branch():
    """A false condition keeps an output that existed and gives zeros of
    the true branch's shape for one that did not (the reference's
    ``skip_branch``)."""
    def net(pkg):
        layers = pkg.layers
        x = layers.data(name="x", shape=[2, 3], append_batch_size=False)
        flag = layers.data(name="flag", shape=[1], append_batch_size=False)
        kept = layers.scale(x, scale=1.0)
        block = pkg.default_main_program().current_block()
        fresh = block.create_var(name="fresh", dtype="float32")
        cb = layers.ConditionalBlock(
            [layers.greater_than(flag, layers.fill_constant(
                shape=[1], dtype="float32", value=0.0))],
            is_scalar_condition=True)
        with cb.block():
            layers.assign(layers.scale(x, scale=3.0), output=kept)
            layers.assign(layers.scale(x, scale=5.0), output=fresh)
        return [kept, fresh]

    xv = _f(6, 2, 3)
    feeds = [{"x": xv, "flag": np.float32([v])} for v in (1.0, -1.0)]
    (kept, fresh), _ = _run_both(net, feeds)
    np.testing.assert_allclose(kept, xv, rtol=1e-6)
    np.testing.assert_array_equal(fresh, np.zeros((2, 3), "float32"))


def test_print_passes_its_input_on(capsys):
    """``layers.Print`` returns its input and prints the message with the
    value (its grad passes the cotangent through)."""
    def net(pkg):
        layers = pkg.layers
        x = layers.data(name="x", shape=[2, 3], append_batch_size=False)
        x.stop_gradient = False
        y = layers.Print(x, message="peek")
        loss = layers.reduce_sum(layers.scale(y, scale=2.0))
        pkg.append_backward(loss)
        return [y, "x@GRAD"]

    xv = _f(7, 2, 3)
    (y, gx), _ = _run_both(net, [{"x": xv}])
    np.testing.assert_array_equal(y, xv)
    np.testing.assert_array_equal(gx, np.full((2, 3), 2.0, "float32"))
    assert "peek" in capsys.readouterr().out


def test_tensor_array_steps_sum_and_vjp():
    """The port's array alone: a write past the length leaves zero steps
    between, a read of an unwritten step is zeros, a write turned off by
    its gate changes neither row nor length, ``sum`` adds the buffers (a
    shorter one padded with zero steps), and an array crosses
    ``torch.func.vjp`` as its buffer, a cotangent array matched to its
    output's buffer by the auto-vjp's rule (zero steps past it)."""
    import torch
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.ops.control_flow_ops import TensorArray
    aux = {}
    x = torch.arange(3.0)
    a = TensorArray(capacity=4).write(torch.tensor([2]), x, aux)
    assert int(a.length) == 3 and torch.equal(a.read(torch.tensor(0), aux),
                                              torch.zeros(3))
    assert torch.equal(a.read(torch.tensor([3]), aux), torch.zeros(3))
    off = a.write(torch.tensor(0), x + 1, aux, keep=torch.tensor(False))
    assert torch.equal(off.data, a.data) and int(off.length) == 3
    assert int(registry.fault_word(aux)[0]) == 0
    b = TensorArray(capacity=1).write(torch.tensor(0), x, aux)
    s = a + b
    assert s.capacity == 4 and int(s.length) == 3
    assert s.data.tolist() == [[0, 1, 2], [0, 0, 0], [0, 1, 2], [0, 0, 0]]

    def f(buf, w):
        return buf * w

    out, vjp = torch.func.vjp(f, a.data, torch.ones(3))
    cot = registry._match_cotangent_dtype(
        TensorArray(capacity=2).write(torch.tensor(0), torch.ones(3), aux),
        out)
    g_buf, g_w = vjp(cot)
    assert g_buf.tolist() == [[1, 1, 1]] + [[0, 0, 0]] * 3
    assert g_w.tolist() == [0, 0, 0]
    assert a.with_data(g_buf).capacity == 4
