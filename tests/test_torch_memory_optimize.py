"""The port's memory-optimization pass
(``paddle_tpu_torch.memory_optimization_transpiler``): the 5 cases of
``tests/test_memory_optimize.py`` (liveness, reuse planning on a real
Transformer program, measured early release through a host op), the
``MemoryPlan`` against the JAX package's on the same
``Program.to_dict()`` (peaks, reuse pairs, ``last_use``, donatable
feeds: equal, they are integer facts), and early release on the port's
other walks: a released eager run gives the same fetches bit for bit
under a distinct signature, and ``PADDLE_TPU_OPT`` rebuilds the plan for
the optimized op list."""

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.memory_optimization_transpiler import \
    memory_optimize as ref_memory_optimize
from paddle_tpu.models import transformer as JT
from paddle_tpu_torch.memory_optimization_transpiler import (
    ControlFlowGraph, MemoryPlan, memory_optimize, release_memory)
from paddle_tpu_torch.models import transformer as TT


def _fresh():
    main, startup = pt.Program(), pt.Program()
    return main, startup


class TestLiveness:
    def _chain_program(self):
        # x -> a = relu(x) -> b = relu(a) -> c = relu(b); a dies after b
        main, startup = _fresh()
        with pt.program_guard(main, startup):
            x = pt.layers.data(name="x", shape=[4, 8],
                               append_batch_size=False)
            a = pt.layers.relu(x)
            b = pt.layers.relu(a)
            c = pt.layers.relu(b)
        return main, a, b, c

    def test_last_use(self):
        prog, a, b, c = self._chain_program()
        cfg = ControlFlowGraph(prog.global_block())
        last = cfg.last_use_index()
        # a is consumed by the op producing b; it must die before c's op
        assert last[a.name] < last[c.name]
        assert last["x"] <= last[a.name]

    def test_live_sets(self):
        prog, a, b, c = self._chain_program()
        blk = prog.global_block()
        cfg = ControlFlowGraph(blk)
        i_c = max(i for i, op in enumerate(blk.ops)
                  if c.name in op.output_arg_names)
        # at the final op, only its inputs/outputs are live
        assert a.name not in cfg.live_in[i_c]

    def test_reuse_pairs_same_shape(self):
        prog, a, b, c = self._chain_program()
        cfg = ControlFlowGraph(prog.global_block())
        pairs = cfg.reuse_pairs()
        # c can reuse a's buffer (same [4,8] float32, a dead by then)
        assert any(new == c.name and old == a.name for new, old in pairs), \
            pairs


def _hp(mod, dropout=0.0):
    hp = mod.ModelHyperParams()
    hp.d_model, hp.d_inner_hid, hp.n_layer = 64, 128, 2
    hp.n_head, hp.d_key, hp.d_value = 4, 16, 16
    hp.src_vocab_size = hp.trg_vocab_size = 500
    hp.dropout = dropout
    return hp


def _transformer(pkg, mod, names, train=True, dropout=0.0):
    main, startup = pkg.Program(), pkg.Program()
    with names("mo_"), pkg.program_guard(main, startup):
        avg_cost, _ = mod.transformer(4, 16, 16, _hp(mod, dropout))
        if train:
            pkg.optimizer.Adam(learning_rate=1e-3).minimize(avg_cost)
    return main, startup, avg_cost


class TestMemoryOptimizeTransformer:
    def test_plan_on_transformer(self):
        """The reference's case plans the JAX package's train program at
        dropout 0.1, whose backward stops at every ``dropout_grad``
        (ROADMAP queue 3): its forward values die early and 129 reuse
        pairs remain.  With the whole backward (the port's program, or
        the JAX package's at dropout 0) every forward value lives into
        the backward and the shapeless grads claim no buffer: no pair,
        in both packages alike.  The forward program has them."""
        names = pt.framework.unique_name_scope
        fwd, _, _ = _transformer(pt, TT, names, train=False)
        plan = memory_optimize(fwd)
        assert isinstance(plan, MemoryPlan) and fwd._memory_plan is plan
        assert len(plan.reuse_pairs) > 10
        assert plan.peak_bytes_with_reuse <= plan.peak_bytes
        report = plan.report()
        assert "reuse pairs" in report and "savings" in report
        train, _, _ = _transformer(pt, TT, names)
        jm, _, _ = _transformer(fluid, JT,
                                fluid.framework.unique_name_scope)
        assert memory_optimize(train).reuse_pairs == \
            ref_memory_optimize(jm).reuse_pairs == []


def _plan_facts(plan):
    return (plan.peak_bytes, plan.peak_bytes_with_reuse,
            list(plan.reuse_pairs), plan.last_use,
            sorted(plan.donatable_feeds))


@pytest.mark.parametrize("model", ["transformer", "forward", "host_op"])
def test_memory_plan_equals_reference(model):
    """The same program (the JAX package's, carried over by
    ``to_dict()``): every fact of the plan equal.  ``transformer`` is the
    reference case's own program (dropout 0.1, see above)."""
    names = fluid.framework.unique_name_scope
    if model == "host_op":
        jm, js = fluid.Program(), fluid.Program()
        with fluid.program_guard(jm, js):
            _host_op_program(fluid)
    else:
        jm, _, _ = _transformer(fluid, JT, names, train=model != "forward",
                                dropout=0.1)
    tm = pt.Program.from_dict(jm.to_dict())
    want = ref_memory_optimize(jm)
    got = memory_optimize(tm)
    assert _plan_facts(got) == _plan_facts(want)
    assert got.report() == want.report()
    assert got.savings_bytes() == want.savings_bytes()
    assert got.reuse_pairs and got.last_use[0]
    if model == "transformer":
        assert len(got.reuse_pairs) > 10 and got.savings_bytes() > 0


def _host_op_program(pkg):
    # edit_distance is a host op (the block stays eager); the fc chain
    # gives the pass dead intermediates to drop
    layers = pkg.layers
    x = layers.data(name="x", shape=[8, 64], append_batch_size=False)
    h1 = layers.fc(input=x, size=64, act="relu")
    h2 = layers.fc(input=h1, size=64, act="relu")
    h3 = layers.fc(input=h2, size=64, act="relu")
    out = layers.reduce_mean(h3)
    hyp = layers.data(name="hyp", shape=[8, 1], append_batch_size=False,
                      dtype="int64", lod_level=1)
    ref = layers.data(name="ref", shape=[8, 1], append_batch_size=False,
                      dtype="int64", lod_level=1)
    helper = pkg.layer_helper.LayerHelper("edit_distance")
    dist = helper.create_tmp_variable("float32")
    seq_num = helper.create_tmp_variable("int32")
    helper.append_op(type="edit_distance",
                     inputs={"Hyps": [hyp], "Refs": [ref]},
                     outputs={"Out": [dist], "SequenceNum": [seq_num]})
    return out, dist


def _host_feed():
    rng = np.random.RandomState(0)
    lod = [[0, 4, 8]]
    return {
        "x": rng.rand(8, 64).astype("float32"),
        "hyp": (rng.randint(0, 5, (8, 1)).astype("int64"), lod),
        "ref": (rng.randint(0, 5, (8, 1)).astype("int64"), lod),
    }


class TestReleaseMemory:
    def test_release_drops_dead_vars_same_results(self):
        main, startup = _fresh()
        with pt.program_guard(main, startup):
            out, _ = _host_op_program(pt)
        exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
        exe.run(startup, scope=scope)
        base = exe.run(main, feed=_host_feed(), fetch_list=[out],
                       scope=scope)

        release_memory(main)
        # same executor: the cache key includes the release flag
        got = exe.run(main, feed=_host_feed(), fetch_list=[out],
                      scope=scope)
        np.testing.assert_allclose(np.asarray(got[0]), np.asarray(base[0]),
                                   rtol=1e-6)
        stats = main._release_stats
        assert stats["vars"] > 0 and stats["bytes"] > 0, stats


def test_released_eager_step_same_fetches_distinct_signature():
    """A training step (forward, backward, Adam) released and not, from
    one state on fresh executors: the same loss and state bit for bit;
    the released key is its own cache entry; the walk drops the dead
    intermediates but no persistable and no fetch."""
    main, startup, cost = _transformer(pt, TT,
                                       pt.framework.unique_name_scope)
    exe0, scope0 = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe0.run(startup, scope=scope0)
    state = {n: v.clone() for n, v in scope0.items()}
    feed = TT.fake_batch(4, 16, 16, _hp(TT), seed=1)

    def steps(released):
        exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
        for n, v in state.items():
            scope.set_var(n, v.clone())
        if released:
            release_memory(main)
        else:
            main._release_memory = False
        losses = [exe.run(main, feed=feed, fetch_list=[cost],
                          scope=scope)[0] for _ in range(2)]
        block = main.global_block()
        feeds = {n: pt.convert.to_tensor(v, exe.device)
                 for n, v in feed.items()}
        sig = exe._signature(main, block, feeds, (cost.name,), scope)
        assert list(exe._cache) == [sig]
        return losses, {n: v.clone() for n, v in scope.items()}, sig

    base, base_state, base_sig = steps(False)
    got, got_state, got_sig = steps(True)
    assert got_sig != base_sig
    for a, b in zip(got, base):
        np.testing.assert_array_equal(a, b)
    for n, v in base_state.items():
        assert got_state[n].equal(v), n
    stats = main._release_stats
    assert stats["vars"] > 50 and stats["bytes"] > 0
    # the plan gives persistables a last use too; the walk keeps them
    # (the state above is bit-equal and complete)
    persist = {v.name for v in main.list_vars() if v.persistable}
    assert persist & set(main._memory_plan.last_use[0])
    assert sorted(got_state) == sorted(base_state)
    main._release_memory = False


def test_optimized_program_rebuilds_the_plan(monkeypatch):
    """Under ``PADDLE_TPU_OPT`` the released program's clone is
    optimized, and its plan keys the optimized op list."""
    main, startup = _fresh()
    with pt.program_guard(main, startup):
        out, _ = _host_op_program(pt)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    base = exe.run(main, feed=_host_feed(), fetch_list=[out], scope=scope)
    release_memory(main)
    monkeypatch.setenv("PADDLE_TPU_OPT", "1")
    got = exe.run(main, feed=_host_feed(), fetch_list=[out], scope=scope)
    (optimized,) = exe._opt_cache.values()
    assert optimized is not main and optimized._release_memory
    assert len(optimized._memory_plan.last_use[0]) > 0
    np.testing.assert_allclose(got[0], base[0], rtol=1e-6)
    assert optimized._release_stats["vars"] > 0
