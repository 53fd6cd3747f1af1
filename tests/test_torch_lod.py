"""LoD in the port's scope and executor against the JAX package's, on the
CPU: ``Scope.set_lod`` / ``find_lod``, ``(value, lod)`` feeds (checked
against the value's rows), a dense feed clearing a stale LoD, the
executor's row-count rule that passes an input's LoD to an output with
as many rows (``_share_lod``, B == N included), ``reshape`` keeping the
LoD when rows are kept, ``select_bucket_edges``, and the bucketed mode,
which the port does not run and refuses.

Tolerance: float32 ``atol = rtol = 1e-5``."""

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import lod as jax_lod
from paddle_tpu_torch import lod as torch_lod

TOL = 1e-5
LOD = [[0, 3, 5, 9]]


@pytest.fixture(autouse=True)
def _plain_reference(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_OPT", raising=False)
    monkeypatch.delenv("PADDLE_TPU_LOD_BUCKETS", raising=False)


def _f(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("pkg", [fluid, pt], ids=["jax", "torch"])
def test_scope_lod_walks_parents_and_clears(pkg):
    root = pkg.Scope()
    kid = root.new_scope()
    root.set_var("x", np.zeros(3, np.float32))
    root.set_lod("x", [[0, 1, 3]])
    assert kid.find_lod("x") == [[0, 1, 3]]
    kid.set_lod("x", [[0, 3]])
    assert kid.find_lod("x") == [[0, 3]] and root.find_lod("x") == \
        [[0, 1, 3]]
    kid.set_lod("x", None)               # clears here and in the parents
    assert kid.find_lod("x") is None and root.find_lod("x") is None
    root.set_lod("x", [[0, 3]])
    root.erase(["x"])
    assert root.find_lod("x") is None and not root.has_var("x")


def _pool_program(pkg, pool="sum", rows=-1):
    main = pkg.Program()
    with pkg.program_guard(main, pkg.Program()):
        x = pkg.layers.data("x", shape=[rows, 2], append_batch_size=False,
                            lod_level=1)
        out = pkg.layers.sequence_pool(x, pool)
    return main, out


def _run(pkg, main, feed, fetch, scope=None):
    return [np.asarray(v) for v in pkg.Executor(pkg.CPUPlace()).run(
        main, feed=feed, fetch_list=fetch, scope=scope or pkg.Scope())]


def test_ragged_feed_runs_as_the_reference_and_lands_in_the_scope():
    x = _f(0, 9, 2)
    got = []
    for pkg in (fluid, pt):
        main, out = _pool_program(pkg)
        scope = pkg.Scope()
        got.append(_run(pkg, main, {"x": (x, LOD)}, [out], scope)[0])
        assert scope.find_lod("x") == LOD
    np.testing.assert_allclose(got[1], got[0], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got[1], [x[:3].sum(0), x[3:5].sum(0),
                                        x[5:].sum(0)], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("lod,why", [
    ([[0, 3, 5, 8]], "ends at 8"),
    ([[1, 3, 5, 9]], "must start at 0"),
    ([[0, 5, 3, 9]], "never decrease"),
    ([[0, 1, 2], [0, 3, 5, 9]], "next level holds 3"),
    ([], "empty LoD"),
], ids=["rows", "start", "decreasing", "levels", "empty"])
def test_ragged_feed_is_checked(lod, why):
    main, out = _pool_program(pt)
    with pytest.raises(ValueError, match=why):
        _run(pt, main, {"x": (_f(0, 9, 2), lod)}, [out])


def test_dense_feed_clears_a_stale_lod():
    """A dense feed after a ragged one drops the scope's LoD: the pool
    then reads one row per sequence, as the reference does."""
    x = _f(1, 9, 2)
    got = []
    for pkg in (fluid, pt):
        main, out = _pool_program(pkg)
        scope = pkg.Scope()
        _run(pkg, main, {"x": (x, LOD)}, [out], scope)
        got.append(_run(pkg, main, {"x": x}, [out], scope)[0])
        assert scope.find_lod("x") is None
    np.testing.assert_allclose(got[1], got[0], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got[1], x, atol=TOL, rtol=TOL)


def _last_step_lstm(pkg, lod):
    """``sequence_last_step`` of a ragged x, then an fc and an LSTM over
    its B rows: the LSTM runs only if the last steps carry a LoD, which
    the row-count rule gives them when B == N."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.framework.unique_name_scope("sl_") if pkg is fluid else \
            pt.framework.unique_name_scope("sl_"), \
            pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[-1, 3], append_batch_size=False,
                            lod_level=1)
        last = pkg.layers.sequence_last_step(x)
        proj = pkg.layers.fc(last, size=8)
        h, _ = pkg.layers.dynamic_lstm(proj, size=8, use_peepholes=False)
    exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
    exe.run(startup, scope=scope)
    return exe, scope, main, h


def test_row_count_rule_labels_b_equal_n_as_the_reference():
    """All lengths 1 (B == N): the last steps inherit x's LoD by row count
    in both packages and the LSTM over them runs, to the same values;
    with B != N neither package labels them and both LSTMs refuse."""
    from paddle_tpu_torch.convert import persistable_names, scope_from_numpy
    x = _f(2, 4, 3)
    jexe, jscope, jmain, jh = _last_step_lstm(fluid, [[0, 1, 2, 3, 4]])
    texe, _, tmain, th = _last_step_lstm(pt, [[0, 1, 2, 3, 4]])
    tscope = scope_from_numpy(
        {n: np.asarray(jscope.find_var(n))
         for n in persistable_names(tmain)}, pt.CPUPlace(), tmain)
    feed = {"x": (x, [[0, 1, 2, 3, 4]])}
    (want,) = jexe.run(jmain, feed=feed, fetch_list=[jh], scope=jscope)
    (got,) = texe.run(tmain, feed=feed, fetch_list=[th], scope=tscope)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)
    for exe, main, h, scope in ((jexe, jmain, jh, jscope),
                                (texe, tmain, th, tscope)):
        with pytest.raises(ValueError, match="requires LoD"):
            exe.run(main, feed={"x": (x, [[0, 1, 4]])}, fetch_list=[h],
                    scope=scope)


def test_share_lod_follows_the_first_lod_input():
    """The port's rule read directly: an output with the first LoD
    input's row count inherits its LoD; other outputs and an output the
    op labelled itself keep theirs."""
    import torch
    from paddle_tpu_torch.executor import lower_block
    main = pt.Program()
    with pt.program_guard(main, pt.Program()):
        x = pt.layers.data("x", shape=[-1, 2], append_batch_size=False,
                           lod_level=1)
        y = pt.layers.data("y", shape=[3, 2], append_batch_size=False)
        a = pt.layers.scale(x, 2.0)              # 9 rows: inherits
        b = pt.layers.reduce_sum(x, dim=[1])     # 9 rows: inherits
        c = pt.layers.scale(y, 2.0)              # no LoD input
        d = pt.layers.sequence_pool(x, "sum")    # 3 rows: none
    env = {"x": torch.from_numpy(_f(3, 9, 2)),
           "y": torch.from_numpy(_f(4, 3, 2))}
    aux = {"device": torch.device("cpu"), "lod": {"x": LOD}}
    lower_block(main.global_block(), env, aux)
    assert aux["lod"][a.name] == LOD and aux["lod"][b.name] == LOD
    assert c.name not in aux["lod"] and d.name not in aux["lod"]


def test_reshape_keeps_the_lod_when_rows_are_kept():
    x = _f(5, 6, 4)
    lod = [[0, 2, 6]]
    got = []
    for pkg in (fluid, pt):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            xv = pkg.layers.data("x", shape=[-1, 4], append_batch_size=False,
                                 lod_level=1)
            r = pkg.layers.reshape(xv, shape=[0, 2, 2])
            flat = pkg.layers.reshape(r, shape=[0, 4])
            out = pkg.layers.sequence_pool(flat, "average")
        got.append(_run(pkg, main, {"x": (x, lod)}, [out])[0])
    np.testing.assert_allclose(got[1], got[0], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got[1], [x[:2].mean(0), x[2:].mean(0)],
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("counts,max_edges", [
    ([3, 5, 5, 9, 17, 17, 17, 40, 100], 3),
    ([1, 1, 2, 64], 2),
    (list(range(1, 50)), 4),
    ([7], 4),
    ([], 2),
])
def test_select_bucket_edges_matches_the_reference(counts, max_edges):
    assert torch_lod.select_bucket_edges(counts, max_edges) == \
        jax_lod.select_bucket_edges(counts, max_edges)
    cost = lambda e: e * e + 3.0  # noqa: E731
    assert torch_lod.select_bucket_edges(counts, max_edges, cost) == \
        jax_lod.select_bucket_edges(counts, max_edges, cost)


def test_bucketed_mode_raises(monkeypatch):
    """The JAX package's bucketed LoD mode is not ported: a ragged feed to
    a program that asks for it, and per-step LoD windows in
    ``run_steps``, raise instead of quietly running the exact LoD."""
    main, out = _pool_program(pt)
    feed = {"x": (_f(6, 9, 2), LOD)}
    main.lod_buckets = True
    with pytest.raises(NotImplementedError, match="Bucketed LoD"):
        _run(pt, main, feed, [out])
    main.lod_buckets = None
    monkeypatch.setenv("PADDLE_TPU_LOD_BUCKETS", "1")
    with pytest.raises(NotImplementedError, match="Bucketed LoD"):
        _run(pt, main, feed, [out])
    monkeypatch.delenv("PADDLE_TPU_LOD_BUCKETS")
    exe = pt.Executor(pt.CPUPlace())
    for value in (feed["x"], [feed["x"], feed["x"]]):
        with pytest.raises(NotImplementedError, match="Bucketed LoD"):
            exe.run_steps(main, feed={"x": value}, fetch_list=[out],
                          steps=2, scope=pt.Scope())
