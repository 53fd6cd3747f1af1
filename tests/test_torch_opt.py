"""The port's optimization pipeline: on every zoo program it yields the
same optimized program, ``__rng_slots__`` and report as the JAX
package's; the optimized run of the port gives the same fetches as its
own unoptimized run on the CPU, dropout live; the verify-sandwich
reverts a broken pass; and ``PADDLE_TPU_OPT`` is memoized per program
version."""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu.analysis.opt import optimize_program as jax_optimize
from paddle_tpu.models import ZOO_MODELS, build_train_program
from paddle_tpu_torch.analysis.opt import (PassPipeline, clone_program,
                                           optimize_program)
from paddle_tpu_torch.analysis.opt.passes import RNG_SLOTS_ATTR
from paddle_tpu_torch.models import build_train_program as port_build

ZOO_CASES = [(m, bw) for m in ZOO_MODELS for bw in (True, False)]

#: fetch tolerance where a float constant was folded on the host
FETCH_TOL = 1e-6


def _zoo_id(case):
    return f"{case[0]}-{'train' if case[1] else 'forward'}"


def _strip(d):
    if isinstance(d, dict):
        return {k: _strip(v) for k, v in d.items() if k != "creation_site"}
    if isinstance(d, list):
        return [_strip(v) for v in d]
    return d


def _slots(program):
    return [op.attrs.get(RNG_SLOTS_ATTR, 1)
            for b in program.blocks for op in b.ops]


def _same_result(jprog, tprog, feeds, fetches):
    jopt, jrep = jax_optimize(jprog, feed_names=feeds, fetch_names=fetches)
    topt, trep = optimize_program(tprog, feed_names=feeds,
                                  fetch_names=fetches)
    assert _strip(topt.to_dict()) == _strip(jopt.to_dict())
    assert _slots(topt) == _slots(jopt)
    assert trep.to_dict() == jrep.to_dict()
    assert trep.format() == jrep.format()
    assert topt._donation_plan.to_dict() == jopt._donation_plan.to_dict()
    assert getattr(topt, "_opt_interpret", False) == \
        getattr(jopt, "_opt_interpret", False)
    assert not trep.aborted_passes
    return topt, trep


@pytest.mark.parametrize("case", ZOO_CASES, ids=_zoo_id)
def test_zoo_optimizes_like_the_reference(case):
    jmain, jstartup, feeds, fetches = build_train_program(*case)
    tmain = pt.Program.from_dict(jmain.to_dict())
    before = tmain.to_dict()
    _same_result(jmain, tmain, feeds, fetches)
    assert tmain.to_dict() == before  # the input is never mutated
    if case[1]:
        tstartup = pt.Program.from_dict(jstartup.to_dict())
        _same_result(jstartup, tstartup, None, None)


# ---------------------------------------------------------------------------
# optimized vs unoptimized runs of the port
# ---------------------------------------------------------------------------

#: one LoD for every ragged feed: two sequences of 3 and 2 rows
LOD = [[0, 3, 5]]


def _feed(main, feeds, seed, batch=2):
    """Random feeds in range: every integer (ids, labels) is 0 or 1,
    which is a valid class and token of every zoo model (W&D's labels
    are two-class)."""
    rng = np.random.RandomState(seed)
    block = main.global_block()
    names = feeds if feeds is not None else [
        v.name for v in block.vars.values() if getattr(v, "is_data", False)]
    out = {}
    for n in names:
        v = block.var(n)
        ragged = getattr(v, "lod_level", 0) or 0
        shape = [batch if d is None or d < 0 else d
                 for d in (v.shape or (batch,))]
        if ragged:
            shape[0] = LOD[0][-1]
        if str(v.dtype).startswith("int"):
            a = rng.randint(0, 2, size=shape).astype(str(v.dtype))
        else:
            a = rng.standard_normal(shape).astype(np.float32)
        out[n] = (a, LOD) if ragged else a
    return out


def _steps(name, backward, opt, monkeypatch, steps=2):
    monkeypatch.setenv("PADDLE_TPU_OPT", "1" if opt else "0")
    main, startup, feeds, fetches = port_build(name, backward=backward)
    main.random_seed = startup.random_seed = 7
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    outs = [exe.run(main, feed=_feed(main, feeds, seed=s),
                    fetch_list=fetches, scope=scope) for s in range(steps)]
    if not opt:
        return outs, None
    assert len(exe._opt_cache) == 2  # the startup and the main program
    (program,) = [p for k, p in exe._opt_cache.items() if k[0] == id(main)]
    return outs, program


@pytest.mark.parametrize("case", ZOO_CASES, ids=_zoo_id)
def test_optimized_run_matches_unoptimized(case, monkeypatch):
    """Two steps from the same startup state, Transformer dropout at
    0.1: the same fetches, bit for bit where no float constant was
    folded."""
    want, _ = _steps(*case, opt=False, monkeypatch=monkeypatch)
    got, optimized = _steps(*case, opt=True, monkeypatch=monkeypatch)
    report = optimized._opt_report
    folded = sum(p["stats"].get("folded", 0) for p in report.passes)
    for ws, gs in zip(want, got):
        for w, g in zip(ws, gs):
            assert np.all(np.isfinite(w))
            if folded:
                np.testing.assert_allclose(g, w, rtol=FETCH_TOL,
                                           atol=FETCH_TOL)
            else:
                np.testing.assert_array_equal(g, w)


def _dropout_program():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=[16], dtype="float32")
        # a dead op BEFORE the dropout: removing it shifts the op
        # positions, and without slot bookkeeping the mask would move
        pt.layers.fc(x, 4)
        h = pt.layers.fc(x, 16)
        d = pt.layers.dropout(h, dropout_prob=0.5)
        out = pt.layers.mean(d)
    main.random_seed = startup.random_seed = 9
    return main, startup, out


def _run_dropout(main, startup, out):
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    feed = {"x": np.random.RandomState(0).randn(4, 16).astype("float32")}
    return exe.run(main, feed=feed, fetch_list=[out.name], scope=scope)[0]


def test_removed_ops_charge_their_rng_slots():
    main, startup, out = _dropout_program()
    ref = _run_dropout(main, startup, out)
    optimized, report = optimize_program(main, feed_names=("x",),
                                         fetch_names=(out.name,))
    assert report.ops_removed() > 0
    assert sum(_slots(optimized)) == len(main.global_block().ops)
    np.testing.assert_array_equal(_run_dropout(optimized, startup, out),
                                  ref)
    # the control: without the charged slots the mask moves
    uncharged = clone_program(optimized)
    for op in uncharged.global_block().ops:
        op.attrs.pop(RNG_SLOTS_ATTR, None)
    assert not np.array_equal(_run_dropout(uncharged, startup, out), ref)


def test_fused_chain_under_amp_matches_unfused():
    """``fused_elementwise`` replays each member's lowering with its own
    AMP casts: the fused run of a bf16 program is the unfused run."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=[8], dtype="float32")
        h = pt.layers.fc(x, 8)
        y = pt.layers.scale(pt.layers.relu(pt.layers.tanh(h)), scale=3.0)
        out = pt.layers.elementwise_add(y, h)
    main.amp = True
    main.random_seed = startup.random_seed = 3
    optimized, report = optimize_program(main, feed_names=("x",),
                                         fetch_names=(out.name,))
    assert "fused_elementwise" in [op.type for op in
                                   optimized.global_block().ops]
    assert optimized.amp is True
    feed = {"x": np.random.RandomState(1).randn(4, 8).astype("float32")}
    outs = []
    for prog in (main, optimized):
        scope = pt.Scope()
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=scope)
        outs.append(exe.run(prog, feed=feed, fetch_list=[out.name],
                            scope=scope)[0])
    np.testing.assert_array_equal(outs[1], outs[0])


# ---------------------------------------------------------------------------
# the verify-sandwich
# ---------------------------------------------------------------------------

def _small():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=[4], dtype="float32")
        h = pt.layers.fc(x, 8, act="relu")
        cost = pt.layers.mean(h)
    return main, startup, ("x",), (cost.name,)


def test_pass_deleting_a_needed_op_is_reverted():
    main, startup, feeds, fetches = _small()

    def evil_delete(program, ctx):
        program.global_block().ops.pop()
        return {"mangled": 1}

    optimized, report = PassPipeline([evil_delete]).run(
        main, feed_names=feeds, fetch_names=fetches)
    assert report.passes[0]["status"] == "aborted"
    assert report.passes[0]["new_diagnostics"]
    assert report.aborted_passes == ["evil_delete"]
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    (out,) = exe.run(optimized, feed={"x": np.ones((1, 4), "float32")},
                     fetch_list=list(fetches), scope=scope)
    assert np.isfinite(out).all()


def test_pass_rewiring_to_undefined_name_is_reverted():
    main, _, feeds, fetches = _small()

    def evil_rewire(program, ctx):
        op = program.global_block().ops[-1]
        op.inputs = {k: ["__no_such_var__"] for k in op.inputs}
        return {"mangled": 1}

    optimized, report = PassPipeline([evil_rewire]).run(
        main, feed_names=feeds, fetch_names=fetches)
    assert report.passes[0]["status"] == "aborted"
    assert "PTA001" in {d["code"] for d in
                        report.passes[0]["new_diagnostics"]}
    assert optimized.to_dict() == clone_program(main).to_dict()


def test_raising_pass_is_aborted_and_unknown_pass_rejected():
    main, _, feeds, fetches = _small()

    def evil_raise(program, ctx):
        raise RuntimeError("boom")

    _, report = PassPipeline([evil_raise]).run(
        main, feed_names=feeds, fetch_names=fetches)
    assert report.passes[0]["status"] == "aborted"
    assert report.passes[0]["stats"] == {"raised": 1}
    with pytest.raises(ValueError, match="unknown optimization"):
        PassPipeline(["not_a_pass"])


# ---------------------------------------------------------------------------
# PADDLE_TPU_OPT in the executor
# ---------------------------------------------------------------------------

def _train():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=[8], dtype="float32")
        y = pt.layers.data("y", shape=[1], dtype="float32")
        h = pt.layers.fc(x, 8, act="relu")
        pred = pt.layers.fc(h, 1)
        cost = pt.layers.mean(pt.layers.square(pred - y))
        pt.optimizer.SGD(learning_rate=0.01).minimize(cost)
    main.random_seed = startup.random_seed = 4
    return main, startup, cost


def test_opt_env_is_memoized_and_reoptimizes_after_bump(monkeypatch):
    main, startup, cost = _train()
    rng = np.random.RandomState(1)
    feed = {"x": rng.randn(4, 8).astype("float32"),
            "y": rng.randn(4, 1).astype("float32")}
    monkeypatch.delenv("PADDLE_TPU_OPT", raising=False)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    (ref,) = exe.run(main, feed=feed, fetch_list=[cost.name], scope=scope)
    assert exe._opt_cache == {}

    monkeypatch.setenv("PADDLE_TPU_OPT", "1")
    scope2 = pt.Scope()
    exe2 = pt.Executor(pt.CPUPlace())
    exe2.run(startup, scope=scope2)
    before = main.to_dict()
    (opt1,) = exe2.run(main, feed=feed, fetch_list=[cost.name],
                       scope=scope2)
    assert main.to_dict() == before
    memo = dict(exe2._opt_cache)
    assert len(memo) == 2
    exe2.run(main, feed=feed, fetch_list=[cost.name], scope=scope2)
    assert all(exe2._opt_cache[k] is v for k, v in memo.items())
    np.testing.assert_array_equal(opt1, ref)
    main.bump_version()
    exe2.run(main, feed=feed, fetch_list=[cost.name], scope=scope2)
    assert len(exe2._opt_cache) == 3
    # an optimized clone passed back in is run as it is
    optimized = next(iter(exe2._opt_cache.values()))
    assert exe2._maybe_optimize(optimized, {}, []) is optimized
    exe2.close()
    assert exe2._opt_cache == {}


def test_opt_env_applies_to_run_steps(monkeypatch):
    main, startup, cost = _train()
    feed = {"x": np.ones((4, 8), "float32"), "y": np.ones((4, 1),
                                                          "float32")}
    results = []
    for flag in ("0", "1"):
        monkeypatch.setenv("PADDLE_TPU_OPT", flag)
        scope = pt.Scope()
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=scope)
        (losses,) = exe.run_steps(main, feed=feed, fetch_list=[cost.name],
                                  steps=3, scope=scope)
        results.append(losses)
        assert bool(exe._opt_cache) == (flag == "1")
    np.testing.assert_array_equal(results[1], results[0])
    assert torch.is_tensor(torch.as_tensor(results[0]))
