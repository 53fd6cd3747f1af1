"""The port's static analysis against the JAX package's: the typecheck
pass infers the same shape and dtype for every variable, the lints give
the same findings, every negative case raises its code, the
``PADDLE_TPU_VERIFY`` hook fails before any op runs, and the DOT and
pseudo-code renderings are the same text.  Programs are built by the JAX
package and carried over with ``Program.to_dict()`` / ``from_dict()``."""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import analysis as jax_analysis
from paddle_tpu.analysis import typecheck as jax_typecheck
from paddle_tpu.analysis import visualize as jax_visualize
from paddle_tpu.memory_optimization_transpiler import \
    plan_donation as jax_plan_donation
from paddle_tpu.models import ZOO_MODELS, build_train_program
from paddle_tpu_torch import analysis
from paddle_tpu_torch.analysis import typecheck, visualize
from paddle_tpu_torch.memory_optimization_transpiler import plan_donation
from test_analysis import NEGATIVE_CASES

ZOO_CASES = [(m, bw) for m in ZOO_MODELS for bw in (True, False)]


def _zoo_id(case):
    return f"{case[0]}-{'train' if case[1] else 'forward'}"


def _carried(name, backward):
    main, startup, feeds, fetches = build_train_program(name, backward)
    return (main, pt.Program.from_dict(main.to_dict()), feeds, fetches)


def _inferred(mod, program):
    """name -> (shape, dtype) the typecheck pass proved, every block."""
    out = {}

    def walk(block, parent):
        tc = mod._check_block(block, [], set(), parent_env=parent)
        out.update({n: (i.shape, i.dtype) for n, i in tc._env.items()})

    walk(program.global_block(), None)
    return out


def _keys(result):
    return sorted((d.code, d.severity, d.var, d.op_type)
                  for d in result.diagnostics)


@pytest.mark.parametrize("case", ZOO_CASES, ids=_zoo_id)
def test_zoo_types_and_lints_match(case):
    jmain, tmain, feeds, fetches = _carried(*case)
    want = _inferred(jax_typecheck, jmain)
    got = _inferred(typecheck, tmain)
    assert want and got == want
    jr = jax_analysis.lint_program(jmain, feed_names=feeds,
                                   fetch_names=fetches)
    tr = analysis.lint_program(tmain, feed_names=feeds, fetch_names=fetches)
    assert _keys(tr) == _keys(jr)
    assert tr.uncovered_op_types == jr.uncovered_op_types
    assert [d.to_dict() for d in tr.diagnostics] == \
        [d.to_dict() for d in jr.diagnostics]


def test_diagnostic_codes_are_the_references():
    assert analysis.DIAGNOSTIC_CODES == jax_analysis.DIAGNOSTIC_CODES
    assert len(analysis.DIAGNOSTIC_CODES) == 19
    assert typecheck.covered_op_types() == jax_typecheck.covered_op_types()


@pytest.mark.parametrize("code", sorted(NEGATIVE_CASES))
def test_negative_case_triggers_code_in_the_port(code):
    program, feeds, fetches = NEGATIVE_CASES[code]()
    tprog = pt.Program.from_dict(program.to_dict())
    want = jax_analysis.lint_program(program, feed_names=feeds,
                                     fetch_names=fetches)
    got = analysis.lint_program(tprog, feed_names=feeds,
                                fetch_names=fetches)
    assert code in got.codes(), got.format()
    assert _keys(got) == _keys(want)
    hit = next(d for d in got.diagnostics if d.code == code)
    assert hit.var or hit.op_type, hit.format()
    assert analysis.format_diagnostics(got.diagnostics) == \
        jax_analysis.format_diagnostics(want.diagnostics)


class _Counting:
    """Wraps the port registry's lowering lookup to count op runs."""

    def __init__(self, monkeypatch):
        from paddle_tpu_torch.ops import registry
        self.runs = 0
        real = registry.resolve_lowering

        def counted(op_type):
            self.runs += 1
            return real(op_type)

        monkeypatch.setattr(registry, "resolve_lowering", counted)


def test_verify_hook_fails_before_the_first_op(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_VERIFY", "1")
    program, _, _ = NEGATIVE_CASES["PTA002"]()
    tprog = pt.Program.from_dict(program.to_dict())
    counting = _Counting(monkeypatch)
    exe = pt.Executor(pt.CPUPlace())
    with pytest.raises(analysis.ProgramVerificationError) as ei:
        exe.run(tprog, feed={"x": np.zeros((2, 2), np.float32)},
                fetch_list=["y"], scope=pt.Scope())
    assert "PTA002" in str(ei.value)
    assert ei.value.where == "executor.run"
    assert counting.runs == 0


def test_verify_hook_memoizes_and_reverifies_after_bump(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_VERIFY", "1")
    p = pt.Program()
    b = p.global_block()
    b.create_var(name="x", shape=(2, 2), dtype="float32", is_data=True)
    b.append_op(type="relu", inputs={"X": ["x"]}, outputs={"Out": ["y"]})
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    feed = {"x": np.zeros((2, 2), np.float32)}
    exe.run(p, feed=feed, fetch_list=["y"], scope=scope)
    keys = set(exe._verified)
    assert (id(p), p._version) in keys
    exe.run(p, feed=feed, fetch_list=["y"], scope=scope)
    assert set(exe._verified) == keys
    # break the program: append_op bumps the version, which re-verifies
    b.append_op(type="relu", inputs={"X": ["late"]}, outputs={"Out": ["z"]})
    b.append_op(type="tanh", inputs={"X": ["y"]}, outputs={"Out": ["late"]})
    with pytest.raises(analysis.ProgramVerificationError):
        exe.run(p, feed=feed, fetch_list=["z"], scope=scope)
    exe.close()
    assert not exe._verified


def test_verify_off_runs_without_checking(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_VERIFY", raising=False)
    p = pt.Program()
    b = p.global_block()
    b.create_var(name="x", shape=(2,), dtype="float32", is_data=True)
    b.append_op(type="relu", inputs={"X": ["x"]}, outputs={"Out": ["y"]})
    exe = pt.Executor(pt.CPUPlace())
    (y,) = exe.run(p, feed={"x": np.array([-1.0, 2.0], np.float32)},
                   fetch_list=["y"], scope=pt.Scope())
    np.testing.assert_array_equal(y, [0.0, 2.0])
    assert not exe._verified


def test_fetch_missing_check_names_the_target():
    env = {"a": torch.zeros(1)}
    assert pt.Executor.fetch_missing_check(["a"], env) == ["a"]
    with pytest.raises(KeyError, match="'b' was not produced"):
        pt.Executor.fetch_missing_check(["a", "b"], env)
    # a run checks its fetches so: one the block writes or the scope holds
    # comes back, any other raises naming it
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[2], append_batch_size=False)
        y = pt.layers.scale(x, scale=2.0)
    scope = pt.Scope()
    scope.set_var("held", np.ones(1, np.float32))
    exe = pt.Executor(pt.CPUPlace())
    feed = {"x": np.array([1.0, 2.0], np.float32)}
    got = exe.run(main, feed=feed, fetch_list=[y, "held"], scope=scope)
    np.testing.assert_array_equal(got[0], [2.0, 4.0])
    np.testing.assert_array_equal(got[1], [1.0])
    with pytest.raises(KeyError, match="'nope' was not produced"):
        exe.run(main, feed=feed, fetch_list=[y, "nope"], scope=scope)


@pytest.mark.parametrize("name", ["mnist", "transformer", "seq2seq",
                                  "wide_and_deep"])
def test_dot_and_pprint_text_match(name):
    jmain, tmain, feeds, fetches = _carried(name, True)
    assert visualize.program_dot(tmain) == jax_visualize.program_dot(jmain)
    assert visualize.pprint_program_codes(tmain) == \
        jax_visualize.pprint_program_codes(jmain)
    assert visualize.pprint_block_codes(
        tmain.global_block(), show_backward=False) == \
        jax_visualize.pprint_block_codes(jmain.global_block(),
                                         show_backward=False)
    assert visualize.draw_block_graphviz(
        tmain.global_block(), highlights=fetches, path=None) == \
        jax_visualize.draw_block_graphviz(jmain.global_block(),
                                          highlights=fetches, path=None)
    # with the donation plan's annotations
    jax_plan_donation(jmain, feed_names=feeds, fetch_names=fetches)
    plan = plan_donation(tmain, feed_names=feeds, fetch_names=fetches)
    assert plan.to_dict() == jmain._donation_plan.to_dict()
    assert plan.report() == jmain._donation_plan.report()
    assert visualize.program_dot(tmain) == jax_visualize.program_dot(jmain)


def test_dot_writes_its_file(tmp_path):
    _, tmain, _, _ = _carried("mnist", False)
    path = tmp_path / "p.dot"
    dot = visualize.program_dot(tmain, path=str(path))
    assert dot.startswith("digraph Program {") and path.read_text() == dot


def test_port_built_programs_lint_clean():
    """The port's own zoo builders (the transformer and VGG keep the
    grad through ``dropout``, so their train programs differ from the
    JAX package's) give no errors."""
    from paddle_tpu_torch.models import build_train_program as tbuild
    for name in ("transformer", "vgg"):
        main, startup, feeds, fetches = tbuild(name, backward=True)
        assert not analysis.lint_program(main, feeds, fetches).errors
        assert not analysis.lint_program(startup).errors
    assert fluid  # the reference package is imported for the carry-over
