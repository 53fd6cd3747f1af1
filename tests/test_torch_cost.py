"""The port's static cost model against the JAX package's: on every zoo
program (built by the JAX package, carried over as a dict) ``estimate``
gives the same total and per-op FLOPs and bytes, ``row_cost_fn`` the
same fit, ``op_flops`` the same per-op weights, and the port's report
passes ``validate_cost_report``.  All exact: they are integers."""

import pytest

import paddle_tpu_torch as pt
from paddle_tpu.analysis import cost as jax_cost
from paddle_tpu.models import ZOO_MODELS, build_train_program
from paddle_tpu_torch.analysis import cost

ZOO_CASES = [(m, bw) for m in ZOO_MODELS for bw in (True, False)]


def _zoo_id(case):
    return f"{case[0]}-{'train' if case[1] else 'forward'}"


@pytest.mark.parametrize("case", ZOO_CASES, ids=_zoo_id)
def test_estimate_matches_per_op(case):
    jmain, _, feeds, _ = build_train_program(*case)
    tmain = pt.Program.from_dict(jmain.to_dict())
    want = jax_cost.estimate(jmain)
    got = cost.estimate(tmain)
    assert got.to_dict() == want.to_dict()
    assert got.total_flops > 0
    assert got.by_op_type() == want.by_op_type()
    assert cost.validate_cost_report(got.to_dict()) == []
    block, jblock = tmain.global_block(), jmain.global_block()
    assert [cost.op_flops(op, block) for op in block.ops] == \
        [jax_cost.op_flops(op, jblock) for op in jblock.ops]
    # the fit over the batch rows of the first feed, at the bucket sizes
    # a planner would price
    var = feeds[0] if feeds else None
    jfit = jax_cost.row_cost_fn(jmain, batch_var=var)
    tfit = cost.row_cost_fn(tmain, batch_var=var)
    assert [tfit(r) for r in (1, 3, 8, 64)] == \
        [jfit(r) for r in (1, 3, 8, 64)]
    # the probe leaves the program's declared shapes as they were
    assert tmain.to_dict() == pt.Program.from_dict(
        jmain.to_dict()).to_dict()


def test_validate_cost_report_rejects_a_broken_report():
    body = cost.estimate(pt.Program()).to_dict()
    assert cost.validate_cost_report(body) == []
    bad = dict(body, total_flops=-1, per_op=[{"op_index": 0}])
    problems = cost.validate_cost_report(bad)
    assert problems == jax_cost.validate_cost_report(bad)
    assert any("total_flops" in p for p in problems)
    assert cost.validate_cost_report([]) == \
        jax_cost.validate_cost_report([])


def test_rule_tables_match():
    assert cost.covered_op_types() == jax_cost.covered_op_types()
    for name in ("_c_sdpa", "_c_paged_attention", "_c_lstm"):
        assert callable(getattr(cost, name))
