"""The port's row-sharded embedding tables (``paddle_tpu_torch.embedding.
sharded_table``) against the JAX package's (mirror of the plan, gather,
scatter and dp4 parity classes of ``tests/test_embedding.py``).

In this process: ``plan_sharded_tables`` on the same Wide & Deep program
gives the JAX package's tables, states, rules, checkpoint specs and
diagnostics codes, and an indivisible vocab fails the proof in both.

In one 4-rank gloo world (``torch_worlds.sharded_table_cases``, a module
fixture): ``sharded_gather`` / ``sharded_scatter_add`` on each rank's
block against dense indexing, and Wide & Deep trained through
``ParallelExecutor`` on a ``data`` mesh of 4 with the plan's rules (the
table and its Adam moments cut to a quarter of the rows a rank) and
replicated, against the port's ``Executor`` on one device from the same
state: the losses and every persistable bitwise equal (batch 9 does not
split 4 ways, so the feeds stay whole and the table's split is the only
difference, as in the JAX package's test).
"""

import re

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.analysis import ProgramVerificationError as JError
from paddle_tpu.embedding import plan_sharded_tables as jplan
from paddle_tpu.models import wide_and_deep

import torch_worlds
import paddle_tpu_torch as pt
from paddle_tpu_torch.analysis import ProgramVerificationError as TError
from paddle_tpu_torch.convert import persistable_names, scope_from_numpy
from paddle_tpu_torch.embedding import plan_sharded_tables as tplan
from paddle_tpu_torch.embedding import registered_tables
from paddle_tpu_torch.profiler import runtime_metrics

WORLD = 4
STEPS = 4


def _build_wide_deep(batch=9, vocab=64):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 11
    with fluid.program_guard(main, startup):
        cost, acc, feeds = wide_and_deep.wide_and_deep_train_program(
            batch, vocab_size=vocab)
        fluid.optimizer.Adam(learning_rate=0.01).minimize(cost)
    return main, startup, cost


def _feeds():
    rng = np.random.RandomState(0)
    return [{"slot_ids": rng.randint(0, 64, (9, 4, 1)).astype("int64"),
             "dense": rng.rand(9, 8).astype("float32"),
             "label": rng.randint(0, 2, (9, 1)).astype("int64")}
            for _ in range(STEPS)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 4-rank world's results, and the port's one-device run of the
    same training."""
    send, result = torch_worlds.spawn_world(
        torch_worlds.sharded_table_cases, WORLD,
        tmp_path_factory.mktemp("stworld"))
    main, startup, cost = _build_wide_deep()
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    tmain = pt.Program.from_dict(main.to_dict())
    state = {n: np.array(np.asarray(scope.find_var(n)))
             for n in persistable_names(tmain)}
    rng = np.random.RandomState(4)
    case = {"w": np.arange(64 * 3, dtype=np.float32).reshape(64, 3),
            "ids": np.array([0, 5, 17, 63, 33, 17]),
            "rows": np.array([3, 40, 3, 63]),
            "vals": rng.rand(4, 3).astype(np.float32),
            "program": main.to_dict(), "state": state, "feeds": _feeds(),
            "fetch": [cost.name]}
    send(case)
    tscope = scope_from_numpy(state, pt.CPUPlace())
    exe = pt.Executor(pt.CPUPlace())
    losses = [np.asarray(exe.run(tmain, feed=f, fetch_list=[cost.name],
                                 scope=tscope)[0]) for f in case["feeds"]]
    single = {"losses": losses,
              "state": {n: np.asarray(tscope.find_var(n))
                        for n in tscope.local_var_names()}}
    return case, result(), single


# ---------------------------------------------------------------------------
# the plan, in this process
# ---------------------------------------------------------------------------

def test_plan_equals_the_reference():
    """The same tables, row-shaped moments, rules and checkpoint specs as
    the JAX package's; the scalar betas stay replicated."""
    main, _, _ = _build_wide_deep()
    want = jplan(main, mesh_axis="data", mesh_axes={"data": 4})
    before = runtime_metrics.counter("embedding.plans")
    got = tplan(pt.Program.from_dict(main.to_dict()), mesh_axis="data",
                mesh_axes={"data": 4})
    assert runtime_metrics.counter("embedding.plans") == before + 1
    assert set(got.tables) == {"wide_deep_emb", "wide_lr_w"}
    assert got.tables == want.tables and got.states == want.states
    assert {n.split(".")[0] for n in got.states} == {"moment1", "moment2"}
    assert [(pat, tuple(spec)) for pat, spec in got.rules()] == \
        [(pat, tuple(spec)) for pat, spec in want.rules()]
    assert got.checkpoint_specs() == want.checkpoint_specs()
    assert got.diagnostics == [] == want.diagnostics and bool(got)
    assert registered_tables()["wide_deep_emb"]["vocab"] == 64
    for pat, _ in got.rules():
        names = [n for n in got.all_placements() if re.search(pat, n)]
        assert len(names) == 1, pat  # one rule, one tensor


def test_indivisible_vocab_fails_the_proof():
    main, _, _ = _build_wide_deep(vocab=66)  # 66 % 4 != 0
    tmain = pt.Program.from_dict(main.to_dict())
    with pytest.raises(JError):
        jplan(main, mesh_axis="data", mesh_axes={"data": 4})
    with pytest.raises(TError):
        tplan(tmain, mesh_axis="data", mesh_axes={"data": 4})
    want = jplan(main, mesh_axis="data", mesh_axes={"data": 4},
                 raise_on_error=False).diagnostics
    got = tplan(tmain, mesh_axis="data", mesh_axes={"data": 4},
                raise_on_error=False).diagnostics
    assert [(d.code, d.message, d.var) for d in got] == \
        [(d.code, d.message, d.var) for d in want]
    assert any(d.code in ("PTA016", "PTA017") for d in got)


# ---------------------------------------------------------------------------
# in the world
# ---------------------------------------------------------------------------

def test_sharded_gather_matches_dense_take(world):
    case, got, _ = world
    np.testing.assert_array_equal(got["gather"], case["w"][case["ids"]])


def test_sharded_scatter_add_matches_dense_scatter(world):
    case, got, _ = world
    want = np.zeros_like(case["w"])
    np.add.at(want, case["rows"], case["vals"])
    np.testing.assert_array_equal(np.concatenate(got["scatter_blocks"]),
                                  want)


@pytest.mark.parametrize("run", ["sharded", "replicated"])
def test_dp4_losses_and_state_bitwise_equal_one_device(world, run):
    """Row-sharding the tables is numerically transparent: every loss
    and every persistable after the steps equals the one-device run's
    bit for bit."""
    _, got, single = world
    got = got[run]
    assert [x.tobytes() for x in got["losses"]] == \
        [x.tobytes() for x in single["losses"]]
    assert set(got["state"]) <= set(single["state"])
    for n, v in got["state"].items():
        assert np.asarray(v).tobytes() == \
            np.asarray(single["state"][n]).tobytes(), n


def test_tables_and_moments_hold_a_quarter_of_the_rows(world):
    """The planned tables are really partitioned: a quarter of the rows
    a rank, their Adam moments alongside."""
    _, got, _ = world
    heights = got["sharded"]["local_rows"]
    sharded = [n for n in heights if n in ("wide_deep_emb", "wide_lr_w")
               or n.startswith("moment")]
    assert len(sharded) >= 6 and set(sharded) == set(heights)
    for n in sharded:
        assert heights[n] * WORLD == got["sharded"]["state"][n].shape[0], n
        assert got["sharded"]["placements"][n][0] == "data"
