"""The port's distributed-program verifier (``paddle_tpu_torch.analysis.
distributed``: PTA011–PTA017) against the JAX package's (mirror of
``tests/test_analysis_distributed.py``).

Every case builds its program family with the JAX package (the builders
of ``tests/test_analysis_distributed.py``), carries each program across
with ``Program.to_dict()`` / ``from_dict()``, runs both packages' check
and holds the port's diagnostics to the JAX package's: the same codes,
messages, variables, op types and members, in the same order.  The
pipeline cases (PTA015, ``check_stage_set``, ``check_pipeline_stages``,
``lint_pipeline``, ``check_pipeline_carriers``' PTA010 and ``lint
--pipeline``) run the same way; the gen-bundle codes PTA018/PTA019 are
held in ``tests/test_torch_cli_analysis.py``.
"""

import json
import os

import pytest

import test_analysis_distributed as J
from paddle_tpu.analysis import distributed as JD

import paddle_tpu_torch as pt
from paddle_tpu_torch.analysis import distributed as TD


def _t(program):
    return pt.Program.from_dict(program.to_dict())


def _key(diags):
    if hasattr(diags, "diagnostics"):
        diags = diags.diagnostics
    return [(d.code, d.severity, d.message, d.var, d.op_type, d.program)
            for d in diags]


def _pta011(D, cv):
    a = cv(J._collective_prog(["c_allreduce_sum", "c_broadcast"]))
    b = cv(J._collective_prog(["c_broadcast", "c_allreduce_sum"]))
    return D.check_collective_match([("replica0", a), ("replica1", b)])


def _pta012(D, cv):
    a = cv(J._collective_prog(["c_allreduce_sum"], axis="data"))
    b = cv(J._collective_prog(["c_allreduce_sum"], axis="model",
                              shape=(4, 8)))
    return D.check_collective_match([("replica0", a), ("replica1", b)])


def _pta013(D, cv):
    trainer, pserver = J._trainer_pserver_pair(recv_side=False,
                                               block_rows=(4, 4))
    return D.lint_pair(("trainer", cv(trainer)), [("pserver", cv(pserver))])


def _pta014(D, cv):
    trainer, pserver = J._trainer_pserver_pair(recv_side=True,
                                               block_rows=(3, 3))
    return D.lint_pair(("trainer", cv(trainer)), [("pserver", cv(pserver))])


def _pta016(D, cv):
    p, b = J._prog()
    b.create_parameter(shape=(9, 4), dtype="float32", name="w")
    return D.check_sharding(cv(p), {"w": ("model",)},
                            mesh_axes={"model": 2})


def _pta017(D, cv):
    p, b = J._prog()
    b.create_var(name="a", shape=(4, 4), dtype="float32", is_data=True)
    b.create_var(name="b", shape=(4, 4), dtype="float32", is_data=True)
    b.append_op(type="elementwise_add", inputs={"X": ["a"], "Y": ["b"]},
                outputs={"Out": ["c"]})
    return D.check_sharding(cv(p), {"a": ("data", None),
                                    "b": (None, "model")},
                            mesh_axes={"data": 2, "model": 2})


def _pta011_clean(D, cv):
    order = ["c_allreduce_sum", "c_broadcast", "c_allgather"]
    return D.check_collective_match(
        [("stage0", cv(J._collective_prog(order))),
         ("stage1", cv(J._collective_prog(order)))])


def _pta013_clean(D, cv):
    trainer, pserver = J._trainer_pserver_pair(recv_side=True,
                                               block_rows=(4, 4))
    return D.lint_pair(("trainer", cv(trainer)), [("pserver", cv(pserver))])


def _pta013_shape_drift(D, cv):
    trainer, pserver = J._trainer_pserver_pair(recv_side=True,
                                               block_rows=(4, 4))
    pserver.global_block().var("w@GRAD").shape = (8, 5)
    return D.lint_pair(("trainer", cv(trainer)), [("pserver", cv(pserver))])


def _adam_program(J):
    p, b = J._prog()
    b.create_parameter(shape=(8, 4), dtype="float32", name="w")
    for name in ("g", "m1", "m2"):
        b.create_var(name=name, shape=(8, 4), dtype="float32", is_data=True)
    for name in ("lr", "b1p", "b2p"):
        b.create_var(name=name, shape=(1,), dtype="float32", is_data=True)
    b.append_op(type="adam",
                inputs={"Param": ["w"], "Grad": ["g"], "LearningRate": ["lr"],
                        "Moment1": ["m1"], "Moment2": ["m2"],
                        "Beta1Pow": ["b1p"], "Beta2Pow": ["b2p"]},
                outputs={"ParamOut": ["w"], "Moment1Out": ["m1"],
                         "Moment2Out": ["m2"], "Beta1PowOut": ["b1p"],
                         "Beta2PowOut": ["b2p"]})
    return p


def _unknown_var(D, cv):
    p, _ = J._prog()
    return D.check_sharding(cv(p), {"ghost": ("model",)})


def _axis_not_in_mesh(D, cv):
    p, b = J._prog()
    b.create_parameter(shape=(8, 4), dtype="float32", name="w")
    return D.check_sharding(cv(p), {"w": ("nope",)}, mesh_axes={"model": 2})


def _optimizer_sees_placements(D, cv):
    p, b = J._prog()
    b.create_parameter(shape=(8, 4), dtype="float32", name="w")
    b.create_var(name="g", shape=(8, 4), dtype="float32", is_data=True)
    b.create_var(name="lr", shape=(1,), dtype="float32", is_data=True)
    b.append_op(type="sgd", inputs={"Param": ["w"], "Grad": ["g"],
                                    "LearningRate": ["lr"]},
                outputs={"ParamOut": ["w"]})
    return D.check_sharding(cv(p), {"w": ("model", None),
                                    "g": ("data", None)},
                            mesh_axes={"model": 2, "data": 2})


def _inconsistent_state(D, cv):
    return D.check_sharding(cv(_adam_program(J)),
                            {"m1": ("data", None), "m2": ()},
                            mesh_axes={"data": 2})


def _zero_shape_silent(D, cv):
    return D.check_sharding(cv(_adam_program(J)),
                            {"w": (), "g": (), "m1": ("data", None),
                             "m2": ("data", None)}, mesh_axes={"data": 2})


def _replicated_silent(D, cv):
    p, b = J._prog()
    b.create_parameter(shape=(8, 4), dtype="float32", name="w")
    b.create_var(name="a", shape=(2, 8), dtype="float32", is_data=True)
    b.append_op(type="mul", inputs={"X": ["a"], "Y": ["w"]},
                outputs={"Out": ["h"]})
    return D.check_sharding(cv(p), {"w": ()}, mesh_axes={"model": 2})


def _one_sided_contraction(D, cv):
    p, b = J._prog()
    b.create_var(name="a", shape=(2, 8), dtype="float32", is_data=True)
    b.create_parameter(shape=(8, 4), dtype="float32", name="w")
    b.append_op(type="matmul", inputs={"X": ["a"], "Y": ["w"]},
                outputs={"Out": ["h"]})
    return D.check_sharding(cv(p), {"a": (None, "model"), "w": (None, None)},
                            mesh_axes={"model": 2})


def _stages(cv, stages):
    return [(label, cv(prog), ins, outs) for label, prog, ins, outs in stages]


def _pta015(D, cv):
    return D.check_pipeline_stages(_stages(cv, J._stage_pair(
        consumer_shape=(2, 8))))


def _pta015_reordered(D, cv):
    return D.check_pipeline_stages(_stages(cv, J._stage_pair(reorder=True)))


def _pta011_across_stages(D, cv):
    """The headline drill: a pipeline stage whose collectives are
    reordered against its peer's is a static deadlock."""
    stages = J._stage_pair()
    s0 = stages[0][1].global_block()
    s1 = stages[1][1].global_block()
    s0.append_op(type="c_allreduce_sum", inputs={"X": ["h"]},
                 outputs={"Out": ["h_r"]}, attrs={"axis": "pipe"})
    s0.append_op(type="c_broadcast", inputs={"X": ["h_r"]},
                 outputs={"Out": ["h_b"]}, attrs={"axis": "pipe", "root": 0})
    s1.append_op(type="c_broadcast", inputs={"X": ["y"]},
                 outputs={"Out": ["y_b"]}, attrs={"axis": "pipe", "root": 0})
    s1.append_op(type="c_allreduce_sum", inputs={"X": ["y_b"]},
                 outputs={"Out": ["y_r"]}, attrs={"axis": "pipe"})
    return D.check_pipeline_stages(_stages(cv, stages))


def _stages_matching_collectives(D, cv):
    stages = J._stage_pair()
    for _, prog, _i, _o in stages:
        prog.global_block().append_op(
            type="c_allreduce_sum",
            inputs={"X": [prog.global_block().ops[0].output_arg_names[0]]},
            outputs={"Out": ["r"]}, attrs={"axis": "pipe"})
    return D.check_pipeline_stages(_stages(cv, stages))


#: case -> the codes it must give (empty: silent, zero false positives)
CASES = {
    "pta011_reordered_collectives": (_pta011, ["PTA011"]),
    "pta012_collective_attr_mismatch": (_pta012, ["PTA012"]),
    "pta013_send_without_recv": (_pta013, ["PTA013"]),
    "pta014_split_does_not_reassemble": (_pta014, ["PTA014"]),
    "pta016_invalid_sharding_spec": (_pta016, ["PTA016"]),
    "pta017_implicit_full_reshard": (_pta017, ["PTA017"]),
    "matching_collectives_are_clean": (_pta011_clean, []),
    "paired_send_recv_is_clean": (_pta013_clean, []),
    "shape_drifted_send_recv": (_pta013_shape_drift, ["PTA013"]),
    "spec_for_unknown_var": (_unknown_var, ["PTA016"]),
    "axis_not_in_mesh": (_axis_not_in_mesh, ["PTA016"]),
    "optimizer_sees_declared_placements": (_optimizer_sees_placements,
                                           ["PTA016"]),
    "inconsistent_optimizer_state": (_inconsistent_state, ["PTA016"]),
    "zero_shape_state_plan_is_silent": (_zero_shape_silent, []),
    "replicated_everything_is_silent": (_replicated_silent, []),
    "one_sided_contraction_shard": (_one_sided_contraction, ["PTA017"]),
    "pta015_boundary_carrier_mismatch": (_pta015, ["PTA015"]),
    "reordered_carrier_is_pta015": (_pta015_reordered, ["PTA015"]),
    "reordered_collective_pipeline_pair": (_pta011_across_stages,
                                           ["PTA011"]),
    "matching_collectives_across_stages": (_stages_matching_collectives,
                                           []),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_diagnostics_equal_the_reference(case):
    build, codes = CASES[case]
    want = _key(build(JD, lambda p: p))
    got = _key(build(TD, _t))
    assert got == want
    assert sorted({c for c, *_ in got}) == sorted(set(codes)), got


def test_param_grad_spec_disagreement_is_pta016():
    from paddle_tpu.parallel.distribute_transpiler import \
        DistributedSpec as JSpec
    from paddle_tpu_torch.parallel.distribute_transpiler import \
        DistributedSpec as TSpec
    p, b = J._prog()
    b.create_parameter(shape=(8, 4), dtype="float32", name="w")
    keys = []
    for D, Spec, cv in ((JD, JSpec, lambda x: x), (TD, TSpec, _t)):
        spec = Spec()
        spec.param_specs["w"] = ("model",)
        spec.grad_specs["w"] = ("data",)
        keys.append(_key(D.check_distributed_spec(cv(p), spec)))
    assert keys[0] == keys[1] and "PTA016" in {k[0] for k in keys[1]}


def test_registering_a_sharding_rule():
    calls = []

    @TD.sharding_rule("my_test_only_op")
    def _rule(op, senv):
        calls.append(op.type)
        senv.set_output(op, "Out", senv.input_spec(op, "X"))

    try:
        p, b = J._prog()
        b.create_var(name="a", shape=(4,), dtype="float32", is_data=True)
        b.append_op(type="my_test_only_op", inputs={"X": ["a"]},
                    outputs={"Out": ["o"]})
        diags = TD.check_sharding(_t(p), {"a": ("data",)},
                                  mesh_axes={"data": 2})
        assert calls == ["my_test_only_op"] and not diags
    finally:
        TD._SHARDING_RULES.pop("my_test_only_op", None)
    assert TD.sharding_rules() == JD.sharding_rules()


def _zoo():
    from paddle_tpu_torch.models import ZOO_MODELS
    return ZOO_MODELS


@pytest.mark.parametrize("name", _zoo())
def test_zoo_distribute_transpile_equals_the_reference(name):
    """Each zoo model's transpiled plan verifies clean, and the port's
    plan (specs and home shards) is the JAX package's, on the program
    the JAX package built."""
    from paddle_tpu.models import build_train_program
    from paddle_tpu.parallel.distribute_transpiler import \
        DistributeTranspiler as JT
    from paddle_tpu_torch.parallel.distribute_transpiler import \
        DistributeTranspiler as TT
    main, startup, _, _ = build_train_program(name)
    jt = JT().transpile(program=main, startup_program=startup,
                        pservers="a:1,b:2", shard_params=True)
    tmain, tstart = _t(main), _t(startup)
    tt = TT().transpile(program=tmain, startup_program=tstart,
                        pservers="a:1,b:2", shard_params=True)
    assert not TD.check_distributed_spec(tmain, tt.spec)
    assert {n: tuple(s) for n, s in tt.spec.param_specs.items()} == \
        {n: tuple(s) for n, s in jt.spec.param_specs.items()}
    assert tt.placement() == jt.placement()
    assert [(p, tuple(s)) for p, s in tt.param_shardings()] == \
        [(p, tuple(s)) for p, s in jt.param_shardings()]
    assert tt.get_trainer_program() is tmain


def test_splitters_equal_the_reference():
    """round_robin and hash_name placements (the reference's
    distributed_splitter) are the JAX package's, name for name."""
    from paddle_tpu.parallel import distribute_transpiler as JDT
    from paddle_tpu_torch.parallel import distribute_transpiler as TDT
    names = [f"sp_{c}.w_{i}" for c in "abcdefg" for i in range(3)]
    for k in (1, 2, 3, 5):
        assert TDT.round_robin_split(names, k) == \
            JDT.round_robin_split(names, k)
        assert TDT.hash_name_split(names, k) == JDT.hash_name_split(names, k)


def _write_model(path, program):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "__model__"), "w") as f:
        json.dump({"program": program.to_dict(), "feed_var_names": [],
                   "fetch_var_names": []}, f)
    return path


@pytest.mark.parametrize("recv_side,code", [(False, "PTA013"),
                                            (True, "PTA014")])
def test_lint_pair_mode_equals_the_reference(tmp_path, capsys, recv_side,
                                             code):
    from paddle_tpu.cli import main as jmain
    from paddle_tpu_torch.cli import main as tmain
    trainer, pserver = J._trainer_pserver_pair(recv_side=recv_side,
                                               block_rows=(3, 3))
    t = _write_model(str(tmp_path / "trainer"), trainer)
    p = _write_model(str(tmp_path / "pserver"), pserver)
    assert jmain(["lint", "--pair", t, p, "--json"]) == 1
    want = json.loads(capsys.readouterr().out)
    assert tmain(["lint", "--pair", t, p, "--json"]) == 1
    got = json.loads(capsys.readouterr().out)
    assert code in {d["code"] for tgt in got["targets"]
                    for d in tgt["diagnostics"]}

    def strip(report):
        for tgt in report["targets"]:
            for d in tgt["diagnostics"]:
                d.pop("site", None)
        return report

    assert strip(got) == strip(want)


def test_tampered_boundary_is_pta015():
    """``check_stage_set`` (the pipelined program's wiring): dropping a
    consumed carrier from a boundary is caught statically, as in the JAX
    package; the untampered split is clean."""
    from paddle_tpu.parallel.pipeline_transpiler import split_program as js
    from paddle_tpu_torch.parallel.pipeline_transpiler import \
        split_program as ts
    import paddle_tpu as fluid
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        h = fluid.layers.fc(input=x, size=8, act="relu")
        y = fluid.layers.fc(input=h, size=2)
    keys = []
    for D, split, prog in ((JD, js, main), (TD, ts, _t(main))):
        block, stage_ops, _params, boundaries = split(prog, 2, ["x"],
                                                      [y.name])
        tampered = [list(names) for names in boundaries]
        tampered[1] = []  # stage 1 consumes the carrier; drop it all
        keys.append(_key(D.check_stage_set(block, stage_ops, tampered,
                                           feed_names=["x"])))
        assert not D.check_stage_set(block, stage_ops, boundaries,
                                     feed_names=["x"])
    assert keys[0] == keys[1] and "PTA015" in {k[0] for k in keys[1]}


def test_pipeline_carrier_constant_out_of_range_is_pta010():
    """``check_pipeline_carriers``: an int64 literal outside int32 range
    crossing a stage boundary is rejected at transpile time (PTA010); an
    in-range one crosses freely."""
    from paddle_tpu import analysis as JA
    from paddle_tpu_torch import analysis as TA
    p, b = J._prog()
    b.append_op(type="fill_constant", outputs={"Out": ["big_id"]},
                attrs={"shape": [2], "dtype": "int64", "value": 2 ** 40})
    b.append_op(type="relu", inputs={"X": ["big_id"]},
                outputs={"Out": ["y"]})
    keys = []
    for A, prog in ((JA, p), (TA, _t(p))):
        with pytest.raises(A.ProgramVerificationError) as ei:
            A.check_pipeline_carriers(prog.global_block(), [["big_id"]])
        keys.append(_key(ei.value.diagnostics))
    assert keys[0] == keys[1] and keys[1][0][0] == "PTA010"
    p2, b2 = J._prog()
    b2.append_op(type="fill_constant", outputs={"Out": ["small_id"]},
                 attrs={"shape": [2], "dtype": "int64", "value": 7})
    assert TA.check_pipeline_carriers(_t(p2).global_block(),
                                      [["small_id"]]) == []


@pytest.mark.parametrize("name", _zoo())
def test_zoo_pipeline_split_equals_the_reference(name):
    """Each zoo model's 2-stage split lints clean in both packages, or
    both reject it with the same message."""
    from paddle_tpu import analysis as JA
    from paddle_tpu.models import build_train_program
    from paddle_tpu_torch import analysis as TA
    main, _startup, feeds, fetches = build_train_program(name)
    if feeds is None:
        feeds = [v.name for v in main.global_block().vars.values()
                 if getattr(v, "is_data", False)]
    results = []
    for A, prog in ((JA, main), (TA, _t(main))):
        try:
            results.append(_key(A.lint_pipeline(prog, 2, feeds, fetches)))
        except ValueError as e:
            results.append(("unsplittable", str(e)))
    assert results[0] == results[1]
    assert results[1] == [] or results[1][0] == "unsplittable"


def test_lint_pipeline_mode_equals_the_reference(capsys):
    from paddle_tpu.cli import main as jmain
    from paddle_tpu_torch.cli import main as tmain
    argv = ["lint", "--zoo", "mnist", "--pipeline", "2", "--json"]
    assert jmain(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert tmain(argv) == 0
    got = json.loads(capsys.readouterr().out)
    assert [t["target"] for t in got["targets"]] == \
        ["mnist", "mnist/pipeline2", "mnist/startup"]
    assert got["errors"] == 0
    assert [t["target"] for t in got["targets"]] == \
        [t["target"] for t in want["targets"]]
