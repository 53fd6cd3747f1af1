"""The port's numerics observatory (``paddle_tpu_torch.obs.numerics``)
against the JAX package's (``paddle_tpu.obs.numerics``), the cases of
``tests/test_numerics.py``: tensor stats on the same values, probing
that forces the eager step and names the first non-finite op in both
packages alike, the bounded trail, and the fused health norms.

Tolerances: the stats of integers and booleans (float64 in both) and
the counts are equal; a float mean and std are float32 sums taken in
another order, so within ``STAT_RTOL`` of the values' magnitude (their
absmax, at least 1); the health norms within ``NORM_RTOL``."""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.obs import numerics as ref_numerics
from paddle_tpu_torch.obs import numerics
from paddle_tpu_torch.profiler import RuntimeMetrics, runtime_metrics

STAT_RTOL = 1e-5
NORM_RTOL = 1e-5


def _same_stats(got, want):
    assert set(got) == set(want)
    # float32 sums in another order: an error relative to the values'
    # magnitude (their absmax), not to the mean or std themselves
    scale = max(1.0, abs(want.get("absmax") or 0.0))
    for k, w in want.items():
        g = got[k]
        if isinstance(w, float) and isinstance(g, float):
            assert g == pytest.approx(w, rel=STAT_RTOL,
                                      abs=STAT_RTOL * scale), k
        else:
            assert g == w, k


_STAT_CASES = {
    "float": np.array([[1.0, -2.0], [0.0, 4.0]], np.float32),
    "nan_inf": np.array([1.0, np.nan, np.inf, 2.0], np.float32),
    "all_nan": np.full(3, np.nan, np.float32),
    "int": np.array([0, 3, -7], np.int64),
    "bool": np.array([True, False, True, True]),
    "empty": np.array([], np.float32),
    "random": np.random.RandomState(0).randn(64, 33).astype(np.float32),
    "scalar": np.float32(2.5),
}


@pytest.mark.parametrize("case", sorted(_STAT_CASES))
def test_tensor_stats_match_reference(case):
    value = _STAT_CASES[case]
    _same_stats(numerics.tensor_stats(torch.as_tensor(np.asarray(value))),
                ref_numerics.tensor_stats(value))
    # a numpy value is statted the same as its tensor
    _same_stats(numerics.tensor_stats(value),
                ref_numerics.tensor_stats(value))


def test_tensor_stats_bfloat16_and_unstatable():
    import jax.numpy as jnp
    got = numerics.tensor_stats(torch.tensor([1.0, 2.0, -0.5],
                                             dtype=torch.bfloat16))
    want = ref_numerics.tensor_stats(jnp.asarray([1.0, 2.0, -0.5],
                                                 jnp.bfloat16))
    _same_stats(got, want)
    assert got["dtype"] == "bfloat16"
    assert numerics.tensor_stats(object())["kind"] == "object"
    assert numerics.tensor_stats(object()) == \
        ref_numerics.tensor_stats(object())


def _fc_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[3], dtype="float32")
        h = pkg.layers.fc(x, 2)
        loss = pkg.layers.reduce_mean(h)
    return main, startup, loss


def test_probe_forces_eager_and_counts_ops():
    main, startup, loss = _fc_program(pt)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.ones((2, 3), np.float32)}
    exe.run(main, feed=feed, fetch_list=[loss.name], scope=scope)
    plain = set(exe._cache)
    before = runtime_metrics.counter("numerics.ops_probed")
    collector = numerics.ProbeCollector()
    with numerics.probe(collector):
        assert numerics.probing_enabled()
        exe.run(main, feed=feed, fetch_list=[loss.name], scope=scope)
    assert not numerics.probing_enabled()
    # probing is a signature of its own (the eager step); the plain key
    # is unchanged
    probed = [k for k in exe._cache if k not in plain]
    assert len(probed) == 1 and probed[0][-1] == ("probing",)
    assert exe._cache[probed[0]].interpret
    assert collector.ops_probed == len(main.global_block().ops)
    assert runtime_metrics.counter("numerics.ops_probed") == \
        before + collector.ops_probed
    assert collector.first_bad is None


def _log_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[4], dtype="float32")
        h = pkg.layers.fc(x, 4)
        shifted = pkg.layers.elementwise_sub(
            h, pkg.layers.fill_constant([1], "float32", 1e6))
        bad = pkg.layers.log(shifted)   # log of a negative: NaN
        loss = pkg.layers.reduce_mean(bad)
    return main, startup, loss


def test_organic_nan_localizes_like_the_reference():
    """The same program dict and state in both packages: the first bad
    op, its index, its creation site (this file) and the stats of its
    inputs and outputs agree."""
    from paddle_tpu_torch.convert import to_numpy
    main, startup, loss = _log_program(pt)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    state = {n: to_numpy(v) for n, v in scope.items()
             if isinstance(v, torch.Tensor)}
    feed = {"x": np.ones((2, 4), np.float32)}
    before = runtime_metrics.counter("numerics.non_finite_ops")
    collector = numerics.ProbeCollector(trail=4)
    with numerics.probe(collector):
        exe.run(main, feed=feed, fetch_list=[loss.name], scope=scope)
    fb = collector.first_bad
    assert fb is not None and fb["type"] == "log"
    assert fb["creation_site"][0].endswith("test_torch_numerics.py")
    assert all(s["finite_frac"] == 1.0 for s in fb["inputs"].values())
    assert any(s["finite_frac"] < 1.0 for s in fb["outputs"].values())
    assert len(fb["trail"]) <= 4 and fb["trail"][-1]["type"] == "log"
    assert runtime_metrics.counter("numerics.non_finite_ops") == before + 1

    ref_main = fluid.Program.from_dict(main.to_dict())
    ref_scope = fluid.Scope()
    for n, v in state.items():
        ref_scope.set_var(n, v)
    ref_c = ref_numerics.ProbeCollector(trail=4)
    with ref_numerics.probe(ref_c):
        fluid.Executor(fluid.CPUPlace()).run(
            ref_main, feed=feed, fetch_list=[loss.name], scope=ref_scope)
    rb = ref_c.first_bad
    assert (fb["index"], fb["type"]) == (rb["index"], rb["type"])
    assert fb["creation_site"] == rb["creation_site"]
    assert collector.ops_probed == ref_c.ops_probed
    assert [r["type"] for r in fb["trail"]] == \
        [r["type"] for r in rb["trail"]]
    for n in rb["inputs"]:
        _same_stats(fb["inputs"][n], rb["inputs"][n])
    for n in rb["outputs"]:
        _same_stats(fb["outputs"][n], rb["outputs"][n])


def test_trail_is_bounded():
    class _Op:
        type = "fake"
        input_arg_names = []
        output_arg_names = ["o"]
        creation_site = ("f.py", 1)

    c = numerics.ProbeCollector(trail=3)
    for _ in range(10):
        c.record_op(_Op(), {"o": None}, {"o": torch.zeros(2)})
    assert len(c.trail) == 3 and c.ops_probed == 10


def test_poison_var_nans_its_producing_op():
    main, startup, loss = _fc_program(pt)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    c = numerics.ProbeCollector(poison_var=loss.name)
    with numerics.probe(c):
        out, = exe.run(main, feed={"x": np.ones((2, 3), np.float32)},
                       fetch_list=[loss.name], scope=scope)
    assert c.poisoned and np.isnan(out).all()
    assert c.first_bad["type"] == "reduce_mean"


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_health_matches_reference(seed):
    import jax.numpy as jnp
    rng = np.random.RandomState(seed)
    old = [rng.randn(4, 5).astype(np.float32),
           rng.randn(7).astype(np.float32)]
    new = [o + 0.01 * rng.randn(*o.shape).astype(np.float32) for o in old]
    arrs = [rng.randn(3).astype(np.float32)] + new
    flat = numerics.fused_check_fn()(
        [torch.as_tensor(a) for a in arrs],
        [torch.as_tensor(a) for a in new],
        [torch.as_tensor(a) for a in old]).tolist()
    finite, norms, extra = numerics.split_fused(flat, True)
    ref_finite, ref_norms = ref_numerics.fused_check_fn()(
        [jnp.asarray(a) for a in arrs], [jnp.asarray(a) for a in new],
        [jnp.asarray(a) for a in old])
    assert finite == bool(ref_finite) and extra == []
    got = numerics.health_from_norms(norms)
    want = ref_numerics.health_from_norms(np.asarray(ref_norms))
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=NORM_RTOL), k


def test_fused_check_norms_and_non_finite():
    fn = numerics.fused_check_fn()
    flat = fn([torch.ones(3)], [torch.full((2, 2), 0.5)],
              [torch.zeros(2, 2)], [torch.tensor([3.0])]).tolist()
    finite, norms, extra = numerics.split_fused(flat, True)
    health = numerics.health_from_norms(norms)
    assert finite and extra == [3.0]
    assert health["param_norm"] == pytest.approx(1.0)
    assert health["grad_norm"] == pytest.approx(1.0)
    assert health["update_ratio"] == pytest.approx(1.0)
    flat = fn([torch.tensor([1.0, float("nan")]),
               torch.tensor([1.0], dtype=torch.float64)], [], []).tolist()
    finite, norms, _ = numerics.split_fused(flat, False)
    assert not finite and numerics.health_from_norms(norms) is None


def test_set_health_gauges():
    m = RuntimeMetrics()
    numerics.set_health_gauges(m, None)        # disabled: no-op
    assert m.gauge("train.grad_norm") is None
    numerics.set_health_gauges(
        m, {"param_norm": 2.0, "grad_norm": 0.5, "update_ratio": 0.25})
    assert m.gauge("train.param_norm") == 2.0
    assert m.gauge("train.grad_norm") == 0.5
    assert m.gauge("train.update_ratio") == 0.25
