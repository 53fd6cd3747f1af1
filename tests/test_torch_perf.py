"""The port's device-performance plane (``paddle_tpu_torch.obs.perf``,
the device timing of ``paddle_tpu_torch.profiler``) against the JAX
package's, the cases of ``tests/test_perf.py`` that do not read XLA:
the cost record of each prepared signature (its FLOPs equal to the JAX
package's ``analysis.cost.estimate`` of the same program dict), the
routing of the live MFU gauges, ``note_step``'s arithmetic, the HBM
census's attribution (equal to the reference's on the same state) and
its providers, cadence and headroom warning, the ``profile compile`` /
``profile memory`` commands on MNIST, the step-phase series, and the
trace readers on a synthetic trace and a CPU trace.

On the CPU there is no allocator: a record's ``temp_bytes`` and the
census's ``total``, ``other`` and ``high_watermark`` are None (the card
cases are in ``tests/test_torch_cuda.py``)."""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.analysis import cost as ref_cost
from paddle_tpu.obs import perf as ref_perf
from paddle_tpu_torch import cli, profiler
from paddle_tpu_torch.convert import to_numpy
from paddle_tpu_torch.executor import _mfu_gauge_for
from paddle_tpu_torch.obs import perf
from paddle_tpu_torch.profiler import runtime_metrics


def _build_fc_train(pkg=pt, size=8):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 1
    with pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[4], dtype="float32")
        y = pkg.layers.fc(input=x, size=size)
        loss = pkg.layers.mean(y)
        pkg.optimizer.Adam(learning_rate=0.1).minimize(loss)
    return main, startup, loss.name


def _run_fresh(main, startup, fetch, feed=None, runs=1, **kw):
    """Startup + ``runs`` steps in a fresh scope and CPU executor;
    returns ``(scope, exe, records made during the call)``."""
    before = {r["key"] for r in perf.records()}
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    feed = feed or {"x": np.ones((2, 4), np.float32)}
    for _ in range(runs):
        exe.run(main, feed=feed, fetch_list=[fetch], scope=scope, **kw)
    return scope, exe, [r for r in perf.records() if r["key"] not in before]


def test_record_fields_and_live_mfu_gauge():
    main, startup, loss = _build_fc_train()
    _scope, _exe, recs = _run_fresh(main, startup, loss, runs=2)
    (r,) = [r for r in recs if "x:2x4" in r["label"]]
    assert r["flops"] > 0 and r["bytes_accessed"] > 0
    assert r["flops_source"] == "analysis.cost.estimate"
    for k in perf.MEMORY_KEYS:
        assert k in r["memory"]
    assert r["memory"]["temp_bytes"] is None           # no allocator
    assert r["memory"]["argument_bytes"] > r["memory"]["alias_bytes"] > 0
    for k in perf.PHASE_KEYS:
        assert r["phases"][k] >= 0
    assert r["steps"] == 2 and r["mfu"] > 0
    assert runtime_metrics.gauge("train.mfu") == pytest.approx(r["mfu"])
    peak, basis = perf.peak_flops_info("cpu")
    assert basis == "cpu-fallback"
    assert r["mfu"] == pytest.approx(
        r["flops"] / (r["last_step_seconds"] * peak))


def _concrete(program, shapes):
    copy = fluid.Program.from_dict(program.to_dict())
    for n, s in shapes.items():
        copy.global_block().vars[n].shape = list(s)
    return copy


def test_record_flops_equal_the_reference_estimate():
    """The record prices the program with the run's feed shapes: the JAX
    package's static estimate of the same dict with those shapes."""
    main, startup, loss = _build_fc_train(size=16)
    _, _, recs = _run_fresh(main, startup, loss,
                            feed={"x": np.ones((5, 4), np.float32)})
    (r,) = [r for r in recs if "x:5x4" in r["label"]]
    want = ref_cost.estimate(_concrete(main, {"x": (5, 4)}))
    assert r["flops"] == want.total_flops
    assert r["bytes_accessed"] == want.total_bytes


def test_transformer_record_flops_equal_the_reference_estimate():
    from paddle_tpu_torch.models import transformer as T
    hp = T.ModelHyperParams()
    hp.d_model, hp.d_inner_hid, hp.n_layer = 32, 64, 1
    hp.n_head, hp.d_key, hp.d_value = 2, 16, 16
    hp.src_vocab_size = hp.trg_vocab_size = 50
    hp.max_length, hp.dropout = 16, 0.0
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        cost, _ = T.transformer(2, 8, 8, hp)
        pt.optimizer.Adam(learning_rate=1e-3).minimize(cost)
    feed = T.fake_batch(2, 8, 8, hp, seed=0)
    _, _, recs = _run_fresh(main, startup, cost.name, feed=feed)
    (r,) = [r for r in recs if r["label"] != "(no feeds)"]
    want = ref_cost.estimate(fluid.Program.from_dict(main.to_dict()))
    assert r["flops"] == want.total_flops > 0


def test_cost_estimate_waits_for_its_first_need(monkeypatch):
    """A record prices its program at the first step that sets a gauge
    or at ``records()``, once, and times it; a signature that sets no
    gauge pays nothing until reported; a program changed since its
    record was made is not priced."""
    calls = []
    real = perf._cost

    def counting(program, shapes):
        calls.append(dict(shapes))
        return real(program, shapes)
    monkeypatch.setattr(perf, "_cost", counting)
    main, startup, loss = _build_fc_train(size=6)
    scope, exe, _ = _run_fresh(main, startup, loss, runs=3,
                               feed={"x": np.ones((3, 4), np.float32)})
    assert calls.count({"x": (3, 4)}) == 1
    rec = exe._last_compiled.perf_record
    assert rec["flops"] > 0 and rec["cost_seconds"] >= 0
    quiet = {}
    for rows in (7, 9):
        exe.run(main, feed={"x": np.ones((rows, 4), np.float32)},
                fetch_list=[loss], scope=scope, return_numpy=False)
        quiet[rows] = exe._last_compiled.perf_record
        if rows == 7:
            assert {"x": (7, 4)} not in calls and quiet[7]["flops"] is None
            reported = {r["key"]: r for r in perf.records()}
            assert calls.count({"x": (7, 4)}) == 1
            assert reported[quiet[7]["key"]]["flops"] > 0
    main.bump_version()
    reported = {r["key"]: r for r in perf.records()}
    assert {"x": (9, 4)} not in calls
    assert reported[quiet[9]["key"]]["flops"] is None
    assert calls.count({"x": (7, 4)}) == calls.count({"x": (3, 4)}) == 1


def test_mfu_gauge_routing():
    main, startup, loss = _build_fc_train(size=12)
    assert _mfu_gauge_for(main) == "train.mfu"
    main._mfu_gauge = "gen.decode_mfu"
    assert _mfu_gauge_for(main) == "gen.decode_mfu"
    inf = pt.Program()
    inf._is_inference = True
    assert _mfu_gauge_for(inf) is None
    # a tagged program's steps land in its own gauge, not train.mfu
    runtime_metrics.set_gauge("train.mfu", -2.0)
    before = runtime_metrics.gauge("gen.decode_mfu")
    _run_fresh(main, startup, loss)
    assert runtime_metrics.gauge("gen.decode_mfu") not in (None, before)
    assert runtime_metrics.gauge("train.mfu") == -2.0


def test_inference_and_async_paths_derive_no_gauge():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[4], dtype="float32")
        y = pt.layers.fc(input=x, size=8)
    main._is_inference = True
    runtime_metrics.set_gauge("train.mfu", -3.0)
    _run_fresh(main, startup, y.name)
    assert runtime_metrics.gauge("train.mfu") == -3.0
    tmain, tstartup, loss = _build_fc_train(size=20)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(tstartup, scope=scope)
    feed = {"x": np.ones((2, 4), np.float32)}
    runtime_metrics.set_gauge("train.mfu", -1.0)
    exe.run(tmain, feed=feed, fetch_list=[loss], scope=scope,
            return_numpy=False)
    exe.run_steps(tmain, feed=feed, fetch_list=[loss], steps=2, scope=scope,
                  return_numpy=False)
    assert runtime_metrics.gauge("train.mfu") == -1.0
    exe.run_steps(tmain, feed=feed, fetch_list=[loss], steps=2, scope=scope)
    assert runtime_metrics.gauge("train.mfu") > 0


def test_note_step_arithmetic():
    peak = perf.peak_flops_info("cpu")[0]
    rec = {"flops": 1e9, "steps": 0, "last_step_seconds": None,
           "mfu": None, "device": "cpu"}
    m1 = perf.note_step(dict(rec), 1.0)
    assert m1 == pytest.approx(1e9 / peak)
    assert perf.note_step(dict(rec), 1.0, flops_scale=4) == \
        pytest.approx(4 * m1)
    assert perf.note_step(dict(rec), 2.0, devices=2) == \
        pytest.approx(m1 / 4)
    assert perf.note_step(None, 1.0) is None
    assert perf.note_step(dict(rec, flops=None), 1.0) is None
    assert perf.note_step(dict(rec), 0.0) is None
    # the reference's arithmetic, at its own peak
    ref = ref_perf.note_step(dict(rec), 1.0, flops_scale=4)
    assert ref * ref_perf.peak_flops_info()[0] == pytest.approx(
        perf.note_step(dict(rec), 1.0, flops_scale=4) * peak)


def test_report_schema():
    _build = _build_fc_train(size=6)
    _run_fresh(*_build)
    report = perf.compile_report()
    assert perf.validate_report(report) == []
    assert report["records"] and report["mfu_basis"] in perf.MFU_BASES
    # the port's basis names are its own: a TPU basis is drift
    assert perf.validate_report(dict(report, mfu_basis="tpu-peak"))
    bad = json.loads(json.dumps(report))
    del bad["records"][0]["phases"]["trace_seconds"]
    assert perf.validate_report(bad)
    assert perf.validate_report([]) and perf.validate_report(
        dict(report, format=2))


def test_capture_disabled_env(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PERF", "0")
    main, startup, loss = _build_fc_train(size=32)
    runtime_metrics.set_gauge("train.mfu", -4.0)
    _, _, recs = _run_fresh(main, startup, loss)
    assert recs == [] and runtime_metrics.gauge("train.mfu") == -4.0


def test_census_attribution_matches_reference():
    """The same Adam state in both packages: params and optimizer state
    split alike, to the byte."""
    main, startup, loss = _build_fc_train(size=24)
    scope, _, _ = _run_fresh(main, startup, loss)
    census = perf.hbm_census(scope, device="cpu")
    ref_scope = fluid.Scope()
    for n, v in scope.items():
        if isinstance(v, torch.Tensor):
            ref_scope.set_var(n, to_numpy(v))
    want = ref_perf.hbm_census(ref_scope)
    assert census["params"] == want["params"] > 0
    assert census["optimizer"] == want["optimizer"] > 0
    assert census["total"] is None and census["other"] is None
    assert census["high_watermark"] is None and "limit" not in census
    for g in ("hbm.params_bytes", "hbm.optimizer_bytes"):
        assert runtime_metrics.gauge(g) is not None


def test_census_counts_a_storage_once():
    scope = pt.Scope()
    w = torch.zeros(10, 4)
    scope.set_var("w", w)
    scope.set_var("w_view", w[:5])          # the same storage
    scope.set_var("moment1_w", torch.zeros(10, 4))
    kid = scope.new_scope()
    kid.set_var("tmp", torch.zeros(3))
    census = perf.hbm_census(kid, device="cpu")
    assert census["params"] == 10 * 4 * 4 + 3 * 4
    assert census["optimizer"] == 10 * 4 * 4


def test_provider_collection(monkeypatch):
    # the census of this test's providers only: a GenPredictor that an
    # earlier test left alive keeps its own registered until it is
    # finalized
    monkeypatch.setattr(perf, "_hbm_providers", {})
    pool = torch.zeros(4, 16)
    host_table = np.zeros((4, 2), np.int32)   # host memory: not counted
    token = perf.register_hbm_provider("kv_pages",
                                       lambda: [pool, host_table])
    bad = perf.register_hbm_provider("kv_cache", lambda: 1 / 0)
    try:
        scope = pt.Scope()
        scope.set_var("pool", pool)     # claimed by the provider first
        census = perf.hbm_census(scope, device="cpu")
        assert census["kv_pages"] == pool.numel() * 4
        assert census["kv_cache"] == 0 and census["params"] == 0
    finally:
        perf.unregister_hbm_provider(token)
        perf.unregister_hbm_provider(bad)
    assert perf.hbm_census(pt.Scope(), device="cpu")["kv_pages"] == 0


def test_gen_predictor_feeds_decode_mfu_and_kv_census(tmp_path):
    from paddle_tpu_torch.gen import GenPredictor, GenScheduler
    from paddle_tpu_torch.models import gen_lm
    d = str(tmp_path / "gen")
    gen_lm.export_gen_model(d, gen_lm.GenConfig(), num_slots=2,
                            place=pt.CPUPlace(), seed=3)
    pred = GenPredictor(d, place=pt.CPUPlace())
    assert pred._dec_prog._mfu_gauge == "gen.decode_mfu"
    runtime_metrics.set_gauge("train.mfu", -5.0)
    runtime_metrics.set_gauge("gen.decode_mfu", -5.0)
    sched = GenScheduler(pred)
    assert len(list(sched.submit([1, 2, 3], max_new_tokens=4))) == 4
    sched.close()
    assert runtime_metrics.gauge("gen.decode_mfu") > 0
    assert runtime_metrics.gauge("train.mfu") == -5.0
    census = perf.hbm_census(pt.Scope(), device="cpu")
    pool = sum(pred._scope.find_var(n).numel() *
               pred._scope.find_var(n).element_size()
               for n in pred.cache_vars)
    assert pred.paged and census["kv_pages"] == pool


def test_census_tick_cadence():
    before = runtime_metrics.counter("hbm.census_runs")
    perf.arm_census(3600.0)
    try:
        perf.census_tick(pt.Scope())   # due at once (a fresh arm)
        perf.census_tick(pt.Scope())   # armed, not due: no census
        assert runtime_metrics.counter("hbm.census_runs") == before + 1
    finally:
        perf.arm_census(None)
    perf.census_tick(pt.Scope())       # unarmed: no census
    assert runtime_metrics.counter("hbm.census_runs") == before + 1


def test_census_armed_from_env(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_HBM_CENSUS", "3600")
    before = runtime_metrics.counter("hbm.census_runs")
    try:
        main, startup, loss = _build_fc_train(size=28)
        _run_fresh(main, startup, loss, runs=2)
        assert runtime_metrics.counter("hbm.census_runs") == before + 1
    finally:
        perf.arm_census(None)


def test_headroom_warning_fires_after_the_first_run(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_HBM_LIMIT_BYTES", "1")
    assert perf.hbm_limit_bytes("cpu") == 1
    before = runtime_metrics.counter("hbm.headroom_warnings")
    main, startup, loss = _build_fc_train(size=40)
    _run_fresh(main, startup, loss)
    assert runtime_metrics.counter("hbm.headroom_warnings") > before
    assert runtime_metrics.gauge("hbm.limit_bytes") == 1


def test_step_phases_series():
    main, startup, loss = _build_fc_train(size=36)
    names = [f"perf.step.{p}_seconds"
             for p in ("feed", "dispatch", "device_wait", "fetch")]
    snap = runtime_metrics.snapshot()["series"]
    before = {n: snap.get(n, {}).get("count", 0) for n in names}
    perf.enable_step_phases()
    try:
        _run_fresh(main, startup, loss, runs=2)
    finally:
        perf.disable_step_phases()
    snap = runtime_metrics.snapshot()["series"]
    for n in names:
        # the startup run and the two steps
        assert snap[n]["count"] == before[n] + 3, n
    assert not perf.step_phases_enabled()


@pytest.mark.parametrize("mode", ["compile", "memory"])
def test_profile_json_on_mnist(mode, capsys):
    rc = cli.main(["profile", mode, "--zoo", "mnist", "--place", "cpu",
                   "--json"])
    assert rc == 0
    body = json.loads(capsys.readouterr().out)
    if mode == "compile":
        assert perf.validate_report(body) == []
        assert any(r["flops"] for r in body["records"])
    else:
        for k in ("params", "optimizer", "kv_cache", "prefetch", "other",
                  "total", "high_watermark"):
            assert k in body
        assert body["params"] > 0 and body["optimizer"] > 0


def test_profile_step_on_cpu(capsys):
    assert cli.main(["profile", "step", "--place", "cpu", "--d-model", "32",
                     "--layers", "1", "--seq", "8", "--batch", "2",
                     "--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "device_wait" in out and "train.mfu=" in out


# ---------------------------------------------------------------------------
# trace readers
# ---------------------------------------------------------------------------

def _kernel(name, ts, dur, corr, stream=7):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": stream, "args": {"correlation": corr}}


def _synthetic_trace():
    """Two host threads launching kernels on two streams: op ranges
    nest on thread 1; the kernels overlap across streams."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "ptop_matmul__h",
         "ts": 0, "dur": 10, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "ptop_softmax__p",
         "ts": 10, "dur": 10, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "ptop_while__o",
         "ts": 20, "dur": 30, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "ptop_scale__s",
         "ts": 25, "dur": 5, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 1, "dur": 1, "pid": 1, "tid": 1, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 11, "dur": 1, "pid": 1, "tid": 1,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 26, "dur": 1, "pid": 1, "tid": 1,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel",
         "ts": 40, "dur": 1, "pid": 1, "tid": 1,
         "args": {"correlation": 4}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 12, "dur": 1, "pid": 1, "tid": 2,
         "args": {"correlation": 5}},
        _kernel("gemm_kernel", 100, 50, 1),
        _kernel("bias_softmax_warp_kernel", 150, 20, 2),
        _kernel("scale_kernel", 160, 30, 3, stream=8),    # overlaps
        _kernel("reduce_kernel", 300, 10, 4),
        _kernel("bias_softmax_grad_kernel", 400, 5, 5),   # no range
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 305,
         "dur": 10, "pid": 0, "tid": 7, "args": {"correlation": 9}},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "ptop_matmul__h",
         "ts": 100, "dur": 50, "pid": 0, "tid": 7},
    ]
    return {"traceEvents": ev}


def test_device_busy_seconds_is_the_union(tmp_path):
    trace = _synthetic_trace()
    # [100, 190] (three kernels, one overlapping), [300, 315], [400, 405]
    assert profiler.device_busy_seconds(trace) == pytest.approx(110e-6)
    path = tmp_path / "t" / "trace.json"
    path.parent.mkdir()
    path.write_text(json.dumps(trace))
    assert profiler.device_busy_seconds(str(path.parent)) == \
        pytest.approx(110e-6)
    plain_sum = sum(d for _, d in profiler.iter_trace_events(
        trace, device_only=True)) / 1e12
    assert plain_sum == pytest.approx(125e-6)
    assert plain_sum > profiler.device_busy_seconds(trace)


def test_scope_device_seconds_and_op_table():
    trace = _synthetic_trace()
    assert profiler.scope_device_seconds(trace, "bias_softmax") == \
        pytest.approx(25e-6)
    # a kernel is also found by the op range it is charged to
    assert profiler.scope_device_seconds(trace, "ptop_softmax") == \
        pytest.approx(20e-6)
    table, rows = profiler.compiled_op_table(trace)
    got = {t: (n, pytest.approx(s)) for t, n, s in rows}
    # the innermost open range wins; a launch after its range closed
    # falls back to the enclosing one; a thread without ranges: none
    assert got == {"matmul": (1, 50e-6), "softmax": (1, 20e-6),
                   "scale": (1, 30e-6), "while": (1, 10e-6)}
    assert rows[0][0] == "matmul" and "softmax" in table
    assert [r[0] for r in profiler.compiled_op_table(
        trace, "calls")[1]][:1]


def test_op_scope_names_round_trip():
    main, _, _ = _build_fc_train(size=4)
    for op in main.global_block().ops:
        name = profiler.op_scope_name(op)
        assert "." not in name and "/" not in name
        assert profiler.parse_op_scope("outer/" + name)[0] == op.type
    assert profiler.parse_op_scope("no_scope_here") is None


def test_compiled_profiler_runs_the_eager_step_with_op_ranges(tmp_path,
                                                              capsys):
    """On the CPU: a trace with one ``ptop_`` range per op of the step
    (no device events, so an empty table and zero device seconds), and
    the step a signature of its own."""
    main, startup, loss = _build_fc_train(size=44)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    feed = {"x": np.ones((2, 4), np.float32)}
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    plain = set(exe._cache)
    d = str(tmp_path / "prof")
    with profiler.compiled_profiler(trace_dir=d) as got:
        assert got == d and profiler.op_ranges_enabled()
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert not profiler.op_ranges_enabled()
    (sig,) = [k for k in exe._cache if k not in plain]
    assert sig[-1] == ("op_ranges",) and exe._cache[sig].interpret
    events = json.load(open(f"{d}/trace.json"))["traceEvents"]
    ranges = [e["name"] for e in events
              if str(e.get("name", "")).startswith("ptop_")]
    assert len(ranges) == len(main.global_block().ops)
    assert "Event" in capsys.readouterr().out
    assert profiler.measure_device_seconds(
        lambda: exe.run(main, feed=feed, fetch_list=[loss],
                        scope=scope)) == 0.0
