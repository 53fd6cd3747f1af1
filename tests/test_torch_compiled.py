"""The executor's compiled path on the CPU, held against the JAX
package's: ``_prepare``'s state partitions, the step cache's hit, miss
and eviction counts (``PADDLE_TPU_JIT_CACHE_SIZE``), the host-op cliff
warning, the op-level profiling table and ``compile_zoo_step``, on the
same programs (built by the JAX package and carried over with
``to_dict`` / ``from_dict``) and the same run sequences.  Then the
capture rule: one step of every zoo model and the generation prefill and
decode, with every host read, host-to-device copy, host-generator draw
and data-dependent shape recorded under the op being lowered; each such op must keep its block eager, and the blocks
the port runs as CUDA graphs on the card must have none.  (The graphs
themselves run only on the card: ``tests/test_torch_cuda.py -k graph``.)
"""

import re
import warnings

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as jfluid
import paddle_tpu_torch as pt
from paddle_tpu import executor as jexecutor
from paddle_tpu import layers as jlayers
from paddle_tpu import profiler as jprofiler
from paddle_tpu.models import ZOO_MODELS
from paddle_tpu.models import build_train_program as jax_build
from paddle_tpu.models import compile_zoo_step as jax_compile_zoo_step
from paddle_tpu_torch import executor, profiler
from paddle_tpu_torch.models import build_train_program as port_build
from paddle_tpu_torch.models import compile_zoo_step, gen_lm, synth_feed
from paddle_tpu_torch.ops import registry, tensor_ops

CPU = pt.CPUPlace()


def _to_port(*programs):
    return [pt.Program.from_dict(p.to_dict()) for p in programs]


def _counts(metrics):
    return (metrics.counter("jit_cache.hits"),
            metrics.counter("jit_cache.misses"),
            metrics.counter("jit_cache.evictions"))


# ---------------------------------------------------------------------------
# the programs: built by the JAX package
# ---------------------------------------------------------------------------

def _mlp_sgd():
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup):
        x = jlayers.data(name="cx", shape=[4])
        y = jlayers.data(name="cy", shape=[1])
        h = jlayers.fc(x, size=8, act="relu")
        cost = jlayers.mean(jlayers.square_error_cost(jlayers.fc(h, 1), y))
        jfluid.optimizer.SGD(0.1).minimize(cost)
    feed = {"cx": np.ones((2, 4), np.float32),
            "cy": np.ones((2, 1), np.float32)}
    return main, startup, feed, [cost.name]


def _transformer_adam():
    main, startup, feeds, fetches = jax_build("transformer")
    return main, startup, synth_feed(*_to_port(main), feeds), fetches


def _fetch_param_and_feed():
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup):
        x = jlayers.data(name="px", shape=[4])
        out = jlayers.fc(x, size=3)
    w = main.global_block().all_parameters()[0].name
    return main, startup, {"px": np.ones((2, 4), np.float32)}, \
        [out.name, w, "px"]


def _write_only_persistable():
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup):
        x = jlayers.data(name="wx", shape=[4])
        g = jlayers.create_global_var(shape=[1], value=0.0, dtype="float32",
                                      persistable=True, name="w_only")
        jlayers.assign(jlayers.reduce_sum(x), output=g)
        out = jlayers.scale(x, scale=2.0)
    return main, startup, {"wx": np.ones((2, 4), np.float32)}, [out.name]


PROGRAMS = {"mlp_sgd": _mlp_sgd, "transformer_adam": _transformer_adam,
            "fetch_param_and_feed": _fetch_param_and_feed,
            "write_only_persistable": _write_only_persistable}


def _prepare_both(jmain, feed, fetches):
    (tmain,) = _to_port(jmain)
    jexe, texe = jfluid.Executor(), pt.Executor(CPU)
    want = jexe._prepare(jmain, jmain.global_block(), feed, tuple(fetches),
                         jfluid.Scope())
    got = texe._prepare(tmain, tmain.global_block(),
                        {n: torch.from_numpy(np.asarray(a))
                         for n, a in feed.items()},
                        tuple(fetches), pt.Scope())
    return want, got


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_prepare_partitions_match_the_reference(name):
    jmain, _, feed, fetches = PROGRAMS[name]()
    want, got = _prepare_both(jmain, feed, fetches)
    for key in ("feed_names", "ro_names", "inout_names", "create_state",
                "param_names", "interpret"):
        assert got[key] == want[key], key
    if name == "write_only_persistable":
        assert got["create_state"] == ("w_only",)
    if name == "fetch_param_and_feed":
        assert got["ro_names"] and not got["inout_names"]
    if name in ("mlp_sgd", "transformer_adam"):
        assert got["param_names"]


def test_persistable_names_match_the_reference():
    jmain, _, _, _ = _transformer_adam()
    (tmain,) = _to_port(jmain)
    assert executor._persistable_names(tmain) == \
        jexecutor._persistable_names(jmain)


# ---------------------------------------------------------------------------
# the step cache: hits, misses, evictions, capacity
# ---------------------------------------------------------------------------

def _sequence(exe, fluid, main, startup, scope, metrics, out_name, x_name):
    """startup; feeds [2,4], [2,4], [3,4], [2,4]; a fetch-list change;
    bump_version: the counters after each run."""
    seen = [_counts(metrics)]
    exe.run(startup, scope=scope)
    seen.append(_counts(metrics))
    for rows in (2, 2, 3, 2):
        exe.run(main, feed={x_name: np.ones((rows, 4), np.float32)},
                fetch_list=[out_name], scope=scope)
        seen.append(_counts(metrics))
    exe.run(main, feed={x_name: np.ones((2, 4), np.float32)},
            fetch_list=[out_name, x_name], scope=scope)
    seen.append(_counts(metrics))
    main.bump_version()
    exe.run(main, feed={x_name: np.ones((2, 4), np.float32)},
            fetch_list=[out_name], scope=scope)
    seen.append(_counts(metrics))
    return [tuple(b - a for a, b in zip(seen[0], s)) for s in seen[1:]]


def _scale_programs():
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup):
        x = jlayers.data(name="sx", shape=[4])
        out = jlayers.fc(x, size=2)
    return main, startup, out.name


@pytest.mark.parametrize("capacity", [None, "2"])
def test_cache_counters_move_like_the_reference(capacity, monkeypatch):
    if capacity is None:
        monkeypatch.delenv("PADDLE_TPU_JIT_CACHE_SIZE", raising=False)
    else:
        monkeypatch.setenv("PADDLE_TPU_JIT_CACHE_SIZE", capacity)
    jmain, jstartup, out = _scale_programs()
    tmain, tstartup = _to_port(jmain, jstartup)
    want = _sequence(jfluid.Executor(), jfluid, jmain, jstartup,
                     jfluid.Scope(), jprofiler.runtime_metrics, out, "sx")
    got = _sequence(pt.Executor(CPU), pt, tmain, tstartup, pt.Scope(),
                    profiler.runtime_metrics, out, "sx")
    assert got == want
    # hits, misses: startup miss; miss, hit, miss, hit; fetch change
    # miss; bump_version miss
    assert [(h, m) for h, m, _ in got] == [
        (0, 1), (0, 2), (1, 2), (1, 3), (2, 3), (2, 4), (2, 5)]
    if capacity:
        assert got[-1][2] > 0


def test_capacity_env_and_eviction_counter(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_JIT_CACHE_SIZE", "2")
    exe = pt.Executor(CPU)
    assert exe._cache_capacity == 2
    jmain, _, out = _scale_programs()
    main = pt.Program.from_dict(jmain.to_dict())
    scope = pt.Scope()
    for n in main.global_block().all_parameters():
        scope.set_var(n.name, torch.zeros(n.shape))
    ev0 = profiler.runtime_metrics.counter("jit_cache.evictions")
    for rows in (1, 2, 3, 4):  # 4 distinct signatures, capacity 2
        exe.run(main, feed={"sx": np.ones((rows, 4), "float32")},
                fetch_list=[out], scope=scope)
    assert len(exe._cache) <= 2
    assert profiler.runtime_metrics.counter(
        "jit_cache.evictions") >= ev0 + 2


def test_capacity_default_and_bad_values(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_JIT_CACHE_SIZE", raising=False)
    assert executor.jit_cache_capacity() == 64
    monkeypatch.setenv("PADDLE_TPU_JIT_CACHE_SIZE", "not-a-number")
    assert executor.jit_cache_capacity() == 64
    monkeypatch.setenv("PADDLE_TPU_JIT_CACHE_SIZE", "0")
    assert executor.jit_cache_capacity() == 1  # clamped
    for raw in ("not-a-number", "0", "-3", "5"):
        monkeypatch.setenv("PADDLE_TPU_JIT_CACHE_SIZE", raw)
        assert executor.jit_cache_capacity() == \
            jexecutor.jit_cache_capacity()


# ---------------------------------------------------------------------------
# the host-op cliff warning
# ---------------------------------------------------------------------------

def _host_op_program():
    """``sequence_erase`` (a host op of both packages) at the top level
    and ``sequence_slice`` inside a StaticRNN's step block."""
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup):
        ids = jlayers.data(name="hid", shape=[1], dtype="int64",
                           lod_level=1)
        jlayers.sequence_erase(ids, tokens=[2])
        seq = jlayers.data(name="hseq", shape=[3, 2], dtype="float32")
        off = jlayers.data(name="hoff", shape=[1], dtype="int64")
        rnn = jlayers.StaticRNN()
        with rnn.step():
            step = rnn.step_input(seq)
            mem = rnn.memory(shape=[2], batch_ref=step)
            jlayers.sequence_slice(step, off, off)
            nxt = jlayers.elementwise_add(step, mem)
            rnn.update_memory(mem, nxt)
            rnn.step_output(nxt)
        rnn()
    return main


def _culprits(caught):
    found = []
    for w in caught:
        m = re.search(r"host op\(s\) (\[.*?\])", str(w.message))
        if m:
            found.append(eval(m.group(1)))  # a printed list of str
    return found


def test_cliff_warning_names_the_same_culprits_once():
    jmain = _host_op_program()
    (tmain,) = _to_port(jmain)
    seen = {}
    for name, exe, prog, scope in (
            ("jax", jfluid.Executor(), jmain, jfluid.Scope()),
            ("port", pt.Executor(CPU), tmain, pt.Scope())):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(2):
                parts = exe._prepare(prog, prog.global_block(), {},
                                     ("hseq",), scope)
        seen[name] = _culprits(caught)
        assert parts["interpret"]
    assert len(seen["port"]) == 1
    assert seen["port"] == seen["jax"] == \
        [["sequence_erase", "sequence_slice"]]


# ---------------------------------------------------------------------------
# op profiling
# ---------------------------------------------------------------------------

def _table_rows(text):
    lines = text.splitlines()
    rows = {}
    for line in lines[1:]:
        parts = line.split()
        rows[parts[0]] = int(parts[1])
    return lines[0], rows


def test_op_profile_table_matches_the_reference():
    jmain, jstartup, feed, fetches = _mlp_sgd()
    tmain, tstartup = _to_port(jmain, jstartup)
    tables = []
    for fluid, prof, main, startup, exe, scope in (
            (jfluid, jprofiler, jmain, jstartup, jfluid.Executor(),
             jfluid.Scope()),
            (pt, profiler, tmain, tstartup, pt.Executor(CPU), pt.Scope())):
        exe.run(startup, scope=scope)
        prof.enable_op_profiling()
        try:
            for _ in range(2):
                exe.run(main, feed=feed, fetch_list=fetches, scope=scope)
        finally:
            prof.disable_op_profiling()
        tables.append(_table_rows(prof.op_profile_table("calls")))
        prof.reset_profiler()
    (jhead, jrows), (thead, trows) = tables
    assert thead == jhead
    assert trows == jrows
    assert trows["mul"] == 4 and trows["sgd"] == 8


def test_op_profiling_enters_the_signature_and_forces_eager():
    jmain, jstartup, feed, fetches = _mlp_sgd()
    main, startup = _to_port(jmain, jstartup)
    exe, scope = pt.Executor(CPU), pt.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=feed, fetch_list=fetches, scope=scope)
    plain = exe._last_compiled
    assert not plain.interpret
    m0 = profiler.runtime_metrics.counter("jit_cache.misses")
    with profiler.op_profiler():
        exe.run(main, feed=feed, fetch_list=fetches, scope=scope)
    profiled = exe._last_compiled
    assert profiled is not plain and profiled.interpret
    assert profiler.runtime_metrics.counter("jit_cache.misses") == m0 + 1
    exe.run(main, feed=feed, fetch_list=fetches, scope=scope)
    assert exe._last_compiled is plain
    profiler.reset_profiler()


def test_opt_interpret_keeps_the_block_eager():
    jmain, jstartup, feed, fetches = _mlp_sgd()
    main, startup = _to_port(jmain, jstartup)
    main._opt_interpret = True
    exe, scope = pt.Executor(CPU), pt.Scope()
    exe.run(startup, scope=scope)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no cliff warning for this
        exe.run(main, feed=feed, fetch_list=fetches, scope=scope)
    assert exe._last_compiled.interpret


# ---------------------------------------------------------------------------
# compile_zoo_step
# ---------------------------------------------------------------------------

def _outcome(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — compared across packages
        return type(e).__name__, str(e)
    return "ok"


@pytest.mark.parametrize("name", ZOO_MODELS)
def test_compile_zoo_step_like_the_reference(name):
    """Every zoo model the port runs on the CPU runs one synthetic step;
    the two that neither package runs on synthetic dense feeds (an
    ``lstm`` wants a LoD) fail alike."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = _outcome(lambda: compile_zoo_step(name, place=CPU))
        if name in ("seq2seq", "stacked_lstm"):
            assert got[0] == "ValueError"
            assert got == _outcome(lambda: jax_compile_zoo_step(name))
        else:
            assert got == "ok"


# ---------------------------------------------------------------------------
# the capture rule
# ---------------------------------------------------------------------------

#: aten ops that read the device on the host, copy host data to it or
#: make a shape from the data: each a sync (or a refusal) under a capture
_SYNCING = {"_local_scalar_dense", "is_nonzero", "equal", "nonzero",
            "masked_select", "_unique", "_unique2", "unique_dim",
            "unique_consecutive", "lift_fresh", "lift_fresh_copy"}
#: random aten ops: under a capture only a registered generator may draw
_RANDOM = {"rand", "randn", "randint", "bernoulli", "normal", "uniform",
           "normal_", "uniform_", "multinomial", "randperm", "rand_like",
           "randn_like", "randint_like", "exponential", "bernoulli_"}


#: the ops being lowered, innermost last (``lowering`` fixture)
_LOWERING = []


def _lowering_op():
    return _LOWERING[-1] if _LOWERING else None


class _Tracked:
    """An OpDef whose lowering keeps its op on ``_LOWERING``."""

    def __init__(self, opdef):
        self.opdef = opdef

    def lower(self, ctx):
        _LOWERING.append(ctx.op)
        try:
            return self.opdef.lower(ctx)
        finally:
            _LOWERING.pop()


class _Audit(TorchDispatchMode):
    """Records ``(op being lowered, what)`` for every aten call a CUDA
    graph could not replay as it ran."""

    def __init__(self, events):
        super().__init__()
        self.events = events

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        op = _lowering_op()
        if op is not None:
            name = func.__name__.split(".")[0]
            if name in _SYNCING:
                self.events.append((op.type, name))
            elif name in _RANDOM and kwargs.get("generator") is None:
                self.events.append((op.type, f"{name} (default generator)"))
            elif name in ("index", "index_put", "index_put_") and any(
                    isinstance(i, torch.Tensor) and i.dtype == torch.bool
                    for i in (args[1] if len(args) > 1 else ())):
                self.events.append((op.type, f"{name} by a mask"))
            elif name == "repeat_interleave" and \
                    kwargs.get("output_size") is None and \
                    isinstance(args[0] if args else None, torch.Tensor) and \
                    len(args) > 1 and isinstance(args[1], torch.Tensor):
                self.events.append((op.type, name))
        return func(*args, **kwargs)


@pytest.fixture
def recorded(monkeypatch):
    """Patch the host reads and the host generator to record the op
    being lowered (every lowering tracked through
    ``registry.resolve_lowering``), beside the aten audit."""
    events = []
    resolve = registry.resolve_lowering
    monkeypatch.setattr(registry, "resolve_lowering",
                        lambda op_type: _Tracked(resolve(op_type)))

    def note(what):
        op = _lowering_op()
        events.append((op.type if op is not None else None, what))

    host_scalar = registry.host_scalar

    def patched_host_scalar(aux, tensor):
        note("host_scalar")
        return host_scalar(aux, tensor)

    host_generator = tensor_ops._host_generator

    def patched_host_generator(ctx):
        note("host generator")
        return host_generator(ctx)

    monkeypatch.setattr(registry, "host_scalar", patched_host_scalar)
    monkeypatch.setattr(tensor_ops, "_host_generator", patched_host_generator)
    import paddle_tpu_torch.ops.control_flow_ops as cf
    monkeypatch.setattr(cf, "host_scalar", patched_host_scalar)
    return events


#: the zoo models whose train step runs as a CUDA graph on the card (with
#: the gen-LM prefill and decode and the ``/predict`` MLP); the others
#: stay eager: a static LoD's tables are copied from the host (the LSTM,
#: the seq2seq; both graph under the buckets,
#: ``tests/test_torch_lod_buckets.py``)
GRAPHED = {"mnist", "resnet", "vgg", "transformer", "gen_lm", "gen_lm_long",
           "wide_and_deep"}
EAGER = {"seq2seq", "stacked_lstm"}


def _ragged(main, feeds, rng):
    """One step's feed: a LoD of two sequences for ragged variables,
    integers 0 or 1 (a valid id and label of every zoo model)."""
    block = main.global_block()
    names = feeds if feeds is not None else [
        v.name for v in block.vars.values() if getattr(v, "is_data", False)]
    lod = [[0, 3, 5]]
    out = {}
    for n in names:
        v = block.var(n)
        shape = [2 if d is None or d < 0 else d for d in (v.shape or (2,))]
        if getattr(v, "lod_level", 0):
            shape[0] = lod[0][-1]
        a = (rng.randint(0, 2, size=shape).astype(str(v.dtype))
             if str(v.dtype).startswith("int")
             else rng.standard_normal(shape).astype(np.float32))
        out[n] = (a, lod) if getattr(v, "lod_level", 0) else a
    return out


def _audited_run(exe, events, **kw):
    start = len(events)
    with _Audit(events):
        exe.run(**kw)
    return events[start:], exe._last_compiled


@pytest.mark.parametrize("name", ZOO_MODELS)
def test_capture_rule_covers_every_host_action(name, recorded):
    assert GRAPHED | EAGER == set(ZOO_MODELS)
    main, startup, feeds, fetches = port_build(name)
    exe, scope = pt.Executor(CPU), pt.Scope()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got, entry = _audited_run(exe, recorded, program=startup,
                                  scope=scope)
        # random init draws on the host: the startup program stays eager
        assert any(w == "host generator" for _, w in got)
        assert entry.interpret
        # the second step is what a capture sees (the first made the
        # block's constants)
        for seed in (0, 1):
            got, entry = _audited_run(
                exe, recorded, program=main, scope=scope,
                fetch_list=fetches,
                feed=_ragged(main, feeds, np.random.RandomState(seed)))
    if got:
        assert entry.interpret, got
    assert entry.interpret == (name in EAGER), sorted(set(got))
    if name in EAGER:
        assert got  # the rule is not idle: these blocks do host work


def test_capture_rule_gen_prefill_and_decode(tmp_path, recorded):
    d = str(tmp_path / "gen")
    gen_lm.export_gen_model(d, gen_lm.GenConfig(), num_slots=2, place=CPU,
                            seed=0)
    from paddle_tpu_torch.gen import GenPredictor
    pred = GenPredictor(d, place=CPU)
    _, kv = pred.prefill([1, 2, 3])
    pred.alloc_slot_pages(0, pred.pages_needed(3, 2))
    pred.write_slot(0, kv, 3)
    pred.decode_step([4, 0], [3, 0], lens=[4, 0])
    del recorded[:]
    with _Audit(recorded):     # the second run of each: what a capture sees
        pred.prefill([5, 6, 7])
        assert not pred._exe._last_compiled.interpret
        pred.decode_step([4, 0], [4, 0], lens=[5, 0])
        assert not pred._exe._last_compiled.interpret
    assert not recorded


_OPTIMIZERS = {
    "Momentum": lambda O, L: O.Momentum(0.01, momentum=0.9),
    "Adagrad": lambda O, L: O.Adagrad(0.01),
    "Adamax": lambda O, L: O.Adamax(0.01),
    "DecayedAdagrad": lambda O, L: O.DecayedAdagrad(0.01),
    "Adadelta": lambda O, L: O.Adadelta(0.01),
    "RMSProp": lambda O, L: O.RMSProp(0.01, momentum=0.5),
    "Ftrl": lambda O, L: O.Ftrl(0.01, l1=0.01, l2=0.01),
    "Momentum(noam_decay)": lambda O, L: O.Momentum(L.noam_decay(64, 4),
                                                    momentum=0.9),
    "SGD + ModelAverage": lambda O, L: O.SGD(0.01),
}


@pytest.mark.parametrize("name", sorted(_OPTIMIZERS))
def test_capture_rule_optimizers(name, recorded):
    """Every optimizer's update ops (and an LR schedule, ModelAverage)
    may be captured: nothing host-side in a step."""
    O, L = pt.optimizer, pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = L.data(name="ox", shape=[8, 4], dtype="float32",
                   append_batch_size=False)
        loss = L.mean(L.fc(L.fc(x, 8, act="relu"), 1) ** 2)
        _OPTIMIZERS[name](O, L).minimize(loss)
        if "ModelAverage" in name:
            O.ModelAverage(max_average_window=2)
    exe, scope = pt.Executor(CPU), pt.Scope()
    exe.run(startup, scope=scope)
    feed = {"ox": np.random.RandomState(0).randn(8, 4).astype("float32")}
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    got, entry = _audited_run(exe, recorded, program=main, scope=scope,
                              feed=feed, fetch_list=[loss])
    assert not got and not entry.interpret
