"""The port's training sentinel (``paddle_tpu_torch.fault.sentinel``)
against the JAX package's, the cases of ``tests/test_sentinel.py``:
detection (culprits, integers, cadence, the EMA spike and its warm-up,
strikes, phantom promotion, the ``PADDLE_TPU_SENTINEL`` grammar) run
through both sentinels alike; skip-step inside ``Executor.run`` (the
scope bit-equal after a trip, the sparse rows of Wide & Deep too);
the structural guarantee of an unguarded step, by counting; the ladder
drill (skip, quarantine, rollback, resume) as an explicit loop in both
packages from one state; quarantine bundles replayed and localized
across the packages; and the ``replay`` and ``ckpt`` commands' exit
codes.

Tolerances: a package's drill equals its own clean run bit for bit
(the rollback restores the state's bytes); the two packages' losses
agree to ``LOSS_RTOL`` (float32 sums in other orders)."""

import os
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import cli as ref_cli
from paddle_tpu import profiler as ref_profiler
from paddle_tpu.fault import CheckpointManager as RefManager
from paddle_tpu.fault import NumericalFault as RefFault
from paddle_tpu.fault import Sentinel as RefSentinel
from paddle_tpu.fault import chaos as ref_chaos
from paddle_tpu.fault import replay_bundle as ref_replay
from paddle_tpu.obs import numerics as ref_numerics
from paddle_tpu_torch import cli
from paddle_tpu_torch.convert import to_numpy
from paddle_tpu_torch.fault import (CheckpointManager, NumericalFault,
                                    Sentinel, chaos, replay_bundle,
                                    sentinel_from_env)
from paddle_tpu_torch.fault import sentinel as sentinel_mod
from paddle_tpu_torch.obs import numerics
from paddle_tpu_torch.profiler import runtime_metrics

LOSS_RTOL = 1e-5
STEPS = 10
SAVE_STEPS = (2, 4)
COUNTERS = ("sentinel.skipped_steps", "sentinel.quarantined",
            "sentinel.rollbacks")


@pytest.fixture(autouse=True)
def _clean_failpoints():
    chaos.clear()
    ref_chaos.clear()
    yield
    chaos.clear()
    ref_chaos.clear()


def build_model(pkg, seed=11, lr=0.05):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    # the same names every time, in both packages
    with pkg.framework.unique_name_scope("sd_"), \
            pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[6], dtype="float32")
        y = pkg.layers.data("y", shape=[1], dtype="float32")
        pred = pkg.layers.fc(x, 1, param_attr="w", bias_attr="b")
        loss = pkg.layers.reduce_mean(pkg.layers.square_error_cost(pred, y))
        pkg.optimizer.Momentum(learning_rate=lr, momentum=0.9) \
            .minimize(loss)
    return main, startup, loss


def _feed(step):
    rng = np.random.RandomState(step)
    xs = rng.rand(8, 6).astype("float32")
    return {"x": xs, "y": xs.sum(1, keepdims=True).astype("float32")}


def _state(scope):
    return {n: to_numpy(v) for n, v in scope.items()
            if isinstance(v, torch.Tensor)}


def _port_model():
    main, startup, loss = build_model(pt)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    return main, loss, exe, scope


# ---------------------------------------------------------------------------
# detection, both sentinels alike
# ---------------------------------------------------------------------------

def _both():
    """A port and a reference sentinel of the same settings."""
    def make(**kw):
        return Sentinel(**kw), RefSentinel(**kw)
    return make


def _trip(sentinel, fault_cls, *args):
    try:
        sentinel.after_step(*args)
    except fault_cls as f:
        return f
    return None


def test_non_finite_state_trips_and_names_culprits_as_reference():
    port, ref = _both()(cadence=1, strikes=99, spike_factor=None)
    bad = {"w": np.array([1.0, np.nan], "float32"),
           "b": np.ones(2, "float32"), "n": np.arange(3)}
    got = _trip(port, NumericalFault, ["loss"], [np.float32(1.0)], bad)
    want = _trip(ref, RefFault, ["loss"], [np.float32(1.0)], bad)
    assert got.reason == want.reason == "non_finite"
    assert got.bad == want.bad == ["w"]
    # a CUDA-less tensor value trips the same
    got = _trip(Sentinel(cadence=1, spike_factor=None), NumericalFault,
                ["loss"], [torch.tensor(1.0)],
                {"w": torch.tensor([1.0, float("inf")])})
    assert got.bad == ["w"]


def test_non_finite_loss_trips_both():
    port, ref = _both()(cadence=1, strikes=99, spike_factor=None)
    assert _trip(port, NumericalFault, ["loss"], [np.float32(np.inf)], {})
    assert _trip(ref, RefFault, ["loss"], [np.float32(np.inf)], {})


def test_integer_state_never_trips():
    for s in _both()(cadence=1, strikes=99, spike_factor=None):
        _, state = s.after_step(["step"], [np.int64(3)],
                                {"count": np.arange(4)})
        assert state["count"].shape == (4,)
    s = Sentinel(cadence=1, spike_factor=None)
    s.after_step(["step"], [torch.tensor(3)],
                 {"count": torch.arange(4)})


def test_cadence_skips_off_steps_as_reference():
    port, ref = _both()(cadence=3, strikes=99, spike_factor=None)
    bad = {"w": np.array([np.nan], "float32")}
    for tick in (1, 2):
        assert _trip(port, NumericalFault, [], [], bad) is None
        assert _trip(ref, RefFault, [], [], bad) is None
    assert _trip(port, NumericalFault, [], [], bad).step == 3
    assert _trip(ref, RefFault, [], [], bad).step == 3


def test_ema_spike_detector_as_reference():
    port, ref = _both()(cadence=1, strikes=99, spike_factor=3.0,
                        spike_warmup=3)
    for v in (1.0, 1.1, 0.9, 1.0):
        port.after_step(["loss"], [np.float32(v)], {})
        ref.after_step(["loss"], [np.float32(v)], {})
    assert port._ema == pytest.approx(ref._ema, rel=1e-6)
    got = _trip(port, NumericalFault, ["loss"], [np.float32(50.0)], {})
    want = _trip(ref, RefFault, ["loss"], [np.float32(50.0)], {})
    assert got.reason == want.reason == "loss_spike"


def test_spike_detector_warms_up_first():
    for s in _both()(cadence=1, strikes=99, spike_factor=3.0,
                     spike_warmup=5):
        # huge swings inside the warm-up window must not trip
        for v in (1.0, 99.0, 0.01):
            s.after_step(["loss"], [np.float32(v)], {})


def test_clean_check_resets_strikes(tmp_path):
    for s, fault in zip(_both()(cadence=1, strikes=2, spike_factor=None,
                                quarantine_dir=str(tmp_path)),
                        (NumericalFault, RefFault)):
        assert s.handle_fault(fault("x", reason="non_finite"),
                              step=1) is None
        assert s._strikes == 1
        s.after_step([], [], {"w": np.ones(2, "float32")})  # clean
        assert s._strikes == 0


def test_phantom_promotion_keeps_rollback_budget():
    """``mark_good`` returning None (the checkpoint rotated away before
    its promotion) is no forward progress: the budget does not refill."""
    class Mgr:
        dirname = "."

        def mark_good(self, step):
            return None

    for cls in (Sentinel, RefSentinel):
        s = cls(manager=Mgr())
        s._rollbacks = 2
        s._promote(5)
        assert s._rollbacks == 2


def test_sentinel_from_env_grammar(monkeypatch):
    from paddle_tpu.fault import sentinel_from_env as ref_from_env
    monkeypatch.setenv("PADDLE_TPU_SENTINEL", "0")
    assert sentinel_from_env() is None and ref_from_env() is None
    monkeypatch.setenv("PADDLE_TPU_SENTINEL", "1")
    assert isinstance(sentinel_from_env(), Sentinel)
    spec = ("cadence=4;strikes=2,spike=off;good_after=3;ema=0.5;warmup=7;"
            "max_rollbacks=1;loss=l;quarantine=q")
    monkeypatch.setenv("PADDLE_TPU_SENTINEL", spec)
    keys = ("cadence", "strikes", "spike_factor", "mark_good_after",
            "ema_beta", "spike_warmup", "max_rollbacks", "loss_name",
            "quarantine_dir")
    got, want = sentinel_from_env(), ref_from_env()
    assert [getattr(got, k) for k in keys] == \
        [getattr(want, k) for k in keys]
    assert (got.cadence, got.strikes, got.spike_factor,
            got.mark_good_after) == (4, 2, None, 3)
    monkeypatch.setenv("PADDLE_TPU_SENTINEL", "bogus=1")
    with pytest.raises(ValueError):
        sentinel_from_env()


def test_health_digest_matches_reference():
    """The fused norms of one guarded update, in both sentinels."""
    rng = np.random.RandomState(3)
    old = {"w": rng.randn(6, 4).astype("float32"),
           "b": rng.randn(4).astype("float32")}
    new = {n: v - 0.1 * rng.randn(*v.shape).astype("float32")
           for n, v in old.items()}
    port, ref = _both()(cadence=1, spike_factor=None)
    port.after_step(["loss"], [np.float32(1.0)], new, prev_state=old,
                    param_names=("w", "b"))
    ref.after_step(["loss"], [np.float32(1.0)], new, prev_state=old,
                   param_names=("w", "b"))
    for k, v in ref.last_health.items():
        assert port.last_health[k] == pytest.approx(v, rel=1e-5), k
    for g in ("train.param_norm", "train.grad_norm", "train.update_ratio"):
        assert runtime_metrics.gauge(g) == pytest.approx(
            ref_profiler.runtime_metrics.gauge(g), rel=1e-5)


# ---------------------------------------------------------------------------
# skip-step inside Executor.run
# ---------------------------------------------------------------------------

def test_tripped_step_leaves_the_scope_bit_equal():
    main, loss, exe, scope = _port_model()
    s = Sentinel(cadence=1, strikes=99, spike_factor=None)
    exe.run(main, feed=_feed(1), fetch_list=[loss], scope=scope, sentinel=s)
    before = _state(scope)
    chaos.inject("sentinel.nan", times=1)
    with pytest.raises(NumericalFault) as ei:
        exe.run(main, feed=_feed(2), fetch_list=[loss], scope=scope,
                sentinel=s)
    assert ei.value.injected and ei.value.health is not None
    after = _state(scope)
    assert set(after) == set(before)
    for n in before:
        np.testing.assert_array_equal(after[n], before[n], err_msg=n)
    # and the guard recovers: the next clean step trains normally
    chaos.clear("sentinel.nan")
    exe.run(main, feed=_feed(3), fetch_list=[loss], scope=scope, sentinel=s)
    assert not np.array_equal(after["w"], to_numpy(scope.find_var("w")))


def test_real_fault_names_the_parameter():
    """An inf parameter: the trip names it (and what it poisoned), and
    the scope holds the pre-step state."""
    main, loss, exe, scope = _port_model()
    w = scope.find_var("w")
    w[0, 0] = float("inf")
    before = _state(scope)
    s = Sentinel(cadence=1, spike_factor=None)
    with pytest.raises(NumericalFault) as ei:
        exe.run(main, feed=_feed(1), fetch_list=[loss], scope=scope,
                sentinel=s)
    assert not ei.value.injected and "w" in ei.value.bad
    assert ei.value.repro["state"]["w"][0, 0] == np.inf
    for n, v in _state(scope).items():
        np.testing.assert_array_equal(v, before[n], err_msg=n)


def test_injection_defers_to_the_next_checked_step():
    for s, fault in ((Sentinel(cadence=2, strikes=99, spike_factor=None),
                      NumericalFault),
                     (RefSentinel(cadence=2, strikes=99, spike_factor=None),
                      RefFault)):
        for c in (chaos, ref_chaos):
            c.inject("sentinel.nan", times=1)
        state = {"w": np.ones(3, "float32")}
        _, out = s.after_step(["loss"], [np.float32(1.0)], state)
        assert np.isfinite(np.asarray(out["w"])).all()
        with pytest.raises(fault) as ei:
            s.after_step(["loss"], [np.float32(1.0)], state)
        assert ei.value.injected and ei.value.step == 2
        chaos.clear()
        ref_chaos.clear()


def test_unguarded_step_is_structurally_free(monkeypatch):
    """``sentinel=None``: the plain signature (no extra component), no
    check, no sentinel code and no host read; a guarded step is a cache
    entry of its own and reads the device exactly once."""
    main, loss, exe, scope = _port_model()
    seen = []
    orig = Sentinel.after_step

    def spy(self, *a, **k):
        seen.append(1)
        return orig(self, *a, **k)

    reads = []
    for name in ("item", "tolist"):
        real = getattr(torch.Tensor, name)

        def counted(self, *a, _real=real, **k):
            reads.append(1)
            return _real(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, counted)
    monkeypatch.setattr(Sentinel, "after_step", spy)
    block = main.global_block()
    exe.run(main, feed=_feed(1), fetch_list=[loss], scope=scope)
    assert not seen and not reads
    (sig,) = [k for k in exe._cache if k[0] == id(main)]
    feeds = {n: torch.as_tensor(v) for n, v in _feed(1).items()}
    assert sig == exe._signature(main, block, feeds, (loss.name,), scope)
    # the reference's components (the early-release flag among them) and
    # check_nan_inf: no guard component
    assert len(sig) == 11 and sig[-1] is False
    assert exe._step_check(exe._cache[sig], main, feeds, scope,
                           None) is None
    s = Sentinel(cadence=1, strikes=99, spike_factor=None)
    exe.run(main, feed=_feed(2), fetch_list=[loss], scope=scope, sentinel=s)
    assert seen and len(reads) == 1
    guarded = [k for k in exe._cache if k[0] == id(main) and k != sig]
    assert len(guarded) == 1 and guarded[0][-1] == ("guarded",)
    assert guarded[0][:-1] == sig
    reads.clear()
    exe.run(main, feed=_feed(3), fetch_list=[loss], scope=scope)
    assert not reads and len(seen) == 1


def _sparse_program(pkg, opt):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with pkg.framework.unique_name_scope("sp_"), \
            pkg.program_guard(main, startup):
        from paddle_tpu_torch.models import wide_and_deep as TW
        from paddle_tpu.models import wide_and_deep as JW
        model = TW if pkg is pt else JW
        cost, _, _ = model.wide_and_deep_train_program(
            8, vocab_size=64, num_slots=4, emb_dim=4, hidden=8)
        {"sgd": lambda: pkg.optimizer.SGD(learning_rate=0.1),
         "adam": lambda: pkg.optimizer.Adam(learning_rate=0.1),
         "adagrad": lambda: pkg.optimizer.Adagrad(learning_rate=0.1)}[
            opt]().minimize(cost)
    return main, startup, cost


def _wd_feed(seed):
    rng = np.random.RandomState(seed)
    return {"slot_ids": rng.randint(0, 12, (8, 4, 1)).astype("int64"),
            "dense": rng.rand(8, 8).astype("float32"),
            "label": rng.randint(0, 2, (8, 1)).astype("int64")}


@pytest.mark.parametrize("opt", ["sgd", "adam", "adagrad"])
def test_skip_step_puts_back_sparse_rows(opt):
    """Wide & Deep's sparse branches write their rows in place; a tripped
    guarded step puts them back: every tensor of the scope bit-equal, as
    the JAX package's functional update leaves it.  The next clean step
    equals an unguarded step from the same state."""
    main, startup, cost = _sparse_program(pt, opt)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    s = Sentinel(cadence=1, strikes=99, spike_factor=None)
    exe.run(main, feed=_wd_feed(0), fetch_list=[cost], scope=scope,
            sentinel=s)
    before = _state(scope)
    chaos.inject("sentinel.nan", times=1)
    with pytest.raises(NumericalFault):
        exe.run(main, feed=_wd_feed(1), fetch_list=[cost], scope=scope,
                sentinel=s)
    after = _state(scope)
    for n in before:
        np.testing.assert_array_equal(after[n], before[n], err_msg=n)
    # the tables did take in-place rows in that step (the undo mattered)
    got, = exe.run(main, feed=_wd_feed(1), fetch_list=[cost], scope=scope,
                   sentinel=s)
    twin = pt.Scope()
    for n, v in before.items():
        twin.set_var(n, torch.from_numpy(v.copy()))
    want, = pt.Executor(pt.CPUPlace()).run(
        main, feed=_wd_feed(1), fetch_list=[cost], scope=twin)
    np.testing.assert_array_equal(got, want)
    for n, v in _state(twin).items():
        np.testing.assert_array_equal(to_numpy(scope.find_var(n)), v,
                                      err_msg=n)


def test_sparse_skip_step_matches_reference():
    """The JAX package's skip-step on the same W&D state: both scopes
    keep the pre-step state (the reference's update is functional)."""
    main, startup, cost = _sparse_program(pt, "adam")
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    state = _state(scope)
    ref_main = fluid.Program.from_dict(main.to_dict())
    ref_scope = fluid.Scope()
    for n, v in state.items():
        ref_scope.set_var(n, v)
    for c in (chaos, ref_chaos):
        c.inject("sentinel.nan", times=1)
    with pytest.raises(NumericalFault) as got:
        exe.run(main, feed=_wd_feed(1), fetch_list=[cost], scope=scope,
                sentinel=Sentinel(cadence=1, spike_factor=None))
    with pytest.raises(RefFault) as want:
        fluid.Executor(fluid.CPUPlace()).run(
            ref_main, feed=_wd_feed(1), fetch_list=[cost.name],
            scope=ref_scope,
            sentinel=RefSentinel(cadence=1, spike_factor=None))
    assert sorted(got.value.bad) == sorted(want.value.bad)
    for n, v in state.items():
        np.testing.assert_array_equal(to_numpy(scope.find_var(n)), v)
        np.testing.assert_array_equal(np.asarray(ref_scope.find_var(n)), v)


# ---------------------------------------------------------------------------
# the ladder drill, both packages, one state
# ---------------------------------------------------------------------------

def _drill(pkg, root, state, inject):
    """``STEPS`` steps from ``state``: with ``inject``, a sentinel
    (strikes 2) and ``sentinel.nan`` at the 5th and 6th checks, saves
    after ``SAVE_STEPS``, and on a rollback the loop resumes after the
    restored step.  Returns ``(losses by applied step, manager,
    sentinel, counter deltas and the rollbacks' ``(restored step,
    last_good_step())``)``."""
    port = pkg is pt
    main, startup, loss = build_model(pkg)
    if port:
        exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
        for n, v in state.items():
            scope.set_var(n, torch.from_numpy(v.copy()))
        mgr_cls, sent_cls, fault_cls, c, m = (
            CheckpointManager, Sentinel, NumericalFault, chaos,
            runtime_metrics)
    else:
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        for n, v in state.items():
            scope.set_var(n, v)
        mgr_cls, sent_cls, fault_cls, c, m = (
            RefManager, RefSentinel, RefFault, ref_chaos,
            ref_profiler.runtime_metrics)
    before = {n: m.counter(n) for n in COUNTERS}
    mgr = sentinel = None
    if inject:
        mgr = mgr_cls(str(root), keep=4, executor=exe, main_program=main,
                      scope=scope)
        sentinel = sent_cls(manager=mgr, cadence=1, strikes=2,
                            mark_good_after=1)
        c.inject("sentinel.nan", after=4, times=2)
    losses, step, rollbacks = {}, 0, []
    while step < STEPS:
        step += 1
        try:
            out, = exe.run(main, feed=_feed(step), fetch_list=[loss.name],
                           scope=scope, sentinel=sentinel)
        except fault_cls as fault:
            restored = sentinel.handle_fault(fault, step=step)
            if restored is not None:
                rollbacks.append((restored, mgr.last_good_step()))
                step = restored
                losses = {k: v for k, v in losses.items() if k <= step}
            continue
        losses[step] = float(np.asarray(out).reshape(-1)[0])
        if inject and step in SAVE_STEPS:
            mgr.save(step)
            sentinel.note_checkpoint(step)
    c.clear("sentinel.nan")
    delta = {n: m.counter(n) - before[n] for n in COUNTERS}
    delta["rollback_targets"] = rollbacks
    return [losses[k] for k in sorted(losses)], mgr, sentinel, delta


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    """A clean run and a drill in each package, from one startup state
    (the expensive part, shared by the assertions below)."""
    root = tmp_path_factory.mktemp("ladder")
    main, loss, exe, scope = _port_model()
    state = _state(scope)
    chaos.clear()
    ref_chaos.clear()
    out = {}
    for pkg, tag in ((pt, "port"), (fluid, "ref")):
        clean = _drill(pkg, root / f"{tag}_clean", state, inject=False)[0]
        losses, mgr, sentinel, delta = _drill(pkg, root / tag, state,
                                              inject=True)
        out[tag] = {"clean": clean, "losses": losses, "mgr": mgr,
                    "sentinel": sentinel, "delta": delta}
    return out


def _bundles(sentinel):
    d = sentinel.quarantine_dir
    return [os.path.join(d, n) for n in sorted(os.listdir(d))]


def test_drill_skips_quarantines_rolls_back_and_resumes(drill):
    for tag in ("port", "ref"):
        d = drill[tag]
        assert d["delta"] == {"sentinel.skipped_steps": 2,
                              "sentinel.quarantined": 2,
                              "sentinel.rollbacks": 1,
                              # step 2 was the newest promoted known-good
                              # (step 4's promotion was voided by the
                              # strikes); the resumed run promotes 4 again
                              "rollback_targets": [(2, 2)]}, tag
        assert len(_bundles(d["sentinel"])) == 2
        assert d["mgr"].last_good_step() == 4
        assert len(d["losses"]) == STEPS
    # every batch applied once: the port's drill IS its clean run
    assert drill["port"]["losses"] == drill["port"]["clean"]
    np.testing.assert_allclose(drill["port"]["losses"],
                               drill["ref"]["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(drill["ref"]["losses"],
                               drill["ref"]["clean"], rtol=LOSS_RTOL)


def test_bundle_carries_payload_and_health(drill):
    sentinel = drill["port"]["sentinel"]
    assert set(sentinel.last_health) == {"param_norm", "grad_norm",
                                         "update_ratio"}
    with open(_bundles(sentinel)[0], "rb") as f:
        bundle = pickle.load(f)
    assert bundle["reason"] == "non_finite" and bundle["injected"]
    assert bundle["repro"]["feed"] and bundle["repro"]["state"]
    assert "param_norm" in bundle["health"]

    def plain(v):
        # numpy arrays and plain Python values only: no tensor
        if isinstance(v, dict):
            return all(plain(x) for x in v.values())
        if isinstance(v, (list, tuple)):
            return all(plain(x) for x in v)
        return isinstance(v, (np.ndarray, np.generic, str, int, float,
                              bool, type(None)))
    assert plain(bundle)
    ref_keys = set(pickle.load(open(_bundles(drill["ref"]["sentinel"])[0],
                                    "rb")))
    assert set(bundle) == ref_keys
    # the port's payload adds the device whose generators drew the step
    assert bundle["repro"]["rng_device"] == "cpu"
    assert set(bundle["repro"]) == set(pickle.load(open(
        _bundles(drill["ref"]["sentinel"])[0], "rb"))["repro"]) | \
        {"rng_device"}


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_bundles_replay_alike_in_both_packages(drill, writer):
    """A bundle either package wrote replays in both with the same
    verdict, reason and culprits, and localizes to the same op."""
    path = _bundles(drill[writer]["sentinel"])[0]
    got = replay_bundle(path)
    want = ref_replay(path)
    assert got["reproduced"] and want["reproduced"]
    assert (got["reason"], got["injected"]) == \
        (want["reason"], want["injected"])
    assert sorted(got["bad"]) == sorted(want["bad"])
    loc = numerics.localize_bundle(path)
    ref_loc = ref_numerics.localize_bundle(path)
    assert loc["localized"] and ref_loc["localized"]
    fb, rb = loc["first_bad_op"], ref_loc["first_bad_op"]
    assert (fb["type"], fb["index"]) == (rb["type"], rb["index"]) == \
        ("reduce_mean", rb["index"])
    assert fb["creation_site"] == rb["creation_site"]
    assert fb["creation_site"][0].endswith("test_torch_sentinel.py")
    assert loc["ops_probed"] == ref_loc["ops_probed"]
    assert all(s.get("finite_frac") == 1.0 for s in fb["inputs"].values())


def test_replay_cli_exit_codes(drill, tmp_path, capsys):
    path = _bundles(drill["port"]["sentinel"])[0]
    assert cli.main(["replay", path]) == 0
    assert "REPRODUCED" in capsys.readouterr().out
    assert cli.main(["replay", "--json", path]) == 0
    assert cli.main(["replay", "--localize", path]) == 0
    out = capsys.readouterr().out
    assert "reduce_mean" in out and "test_torch_sentinel.py" in out
    assert cli.main(["replay", "--localize", "--json", path]) == 0
    with open(path, "rb") as f:
        bundle = pickle.load(f)
    bundle["injected"] = False   # pretend the NaN came from the card
    clean = str(tmp_path / "clean.pkl")
    with open(clean, "wb") as f:
        pickle.dump(bundle, f, protocol=4)
    assert cli.main(["replay", clean]) == 1
    assert cli.main(["replay", "--localize", clean]) == 1
    assert ref_cli.main(["replay", clean]) == 1
    garbage = tmp_path / "garbage.pkl"
    garbage.write_bytes(b"\x80\x04not a pickle")
    for extra in ([], ["--localize"]):
        assert cli.main(["replay", *extra, str(garbage)]) == 2
        assert cli.main(["replay", *extra,
                         str(tmp_path / "missing.pkl")]) == 2
    # a bundle whose step cannot re-execute is unreplayable (2), never
    # "replayed clean" (1)
    feed = dict(bundle["repro"]["feed"], x=np.zeros((4, 3), "float32"))
    bundle["repro"] = dict(bundle["repro"], feed=feed)
    skewed = str(tmp_path / "skewed.pkl")
    with open(skewed, "wb") as f:
        pickle.dump(bundle, f, protocol=4)
    assert cli.main(["replay", skewed]) == 2
    assert ref_cli.main(["replay", skewed]) == 2
    bundle.pop("repro")
    bare = str(tmp_path / "bare.pkl")
    with open(bare, "wb") as f:
        pickle.dump(bundle, f, protocol=4)
    assert cli.main(["replay", bare]) == 2


def test_replay_preserves_live_armed_failpoint(drill):
    path = _bundles(drill["port"]["sentinel"])[0]
    chaos.inject("sentinel.nan", after=100, times=3)   # a live drill
    assert replay_bundle(path)["reproduced"]
    fp = chaos.swap("sentinel.nan", None)
    assert fp is not None and fp.after == 100 and fp.times == 3


def test_replay_does_not_count_as_a_fault(drill):
    path = _bundles(drill["port"]["sentinel"])[0]
    before = {n: runtime_metrics.counter(n) for n in COUNTERS}
    replay_bundle(path)
    assert {n: runtime_metrics.counter(n) for n in COUNTERS} == before


def test_loss_spike_bundle_replays(tmp_path):
    main, loss, exe, scope = _port_model()
    s = Sentinel(cadence=1, strikes=99, spike_factor=0.5, spike_warmup=1,
                 quarantine_dir=str(tmp_path))
    # a baseline far below any real loss: the first step spikes
    s._ema, s._ema_n = 1e-6, 5
    with pytest.raises(NumericalFault) as ei:
        exe.run(main, feed=_feed(1), fetch_list=[loss], scope=scope,
                sentinel=s)
    assert ei.value.reason == "loss_spike"
    path = s.quarantine(ei.value)
    report = replay_bundle(path)
    assert report["reproduced"] and report["reason"] == "loss_spike"
    assert ref_replay(path)["reason"] == "loss_spike"
    assert cli.main(["replay", path]) == 0


def _dropout_model():
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 5
    with pt.framework.unique_name_scope("dr_"), \
            pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=[6], dtype="float32")
        y = pt.layers.data("y", shape=[1], dtype="float32")
        h = pt.layers.dropout(pt.layers.fc(x, 16), dropout_prob=0.5)
        pred = pt.layers.fc(h, 1)
        loss = pt.layers.reduce_mean(pt.layers.square_error_cost(pred, y))
        pt.optimizer.Momentum(learning_rate=0.05, momentum=0.9) \
            .minimize(loss)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    return main, exe, scope, [h.name, loss.name]


def test_dropout_step_replays_its_masks_on_the_same_device(tmp_path):
    """A step recorded on the CPU replays on the CPU with the recorded
    step's dropout masks, bit for bit."""
    main, exe, scope, fetch = _dropout_model()
    want = exe.run(main, feed=_feed(1), fetch_list=fetch, scope=scope)
    main, exe, scope, fetch = _dropout_model()
    s = Sentinel(cadence=1, strikes=99, spike_factor=None,
                 quarantine_dir=str(tmp_path))
    chaos.inject("sentinel.nan", times=1)
    with pytest.raises(NumericalFault) as ei:
        exe.run(main, feed=_feed(1), fetch_list=fetch, scope=scope,
                sentinel=s)
    path = s.quarantine(ei.value)
    bundle = pickle.load(open(path, "rb"))
    replay_exe, program, rscope, feed, _ = \
        sentinel_mod.rebuild_repro(path, bundle)
    got = replay_exe.run(program, feed=feed, fetch_list=fetch, scope=rscope)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[0] == 0).any()   # the masks dropped something
    # another run counter draws other masks: the rewind is what matches
    replay_exe, program, rscope, feed, _ = \
        sentinel_mod.rebuild_repro(path, bundle)
    replay_exe._run_counter += 1
    other = replay_exe.run(program, feed=feed, fetch_list=fetch[:1],
                           scope=rscope)[0]
    assert not np.array_equal(other, want[0])
    report = replay_bundle(path)
    assert report["reproduced"] and report["rng_device"] == "cpu"
    assert not report["rng_device_mismatch"]


@pytest.mark.parametrize("recorded", ["cuda", None])
def test_random_draws_off_the_cpu_give_no_clean_verdict(tmp_path, recorded):
    """A clean replay of a step that drew dropout masks on a card's
    generators (or the JAX package's, which records no device) says
    nothing of that step: the CLI exits 2, not 1.  The same bundle
    recorded on the CPU replays clean (1)."""
    main, exe, scope, fetch = _dropout_model()
    s = Sentinel(cadence=1, strikes=99, spike_factor=None,
                 quarantine_dir=str(tmp_path))
    chaos.inject("sentinel.nan", times=1)
    with pytest.raises(NumericalFault) as ei:
        exe.run(main, feed=_feed(1), fetch_list=fetch, scope=scope,
                sentinel=s)
    bundle = pickle.load(open(s.quarantine(ei.value), "rb"))
    bundle["injected"] = False   # pretend the NaN came from the device
    paths = {}
    for tag, device in (("cpu", "cpu"), ("off", recorded)):
        repro = dict(bundle["repro"], rng_device=device)
        if device is None:
            repro.pop("rng_device")
        paths[tag] = str(tmp_path / f"{tag}.pkl")
        with open(paths[tag], "wb") as f:
            pickle.dump(dict(bundle, repro=repro), f, protocol=4)
    report = replay_bundle(paths["off"])
    assert not report["reproduced"] and report["rng_device_mismatch"]
    assert report["rng_device"] == recorded
    assert numerics.localize_bundle(paths["off"])["rng_device_mismatch"]
    for extra in ([], ["--localize"]):
        assert cli.main(["replay", *extra, paths["off"]]) == 2
        assert cli.main(["replay", *extra, paths["cpu"]]) == 1
    # a program that draws nothing replays clean from any device
    assert sentinel_mod.random_ops(main) == ["dropout"]
    assert sentinel_mod.random_ops(build_model(pt)[0]) == []


def test_unrecoverable_without_manager_reraises(tmp_path):
    s = Sentinel(manager=None, cadence=1, strikes=1, spike_factor=None,
                 quarantine_dir=str(tmp_path))
    with pytest.raises(NumericalFault):
        s.handle_fault(NumericalFault("x", reason="non_finite"), step=3)
    assert any(n.startswith("quarantine-step3")
               for n in os.listdir(str(tmp_path)))


# ---------------------------------------------------------------------------
# the ckpt command
# ---------------------------------------------------------------------------

def test_ckpt_inspect_and_verify_exit_codes(drill, tmp_path, capsys):
    import shutil
    from paddle_tpu_torch.cli import _ckpt_report
    d = str(tmp_path / "ck")
    shutil.copytree(drill["port"]["mgr"].dirname, d)
    assert cli.main(["ckpt", "inspect", d]) == 0
    assert cli.main(["ckpt", "verify", d]) == 0
    out = capsys.readouterr().out
    assert "ckpt verify: PASS" in out and "last_good: 4" in out
    assert cli.main(["ckpt", "verify", d, "--json"]) == 0
    # the port's survey is the reference's, read for read
    assert _ckpt_report(d, deep=True) == ref_cli._ckpt_report(d, deep=True)
    assert cli.main(["ckpt", "verify", d, "--step", "99"]) == 1
    from conftest import corrupt_largest_file
    corrupt_largest_file(os.path.join(d, "ckpt-4"))
    assert cli.main(["ckpt", "verify", d]) == 1
    assert cli.main(["ckpt", "verify", d, "--step", "2"]) == 0
    assert cli.main(["ckpt", "inspect", str(tmp_path / "none")]) == 2
