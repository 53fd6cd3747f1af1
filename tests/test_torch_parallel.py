"""The port's ParallelExecutor, ZeRO, tensor parallelism and ring
attention on gloo worlds of spawned CPU ranks, against the JAX package
(mirrors of ``tests/test_parallel.py`` and
``tests/test_multiprocess_dp.py``).

The JAX package runs in this process (one device, or the 8 virtual
devices of ``tests/conftest.py``); the port runs in the ranks of one
4-rank world (``torch_worlds.run_world``, a module fixture running every
case) and, for the launcher, a 2-rank world of ``python -m
paddle_tpu_torch launch``.  Programs cross as ``Program.to_dict()``,
state as numpy arrays (``convert.scope_from_numpy``), all at dropout 0:
each rank draws its own dropout masks, so a split batch's masks are not a
single device's.

Tolerances: data parallelism rtol 2e-5 (the batch is summed in another
order); ZeRO rtol 5e-5 (the optimizer update runs on each rank's slice of
a reduce-scattered gradient); the tensor-parallel Transformer rtol 5e-4
(the JAX package's own bound for its GSPMD run against one device: the
split matmuls and the softmax over a split vocabulary sum in other
orders, over two Adam steps); ring attention 1e-5 absolute (float32
online softmax against the direct one).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu.layers as layers
from paddle_tpu.framework import unique_name_scope

import torch_worlds
from paddle_tpu_torch import Program as TorchProgram
from paddle_tpu_torch.convert import persistable_names

WORLD = 4
DP_TOL = 2e-5
ZERO_TOL = 5e-5
TP_TOL = 5e-4
RING_TOL = 1e-5
OPTIMIZERS = {
    "sgd": lambda o: o.SGD(learning_rate=0.1),
    "momentum": lambda o: o.Momentum(learning_rate=0.05, momentum=0.9),
    "adagrad": lambda o: o.Adagrad(learning_rate=0.05),
    "adam": lambda o: o.Adam(learning_rate=0.01),
    "adamax": lambda o: o.Adamax(learning_rate=0.01),
    "decayed_adagrad": lambda o: o.DecayedAdagrad(learning_rate=0.05),
    "adadelta": lambda o: o.Adadelta(learning_rate=1.0),
    "rmsprop": lambda o: o.RMSProp(learning_rate=0.01),
    "ftrl": lambda o: o.Ftrl(learning_rate=0.05),
}


def _cross_entropy_grad_once(mp):
    """The reference's ``cross_entropy_grad`` doubles ``dX`` (ROADMAP
    queue 3, "In the reference"; the port counts the cotangent once):
    run its auto-vjp with the ``Out`` slot left out, as
    ``tests/test_torch_conv.py``'s fixture does, so the packages' SGD
    steps can be compared."""
    import copy
    from paddle_tpu.ops import registry as fluid_registry
    auto = fluid_registry.auto_vjp_grad_lower("cross_entropy")

    def once(ctx):
        op = copy.copy(ctx.op)
        op.inputs = {s: v for s, v in ctx.op.inputs.items()
                     if s not in ("Out", "Out@GRAD")}
        saved, ctx.op = ctx.op, op
        try:
            auto(ctx)
        finally:
            ctx.op = saved

    mp.setitem(fluid_registry._REGISTRY, "cross_entropy_grad",
               fluid_registry.OpDef("cross_entropy_grad", lower=once))


def _state(main, startup):
    """Run the JAX startup program: the state every persistable of
    ``main`` starts from, as numpy."""
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    names = persistable_names(TorchProgram.from_dict(main.to_dict()))
    return scope, {n: np.array(np.asarray(scope.find_var(n)))
                   for n in names}


def _jax_steps(main, scope, feeds, fetch):
    """The JAX package's steps, run when called (the fixture starts the
    port's world first)."""
    def run():
        exe = fluid.Executor(fluid.CPUPlace())
        return [[np.asarray(x) for x in exe.run(
            main, feed=f, fetch_list=fetch, scope=scope)] for f in feeds]
    return run


def _mlp(opt, batch=16, hidden=64, classes=8, prefix="pm"):
    main, startup = fluid.Program(), fluid.Program()
    with unique_name_scope(prefix), fluid.program_guard(main, startup):
        x = layers.data(name="img", shape=[batch, 32],
                        append_batch_size=False)
        y = layers.data(name="label", shape=[batch, 1], dtype="int64",
                        append_batch_size=False)
        h = layers.fc(input=x, size=hidden, act="relu")
        pred = layers.fc(input=h, size=classes, act="softmax")
        loss = layers.mean(layers.cross_entropy(input=pred, label=y))
        OPTIMIZERS[opt](fluid.optimizer).minimize(loss)
    return main, startup, loss


def _mlp_feed(batch=16, classes=8, seed=0):
    rng = np.random.RandomState(seed)
    return {"img": rng.rand(batch, 32).astype("float32"),
            "label": rng.randint(0, classes, (batch, 1)).astype("int64")}


def _tp_hp():
    from paddle_tpu.models import transformer as T
    hp = T.ModelHyperParams()
    hp.d_model, hp.d_inner_hid, hp.n_layer = 32, 64, 2
    hp.n_head, hp.d_key, hp.d_value = 4, 8, 8
    hp.src_vocab_size = hp.trg_vocab_size = 64
    hp.max_length = 16
    hp.dropout = 0.0
    return hp


def _ring_program(shape, causal, grads):
    main, startup = fluid.Program(), fluid.Program()
    with unique_name_scope("ro"), fluid.program_guard(main, startup):
        q, k, v = (layers.data(name=n, shape=list(shape),
                               append_batch_size=False)
                   for n in ("q", "k", "v"))
        for var in (q, k, v):
            var.stop_gradient = not grads
        out = layers.ring_attention(q, k, v, causal=causal)
        if grads:
            loss = layers.reduce_mean(out)
            fluid.append_backward(loss, parameter_list=[])
    return main, out


def _ring_inputs(shape, seed):
    rng = np.random.RandomState(seed)
    return {n: rng.rand(*shape).astype("float32") for n in ("q", "k", "v")}


def _cases():
    """Every port case (run in one world) and what to hold it against."""
    from paddle_tpu.models import build_train_program
    from paddle_tpu.models import transformer as JT
    from paddle_tpu_torch.models import transformer as TT
    cases, refs = [], []

    # data parallelism on dp4, SGD; the other ranks start from other
    # weights until the first step's broadcast
    main, startup, loss = _mlp("sgd", classes=10, prefix="dp")
    scope, state = _state(main, startup)
    feeds = [_mlp_feed(classes=10)] * 3
    refs.append(("dp", _jax_steps(main, scope, feeds, [loss.name])))
    cases.append({"program": main.to_dict(), "state": state,
                  "feeds": feeds, "fetch": [loss.name],
                  "mesh": ((WORLD,), ("data",)), "rank_state": True})

    # tensor parallelism: the Transformer on (2, 2) data x model
    hp = _tp_hp()
    main, startup = fluid.Program(), fluid.Program()
    with unique_name_scope("tp"), fluid.program_guard(main, startup):
        cost, _ = JT.transformer(8, 8, 8, hp)
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(cost)
    scope, state = _state(main, startup)
    feeds = [JT.fake_batch(8, 8, 8, hp)] * 2
    refs.append(("tp", _jax_steps(main, scope, feeds, [cost.name])))
    cases.append({"program": main.to_dict(), "state": state,
                  "feeds": feeds, "fetch": [cost.name],
                  "mesh": ((2, 2), ("data", "model")),
                  "shardings": TT.tp_shardings()})

    # ZeRO for every optimizer of OPTIMIZER_STATE_SLOTS, dp4
    for opt in OPTIMIZERS:
        main, startup, loss = _mlp(opt, prefix=f"z{opt}")
        scope, state = _state(main, startup)
        feeds = [_mlp_feed()] * 3
        refs.append((f"zero-{opt}", _jax_steps(main, scope, feeds,
                                               [loss.name])))
        cases.append({"program": main.to_dict(), "state": state,
                      "feeds": feeds, "fetch": [loss.name],
                      "mesh": ((WORLD,), ("data",)), "zero": True})

    # ZeRO on the mnist zoo model (conv + fc, Adam)
    with unique_name_scope("zm"):
        main, startup, _, fetches = build_train_program("mnist")
    scope, state = _state(main, startup)
    rng = np.random.RandomState(3)
    feeds = [{"pixel": rng.rand(8, 1, 28, 28).astype("float32"),
              "label": rng.randint(0, 10, (8, 1)).astype("int64")}] * 2
    refs.append(("zero-mnist", _jax_steps(main, scope, feeds,
                                          [fetches[0]])))
    cases.append({"program": main.to_dict(), "state": state,
                  "feeds": feeds, "fetch": [fetches[0]],
                  "mesh": ((WORLD,), ("data",)), "zero": True})

    # user rules keep precedence over ZeRO: no step run
    main, startup = fluid.Program(), fluid.Program()
    with unique_name_scope("sk"), fluid.program_guard(main, startup):
        x = layers.data(name="img", shape=[16, 32], append_batch_size=False)
        y = layers.data(name="label", shape=[16, 1], dtype="int64",
                        append_batch_size=False)
        pred = layers.fc(input=x, size=8, act="softmax", param_attr="tp_w")
        loss = layers.mean(layers.cross_entropy(input=pred, label=y))
        fluid.optimizer.Momentum(learning_rate=0.05,
                                 momentum=0.9).minimize(loss)
    _, state = _state(main, startup)
    refs.append(("skip", lambda: None))
    cases.append({"program": main.to_dict(), "state": state, "feeds": [],
                  "fetch": [loss.name], "mesh": ((2, 2), ("data", "model")),
                  "zero": True, "shardings": [(r"tp_w", (None, "model"))]})

    # run_pipeline drives a ParallelExecutor
    main, startup, loss = _mlp("sgd", batch=8, classes=10, prefix="rp")
    _, state = _state(main, startup)
    rng = np.random.RandomState(0)
    rows = [{"img": rng.rand(32).astype("float32"),
             "label": rng.randint(0, 10, (1,)).astype("int64")}
            for _ in range(16)]
    refs.append(("pipeline", lambda: None))
    cases.append({"program": main.to_dict(), "state": state,
                  "fetch": [loss.name], "mesh": ((WORLD,), ("data",)),
                  "pipeline": True, "rows": rows, "batch": 8})

    # the ring_attention op: forward on (2, 2) data x seq, grads on
    # (1, 4); the JAX package's op on one device is plain attention
    for causal in (False, True):
        main, out = _ring_program((2, 2, 16, 4), causal, grads=False)
        feed = _ring_inputs((2, 2, 16, 4), seed=0)
        refs.append((f"ring-op-{causal}",
                     _jax_steps(main, fluid.Scope(), [feed], [out.name])))
        cases.append({"program": main.to_dict(), "state": {},
                      "feeds": [feed], "fetch": [out.name],
                      "mesh": ((2, 2), ("data", "seq"))})
    main, out = _ring_program((2, 2, 16, 4), True, grads=True)
    feed = _ring_inputs((2, 2, 16, 4), seed=3)
    fetch = ["q@GRAD", "k@GRAD", "v@GRAD"]
    refs.append(("ring-op-grads",
                 _jax_steps(main, fluid.Scope(), [feed], fetch)))
    cases.append({"program": main.to_dict(), "state": {}, "feeds": [feed],
                  "fetch": fetch, "mesh": ((1, 4), ("data", "seq"))})
    return cases, refs


def _ring_fn_cases():
    import jax
    import jax.numpy as jnp
    from paddle_tpu.ops.attention_ops import _reference_attention
    cases, refs = [], []
    for causal in (False, True):
        rng = np.random.RandomState(7 + causal)
        q, k, v, cot = (rng.randn(2, 2, 32, 8).astype("float32") * 0.5
                        for _ in range(4))
        out, vjp = jax.vjp(lambda a, b, c: _reference_attention(
            a, b, c, None, causal, 8 ** -0.5), jnp.asarray(q),
            jnp.asarray(k), jnp.asarray(v))
        grads = vjp(jnp.asarray(cot))
        cases.append({"q": q, "k": k, "v": v, "cot": cot, "causal": causal})
        refs.append(tuple(np.asarray(t) for t in (out, *grads)))
    return cases, refs


@pytest.fixture(scope="module")
def world_results(tmp_path_factory):
    """One 4-rank world runs every port case while this process runs
    the JAX package's."""
    send, result = torch_worlds.spawn_world(
        torch_worlds.multi, WORLD, tmp_path_factory.mktemp("pworld"))
    with pytest.MonkeyPatch.context() as mp:
        _cross_entropy_grad_once(mp)
        cases, refs = _cases()
        ring_cases, ring_refs = _ring_fn_cases()
        send([("train_cases", cases), ("ring_cases", ring_cases)])
        refs = [(name, ref()) for name, ref in refs]
    got, ring_got = result()
    return ({name: (ref, g, c) for (name, ref), g, c in
             zip(refs, got, cases)}, list(zip(ring_refs, ring_got)))


def _losses(fetches):
    return np.array([float(np.asarray(f[0]).reshape(())) for f in fetches])


def test_dp4_matches_single_device_after_the_broadcast(world_results):
    ref, got, _ = world_results[0]["dp"]
    np.testing.assert_allclose(_losses(got["fetches"]), _losses(ref),
                               rtol=DP_TOL, atol=1e-6)
    # ranks 1-3 started from other weights: one broadcast a state var
    assert got["broadcasts"]["calls"] >= 5


def test_tp_transformer_matches_replicated_losses(world_results):
    ref, got, _ = world_results[0]["tp"]
    # no collective op is written into the user's program
    assert got["program_unchanged"]
    np.testing.assert_allclose(_losses(got["fetches"]), _losses(ref),
                               rtol=TP_TOL, atol=1e-5)


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_zero_matches_unsharded(world_results, opt):
    from paddle_tpu_torch.parallel.zero import OPTIMIZER_STATE_SLOTS
    ref, got, _ = world_results[0][f"zero-{opt}"]
    np.testing.assert_allclose(_losses(got["fetches"]), _losses(ref),
                               rtol=ZERO_TOL, atol=1e-6)
    # every accumulator of the optimizer's slots is split over dp4 and
    # rank 0 holds a quarter of its leading dim
    assert bool(got["placements"]) == bool(OPTIMIZER_STATE_SLOTS[opt])
    for name, spec in got["placements"].items():
        assert spec[0] == "data", name
        assert got["local_shapes"][name][0] * WORLD == \
            got["state"][name].shape[0], name


def test_zero_on_the_mnist_zoo_model(world_results):
    """Also the max pool's grad on DTensors split over the batch (its
    scatter runs out of place, which DTensor takes)."""
    ref, got, _ = world_results[0]["zero-mnist"]
    assert got["placements"]
    np.testing.assert_allclose(_losses(got["fetches"]), _losses(ref),
                               rtol=ZERO_TOL, atol=1e-6)


def test_zero_skips_user_ruled_state(world_results):
    _, got, _ = world_results[0]["skip"]
    assert all("tp_w" not in n for n in got["placements"]), \
        got["placements"]
    assert any("tp_w" in n for n in got["skipped"])


def test_run_pipeline_drives_parallel_executor(world_results):
    _, got, _ = world_results[0]["pipeline"]
    assert len(got["fetches"]) == 2
    assert all(np.isfinite(np.asarray(f[0])).all() for f in got["fetches"])


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_op_on_a_seq_mesh(world_results, causal):
    ref, got, _ = world_results[0][f"ring-op-{causal}"]
    np.testing.assert_allclose(got["fetches"][0][0], ref[0][0],
                               rtol=0, atol=RING_TOL)


def test_ring_attention_op_grads_through_the_ring(world_results):
    ref, got, _ = world_results[0]["ring-op-grads"]
    for g, r in zip(got["fetches"][0], ref[0]):
        assert np.abs(g).sum() > 0
        np.testing.assert_allclose(g, r, rtol=0, atol=RING_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_forward_and_grads(world_results, causal):
    """The ring over a 4-rank ``seq`` axis against the JAX package's
    ``_reference_attention`` and its vjp."""
    ref, got = world_results[1][int(causal)]
    for name, g, r in zip(("out", "dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=RING_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_op_without_a_mesh_is_plain_attention(causal):
    """Outside ``ParallelExecutor`` (no mesh) the op is the unfused
    attention in both packages, forward and grads."""
    import paddle_tpu_torch as pt
    main, out = _ring_program((2, 2, 16, 4), causal, grads=True)
    feed = _ring_inputs((2, 2, 16, 4), seed=5)
    fetch = [out.name, "q@GRAD", "k@GRAD", "v@GRAD"]
    want = _jax_steps(main, fluid.Scope(), [feed], fetch)()[0]
    got = pt.Executor(pt.CPUPlace()).run(
        TorchProgram.from_dict(main.to_dict()), feed=feed, fetch_list=fetch,
        scope=pt.Scope())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=RING_TOL)


def test_inconsistent_state_plan_is_pta016():
    """An inconsistent optimizer-state plan (moment1 split, moment2
    replicated) is a static PTA016 error in both packages, and the port's
    ZeRO plan refuses it when corrupted by hand."""
    from paddle_tpu.analysis.distributed import check_sharding as jcheck
    from paddle_tpu_torch.analysis import ProgramVerificationError
    from paddle_tpu_torch.analysis.distributed import check_sharding
    from paddle_tpu_torch.parallel.zero import zero_plan
    main, _, _ = _mlp("adam", prefix="ic")
    tmain = TorchProgram.from_dict(main.to_dict())
    m1 = next(n for n in tmain.global_block().vars
              if "moment1" in n and ".w_" in n)
    m2 = m1.replace("moment1", "moment2")
    placements = {m1: ("data", None), m2: ()}
    diags = check_sharding(tmain, placements, mesh_axes={"data": 4})
    jdiags = jcheck(main, placements, mesh_axes={"data": 4})
    assert [(d.code, d.message) for d in diags] == \
        [(d.code, d.message) for d in jdiags]
    assert any(d.code == "PTA016" and "inconsistently sharded" in d.message
               for d in diags)

    class Mesh:     # zero_plan reads the axes' names and sizes only
        mesh_dim_names, shape = ("data",), (4,)

    plan = zero_plan(tmain, Mesh())
    assert plan.placements and not plan.verify()
    plan.placements[m2] = ()
    with pytest.raises(ProgramVerificationError):
        plan.verify()


def test_zero_plan_equals_the_reference_plan():
    """The port's plan of a program is the JAX package's, rule for rule."""
    from paddle_tpu.parallel.mesh import make_mesh
    from paddle_tpu.parallel.zero import zero_plan as jplan
    from paddle_tpu_torch.parallel.zero import zero_plan
    main, _, _ = _mlp("adam", prefix="zp")
    tmain = TorchProgram.from_dict(main.to_dict())

    class Mesh:
        mesh_dim_names, shape = ("data",), (4,)

    import jax
    want = jplan(main, make_mesh((4,), ("data",),
                                 devices=jax.devices()[:4]))
    got = zero_plan(tmain, Mesh())
    assert got.placements == want.placements
    assert got.skipped == want.skipped
    assert [(p, tuple(s)) for p, s in got.rules()] == \
        [(p, tuple(s)) for p, s in want.rules()]


_LAUNCHED = '''
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import paddle_tpu_torch as pt
from paddle_tpu_torch import parallel
from paddle_tpu_torch.convert import scope_from_numpy
store, case_path, out = sys.argv[1:4]
# launch exports the reference's env convention; the rendezvous goes
# through a file, so no port is needed
assert os.environ["PADDLE_COORDINATOR"].startswith("127.0.0.1:")
parallel.init_parallel_env(place=pt.CPUPlace(), init_method="file://" + store)
rank = parallel.get_rank()
assert parallel.get_world_size() == int(os.environ["PADDLE_TRAINERS"]) == 2
case = np.load(case_path, allow_pickle=True).item()
prog = pt.Program.from_dict(case["program"])
scope = scope_from_numpy(case["state"], pt.CPUPlace())
pexe = parallel.ParallelExecutor(main_program=prog,
                                 mesh=parallel.make_mesh((2,), ("data",)))
losses = [float(pexe.run(feed=f, fetch_list=case["fetch"], scope=scope)[0])
          for f in case["feeds"]]
if rank == 0:
    json.dump(losses, open(out, "w"))
parallel.destroy_parallel_env()
'''


def test_two_launched_ranks_match_one_process(tmp_path, monkeypatch):
    """``launch --nproc 2`` of a DP trainer (the mirror of
    ``test_multiprocess_dp.py``): two ranks' losses equal one process's,
    the port's and the JAX package's, within DP_TOL."""
    import json
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.convert import scope_from_numpy
    _cross_entropy_grad_once(monkeypatch)
    main, startup, loss = _mlp("sgd", classes=10, prefix="lp")
    scope, state = _state(main, startup)
    rng = np.random.RandomState(7)
    feeds = [{"img": rng.rand(16, 32).astype("float32"),
              "label": rng.randint(0, 10, (16, 1)).astype("int64")}
             for _ in range(4)]
    case = tmp_path / "case.npy"
    np.save(case, {"program": main.to_dict(), "state": state,
                   "feeds": feeds, "fetch": [loss.name]},
            allow_pickle=True)
    script = tmp_path / "trainer.py"
    script.write_text(_LAUNCHED)
    out = tmp_path / "losses.json"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "launch", "--nproc", "2",
         str(script), str(tmp_path / "store"), str(case), str(out)],
        cwd=root, env=dict(os.environ, PYTHONPATH=root),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ref = _losses(_jax_steps(main, scope, feeds, [loss.name])())
        texe = pt.Executor(pt.CPUPlace())
        tprog = TorchProgram.from_dict(main.to_dict())
        tscope = scope_from_numpy(state, pt.CPUPlace())
        one = np.array([float(texe.run(tprog, feed=f,
                                       fetch_list=[loss.name],
                                       scope=tscope)[0]) for f in feeds])
        _, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    two = np.array(json.loads(out.read_text()))
    np.testing.assert_allclose(two, one, rtol=DP_TOL, atol=1e-6)
    np.testing.assert_allclose(two, ref, rtol=DP_TOL, atol=1e-6)


def test_launch_stops_the_other_ranks_when_one_fails(tmp_path):
    """A rank that dies takes the world down: the others are stopped
    instead of waiting in a collective for it (the JAX package's
    launcher waits for each in turn)."""
    import time
    script = tmp_path / "rank.py"
    script.write_text(
        "import os, sys, time\n"
        "if os.environ['PADDLE_TRAINER_ID'] == '1':\n"
        "    sys.exit(3)\n"
        "time.sleep(60)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    t = time.monotonic()
    r = subprocess.run([sys.executable, "-m", "paddle_tpu_torch", "launch",
                        "--nproc", "3", str(script)], cwd=root,
                       env=dict(os.environ, PYTHONPATH=root),
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 3, r.stderr
    assert "rank 1 exited with 3" in r.stderr
    assert time.monotonic() - t < 30
