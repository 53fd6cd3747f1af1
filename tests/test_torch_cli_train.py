"""The port's training, inference and observability commands
(``python -m paddle_tpu_torch version|train|infer|trace|bench|runs``),
the cases of ``tests/test_cli_and_data.py::TestCLI`` and the ``trace``,
``bench`` and ``runs`` rows of the JAX package's CLI tests:

- ``version`` names torch, CUDA and the card (``unavailable`` here);
- ``train --config`` runs a script with ``PADDLE_NUM_PASSES``; its saved
  bundle runs through ``infer --place cpu`` and equals the JAX
  package's run of the same bundle to ``INFER_RTOL``; ``infer`` without
  ``--place`` raises when CUDA is absent;
- ``train --checkpoint-dir D`` exports what ``fault.manager_from_env``
  reads: the script trains through ``run_pipeline`` with a ``RunLedger``
  under D, and ``runs show|tail`` print its rows;
- ``trace dump --local``; ``--fleet`` raises naming the fleet's item;
- ``bench record`` then ``bench check``; ``runs compare``;
- ``paddle_tpu_torch.debuger`` warns once, ``import paddle_tpu_torch``
  never."""

import contextlib
import io
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from paddle_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INFER_RTOL = 1e-5


def _env(**kw):
    env = dict(os.environ, PYTHONPATH=REPO, **kw)
    for k in ("PADDLE_TPU_CKPT_DIR", "PADDLE_TPU_CKPT_KEEP",
              "PADDLE_TPU_CHAOS"):
        env.pop(k, None)
    env.update(kw)
    return env


def _run_cli(args, env=None, timeout=180):
    return subprocess.run([sys.executable, "-m", "paddle_tpu_torch"] + args,
                          capture_output=True, text=True,
                          env=env or _env(), timeout=timeout, cwd=REPO)


def _cli(args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    return rc, buf.getvalue()


def test_version():
    r = _run_cli(["version"])
    assert r.returncode == 0, r.stderr
    assert "paddle_tpu_torch" in r.stdout and "torch" in r.stdout
    assert "cuda" in r.stdout and "device" in r.stdout
    if not torch.cuda.is_available():
        assert "unavailable (CUDA is not available)" in r.stdout


TRAIN_SCRIPT = """
import os
import numpy as np
import paddle_tpu_torch as pt
import paddle_tpu_torch.layers as layers

passes = int(os.environ.get("PADDLE_NUM_PASSES", 1))
x = layers.data(name="x", shape=[8, 4], append_batch_size=False)
y = layers.data(name="y", shape=[8, 1], append_batch_size=False)
pred = layers.fc(input=x, size=1)
loss = layers.mean(layers.square_error_cost(input=pred, label=y))
pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
exe = pt.Executor(pt.CPUPlace())
exe.run(pt.default_startup_program())
rng = np.random.RandomState(0)
xs = rng.rand(8, 4).astype("float32")
ys = (xs.sum(1, keepdims=True) * 0.5).astype("float32")
first = last = None
for p in range(passes * 10):
    (l,) = exe.run(pt.default_main_program(),
                   feed={"x": xs, "y": ys}, fetch_list=[loss])
    l = float(np.asarray(l).reshape(-1)[0])
    first = l if first is None else first
    last = l
assert last < first
pt.io.save_inference_model(os.environ["MODEL_DIR"], ["x"], [pred], exe)
print("TRAIN_DONE", passes, first, last)
"""


def test_train_and_infer(tmp_path):
    cfg = tmp_path / "train_config.py"
    cfg.write_text(TRAIN_SCRIPT)
    model_dir = tmp_path / "model"
    env = _env(MODEL_DIR=str(model_dir))
    r = _run_cli(["train", "--config", str(cfg), "--num-passes", "2"],
                 env=env)
    assert r.returncode == 0, r.stderr
    assert "TRAIN_DONE 2" in r.stdout

    x = np.random.RandomState(1).rand(8, 4).astype("float32")
    np.save(tmp_path / "x.npy", x)
    r = _run_cli(["infer", "--model", str(model_dir), "--feed",
                  f"x={tmp_path / 'x.npy'}", "--output", str(tmp_path),
                  "--place", "cpu"], env=env)
    assert r.returncode == 0, r.stderr
    assert "shape=(8, 1)" in r.stdout
    (out,) = [f for f in os.listdir(tmp_path) if f.endswith(".npy")
              and f != "x.npy"]
    got = np.load(tmp_path / out)
    # the JAX package runs the port's bundle to the same predictions
    import paddle_tpu as fluid
    jexe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        prog, _, fetches = fluid.io.load_inference_model(
            str(model_dir), jexe)
        (want,) = jexe.run(prog, feed={"x": x}, fetch_list=fetches)
    np.testing.assert_allclose(got, np.asarray(want), rtol=INFER_RTOL,
                               atol=INFER_RTOL)
    # a missing feed is a usage error
    rc, _ = _cli(["infer", "--model", str(model_dir), "--place", "cpu"])
    assert rc == 2


def test_infer_without_a_place_raises_when_cuda_is_absent(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["infer", "--model", str(tmp_path)])


PIPELINE_SCRIPT = """
import json
import os
import numpy as np
import paddle_tpu_torch as pt
import paddle_tpu_torch.datapipe as dp
from paddle_tpu_torch.fault import manager_from_env
from paddle_tpu_torch.obs.ledger import RunLedger

main, startup = pt.Program(), pt.Program()
main.random_seed = startup.random_seed = 5
with pt.program_guard(main, startup):
    x = pt.layers.data("x", shape=[4], dtype="float32")
    y = pt.layers.data("y", shape=[1], dtype="float32")
    pred = pt.layers.fc(x, 1)
    loss = pt.layers.reduce_mean(pt.layers.square_error_cost(pred, y))
    pt.optimizer.SGD(learning_rate=0.05).minimize(loss)
exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
exe.run(startup, scope=scope)
rng = np.random.RandomState(3)
samples = [{"x": rng.rand(4).astype("float32"),
            "y": rng.rand(1).astype("float32")} for _ in range(24)]
pipe = dp.InMemorySource(samples).shuffle(8, seed=1).batch(
    4, drop_last=True).prefetch(device="cpu")
mgr = manager_from_env(executor=exe, main_program=main, scope=scope)
ledger = RunLedger(os.path.join(mgr.dirname, "ledger"), flush_every=1)
mgr.datapipe, mgr.ledger = pipe, ledger
passes = int(os.environ.get("PADDLE_NUM_PASSES", 1))
losses = []
for p in range(passes):
    outs = exe.run_pipeline(main, pipe, fetch_list=[loss], scope=scope,
                            ledger=ledger,
                            on_step=lambda s, f: mgr.save(len(losses) + s))
    losses += [float(np.asarray(o[0]).reshape(())) for o in outs]
ledger.close()
print(json.dumps({"keep": mgr.keep, "dir": mgr.dirname,
                  "losses": losses, "steps": mgr.steps()}))
"""


def test_train_checkpoint_dir_runs_the_pipeline_and_the_ledger(tmp_path):
    cfg = tmp_path / "pipe.py"
    cfg.write_text(PIPELINE_SCRIPT)
    d = tmp_path / "ckpt"
    r = _run_cli(["train", "--config", str(cfg), "--num-passes", "2",
                  "--checkpoint-dir", str(d), "--keep-checkpoints", "2"])
    assert r.returncode == 0, r.stderr
    report = json.loads(r.stdout.strip().splitlines()[-1])
    assert report["keep"] == 2 and report["dir"] == str(d)
    assert len(report["losses"]) == 12 and len(report["steps"]) == 2
    led = str(d / "ledger")
    rc, out = _cli(["runs", "show", led, "--json"])
    body = json.loads(out)
    assert rc == 0 and body["rows"] == 12
    assert (body["first_step"], body["last_step"]) == (0, 11)
    assert body["fields"]["loss"]["first"] == report["losses"][0]
    assert body["fields"]["loss"]["last"] == report["losses"][-1]
    rc, out = _cli(["runs", "tail", led, "-n", "3"])
    lines = out.strip().splitlines()
    assert rc == 0 and lines[0].split()[:3] == ["step", "time_unix", "loss"]
    assert [int(line.split()[0]) for line in lines[1:]] == [9, 10, 11]
    assert [float(line.split()[2]) for line in lines[1:]] == \
        pytest.approx(report["losses"][-3:], rel=1e-5)
    rc, out = _cli(["runs", "compare", led, led, "--json"])
    assert rc == 0 and json.loads(out)["deltas"]["loss"]["delta_last"] == 0
    rc, out = _cli(["runs", "compare", led])
    assert rc == 2
    assert _cli(["runs", "show", str(tmp_path / "nope")])[0] == 2


def test_trace_dump_local(tmp_path):
    from paddle_tpu_torch.obs import trace
    trace.clear()
    trace.enable()
    try:
        with trace.span("train.step", step=0):
            pass
        out = tmp_path / "trace.json"
        rc, text = _cli(["trace", "dump", "--local", "--output", str(out)])
    finally:
        trace.disable()
        trace.clear()
    assert rc == 0 and "wrote" in text
    body = json.loads(out.read_text())
    assert any(ev.get("name") == "train.step"
               for ev in body["traceEvents"])
    rc, text = _cli(["trace", "dump"])
    assert rc == 0 and "traceEvents" in json.loads(text)


def test_trace_dump_fleet_waits_for_the_fleet(tmp_path):
    """``trace dump --fleet`` against a router: one assembled timeline
    with a process row for the router and one for the replica, the
    routed request's spans in both (the name is kept from when the fleet
    was not ported)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.fleet import FleetRouter
    from paddle_tpu_torch.obs import trace as _trace
    from paddle_tpu_torch.serving import InferenceServer, ServingClient
    assert cli.main(["trace", "dump", "--fleet"]) == 2   # needs --addr
    d = str(tmp_path / "m")
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=[4], dtype="float32")
        y = pt.layers.fc(x, 2)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    with pt.scope_guard(scope):
        exe.run(startup)
        pt.io.save_inference_model(d, ["x"], [y], exe, main)
    _trace.enable()
    _trace.clear()
    server = InferenceServer(d, port=0, place=pt.CPUPlace())
    server.start_background()
    router = None
    try:
        router = FleetRouter(replicas=[f"{server.addr[0]}:{server.addr[1]}"])
        router.start_background()
        ServingClient(router.addr).predict({"x": np.ones((2, 4), "float32")})
        out = str(tmp_path / "fleet.json")
        rc, text = _cli(["trace", "dump", "--fleet", "--addr",
                         f"{router.addr[0]}:{router.addr[1]}",
                         "--output", out])
        assert rc == 0 and "wrote" in text
        with open(out) as f:
            obj = json.load(f)
        sources = {p["source"] for p in obj["fleetAssembly"]["processes"]}
        assert "router" in sources and len(sources) == 2, sources
        names = {e["name"] for e in obj["traceEvents"] if e["ph"] == "X"}
        assert {"fleet.request", "serving.request"} <= names, names
    finally:
        if router is not None:
            router.shutdown()
        server.shutdown()
        _trace.disable()
        _trace.clear()


def test_bench_record_then_check(tmp_path):
    traj = str(tmp_path / "traj.json")
    summary = tmp_path / "s.json"
    summary.write_text(json.dumps({"datapipe": {"samples_per_sec": 900.0},
                                   "speedup": 2.0}))
    rc, out = _cli(["bench", "record", "--bench", "datapipe", "--summary",
                    str(summary), "--trajectory", traj, "--baseline"])
    assert rc == 0 and json.loads(out)["baseline"] is True
    rc, out = _cli(["bench", "check", "--trajectory", traj])
    assert rc == 0 and "bench check (regression gate): PASS" in out
    summary.write_text(json.dumps({"datapipe": {"samples_per_sec": 100.0},
                                   "speedup": 2.0}))
    assert _cli(["bench", "record", "--bench", "datapipe", "--summary",
                 str(summary), "--trajectory", traj])[0] == 0
    rc, out = _cli(["bench", "check", "--trajectory", traj])
    assert rc == 1 and "[FAIL] datapipe.samples_per_sec" in out
    assert _cli(["bench", "check", "--trajectory", traj, "--dry"])[0] == 0
    assert _cli(["bench", "record", "--bench", "datapipe"])[0] == 2


def test_debuger_warns_once_and_reexports():
    sys.modules.pop("paddle_tpu_torch.debuger", None)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        from paddle_tpu_torch import debuger
        import paddle_tpu_torch.debuger  # noqa: F401  (cached: silent)
    assert [w.category for w in caught] == [DeprecationWarning]
    from paddle_tpu_torch.analysis import visualize
    assert debuger.draw_block_graphviz is visualize.draw_block_graphviz
    assert debuger.pprint_program_codes is visualize.pprint_program_codes
    r = subprocess.run(
        [sys.executable, "-W", "error::DeprecationWarning", "-c",
         "import paddle_tpu_torch as pt; pt.datapipe; pt.obs.ledger"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
