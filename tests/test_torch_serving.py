"""The port's serving front against the JAX package's, on the CPU, over
HTTP: ``/predict`` through both packages' ``InferenceServer`` (with and
without the ``MicroBatcher``) on one bundle the JAX package exported
from a seed (a small MLP: feature 8, two ``fc`` 32), the same status
codes and error bodies for malformed requests, a model still loading, a
failed load, a full batch queue and an expired or timed-out request,
the same ``/meta`` and the same ``/readyz`` sequence under
``async_load``.  Also the exception classes the server and the
scheduler share.

Tolerance: float32 ``rtol = atol = 1e-5`` (torch and XLA sum in
different orders); status codes and error bodies are compared exactly.
Every HTTP wait has its own timeout and every server is shut down in a
``finally``."""

import contextlib
import http.client
import json
import threading
import time

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu import serving as jax_serving
from paddle_tpu.fault import chaos as jax_chaos
from paddle_tpu_torch import CPUPlace

TOL = 1e-5
HTTP_TIMEOUT = 30


def _torch_modules():
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.fault import chaos
    return serving, chaos


@pytest.fixture(scope="module")
def mlp_dir(tmp_path_factory):
    """A seeded MLP (feature 8, two ``fc`` 32), exported by the JAX
    package."""
    d = str(tmp_path_factory.mktemp("torch_serving") / "mlp")
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 7
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        h = fluid.layers.fc(input=x, size=32, act="relu")
        y = fluid.layers.fc(input=h, size=32)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor()
        exe.run(startup)
        fluid.io.save_inference_model(d, ["x"], [y], exe, main)
    return d


@contextlib.contextmanager
def _server(pkg, model_dir, **kw):
    if pkg == "torch":
        serving, _ = _torch_modules()
        srv = serving.InferenceServer(model_dir, place=CPUPlace(), **kw)
    else:
        srv = jax_serving.InferenceServer(model_dir, **kw)
    srv.start_background()
    try:
        yield srv
    finally:
        srv.shutdown()


def _chaos(pkg):
    return _torch_modules()[1] if pkg == "torch" else jax_chaos


def _http(srv, method, path, body=None, headers=None):
    """``(status, parsed JSON body)`` of one request on a new
    connection."""
    conn = http.client.HTTPConnection(*srv.addr, timeout=HTTP_TIMEOUT)
    try:
        if isinstance(body, (dict, list)):
            body = json.dumps(body).encode()
        hdrs = {"Content-Type": "application/json"}
        hdrs.update(headers or {})
        conn.request(method, path, body, hdrs)
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, json.loads(data) if data else None
    finally:
        conn.close()


def _rows(n, seed):
    return np.random.RandomState(seed).randn(n, 8).astype("float32")


# ---------------------------------------------------------------------------
# the exception classes (one of each, shared by the server and scheduler)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["DeadlineExceeded", "QueueFull",
                                  "BatcherCrashed"])
def test_one_exception_class_shared_with_the_scheduler(name):
    import paddle_tpu_torch.gen as gen
    import paddle_tpu_torch.gen.scheduler as scheduler
    serving, _ = _torch_modules()
    cls = getattr(serving, name)
    assert getattr(gen, name) is cls
    assert getattr(scheduler, name) is cls
    ref = getattr(jax_serving, name)
    assert [c.__name__ for c in cls.__mro__] == \
        [c.__name__ for c in ref.__mro__]
    assert issubclass(cls, RuntimeError)
    assert cls.__doc__ == ref.__doc__


# ---------------------------------------------------------------------------
# /predict
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batching", [False, True],
                         ids=["serialized", "micro-batched"])
def test_predict_replies_match(mlp_dir, batching):
    serving, _ = _torch_modules()
    local = serving.Predictor(mlp_dir, place=CPUPlace())
    feeds = [_rows(n, seed) for seed, n in enumerate((1, 3, 8, 2))]
    replies = {}
    for pkg in ("jax", "torch"):
        with _server(pkg, mlp_dir, batching=batching, warmup=True,
                     max_batch_size=4) as srv:
            client = (serving if pkg == "torch" else jax_serving) \
                .ServingClient(f"{srv.addr[0]}:{srv.addr[1]}",
                               timeout=HTTP_TIMEOUT)
            out = [None] * len(feeds)

            def call(i):
                out[i] = client.predict({"x": feeds[i]})

            threads = [threading.Thread(target=call, args=(i,))
                       for i in range(len(feeds))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(HTTP_TIMEOUT)
            replies[pkg] = out
            status, body = _http(srv, "POST", "/predict",
                                 {"feeds": {"x": feeds[0].tolist()}})
            assert status == 200
            replies[pkg + "_raw"] = (body["shapes"], body["dtypes"])
    for i, x in enumerate(feeds):
        (want,) = local.run({"x": x})
        for pkg in ("jax", "torch"):
            (got,) = replies[pkg][i]
            assert got.shape == (len(x), 32) and got.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                       err_msg=f"{pkg} request {i}")
    assert replies["jax_raw"] == replies["torch_raw"]


ERROR_CASES = {
    # name: (method, path, body, headers, compare the message too)
    "malformed_json": ("POST", "/predict", b"{not json", None, True),
    "no_feeds_key": ("POST", "/predict", {"x": 1}, None, True),
    "missing_feed": ("POST", "/predict", {"feeds": {}}, None, True),
    "wrong_rank": ("POST", "/predict", {"feeds": {"x": [1.0, 2.0]}}, None,
                   False),
    "bad_deadline": ("POST", "/predict", {"feeds": {}},
                     {"X-Deadline-Ms": "soon"}, True),
    "expired_deadline": ("POST", "/predict", {"feeds": {}},
                         {"X-Deadline-Ms": "0"}, True),
    "unknown_post": ("POST", "/nope", {}, None, True),
    "unknown_get": ("GET", "/nope", None, None, True),
    "generate_on_predict_model": ("POST", "/generate", {"prompt": [1]},
                                  None, True),
}


@pytest.fixture(scope="module")
def server_pair(mlp_dir):
    with _server("jax", mlp_dir) as js, _server("torch", mlp_dir) as ts:
        yield js, ts


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_error_replies_match(server_pair, case):
    method, path, body, headers, whole = ERROR_CASES[case]
    (js_status, js_body), (ts_status, ts_body) = (
        _http(s, method, path, body, headers) for s in server_pair)
    assert ts_status == js_status
    assert 400 <= ts_status < 600
    if whole:
        assert ts_body == js_body
    else:
        assert ts_body["error"]["type"] == js_body["error"]["type"]
        assert ts_body["retryable"] == js_body["retryable"]


def test_meta_health_and_metrics_match(server_pair):
    js, ts = server_pair
    for path in ("/meta", "/healthz", "/health", "/readyz"):
        assert _http(ts, "GET", path) == _http(js, "GET", path), path
    for srv in server_pair:
        status, body = _http(srv, "GET", "/stats")
        assert status == 200
        assert {"counters", "series", "histograms", "gauges",
                "server"} <= set(body)
        assert _http(srv, "GET", "/spans")[0] == 200
        assert _http(srv, "GET", "/trace")[0] == 200
    serving, _ = _torch_modules()
    client = serving.ServingClient(f"{ts.addr[0]}:{ts.addr[1]}")
    assert client.healthy() and client.ready()
    assert client.meta()["feeds"] == ["x"]
    assert client.prom_metrics().endswith("\n")
    assert "traceEvents" in client.trace()


def test_readyz_sequence_under_async_load_matches(mlp_dir):
    """While the model loads (held by the ``serving.load`` failpoint)
    ``/readyz`` and ``/predict`` answer 503 ``model_loading`` and
    ``/healthz`` 200; then ``/readyz`` turns 200."""
    seqs = {}
    for pkg in ("jax", "torch"):
        chaos = _chaos(pkg)
        chaos.inject("serving.load", delay=1.0, times=1)
        try:
            with _server(pkg, mlp_dir, async_load=True) as srv:
                seen = [(p, *_http(srv, m, p, b)) for m, p, b in (
                    ("GET", "/healthz", None), ("GET", "/readyz", None),
                    ("POST", "/predict", {"feeds": {}}))]
                states = []
                deadline = time.monotonic() + HTTP_TIMEOUT
                while time.monotonic() < deadline:
                    st = _http(srv, "GET", "/readyz")[0]
                    if not states or states[-1] != st:
                        states.append(st)
                    if st == 200:
                        break
                    time.sleep(0.02)
                assert srv.wait_until_ready(timeout=HTTP_TIMEOUT)
                seqs[pkg] = (seen, states)
        finally:
            chaos.clear()
    assert seqs["torch"] == seqs["jax"]
    seen, states = seqs["torch"]
    assert states == [503, 200]
    assert [s for _, s, _ in seen] == [200, 503, 503]


def test_failed_async_load_matches(tmp_path):
    missing = str(tmp_path / "no_model")
    got = {}
    for pkg in ("jax", "torch"):
        with _server(pkg, missing, async_load=True) as srv:
            with pytest.raises(Exception):
                srv.wait_until_ready(timeout=HTTP_TIMEOUT)
            got[pkg] = [(s, b["error"]["type"], b["retryable"])
                        for s, b in (_http(srv, "GET", "/readyz"),
                                     _http(srv, "POST", "/predict",
                                           {"feeds": {}}))]
    assert got["torch"] == got["jax"] == [
        (500, "model_load_failed", False)] * 2


def _background(srv, body, out, key):
    def run():
        out[key] = _http(srv, "POST", "/predict", body)
    t = threading.Thread(target=run)
    t.start()
    return t


def test_queue_full_reply_matches(mlp_dir):
    """A batch held in dispatch (the ``serving.batch`` failpoint), one
    request queued behind it (queue of 1): the third is shed with a
    retryable 503 ``overloaded``."""
    body = {"feeds": {"x": _rows(1, 0).tolist()}}
    got = {}
    for pkg in ("jax", "torch"):
        chaos = _chaos(pkg)
        with _server(pkg, mlp_dir, batching=True, max_batch_size=1,
                     batch_queue_size=1) as srv:
            _http(srv, "POST", "/predict", body)       # first dispatch
            chaos.inject("serving.batch", delay=1.5, times=1)
            out, threads = {}, []
            try:
                threads.append(_background(srv, body, out, "held"))
                time.sleep(0.4)
                threads.append(_background(srv, body, out, "queued"))
                time.sleep(0.4)
                got[pkg] = _http(srv, "POST", "/predict", body)
            finally:
                for t in threads:
                    t.join(HTTP_TIMEOUT)
                chaos.clear()
            assert out["held"][0] == out["queued"][0] == 200
    assert got["torch"] == got["jax"]
    assert got["torch"] == (503, {"error": {
        "type": "overloaded", "message": "batch queue full (1 pending)"},
        "retryable": True})


@pytest.mark.parametrize("batching", [False, True],
                         ids=["serialized", "micro-batched"])
def test_timed_out_reply_matches(mlp_dir, batching):
    """A request that waits past ``request_timeout`` behind a dispatch
    held by a failpoint gets a retryable 504 ``deadline_exceeded``."""
    body = {"feeds": {"x": _rows(2, 1).tolist()}}
    point = "serving.batch" if batching else "serving.predict"
    got = {}
    for pkg in ("jax", "torch"):
        chaos = _chaos(pkg)
        with _server(pkg, mlp_dir, batching=batching, max_batch_size=1,
                     request_timeout=0.3) as srv:
            _http(srv, "POST", "/predict", body)
            chaos.inject(point, delay=1.5, times=1)
            out = {}
            try:
                t = _background(srv, body, out, "held")
                time.sleep(0.3)
                got[pkg] = _http(srv, "POST", "/predict", body)
            finally:
                t.join(HTTP_TIMEOUT)
                chaos.clear()
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == 504
    assert got["torch"][1]["error"]["type"] == "deadline_exceeded"
    assert got["torch"][1]["retryable"] is True


# ---------------------------------------------------------------------------
# Predictor, batch_key and warmup
# ---------------------------------------------------------------------------

def test_run_many_and_batch_key_match(mlp_dir):
    serving, _ = _torch_modules()
    tp = serving.Predictor(mlp_dir, place=CPUPlace())
    jp = jax_serving.Predictor(mlp_dir)
    feeds = [{"x": _rows(n, 10 + n)} for n in (1, 2, 5)]
    for f in feeds + [{"x": np.float32(1.0)}]:
        assert serving.batch_key(f) == jax_serving.batch_key(f)
    for got, want in zip(tp.run_many(feeds), jp.run_many(feeds)):
        np.testing.assert_allclose(got[0], want[0], rtol=TOL, atol=TOL)
        assert got[0].shape == want[0].shape
    assert tp.feed_names == jp.feed_names
    assert tp.fetch_names == jp.fetch_names


@pytest.mark.parametrize("bucket", [True, False])
def test_predictor_warmup_signatures_match(mlp_dir, bucket):
    serving, _ = _torch_modules()
    tp = serving.Predictor(mlp_dir, place=CPUPlace())
    jp = jax_serving.Predictor(mlp_dir)
    sizes = (1, 3, 8)
    got = tp.warmup(sizes, bucket=bucket)
    want = jp.warmup(sizes, bucket=bucket)
    assert [b["signature"] for b in got.buckets] == \
        [b["signature"] for b in want.buckets]
    # the CPU runs the plain versions: nothing is built
    assert int(got) == 0
    assert {b["cache"] for b in got.buckets} == {"warm"}


def test_client_master_raises():
    serving, _ = _torch_modules()
    with pytest.raises(NotImplementedError, match="item 8"):
        serving.ServingClient(master="127.0.0.1:1")
