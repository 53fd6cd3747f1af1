"""The port's ``/generate`` against the JAX package's, on the CPU, over
HTTP: one ``GenConfig`` bundle per KV layout (paged and dense), exported
by the JAX package from a seed, served by both packages'
``InferenceServer`` with ``warmup=True``.

- Streamed and buffered streams are token-identical across the two
  servers and to the cache-free re-prefill, and every event passes both
  packages' ``validate_stream_event``.  The smallest top-1/top-2 logit
  gap along the compared streams is reported (``min_logit_gap`` in the
  test's properties and on stdout); the seed is the one first chosen.
- Drain checkpoints have the same form in both schedulers; a checkpoint
  taken from one package's server resumes on the other's to the
  uninterrupted stream; a client over both servers resumes a stream
  whose owner drained or aborted.
- The port's warmup leaves the pool's bytes unchanged (paged and
  dense; the reference's dense warmup turns a -0.0 into +0.0, which the
  test checks too), and declares the same signatures as the
  reference's; ``admission="batch"`` gives the
  reference's streams; error replies of ``/generate`` are equal.

Tokens and replies are compared exactly.  Every HTTP wait has its own
timeout, every server is shut down in a ``finally``, and every armed
failpoint is cleared."""

import contextlib
import http.client
import json
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu import serving as jax_serving
from paddle_tpu.fault import chaos as jax_chaos
from paddle_tpu.fleet.sessions import \
    validate_checkpoint as jax_validate_checkpoint
from paddle_tpu.fleet.sessions import \
    validate_stream_event as jax_validate_event
from paddle_tpu.gen import GenPredictor as JaxPredictor
from paddle_tpu.gen import GenScheduler as JaxScheduler
from paddle_tpu.models import gen_lm as jax_gen_lm
from paddle_tpu_torch import CPUPlace
from paddle_tpu_torch import serving as torch_serving
from paddle_tpu_torch.fault import chaos as torch_chaos
from paddle_tpu_torch.fleet import \
    validate_checkpoint as torch_validate_checkpoint
from paddle_tpu_torch.fleet import \
    validate_stream_event as torch_validate_event
from paddle_tpu_torch.gen import GenPredictor, GenScheduler, StreamMigrated

HTTP_TIMEOUT = 30
NUM_SLOTS = 4
MAX_NEW = 8
PROMPT_LENS = (3, 15, 17, 33)


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    out = {}
    for paged in (True, False):
        d = str(tmp_path_factory.mktemp("torch_serving_gen") /
                ("paged" if paged else "dense"))
        jax_gen_lm.export_gen_model(d, jax_gen_lm.GenConfig(),
                                    num_slots=NUM_SLOTS, paged=paged)
        out["paged" if paged else "dense"] = d
    return out


@contextlib.contextmanager
def _server(pkg, model_dir, **kw):
    if pkg == "torch":
        srv = torch_serving.InferenceServer(model_dir, place=CPUPlace(),
                                            warmup=True, **kw)
    else:
        srv = jax_serving.InferenceServer(model_dir, warmup=True, **kw)
    srv.start_background()
    try:
        yield srv
    finally:
        srv.shutdown()


@pytest.fixture(scope="module", params=["paged", "dense"])
def pair(request, bundles):
    """``(layout, bundle, jax server, torch server)``."""
    d = bundles[request.param]
    with _server("jax", d) as js, _server("torch", d) as ts:
        yield request.param, d, js, ts


def _addr(srv):
    return f"{srv.addr[0]}:{srv.addr[1]}"


def _read_stream(srv, payload, headers=None):
    """``(status, events)``: the ndjson events of one streamed reply (or
    the JSON body of a buffered or error reply, as one event)."""
    conn = http.client.HTTPConnection(*srv.addr, timeout=HTTP_TIMEOUT)
    try:
        hdrs = {"Content-Type": "application/json"}
        hdrs.update(headers or {})
        conn.request("POST", "/generate", json.dumps(payload).encode(),
                     hdrs)
        resp = conn.getresponse()
        if resp.getheader("Content-Type") != "application/x-ndjson":
            return resp.status, [json.loads(resp.read())]
        events = []
        while True:
            line = resp.readline()
            if not line:
                break
            events.append(json.loads(line))
        return resp.status, events
    finally:
        conn.close()


def _prompts(seed=0, lens=PROMPT_LENS):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(0, 64, n)] for n in lens]


def _tokens(events):
    return [e["token"] for e in events if "token" in e]


def _reprefill(pred, prompt, n):
    """Greedy tokens by cache-free re-prefill, and the smallest
    top-1/top-2 logit gap along them."""
    seq, out, gap = list(prompt), [], np.inf
    for _ in range(n):
        logits, _ = pred.prefill(seq)
        top = np.sort(np.asarray(logits, np.float64))[-2:]
        gap = min(gap, float(top[1] - top[0]))
        out.append(int(np.argmax(logits)))
        seq.append(out[-1])
    return out, gap


@pytest.fixture(scope="module")
def port_predictors(bundles):
    return {k: GenPredictor(d, place=CPUPlace())
            for k, d in bundles.items()}


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

def test_streams_are_token_identical(pair, port_predictors,
                                     record_property):
    layout, _, js, ts = pair
    min_gap = np.inf
    for prompt in _prompts(0):
        want, gap = _reprefill(port_predictors[layout], prompt, MAX_NEW)
        min_gap = min(min_gap, gap)
        for srv in (js, ts):
            for stream in (True, False):
                status, events = _read_stream(
                    srv, {"prompt": prompt, "max_new_tokens": MAX_NEW,
                          "stream": stream})
                assert status == 200
                for ev in events if stream else []:
                    assert torch_validate_event(ev) == []
                    assert jax_validate_event(ev) == []
                toks = _tokens(events) if stream else events[0]["tokens"]
                assert toks == want, (layout, len(prompt), stream)
                tail = events[-1]
                assert tail["done"] and tail["finish_reason"] == "length"
                assert tail["token_index"] == MAX_NEW
                if stream:
                    assert [e["index"] for e in events if "token" in e] \
                        == list(range(MAX_NEW))
    record_property("min_logit_gap", min_gap)
    print(f"\n{layout}: smallest top-1/top-2 logit gap {min_gap:.6g}")


def test_concurrent_streams_match_the_reference_server(pair):
    """Four streams at once through each server (the scheduler's
    continuous batching): each equals the same prompt served alone by
    the reference server."""
    _, _, js, ts = pair
    prompts = _prompts(5, (4, 9, 16, 20))
    want = [_tokens(_read_stream(js, {"prompt": p,
                                      "max_new_tokens": MAX_NEW})[1])
            for p in prompts]
    got = [None] * len(prompts)
    client = torch_serving.ServingClient(_addr(ts), timeout=HTTP_TIMEOUT)

    def run(i):
        got[i] = _tokens(client.generate(prompts[i],
                                         max_new_tokens=MAX_NEW))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(HTTP_TIMEOUT)
    assert got == want


GEN_ERRORS = {
    "malformed_json": b"{oops",
    "no_prompt": {"max_new_tokens": 2},
    "empty_prompt": {"prompt": []},
    "out_of_vocab": {"prompt": [1, 999]},
    "zero_new_tokens": {"prompt": [1], "max_new_tokens": 0},
    "negative_resume": {"prompt": [1], "resume_from": -1},
    "resume_past_max_prompt": {"prompt": list(range(1, 64)) * 2,
                               "resume_from": 3},
    "resume_after_eos": {"prompt": [1, 2, 5], "resume_from": 1,
                         "eos_id": 5, "stream": False},
    "resume_after_eos_streamed": {"prompt": [1, 2, 5], "resume_from": 1,
                                  "eos_id": 5},
}


@pytest.mark.parametrize("case", sorted(GEN_ERRORS))
def test_generate_error_replies_match(pair, case):
    _, _, js, ts = pair
    body = GEN_ERRORS[case]
    replies = []
    for srv in (js, ts):
        if isinstance(body, bytes):
            conn = http.client.HTTPConnection(*srv.addr,
                                              timeout=HTTP_TIMEOUT)
            try:
                conn.request("POST", "/generate", body,
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                replies.append((resp.status, json.loads(resp.read())))
            finally:
                conn.close()
        else:
            replies.append(_read_stream(srv, body))
    assert replies[1] == replies[0]


def test_expired_deadline_reply_matches(pair):
    _, _, js, ts = pair
    replies = [_read_stream(s, {"prompt": [1, 2]},
                            headers={"X-Deadline-Ms": "0"})
               for s in (js, ts)]
    assert replies[1] == replies[0]
    assert replies[1][0] == 504


# ---------------------------------------------------------------------------
# drain, migrate, abort, resume
# ---------------------------------------------------------------------------

def _drained_checkpoint(scheduler_cls, predictor, chaos, prompt):
    sched = scheduler_cls(predictor, queue_size=8)
    chaos.inject("gen.decode.stall", delay=0.05)
    try:
        s = sched.submit(prompt, max_new_tokens=12)
        assert s.next_event(timeout=HTTP_TIMEOUT)[0] == "token"
        ckpts = sched.drain(deadline_s=0.1)
        with pytest.raises(Exception) as ei:
            for _ in s:
                pass
        assert type(ei.value).__name__ == "StreamMigrated"
    finally:
        chaos.clear()
        sched.close()
    assert len(ckpts) == 1
    return ckpts[0]


def test_drain_checkpoints_have_one_form_and_resume_across_packages(
        bundles, port_predictors):
    d = bundles["paged"]
    prompt = [3, 4, 9]
    jc = _drained_checkpoint(JaxScheduler, JaxPredictor(d), jax_chaos,
                             prompt)
    tc = _drained_checkpoint(GenScheduler, port_predictors["paged"],
                             torch_chaos, prompt)
    assert sorted(tc) == sorted(jc)
    assert {k: type(v) for k, v in tc.items()} == \
        {k: type(v) for k, v in jc.items()}
    for ck in (jc, tc):
        assert torch_validate_checkpoint(ck) == []
        assert jax_validate_checkpoint(ck) == []
        assert ck["prompt"] == prompt and ck["reason"] == "draining"
        assert len(ck["tokens"]) + ck["remaining_tokens"] == 12
    want, _ = _reprefill(port_predictors["paged"], prompt, 12)
    assert jc["tokens"] == want[:len(jc["tokens"])]
    assert tc["tokens"] == want[:len(tc["tokens"])]
    # each package's checkpoint resumes on the OTHER package's server
    with _server("jax", d) as js, _server("torch", d) as ts:
        for ck, srv in ((tc, js), (jc, ts)):
            k = len(ck["tokens"])
            status, events = _read_stream(srv, {
                "prompt": ck["prompt"] + ck["tokens"],
                "max_new_tokens": ck["remaining_tokens"],
                "resume_from": k})
            assert status == 200
            assert [e["index"] for e in events if "token" in e] == \
                list(range(k, 12))
            assert ck["tokens"] + _tokens(events) == want
            assert events[-1]["token_index"] == 12


def test_migrate_tail_has_the_reference_form(bundles):
    """A server drained mid-stream ends the stream with the same
    ``migrate`` tail in both packages."""
    d = bundles["paged"]
    tails = {}
    for pkg, chaos in (("jax", jax_chaos), ("torch", torch_chaos)):
        with _server(pkg, d) as srv:
            chaos.inject("gen.decode.stall", delay=0.05)
            out = {}
            try:
                t = threading.Thread(target=lambda: out.update(
                    r=_read_stream(srv, {"prompt": [7, 1],
                                         "max_new_tokens": 12})))
                t.start()
                deadline = time.monotonic() + HTTP_TIMEOUT
                while srv._gen.active_slots == 0 and \
                        time.monotonic() < deadline:
                    time.sleep(0.01)
                time.sleep(0.12)
                ckpts = srv.drain_sessions(deadline_s=0)
                t.join(HTTP_TIMEOUT)
            finally:
                chaos.clear()
            status, events = out["r"]
            assert status == 200 and len(ckpts) == 1
            tail = events[-1]
            assert torch_validate_event(tail) == []
            assert jax_validate_event(tail) == []
            k = len(_tokens(events))
            assert tail == {"migrate": {"resume_from": k,
                                        "remaining_tokens": 12 - k},
                            "done": True, "token_index": k,
                            "retryable": True}
            tails[pkg] = sorted(tail)
            # a draining replica sheds new sessions, retryably
            st, body = _read_stream(srv, {"prompt": [1]})
            assert (st, body[0]["error"]["type"], body[0]["retryable"]) \
                == (503, "draining", True)
    assert tails["torch"] == tails["jax"]


@pytest.mark.parametrize("kill", ["abort", "drain"])
@pytest.mark.parametrize("owner", ["torch", "jax"])
def test_client_resumes_on_the_other_package(bundles, port_predictors,
                                             kill, owner):
    """The port's ``ServingClient`` over one server of each package: the
    owner of a stream aborts (a retryable error tail) or drains (a
    migrate tail) mid-stream; the client resumes on the other server and
    the finished stream equals the uninterrupted one."""
    d = bundles["paged"]
    prompt = [2, 9, 4]
    want, _ = _reprefill(port_predictors["paged"], prompt, 12)
    with _server("jax", d) as js, _server("torch", d) as ts:
        first, other = (ts, js) if owner == "torch" else (js, ts)
        chaos = torch_chaos if owner == "torch" else jax_chaos
        chaos.inject("gen.decode.stall", delay=0.04)
        try:
            client = torch_serving.ServingClient(
                [_addr(first), _addr(other)], timeout=HTTP_TIMEOUT)
            client._rr = -1      # the first attempt goes to ``first``
            events = []
            for ev in client.generate(prompt, max_new_tokens=12):
                events.append(ev)
                if len(_tokens(events)) == 3:
                    if kill == "abort":
                        first.abort_streams()
                    else:
                        first.drain_sessions(deadline_s=0)
        finally:
            chaos.clear()
    assert [e["index"] for e in events if "token" in e] == list(range(12))
    assert _tokens(events) == want
    assert events[-1]["done"] and not events[-1].get("error")


# ---------------------------------------------------------------------------
# warmup and admission
# ---------------------------------------------------------------------------

def _seed_and_warm(pred, pool):
    """Seed slot 1 from a prefill, warm ``pred`` up; returns the pool
    (``pool(name)`` as numpy) before and after, and the warmup report."""
    prompt = [5, 6, 7, 8, 9]
    logits, kv = pred.prefill(prompt)
    if pred.paged:
        pred.alloc_slot_pages(1, pred.pages_needed(len(prompt), 4))
    pred.write_slot(1, kv, len(prompt))
    before = [pool(n).copy() for n in pred.cache_vars]
    report = pred.warmup()
    return before, [pool(n) for n in pred.cache_vars], report


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_warmup_leaves_the_pool_unchanged(bundles, layout):
    """A live slot's rows survive the port's warmup bit for bit, and the
    port warms the reference's signatures.  The reference's dense warmup
    runs the decode's add-write of a zero one-hot, which keeps every
    value but turns a ``-0.0`` of the seeded row into ``+0.0``; its
    paged pool keeps its bytes."""
    d = bundles[layout]
    pred = GenPredictor(d, place=CPUPlace())
    before, after, report = _seed_and_warm(
        pred, lambda n: pred.cache(n).numpy())
    for b, a, n in zip(before, after, pred.cache_vars):
        assert (a.dtype, a.tobytes()) == (b.dtype, b.tobytes()), n
    jp = JaxPredictor(d)
    jbefore, jafter, want = _seed_and_warm(
        jp, lambda n: np.asarray(jp._scope.find_var(n)))
    for b, a, n in zip(jbefore, jafter, jp.cache_vars):
        moved = b.view(np.int32) != a.view(np.int32)
        assert np.array_equal(a, b), n
        assert bool(np.signbit(b[moved]).all()) and \
            not np.signbit(a[moved]).any() and \
            bool((b[moved] == 0).all()), n
        if jp.paged:
            assert not moved.any(), n
    assert [(b["program"], b["signature"]) for b in report.buckets] == \
        [(b["program"], b["signature"]) for b in want.buckets]
    assert [b["program"] for b in report.buckets].count("decode") == \
        (len([p for p in pred.page_buckets if p <= pred.pages_per_slot])
         if pred.paged else 1)
    assert {b["cache"] for b in report.buckets} == {"warm"}


def test_warmup_failure_fails_readyz_not_a_request(bundles):
    """A failure during the loader thread's warmup (where a kernel build
    that fails would raise; here the ``serving.warmup`` failpoint) lands
    in ``load_error``: ``/readyz`` and ``/generate`` answer 500
    ``model_load_failed`` at once, in both packages."""
    got = {}
    for pkg, chaos in (("jax", jax_chaos), ("torch", torch_chaos)):
        chaos.inject("serving.warmup", error=RuntimeError("build failed"),
                     times=1)
        try:
            with _server(pkg, bundles["paged"], async_load=True) as srv:
                with pytest.raises(RuntimeError, match="build failed"):
                    srv.wait_until_ready(timeout=HTTP_TIMEOUT)
                conn = http.client.HTTPConnection(*srv.addr,
                                                  timeout=HTTP_TIMEOUT)
                try:
                    conn.request("GET", "/readyz")
                    resp = conn.getresponse()
                    readyz = (resp.status, json.loads(resp.read()))
                finally:
                    conn.close()
                got[pkg] = (readyz, _read_stream(srv, {"prompt": [1]}))
        finally:
            chaos.clear()
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == (500, {"error": {
        "type": "model_load_failed", "message": "build failed"},
        "retryable": False})


@pytest.mark.parametrize("admission", ["batch", "continuous"])
def test_admission_policies_give_the_reference_streams(bundles,
                                                       port_predictors,
                                                       admission):
    d = bundles["paged"]
    prompts = _prompts(3, (5, 12, 7, 30, 2, 18))
    streams = {}
    for name, sched in (
            ("jax", JaxScheduler(JaxPredictor(d), admission=admission)),
            ("torch", GenScheduler(port_predictors["paged"],
                                   admission=admission))):
        try:
            subs = [sched.submit(p, max_new_tokens=6) for p in prompts]
            streams[name] = [list(s) for s in subs]
            assert sched.queue_depth == 0 and sched.active_slots == 0
        finally:
            sched.close()
    assert streams["torch"] == streams["jax"]


def test_cost_planners_raise_naming_the_item(bundles, port_predictors):
    """The planners of the static cost model are ported; what they still
    refuse they refuse as the reference does, naming what is missing: the
    page planner needs a paged bundle."""
    for pred in (port_predictors["dense"], JaxPredictor(bundles["dense"])):
        with pytest.raises(ValueError,
                           match="plan_page_buckets needs a paged bundle"):
            pred.plan_page_buckets([3, 9])


def test_cost_planners_match_the_reference(bundles, port_predictors):
    """The planners give the reference's numbers (the full comparison is
    ``tests/test_torch_gen_planners.py``), and the scheduler takes a
    prefill budget."""
    pred = port_predictors["paged"]
    ref = JaxPredictor(bundles["paged"])
    assert pred.prefill_cost(8) == ref.prefill_cost(8)
    assert pred.plan_prompt_buckets([3, 9]) == ref.plan_prompt_buckets([3, 9])
    assert pred.plan_page_buckets([3, 9]) == ref.plan_page_buckets([3, 9])
    sched = GenScheduler(pred, prefill_budget=1e6)
    try:
        assert sched.prefill_budget == 1e6
    finally:
        sched.close()


def test_stream_migrated_is_exported():
    assert issubclass(StreamMigrated, RuntimeError)
