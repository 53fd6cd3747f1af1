"""The serving planners of the port against the JAX package's, on the
same bundles (exported by the JAX package, loaded by both): the static
prefill cost at every bucket, the cost-optimal prompt and page buckets,
``GenScheduler(prefill_budget=...)`` admitting in the same passes and
streaming the same tokens for a scripted arrival order, and
``InferenceServer(gen_prefill_budget=...)`` over HTTP on the CPU.  Costs
and edges are compared exactly, tokens too."""

import http.client
import json
import threading

import numpy as np
import pytest

from paddle_tpu.gen import GenPredictor as JaxPredictor
from paddle_tpu.gen import GenScheduler as JaxScheduler
from paddle_tpu.models import gen_lm as jax_gen_lm
from paddle_tpu_torch import CPUPlace
from paddle_tpu_torch import serving as torch_serving
from paddle_tpu_torch.gen import GenPredictor, GenScheduler
from paddle_tpu_torch.profiler import runtime_metrics

HTTP_TIMEOUT = 30
NUM_SLOTS = 4
MAX_NEW = 6
#: the scripted arrival order: more prompts than slots, mixed buckets
PROMPT_LENS = (5, 12, 7, 30, 2, 18)
OBSERVED = [3] * 20 + [9] * 8 + [15] * 4 + [40] * 3 + [61] * 2


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    out = {}
    for layout in ("paged", "dense"):
        d = str(tmp_path_factory.mktemp("torch_planners") / layout)
        jax_gen_lm.export_gen_model(d, jax_gen_lm.GenConfig(),
                                    num_slots=NUM_SLOTS,
                                    paged=layout == "paged")
        out[layout] = d
    return out


@pytest.fixture(scope="module")
def predictors(bundles):
    return {k: (JaxPredictor(d), GenPredictor(d, place=CPUPlace()))
            for k, d in bundles.items()}


def _prompts(seed=3, lens=PROMPT_LENS):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(0, 64, n)] for n in lens]


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_prefill_cost_at_every_bucket(predictors, layout):
    jp, tp = predictors[layout]
    lengths = sorted({1, tp.max_prompt_len} | set(tp.prompt_buckets) |
                     {b - 1 for b in tp.prompt_buckets if b > 1} |
                     {b + 1 for b in tp.prompt_buckets
                      if b < tp.max_prompt_len})
    got = [tp.prefill_cost(n) for n in lengths]
    assert got == [jp.prefill_cost(n) for n in lengths]
    assert got == sorted(got) and got[0] > 0
    # memoized per (bucket[, pages])
    assert tp.prefill_cost(lengths[-1]) == got[-1]
    assert tp._prefill_cost


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_plan_prompt_buckets(predictors, layout):
    jp, tp = predictors[layout]
    for max_edges in (1, 2, 4):
        got = tp.plan_prompt_buckets(OBSERVED, max_edges=max_edges)
        assert got == jp.plan_prompt_buckets(OBSERVED, max_edges=max_edges)
        assert got and all(e <= tp.max_len for e in got)


def test_plan_page_buckets(predictors):
    jp, tp = predictors["paged"]
    for max_edges in (1, 2, 4):
        got = tp.plan_page_buckets(OBSERVED, max_edges=max_edges)
        assert got == jp.plan_page_buckets(OBSERVED, max_edges=max_edges)
    _, dense = predictors["dense"]
    with pytest.raises(ValueError, match="paged bundle"):
        dense.plan_page_buckets(OBSERVED)


def _traced(pred, trace):
    """Record the predictor's prefills (by prompt length) and decode
    steps, in the order the scheduler runs them."""
    prefill, decode = pred.prefill, pred.decode_step

    def traced_prefill(prompt):
        trace.append(("prefill", len(prompt)))
        return prefill(prompt)

    def traced_decode(*a, **kw):
        trace.append(("decode",))
        return decode(*a, **kw)

    pred.prefill, pred.decode_step = traced_prefill, traced_decode
    return lambda: (setattr(pred, "prefill", prefill),
                    setattr(pred, "decode_step", decode))


def _passes(trace):
    """The admission passes: runs of prefills between decode steps."""
    out, cur = [], []
    for ev in trace:
        if ev[0] == "prefill":
            cur.append(ev[1])
        elif cur:
            out.append(cur)
            cur = []
    return out + ([cur] if cur else [])


def _budgeted_run(sched_cls, pred, budget, prompts):
    trace = []
    restore = _traced(pred, trace)
    runtime_metrics.reset()
    sched = sched_cls(pred, prefill_budget=budget)
    try:
        # every request arrives before the first admission pass: the
        # scheduler thread waits on the condition the test holds
        with sched._cv:
            subs = [sched.submit(p, max_new_tokens=MAX_NEW)
                    for p in prompts]
        streams = [list(s) for s in subs]
    finally:
        sched.close()
        restore()
    return streams, _passes(trace)


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_budgeted_scheduler_admits_like_the_reference(predictors, layout):
    jp, tp = predictors[layout]
    prompts = _prompts()
    budget = tp.prefill_cost(max(PROMPT_LENS))
    assert budget == jp.prefill_cost(max(PROMPT_LENS))
    want, want_passes = _budgeted_run(JaxScheduler, jp, budget, prompts)
    got, got_passes = _budgeted_run(GenScheduler, tp, budget, prompts)
    snap = runtime_metrics.snapshot()["series"]["gen.admission_cost"]
    assert got == want
    assert got_passes == want_passes
    assert snap["count"] == len(prompts)
    # the budget binds: the first pass admits fewer than the free slots
    assert len(got_passes[0]) < NUM_SLOTS
    assert sorted(n for p in got_passes for n in p) == sorted(PROMPT_LENS)
    unbudgeted = GenScheduler(tp)
    try:
        plain = [list(unbudgeted.submit(p, max_new_tokens=MAX_NEW))
                 for p in prompts]
    finally:
        unbudgeted.close()
    assert got == plain


def test_budget_is_continuous_only(predictors):
    _, tp = predictors["dense"]
    for admission, want in (("batch", None), ("continuous", 5.0)):
        s = GenScheduler(tp, admission=admission, prefill_budget=5.0)
        try:
            assert s.prefill_budget == want
        finally:
            s.close()


def _stream(addr, prompt):
    conn = http.client.HTTPConnection(*addr, timeout=HTTP_TIMEOUT)
    try:
        conn.request("POST", "/generate",
                     json.dumps({"prompt": prompt,
                                 "max_new_tokens": MAX_NEW}).encode(),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        return [json.loads(line)["token"] for line in resp.read().split(
            b"\n") if line and "token" in json.loads(line)]
    finally:
        conn.close()


def test_server_with_a_prefill_budget_over_http(bundles, predictors):
    _, tp = predictors["paged"]
    prompts = _prompts(seed=5)
    budget = tp.prefill_cost(max(PROMPT_LENS))
    want = {}
    sched = GenScheduler(tp)
    try:
        for i, p in enumerate(prompts):
            want[i] = list(sched.submit(p, max_new_tokens=MAX_NEW))
    finally:
        sched.close()
    runtime_metrics.reset()
    srv = torch_serving.InferenceServer(bundles["paged"], place=CPUPlace(),
                                        warmup=True,
                                        gen_prefill_budget=budget)
    srv.start_background()
    try:
        assert srv._ready.wait(HTTP_TIMEOUT)
        assert srv._gen.prefill_budget == budget
        got, errors = {}, []

        def one(i, p):
            try:
                got[i] = _stream(srv.addr, p)
            except Exception as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=one, args=(i, p))
                   for i, p in enumerate(prompts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(HTTP_TIMEOUT)
    finally:
        srv.shutdown()
    assert not errors, errors
    assert got == want
    snap = runtime_metrics.snapshot()["series"]
    assert snap["gen.admission_cost"]["count"] == len(prompts)
