"""Registry cross-check of the port: every metric name and every chaos
failpoint that ``paddle_tpu_torch/`` emits must be listed in the JAX
package's registries, ``docs/observability.md`` and
``docs/fault_tolerance.md`` — the port emits the reference's names and
no others, so dashboards and drills written for one package read the
other.  The scanners are those of ``tests/test_obs_metric_registry.py``
and ``tests/test_chaos_failpoint_registry.py``, pointed at the port."""

import os
import re

import paddle_tpu_torch

SRC_ROOT = os.path.dirname(os.path.abspath(paddle_tpu_torch.__file__))
DOCS = os.path.join(os.path.dirname(SRC_ROOT), "docs")

_LITERAL = re.compile(
    r"\.(?:inc|observe|bucket|set_gauge)\(\s*[\"']([a-zA-Z0-9_.]+)[\"']")
_LATENCY = re.compile(r"record_latency\(\s*[\"']([a-zA-Z0-9_.]+)[\"']")
_FIRE = re.compile(
    r"\b_?chaos\.fire\(\s*\n?\s*[\"']"
    r"([a-z0-9_]+(?:\.[a-z0-9_]+)+)[\"']")
_SPAN = re.compile(r"\b_?span\(\s*[\"']([a-z0-9_]+(?:\.[a-z0-9_]+)+)[\"']")


def _iter_sources():
    for dirpath, _, names in os.walk(SRC_ROOT):
        for n in sorted(names):
            if n.endswith(".py"):
                with open(os.path.join(dirpath, n)) as f:
                    yield os.path.join(dirpath, n), f.read()


def emitted_metric_names():
    names, series = set(), set()
    for _, text in _iter_sources():
        names.update(_LITERAL.findall(text))
        found = _LATENCY.findall(text)
        series.update(found)
        names.update(found)
    names.update(f"{n}.errors" for n in series)
    return names


def fired_failpoint_names():
    names = set()
    for path, text in _iter_sources():
        if os.path.relpath(path, SRC_ROOT) == os.path.join("fault",
                                                           "chaos.py"):
            continue  # the framework itself, not a fire site
        names.update(_FIRE.findall(text))
    return names


def opened_span_names():
    names = set()
    for _, text in _iter_sources():
        names.update(_SPAN.findall(text))
    return names


def _doc_rows(name, pattern=r"^\|\s*`([a-zA-Z0-9_.<>]+)`\s*\|"):
    with open(os.path.join(DOCS, name)) as f:
        return set(re.findall(pattern, f.read(), flags=re.M))


def _documented_spans():
    """Every dotted name the doc gives in backticks.  A row's shorthand
    (``collective.all_reduce`` / ``.all_gather``, each in backticks)
    names ``collective.all_gather`` too: the prefix of the name before
    it."""
    with open(os.path.join(DOCS, "observability.md")) as f:
        doc = f.read()
    names = set()
    for line in doc.splitlines():
        prefix = None
        for tok in re.findall(r"`(\.?[a-z0-9_]+(?:\.[a-z0-9_]+)*)`", line):
            if tok.startswith("."):
                if prefix is not None:
                    names.add(prefix + tok)
            elif "." in tok:
                names.add(tok)
                prefix = tok.split(".")[0]
    return names


def test_scanners_find_the_serving_front():
    """An over-tight regex silently passing the doc checks is worse than
    a missing row: the load-bearing names must be seen."""
    assert {"serving.requests_ok", "serving.batch_occupancy",
            "serving.request_seconds", "gen.tokens", "gen.ttft_seconds",
            "gen.session.migrations", "warmup.signatures",
            "executor.warmup_seconds", "executor.warmup_seconds.errors",
            "slo.breach"} <= emitted_metric_names()
    assert {"serving.run", "serving.batch", "serving.batcher.crash",
            "serving.load", "serving.warmup", "serving.predict",
            "gen.decode.stall", "gen.client.disconnect"} <= \
        fired_failpoint_names()
    assert {"serving.request", "serving.dispatch", "gen.request",
            "gen.prefill", "gen.decode_step"} <= opened_span_names()


def test_every_emitted_metric_is_in_the_reference_registry():
    documented = _doc_rows("observability.md")
    assert documented
    missing = sorted(
        n for n in emitted_metric_names()
        if n not in documented and not (
            n.endswith(".errors") and "<series>.errors" in documented))
    assert not missing, (
        f"metrics the port emits that docs/observability.md does not "
        f"list: {missing}")


def test_every_fired_failpoint_is_in_the_reference_registry():
    documented = _doc_rows("fault_tolerance.md",
                           r"^\|\s*`([a-z0-9_.]+)`\s*\|")
    assert documented
    missing = sorted(fired_failpoint_names() - documented)
    assert not missing, (
        f"failpoints the port fires that docs/fault_tolerance.md does "
        f"not list: {missing}")


def test_every_opened_span_is_in_the_reference_registry():
    missing = sorted(opened_span_names() - _documented_spans())
    assert not missing, (
        f"spans the port opens that docs/observability.md does not "
        f"name: {missing}")
