"""Prometheus text-exposition rendering of the runtime metrics registry.

The reference exposed its pserver/master counters through Go Prometheus
handlers (``go/pserver/service.go``); here one renderer maps the
process-wide :class:`profiler.RuntimeMetrics` snapshot onto the v0.0.4
text format, served by the inference server's ``/metrics`` endpoint and
``paddle_tpu stats --prom``:

==============  =========================================================
registry kind   exposition mapping
==============  =========================================================
counters        ``paddle_tpu_<name>_total`` (counter)
gauges          ``paddle_tpu_<name>`` (gauge)
series          summary: ``{quantile="0.5|0.95|0.99"}`` + ``_sum`` /
                ``_count`` (window percentiles over the bounded
                reservoir; sum/count are lifetime aggregates)
histograms      histogram: cumulative ``_bucket{le="..."}`` + ``_sum`` /
                ``_count`` (discrete occupancy values as bucket edges)
==============  =========================================================

Dots and other non-metric characters in registry names become ``_``
(``serving.request_seconds`` -> ``paddle_tpu_serving_request_seconds``).
"""

from __future__ import annotations

import re

__all__ = ["render_prometheus", "sanitize_name", "CONTENT_TYPE", "PREFIX"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
PREFIX = "paddle_tpu_"

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")
_LEADING_BAD = re.compile(r"^[^a-zA-Z_:]")


def sanitize_name(name):
    """Registry name -> legal Prometheus metric name (prefixed)."""
    out = _NAME_BAD.sub("_", str(name))
    if _LEADING_BAD.match(out):
        out = "_" + out
    return PREFIX + out


def _fmt(value):
    if value is None:
        return "NaN"
    f = float(value)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _esc_label(value):
    return str(value).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _labelset(labels, **inline):
    """``{a="1",b="2"}`` rendering of fixed labels + per-sample ones
    (``quantile``/``le``); empty when there are none."""
    pairs = list((labels or {}).items()) + list(inline.items())
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_esc_label(v)}"' for k, v in pairs) + "}"


def render_prometheus(snapshot=None, labels=None, emit_meta=True):
    """Render a ``RuntimeMetrics.snapshot()`` (or the live process
    registry when None) as Prometheus text exposition format.

    ``labels`` attaches a fixed label set to EVERY sample (the fleet
    federation path renders each replica's snapshot under its
    ``replica="host:port"`` identity); ``emit_meta=False`` suppresses
    the ``# HELP``/``# TYPE`` comments so a federated exposition can
    declare each family once and append the per-replica sample blocks
    after it.

    Conformance contract (locked by tests/test_obs_prom.py): histogram
    buckets render in ascending ``le`` order with cumulative counts, a
    terminal ``+Inf`` bucket, and ``_count`` equal to the ``+Inf``
    bucket; summaries carry ascending ``quantile`` in [0, 1] plus
    ``_sum``/``_count``; counters end in ``_total``."""
    if snapshot is None:
        from paddle_tpu_torch.profiler import runtime_metrics
        snapshot = runtime_metrics.snapshot()
    lines = []

    def meta(metric, name, kind):
        if emit_meta:
            lines.append(f"# HELP {metric} {name} ({kind})")
            lines.append(f"# TYPE {metric} {kind.split()[-1]}")

    for name, value in sorted((snapshot.get("counters") or {}).items()):
        metric = sanitize_name(name) + "_total"
        meta(metric, name, "counter")
        lines.append(f"{metric}{_labelset(labels)} {_fmt(value)}")

    for name, value in sorted((snapshot.get("gauges") or {}).items()):
        metric = sanitize_name(name)
        meta(metric, name, "gauge")
        lines.append(f"{metric}{_labelset(labels)} {_fmt(value)}")

    for name, s in sorted((snapshot.get("series") or {}).items()):
        metric = sanitize_name(name)
        meta(metric, name, "windowed summary")
        for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            v = s.get(key)
            if v is not None:
                lines.append(f"{metric}{_labelset(labels, quantile=q)} "
                             f"{_fmt(v)}")
        lines.append(f"{metric}_sum{_labelset(labels)} "
                     f"{_fmt(s.get('total', 0.0))}")
        lines.append(f"{metric}_count{_labelset(labels)} "
                     f"{_fmt(s.get('count', 0))}")

    for name, hist in sorted((snapshot.get("histograms") or {}).items()):
        metric = sanitize_name(name)
        meta(metric, name, "histogram")
        total = 0
        weighted = 0.0
        # discrete observed values become cumulative le edges, emitted
        # strictly ascending (numeric sort, not lexicographic)
        for key, count in sorted(hist.items(), key=lambda kv: float(kv[0])):
            total += int(count)
            weighted += float(key) * int(count)
            lines.append(f"{metric}_bucket{_labelset(labels, le=key)} "
                         f"{_fmt(total)}")
        lines.append(f'{metric}_bucket{_labelset(labels, le="+Inf")} '
                     f"{_fmt(total)}")
        lines.append(f"{metric}_sum{_labelset(labels)} {_fmt(weighted)}")
        lines.append(f"{metric}_count{_labelset(labels)} {_fmt(total)}")

    return "\n".join(lines) + "\n"
