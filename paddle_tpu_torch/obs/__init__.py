"""Observability spine of the port (its own copies of the JAX package's
standard-library modules): structured tracing, the flight recorder,
Prometheus exposition, the SLO watchdog and the warmup report.

- :mod:`paddle_tpu_torch.obs.trace` — spans with contextvar nesting and
  trace-context propagation, recorded into a bounded ring
  (``PADDLE_TPU_TRACE``), exported as Chrome trace-event JSON
  (``/trace``).
- :mod:`paddle_tpu_torch.obs.flight` — post-mortem dumps of the span
  tail + metrics snapshot (``PADDLE_TPU_POSTMORTEM``).
- :mod:`paddle_tpu_torch.obs.prom` — Prometheus text exposition of the
  runtime metrics (``/metrics``).
- :mod:`paddle_tpu_torch.obs.slo` — declarative SLO specs
  (``PADDLE_TPU_SLO``) evaluated over the runtime metrics.
- :mod:`paddle_tpu_torch.obs.perf` — ``WarmupReport``.

Metric, span and failpoint names are the JAX package's, listed in
``docs/observability.md`` and ``docs/fault_tolerance.md``.
"""

from __future__ import annotations

from paddle_tpu_torch.obs import trace
from paddle_tpu_torch.obs import flight
from paddle_tpu_torch.obs import prom
from paddle_tpu_torch.obs import perf
from paddle_tpu_torch.obs import slo
from paddle_tpu_torch.obs.trace import (span, record_span, trace_context,
                                        current_trace_id, new_trace_id,
                                        chrome_trace, dump_chrome_trace,
                                        set_process_name, snapshot_payload)
from paddle_tpu_torch.obs.flight import write_postmortem, read_postmortem
from paddle_tpu_torch.obs.prom import render_prometheus
from paddle_tpu_torch.obs.slo import SLOWatchdog, load_spec, validate_spec

__all__ = ["trace", "flight", "prom", "perf", "slo",
           "span", "record_span", "trace_context",
           "current_trace_id", "new_trace_id", "chrome_trace",
           "dump_chrome_trace", "set_process_name", "snapshot_payload",
           "write_postmortem", "read_postmortem", "render_prometheus",
           "SLOWatchdog", "load_spec", "validate_spec"]

# arm the uncaught-exception post-mortem hook iff the operator asked
# for one (PADDLE_TPU_POSTMORTEM); unarmed this changes nothing
flight.install_from_env()
