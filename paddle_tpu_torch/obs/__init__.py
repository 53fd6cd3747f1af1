"""Observability spine of the port (its own copies of the JAX package's
``obs`` modules): structured tracing, the flight recorder, Prometheus
exposition, the SLO watchdog, device performance and numerics.

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
- :mod:`paddle_tpu_torch.obs.perf` — one cost record per prepared
  signature, the live MFU gauges (``train.mfu`` / ``gen.decode_mfu``),
  the HBM census (``hbm.*``) with its headroom check, the step-phase
  switch, and ``WarmupReport``.
- :mod:`paddle_tpu_torch.obs.numerics` — per-op tensor-stat probes
  (first non-finite op), bundle localization, and the fused
  training-health norms the sentinel publishes.
- :mod:`paddle_tpu_torch.obs.ledger` — the persistent run ledger: the
  loss, norm, MFU and stall series as JSONL segments that survive the
  process and rewind with a checkpoint (``runs tail|show|compare``).
- :mod:`paddle_tpu_torch.obs.bench_history` — the bench trajectory and
  its regression gate (``bench check|record``), over the port's own
  ``BENCH_TRAJECTORY_TORCH.json``.

The fleet's federated metrics (``obs/aggregate.py``) come with the fleet.

Metric, span and failpoint names are the JAX package's, listed in
``docs/observability.md`` and ``docs/fault_tolerance.md``.
"""

from __future__ import annotations

from paddle_tpu_torch.obs import trace
from paddle_tpu_torch.obs import flight
from paddle_tpu_torch.obs import prom
from paddle_tpu_torch.obs import perf
from paddle_tpu_torch.obs import numerics
from paddle_tpu_torch.obs import slo
from paddle_tpu_torch.obs import ledger
from paddle_tpu_torch.obs import bench_history
from paddle_tpu_torch.obs.trace import (span, record_span, trace_context,
                                        current_trace_id, new_trace_id,
                                        chrome_trace, dump_chrome_trace,
                                        set_process_name, snapshot_payload)
from paddle_tpu_torch.obs.flight import write_postmortem, read_postmortem
from paddle_tpu_torch.obs.prom import render_prometheus
from paddle_tpu_torch.obs.slo import SLOWatchdog, load_spec, validate_spec

__all__ = ["trace", "flight", "prom", "perf", "numerics", "slo",
           "ledger", "bench_history",
           "span", "record_span", "trace_context",
           "current_trace_id", "new_trace_id", "chrome_trace",
           "dump_chrome_trace", "set_process_name", "snapshot_payload",
           "write_postmortem", "read_postmortem", "render_prometheus",
           "SLOWatchdog", "load_spec", "validate_spec"]

# arm the uncaught-exception post-mortem hook iff the operator asked
# for one (PADDLE_TPU_POSTMORTEM); unarmed this changes nothing
flight.install_from_env()
