"""Multi-replica serving fleet of the port (``paddle_tpu.fleet``'s):
master-backed discovery, health-aware routing, and chaos-proof failover.

The reference framework's production story is a *cluster* — trainers
and pservers coordinated by a Go master with leases and fault
tolerance (``go/master/service.go``).  This package re-aims that
machinery at inference:

- :class:`~paddle_tpu_torch.fleet.replica.FleetReplica` — an
  :class:`~paddle_tpu_torch.serving.InferenceServer` that registers with the
  master on readiness and renews a TTL lease via heartbeat; an expired
  lease = unhealthy, dropped from the routing table, and `/readyz`
  answers ``503 lease_lost`` while the process is alive.
- :class:`~paddle_tpu_torch.fleet.router.FleetRouter` — a thin front-end
  that discovers live replicas from the master, spreads traffic by
  least-outstanding requests, and retries failed attempts on a
  *different* replica under a full-jitter
  :class:`~paddle_tpu_torch.fault.RetryPolicy`, bounded end to end by the
  caller's ``X-Deadline-Ms`` budget; ``X-Request-Id`` makes one
  request traceable across replicas.
- the client-side alternative: ``ServingClient(master=...)`` (or a
  list of addresses) balances and fails over without a router hop.
- :class:`~paddle_tpu_torch.fleet.controller.FleetController` — the closed
  control loop: SLO pressure and scraper rollups in, scale-up from a
  warm-standby pool / idle drain / admission-control backpressure
  (429 + Retry-After via the router's degradation ladder) out.
- :class:`~paddle_tpu_torch.fleet.traffic.TrafficReplay` — the load side:
  open-loop traffic replay (diurnal ramps, flash crowds, heavy-tailed
  prompt mixes) that drills the control loop under chaos.

See ``docs/serving_fleet.md`` for topology, failover semantics, the
rolling-restart runbook, the autoscaling/backpressure runbook, and
the chaos drills.
"""

from __future__ import annotations

from paddle_tpu_torch.fleet.controller import ControllerPolicy, \
    FleetController, load_policy
from paddle_tpu_torch.fleet.replica import FleetReplica
from paddle_tpu_torch.fleet.router import FleetRouter
from paddle_tpu_torch.fleet.sessions import SessionTable, new_session_id, \
    validate_checkpoint, validate_stream_event
from paddle_tpu_torch.fleet.traffic import TrafficReplay

__all__ = ["FleetReplica", "FleetRouter", "FleetController",
           "ControllerPolicy", "load_policy", "SessionTable",
           "TrafficReplay", "new_session_id", "validate_checkpoint",
           "validate_stream_event"]
