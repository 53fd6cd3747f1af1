"""Closed-loop fleet controller: SLO pressure in, scaling and
admission-control actions out.

The :class:`~paddle_tpu_torch.obs.slo.SLOWatchdog` *detects* (breach log,
post-mortems) and the :class:`~paddle_tpu_torch.obs.aggregate.FleetScraper`
*observes* (per-replica RPS/MFU/HBM rollups); this module closes the
loop — the missing "act" half of the reference framework's
fault-tolerant-cluster story.  One :class:`FleetController` per fleet
runs a periodic reconcile tick:

1. **Sense** — one federation scrape (demand = the scraper's counter-
   delta RPS), one watchdog evaluation (pressure = the worst
   value-vs-threshold margin across objectives, a *continuous* signal
   available BEFORE the binary breach fires).
2. **Degrade** — map pressure onto a graceful-degradation ladder:
   :meth:`FleetRouter.set_admission` sheds a growing fraction of
   arrivals with ``429`` + ``Retry-After`` (clamped to each caller's
   ``X-Deadline-Ms``) instead of queueing them into a timeout.  The
   ladder climbs one rung per pressured tick but descends only after
   ``recover_ticks`` consecutive healthy ticks — hysteresis, so a
   p99 hovering at the threshold cannot flap the fleet.
3. **Scale up** — on sustained pressure, promote a replica from the
   warm-standby pool: standbys are :meth:`FleetReplica.warm`-ed ahead
   of time (``warmup=True`` builds every kernel and prompt/page bucket
   on the device before the standby reports ready), so scale-up is an
   :meth:`FleetReplica.enroll` — a lease registration, not a warmup.
4. **Scale down** — on sustained idleness, drain the most recently
   promoted replica via the rolling-restart
   :meth:`FleetReplica.drain` path (finish in-flight, then leave).
5. **Replenish** — keep the standby pool at its target size with a
   background warm thread.

Placement stays in the router (least-outstanding with an HBM-headroom
tie-break from the same scrapes); the controller only changes how many
replicas there are and how many requests get in the door.

The policy is a small JSON document mirroring the SLO-spec pattern
(``PADDLE_TPU_AUTOSCALE=/path/policy.json`` arms it for the CLI;
``paddle_tpu_torch selfcheck`` validates the schema statically).

Failpoints (chaos drills, registry in ``docs/fault_tolerance.md``):
``fleet.scale.stall`` fires per scale-up decision (armed ``error``:
the promotion is lost this tick — the drill for an exhausted machine
pool); ``fleet.standby.fail`` fires per standby warm attempt (armed
``error``: the warm fails and is retried next tick — the drill for a
standby host that dies mid-provision).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time

from paddle_tpu_torch.obs.trace import span as _span

logger = logging.getLogger(__name__)

__all__ = ["FleetController", "ControllerPolicy", "load_policy",
           "validate_policy", "policy_from_env", "POLICY_ENV",
           "EXAMPLE_POLICY"]

POLICY_ENV = "PADDLE_TPU_AUTOSCALE"
POLICY_VERSION = 1

# the documented policy shape — selfcheck validates this constant so
# the schema validator itself is exercised even when no policy is armed
EXAMPLE_POLICY = {
    "version": 1,
    "interval_seconds": 1.0,
    "min_replicas": 1,
    "max_replicas": 4,
    "standby_pool": 1,
    "ready_timeout_seconds": 300.0,
    "scale_up": {
        "pressure_ratio": 0.8,
        "sustained_ticks": 2,
        "cooldown_seconds": 10.0,
    },
    "scale_down": {
        "idle_rps_per_replica": 0.5,
        "sustained_ticks": 10,
        "cooldown_seconds": 30.0,
    },
    "degrade": {
        "ladder": [0.0, 0.25, 0.5, 0.75],
        "engage_ratio": 0.95,
        "recover_ticks": 3,
        "retry_after_seconds": 1.0,
    },
}


def _is_number(v):
    return isinstance(v, (int, float)) and not isinstance(v, bool) \
        and v == v and abs(v) != float("inf")


def _is_count(v, minimum=0):
    return isinstance(v, int) and not isinstance(v, bool) and v >= minimum


def validate_policy(obj):
    """Schema problems of a controller policy dict, as a list of
    strings (empty = valid).  Never raises — selfcheck renders the
    list, mirroring :func:`paddle_tpu_torch.obs.slo.validate_spec`."""
    problems = []
    if not isinstance(obj, dict):
        return [f"policy must be a JSON object, "
                f"got {type(obj).__name__}"]
    if obj.get("version") != POLICY_VERSION:
        problems.append(f"version must be {POLICY_VERSION}, "
                        f"got {obj.get('version')!r}")
    for key in ("interval_seconds", "ready_timeout_seconds"):
        if key in obj and (not _is_number(obj[key]) or obj[key] <= 0):
            problems.append(f"{key} must be a positive number")
    for key in ("min_replicas", "max_replicas", "standby_pool"):
        if key in obj and not _is_count(
                obj[key], minimum=0 if key == "standby_pool" else 1):
            problems.append(
                f"{key} must be an integer >= "
                f"{0 if key == 'standby_pool' else 1}")
    lo = obj.get("min_replicas", 1)
    hi = obj.get("max_replicas", 4)
    if _is_count(lo, 1) and _is_count(hi, 1) and lo > hi:
        problems.append("min_replicas must be <= max_replicas")

    up = obj.get("scale_up", {})
    if not isinstance(up, dict):
        problems.append("scale_up must be an object")
        up = {}
    if "pressure_ratio" in up and (
            not _is_number(up["pressure_ratio"])
            or up["pressure_ratio"] <= 0):
        problems.append("scale_up.pressure_ratio must be > 0")
    if "sustained_ticks" in up and not _is_count(up["sustained_ticks"], 1):
        problems.append("scale_up.sustained_ticks must be an "
                        "integer >= 1")
    if "cooldown_seconds" in up and (
            not _is_number(up["cooldown_seconds"])
            or up["cooldown_seconds"] < 0):
        problems.append("scale_up.cooldown_seconds must be >= 0")

    down = obj.get("scale_down", {})
    if not isinstance(down, dict):
        problems.append("scale_down must be an object")
        down = {}
    if "idle_rps_per_replica" in down and (
            not _is_number(down["idle_rps_per_replica"])
            or down["idle_rps_per_replica"] < 0):
        problems.append("scale_down.idle_rps_per_replica must be >= 0")
    if "sustained_ticks" in down and \
            not _is_count(down["sustained_ticks"], 1):
        problems.append("scale_down.sustained_ticks must be an "
                        "integer >= 1")
    if "cooldown_seconds" in down and (
            not _is_number(down["cooldown_seconds"])
            or down["cooldown_seconds"] < 0):
        problems.append("scale_down.cooldown_seconds must be >= 0")

    deg = obj.get("degrade", {})
    if not isinstance(deg, dict):
        problems.append("degrade must be an object")
        deg = {}
    ladder = deg.get("ladder")
    if ladder is not None:
        if not isinstance(ladder, list) or not ladder or \
                not all(_is_number(f) and 0 <= f <= 1 for f in ladder):
            problems.append("degrade.ladder must be a non-empty list of "
                            "shed fractions in [0, 1]")
        elif ladder[0] != 0:
            problems.append("degrade.ladder[0] must be 0 (level 0 "
                            "admits everything)")
        elif any(b < a for a, b in zip(ladder, ladder[1:])):
            problems.append("degrade.ladder must be non-decreasing")
    if "engage_ratio" in deg and (
            not _is_number(deg["engage_ratio"])
            or deg["engage_ratio"] <= 0):
        problems.append("degrade.engage_ratio must be > 0")
    if "recover_ticks" in deg and not _is_count(deg["recover_ticks"], 1):
        problems.append("degrade.recover_ticks must be an integer >= 1")
    if "retry_after_seconds" in deg and (
            not _is_number(deg["retry_after_seconds"])
            or deg["retry_after_seconds"] < 0):
        problems.append("degrade.retry_after_seconds must be >= 0")

    known = {"version", "interval_seconds", "min_replicas",
             "max_replicas", "standby_pool", "ready_timeout_seconds",
             "scale_up", "scale_down", "degrade", "description"}
    unknown = set(obj) - known
    if unknown:
        problems.append(f"unknown keys {sorted(unknown)}")
    for section, keys in (
            ("scale_up", {"pressure_ratio", "sustained_ticks",
                          "cooldown_seconds"}),
            ("scale_down", {"idle_rps_per_replica", "sustained_ticks",
                            "cooldown_seconds"}),
            ("degrade", {"ladder", "engage_ratio", "recover_ticks",
                         "retry_after_seconds"})):
        sec = obj.get(section)
        if isinstance(sec, dict):
            unknown = set(sec) - keys
            if unknown:
                problems.append(f"{section}: unknown keys "
                                f"{sorted(unknown)}")
    return problems


class ControllerPolicy:
    """A validated controller policy; construct via
    :func:`load_policy`.  Missing knobs take :data:`EXAMPLE_POLICY`'s
    defaults, so a policy file only states what it changes."""

    def __init__(self, obj, source=None):
        problems = validate_policy(obj)
        if problems:
            raise ValueError(
                "invalid controller policy"
                + (f" ({source})" if source else "") + ":\n  "
                + "\n  ".join(problems))
        self.source = source
        self.interval = float(obj.get(
            "interval_seconds", EXAMPLE_POLICY["interval_seconds"]))
        self.min_replicas = int(obj.get(
            "min_replicas", EXAMPLE_POLICY["min_replicas"]))
        self.max_replicas = int(obj.get(
            "max_replicas", EXAMPLE_POLICY["max_replicas"]))
        self.standby_pool = int(obj.get(
            "standby_pool", EXAMPLE_POLICY["standby_pool"]))
        self.ready_timeout = float(obj.get(
            "ready_timeout_seconds",
            EXAMPLE_POLICY["ready_timeout_seconds"]))
        self.scale_up = dict(EXAMPLE_POLICY["scale_up"],
                             **(obj.get("scale_up") or {}))
        self.scale_down = dict(EXAMPLE_POLICY["scale_down"],
                               **(obj.get("scale_down") or {}))
        self.degrade = dict(EXAMPLE_POLICY["degrade"],
                            **(obj.get("degrade") or {}))

    def to_dict(self):
        return {"version": POLICY_VERSION,
                "interval_seconds": self.interval,
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "standby_pool": self.standby_pool,
                "ready_timeout_seconds": self.ready_timeout,
                "scale_up": dict(self.scale_up),
                "scale_down": dict(self.scale_down),
                "degrade": dict(self.degrade)}


def load_policy(policy):
    """Coerce a path / dict / ControllerPolicy into a
    :class:`ControllerPolicy`; raises ``ValueError`` naming every
    schema problem."""
    if isinstance(policy, ControllerPolicy):
        return policy
    if isinstance(policy, dict):
        return ControllerPolicy(policy)
    with open(policy) as f:
        try:
            obj = json.load(f)
        except ValueError as e:
            raise ValueError(f"invalid controller policy ({policy}): "
                             f"not JSON: {e}")
    return ControllerPolicy(obj, source=str(policy))


def policy_from_env():
    """A :class:`ControllerPolicy` from ``PADDLE_TPU_AUTOSCALE``, or
    None when the env var is unset.  A malformed file WARNS and
    disarms (selfcheck is the static gate that fails it loudly)."""
    path = os.environ.get(POLICY_ENV, "").strip()
    if not path:
        return None
    try:
        return load_policy(path)
    except (OSError, ValueError) as e:
        import warnings
        warnings.warn(f"{POLICY_ENV}={path!r} did not load — fleet "
                      f"controller policy disarmed: {e}")
        return None


class FleetController:
    """The reconcile loop over one :class:`FleetRouter`'s fleet.

    ``standby_factory`` is a zero-argument callable returning an
    UNSTARTED :class:`~paddle_tpu_torch.fleet.replica.FleetReplica`; the
    controller warms it into the standby pool and enrolls it on
    scale-up.  Without a factory the controller still runs the
    degradation ladder and scale-DOWN of replicas it owns — it just
    cannot add capacity.

    ``watchdog`` defaults to the router's own SLO watchdog; the
    controller drives :meth:`SLOWatchdog.maybe_evaluate` from its tick
    (interval-gated, so sharing the watchdog with the router's
    background thread never double-evaluates a window).

    Thread-safety: the public surface (:meth:`tick`, :meth:`state`,
    :meth:`prewarm`, :meth:`shutdown`) may be called from any thread;
    replica promotion/drain happen outside the controller lock so a
    slow drain can never block ``state()`` probes.
    """

    def __init__(self, router, policy=None, standby_factory=None,
                 watchdog=None, metrics=None):
        if policy is None:
            policy = policy_from_env()
        self.policy = load_policy(policy) if policy is not None \
            else ControllerPolicy(dict(EXAMPLE_POLICY))
        self.router = router
        self._standby_factory = standby_factory
        self._watchdog = watchdog if watchdog is not None \
            else getattr(router, "_slo", None)
        if metrics is None:
            from paddle_tpu_torch.profiler import runtime_metrics
            metrics = runtime_metrics
        self._metrics = metrics
        self._lock = threading.Lock()
        self._standbys = []       # warmed, NOT enrolled
        self._owned = []          # enrolled by this controller (LIFO)
        self._warming = False     # one background warm at a time
        self._level = 0           # current degradation rung
        self._healthy_ticks = 0   # consecutive ticks below engage_ratio
        self._pressure_ticks = 0  # consecutive ticks above pressure_ratio
        self._idle_ticks = 0      # consecutive idle-rate ticks
        self._last_scale_up = float("-inf")
        self._last_scale_down = float("-inf")
        self.last_pressure = 0.0
        self.last_rps = None
        self._stop = threading.Event()
        self._thread = None

    # -- sensing -----------------------------------------------------------
    def _pressure(self, values):
        """The worst value-vs-threshold margin across the watchdog's
        last pass, normalized so 1.0 = at the threshold and >1 =
        breaching.  ``max``-style objectives (quantile, error_rate)
        contribute ``value / threshold``; ``rate_floor`` contributes
        ``threshold / value`` (a rate at half its floor reads 2.0).
        Windows with nothing to judge contribute nothing."""
        worst = 0.0
        for v in values or []:
            value, threshold = v.get("value"), v.get("threshold")
            if value is None or threshold is None:
                continue
            if v.get("kind") == "rate_floor":
                ratio = float("inf") if value <= 0 \
                    else threshold / value
            else:
                ratio = (float("inf") if threshold <= 0 and value > 0
                         else (value / threshold if threshold > 0
                               else 0.0))
            worst = max(worst, ratio)
        return worst

    # -- the reconcile tick ------------------------------------------------
    def tick(self):
        """One sense -> degrade -> scale pass; returns a summary dict
        (also retained for :meth:`state`)."""
        t0 = time.perf_counter()
        self._metrics.inc("controller.ticks")
        with _span("controller.tick"):
            scraper = self.router._scraper
            scrapes = scraper.scrape()
            rps, _tps = scraper.rates(scrapes)
            values = []
            if self._watchdog is not None:
                self._watchdog.maybe_evaluate()
                values = self._watchdog.last_values()
            pressure = self._pressure(values)
            self.last_pressure = pressure
            self.last_rps = rps
            self._update_ladder(pressure)
            promoted = self._maybe_scale_up(pressure)
            drained = self._maybe_scale_down(rps)
            self._ensure_standbys()
            with self._lock:
                self._metrics.set_gauge("controller.standbys_ready",
                                        len(self._standbys))
        self._metrics.observe("controller.tick_seconds",
                              time.perf_counter() - t0)
        return {"pressure": pressure, "rps": rps,
                "degrade_level": self._level,
                "promoted": promoted, "drained": drained}

    # -- graceful degradation ----------------------------------------------
    def _update_ladder(self, pressure):
        deg = self.policy.degrade
        ladder = deg["ladder"]
        stepped = False
        if pressure >= deg["engage_ratio"]:
            self._healthy_ticks = 0
            if self._level < len(ladder) - 1:
                self._level += 1
                stepped = True
        else:
            self._healthy_ticks += 1
            # hysteresis: climb immediately, descend only after
            # recover_ticks consecutive healthy ticks — the flap damper
            if self._level > 0 and \
                    self._healthy_ticks >= deg["recover_ticks"]:
                self._level -= 1
                self._healthy_ticks = 0
                stepped = True
        if stepped:
            self._metrics.inc("controller.degrade_steps")
        self._metrics.set_gauge("controller.degrade_level", self._level)
        self.router.set_admission(
            self._level, ladder[self._level],
            retry_after_s=deg["retry_after_seconds"],
            reason=f"slo pressure {pressure:.2f}" if self._level
            else "")

    # -- scale up ----------------------------------------------------------
    def _maybe_scale_up(self, pressure):
        up = self.policy.scale_up
        if pressure >= up["pressure_ratio"]:
            self._pressure_ticks += 1
        else:
            self._pressure_ticks = 0
            return None
        if self._pressure_ticks < up["sustained_ticks"]:
            return None
        now = time.monotonic()
        if now - self._last_scale_up < up["cooldown_seconds"]:
            return None
        if len(self.router.live_replicas()) >= self.policy.max_replicas:
            return None
        return self.scale_up(reason=f"slo pressure {pressure:.2f} for "
                                    f"{self._pressure_ticks} ticks")

    def scale_up(self, reason=""):
        """Promote one warm standby into the serving fleet (enroll =
        register + heartbeat; the router discovers it on its next
        poll).  Falls back to a synchronous warm when the pool is
        empty.  Returns the promoted replica, or None when promotion
        was impossible this tick (no factory, warm failure, or the
        ``fleet.scale.stall`` drill)."""
        from paddle_tpu_torch.fault import chaos
        with _span("controller.scale_up", reason=reason):
            try:
                chaos.fire("fleet.scale.stall", reason=reason)
            except chaos.FaultInjected:
                # the machine-pool-exhausted drill: the decision is
                # lost this tick, pressure keeps it coming back
                self._metrics.inc("controller.scale_stalls")
                logger.warning("fleet.scale.stall fired: scale-up "
                               "lost this tick (%s)", reason)
                return None
            with self._lock:
                replica = self._standbys.pop() if self._standbys \
                    else None
            if replica is None:
                # cold fallback: no standby ready (warm thread still
                # working, or the pool is disabled) — pay the warm now
                # rather than not scaling at all
                replica = self._warm_one()
                if replica is None:
                    return None
            try:
                replica.enroll()
            except Exception:
                logger.exception("scale-up enroll failed for replica "
                                 "%s", replica.replica_id)
                try:
                    replica.drain()
                except Exception:
                    pass
                return None
            with self._lock:
                self._owned.append(replica)
            self._last_scale_up = time.monotonic()
            self._pressure_ticks = 0
            self._metrics.inc("controller.scale_ups")
            logger.info("scaled up: replica %s enrolled (%s)",
                        replica.replica_id, reason or "manual")
            return replica

    # -- scale down --------------------------------------------------------
    def _maybe_scale_down(self, rps):
        down = self.policy.scale_down
        live = len(self.router.live_replicas())
        with self._lock:
            owned = len(self._owned)
        if rps is None or live <= self.policy.min_replicas or not owned \
                or self._level > 0:
            # never drain while degraded: shedding + shrinking at the
            # same time is how oscillation starts
            self._idle_ticks = 0
            return None
        if rps / max(1, live) > down["idle_rps_per_replica"]:
            self._idle_ticks = 0
            return None
        self._idle_ticks += 1
        if self._idle_ticks < down["sustained_ticks"]:
            return None
        now = time.monotonic()
        if now - self._last_scale_down < down["cooldown_seconds"]:
            return None
        with self._lock:
            replica = self._owned.pop() if self._owned else None
        if replica is None:
            return None
        # LIFO: the most recently promoted replica leaves first — the
        # longest-lived replicas keep the warmest caches
        with _span("controller.drain", replica=replica.replica_id):
            try:
                replica.drain()
            except Exception:
                logger.exception("scale-down drain failed for replica "
                                 "%s", replica.replica_id)
        self._last_scale_down = now
        self._idle_ticks = 0
        self._metrics.inc("controller.scale_downs")
        logger.info("scaled down: replica %s drained",
                    replica.replica_id)
        return replica

    # -- standby pool ------------------------------------------------------
    def _warm_one(self):
        """Warm one standby through the factory.  Returns the warmed
        replica or None on failure — including the
        ``fleet.standby.fail`` drill."""
        from paddle_tpu_torch.fault import chaos
        if self._standby_factory is None:
            return None
        replica = None
        try:
            chaos.fire("fleet.standby.fail")
            replica = self._standby_factory()
            replica.warm(self.policy.ready_timeout)
            self._metrics.inc("controller.standbys_warmed")
            return replica
        except Exception:
            self._metrics.inc("controller.standby_warm_failures")
            logger.exception("standby warm failed")
            if replica is not None:
                try:
                    replica.drain()
                except Exception:
                    pass
            return None

    def _ensure_standbys(self):
        """Keep the standby pool at its target size, one background
        warm at a time — a warm is seconds (a model load and its
        warmup), and the tick must never block on it."""
        with self._lock:
            if (self._warming or self._standby_factory is None
                    or len(self._standbys) >= self.policy.standby_pool):
                return
            self._warming = True

        def work():
            try:
                replica = self._warm_one()
                if replica is not None:
                    with self._lock:
                        self._standbys.append(replica)
            finally:
                with self._lock:
                    self._warming = False

        threading.Thread(target=work, daemon=True,
                         name="fleet-standby-warm").start()

    def prewarm(self, count=None, raise_on_failure=True):
        """Synchronously fill the standby pool (``count`` defaults to
        the policy's ``standby_pool``) — the pre-launch step that makes
        the FIRST scale-up warm too.  Returns the number warmed."""
        want = self.policy.standby_pool if count is None else int(count)
        warmed = 0
        while True:
            with self._lock:
                if len(self._standbys) >= want:
                    break
            replica = self._warm_one()
            if replica is None:
                if raise_on_failure:
                    raise RuntimeError(
                        "standby prewarm failed (no factory, warm "
                        "error, or fleet.standby.fail armed)")
                break
            with self._lock:
                self._standbys.append(replica)
            warmed += 1
        with self._lock:
            self._metrics.set_gauge("controller.standbys_ready",
                                    len(self._standbys))
        return warmed

    # -- state / lifecycle -------------------------------------------------
    def state(self):
        """JSON-able controller summary (for tests, the CLI, and
        operator probes)."""
        with self._lock:
            standbys = [r.replica_id for r in self._standbys]
            owned = [r.replica_id for r in self._owned]
        return {"policy": self.policy.to_dict(),
                "degrade_level": self._level,
                "admission": self.router.admission_state(),
                "pressure": self.last_pressure,
                "rps": self.last_rps,
                "standbys": standbys,
                "owned": owned,
                "live_replicas": len(self.router.live_replicas())}

    def start(self, interval=None):
        """Background reconcile thread; idempotent."""
        if self._thread is not None:
            return self._thread
        period = float(interval if interval is not None
                       else self.policy.interval)

        def loop():
            while not self._stop.wait(period):
                try:
                    self.tick()
                except Exception:  # pragma: no cover - must never die
                    logger.exception("fleet controller tick failed")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="fleet-controller")
        self._thread.start()
        return self._thread

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def shutdown(self, drain_owned=False):
        """Stop the loop and tear down the standby pool (warmed-but-
        unenrolled listeners would otherwise leak).  With
        ``drain_owned`` the controller also drains every replica it
        promoted — bench/test cleanup; production rolldowns usually
        leave the serving fleet up."""
        self.stop()
        with self._lock:
            standbys, self._standbys = self._standbys, []
            owned = list(self._owned) if drain_owned else []
            if drain_owned:
                self._owned = []
        for replica in standbys + owned:
            try:
                replica.drain()
            except Exception:
                pass
