"""Training sentinel: numerical-fault detection, batch quarantine,
automatic rollback and deterministic replay (the port of
``paddle_tpu.fault.sentinel``; ``docs/fault_tolerance.md`` "Numerical
faults").

The checkpoint plane (``checkpoint.py``, ``lifecycle.py``) survives
*process* deaths; the :class:`Sentinel` guards against *state*
corruption, one NaN/Inf loss or update that silently poisons every step
after it.  It composes the existing machinery into a recovery loop:

1. **detect**: the fused finite check (every floating fetch and written
   state, with the global parameter and update norms and the loss: one
   small tensor read back, the one host sync a checked step pays;
   ``obs/numerics.py``) plus an EMA loss-spike detector, at a configurable
   cadence (``PADDLE_TPU_SENTINEL``);
2. **skip-step**: on a trip, ``Executor.run`` discards the update (the
   check runs before the state's write-back, which a guarded signature
   keeps outside its CUDA graph; the rows a sparse optimizer branch wrote
   in place are put back) and raises :class:`NumericalFault`;
3. **quarantine**: the faulty step is dumped as a pickled repro bundle
   (program dict, pre-step state, batch, RNG coordinates, trace id) for
   offline forensics: ``python -m paddle_tpu_torch replay <bundle>``
   re-executes it on the CPU and reports whether the non-finite
   reproduces (a step that drew random numbers on a card draws other
   values on the CPU: such a replay reports ``rng_device_mismatch`` and
   gives no clean verdict);
4. **rollback**: after K consecutive strikes,
   ``CheckpointManager.restore_last_good()`` rewinds the state to the
   last *verified-good* checkpoint (marked by
   :meth:`Sentinel.note_checkpoint` after N clean checks; the GC never
   collects it) and training resumes, emitting a flight-recorder
   post-mortem.

The ``sentinel.nan`` chaos failpoint injects NaNs into the loss and the
updated state exactly where a real numerical fault would appear, on
checked steps only, so the whole ladder can be drilled end to end.

A bundle holds numpy arrays, the program's ``to_dict()`` and plain
Python values only (no torch tensor, no ml_dtypes array: bfloat16 state
is widened to float32 and cast back to the program's dtype on replay),
so a bundle that either package writes loads in the other.

With no sentinel attached, ``Executor.run`` is exactly the unguarded
step: the same signature, the write-back inside the CUDA graph, no added
host sync.  The guard does not see two kinds of in-place state: the KV
pool that ``paged_attention`` writes (a serving program's, never a
guarded one's) keeps its rows on a trip, and a block with CSP ops writes
its persistables through the scope during the step.
"""

from __future__ import annotations

import logging
import os
import pickle
import time

import numpy as np
import torch

from paddle_tpu_torch.fault import chaos
from paddle_tpu_torch.obs import numerics as _numerics
from paddle_tpu_torch.obs.trace import current_trace_id, span as _span

__all__ = ["Sentinel", "NumericalFault", "sentinel_from_env",
           "replay_bundle", "load_bundle", "BUNDLE_FORMAT"]

logger = logging.getLogger(__name__)

BUNDLE_FORMAT = 1


class NumericalFault(RuntimeError):
    """A sentinel check tripped: non-finite values or a loss spike.

    Raised by ``Executor.run`` BEFORE the poisoned update reaches the
    scope (the step is skipped).  ``reason`` is ``"non_finite"`` or
    ``"loss_spike"``; ``bad`` names the offending tensors; ``repro`` is
    the self-contained replay payload (see :func:`replay_bundle`);
    ``injected`` marks faults manufactured by the ``sentinel.nan``
    failpoint; ``health`` is the fused norm digest (param/grad norm,
    update ratio) of the tripping step, when the check computed one.
    """

    def __init__(self, message, step=None, reason=None, bad=None,
                 repro=None, injected=False, health=None):
        super().__init__(message)
        self.step = step
        self.reason = reason
        self.bad = list(bad or [])
        self.repro = repro
        self.injected = injected
        self.health = health


def _metrics():
    from paddle_tpu_torch.profiler import runtime_metrics
    return runtime_metrics


class _NullMetrics:
    """Sink for sentinels that must not touch the process-global
    counters: the replay guard, which would otherwise inflate the
    production ``sentinel.*`` fault metrics of a process that also
    trains or serves ``/stats``."""

    def inc(self, name, n=1):
        pass

    def observe(self, name, value):
        pass

    def set_gauge(self, name, value):
        pass


_NULL_METRICS = _NullMetrics()


def _as_tensor(v):
    """A fetch or state value as a tensor (numpy arrays and scalars on the
    CPU; an ml_dtypes float widened to float32), or None."""
    return _numerics.as_tensor(v) if _is_arraylike(v) else None


def _floating(t):
    return t is not None and t.is_floating_point()


class Sentinel:
    """Numerical-fault guard for ``Executor.run``.

    ::

        sentinel = Sentinel(manager=mgr, cadence=1, strikes=3)
        step = 0
        while step < steps:
            step += 1
            try:
                exe.run(main, feed=batch(step), fetch_list=[loss],
                        sentinel=sentinel)
            except NumericalFault as fault:
                restored = sentinel.handle_fault(fault, step=step)
                if restored is not None:
                    step = restored      # resume after the known-good
                continue
            mgr.save(step)
            sentinel.note_checkpoint(step)

    Parameters
    ----------
    manager : CheckpointManager, optional
        Rollback target provider.  Without one, the ladder ends at
        quarantine and the K-th strike re-raises the fault.
    cadence : int
        Check every ``cadence``-th step (1 = every step).  Each check
        costs one device sync; off-cadence steps pay nothing.
    strikes : int
        Consecutive faulty checks before rollback.  A clean check
        resets the count.
    spike_factor : float or None
        Trip when ``|loss - ema| > spike_factor * (|ema| + 1e-9)`` after
        ``spike_warmup`` observations.  None disables the detector.
    ema_beta : float
        EMA smoothing for the loss baseline.
    loss_name : str, optional
        Fetch name of the loss; default: the first scalar float fetch.
    quarantine_dir : str, optional
        Where repro bundles land (default:
        ``<manager.dirname>/quarantine`` or ``./sentinel_quarantine``).
    mark_good_after : int
        Clean checks after ``note_checkpoint(step)`` before the
        checkpoint is promoted to known-good.
    max_rollbacks : int
        Rollbacks allowed without forward progress (a successful
        mark-good resets the budget); exceeding it re-raises the fault
        instead of looping on a poisoned known-good.
    """

    def __init__(self, manager=None, cadence=1, strikes=3,
                 spike_factor=10.0, ema_beta=0.9, spike_warmup=5,
                 loss_name=None, quarantine_dir=None, mark_good_after=1,
                 max_rollbacks=3):
        self.manager = manager
        self.cadence = max(1, int(cadence))
        self.strikes = max(1, int(strikes))
        self.spike_factor = None if spike_factor is None \
            else float(spike_factor)
        self.ema_beta = float(ema_beta)
        self.spike_warmup = max(1, int(spike_warmup))
        self.loss_name = loss_name
        self.mark_good_after = max(0, int(mark_good_after))
        self.max_rollbacks = max(0, int(max_rollbacks))
        if quarantine_dir is None and manager is not None:
            quarantine_dir = os.path.join(manager.dirname, "quarantine")
        self.quarantine_dir = quarantine_dir or "sentinel_quarantine"
        self._tick = 0            # steps seen
        self._strikes = 0         # consecutive faulty checks
        self._rollbacks = 0       # rollbacks since last forward progress
        self._ema = None
        self._ema_n = 0
        self._pending_good = []   # [step, clean checks still needed]
        self._bundle_seq = 0
        self._check_fn = None     # the fused finite check, made once
        self._metrics_enabled = True   # replay guards flip this off
        self._warned_loss_name = False
        self.last_health = None   # fused norm digest of the last check

    def _m(self):
        return _metrics() if self._metrics_enabled else _NULL_METRICS

    # -- detection (called by Executor.run on guarded steps) ------------

    def after_step(self, fetch_names, fetches, new_state, repro=None,
                   prev_state=None, param_names=()):
        """Inspect one step's results BEFORE the state's write-back.

        Applies the ``sentinel.nan`` poison when that failpoint fires,
        then, on cadence steps, runs the fused finite check and the EMA
        spike detector.  Returns the (possibly poisoned) ``(fetches,
        new_state)``; raises :class:`NumericalFault` on a trip, in which
        case the executor discards the update.  Values may be tensors (on
        any device) or numpy arrays.

        ``prev_state``/``param_names`` (the pre-step values of the
        written state and which of those names are Parameters) extend the
        fused reduction with the global param/update norms, still one
        host sync a guarded step, published as the ``train.param_norm``
        / ``train.grad_norm`` / ``train.update_ratio`` gauges and carried
        into the escalation context (quarantine bundles, rollback
        post-mortems)."""
        self._tick += 1
        if self._tick % self.cadence:
            return fetches, new_state
        injected = False
        # the failpoint fires only on CHECKED steps: an off-cadence
        # poison would be committed unseen and the next check would
        # quarantine an innocent batch
        if chaos.armed("sentinel.nan"):
            try:
                chaos.fire("sentinel.nan", step=self._tick)
            except chaos.FaultInjected:
                injected = True
                fetches, new_state = self._poison(fetch_names, fetches,
                                                  new_state)
        t0 = time.perf_counter()
        try:
            with _span("sentinel.check", step=self._tick):
                self._inspect(fetch_names, fetches, new_state, repro,
                              injected, prev_state, param_names)
        finally:
            # a tripped check raises out of _inspect, the expensive case
            # (it pays the host-side culprit sweep): the latency series
            # the cadence is tuned against records it too
            self._m().observe("sentinel.check_seconds",
                              time.perf_counter() - t0)
        return fetches, new_state

    def _inspect(self, fetch_names, fetches, new_state, repro, injected,
                 prev_state=None, param_names=()):
        m = self._m()
        m.inc("sentinel.checks")
        named = list(zip(fetch_names, fetches))
        named += list(new_state.items())
        idx = self._loss_index(fetch_names, fetches)
        finite, health, loss = self._device_check(
            [v for _, v in named], new_state, prev_state, param_names,
            None if idx is None else fetches[idx])
        self.last_health = health
        if health is not None:
            _numerics.set_health_gauges(m, health)
        if not finite:
            bad = [n for n, v in named if not _host_finite(v)]
            m.inc("sentinel.non_finite")
            self._trip("non_finite", bad, repro, injected,
                       f"non-finite values in {bad[:4]} at guarded "
                       f"step {self._tick}")
        if loss is not None and self.spike_factor is not None:
            if self._ema_n >= self.spike_warmup and \
                    abs(loss - self._ema) > \
                    self.spike_factor * (abs(self._ema) + 1e-9):
                m.inc("sentinel.loss_spikes")
                self._trip("loss_spike", [], repro, injected,
                           f"loss {loss:g} spiked against EMA "
                           f"{self._ema:g} at guarded step {self._tick}")
            beta = self.ema_beta
            self._ema = loss if self._ema is None \
                else beta * self._ema + (1.0 - beta) * loss
            self._ema_n += 1
        # clean check: strikes reset, pending checkpoints age toward good
        self._strikes = 0
        self._advance_good()

    def _trip(self, reason, bad, repro, injected, message):
        self._m().inc("sentinel.skipped_steps")
        payload = None
        if repro is not None:
            try:
                payload = repro() if callable(repro) else repro
            except Exception:
                logger.warning("sentinel: repro payload capture failed",
                               exc_info=True)
        raise NumericalFault(message, step=self._tick, reason=reason,
                             bad=bad, repro=payload, injected=injected,
                             health=self.last_health)

    def _device_check(self, values, new_state, prev_state, param_names,
                      loss=None):
        """The fused finite test over every floating value PLUS the
        global param/update norms and the loss (``obs/numerics.py``), read
        back once: the single host sync a check step pays.  Culprit
        naming (rare) happens after, tensor by tensor.  Returns
        ``(all_finite, health_dict_or_None, loss_or_None)``."""
        leaves = [t for t in map(_as_tensor, values) if _floating(t)]
        new_params, old_params = [], []
        if prev_state is not None:
            for n in param_names:
                a = _as_tensor(new_state.get(n))
                b = _as_tensor(prev_state.get(n))
                if _floating(a) and b is not None and a.shape == b.shape:
                    new_params.append(a)
                    old_params.append(b.to(a.device))
        loss_t = _as_tensor(loss)
        extra = [loss_t] if loss_t is not None and loss_t.numel() else []
        if not leaves and not new_params and not extra:
            return True, None, None
        if self._check_fn is None:
            self._check_fn = _numerics.fused_check_fn()
        values = self._check_fn(leaves, new_params, old_params,
                                extra).tolist()
        finite, norms, rest = _numerics.split_fused(values,
                                                    bool(new_params))
        health = _numerics.health_from_norms(norms) if norms else None
        return finite, health, (rest[0] if rest else None)

    def _loss_index(self, fetch_names, fetches):
        if self.loss_name is not None:
            try:
                return list(fetch_names).index(self.loss_name)
            except ValueError:
                if not self._warned_loss_name:
                    # a typo'd loss= must not SILENTLY disable the spike
                    # detector the operator believes is active
                    self._warned_loss_name = True
                    logger.warning(
                        "sentinel: configured loss_name %r is not among "
                        "the fetches %s — the loss-spike detector is "
                        "inactive until it matches",
                        self.loss_name, list(fetch_names))
                return None
        for i, v in enumerate(fetches):
            t = _as_tensor(v)
            if _floating(t) and t.numel() == 1:
                return i
        return None

    def _poison(self, fetch_names, fetches, new_state):
        """``sentinel.nan`` failpoint action: NaN out the loss fetch and
        every floating tensor of the updated state, the shape of a real
        numerical blow-up (bad loss + poisoned params).  The poisoned
        values are new tensors: the step's own stay as they were."""
        fetches = list(fetches)
        idx = self._loss_index(fetch_names, fetches)
        if idx is not None:
            fetches[idx] = _nan_like(fetches[idx])
        poisoned = {}
        for n, v in new_state.items():
            poisoned[n] = _nan_like(v) if _floating(_as_tensor(v)) else v
        return fetches, poisoned

    # -- escalation ladder ------------------------------------------------

    def handle_fault(self, fault, step=None):
        """Quarantine the faulty step and count the strike; after K
        consecutive strikes roll back to the last known-good checkpoint.
        Returns the restored step on rollback, else None (the caller
        skips the batch and continues).  Re-raises when unrecoverable
        (no manager, nothing restorable, rollback budget exhausted)."""
        self._strikes += 1
        # a fault invalidates the clean-streak countdown of every save
        # not yet promoted: a poisoned step may already be inside them
        self._pending_good.clear()
        try:
            self.quarantine(fault, step=step)
        except Exception:
            logger.warning("sentinel: quarantine dump failed",
                           exc_info=True)
        if self._strikes >= self.strikes:
            return self.rollback(fault)
        return None

    def quarantine(self, fault, step=None):
        """Dump the fault as a pickled bundle under ``quarantine_dir``
        (atomic tmp+rename); returns the path.  A fault whose repro
        capture failed still records the event (step, reason, culprits,
        trace id): such a bundle cannot replay (``replay`` exits 2 on it)
        but keeps the forensic trail."""
        os.makedirs(self.quarantine_dir, exist_ok=True)
        self._bundle_seq += 1
        name = (f"quarantine-step{step if step is not None else fault.step}"
                f"-{os.getpid()}-{self._bundle_seq}.pkl")
        path = os.path.join(self.quarantine_dir, name)
        bundle = {
            "format": BUNDLE_FORMAT,
            "step": step if step is not None else fault.step,
            "reason": fault.reason,
            "bad": fault.bad,
            "injected": bool(fault.injected),
            "trace_id": current_trace_id(),
            "time_unix": time.time(),
            # detector state at the trip: replaying a loss-spike bundle
            # needs the EMA baseline the loss spiked AGAINST
            "detector": {"ema": self._ema, "ema_n": self._ema_n,
                         "spike_factor": self.spike_factor,
                         "ema_beta": self.ema_beta,
                         "loss_name": self.loss_name},
            # fused norm digest of the tripping step: forensics can tell
            # "params were already huge" from "one bad batch"
            "health": getattr(fault, "health", None),
            "repro": fault.repro,
        }
        with _span("sentinel.quarantine", step=bundle["step"]):
            from paddle_tpu_torch.io import atomic_write
            atomic_write(path, pickle.dumps(bundle, protocol=4))
        self._m().inc("sentinel.quarantined")
        logger.warning("sentinel: quarantined step %s (%s) -> %s",
                       bundle["step"], fault.reason, path)
        return path

    def rollback(self, fault=None):
        """Restore the last known-good checkpoint through the attached
        manager and reset the detector state.  Emits a flight-recorder
        post-mortem (a no-op unless ``PADDLE_TPU_POSTMORTEM`` is armed).
        Returns the restored step."""
        err = fault or NumericalFault("sentinel rollback requested",
                                      reason="manual")
        if self.manager is None:
            raise err
        if self._rollbacks >= self.max_rollbacks:
            logger.error("sentinel: rollback budget (%d) exhausted with "
                         "no forward progress — giving up",
                         self.max_rollbacks)
            raise err
        self._rollbacks += 1
        with _span("sentinel.rollback", strikes=self._strikes):
            restored = self.manager.restore_last_good()
        if restored is None:
            raise err
        self._strikes = 0
        self._ema = None
        self._ema_n = 0
        self._pending_good.clear()
        self._m().inc("sentinel.rollbacks")
        try:
            from paddle_tpu_torch.obs import flight
            flight.write_postmortem(
                reason=f"sentinel rollback to step {restored}",
                extra={"restored_step": int(restored),
                       "fault": str(fault) if fault else None,
                       "health": self.last_health,
                       "quarantine_dir": self.quarantine_dir})
        except Exception:
            pass
        logger.warning("sentinel: rolled back to known-good step %s",
                       restored)
        return restored

    # -- known-good promotion --------------------------------------------

    def note_checkpoint(self, step):
        """Register a freshly-saved checkpoint; after ``mark_good_after``
        clean checks it is promoted via ``manager.mark_good(step)``."""
        if self.manager is None:
            return
        if self.mark_good_after <= 0:
            self._promote(int(step))
        else:
            self._pending_good.append([int(step), self.mark_good_after])

    def _advance_good(self):
        if not self._pending_good:
            return
        promoted = None
        for entry in self._pending_good:
            entry[1] -= 1
            if entry[1] <= 0:
                promoted = entry[0]   # newest eligible wins
        if promoted is not None:
            self._pending_good = [e for e in self._pending_good
                                  if e[1] > 0]
            self._promote(promoted)

    def _promote(self, step):
        try:
            got = self.manager.mark_good(step)
        except Exception:
            logger.warning("sentinel: mark_good(%s) failed", step,
                           exc_info=True)
            return
        if got is None:
            # the checkpoint was rotated away before its promotion caught
            # up: no new anchor, no forward progress, so the rollback
            # budget must NOT refill on a phantom promotion
            logger.warning("sentinel: checkpoint %s vanished before "
                           "promotion (keep-N rotation outran the "
                           "clean-check lag)", step)
            return
        self._rollbacks = 0   # forward progress: refill rollback budget


def sentinel_from_env(manager=None, spec=None, **overrides):
    """Build a :class:`Sentinel` from ``PADDLE_TPU_SENTINEL`` (or an
    explicit ``spec``); returns None when unset/disabled: training
    scripts guard only when the operator asked.

    Grammar (``;`` or ``,`` separated)::

        PADDLE_TPU_SENTINEL="1"                              # defaults
        PADDLE_TPU_SENTINEL="cadence=4;strikes=3;spike=10"
        PADDLE_TPU_SENTINEL="cadence=1;spike=off;quarantine=/tmp/q"

    Keys: ``cadence``, ``strikes``, ``spike`` (factor, or ``off``),
    ``ema``, ``warmup``, ``good_after``, ``max_rollbacks``,
    ``quarantine`` (dir), ``loss`` (fetch name)."""
    spec = spec if spec is not None \
        else os.environ.get("PADDLE_TPU_SENTINEL", "")
    spec = spec.strip()
    if not spec or spec.lower() in ("0", "false", "off", "no"):
        return None
    kwargs = {}
    if spec.lower() not in ("1", "true", "on", "yes"):
        keymap = {"cadence": ("cadence", int),
                  "strikes": ("strikes", int),
                  "spike": ("spike_factor",
                            lambda v: None if v.lower() in ("off", "none")
                            else float(v)),
                  "ema": ("ema_beta", float),
                  "warmup": ("spike_warmup", int),
                  "good_after": ("mark_good_after", int),
                  "max_rollbacks": ("max_rollbacks", int),
                  "quarantine": ("quarantine_dir", str),
                  "loss": ("loss_name", str)}
        for clause in spec.replace(",", ";").split(";"):
            clause = clause.strip()
            if not clause:
                continue
            key, _, value = clause.partition("=")
            key = key.strip().lower()
            if key not in keymap:
                raise ValueError(
                    f"PADDLE_TPU_SENTINEL: unknown key {key!r} in "
                    f"{clause!r} (want {sorted(keymap)})")
            dest, conv = keymap[key]
            kwargs[dest] = conv(value.strip())
    kwargs.update(overrides)
    return Sentinel(manager=manager, **kwargs)


# ---------------------------------------------------------------------------
# offline replay (`python -m paddle_tpu_torch replay <bundle>`)
# ---------------------------------------------------------------------------

def load_bundle(path):
    """Unpickle + sanity-check a quarantine bundle (shared by
    :func:`replay_bundle` and ``numerics.localize_bundle``); a malformed
    bundle raises ``ValueError`` (the CLI's exit 2)."""
    try:
        with open(path, "rb") as f:
            bundle = pickle.load(f)
        if not isinstance(bundle, dict):
            raise ValueError("not a bundle dict")
    except OSError:
        raise
    except Exception as e:
        # pickle raises a zoo on truncated/corrupt input (UnpicklingError,
        # EOFError, AttributeError, ...): normalize to the CLI's
        # "malformed bundle" verdict (exit 2), never the "replayed clean"
        # one
        raise ValueError(f"{path}: malformed bundle: {e}") from e
    return bundle


def rebuild_repro(path, bundle):
    """The step a bundle records, rebuilt on the CPU: ``(executor,
    program, scope, feed, fetch_names)``, the executor's run counter
    rewound to the recorded step's.  The replay draws the recorded
    step's random values only where the CPU's generators drew them: see
    :func:`rng_device_mismatch`.  State whose program dtype is bfloat16
    is cast back to it.  A payload that does not rebuild raises
    ``ValueError``."""
    from paddle_tpu_torch.convert import to_tensor
    from paddle_tpu_torch.executor import Executor
    from paddle_tpu_torch.framework import Program
    from paddle_tpu_torch.place import CPUPlace
    from paddle_tpu_torch.scope import Scope

    repro = bundle.get("repro")
    if not repro:
        raise ValueError(f"{path}: bundle carries no repro payload")
    try:
        program = Program.from_dict(repro["program"])
        program.random_seed = repro.get("random_seed")
        block = program.global_block()
        scope = Scope()
        cpu = torch.device("cpu")
        for name, value in (repro.get("state") or {}).items():
            var = block.vars.get(name)
            scope.set_var(name, to_tensor(value, cpu, getattr(
                var, "dtype", None) if _declared_bf16(var) else None))
        # the step's random draws are keyed (seed * 1000003 +
        # run_counter): rewind the counter to the recorded step's
        run_counter = int(repro.get("run_counter", 1)) - 1
        feed = dict(repro["feed"])
        fetch_names = list(repro["fetch_names"])
    except Exception as e:
        # a bundle that unpickles but whose payload cannot rebuild
        # (version skew, corrupt arrays) is still "malformed" (exit 2),
        # never "replayed clean"
        raise ValueError(
            f"{path}: cannot rebuild repro payload: {e}") from e
    exe = Executor(CPUPlace())
    exe._run_counter = run_counter
    return exe, program, scope, feed, fetch_names


def random_ops(program):
    """The types of ``program``'s ops whose output depends on the random
    values they draw (a dropout that keeps everything, at probability 0
    or in test mode, does not)."""
    from paddle_tpu_torch.ops.registry import lookup

    found = set()
    for block in program.blocks:
        for op in block.ops:
            opdef = lookup(op.type)
            if opdef is None or not opdef.uses_rng:
                continue
            if op.type == "dropout" and (
                    op.attrs.get("is_test", False) or
                    float(op.attrs.get("dropout_prob", 0.5)) == 0.0):
                continue
            found.add(op.type)
    return sorted(found)


def rng_device_mismatch(bundle, program):
    """True when the CPU replay of ``bundle`` cannot draw the recorded
    step's random values: ``program`` draws random numbers and the step
    drew them elsewhere than on the port's CPU generators (a card's
    Philox, or a bundle the JAX package wrote, whose PRNG is its own)."""
    recorded = (bundle.get("repro") or {}).get("rng_device")
    return recorded != "cpu" and bool(random_ops(program))


def _declared_bf16(var):
    return var is not None and str(getattr(var, "dtype", "")) == "bfloat16"


def replay_bundle(path):
    """Re-execute a quarantined step from its repro bundle and report
    whether the numerical fault reproduces.

    Rebuilds the program, pre-step state, batch and RNG coordinates
    recorded at quarantine time, runs ONE step under a detect-only
    sentinel, and returns ``{"reproduced": bool, "reason", "bad",
    "step", "injected"}``.  Bundles whose fault the ``sentinel.nan``
    failpoint made re-arm it for one fire, so injected drills replay
    deterministically too.  The step runs on the CPU (``CPUPlace``),
    wherever the fault was seen: the JAX package's replay pins its CPU
    platform the same way, to debug a device's fault on a workstation.
    Bundles written by either package load here.

    The report's ``rng_device`` is the device type whose generators drew
    the recorded step's random values (None for a bundle the JAX package
    wrote), and ``rng_device_mismatch`` is true when the program draws
    random numbers that the CPU replay cannot draw alike
    (:func:`rng_device_mismatch`): a clean replay of such a bundle says
    nothing of the recorded step, and the CLI gives it no clean
    verdict."""
    bundle = load_bundle(path)
    exe, program, scope, feed, fetch_names = rebuild_repro(path, bundle)
    det = bundle.get("detector") or {}
    if bundle.get("reason") == "loss_spike" and \
            det.get("spike_factor") is not None and \
            det.get("ema") is not None:
        # re-arm the spike detector against the recorded EMA baseline: a
        # deterministic spike (bad batch) reproduces, a transient one
        # replays clean
        guard = Sentinel(cadence=1, strikes=1 << 30,
                         spike_factor=det["spike_factor"],
                         ema_beta=det.get("ema_beta", 0.9),
                         spike_warmup=1,
                         loss_name=det.get("loss_name"))
        guard._ema = det.get("ema")
        guard._ema_n = max(int(det.get("ema_n") or 1), 1)
    else:
        guard = Sentinel(cadence=1, strikes=1 << 30, spike_factor=None)
    # the replay guard must not inflate the process-global sentinel.*
    # fault counters (an in-process replay is forensics, not a fault)
    guard._metrics_enabled = False
    prev_nan_fp = None
    if bundle.get("injected"):
        # swap, don't inject+clear: an in-process caller may have a live
        # drill armed on sentinel.nan, which the replay must neither
        # clobber on the way in nor disarm on the way out
        prev_nan_fp = chaos.swap("sentinel.nan", None)
        chaos.inject("sentinel.nan", times=1)
    report = {"reproduced": False, "reason": None, "bad": [],
              "step": bundle.get("step"),
              "injected": bool(bundle.get("injected")),
              "rng_device": bundle["repro"].get("rng_device"),
              "rng_device_mismatch": rng_device_mismatch(bundle, program)}
    try:
        try:
            exe.run(program, feed=feed, fetch_list=fetch_names,
                    scope=scope, sentinel=guard)
        except NumericalFault as f:
            report.update(reproduced=True, reason=f.reason, bad=f.bad)
        except Exception as e:
            # a step that cannot re-execute at all (version skew, a shape
            # error) is "unreplayable" (the CLI's exit 2): it must never
            # fall through to exit 1, the "replayed CLEAN, suspect
            # hardware" verdict automated triage trusts
            raise ValueError(
                f"{path}: bundle does not re-execute: {e}") from e
    finally:
        if bundle.get("injected"):
            chaos.swap("sentinel.nan", prev_nan_fp)
    return report


def _nan_like(v):
    if isinstance(v, torch.Tensor):
        return v * float("nan")
    return np.asarray(v) * np.float32(np.nan)


def _is_arraylike(v):
    return hasattr(v, "shape") or hasattr(v, "dtype")


def _host_finite(v):
    """True unless ``v`` is a floating tensor or array holding a NaN or
    an inf (the culprit sweep of a tripped check)."""
    t = _as_tensor(v)
    if not _floating(t):
        return True
    return bool(torch.isfinite(t).all())
