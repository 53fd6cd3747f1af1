"""Device-performance observability (the port of ``paddle_tpu.obs.perf``):
one cost record per prepared signature, the live MFU gauges, the HBM
census and its headroom check, the step-phase switch, and the
:class:`WarmupReport` that ``Executor.warmup`` returns.

- **Records.**  On every step-cache miss the executor creates one record
  for the signature (:func:`new_record`): its ``flops`` and
  ``bytes_accessed`` from the static cost model
  (``analysis.cost.estimate`` over the program with the run's feed
  shapes; ``"flops_source": "analysis.cost.estimate"``), since torch has
  no counterpart of XLA's ``cost_analysis()`` and its FLOP counter does
  not see the kernels the port launches through ``ctypes``.  The
  estimate walks the whole program, so it runs at the first need, not
  at the miss: the first :func:`note_step` that sets a gauge, or
  :func:`records`; ``cost_seconds`` is its time, and a signature that
  feeds no gauge and is never reported pays nothing.  ``phases``
  holds the prepare seconds (``trace_seconds``), the signature's eager
  first run (``lower_seconds``) and its CUDA graph capture
  (``backend_seconds``); ``memory`` the feeds and state the step reads
  (``argument_bytes``), the fetches and state it writes
  (``output_bytes``), the written state it reads too (``alias_bytes``)
  and, on the card, the eager first run's allocation peak above its
  start (``temp_bytes``; None on the CPU, which has no allocator
  statistics).  Records surface through :func:`records` /
  :func:`compile_report` and ``python -m paddle_tpu_torch profile
  compile``.  ``PADDLE_TPU_PERF=0`` turns them off.

- **Live MFU.**  :func:`note_step` divides a record's FLOPs by the
  measured step seconds and the device's peak (:func:`peak_flops_info`)
  into the ``train.mfu`` gauge (or ``gen.decode_mfu`` for the decode
  program).  The step time covers feed staging to the fetches' host
  conversion, which waits for the device; ``return_numpy=False`` derives
  no gauge (its time would be the launch time only).

- **HBM census.**  :func:`hbm_census` attributes device memory to
  collections: the providers' tensors (``kv_cache`` / ``kv_pages`` from
  ``GenPredictor``), then the scope's tensors split into ``optimizer``
  state (the accumulator-name rule of ``optimizer.py``) and ``params``.
  A storage counts once (a CUDA graph's state buffers ARE the scope's
  tensors).  ``total`` is ``torch.cuda.memory_allocated()``, ``other``
  what the collections leave of it, ``high_watermark`` the process's
  peak allocation and ``limit`` the card's memory (``mem_get_info``)
  unless ``PADDLE_TPU_HBM_LIMIT_BYTES`` sets it.  On the CPU the census
  attributes the scope and reports no total, watermark or limit.  Armed
  on a cadence with ``PADDLE_TPU_HBM_CENSUS=<seconds>``, the executor's
  per-step :func:`census_tick` costs a None check unarmed.

- **Headroom check.**  There is no compile-time memory analysis: after a
  signature's eager first run on the card, its projected footprint
  (``temp_bytes`` + ``output_bytes``) is compared with the limit less the
  allocated memory, and a program that will not fit warns
  (``hbm.headroom_warnings``) before its CUDA graph is captured.
  Measuring the first run's peak resets the allocator's peak statistic
  (``torch.cuda.reset_peak_memory_stats``); the census folds the peak
  seen before each reset into its high watermark.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time

__all__ = ["peak_flops_per_chip", "peak_flops_info", "MFU_BASES",
           "capture_enabled", "new_record", "FirstRun", "note_step",
           "records",
           "compile_report", "validate_report", "reset_records",
           "hbm_census", "register_hbm_provider", "unregister_hbm_provider",
           "hbm_limit_bytes", "live_device_bytes", "census_tick",
           "arm_census", "arm_census_from_env", "enable_step_phases",
           "disable_step_phases", "step_phases_enabled", "WarmupReport"]

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# peak FLOPs
# ---------------------------------------------------------------------------

#: dense bf16 tensor-core peak FLOP/s by device-name substring: the H100
#: SXM data sheet's 989 TFLOP/s (dense, without sparsity)
PEAK_FLOPS_TABLE = {"H100": 989e12}

#: the finite-but-meaningless fallback of any other device (tagged, never
#: compared with a ``gpu-peak`` record)
CPU_FALLBACK_PEAK = 1e12

#: every legal MFU basis tag: the one definition :func:`peak_flops_info`
#: emits from and :func:`validate_report` checks against
MFU_BASES = ("gpu-peak", "cpu-fallback")

_peak_cache = {}


def peak_flops_info(device=None):
    """``(peak_flops, basis)`` of ``device`` (default: the current card
    when present, else the CPU).  ``basis`` is ``"gpu-peak"`` when the
    card's name (``torch.cuda.get_device_name``) matches the table and
    ``"cpu-fallback"`` otherwise, so a CPU run's MFU is never read as a
    card's."""
    import torch
    device = _census_device(device)
    key = str(device)
    if key in _peak_cache:
        return _peak_cache[key]
    value, basis = CPU_FALLBACK_PEAK, "cpu-fallback"
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        for k, v in PEAK_FLOPS_TABLE.items():
            if k in name:
                value, basis = v, "gpu-peak"
                break
    _peak_cache[key] = (value, basis)
    return _peak_cache[key]


def peak_flops_per_chip(device=None):
    """The peak FLOP/s of :func:`peak_flops_info`."""
    return peak_flops_info(device)[0]


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------

_records_lock = threading.Lock()
_records = collections.OrderedDict()   # key -> record dict
_RECORDS_MAX = 256
_key_counter = [0]

REPORT_FORMAT = 1

#: keys every record carries (``validate_report`` holds the ``profile
#: compile --json`` schema to this)
RECORD_KEYS = ("key", "label", "created_unix", "flops", "bytes_accessed",
               "memory", "phases", "steps", "last_step_seconds", "mfu")
_pending_cost = {}   # record key -> (program, its version, feed shapes)
MEMORY_KEYS = ("argument_bytes", "output_bytes", "temp_bytes",
               "alias_bytes", "generated_code_bytes")
PHASE_KEYS = ("trace_seconds", "lower_seconds", "backend_seconds")


def capture_enabled():
    """Records are on by default; ``PADDLE_TPU_PERF=0`` turns them off
    (the executor then keeps no record and derives no MFU)."""
    return os.environ.get("PADDLE_TPU_PERF", "1").strip().lower() \
        not in ("0", "false", "off", "no")


def _metrics():
    from paddle_tpu_torch.profiler import runtime_metrics
    return runtime_metrics


def jit_label(feeds, fetch_names, tag=""):
    """Readable label of a signature for the profile tables: the sorted
    feed name:shape pairs (truncated)."""
    parts = []
    for n in sorted(feeds):
        shape = "x".join(str(d) for d in getattr(feeds[n], "shape", ()))
        parts.append(f"{n}:{shape or '()'}")
    label = (f"{tag}:" if tag else "") + ",".join(parts)
    if len(label) > 96:
        label = label[:93] + "..."
    return label or "(no feeds)"


def _feed_shaped(program, shapes):
    """``program``, or a copy whose feed variables declare the run's feed
    ``shapes`` where it declares an unknown (-1) dim: the cost model
    counts an unknown dim as 1."""
    block = program.global_block()
    fix = {}
    for n, shape in shapes.items():
        var = block.vars.get(n)
        if var is not None and var.shape is not None and \
                len(var.shape) == len(shape) and \
                any(d is None or int(d) < 0 for d in var.shape):
            fix[n] = list(shape)
    if not fix:
        return program
    from paddle_tpu_torch.framework import Program
    copy = Program.from_dict(program.to_dict())
    for n, shape in fix.items():
        copy.global_block().vars[n].shape = shape
    return copy


def _cost(program, shapes):
    try:
        from paddle_tpu_torch.analysis import cost
        rep = cost.estimate(_feed_shaped(program, shapes))
        return float(rep.total_flops), float(rep.total_bytes)
    except Exception:
        logger.debug("cost estimate failed", exc_info=True)
        return None, None


def _nbytes(values):
    import torch
    total = 0
    for v in values:
        if isinstance(v, torch.Tensor):
            total += v.numel() * v.element_size()
        elif hasattr(v, "nbytes"):
            total += int(v.nbytes)
    return int(total)


def new_record(program, feeds, fetch_names, prepare_seconds, device,
               metrics=None):
    """The record of a freshly prepared signature of ``program`` (run
    with ``feeds`` on ``device``), inserted into the table; None when
    records are off.  Its ``flops`` and ``bytes_accessed`` wait for
    :func:`_resolve_cost`."""
    if not capture_enabled():
        return None
    m = metrics or _metrics()
    _key_counter[0] += 1
    key = f"sig-{_key_counter[0]:04d}"
    record = {
        "key": key,
        "label": jit_label(feeds, fetch_names),
        "created_unix": time.time(),
        "flops": None,
        "bytes_accessed": None,
        "flops_source": "analysis.cost.estimate",
        "cost_seconds": None,
        "device": str(device),
        "memory": None,
        "phases": {"trace_seconds": prepare_seconds,
                   "lower_seconds": 0.0, "backend_seconds": 0.0},
        "steps": 0,
        "last_step_seconds": None,
        "mfu": None,
    }
    shapes = {n: tuple(getattr(t, "shape", ())) for n, t in feeds.items()}
    with _records_lock:
        while len(_records) >= _RECORDS_MAX:
            _pending_cost.pop(_records.popitem(last=False)[0], None)
        _records[key] = record
        _pending_cost[key] = (program, program._version, shapes)
    m.inc("compile.captures")
    m.observe("compile.phase_trace_seconds", prepare_seconds)
    return record


def _resolve_cost(record, metrics=None):
    """Price ``record``'s program with its feed shapes, once: fills
    ``flops``, ``bytes_accessed`` and ``cost_seconds``.  A program
    changed since the record was made is not priced (its next run
    prepares a signature of its own)."""
    with _records_lock:
        pending = _pending_cost.pop(record.get("key"), None)
    if pending is None:
        return
    program, version, shapes = pending
    if program._version != version:
        return
    t0 = time.perf_counter()
    flops, nbytes = _cost(program, shapes)
    record["cost_seconds"] = time.perf_counter() - t0
    record["flops"] = flops or None
    record["bytes_accessed"] = nbytes or None
    m = metrics or _metrics()
    if flops:
        m.observe("compile.cost_flops", flops)
    if nbytes:
        m.observe("compile.cost_bytes", nbytes)


def note_first_run(record, seconds, feeds, state_in, fetches, new_state,
                   temp_bytes, metrics=None):
    """Fill ``record``'s memory breakdown and ``lower_seconds`` after the
    signature's eager first run, then run the headroom check (before the
    second run captures the graph)."""
    if record is None:
        return
    m = metrics or _metrics()
    record["phases"]["lower_seconds"] = seconds
    alias = [v for n, v in state_in.items() if n in new_state]
    record["memory"] = {
        "argument_bytes": _nbytes(list(feeds.values()) +
                                  list(state_in.values())),
        "output_bytes": _nbytes(list(fetches) + list(new_state.values())),
        "temp_bytes": temp_bytes,
        "alias_bytes": _nbytes(alias),
        "generated_code_bytes": 0,
    }
    m.observe("compile.phase_lower_seconds", seconds)
    if temp_bytes is not None:
        m.observe("compile.memory_temp_bytes", temp_bytes)
    _headroom_check(record, m)


class FirstRun:
    """The window of a signature's eager first run, for its record: on
    the card it resets the peak-allocation statistic at the start
    (:func:`reset_peak`) and reads the peak above the start at the end
    (one device sync, the first run only).  With ``record=None`` both
    ends do nothing."""

    def __init__(self, record, device):
        self.record = record
        if record is None:
            return
        self.device = _census_device(device)
        self.start = reset_peak(self.device) \
            if self.device.type == "cuda" else None
        self.t0 = time.perf_counter()

    def done(self, feeds, state_in, fetches, new_state):
        if self.record is None:
            return
        temp = None
        if self.start is not None:
            import torch
            torch.cuda.synchronize(self.device)
            temp = max(0, int(torch.cuda.max_memory_allocated(
                self.device)) - self.start)
        note_first_run(self.record, time.perf_counter() - self.t0, feeds,
                       state_in, fetches, new_state, temp)


def note_capture(record, seconds, metrics=None):
    """``backend_seconds`` of ``record``: its CUDA graph capture."""
    if record is None:
        return
    record["phases"]["backend_seconds"] = seconds
    (metrics or _metrics()).observe("compile.phase_backend_seconds",
                                    seconds)


def records():
    """Snapshot of the records, oldest first, each priced."""
    with _records_lock:
        live = list(_records.values())
    for r in live:
        _resolve_cost(r)
    with _records_lock:
        return [dict(r, phases=dict(r["phases"]),
                     memory=(dict(r["memory"]) if r["memory"] else None))
                for r in _records.values()]


def reset_records():
    """Drop the records (tests)."""
    with _records_lock:
        _records.clear()
        _pending_cost.clear()


def compile_report():
    """The ``profile compile --json`` body (schema held by
    :func:`validate_report`)."""
    import torch
    backend = "cuda" if torch.cuda.is_available() else "cpu"
    peak, basis = peak_flops_info()
    return {"format": REPORT_FORMAT, "backend": backend,
            "peak_flops_per_chip": peak, "mfu_basis": basis,
            "records": records()}


def validate_report(obj):
    """Schema problems of a :func:`compile_report` body as a list of
    strings (empty = valid)."""
    problems = []
    if not isinstance(obj, dict):
        return [f"report must be an object, got {type(obj).__name__}"]
    if obj.get("format") != REPORT_FORMAT:
        problems.append(f"format must be {REPORT_FORMAT}, "
                        f"got {obj.get('format')!r}")
    if obj.get("mfu_basis") not in MFU_BASES:
        problems.append(f"mfu_basis must be one of {MFU_BASES}, "
                        f"got {obj.get('mfu_basis')!r}")
    recs = obj.get("records")
    if not isinstance(recs, list):
        return problems + ["records must be a list"]
    for i, r in enumerate(recs):
        where = f"records[{i}]"
        if not isinstance(r, dict):
            problems.append(f"{where}: must be an object")
            continue
        for k in RECORD_KEYS:
            if k not in r:
                problems.append(f"{where}: missing key {k!r}")
        phases = r.get("phases")
        if not isinstance(phases, dict) or \
                any(k not in phases for k in PHASE_KEYS):
            problems.append(f"{where}: phases needs {PHASE_KEYS}")
        mem = r.get("memory")
        if mem is not None and (not isinstance(mem, dict) or
                                any(k not in mem for k in MEMORY_KEYS)):
            problems.append(f"{where}: memory needs {MEMORY_KEYS}")
        for k in ("flops", "bytes_accessed"):
            v = r.get(k)
            if v is not None and (not isinstance(v, (int, float))
                                  or isinstance(v, bool) or v < 0):
                problems.append(f"{where}: {k} must be a non-negative "
                                f"number or null")
    return problems


# ---------------------------------------------------------------------------
# live MFU
# ---------------------------------------------------------------------------

def note_step(record, seconds, gauge="train.mfu", devices=1,
              flops_scale=1, metrics=None):
    """Per-step MFU hook (the executor calls it after a step whose
    fetches came back to the host): ``flops * flops_scale / seconds /
    (peak * devices)`` into ``gauge``, the peak that of the record's
    device.  Without a record or FLOPs this is a None check.
    ``flops_scale`` is ``steps`` for a ``run_steps`` window, whose record
    prices one step."""
    if record is None or not seconds or seconds <= 0:
        return None
    _resolve_cost(record, metrics)
    flops = record.get("flops")
    if not flops:
        return None
    peak, _basis = peak_flops_info(record.get("device"))
    mfu = flops * flops_scale / seconds / (peak * max(int(devices), 1))
    record["steps"] += 1
    record["last_step_seconds"] = seconds
    record["mfu"] = mfu
    (metrics or _metrics()).set_gauge(gauge, mfu)
    return mfu


# ---------------------------------------------------------------------------
# HBM census
# ---------------------------------------------------------------------------

#: scope-variable name prefixes that mark optimizer accumulator state
#: (``optimizer.py`` names accumulators ``<slot>.<param>_N``)
OPTIMIZER_STATE_PREFIXES = (
    "moment", "velocity", "beta1_pow", "beta2_pow", "inf_norm",
    "avg_squared", "mean_square", "squared_accumulator",
    "linear_accumulator",
)

#: census collections, in attribution priority order; provider-backed
#: collections claim their tensors before the scope walk
HBM_COLLECTIONS = ("kv_cache", "kv_pages", "prefetch", "embedding",
                   "optimizer", "params")

_hbm_lock = threading.Lock()
_hbm_providers = {}     # collection -> {token: callable}
_hbm_token = [0]
_hbm_high_watermark = [0]


def register_hbm_provider(collection, fn):
    """Register ``fn`` (no args -> iterable of tensors) as a source of
    ``collection``'s memory (``kv_cache`` / ``kv_pages`` / custom).
    Returns a token for :func:`unregister_hbm_provider`.  Providers that
    raise are skipped, never fatal: the census is a diagnostic."""
    with _hbm_lock:
        _hbm_token[0] += 1
        token = _hbm_token[0]
        _hbm_providers.setdefault(collection, {})[token] = fn
    return token


def unregister_hbm_provider(token):
    with _hbm_lock:
        for fns in _hbm_providers.values():
            fns.pop(token, None)


def _provider_tensors(collection):
    with _hbm_lock:
        fns = list(_hbm_providers.get(collection, {}).values())
    out = []
    for fn in fns:
        try:
            out.extend(fn() or ())
        except Exception:
            logger.debug("hbm provider for %r raised; skipped",
                         collection, exc_info=True)
    return out


def _is_optimizer_state(name):
    base = name.rsplit("/", 1)[-1]
    return any(base.startswith(p) for p in OPTIMIZER_STATE_PREFIXES)


def _census_device(device=None):
    """``device`` as a ``torch.device`` with its index (a bare ``cuda``
    is the current card; the allocator's statistics want an index);
    default: the current card when present, else the CPU."""
    import torch
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def hbm_limit_bytes(device=None):
    """Device memory limit for headroom accounting:
    ``PADDLE_TPU_HBM_LIMIT_BYTES`` wins (operators and tests), else the
    card's total memory (``torch.cuda.mem_get_info``), else None (the
    CPU: the headroom check then stands down)."""
    raw = os.environ.get("PADDLE_TPU_HBM_LIMIT_BYTES", "").strip()
    if raw:
        try:
            return int(float(raw))
        except ValueError:
            logger.warning("bad PADDLE_TPU_HBM_LIMIT_BYTES=%r; ignored",
                           raw)
    device = _census_device(device)
    if device.type != "cuda":
        return None
    import torch
    return int(torch.cuda.mem_get_info(device)[1])


def live_device_bytes(device=None):
    """Bytes the caching allocator holds allocated on the card
    (``torch.cuda.memory_allocated``), the census's ``total``; None on
    the CPU."""
    device = _census_device(device)
    if device.type != "cuda":
        return None
    import torch
    return int(torch.cuda.memory_allocated(device))


def reset_peak(device):
    """Reset the card's peak-allocation statistic for a measurement
    window, folding the peak so far into the census's watermark.
    Returns the allocated bytes at the window's start."""
    import torch
    # the allocator's statistics exist once CUDA is initialized (a
    # process's first step may be its first CUDA call)
    torch.cuda.init()
    with _hbm_lock:
        _hbm_high_watermark[0] = max(_hbm_high_watermark[0], int(
            torch.cuda.max_memory_allocated(device)))
    torch.cuda.reset_peak_memory_stats(device)
    return int(torch.cuda.memory_allocated(device))


def _high_watermark(device):
    import torch
    with _hbm_lock:
        _hbm_high_watermark[0] = max(_hbm_high_watermark[0], int(
            torch.cuda.max_memory_allocated(device)))
        return _hbm_high_watermark[0]


def hbm_census(scope=None, metrics=None, device=None):
    """One walk of the providers' and the scope's tensors on ``device``
    (default: the card when present) attributed to collections, exported
    as the ``hbm.*`` gauges.  ``scope`` defaults to the global scope;
    provider-backed collections claim their tensors first, a storage
    counts once, and on the card what the collections leave of
    ``memory_allocated()`` is ``other``.  Returns the census dict (on the
    CPU ``total``, ``other`` and ``high_watermark`` are None and there is
    no ``limit``)."""
    import torch

    from paddle_tpu_torch.convert import is_dtensor
    m = metrics or _metrics()
    device = _census_device(device)
    counted = set()
    census = {c: 0 for c in HBM_COLLECTIONS}

    def claim(collection, values):
        for t in values:
            if not isinstance(t, torch.Tensor) or \
                    t.device.type != device.type:
                continue     # host arrays (a page table) are not HBM
            if is_dtensor(t):
                t = t.to_local()     # this rank's shard
            st = t.untyped_storage()
            key = (str(t.device), st.data_ptr())
            if key in counted:
                continue
            counted.add(key)
            census[collection] += int(st.nbytes())

    for collection in ("kv_cache", "kv_pages", "prefetch", "embedding"):
        claim(collection, _provider_tensors(collection))
    if scope is None:
        from paddle_tpu_torch.scope import global_scope
        scope = global_scope()
    opt, params = [], []
    s = scope
    while s is not None:
        for name, v in s.items():
            if isinstance(v, torch.Tensor):
                (opt if _is_optimizer_state(name) else params).append(v)
        s = s.parent
    claim("optimizer", opt)
    claim("params", params)

    attributed = sum(census.values())
    total = live_device_bytes(device)
    if total is None:
        census.update(other=None, total=None, high_watermark=None)
    else:
        census["other"] = max(0, total - attributed)
        census["total"] = total
        census["high_watermark"] = max(_high_watermark(device), total)

    m.inc("hbm.census_runs")
    m.set_gauge("hbm.params_bytes", census["params"])
    m.set_gauge("hbm.optimizer_bytes", census["optimizer"])
    m.set_gauge("hbm.kv_cache_bytes", census["kv_cache"])
    m.set_gauge("hbm.kv_pages_bytes", census["kv_pages"])
    m.set_gauge("hbm.prefetch_bytes", census["prefetch"])
    m.set_gauge("hbm.embedding_bytes", census["embedding"])
    if total is not None:
        m.set_gauge("hbm.other_bytes", census["other"])
        m.set_gauge("hbm.total_bytes", census["total"])
        m.set_gauge("hbm.high_watermark_bytes", census["high_watermark"])
    limit = hbm_limit_bytes(device)
    if limit is not None and total is not None:
        census["limit"] = limit
        census["headroom"] = limit - total
        m.set_gauge("hbm.limit_bytes", limit)
        m.set_gauge("hbm.headroom_bytes", limit - total)
    return census


def _headroom_check(record, m):
    """Projected-footprint check of a signature after its eager first
    run: its temp + output bytes must fit beside what is allocated now
    (its arguments are).  Warns, a counter and a log line naming the
    signature, before its graph is captured."""
    device = _census_device(record.get("device") or "cpu")
    limit = hbm_limit_bytes(device)
    mem = record.get("memory")
    if limit is None or mem is None:
        return
    live = live_device_bytes(device) or 0
    projected = (mem["temp_bytes"] or 0) + mem["output_bytes"] + \
        mem["generated_code_bytes"]
    headroom = limit - live
    m.set_gauge("hbm.limit_bytes", limit)
    m.set_gauge("hbm.headroom_bytes", headroom)
    if projected > headroom:
        m.inc("hbm.headroom_warnings")
        logger.warning(
            "projected footprint of %s (%s) is %.1f MB but only %.1f MB "
            "of device memory remains beside the %.1f MB allocated — the "
            "next run may run out of memory",
            record["key"], record["label"], projected / 1e6,
            headroom / 1e6, live / 1e6)


# ---------------------------------------------------------------------------
# census cadence (the executor's per-step hook)
# ---------------------------------------------------------------------------

_census_interval = None
_census_due = 0.0


def arm_census(interval_seconds):
    """Arm (or, with None/0, disarm) the per-step census cadence.
    Re-arming at the SAME interval keeps the current due time: every
    ``Executor.__init__`` re-reads the env, and a construction must not
    force an immediate off-cadence census."""
    global _census_interval, _census_due
    if not interval_seconds:
        _census_interval = None
        return
    interval = float(interval_seconds)
    if _census_interval == interval:
        return
    _census_interval = interval
    _census_due = 0.0


def arm_census_from_env():
    """``PADDLE_TPU_HBM_CENSUS=<seconds>`` arms the cadence (called by
    ``Executor.__init__``; the env wins over a previous programmatic arm
    only when set)."""
    raw = os.environ.get("PADDLE_TPU_HBM_CENSUS", "").strip()
    if not raw:
        return
    try:
        arm_census(float(raw))
    except ValueError:
        logger.warning("bad PADDLE_TPU_HBM_CENSUS=%r; census not armed",
                       raw)


def census_tick(scope=None):
    """The executor's per-step hook: a None check unarmed, one clock
    read armed-but-not-due, a full census when the interval elapsed."""
    global _census_due
    if _census_interval is None:
        return
    now = time.monotonic()
    if now < _census_due:
        return
    _census_due = now + _census_interval
    try:
        hbm_census(scope)
    except Exception:
        logger.warning("hbm census failed", exc_info=True)


# ---------------------------------------------------------------------------
# step-phase breakdown (python -m paddle_tpu_torch profile step)
# ---------------------------------------------------------------------------

_step_phases = False


def enable_step_phases():
    """Arm the executor's per-step feed/dispatch/device-wait/fetch series
    (``perf.step.*``): one device sync a step more, so this is a
    profiling mode (``profile step``), not a steady-state default."""
    global _step_phases
    _step_phases = True


def disable_step_phases():
    global _step_phases
    _step_phases = False


def step_phases_enabled():
    return _step_phases


# ---------------------------------------------------------------------------
# warmup report
# ---------------------------------------------------------------------------

class WarmupReport(int):
    """``Executor.warmup``'s return value: the number of kernel sources
    compiled during the warmup (an ``int``), plus a per-bucket
    ``buckets`` list: ``{"signature": {name: shape}, "compiles": n,
    "seconds": s, "cache": "cold" | "persistent-hit" | "warm"}`` —
    ``cold`` when ``nvcc`` compiled a kernel source for that signature,
    ``persistent-hit`` when a kernel library was loaded from the build
    directory, ``warm`` when nothing new was needed.  Surfaced per bucket
    in serving ``/stats``."""

    def __new__(cls, compiles, buckets=()):
        obj = super().__new__(cls, int(compiles))
        obj.buckets = list(buckets)
        return obj

    @staticmethod
    def merge(*reports, **tags):
        """Concatenate reports; ``labels=("prefill", "decode")`` stamps
        ``program: <label>`` onto every bucket of the report at that
        position."""
        labels = tags.pop("labels", None)
        buckets = []
        for i, rep in enumerate(reports):
            for b in getattr(rep, "buckets", ()):
                b = dict(b)
                if labels is not None:
                    b["program"] = labels[i]
                buckets.append(b)
        return WarmupReport(sum(int(r) for r in reports), buckets)
