"""Persistent run ledger: append-only, schema-validated JSONL step
series (docs/observability.md "Run ledger & numerics"; the port's copy
of ``paddle_tpu.obs.ledger``, in its format: a ledger directory either
package writes reads in the other).

Every step-series training-health signal the process already computes —
loss, grad/param norms, update ratio, MFU, tokens/s, datapipe stall,
HBM headroom — previously evaporated at process exit.  The ledger
persists them as a directory of JSONL segments:

* ``seg-000000.jsonl`` … sealed, immutable segments;
* ``seg-00000N.jsonl.open`` … the single active segment.

Each segment's first line is a header (``{"ledger_format": 1,
"segment": N, "rows_before": M}``); every following line is one step
row (``validate_row``).  Rotation is atomic: flush + fsync + ``os
.replace`` of the ``.open`` name to the sealed name, then a fresh
active segment.  Appends are buffered (``flush_every``) so an armed
ledger stays cheap beside a step; the disarmed path in
``Executor.run_pipeline`` is a ``None`` check.

**Exactly-once resume.** ``state_dict()`` (flush + fsync, then
``{"format", "rows_total", "last_step"}``) rides the checkpoint
sidecar exactly like datapipe iterator state: `run_pipeline` appends
the step row BEFORE ``on_step`` runs the checkpoint hook, so a
snapshot's ``rows_total`` includes its own step; on restore,
``load_state_dict`` truncates the ledger back to ``rows_total`` rows —
rows from steps after the restored checkpoint (which will be re-run)
are dropped, rows up to it are never duplicated.  Because ``note_step``
self-numbers rows (``last_step + 1``), the series stays monotonic even
though ``run_pipeline`` restarts its local step counter at 0.

**Drift alerts.** An optional drift spec (same problems-list
``validate_spec`` idiom as ``obs/slo.py``; see
``EXAMPLE_DRIFT_SPEC``) evaluates rules per appended row — ``spike``
(value > EMA × factor after a warmup), ``ceiling`` (value > max),
``floor`` (value < min).  Breaches increment ``ledger.drift_breaches``;
``sustained`` consecutive breaches of one rule write a flight-recorder
post-mortem (``ledger.drift_postmortems``) and the episode re-arms only
after the rule recovers, so a flapping signal yields one post-mortem
per episode.

``python -m paddle_tpu_torch runs tail|show|compare`` reads ledger
directories offline;
:func:`active_tail` gives the flight recorder the last-N in-memory rows
so crash dumps show the loss/grad trajectory into the fault.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import re
import time
import weakref

logger = logging.getLogger(__name__)

__all__ = ["RunLedger", "DriftWatch", "validate_spec", "validate_row",
           "validate_header", "read_rows", "tail_rows", "summarize",
           "compare", "active_tail", "LEDGER_FORMAT", "ROW_FIELDS",
           "EXAMPLE_DRIFT_SPEC"]

LEDGER_FORMAT = 1

# every optional per-step field (number or null); "step"/"time_unix"
# are the two required keys of a row
ROW_FIELDS = ("loss", "grad_norm", "param_norm", "update_ratio", "mfu",
              "tokens_per_sec", "datapipe_stall_seconds",
              "hbm_headroom_bytes")

# gauges note_step snapshots into the row (reads, not emissions — the
# writers own the registry entries)
_GAUGE_FIELDS = (("grad_norm", "train.grad_norm"),
                 ("param_norm", "train.param_norm"),
                 ("update_ratio", "train.update_ratio"),
                 ("mfu", "train.mfu"),
                 ("tokens_per_sec", "train.tokens_per_sec"),
                 ("hbm_headroom_bytes", "hbm.headroom_bytes"))

_SEG_RE = re.compile(r"^seg-(\d{6})\.jsonl(\.open)?$")

DRIFT_KINDS = ("spike", "ceiling", "floor")

# the documented drift-spec shape (a selfcheck validates this constant,
# so the validator is exercised even when no spec is armed)
EXAMPLE_DRIFT_SPEC = {
    "version": 1,
    "sustained": 2,
    "rules": [
        {"name": "loss-spike", "kind": "spike", "field": "loss",
         "factor": 10.0, "warmup": 8, "ema_beta": 0.9},
        {"name": "grad-norm-explosion", "kind": "ceiling",
         "field": "grad_norm", "max": 1e3},
    ],
}


def _is_number(v):
    return isinstance(v, (int, float)) and not isinstance(v, bool) \
        and v == v and abs(v) != float("inf")


# ---------------------------------------------------------------------------
# schema
# ---------------------------------------------------------------------------

def validate_header(obj):
    """Problems of a segment header line (empty list = valid)."""
    problems = []
    if not isinstance(obj, dict):
        return [f"header must be an object, got {type(obj).__name__}"]
    if obj.get("ledger_format") != LEDGER_FORMAT:
        problems.append(f"ledger_format must be {LEDGER_FORMAT}, "
                        f"got {obj.get('ledger_format')!r}")
    for key in ("segment", "rows_before"):
        v = obj.get(key)
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            problems.append(f"{key} must be an integer >= 0")
    return problems


def validate_row(obj):
    """Problems of one step row (empty list = valid).  Unknown keys are
    rejected — the schema is the compatibility contract ``runs
    compare`` and ``bench check`` rely on."""
    problems = []
    if not isinstance(obj, dict):
        return [f"row must be an object, got {type(obj).__name__}"]
    step = obj.get("step")
    if not isinstance(step, int) or isinstance(step, bool) or step < 0:
        problems.append("step must be an integer >= 0")
    if not _is_number(obj.get("time_unix")):
        problems.append("time_unix must be a finite number")
    allowed = {"step", "time_unix", *ROW_FIELDS}
    for key in obj:
        if key not in allowed:
            problems.append(f"unknown field {key!r}")
    for key in ROW_FIELDS:
        if key in obj and obj[key] is not None \
                and not _is_number(obj[key]):
            problems.append(f"{key} must be a finite number or null")
    return problems


def validate_spec(obj):
    """Schema problems of a drift spec dict, as a list of strings
    (empty = valid).  Never raises: a caller renders the list."""
    problems = []
    if not isinstance(obj, dict):
        return [f"spec must be a JSON object, got {type(obj).__name__}"]
    if obj.get("version") != LEDGER_FORMAT:
        problems.append(f"version must be {LEDGER_FORMAT}, "
                        f"got {obj.get('version')!r}")
    if "sustained" in obj and (not isinstance(obj["sustained"], int)
                               or isinstance(obj["sustained"], bool)
                               or obj["sustained"] < 1):
        problems.append("sustained must be an integer >= 1")
    rules = obj.get("rules")
    if not isinstance(rules, list) or not rules:
        problems.append("rules must be a non-empty list")
        return problems
    seen = set()
    for i, rule in enumerate(rules):
        where = f"rules[{i}]"
        if not isinstance(rule, dict):
            problems.append(f"{where} must be an object")
            continue
        name = rule.get("name")
        if not isinstance(name, str) or not name:
            problems.append(f"{where}.name must be a non-empty string")
        elif name in seen:
            problems.append(f"{where}.name {name!r} is duplicated")
        else:
            seen.add(name)
        kind = rule.get("kind")
        if kind not in DRIFT_KINDS:
            problems.append(
                f"{where}.kind must be one of {DRIFT_KINDS}, "
                f"got {kind!r}")
            continue
        if rule.get("field") not in ROW_FIELDS:
            problems.append(
                f"{where}.field must be one of {ROW_FIELDS}, "
                f"got {rule.get('field')!r}")
        if kind == "spike":
            if not _is_number(rule.get("factor")) \
                    or rule.get("factor") <= 1:
                problems.append(f"{where}.factor must be a number > 1")
            if "warmup" in rule and (
                    not isinstance(rule["warmup"], int)
                    or isinstance(rule["warmup"], bool)
                    or rule["warmup"] < 1):
                problems.append(f"{where}.warmup must be an "
                                "integer >= 1")
            if "ema_beta" in rule and (
                    not _is_number(rule["ema_beta"])
                    or not 0 < rule["ema_beta"] < 1):
                problems.append(f"{where}.ema_beta must be in (0, 1)")
        elif kind == "ceiling":
            if not _is_number(rule.get("max")):
                problems.append(f"{where}.max must be a finite number")
        elif kind == "floor":
            if not _is_number(rule.get("min")):
                problems.append(f"{where}.min must be a finite number")
    return problems


class DriftWatch:
    """Evaluate drift rules against each appended row.

    Mirrors ``SLOWatchdog``'s episode semantics at row granularity:
    ``sustained`` CONSECUTIVE breaches of one rule emit a single
    flight-recorder post-mortem, re-armed after the rule recovers."""

    def __init__(self, spec, metrics=None, log_limit=64):
        problems = validate_spec(spec)
        if problems:
            raise ValueError("invalid drift spec: " +
                             "; ".join(problems))
        self.spec = spec
        self.sustained = int(spec.get("sustained", 3))
        self._metrics = metrics
        self.breach_log = collections.deque(maxlen=log_limit)
        self._state = {r["name"]: {"ema": None, "n": 0, "consec": 0,
                                   "fired": False}
                       for r in spec["rules"]}

    def _judge(self, rule, value, st):
        kind = rule["kind"]
        if kind == "ceiling":
            return value > rule["max"]
        if kind == "floor":
            return value < rule["min"]
        # spike: against the EMA of previously seen values
        beta = rule.get("ema_beta", 0.9)
        warmup = rule.get("warmup", 8)
        breached = (st["n"] >= warmup and st["ema"] is not None
                    and abs(value) > abs(st["ema"]) * rule["factor"])
        if not breached:  # a spike must not drag the baseline up
            st["ema"] = value if st["ema"] is None else \
                beta * st["ema"] + (1 - beta) * value
            st["n"] += 1
        return breached

    def evaluate(self, row):
        """Judge one row; returns the list of rule names that breached."""
        breached_names = []
        for rule in self.spec["rules"]:
            value = row.get(rule["field"])
            if value is None:
                continue
            st = self._state[rule["name"]]
            if not self._judge(rule, value, st):
                st["consec"] = 0
                st["fired"] = False
                continue
            breached_names.append(rule["name"])
            st["consec"] += 1
            entry = {"rule": rule["name"], "kind": rule["kind"],
                     "field": rule["field"], "value": value,
                     "step": row.get("step"),
                     "consecutive": st["consec"]}
            self.breach_log.append(entry)
            if self._metrics is not None:
                self._metrics.inc("ledger.drift_breaches")
            logger.warning("ledger drift breach: %s", entry)
            if st["consec"] >= self.sustained and not st["fired"]:
                st["fired"] = True
                if self._metrics is not None:
                    self._metrics.inc("ledger.drift_postmortems")
                try:
                    from paddle_tpu_torch.obs import flight
                    flight.write_postmortem(
                        reason=f"ledger drift sustained: "
                               f"{rule['name']}",
                        extra={"breach": entry,
                               "row": dict(row),
                               "rule": dict(rule)})
                except Exception:  # pragma: no cover - best effort
                    pass
        return breached_names


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------

# the most recently installed ledger (weakref), for flight post-mortems
_ACTIVE = None


def active_tail(n=32):
    """Last ``n`` in-memory rows of the installed ledger (``[]`` when
    none) — embedded into flight-recorder post-mortems."""
    ref = _ACTIVE
    ledger = ref() if ref is not None else None
    if ledger is None:
        return []
    return ledger.tail(n)


class RunLedger:
    """Append-only JSONL step series over a directory of segments."""

    def __init__(self, dirname, rotate_rows=4096, flush_every=32,
                 drift_spec=None, metrics=None, install=True):
        if metrics is None:
            from paddle_tpu_torch.profiler import runtime_metrics
            metrics = runtime_metrics
        self.dirname = str(dirname)
        self.rotate_rows = max(1, int(rotate_rows))
        self.flush_every = max(1, int(flush_every))
        self._metrics = metrics
        self.drift = DriftWatch(drift_spec, metrics=metrics) \
            if drift_spec else None
        self._buf = []
        self._tail = collections.deque(maxlen=64)
        self._fh = None
        self._recover()
        if install:
            global _ACTIVE
            _ACTIVE = weakref.ref(self)

    # -- segment bookkeeping -------------------------------------------

    def _seg_path(self, index, open_=False):
        name = f"seg-{index:06d}.jsonl"
        return os.path.join(self.dirname,
                            name + (".open" if open_ else ""))

    def _list_segments(self):
        """Sorted ``(index, path, is_open)`` of every segment file."""
        out = []
        for name in os.listdir(self.dirname):
            m = _SEG_RE.match(name)
            if m:
                out.append((int(m.group(1)),
                            os.path.join(self.dirname, name),
                            bool(m.group(2))))
        out.sort()
        return out

    def _recover(self):
        os.makedirs(self.dirname, exist_ok=True)
        segs = self._list_segments()
        opens = [s for s in segs if s[2]]
        if len(opens) > 1:  # torn rotation: seal all but the newest
            for index, path, _ in opens[:-1]:
                os.replace(path, self._seg_path(index))
            segs = self._list_segments()
            opens = opens[-1:]
        if not segs:
            self._start_segment(0, 0, last_step=-1)
            return
        if opens:
            index, path, _ = opens[0]
            header, rows = _scan_segment(path, truncate_torn=True)
            if header is None:  # torn before the header landed
                rows_before = self._rows_before_from_sealed(segs, index)
                os.remove(path)
                self._start_segment(index, rows_before,
                                    last_step=self._last_sealed_step(
                                        segs, index))
                return
            self._seg_index = index
            self._seg_rows = len(rows)
            self._rows_total = header["rows_before"] + len(rows)
            self._last_step = rows[-1]["step"] if rows else \
                self._last_sealed_step(segs, index)
            self._tail.extend(rows[-self._tail.maxlen:])
            self._fh = open(path, "ab")
        else:  # sealed-only directory (clean kill after rotation)
            index = segs[-1][0] + 1
            header, rows = _scan_segment(segs[-1][1])
            rows_before = (header["rows_before"] if header else 0) \
                + len(rows)
            self._start_segment(
                index, rows_before,
                last_step=rows[-1]["step"] if rows else -1)
            self._tail.extend(rows[-self._tail.maxlen:])

    def _rows_before_from_sealed(self, segs, before_index):
        sealed = [s for s in segs if not s[2] and s[0] < before_index]
        if not sealed:
            return 0
        header, rows = _scan_segment(sealed[-1][1])
        return (header["rows_before"] if header else 0) + len(rows)

    def _last_sealed_step(self, segs, before_index):
        sealed = [s for s in segs if not s[2] and s[0] < before_index]
        if not sealed:
            return -1
        _, rows = _scan_segment(sealed[-1][1])
        return rows[-1]["step"] if rows else -1

    def _start_segment(self, index, rows_before, last_step=None):
        path = self._seg_path(index, open_=True)
        header = {"ledger_format": LEDGER_FORMAT, "segment": index,
                  "rows_before": rows_before}
        with open(path, "wb") as f:
            f.write(json.dumps(header).encode() + b"\n")
            f.flush()
            os.fsync(f.fileno())
        self._fh = open(path, "ab")
        self._seg_index = index
        self._seg_rows = 0
        self._rows_total = rows_before
        if last_step is not None:
            self._last_step = last_step

    def _flush(self, fsync=False):
        if self._buf:
            self._fh.write(b"".join(self._buf))
            self._buf = []
        self._fh.flush()
        if fsync:
            os.fsync(self._fh.fileno())

    def _rotate(self):
        self._flush(fsync=True)
        self._fh.close()
        os.replace(self._seg_path(self._seg_index, open_=True),
                   self._seg_path(self._seg_index))
        self._metrics.inc("ledger.rotations")
        self._start_segment(self._seg_index + 1, self._rows_total)

    # -- appends -------------------------------------------------------

    def append(self, row):
        """Validate + append one row dict (non-finite values sanitized
        to null first).  Returns the row as written."""
        row = dict(row)
        for key in ROW_FIELDS:
            v = row.get(key)
            if v is not None and not _is_number(v):
                row[key] = None
        problems = validate_row(row)
        if problems:
            raise ValueError("invalid ledger row: " +
                             "; ".join(problems))
        self._buf.append(json.dumps(row, allow_nan=False).encode()
                         + b"\n")
        self._seg_rows += 1
        self._rows_total += 1
        self._last_step = row["step"]
        self._tail.append(row)
        self._metrics.inc("ledger.rows")
        if self.drift is not None:
            self.drift.evaluate(row)
        if self._seg_rows >= self.rotate_rows:
            self._rotate()
        elif len(self._buf) >= self.flush_every:
            self._flush()
        return row

    def note_step(self, step=None, fetch_names=(), fetches=(),
                  stall_seconds=None, loss=None):
        """Build and append one step row from the training loop's
        fetches plus the gauges the process already maintains.

        ``step=None`` self-numbers (``last_step + 1``): `run_pipeline`
        restarts its local counter at 0 on every call, but the ledger
        series must stay monotonic across resumes."""
        if step is None:
            step = self._last_step + 1
        if loss is None:
            loss = _first_scalar(fetch_names, fetches)
        row = {"step": int(step), "time_unix": time.time(),
               "loss": loss}
        for field, gauge in _GAUGE_FIELDS:
            v = self._metrics.gauge(gauge)
            if v is not None:
                row[field] = v
        if stall_seconds is not None:
            row["datapipe_stall_seconds"] = float(stall_seconds)
        return self.append(row)

    # -- resume (checkpoint sidecar) -----------------------------------

    def state_dict(self):
        """Durable resume cursor (flushes + fsyncs first, so a crash
        can never leave fewer rows on disk than a saved sidecar
        claims)."""
        self._flush(fsync=True)
        return {"format": LEDGER_FORMAT,
                "rows_total": self._rows_total,
                "last_step": self._last_step}

    def load_state_dict(self, state):
        """Rewind the ledger to exactly ``state["rows_total"]`` rows
        (the restore half of exactly-once resume).  Raises
        ``ValueError`` when the sidecar is malformed or claims more
        rows than exist."""
        if not isinstance(state, dict) \
                or state.get("format") != LEDGER_FORMAT:
            raise ValueError(
                f"ledger sidecar format mismatch: expected "
                f"{LEDGER_FORMAT}, got "
                f"{state.get('format') if isinstance(state, dict) else state!r}")
        target = state.get("rows_total")
        if not isinstance(target, int) or isinstance(target, bool) \
                or target < 0:
            raise ValueError("ledger sidecar rows_total must be an "
                             "integer >= 0")
        self._flush(fsync=True)
        if target > self._rows_total:
            raise ValueError(
                f"ledger sidecar claims {target} rows but only "
                f"{self._rows_total} exist (history lost?)")
        if target == self._rows_total:
            return
        removed = self._rows_total - target
        self._fh.close()
        self._fh = None
        segs = self._list_segments()
        kept_last_step = -1
        boundary = None
        for index, path, is_open in segs:
            header, rows = _scan_segment(path)
            rows_before = header["rows_before"] if header else 0
            if boundary is not None or rows_before + len(rows) > target:
                if boundary is None:
                    boundary = index
                    keep = rows[:target - rows_before]
                    tmp = path + ".tmp"
                    with open(tmp, "wb") as f:
                        f.write(json.dumps(
                            {"ledger_format": LEDGER_FORMAT,
                             "segment": index,
                             "rows_before": rows_before}).encode()
                            + b"\n")
                        for r in keep:
                            f.write(json.dumps(r).encode() + b"\n")
                        f.flush()
                        os.fsync(f.fileno())
                    os.replace(tmp, self._seg_path(index, open_=True))
                    if not is_open:
                        os.remove(path)
                    if keep:
                        kept_last_step = keep[-1]["step"]
                else:
                    os.remove(path)
            else:
                if rows:
                    kept_last_step = rows[-1]["step"]
        self._fh = open(self._seg_path(boundary, open_=True), "ab")
        self._seg_index = boundary
        header, rows = _scan_segment(
            self._seg_path(boundary, open_=True))
        self._seg_rows = len(rows)
        self._rows_total = target
        self._last_step = kept_last_step
        self._tail.clear()
        self._tail.extend(rows[-self._tail.maxlen:])
        self._metrics.inc("ledger.rewound_rows", removed)
        logger.info("ledger rewound %d rows to %d (step %d)",
                    removed, target, self._last_step)

    # -- readers -------------------------------------------------------

    def tail(self, n=32):
        n = max(0, int(n))
        rows = list(self._tail)
        return rows[len(rows) - n:] if n else []

    @property
    def rows_total(self):
        return self._rows_total

    @property
    def last_step(self):
        return self._last_step

    def flush(self):
        self._flush(fsync=True)

    def close(self):
        if self._fh is not None:
            self._flush(fsync=True)
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# offline readers (`python -m paddle_tpu_torch runs ...`)
# ---------------------------------------------------------------------------

def _scan_segment(path, truncate_torn=False):
    """``(header, rows)`` of one segment file; a torn tail (partial or
    invalid trailing line after a kill) is ignored — and physically
    truncated away when ``truncate_torn`` (recovery of the active
    segment, so the append handle starts at a clean line boundary)."""
    header = None
    rows = []
    with open(path, "rb") as f:
        data = f.read()
    good = 0
    pos = 0
    while pos < len(data):
        nl = data.find(b"\n", pos)
        if nl < 0:
            break  # no trailing newline: torn mid-line
        line = data[pos:nl]
        pos = nl + 1
        if not line.strip():
            good = pos
            continue
        try:
            obj = json.loads(line)
        except ValueError:
            break
        if header is None:
            if validate_header(obj):
                break
            header = obj
        else:
            if validate_row(obj):
                break
            rows.append(obj)
        good = pos
    if truncate_torn and good < len(data):
        with open(path, "r+b") as f:
            f.truncate(good)
    return header, rows


def read_rows(dirname):
    """All rows of a ledger directory, in order.  Raises ``ValueError``
    on an unreadable directory."""
    ledger_dir = str(dirname)
    if not os.path.isdir(ledger_dir):
        raise ValueError(f"not a ledger directory: {ledger_dir}")
    segs = []
    for name in os.listdir(ledger_dir):
        m = _SEG_RE.match(name)
        if m:
            segs.append((int(m.group(1)),
                         os.path.join(ledger_dir, name)))
    if not segs:
        raise ValueError(f"no ledger segments in {ledger_dir}")
    segs.sort()
    rows = []
    for _, path in segs:
        _, seg_rows = _scan_segment(path)
        rows.extend(seg_rows)
    return rows


def tail_rows(dirname, n=10):
    rows = read_rows(dirname)
    return rows[max(0, len(rows) - max(0, int(n))):]


def _series_summary(rows, field):
    values = [r[field] for r in rows
              if r.get(field) is not None]
    if not values:
        return None
    return {"first": values[0], "last": values[-1],
            "min": min(values), "max": max(values),
            "samples": len(values)}


def summarize(dirname):
    """The ``runs show`` body: row/segment counts, step range, and a
    first/last/min/max digest per field."""
    rows = read_rows(dirname)
    segs = sum(1 for name in os.listdir(str(dirname))
               if _SEG_RE.match(name))
    out = {"dir": str(dirname), "rows": len(rows), "segments": segs,
           "first_step": rows[0]["step"] if rows else None,
           "last_step": rows[-1]["step"] if rows else None,
           "fields": {}}
    for field in ROW_FIELDS:
        s = _series_summary(rows, field)
        if s is not None:
            out["fields"][field] = s
    return out


def compare(dir_a, dir_b):
    """The ``runs compare`` body: per-field digests of both runs plus
    the last-value delta on the steps both ledgers cover."""
    a, b = summarize(dir_a), summarize(dir_b)
    deltas = {}
    for field in ROW_FIELDS:
        sa, sb = a["fields"].get(field), b["fields"].get(field)
        if sa is None or sb is None:
            continue
        deltas[field] = {"a_last": sa["last"], "b_last": sb["last"],
                         "delta_last": sb["last"] - sa["last"]}
    return {"a": a, "b": b, "deltas": deltas}


def _first_scalar(fetch_names, fetches):
    """The loss heuristic: the first fetched value that collapses to a
    finite scalar float (training loops fetch loss first).  A fetched
    tensor (``return_numpy=False``; bfloat16 included) is read on the
    host."""
    import numpy as np
    for _, value in zip(fetch_names, fetches):
        if hasattr(value, "detach"):          # a torch tensor
            if value.numel() != 1 or not value.is_floating_point():
                continue
            v = float(value.detach().float().reshape(()).item())
            return v if v == v and abs(v) != float("inf") else None
        try:
            arr = np.asarray(value)
        except Exception:
            continue
        if arr.size == 1 and getattr(arr.dtype, "kind", None) == "f":
            v = float(arr.reshape(()))
            return v if v == v and abs(v) != float("inf") else None
    return None
