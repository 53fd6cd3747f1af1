"""Bench trajectory: machine-checked performance history (the port's
copy of ``paddle_tpu.obs.bench_history``, over a file of its own).

A bench script of the port can append its headline metrics to
``BENCH_TRAJECTORY_TORCH.json`` through :func:`record`, and ``python -m
paddle_tpu_torch bench check`` compares the NEWEST run of each bench
against its recorded BASELINE under per-metric tolerance bands, exiting
nonzero on regression, so a change that quietly halves tokens/s fails a
gate instead of landing silently.  The port's trajectory is its own
file beside the JAX package's ``BENCH_TRAJECTORY.json``, whose figures
were taken on a TPU: :func:`default_path` never resolves to it.  No
trajectory exists until a bench records one; ``bench check`` on a
missing file reports that it cannot read it and fails.

File format (``"format": 1``, the JAX package's)::

    {"format": 1, "runs": [
        {"bench": "decode", "time_unix": 1753900000.0,
         "baseline": true,                  # optional; first run else
         "source": "bench summary JSON",    # optional provenance
         "metrics": {"tokens_per_sec": 217.8, ...}}
    ]}

Baseline selection per bench: the LAST run flagged ``"baseline":
true``, else the first recorded run.  Newest = the last recorded run.
Tolerance bands live in :data:`BENCH_METRICS` (direction + band per
metric); a baseline entry may override them via a ``"tolerances"``
mapping of the same shape.  Metrics absent from the table (or from
either run) are reported but never judged: a bench may grow metrics
without invalidating its history.  A run's ``mfu_basis`` is one of the
port's ``obs.perf.MFU_BASES`` (``gpu-peak``, ``cpu-fallback``); a run
tagged otherwise (``tpu-peak``) fails the schema.
"""

from __future__ import annotations

import json
import os
import time

__all__ = ["TRAJECTORY_FILE", "BENCH_METRICS", "MFU_BASES", "record",
           "check",
           "load_trajectory", "validate_trajectory", "summary_metrics",
           "default_path", "add_record_args", "record_from_args"]

TRAJECTORY_FILE = "BENCH_TRAJECTORY_TORCH.json"
FORMAT = 1

# direction: "higher" / "lower" with a RELATIVE tolerance band (0.25 =
# newest may be up to 25% worse than baseline before it counts as a
# regression: bench hosts are noisy); "max_abs" is an
# ABSOLUTE ceiling above baseline (failures: 0 means zero, always).
BENCH_METRICS = {
    "serving": {"rps_batched": ("higher", 0.30),
                "speedup": ("higher", 0.30),
                "p99_ms": ("lower", 0.75)},
    "datapipe": {"samples_per_sec": ("higher", 0.30),
                 "speedup": ("higher", 0.30)},
    "fleet": {"rps_aggregate": ("higher", 0.30),
              "scaling": ("higher", 0.25),
              "kill_failures": ("max_abs", 0.0)},
    "decode": {"tokens_per_sec": ("higher", 0.30),
               "tokens_per_sec_ratio": ("higher", 0.25),
               "ttft_p99_ms": ("lower", 0.75),
               "lost_requests": ("max_abs", 0.0)},
    "paged": {"speedup": ("higher", 0.30),
              "bytes_ratio": ("lower", 0.10),
              "paged_step_ms": ("lower", 0.75)},
    "elastic": {"resume_seconds": ("lower", 1.00),
                "loss_delta_rel": ("max_abs", 1e-3),
                "reshard_failures": ("max_abs", 0.0)},
    # the sharded-embedding gate: per-device table bytes must stay
    # ~1/N of replicated (the memory-scaling claim), the dp4->dp2
    # shrink drill must restore the sharded table + sparse moments
    # within the acceptance loss tolerance, and the sparse update must
    # keep scaling with touched rows, not vocab (a 4x vocab may not
    # move the step time past noise)
    "embedding": {"table_bytes_ratio": ("lower", 0.10),
                  "loss_delta_rel": ("max_abs", 1e-6),
                  "reshard_failures": ("max_abs", 0.0),
                  "step_time_vocab_ratio": ("lower", 0.75)},
    # the cold-start gate: the second-best per-model trace+compile
    # reduction IS the "at least two zoo models improve >=15%"
    # acceptance floor, and the steady step must stay ~1 (the passes
    # may only remove work XLA would have DCE'd anyway)
    "compile": {"reduction_best": ("higher", 0.35),
                "reduction_second_best": ("higher", 0.35),
                "step_time_ratio_worst": ("lower", 0.15)},
    # the autoscale gate: the controller fleet's p99 under the 5×
    # step, at least as many scale-ups as baseline (the loop must keep
    # acting), and the two zero-always invariants — no lost accepted
    # requests in the kill drill, no shed without a Retry-After hint
    "autoscale": {"p99_controller_ms": ("lower", 0.75),
                  "scale_ups": ("higher", 0.50),
                  "lost_accepted": ("max_abs", 0.0),
                  "sheds_without_retry_after": ("max_abs", 0.0)},
    # the resumable-session gate: the kill-owner chaos drill must
    # lose/duplicate ZERO tokens and error ZERO streams (exactly-once
    # delivery is an invariant, not a tolerance), the worst
    # failover-induced token gap must stay bounded, and a resumed
    # stream may not cost more than the band over an unkilled one
    "gen_failover": {"ttft_after_failover_ms": ("lower", 0.75),
                     "resume_overhead_ratio": ("lower", 0.50),
                     "lost_tokens": ("max_abs", 0.0),
                     "dup_tokens": ("max_abs", 0.0),
                     "client_errors": ("max_abs", 0.0)},
    "train_transformer": {"tokens_per_sec_per_chip": ("higher", 0.10),
                          "mfu": ("higher", 0.05),
                          # measured (cost-analysis-based) MFU from the
                          # live train.mfu gauge, and the cold-process
                          # compile wall time (trace+lower+backend
                          # across captured jit keys) — ROADMAP item
                          # 5's optimizer passes are judged against
                          # exactly these two
                          "measured_mfu": ("higher", 0.10),
                          "compile_seconds": ("lower", 0.50)},
}

#: legal values of a run's ``mfu_basis`` tag — one definition, owned
#: by the module that emits the tag (peak_flops_info)
from paddle_tpu_torch.obs.perf import MFU_BASES  # noqa: E402


def default_path():
    """The port's trajectory, ``BENCH_TRAJECTORY_TORCH.json`` at the
    repo root (beside the JAX package's ``BENCH_TRAJECTORY.json``, which
    it never names), resolved relative to the installed package."""
    import paddle_tpu_torch
    root = os.path.dirname(os.path.dirname(
        os.path.abspath(paddle_tpu_torch.__file__)))
    return os.path.join(root, TRAJECTORY_FILE)


# ---------------------------------------------------------------------------
# schema
# ---------------------------------------------------------------------------

def validate_trajectory(obj):
    """Schema problems as a list of strings (empty = valid); the
    ``bench check --dry`` / selfcheck gate."""
    problems = []
    if not isinstance(obj, dict):
        return [f"trajectory must be a JSON object, "
                f"got {type(obj).__name__}"]
    if obj.get("format") != FORMAT:
        problems.append(f"format must be {FORMAT}, "
                        f"got {obj.get('format')!r}")
    runs = obj.get("runs")
    if not isinstance(runs, list):
        return problems + ["runs must be a list"]
    for i, run in enumerate(runs):
        where = f"runs[{i}]"
        if not isinstance(run, dict):
            problems.append(f"{where}: must be an object")
            continue
        if not isinstance(run.get("bench"), str) or not run.get("bench"):
            problems.append(f"{where}: needs a non-empty bench name")
        t = run.get("time_unix")
        if not isinstance(t, (int, float)) or isinstance(t, bool) or \
                t <= 0:
            problems.append(f"{where}: needs a positive time_unix")
        metrics = run.get("metrics")
        if not isinstance(metrics, dict) or not metrics:
            problems.append(f"{where}: needs a non-empty metrics object")
        else:
            for k, v in metrics.items():
                if not isinstance(k, str):
                    problems.append(f"{where}: metric keys must be "
                                    f"strings")
                    break
                if not isinstance(v, (int, float)) or \
                        isinstance(v, bool) or v != v:
                    problems.append(f"{where}: metric {k!r} must be a "
                                    f"finite number, got {v!r}")
        if "baseline" in run and not isinstance(run["baseline"], bool):
            problems.append(f"{where}: baseline must be a boolean")
        if "ledger" in run:
            # optional provenance pointer at the run's ledger directory
            # (obs.ledger): `bench check` refuses a record whose ledger
            # schema version this build cannot read — comparing against
            # rows it would misparse proves nothing
            from paddle_tpu_torch.obs.ledger import LEDGER_FORMAT
            led = run["ledger"]
            if not isinstance(led, dict):
                problems.append(f"{where}: ledger must be an object")
            else:
                if not isinstance(led.get("path"), str) \
                        or not led.get("path"):
                    problems.append(f"{where}: ledger.path must be a "
                                    f"non-empty string")
                if led.get("format") != LEDGER_FORMAT:
                    problems.append(
                        f"{where}: ledger.format must be "
                        f"{LEDGER_FORMAT}, got {led.get('format')!r} "
                        f"(malformed ledger schema version)")
        if "mfu_basis" in run and run["mfu_basis"] not in MFU_BASES:
            problems.append(f"{where}: mfu_basis must be one of "
                            f"{MFU_BASES}, got {run['mfu_basis']!r}")
        if "tolerances" in run:
            tol = run["tolerances"]
            if not isinstance(tol, dict):
                problems.append(f"{where}: tolerances must be an object")
            else:
                for k, v in tol.items():
                    if (not isinstance(v, (list, tuple)) or len(v) != 2
                            or v[0] not in ("higher", "lower", "max_abs")
                            or not isinstance(v[1], (int, float))
                            or isinstance(v[1], bool) or v[1] < 0):
                        problems.append(
                            f"{where}: tolerances[{k!r}] must be "
                            f"[\"higher\"|\"lower\"|\"max_abs\", "
                            f"band>=0]")
    return problems


def load_trajectory(path=None):
    """Load and schema-validate; raises ``ValueError`` on any problem
    (including unreadable/non-JSON files)."""
    path = path or default_path()
    try:
        with open(path) as f:
            obj = json.load(f)
    except OSError as e:
        raise ValueError(f"cannot read trajectory {path!r}: {e}")
    except json.JSONDecodeError as e:
        raise ValueError(f"trajectory {path!r} is not JSON: {e}")
    problems = validate_trajectory(obj)
    if problems:
        raise ValueError(f"trajectory {path!r} fails schema:\n  "
                         + "\n  ".join(problems))
    return obj


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------

def record(bench, metrics, path=None, baseline=False, source=None,
           meta=None, now=None, mfu_basis=None):
    """Append one run to the trajectory (atomic tmp+rename; creates the
    file on first use).  Returns the run entry written.

    ``mfu_basis`` tags what peak the run's MFU numbers were computed
    against (``"gpu-peak"`` / ``"cpu-fallback"``, see
    ``obs.perf.peak_flops_info``); :func:`check` REFUSES to compare a
    bench across bases, so a CPU smoke run can neither pass nor fail
    against a card's baseline."""
    from paddle_tpu_torch import profiler as _profiler
    path = path or default_path()
    entry = {"bench": str(bench),
             "time_unix": float(now if now is not None else time.time()),
             "metrics": {str(k): float(v) for k, v in metrics.items()}}
    if baseline:
        entry["baseline"] = True
    if mfu_basis is not None:
        entry["mfu_basis"] = str(mfu_basis)
    if source:
        entry["source"] = str(source)
    if meta:
        entry["meta"] = meta
    problems = validate_trajectory({"format": FORMAT, "runs": [entry]})
    if problems:
        raise ValueError("refusing to record an invalid run:\n  "
                         + "\n  ".join(problems))
    if os.path.exists(path):
        obj = load_trajectory(path)
    else:
        obj = {"format": FORMAT, "runs": []}
    obj["runs"].append(entry)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _profiler.runtime_metrics.inc("bench.recorded")
    return entry


def summary_metrics(bench, summary):
    """Flatten a bench script's summary dict into the trajectory's
    headline metrics for that bench (the shared extraction the scripts
    and the import path both use)."""
    if bench == "serving":
        return {"rps_batched": summary["batched"]["rps"],
                "speedup": summary["speedup"],
                "p99_ms": summary["batched"]["latency_ms"]["p99"]}
    if bench == "datapipe":
        return {"samples_per_sec": summary["datapipe"]
                ["samples_per_sec"],
                "speedup": summary["speedup"]}
    if bench == "fleet":
        scale_key = max((k for k in summary["fleet"] if k != "1"),
                        key=int)
        return {"rps_aggregate": summary["fleet"][scale_key]["rps"],
                "scaling": summary["scaling"],
                "kill_failures": summary["kill_drill"]["failures"]}
    if bench == "decode":
        cont = summary["modes"]["continuous"]
        return {"tokens_per_sec": cont["tokens_per_sec"],
                "tokens_per_sec_ratio": summary["tokens_per_sec_ratio"],
                "ttft_p99_ms": summary["ttft_p99_ms"]["continuous"],
                "lost_requests": cont["failures"]}
    if bench == "paged":
        return {"speedup": summary["speedup"],
                "bytes_ratio": summary["bytes_ratio"],
                "paged_step_ms": summary["paged"]["decode_step_ms"]}
    if bench == "compile":
        return {"reduction_best": summary["reduction_best"],
                "reduction_second_best":
                    summary["reduction_second_best"],
                "models_ge_15pct": summary["models_ge_15pct"],
                "step_time_ratio_worst":
                    summary["step_time_ratio_worst"]}
    if bench == "elastic":
        return {"resume_seconds": summary["resume"]["restore_seconds"],
                "loss_delta_rel": summary["loss_delta_rel"],
                "reshard_failures": summary["reshard_failures"]}
    if bench == "embedding":
        return {"table_bytes_ratio": summary["table_bytes_ratio"],
                "loss_delta_rel": summary["loss_delta_rel"],
                "reshard_failures": summary["reshard_failures"],
                "step_time_vocab_ratio":
                    summary["sparse_scaling"]["step_time_vocab_ratio"]}
    if bench == "autoscale":
        ctrl = summary["modes"]["controller"]
        return {"p99_controller_ms": ctrl["p99_ms"],
                "scale_ups": ctrl["scale_ups"],
                "lost_accepted":
                    summary["kill_drill"]["traffic"]["lost_accepted"],
                "sheds_without_retry_after":
                    summary["sheds_without_retry_after"]}
    if bench == "gen_failover":
        kill = summary["kill_drill"]
        return {"ttft_after_failover_ms": kill["ttft_after_failover_ms"],
                "resume_overhead_ratio":
                    summary["resume_overhead_ratio"],
                "lost_tokens": kill["lost_tokens"],
                "dup_tokens": kill["dup_tokens"],
                "client_errors": (kill["client_errors"]
                                  + summary["drain_drill"]
                                  ["client_errors"])}
    if bench == "train_transformer":
        out = {"tokens_per_sec_per_chip":
               summary["tokens_per_sec_per_chip"],
               "mfu": summary["mfu"]}
        for opt in ("measured_mfu", "compile_seconds"):
            if summary.get(opt) is not None:
                out[opt] = summary[opt]
        return out
    raise ValueError(f"no trajectory extraction for bench {bench!r} "
                     f"(known: serving, datapipe, fleet, decode, paged, "
                     f"elastic, embedding, compile, train_transformer, "
                     f"autoscale, gen_failover)")


def add_record_args(parser):
    """The bench scripts' shared ``--record-trajectory`` /
    ``--record-baseline`` argparse flags (one definition, four
    scripts)."""
    parser.add_argument(
        "--record-trajectory", default=None, metavar="PATH",
        help="append this run's headline metrics to the bench "
             "trajectory ('default' = the repo's "
             "BENCH_TRAJECTORY_TORCH.json; `python -m paddle_tpu_torch "
             "bench check` gates on it)")
    parser.add_argument(
        "--record-baseline", action="store_true",
        help="flag the recorded run as the comparison baseline")


def record_from_args(bench, summary, args, source, mfu_basis=None):
    """The bench scripts' shared recording tail: extract ``bench``'s
    headline metrics from ``summary`` and append them per the
    :func:`add_record_args` flags.  No-op (returns None) when
    ``--record-trajectory`` was not given."""
    if not getattr(args, "record_trajectory", None):
        return None
    return record(
        bench, summary_metrics(bench, summary),
        path=(None if args.record_trajectory == "default"
              else args.record_trajectory),
        baseline=args.record_baseline, source=source,
        mfu_basis=mfu_basis)


# ---------------------------------------------------------------------------
# checking
# ---------------------------------------------------------------------------

def _judge(direction, band, base, new):
    """(ok, bound) under one tolerance band.  The relative slack is
    ``|base| * band`` — for a NEGATIVE baseline, ``base * (1 - band)``
    would tighten instead of loosen (a -2% compile-reduction baseline
    must not fail an identical -2% run)."""
    slack = abs(base) * band
    if direction == "higher":
        bound = base - slack
        return new >= bound, bound
    if direction == "lower":
        bound = base + slack
        return new <= bound, bound
    # max_abs: absolute ceiling above baseline
    bound = base + band
    return new <= bound, bound


def check(path=None, dry=False):
    """Compare each bench's newest run against its baseline.

    Returns ``{"ok", "problems", "benches": {name: {"baseline",
    "newest", "comparisons", "regressions"}}}``.  ``dry=True`` stops
    after schema validation (the selfcheck gate).  Schema problems OR
    any regression flip ``ok`` to False."""
    from paddle_tpu_torch import profiler as _profiler
    path = path or default_path()
    report = {"ok": True, "path": path, "problems": [], "benches": {}}
    _profiler.runtime_metrics.inc("bench.checks")
    try:
        obj = load_trajectory(path)
    except ValueError as e:
        report["ok"] = False
        report["problems"] = str(e).splitlines()
        return report
    if dry:
        return report
    by_bench = {}
    for run in obj["runs"]:
        by_bench.setdefault(run["bench"], []).append(run)
    for bench, runs in sorted(by_bench.items()):
        baselines = [r for r in runs if r.get("baseline")]
        base = baselines[-1] if baselines else runs[0]
        newest = runs[-1]
        base_basis = base.get("mfu_basis")
        new_basis = newest.get("mfu_basis")
        if base_basis != new_basis and (base_basis or new_basis):
            # comparing a cpu-fallback MFU (peak 1e12, "meaningless but
            # finite") against a gpu-peak baseline — or an untagged run
            # against a tagged one — proves nothing either way: refuse
            # instead of silently passing or failing
            report["ok"] = False
            report["problems"].append(
                f"bench {bench!r}: baseline mfu_basis="
                f"{base_basis!r} but newest run is {new_basis!r} — "
                f"refusing to compare MFU records across bases "
                f"(re-record the baseline on this hardware, or drop "
                f"the cross-basis run)")
            report["benches"][bench] = {
                "runs": len(runs),
                "baseline_time_unix": base["time_unix"],
                "newest_time_unix": newest["time_unix"],
                "comparisons": [],
                "regressions": [],
                "basis_mismatch": {"baseline": base_basis,
                                   "newest": new_basis},
            }
            continue
        tolerances = dict(BENCH_METRICS.get(bench, {}))
        tolerances.update({k: tuple(v) for k, v
                           in (base.get("tolerances") or {}).items()})
        comparisons = []
        regressions = []
        for metric, (direction, band) in sorted(tolerances.items()):
            if metric not in base["metrics"] or \
                    metric not in newest["metrics"]:
                continue
            b, n = base["metrics"][metric], newest["metrics"][metric]
            ok, bound = _judge(direction, band, b, n)
            row = {"metric": metric, "direction": direction,
                   "band": band, "baseline": b, "newest": n,
                   "bound": bound, "ok": ok}
            comparisons.append(row)
            if not ok:
                regressions.append(row)
                _profiler.runtime_metrics.inc("bench.regressions")
        report["benches"][bench] = {
            "runs": len(runs),
            "baseline_time_unix": base["time_unix"],
            "newest_time_unix": newest["time_unix"],
            "comparisons": comparisons,
            "regressions": regressions,
        }
        if regressions:
            report["ok"] = False
    return report
