"""Command-line entry points of the port (the serving and static-analysis
parts of ``paddle_tpu.cli``).

Usage: ``python -m paddle_tpu_torch <command> ...``

  serve    --model DIR --port P      HTTP inference server (--batch
                                     --warmup; --place cpu runs on the
                                     CPU, the default is cuda:0)
  generate --addr HOST:PORT --prompt "1 2 3"
                                     stream tokens from /generate
  stats    --addr HOST:PORT          runtime metrics snapshot of a
                                     serving replica (/stats); --local
                                     for this process; --prom for
                                     Prometheus text
  lint     MODEL_DIR | --zoo NAME    static analysis of a program IR
                                     (PTA*** diagnostics; --json,
                                     --strict, --dot OUT, --verbose)
  opt      MODEL_DIR | --zoo NAME    the optimization pass pipeline,
                                     offline: per-pass stats (--json,
                                     --passes a,b)

``serve --master`` (fleet enrollment) and ``--compile-cache`` (the JAX
package's persistent XLA cache) raise: the fleet is not ported yet, and
the port's kernels always build into the build directory beside their
sources.  ``lint --pair`` and ``lint --pipeline`` raise until the
multi-device transpilers are ported (ROADMAP queue 1 item 7), and
``selfcheck`` raises until the planes it checks are (it follows item
10).
"""

from __future__ import annotations

import argparse
import sys

__all__ = ["main"]


def _place(name):
    from paddle_tpu_torch.place import CPUPlace, CUDAPlace
    if name == "cpu":
        return CPUPlace()
    if name.startswith("cuda"):
        return CUDAPlace(int(name.partition(":")[2] or 0))
    raise ValueError(f"--place must be cpu or cuda[:N], got {name!r}")


def _cmd_serve(args):
    """HTTP inference server over a saved model or a generation bundle."""
    if args.master:
        raise NotImplementedError(
            "serve --master needs the fleet master and replica "
            "(parallel/master.py, fleet/replica.py), not ported yet: "
            "ROADMAP queue 1 item 8")
    if args.compile_cache:
        raise NotImplementedError(
            "serve --compile-cache: the port has no XLA compilation "
            "cache; its CUDA kernels build once into "
            "paddle_tpu_torch/kernels/_build/ and are reused from there")
    from paddle_tpu_torch.serving import serve
    warmup_sizes = None
    if args.warmup_batch_sizes:
        warmup_sizes = [int(s) for s in args.warmup_batch_sizes.split(",")]
    serve(args.model, host=args.host, port=args.port,
          async_load=args.async_load, max_inflight=args.max_inflight,
          request_timeout=args.request_timeout, batching=args.batch,
          max_batch_size=args.max_batch_size,
          max_batch_delay=args.max_batch_delay,
          batch_queue_size=args.batch_queue_size, warmup=args.warmup,
          warmup_batch_sizes=warmup_sizes,
          gen_admission=args.gen_admission,
          gen_queue_size=args.gen_queue_size, place=_place(args.place))
    return 0


def _cmd_generate(args):
    """Streaming generation client: POST /generate and print tokens as
    the chunks arrive."""
    from paddle_tpu_torch.serving import ServingClient
    prompt = [int(t) for t in args.prompt.replace(",", " ").split()]
    client = ServingClient(args.addr, timeout=args.timeout,
                           deadline=args.deadline)
    tokens = []
    for ev in client.generate(prompt, max_new_tokens=args.max_new,
                              eos_id=args.eos_id,
                              stream=not args.no_stream,
                              session_id=args.session_id,
                              resume=not args.no_resume):
        if "token" in ev:
            tokens.append(ev["token"])
            print(ev["token"], flush=True)
        elif ev.get("error"):
            err = ev["error"]
            print(f"error: {err.get('type')}: {err.get('message')}",
                  flush=True)
            return 1
        elif ev.get("done"):
            if ev.get("tokens") and not tokens:
                # stream=false: the buffered reply carries them all
                print(" ".join(str(t) for t in ev["tokens"]), flush=True)
            print(f"# done ({ev.get('finish_reason')})", flush=True)
    return 0


def _cmd_stats(args):
    """Fetch and render a server's /stats metrics snapshot (or this
    process's own registry with --local)."""
    import json as _json

    if args.prom:
        if args.local:
            from paddle_tpu_torch.obs.prom import render_prometheus
            print(render_prometheus(), end="")
        elif args.addr:
            from paddle_tpu_torch.serving import ServingClient
            print(ServingClient(args.addr).prom_metrics(), end="")
        else:
            print("stats: need --addr HOST:PORT or --local",
                  file=sys.stderr)
            return 2
        return 0
    if args.local:
        from paddle_tpu_torch.profiler import runtime_metrics
        snap = runtime_metrics.snapshot()
    elif args.addr:
        from paddle_tpu_torch.serving import ServingClient
        snap = ServingClient(args.addr).stats()
    else:
        print("stats: need --addr HOST:PORT or --local", file=sys.stderr)
        return 2
    if args.json:
        print(_json.dumps(snap, indent=2, sort_keys=True))
        return 0
    for name, v in sorted((snap.get("counters") or {}).items()):
        print(f"{name:<36}{v:>12}")
    for name, s in sorted((snap.get("series") or {}).items()):
        p50, p95, p99 = s.get("p50"), s.get("p95"), s.get("p99")
        fmt = (lambda x: f"{x * 1e3:.2f}ms" if isinstance(x, (int, float))
               else "-")
        print(f"{name:<36}count={s.get('count', 0):<8}"
              f"p50={fmt(p50):<10}p95={fmt(p95):<10}p99={fmt(p99)}")
    for name, v in sorted((snap.get("gauges") or {}).items()):
        print(f"{name:<36}{v:>12g}")
    for name, hist in sorted((snap.get("histograms") or {}).items()):
        print(f"{name}: " + " ".join(f"{k}:{v}" for k, v in hist.items()))
    srv = snap.get("server") or {}
    if srv:
        print("server: " + " ".join(f"{k}={v}"
                                    for k, v in sorted(srv.items())))
    return 0


#: ROADMAP's item for the multi-program lint modes
_TRANSPILERS_ITEM = ("needs the multi-device transpilers "
                     "(distribute_transpiler, pipeline_transpiler) and "
                     "the rest of analysis/distributed.py, not ported "
                     "yet: ROADMAP queue 1 item 7")


def _zoo_targets(args, cmd):
    """``(label, program, feeds, fetches)`` of ``--zoo NAME|all``: each
    model's main program and its startup; None after printing why."""
    from paddle_tpu_torch.models import ZOO_MODELS, build_train_program
    names = ZOO_MODELS if args.zoo == "all" else [args.zoo]
    targets = []
    for name in names:
        try:
            main, startup, feeds, fetches = build_train_program(
                name, backward=not args.no_backward)
        except ValueError as e:
            print(f"{cmd}: {e}", file=sys.stderr)
            return None
        targets.append((name, main, feeds, fetches))
        targets.append((f"{name}/startup", startup, None, None))
    return targets


def _saved_target(target, cmd):
    """``[(label, program, feeds, fetches)]`` of a saved model dir or a
    ``__model__`` json file; None after printing why."""
    from paddle_tpu_torch.analysis.distributed import load_saved_program
    try:
        program, feeds, fetches = load_saved_program(target)
    except (OSError, ValueError, KeyError) as e:
        print(f"{cmd}: cannot load a program from {target!r}: {e}",
              file=sys.stderr)
        return None
    return [(target, program, feeds, fetches)]


def _cmd_lint(args):
    """Static analysis over a Program IR (``paddle_tpu_torch.analysis``):
    lint a saved inference model (its ``__model__`` program; no params or
    executor needed — the analysis is static), a generation bundle
    (prefill + decode + the cross-program signature checks) or a
    model-zoo program built forward+backward.  Prints rustc-style
    diagnostics with stable ``PTA***`` codes; exit 0 = clean, 1 =
    findings (errors always; warnings only under --strict), 2 = bad
    target."""
    import os

    from paddle_tpu_torch import analysis

    if args.pair:
        raise NotImplementedError(f"lint --pair {_TRANSPILERS_ITEM}")
    if args.pipeline:
        raise NotImplementedError(f"lint --pipeline {_TRANSPILERS_ITEM}")
    if args.target and os.path.isdir(args.target) and \
            os.path.isfile(os.path.join(args.target, "gen_meta.json")):
        try:
            results = analysis.lint_gen_bundle(args.target)
        except (OSError, ValueError, KeyError) as e:
            print(f"lint: cannot load the gen bundle at "
                  f"{args.target!r}: {e}", file=sys.stderr)
            return 2
        if args.dot:
            print("lint: --dot renders exactly one main program "
                  "(not a gen-bundle family)", file=sys.stderr)
            return 2
        return _report_lint(results, args)

    if args.zoo:
        targets = _zoo_targets(args, "lint")
    elif args.target:
        targets = _saved_target(args.target, "lint")
    else:
        print("lint: need a MODEL_DIR or --zoo NAME|all", file=sys.stderr)
        return 2
    if targets is None:
        return 2

    # --feed/--fetch override the MAIN programs only: the auto-added
    # */startup companions have neither feeds nor the main's fetch vars
    if args.feed:
        feed_override = [s for s in args.feed.split(",") if s]
        targets = [(lbl, p,
                    fd if lbl.endswith("/startup") else feed_override, ft)
                   for lbl, p, fd, ft in targets]
    if args.fetch:
        fetch_override = [s for s in args.fetch.split(",") if s]
        targets = [(lbl, p, fd,
                    ft if lbl.endswith("/startup") else fetch_override)
                   for lbl, p, fd, ft in targets]

    if args.dot:
        mains = [(lbl, p) for lbl, p, _, _ in targets
                 if not lbl.endswith("/startup")]
        if len(mains) != 1:
            print(f"lint: --dot renders exactly one main program, got "
                  f"{len(mains)} (use one MODEL_DIR or --zoo NAME, not "
                  f"--zoo all)", file=sys.stderr)
            return 2
        from paddle_tpu_torch.analysis.visualize import program_dot
        program_dot(mains[0][1], path=args.dot)
        print(f"wrote {args.dot} ({mains[0][0]})")

    results = [(label, analysis.lint_program(
        program, feed_names=feeds, fetch_names=fetches))
        for label, program, feeds, fetches in targets]
    return _report_lint(results, args)


def _report_lint(results, args):
    """Print (or JSON-dump) a list of ``(label, AnalysisResult)`` and map
    findings to the exit code."""
    import json as _json

    n_err = sum(len(r.errors) for _, r in results)
    n_warn = sum(len(r.warnings) for _, r in results)
    uncovered = set()
    for _, r in results:
        uncovered.update(r.uncovered_op_types)
    if args.json:
        reports = [{
            "target": label,
            "diagnostics": [d.to_dict() for d in r.diagnostics],
            "uncovered_op_types": r.uncovered_op_types}
            for label, r in results]
        print(_json.dumps({"targets": reports, "errors": n_err,
                           "warnings": n_warn}, indent=2))
    else:
        for label, r in results:
            for d in r.diagnostics:
                print(f"[{label}] {d.format()}")
        print(f"lint: {len(results)} program(s): {n_err} error(s), "
              f"{n_warn} warning(s)")
        if uncovered and args.verbose:
            print(f"  warn-list ({len(uncovered)} op type(s) without an "
                  f"inference rule — shapes/dtypes not propagated "
                  f"through them): {', '.join(sorted(uncovered))}")
    return 1 if n_err or (args.strict and n_warn) else 0


def _cmd_opt(args):
    """Offline run of the ``analysis/opt`` pass pipeline: optimize a
    saved model (or zoo programs) and print the per-pass diff/stats
    report — what ``PADDLE_TPU_OPT=1`` does to this program inside the
    executor, inspectable without running anything.  Exit 0 on a clean
    run, 1 when any pass was sandwich-aborted, 2 on a bad target."""
    import json as _json

    from paddle_tpu_torch.analysis.opt import optimize_program

    if args.zoo:
        targets = _zoo_targets(args, "opt")
    elif args.target:
        targets = _saved_target(args.target, "opt")
    else:
        print("opt: need a MODEL_DIR or --zoo NAME|all", file=sys.stderr)
        return 2
    if targets is None:
        return 2
    passes = [s for s in args.passes.split(",") if s] \
        if args.passes else None

    aborted = 0
    reports = []
    for label, program, feeds, fetches in targets:
        try:
            optimized, report = optimize_program(
                program, feed_names=feeds, fetch_names=fetches,
                passes=passes)
        except ValueError as e:
            print(f"opt: {e}", file=sys.stderr)
            return 2
        aborted += len(report.aborted_passes)
        plan = getattr(optimized, "_donation_plan", None)
        interpret = bool(getattr(optimized, "_opt_interpret", False))
        if args.json:
            body = report.to_dict()
            body["target"] = label
            body["donation_plan"] = plan.to_dict() if plan else None
            body["interpret"] = interpret
            reports.append(body)
            continue
        print(f"== {label}")
        print(report.format())
        if report.flops_before is not None:
            print(f"  cost: {report.flops_before:,} -> "
                  f"{report.flops_after:,} static FLOPs")
        if interpret:
            print("  amortization gate: run-once initializer — "
                  "marked to interpret")
        if plan is not None:
            print("  " + plan.report().splitlines()[0])
    if args.json:
        print(_json.dumps({"targets": reports}, indent=2))
    return 1 if aborted else 0


def _cmd_selfcheck(args):
    """The JAX package's one-pass gate over every static check; most of
    its sections check planes the port does not have yet."""
    raise NotImplementedError(
        "selfcheck: 8 of its 17 sections check code the port does not "
        "have yet (the transpilers, sharded embeddings, the fleet "
        "controller, checkpoint manifests, compile_zoo_step, the ledger "
        "and bench history); it follows ROADMAP queue 1 item 10")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="paddle_tpu_torch",
                                     description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("serve", help="HTTP inference server")
    p.add_argument("--model", required=True,
                   help="save_inference_model dir or generation bundle")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8866)
    p.add_argument("--place", default="cuda:0",
                   help="cuda[:N] (default cuda:0) or cpu")
    p.add_argument("--async-load", action="store_true",
                   help="serve /healthz immediately; load the model in "
                        "the background (/readyz gates traffic)")
    p.add_argument("--max-inflight", type=int, default=32,
                   help="concurrent /predict slots before 503 "
                        "load-shedding")
    p.add_argument("--request-timeout", type=float, default=None,
                   help="per-request deadline waiting on the predictor "
                        "(504 when exceeded)")
    p.add_argument("--batch", action="store_true",
                   help="coalesce concurrent /predict requests into "
                        "padded row-bucketed micro-batches")
    p.add_argument("--max-batch-size", type=int, default=8,
                   help="max requests coalesced into one dispatch")
    p.add_argument("--max-batch-delay", type=float, default=0.005,
                   help="seconds the batcher lingers for co-batchable "
                        "requests after the first arrives")
    p.add_argument("--batch-queue-size", type=int, default=128,
                   help="bounded batch queue depth before 503 "
                        "load-shedding")
    p.add_argument("--warmup", action="store_true",
                   help="run the declared feed shapes / serving buckets "
                        "once (building every kernel) before /readyz "
                        "reports ready")
    p.add_argument("--warmup-batch-sizes", default=None,
                   help="comma-separated batch sizes to warm "
                        "(default: the batcher's bucket edges)")
    p.add_argument("--compile-cache", default=None,
                   help="not supported by the port (raises)")
    p.add_argument("--master", default=None,
                   help="fleet master HOST:PORT; not ported yet (raises)")
    p.add_argument("--gen-admission", default="continuous",
                   choices=("continuous", "batch"),
                   help="generation-bundle scheduler policy: admit into "
                        "free KV slots between decode steps "
                        "(continuous) or only between whole batches "
                        "(batch — the request-level baseline)")
    p.add_argument("--gen-queue-size", type=int, default=64,
                   help="bounded /generate admission queue depth before "
                        "503 load-shedding")
    p.set_defaults(fn=_cmd_serve)

    p = sub.add_parser("generate", help="stream tokens from a "
                                        "generation server's /generate")
    p.add_argument("--addr", required=True,
                   help="host:port of a serving replica")
    p.add_argument("--prompt", required=True,
                   help="prompt token ids (space/comma separated)")
    p.add_argument("--max-new", type=int, default=16,
                   help="max tokens to generate")
    p.add_argument("--eos-id", type=int, default=None,
                   help="per-request EOS token override")
    p.add_argument("--timeout", type=float, default=60.0)
    p.add_argument("--deadline", type=float, default=None,
                   help="end-to-end budget seconds (sent as "
                        "X-Deadline-Ms)")
    p.add_argument("--no-stream", action="store_true",
                   help="buffered reply instead of chunked streaming")
    p.add_argument("--session-id", default=None,
                   help="resumable-session id (default: minted per "
                        "request)")
    p.add_argument("--no-resume", action="store_true",
                   help="disable mid-stream resume: a dead replica "
                        "surfaces as a terminal error event instead")
    p.set_defaults(fn=_cmd_generate)

    p = sub.add_parser("stats", help="fetch a serving replica's /stats "
                                     "metrics snapshot")
    p.add_argument("--addr", default=None, help="host:port of the server")
    p.add_argument("--local", action="store_true",
                   help="this process's own metrics registry instead of "
                        "a remote server")
    p.add_argument("--json", action="store_true",
                   help="raw JSON instead of the formatted table")
    p.add_argument("--prom", action="store_true",
                   help="Prometheus text exposition format (the /metrics "
                        "body) instead of the snapshot table")
    p.set_defaults(fn=_cmd_stats)

    p = sub.add_parser("lint", help="static-analyze a program IR "
                                    "(PTA*** diagnostics)")
    p.add_argument("target", nargs="?", default=None,
                   help="save_inference_model dir (or a __model__ json "
                        "file) to lint; a dir with gen_meta.json lints "
                        "the whole generation bundle (prefill + decode "
                        "+ cross-program signature checks)")
    p.add_argument("--pair", nargs=2, metavar=("TRAINER", "PSERVER"),
                   default=None,
                   help="a transpiled trainer/pserver pair; not ported "
                        "yet (raises)")
    p.add_argument("--pipeline", type=int, default=None, metavar="N",
                   help="pipeline-split lint; not ported yet (raises)")
    p.add_argument("--zoo", default=None,
                   help="lint a built-in model's forward+backward "
                        "program instead (mnist|resnet|vgg|transformer|"
                        "seq2seq|stacked_lstm|gen_lm|gen_lm_long|"
                        "wide_and_deep|all)")
    p.add_argument("--no-backward", action="store_true",
                   help="with --zoo: lint the forward program only")
    p.add_argument("--feed", default=None,
                   help="comma-separated feed names (default: the "
                        "model's declared feeds)")
    p.add_argument("--fetch", default=None,
                   help="comma-separated fetch names (default: the "
                        "model's declared fetch targets)")
    p.add_argument("--strict", action="store_true",
                   help="exit 1 on warnings too, not just errors")
    p.add_argument("--dot", default=None, metavar="OUT",
                   help="also write the (single) main program as a "
                        "GraphViz .dot graph here")
    p.add_argument("--json", action="store_true",
                   help="machine-readable diagnostics")
    p.add_argument("--verbose", action="store_true",
                   help="also print the warn-list of op types without "
                        "an inference rule")
    p.set_defaults(fn=_cmd_lint)

    p = sub.add_parser("opt", help="run the Program-IR optimization "
                                   "pipeline offline and print the "
                                   "per-pass diff/stats report")
    p.add_argument("target", nargs="?", default=None,
                   help="save_inference_model dir (or a __model__ json "
                        "file) to optimize")
    p.add_argument("--zoo", default=None,
                   help="optimize a built-in model's forward+backward "
                        "program instead (mnist|...|all)")
    p.add_argument("--no-backward", action="store_true",
                   help="with --zoo: the forward program only")
    p.add_argument("--passes", default=None,
                   help="comma-separated pass subset (default: the "
                        "full pipeline)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable report")
    p.set_defaults(fn=_cmd_opt)

    p = sub.add_parser("selfcheck", help="every static gate in one pass; "
                                         "not ported yet (raises)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_selfcheck)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
