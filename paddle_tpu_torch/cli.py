"""Command-line entry points of the port (``paddle_tpu.cli``'s: training,
inference, serving and its fleet, observability, static analysis, fault
tolerance, profiling and the local launcher).

Usage: ``python -m paddle_tpu_torch <command> ...``

  version                            torch, CUDA and the card's name
  train    --config SCRIPT           run a training script (the
                                     ``paddle_trainer --config`` analog;
                                     --num-passes N, --checkpoint-dir D
                                     --keep-checkpoints K export what
                                     ``fault.manager_from_env`` reads)
  infer    --model DIR --feed name=path.npy
                                     load + run an inference model
                                     (--output DIR; --place cpu runs on
                                     the CPU, the default is cuda:0)
  master   --files GLOB --port P     serve the task-dispatch master
                                     (task leases and the fleet's
                                     replica leases)
  serve    --model DIR --port P      HTTP inference server (--batch
                                     --warmup; --place cpu runs on the
                                     CPU, the default is cuda:0;
                                     --master HOST:PORT enrolls the
                                     replica in a fleet)
  router   --master HOST:PORT --port P
                                     health-aware fleet router (or
                                     --replicas a,b,c)
  controller --master H:P --model DIR
                                     router + closed-loop autoscaler:
                                     warm-standby scale-up, idle drain,
                                     admission backpressure (--policy
                                     POLICY.json or PADDLE_TPU_AUTOSCALE;
                                     --place as serve)
  fleet-stats --router H:P | --master H:P | --replicas a,b
                                     federated fleet metrics: one
                                     exposition, per-replica labels,
                                     rollups, stale-marked corpses
  generate --addr HOST:PORT --prompt "1 2 3"
                                     stream tokens from /generate
  stats    --addr HOST:PORT          runtime metrics snapshot of a
                                     serving replica (/stats); --local
                                     for this process; --prom for
                                     Prometheus text
  trace    dump [--addr H:P|--local] Chrome trace-event JSON of the span
                                     ring (PADDLE_TPU_TRACE); --output;
                                     --fleet assembles the whole fleet's
                                     rings through its router
  bench    check [--dry] | record    bench-trajectory gate over the
                                     port's BENCH_TRAJECTORY_TORCH.json:
                                     newest run vs recorded baseline;
                                     exit 1 on regression
  runs     tail|show|compare DIR     run-ledger readers (obs.ledger)
  lint     MODEL_DIR | --zoo NAME    static analysis of a program IR
                                     (PTA*** diagnostics; --json,
                                     --strict, --dot OUT, --verbose)
  opt      MODEL_DIR | --zoo NAME    the optimization pass pipeline,
                                     offline: per-pass stats (--json,
                                     --passes a,b)
  launch   --nproc N SCRIPT [args]   spawn an N-process world on this
                                     host (PADDLE_COORDINATOR,
                                     PADDLE_TRAINER_ID, PADDLE_TRAINERS);
                                     one rank failing stops the others
  replay   BUNDLE                    re-execute a sentinel-quarantined
                                     step on the CPU (--localize names
                                     the first non-finite op; --json)
  ckpt     inspect|verify DIR        survey / re-hash a checkpoint
                                     directory (--step N, --json)
  profile  op|compile|memory|step    device profiling: per-op device
                                     time, per-signature cost records,
                                     the HBM census, the step phases

``--compile-cache`` (the JAX package's persistent XLA cache) raises: the
port's kernels always build into the build directory beside their
sources, and a warm standby is one whose warmup built or loaded them.
``selfcheck`` raises: it is the rest of ROADMAP queue 1 item 10 and comes
next.  ``train --use-tpu``
is not carried over: the JAX package's flag only exports
``PADDLE_TPU_USE_TPU``, which no code reads.
"""

from __future__ import annotations

import argparse
import os
import runpy
import sys

__all__ = ["main"]


def _place(name):
    from paddle_tpu_torch.place import CPUPlace, CUDAPlace
    if name == "cpu":
        return CPUPlace()
    if name.startswith("cuda"):
        return CUDAPlace(int(name.partition(":")[2] or 0))
    raise ValueError(f"--place must be cpu or cuda[:N], got {name!r}")


def _cmd_version(args):
    """torch's version, the CUDA version torch was built for, and the
    card's name (``unavailable (...)`` off a card)."""
    import torch
    import paddle_tpu_torch
    try:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available")
        device = torch.cuda.get_device_name(0)
    except Exception as e:
        device = f"unavailable ({e})"
    print(f"paddle_tpu_torch {paddle_tpu_torch.__version__} (torch "
          f"{torch.__version__}, cuda {torch.version.cuda or 'none'}, "
          f"device {device})")
    return 0


def _cmd_train(args):
    """Run a training script, the ``paddle_trainer --config`` analog.
    The script sees ``PADDLE_NUM_PASSES`` and, with ``--checkpoint-dir``,
    ``PADDLE_TPU_CKPT_DIR`` / ``PADDLE_TPU_CKPT_KEEP`` (read by
    ``fault.manager_from_env``), like the reference's gflags.  The JAX
    package's ``--use-tpu`` is not carried over: it only exports
    ``PADDLE_TPU_USE_TPU``, which no code in the repo reads."""
    if args.num_passes is not None:
        os.environ["PADDLE_NUM_PASSES"] = str(args.num_passes)
    if args.checkpoint_dir is not None:
        os.environ["PADDLE_TPU_CKPT_DIR"] = args.checkpoint_dir
        os.environ["PADDLE_TPU_CKPT_KEEP"] = str(args.keep_checkpoints)
    sys.argv = [args.config] + (args.script_args or [])
    runpy.run_path(args.config, run_name="__main__")
    return 0


def _cmd_infer(args):
    """Load a saved inference model and run it on ``.npy`` feeds (the
    C++ ``inference::Load`` + run flow, ``inference/io.h:35``) on
    ``--place`` (default ``cuda:0``; raises without CUDA)."""
    import numpy as np
    import paddle_tpu_torch as pt

    exe = pt.Executor(_place(args.place))
    program, feed_names, fetch_targets = \
        pt.io.load_inference_model(args.model, exe)
    feed = {}
    for spec in args.feed or []:
        name, path = spec.split("=", 1)
        feed[name] = np.load(path)
    missing = [n for n in feed_names if n not in feed]
    if missing:
        print(f"missing feeds: {missing}; expected {feed_names}",
              file=sys.stderr)
        return 2
    outs = exe.run(program, feed=feed, fetch_list=fetch_targets)
    for target, value in zip(fetch_targets, outs):
        name = target.name if hasattr(target, "name") else str(target)
        arr = np.asarray(value)
        print(f"{name}: shape={arr.shape}")
        if args.output:
            np.save(os.path.join(args.output, f"{name}.npy"), arr)
    return 0


def _cmd_trace(args):
    """Dump a span ring as Chrome trace-event JSON: this process's with
    --local (enable PADDLE_TPU_TRACE first), a serving replica's via its
    /trace endpoint with --addr.  The output loads in Perfetto
    (ui.perfetto.dev) or chrome://tracing.  ``--fleet`` (against a
    router) dumps the ASSEMBLED fleet timeline: every process's spans
    merged onto one clock with a distinct pid row per process."""
    import json as _json

    if args.fleet:
        import urllib.request
        if not args.addr:
            print("trace dump --fleet: need --addr ROUTER_HOST:PORT",
                  file=sys.stderr)
            return 2
        url = f"http://{args.addr}/trace?fleet=1"
        with urllib.request.urlopen(url, timeout=60) as r:
            obj = _json.loads(r.read())
    elif args.addr:
        from paddle_tpu_torch.serving import ServingClient
        obj = ServingClient(args.addr).trace()
    else:
        from paddle_tpu_torch.obs import trace as _trace
        obj = _trace.chrome_trace()
    body = _json.dumps(obj)
    if args.output:
        with open(args.output, "w") as f:
            f.write(body)
        print(f"wrote {len(obj['traceEvents'])} span(s) to {args.output}")
    else:
        print(body)
    return 0


def _cmd_bench(args):
    """Bench trajectory gate: ``bench check`` compares each bench's
    newest run of the port's trajectory (``BENCH_TRAJECTORY_TORCH.json``
    unless ``--trajectory``) against its recorded baseline under
    per-metric tolerance bands (exit 1 on regression, a schema problem
    or a missing file); ``bench record`` imports a bench summary JSON as
    a new trajectory run."""
    import json as _json

    from paddle_tpu_torch.obs import bench_history

    if args.action == "record":
        if not args.bench or not args.summary:
            print("bench record: need --bench NAME --summary FILE",
                  file=sys.stderr)
            return 2
        try:
            with open(args.summary) as f:
                summary = _json.load(f)
            metrics = bench_history.summary_metrics(args.bench, summary)
            entry = bench_history.record(
                args.bench, metrics, path=args.trajectory,
                baseline=args.baseline, source=args.summary)
        except (OSError, ValueError, KeyError) as e:
            print(f"bench record: {e}", file=sys.stderr)
            return 2
        print(_json.dumps(entry, indent=2, sort_keys=True))
        return 0
    report = bench_history.check(path=args.trajectory, dry=args.dry)
    if args.json:
        print(_json.dumps(report, indent=2, sort_keys=True))
    else:
        for line in report["problems"]:
            print(f"schema: {line}")
        for bench, b in sorted(report.get("benches", {}).items()):
            for row in b["comparisons"]:
                mark = "ok  " if row["ok"] else "FAIL"
                print(f"[{mark}] {bench}.{row['metric']}: "
                      f"newest={row['newest']:g} vs "
                      f"baseline={row['baseline']:g} "
                      f"({row['direction']}, band={row['band']:g}, "
                      f"bound={row['bound']:g})")
        verdict = "PASS" if report["ok"] else "FAIL"
        what = "schema" if args.dry else "regression gate"
        print(f"bench check ({what}): {verdict} [{report['path']}]")
    return 0 if report["ok"] else 1


def _fmt_cell(value):
    if value is None:
        return "-"
    if isinstance(value, float):
        return f"{value:.6g}"
    return str(value)


def _cmd_runs(args):
    """Read side of the run ledger (``obs.ledger``): ``tail`` prints the
    last N step rows of a ledger directory, ``show`` a whole-run digest
    (row/segment counts, per-field first/last/min/max), ``compare`` two
    runs side by side with last-value deltas.  Pure file readers (no
    executor, no device), usable while the training process is still
    appending; a directory either package wrote.  Exit 2 on an
    unreadable ledger."""
    import json as _json

    from paddle_tpu_torch.obs import ledger as _ledger

    try:
        if args.action == "tail":
            rows = _ledger.tail_rows(args.dir, n=args.n)
            if args.json:
                print(_json.dumps(rows, indent=2, sort_keys=True))
                return 0
            fields = [f for f in _ledger.ROW_FIELDS
                      if any(r.get(f) is not None for r in rows)]
            header = ["step", "time_unix"] + fields
            print("  ".join(header))
            for r in rows:
                print("  ".join(_fmt_cell(r.get(k)) for k in header))
            return 0
        if args.action == "show":
            body = _ledger.summarize(args.dir)
            if args.json:
                print(_json.dumps(body, indent=2, sort_keys=True))
                return 0
            print(f"{body['dir']}: {body['rows']} row(s) in "
                  f"{body['segments']} segment(s), steps "
                  f"{body['first_step']}..{body['last_step']}")
            for field, st in sorted(body["fields"].items()):
                print(f"  {field}: first={_fmt_cell(st['first'])} "
                      f"last={_fmt_cell(st['last'])} "
                      f"min={_fmt_cell(st['min'])} "
                      f"max={_fmt_cell(st['max'])} "
                      f"({st['samples']} sample(s))")
            return 0
        if not args.dir_b:
            print("runs compare: need two ledger directories",
                  file=sys.stderr)
            return 2
        body = _ledger.compare(args.dir, args.dir_b)
        if args.json:
            print(_json.dumps(body, indent=2, sort_keys=True))
            return 0
        print(f"A: {body['a']['dir']} ({body['a']['rows']} row(s), "
              f"last step {body['a']['last_step']})")
        print(f"B: {body['b']['dir']} ({body['b']['rows']} row(s), "
              f"last step {body['b']['last_step']})")
        for field, d in sorted(body["deltas"].items()):
            print(f"  {field}: A last={_fmt_cell(d['a_last'])}  "
                  f"B last={_fmt_cell(d['b_last'])}  "
                  f"delta={_fmt_cell(d['delta_last'])}")
        return 0
    except ValueError as e:
        print(f"runs: {e}", file=sys.stderr)
        return 2


def _cmd_master(args):
    """Serve the fault-tolerant task master (go master binary analog)."""
    import glob

    from paddle_tpu_torch.parallel.master import (MasterServer,
                                                  MasterService,
                                                  partition_files)
    files = sorted(glob.glob(args.files))
    if not files:
        print(f"no files match {args.files!r}", file=sys.stderr)
        return 2
    tasks = partition_files(files, args.chunks_per_task)
    service = MasterService(tasks, timeout=args.timeout,
                            failure_max=args.failure_max,
                            snapshot_path=args.snapshot,
                            heartbeat_timeout=args.heartbeat_timeout)
    server = MasterServer(service, host=args.host, port=args.port)
    print(f"master serving {len(tasks)} tasks on "
          f"{server.addr[0]}:{server.addr[1]}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


def _cmd_serve(args):
    """HTTP inference server over a saved model or a generation bundle.
    With --master the replica enrolls in the serving fleet: register on
    readiness, heartbeat-renew the lease, drain cleanly on SIGTERM."""
    if args.compile_cache:
        raise NotImplementedError(
            "serve --compile-cache: the port has no XLA compilation "
            "cache; its CUDA kernels build once into "
            "paddle_tpu_torch/kernels/_build/ and are reused from there")
    from paddle_tpu_torch.serving import serve
    warmup_sizes = None
    if args.warmup_batch_sizes:
        warmup_sizes = [int(s) for s in args.warmup_batch_sizes.split(",")]
    server_kwargs = dict(
        async_load=args.async_load,
        max_inflight=args.max_inflight,
        request_timeout=args.request_timeout, batching=args.batch,
        max_batch_size=args.max_batch_size,
        max_batch_delay=args.max_batch_delay,
        batch_queue_size=args.batch_queue_size, warmup=args.warmup,
        warmup_batch_sizes=warmup_sizes,
        gen_admission=args.gen_admission,
        gen_queue_size=args.gen_queue_size, place=_place(args.place))
    if args.master:
        from paddle_tpu_torch.fault import GracefulShutdown
        from paddle_tpu_torch.fleet import FleetReplica
        replica = FleetReplica(args.model, args.master,
                               replica_id=args.replica_id,
                               host=args.host, port=args.port,
                               lease_ttl=args.lease_ttl,
                               advertise_host=args.advertise_host,
                               **server_kwargs)
        replica.start()
        print(f"fleet replica {replica.replica_id} serving {args.model} "
              f"on {replica.addr[0]}:{replica.addr[1]} "
              f"(master {args.master}; "
              f"{replica.server.place.torch_device()})",
              flush=True)
        # rolling restart contract: SIGTERM -> deregister (router stops
        # routing), finish in-flight, release the lease, exit 0
        with GracefulShutdown() as stop:
            stop.wait()
        migrated = replica.drain(deadline_s=args.drain_deadline_s)
        if migrated:
            print(f"drained: {len(migrated)} active session(s) "
                  f"checkpoint-migrated to survivors", flush=True)
        return 0
    serve(args.model, host=args.host, port=args.port, **server_kwargs)
    return 0


def _cmd_router(args):
    """Serve the health-aware fleet router (master-discovered or static
    replica list)."""
    from paddle_tpu_torch.fleet import FleetRouter
    replicas = [a for a in (args.replicas or "").split(",") if a]
    router = FleetRouter(master_addr=args.master or None,
                         replicas=replicas or None,
                         host=args.host, port=args.port,
                         default_deadline=args.default_deadline,
                         poll_interval=args.poll_interval,
                         slo_spec=args.slo or None)
    n = len(router.live_replicas())
    print(f"fleet router on {router.addr[0]}:{router.addr[1]} "
          f"({'master ' + args.master if args.master else 'static'}; "
          f"{n} replica(s) live)", flush=True)
    try:
        router.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


def _cmd_controller(args):
    """Serve the fleet router WITH the closed control loop in-process:
    a FleetController senses SLO pressure / scraper rollups and scales
    a warm standby pool of replicas built from --model on --place."""
    import itertools

    from paddle_tpu_torch.fault import GracefulShutdown
    from paddle_tpu_torch.fleet import FleetController, FleetReplica, \
        FleetRouter
    if args.compile_cache:
        raise NotImplementedError(
            "controller --compile-cache: the port has no XLA compilation "
            "cache; a standby's warmup builds or loads its CUDA kernels "
            "from paddle_tpu_torch/kernels/_build/")
    place = _place(args.place)
    router = FleetRouter(master_addr=args.master,
                         host=args.host, port=args.port,
                         default_deadline=args.default_deadline,
                         poll_interval=args.poll_interval,
                         slo_spec=args.slo or None)
    router.start_background()
    seq = itertools.count()

    def factory():
        return FleetReplica(args.model, args.master,
                            replica_id=f"auto-{os.getpid()}-{next(seq)}",
                            lease_ttl=args.lease_ttl, warmup=True,
                            place=place)

    controller = FleetController(router, policy=args.policy or None,
                                 standby_factory=factory)
    warmed = controller.prewarm(raise_on_failure=False)
    controller.start()
    print(f"fleet controller on {router.addr[0]}:{router.addr[1]} "
          f"(master {args.master}; policy "
          f"{controller.policy.source or 'defaults'}; "
          f"{warmed} standby(s) warm)", flush=True)
    try:
        with GracefulShutdown() as stop:
            stop.wait()
    except KeyboardInterrupt:
        pass
    controller.shutdown(drain_owned=True)
    router.shutdown()
    return 0


def _cmd_fleet_stats(args):
    """Fleet-level federated metrics: scrape every replica's /stats and
    render ONE Prometheus exposition with per-replica labels + rollups
    (dead replicas marked stale, never fatal).  Three target modes:
    --router proxies the router's own /metrics?fleet=1 (the router's
    scraper keeps rate state between pulls); --master discovers the
    lease table and scrapes in-process; --replicas scrapes a static
    list."""
    import json as _json
    import urllib.request

    from paddle_tpu_torch.obs import aggregate

    if args.router:
        url = f"http://{args.router}/metrics?fleet=1"
        with urllib.request.urlopen(url, timeout=args.timeout) as r:
            print(r.read().decode(), end="")
        return 0
    if args.master:
        from paddle_tpu_torch.parallel.master import MasterClient
        client = MasterClient(args.master)
        try:
            targets = [(r["addr"], r["id"])
                       for r in client.list_replicas()]
        finally:
            client.close()
    elif args.replicas:
        targets = [(a, a) for a in args.replicas.split(",") if a]
    else:
        print("fleet-stats: need --router, --master, or --replicas",
              file=sys.stderr)
        return 2
    scraper = aggregate.FleetScraper(lambda: targets,
                                     timeout=args.timeout)
    text, scrapes = scraper.federate()
    if args.json:
        print(_json.dumps(
            {"replicas": [{k: s[k] for k in
                           ("addr", "id", "ok", "error", "rtt_s")}
                          for s in scrapes]},
            indent=2, sort_keys=True))
    else:
        print(text, end="")
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
        from paddle_tpu_torch.analysis.distributed import load_saved_program
        members = []
        for role, target in zip(("trainer", "pserver"), args.pair):
            try:
                program, feeds, fetches = load_saved_program(target)
            except (OSError, ValueError, KeyError) as e:
                print(f"lint: cannot load a program from {target!r}: "
                      f"{e}", file=sys.stderr)
                return 2
            members.append((role, program, feeds, fetches))
        results = [(label, analysis.lint_program(
            program, feed_names=feeds, fetch_names=fetches))
            for label, program, feeds, fetches in members]
        results.append(("pair", analysis.lint_pair(
            (members[0][0], members[0][1]),
            [(members[1][0], members[1][1])])))
        if args.dot:
            print("lint: --dot renders exactly one main program "
                  "(not a --pair / gen-bundle family)", file=sys.stderr)
            return 2
        return _report_lint(results, args)
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

    results = []
    for label, program, feeds, fetches in targets:
        results.append((label, analysis.lint_program(
            program, feed_names=feeds, fetch_names=fetches)))
        # like --feed/--fetch, --pipeline applies to MAIN programs
        # only: splitting a */startup initializer into "stages"
        # verifies nothing
        if args.pipeline and not label.endswith("/startup"):
            try:
                results.append((f"{label}/pipeline{args.pipeline}",
                                analysis.lint_pipeline(
                                    program, args.pipeline, feeds,
                                    fetches)))
            except ValueError as e:
                # the split itself rejected the program (e.g. a
                # tensor_array would cross a cut) — a target problem,
                # not a diagnostic
                print(f"lint: {label}: {e}", file=sys.stderr)
                return 2
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
    """The JAX package's one-pass gate over every static check; not in
    the port yet."""
    raise NotImplementedError(
        "selfcheck: the one-pass gate over every static check is the "
        "rest of ROADMAP queue 1 item 10, the next slice of the port")


def _cmd_replay(args):
    """Re-execute a quarantined training step from its repro bundle
    (``fault.Sentinel`` quarantine output), on the CPU whatever device
    the fault was seen on: the offline debugging loop for a numerical
    fault, as the JAX package's ``replay`` pins its CPU platform
    (``replay_bundle`` runs on ``CPUPlace``).  ``--localize``
    re-executes op by op with per-op tensor-stat probes and names the
    FIRST op whose output went non-finite, with its creation site and
    the stat trail of the ops before it.  Exit code 0 when the fault
    reproduces (or localizes), 1 when the step replays clean, 2 on a
    malformed or unreplayable bundle, and 2 for a clean replay of a step
    whose random draws the CPU cannot repeat (a card's, or the JAX
    package's: ``rng_device_mismatch``), which proves nothing clean."""
    try:
        if args.localize:
            from paddle_tpu_torch.obs.numerics import localize_bundle
            report = localize_bundle(args.bundle)
        else:
            from paddle_tpu_torch.fault.sentinel import replay_bundle
            report = replay_bundle(args.bundle)
    except (OSError, ValueError, KeyError) as e:
        print(f"replay: cannot load bundle {args.bundle!r}: {e}",
              file=sys.stderr)
        return 2
    if args.localize:
        code = _report_localize(report, json_out=args.json)
    else:
        code = _report_replay(report, json_out=args.json)
    if code == 1 and report["rng_device_mismatch"]:
        print(f"replay: no clean verdict: the recorded step drew random "
              f"numbers on {report['rng_device'] or 'the JAX package'}'s "
              f"generators, which this CPU replay does not repeat",
              file=sys.stderr)
        return 2
    return code


def _report_replay(report, json_out=False):
    """Print a ``replay_bundle`` report; exit 0 = reproduced, 1 = the
    step replayed clean."""
    import json as _json

    if json_out:
        print(_json.dumps(report, indent=2, sort_keys=True))
    elif report["reproduced"]:
        bad = ", ".join(report["bad"][:6]) or "(loss spike)"
        print(f"step {report['step']}: fault REPRODUCED "
              f"({report['reason']}) in: {bad}"
              + (" [chaos-injected]" if report["injected"] else ""))
    else:
        print(f"step {report['step']}: replayed CLEAN — the fault did "
              f"not reproduce on CPU (suspect hardware/nondeterminism)")
    return 0 if report["reproduced"] else 1


def _report_localize(report, json_out=False):
    """Print a ``numerics.localize_bundle`` report; exit 0 = localized,
    1 = every op produced finite outputs."""
    import json as _json

    if json_out:
        print(_json.dumps(report, indent=2, sort_keys=True))
        return 0 if report["localized"] else 1
    if not report["localized"]:
        print(f"step {report['step']}: all {report['ops_probed']} op "
              f"execution(s) produced finite outputs — nothing to "
              f"localize (suspect hardware/nondeterminism)")
        return 1
    bad = report["first_bad_op"]
    site = bad.get("creation_site")
    where = f"{site[0]}:{site[1]}" if site else "(unknown site)"
    tag = " [chaos-injected]" if report["injected"] else ""
    print(f"step {report['step']}: first non-finite output at op "
          f"#{bad['index']} `{bad['type']}` created at {where}{tag}")
    for name, stats in (bad.get("outputs") or {}).items():
        print(f"  out {name}: {stats}")
    for name, stats in (bad.get("inputs") or {}).items():
        print(f"  in  {name}: {stats}")
    trail = bad.get("trail") or []
    if trail:
        print(f"  trail (last {len(trail)} op(s) before the fault):")
        for row in trail:
            outs = ", ".join(row.get("outputs", {}))
            print(f"    #{row['index']} {row['type']} -> {outs}")
    return 0


def _ckpt_report(dirname, step=None, deep=False):
    """The ``ckpt`` survey of a checkpoint directory, pure directory and
    manifest reads (no executor, no program, no device): committed steps
    with per-step manifest status (and per-shard file presence for
    shard-format checkpoints), the saved topology, the latest and
    last-good pointers, and quarantined directories.  ``deep`` re-hashes
    every file (``verify``); shallow reads manifests only."""
    from paddle_tpu_torch.fault import checkpoint as ckpt_mod
    from paddle_tpu_torch.fault import shard_ckpt
    from paddle_tpu_torch.fault.checkpoint import (CorruptCheckpoint,
                                                   GOOD_POINTER_NAME)

    report = {"dir": os.path.abspath(dirname), "steps": [],
              "latest": None, "last_good": None, "quarantined": [],
              "ok": True}
    for pointer, key in (("latest", "latest"),
                         (GOOD_POINTER_NAME, "last_good")):
        try:
            with open(os.path.join(dirname, pointer)) as f:
                report[key] = int(f.read().strip())
        except (OSError, ValueError):
            pass
    steps = []
    for name in sorted(os.listdir(dirname)):
        if name.endswith(".corrupt"):
            report["quarantined"].append(name)
            continue
        if not name.startswith("ckpt-") or \
                not name[len("ckpt-"):].isdigit():
            continue
        steps.append(int(name[len("ckpt-"):]))
    for s in sorted(steps):
        if step is not None and s != int(step):
            continue
        path = os.path.join(dirname, f"ckpt-{s}")
        row = {"step": s, "format": "legacy", "status": "unverifiable",
               "topology": None, "shards": None}
        manifest = shard_ckpt.read_manifest(path)
        if manifest is not None:
            row["format"] = "manifest"
            topo = manifest.get("topology")
            if topo is not None:
                row["format"] = "sharded"
                shards = topo.get("shards") or {}
                counts = [r.get("num_shards", 1) for r in shards.values()]
                row["topology"] = {
                    "mesh_shape": topo.get("mesh_shape"),
                    "axis_names": topo.get("axis_names"),
                    "processes": topo.get("processes"),
                }
                row["shards"] = {
                    "vars": len(shards),
                    "sharded_vars": sum(1 for c in counts if c > 1),
                    "shard_files": sum(counts),
                }
            try:
                if deep:
                    ckpt_mod.verify_checkpoint(path)
                else:
                    # shallow: file presence + size + topology
                    # self-consistency, no re-hash
                    for rel, want in manifest.get("files", {}).items():
                        p = os.path.join(path, rel)
                        if not os.path.exists(p):
                            raise CorruptCheckpoint(
                                f"{path}: missing file {rel!r}")
                        if os.path.getsize(p) != want["size"]:
                            raise CorruptCheckpoint(
                                f"{path}: {rel!r} size mismatch")
                    if topo is not None:
                        problems = shard_ckpt.validate_topology(manifest)
                        if problems:
                            raise CorruptCheckpoint("; ".join(problems))
                row["status"] = "verified" if deep else "present"
            except CorruptCheckpoint as e:
                row["status"] = "CORRUPT"
                row["error"] = str(e)
                report["ok"] = False
        report["steps"].append(row)
    if step is not None and not report["steps"]:
        report["ok"] = False
        report["error"] = f"no committed ckpt-{int(step)} in {dirname}"
    return report


def _cmd_ckpt(args):
    """Operator-facing checkpoint survey: ``inspect`` prints steps,
    per-shard manifest status, the saved topology, and the latest and
    last-good pointers; ``verify`` re-hashes every file of every
    committed step (or ``--step N``) and exit-codes on corruption (1), so
    restorability is checkable from a cron job without loading a program
    or touching a device.  A missing directory exits 2."""
    import json as _json

    if not os.path.isdir(args.dir):
        print(f"ckpt {args.action}: no such directory {args.dir!r}",
              file=sys.stderr)
        return 2
    deep = args.action == "verify"
    report = _ckpt_report(args.dir, step=args.step, deep=deep)
    if args.json:
        print(_json.dumps(report, indent=2, sort_keys=True))
    else:
        print(f"checkpoint dir: {report['dir']}")
        print(f"latest: {report['latest']}   "
              f"last_good: {report['last_good']}")
        for row in report["steps"]:
            line = (f"  ckpt-{row['step']}: {row['status']} "
                    f"[{row['format']}]")
            topo = row.get("topology")
            if topo:
                line += (f" mesh={topo['mesh_shape']}"
                         f"{topo['axis_names']}")
            sh = row.get("shards")
            if sh:
                line += (f" vars={sh['vars']} "
                         f"sharded={sh['sharded_vars']} "
                         f"shard_files={sh['shard_files']}")
            print(line)
            if row.get("error"):
                print(f"    {row['error']}")
        for q in report["quarantined"]:
            print(f"  {q}: quarantined")
        if report.get("error"):
            print(f"ckpt {args.action}: {report['error']}",
                  file=sys.stderr)
        verdict = "PASS" if report["ok"] else "FAIL"
        print(f"ckpt {args.action}: {verdict}")
    return 0 if report["ok"] else 1


def _profile_build(args):
    """Shared model-building head of the ``profile op|step`` modes:
    ``(exe, main_prog, startup, feed, cost_name)`` on ``--place``."""
    import numpy as np

    import paddle_tpu_torch as fluid

    if args.model == "transformer":
        from paddle_tpu_torch.models import transformer as T
        hp = T.ModelHyperParams()
        hp.d_model, hp.d_inner_hid, hp.n_layer = args.d_model, \
            2 * args.d_model, args.layers
        hp.n_head = max(1, args.d_model // 64)
        hp.d_key = hp.d_value = args.d_model // hp.n_head
        hp.src_vocab_size = hp.trg_vocab_size = 1000
        hp.max_length = max(64, args.seq)
        main_prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main_prog, startup):
            cost, _ = T.transformer(args.batch, args.seq, args.seq, hp)
            fluid.optimizer.Adam(learning_rate=1e-4).minimize(cost)
        feed = T.fake_batch(args.batch, args.seq, args.seq, hp)
    elif args.model == "resnet":
        from paddle_tpu_torch.models import resnet as R
        main_prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main_prog, startup):
            cost, _, _ = R.resnet_train_program(
                args.batch, class_dim=1000, depth=50,
                image_shape=(3, args.seq, args.seq))
            fluid.optimizer.Momentum(learning_rate=0.01,
                                     momentum=0.9).minimize(cost)
        rng = np.random.RandomState(0)
        feed = {"image": rng.rand(args.batch, 3, args.seq,
                                  args.seq).astype("float32"),
                "label": rng.randint(0, 1000, (args.batch, 1))
                .astype("int64")}
    else:
        raise SystemExit(f"unknown --model {args.model!r}")
    exe = fluid.Executor(_place(args.place))
    exe.run(startup)
    return exe, main_prog, startup, feed, cost.name


def _fmt_bytes(n):
    return "-" if n is None else f"{n / 1e6:.2f}MB"


def _fmt_ms(s):
    return "-" if s is None else f"{s * 1e3:.1f}ms"


def _profile_zoo_compile(args):
    """Prepare a zoo model's train step (startup + one synthetic step on
    ``--place``) so that its signatures land cost records; returns the
    scope (for ``profile memory``'s census)."""
    from paddle_tpu_torch.models import ZOO_MODELS, compile_zoo_step

    name = args.zoo or "mnist"
    if name not in ZOO_MODELS:
        raise SystemExit(f"unknown --zoo {name!r}; expected one of "
                         f"{ZOO_MODELS}")
    return compile_zoo_step(name, place=_place(args.place))


def _cmd_profile_compile(args):
    """``profile compile``: prepare a zoo model's step and print the
    per-signature table: the cost model's FLOPs and bytes, the memory
    breakdown of the first run, and the prepare / first-run / capture
    seconds it paid."""
    import json as _json

    from paddle_tpu_torch.obs import perf

    _profile_zoo_compile(args)
    report = perf.compile_report()
    if args.json:
        print(_json.dumps(report, indent=2, sort_keys=True))
        return 0
    print(f"backend={report['backend']} "
          f"peak={report['peak_flops_per_chip']:.3g} FLOP/s "
          f"({report['mfu_basis']})")
    print(f"{'key':<10}{'GFLOPs':>10}{'bytes':>12}{'arg':>10}"
          f"{'out':>10}{'temp':>10}{'prepare':>9}{'first':>9}"
          f"{'capture':>9}  label")
    for r in report["records"]:
        mem = r["memory"] or {}
        ph = r["phases"]
        flops = "-" if r["flops"] is None else f"{r['flops'] / 1e9:.3f}"
        print(f"{r['key']:<10}{flops:>10}"
              f"{_fmt_bytes(r['bytes_accessed']):>12}"
              f"{_fmt_bytes(mem.get('argument_bytes')):>10}"
              f"{_fmt_bytes(mem.get('output_bytes')):>10}"
              f"{_fmt_bytes(mem.get('temp_bytes')):>10}"
              f"{_fmt_ms(ph['trace_seconds']):>9}"
              f"{_fmt_ms(ph['lower_seconds']):>9}"
              f"{_fmt_ms(ph['backend_seconds']):>9}  {r['label']}")
    return 0


def _cmd_profile_memory(args):
    """``profile memory``: the HBM census: device bytes attributed to
    params / optimizer state / KV pool / prefetch / other, the high
    watermark and (on the card, or when PADDLE_TPU_HBM_LIMIT_BYTES
    declares one) the limit and headroom."""
    import json as _json

    from paddle_tpu_torch.obs import perf

    scope = _profile_zoo_compile(args)
    census = perf.hbm_census(scope, device=_place(args.place)
                             .torch_device())
    if args.json:
        print(_json.dumps(census, indent=2, sort_keys=True))
        return 0
    for key in ("params", "optimizer", "kv_cache", "kv_pages", "prefetch",
                "other", "total", "high_watermark", "limit", "headroom"):
        if census.get(key) is not None:
            print(f"hbm.{key:<16}{census[key]:>14} bytes")
    return 0


def _cmd_profile_step(args):
    """``profile step``: N measured steps with the per-step breakdown
    armed (feed / dispatch / device-wait / fetch series), with a
    ``torch.profiler`` trace of the same window under ``--trace-dir``,
    and the live MFU the window sustained."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.obs import perf

    exe, main_prog, _startup, feed, cost_name = _profile_build(args)
    exe.run(main_prog, feed=feed, fetch_list=[cost_name])  # first run
    perf.enable_step_phases()
    try:
        if args.trace_dir:
            profiler.start_profiler(profile_path=args.trace_dir)
        for _ in range(args.steps):
            exe.run(main_prog, feed=feed, fetch_list=[cost_name])
    finally:
        if args.trace_dir:
            profiler.stop_profiler(profile_path=args.trace_dir)
        perf.disable_step_phases()
    m = profiler.runtime_metrics
    print(f"{'phase':<14}{'p50':>10}{'p95':>10}")
    for phase in ("feed", "dispatch", "device_wait", "fetch"):
        p = m.percentiles(f"perf.step.{phase}_seconds", qs=(50, 95))
        print(f"{phase:<14}{_fmt_ms(p['p50']):>10}"
              f"{_fmt_ms(p['p95']):>10}")
    mfu = m.gauge("train.mfu")
    basis = perf.peak_flops_info(exe.device)[1]
    if mfu is not None:
        print(f"train.mfu={mfu:.4f} ({basis})")
    if args.trace_dir:
        print(f"device trace written under {args.trace_dir} (Chrome "
              f"trace JSON: Perfetto or chrome://tracing)")
    return 0


def _cmd_profile(args):
    """The ``profile`` family: ``op`` (default) prints the per-IR-op
    device-time table of a training step (the eager step with op ranges,
    ``profiler.compiled_profiler``); ``compile`` the per-signature
    cost/memory/phase table; ``memory`` the HBM census; ``step`` the
    N-step feed/dispatch/device-wait/fetch breakdown."""
    if args.action == "compile":
        return _cmd_profile_compile(args)
    if args.action == "memory":
        return _cmd_profile_memory(args)
    if args.action == "step":
        return _cmd_profile_step(args)
    from paddle_tpu_torch import profiler
    exe, main_prog, _startup, feed, cost_name = _profile_build(args)
    exe.run(main_prog, feed=feed, fetch_list=[cost_name])  # first run
    with profiler.compiled_profiler(sorted_key=args.sorted_by):
        for _ in range(args.steps):
            exe.run(main_prog, feed=feed, fetch_list=[cost_name])
    return 0


def _cmd_launch(args, poll_s=0.1):
    """Spawn an N-process world on this host (the cluster_train
    launcher analog): each process gets the reference's env convention,
    ``PADDLE_COORDINATOR`` (``127.0.0.1:<port>``), ``PADDLE_TRAINER_ID``
    and ``PADDLE_TRAINERS``, which ``parallel.init_parallel_env`` reads.
    Unlike the JAX package's launcher, the first rank to fail stops the
    others (SIGTERM, then SIGKILL after 10 s), so no rank is left waiting
    in a collective for a peer that died.  Returns the first failing
    rank's exit code, else 0."""
    import signal
    import subprocess
    import time

    procs = []
    for rank in range(args.nproc):
        env = dict(os.environ)
        env["PADDLE_COORDINATOR"] = f"127.0.0.1:{args.port}"
        env["PADDLE_TRAINER_ID"] = str(rank)
        env["PADDLE_TRAINERS"] = str(args.nproc)
        procs.append(subprocess.Popen(
            [sys.executable, args.script] + (args.script_args or []),
            env=env))
    rc = 0
    try:
        live = list(procs)
        while live:
            for p in list(live):
                code = p.poll()
                if code is None:
                    continue
                live.remove(p)
                if code != 0 and rc == 0:
                    rc = code
                    print(f"launch: rank {procs.index(p)} exited with "
                          f"{code}; stopping the other ranks",
                          file=sys.stderr)
                    for q in live:
                        q.send_signal(signal.SIGTERM)
                    deadline = time.monotonic() + 10
                    for q in live:
                        try:
                            q.wait(max(0.0, deadline - time.monotonic()))
                        except subprocess.TimeoutExpired:
                            q.kill()
            time.sleep(poll_s)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rc


def main(argv=None):
    parser = argparse.ArgumentParser(prog="paddle_tpu_torch",
                                     description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("version", help="print version info")
    p.set_defaults(fn=_cmd_version)

    p = sub.add_parser("train", help="run a training script")
    p.add_argument("--config", required=True, help="python training script")
    p.add_argument("--num-passes", type=int, default=None)
    p.add_argument("--checkpoint-dir", default=None,
                   help="export PADDLE_TPU_CKPT_DIR for the script's "
                        "fault.manager_from_env()")
    p.add_argument("--keep-checkpoints", type=int, default=5)
    p.add_argument("script_args", nargs="*")
    p.set_defaults(fn=_cmd_train)

    p = sub.add_parser("infer", help="run a saved inference model")
    p.add_argument("--model", required=True, help="save_inference_model dir")
    p.add_argument("--feed", action="append",
                   help="name=path.npy (repeatable)")
    p.add_argument("--output", default=None, help="dir for output .npy")
    p.add_argument("--place", default="cuda:0",
                   help="cuda[:N] (default cuda:0) or cpu")
    p.set_defaults(fn=_cmd_infer)

    p = sub.add_parser("master", help="serve the data-task master")
    p.add_argument("--files", required=True, help="glob of input files")
    p.add_argument("--chunks-per-task", type=int, default=1)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8037)
    p.add_argument("--timeout", type=float, default=60.0)
    p.add_argument("--failure-max", type=int, default=3)
    p.add_argument("--snapshot", default=None,
                   help="snapshot file for restart recovery")
    p.add_argument("--heartbeat-timeout", type=float, default=None,
                   help="reclaim leases of trainers silent this long "
                        "(default: lease timeout only)")
    p.set_defaults(fn=_cmd_master)

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
                   help="HOST:PORT of the fleet master: register this "
                        "replica for discovery and heartbeat-renew its "
                        "lease (SIGTERM drains cleanly)")
    p.add_argument("--replica-id", default=None,
                   help="stable replica id (default: generated)")
    p.add_argument("--lease-ttl", type=float, default=5.0,
                   help="fleet lease TTL seconds; missing renews this "
                        "long drops the replica from routing")
    p.add_argument("--drain-deadline-s", type=float, default=30.0,
                   help="rolling-restart drain bound: seconds in-flight "
                        "generative streams may run to completion "
                        "before the rest are checkpoint-migrated to "
                        "survivors")
    p.add_argument("--advertise-host", default=None,
                   help="host other machines should dial (default: the "
                        "bind host)")
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
                   help="host:port of a serving replica or fleet router")
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

    p = sub.add_parser("router", help="health-aware fleet router over "
                                      "serving replicas")
    p.add_argument("--master", default=None,
                   help="HOST:PORT of the fleet master (live replica "
                        "discovery)")
    p.add_argument("--replicas", default=None,
                   help="comma-separated host:port list (static fleet, "
                        "no master)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8868)
    p.add_argument("--default-deadline", type=float, default=30.0,
                   help="end-to-end budget seconds for requests without "
                        "an X-Deadline-Ms header")
    p.add_argument("--poll-interval", type=float, default=0.25,
                   help="master discovery poll interval seconds")
    p.add_argument("--slo", default=None, metavar="SPEC.json",
                   help="SLO spec to evaluate in-router (breach "
                        "counters + post-mortem on sustained breach; "
                        "default: PADDLE_TPU_SLO when set)")
    p.set_defaults(fn=_cmd_router)

    p = sub.add_parser("controller",
                       help="fleet router + closed-loop autoscaler "
                            "(warm-standby scale-up, idle drain, "
                            "admission-control backpressure)")
    p.add_argument("--master", required=True,
                   help="HOST:PORT of the fleet master (replica "
                        "discovery AND standby enrollment)")
    p.add_argument("--model", required=True,
                   help="save_inference_model dir or generation bundle "
                        "standbys serve")
    p.add_argument("--place", default="cuda:0",
                   help="where standbys run: cuda[:N] (default cuda:0) "
                        "or cpu")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8868)
    p.add_argument("--policy", default=None, metavar="POLICY.json",
                   help="autoscaler policy (default: "
                        "PADDLE_TPU_AUTOSCALE when set, else the "
                        "documented defaults)")
    p.add_argument("--slo", default=None, metavar="SPEC.json",
                   help="SLO spec the controller steers by (default: "
                        "PADDLE_TPU_SLO when set)")
    p.add_argument("--default-deadline", type=float, default=30.0,
                   help="end-to-end budget seconds for requests without "
                        "an X-Deadline-Ms header")
    p.add_argument("--poll-interval", type=float, default=0.25,
                   help="master discovery poll interval seconds")
    p.add_argument("--lease-ttl", type=float, default=5.0,
                   help="fleet lease TTL seconds for promoted standbys")
    p.add_argument("--compile-cache", default=None,
                   help="not supported by the port (raises)")
    p.set_defaults(fn=_cmd_controller)

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

    p = sub.add_parser("trace", help="dump the span ring as Chrome "
                                     "trace-event JSON (Perfetto)")
    p.add_argument("action", choices=["dump"])
    p.add_argument("--addr", default=None,
                   help="host:port of a serving replica (/trace); "
                        "default: this process's ring (--local)")
    p.add_argument("--local", action="store_true",
                   help="this process's span ring (the default when "
                        "--addr is not given)")
    p.add_argument("--fleet", action="store_true",
                   help="assembled fleet timeline via the router's "
                        "/trace?fleet=1 (--addr names the router): every "
                        "process's spans merged onto one clock, one pid "
                        "row per process")
    p.add_argument("--output", default=None,
                   help="write the JSON here instead of stdout")
    p.set_defaults(fn=_cmd_trace)

    p = sub.add_parser("fleet-stats",
                       help="federated fleet metrics: one Prometheus "
                            "exposition over every replica's registry "
                            "(per-replica labels + rollups; dead "
                            "replicas marked stale)")
    p.add_argument("--router", default=None,
                   help="host:port of the fleet router (proxies its "
                        "/metrics?fleet=1 — keeps rate state between "
                        "pulls)")
    p.add_argument("--master", default=None,
                   help="HOST:PORT of the fleet master: scrape the "
                        "current lease table in-process")
    p.add_argument("--replicas", default=None,
                   help="comma-separated host:port list to scrape "
                        "(static fleet, no master)")
    p.add_argument("--timeout", type=float, default=5.0,
                   help="per-replica scrape timeout seconds")
    p.add_argument("--json", action="store_true",
                   help="per-replica scrape health instead of the "
                        "exposition text")
    p.set_defaults(fn=_cmd_fleet_stats)

    p = sub.add_parser("bench",
                       help="bench trajectory: record runs into "
                            "BENCH_TRAJECTORY_TORCH.json and gate on "
                            "regressions vs the recorded baseline")
    p.add_argument("action", choices=["check", "record"])
    p.add_argument("--trajectory", default=None,
                   help="trajectory file (default: the repo's "
                        "BENCH_TRAJECTORY_TORCH.json)")
    p.add_argument("--dry", action="store_true",
                   help="with check: validate the schema only, no "
                        "regression comparison")
    p.add_argument("--bench", default=None,
                   help="with record: bench name (serving|datapipe|"
                        "fleet|decode|...)")
    p.add_argument("--summary", default=None,
                   help="with record: the bench's summary JSON to import")
    p.add_argument("--baseline", action="store_true",
                   help="with record: flag the run as the bench's "
                        "comparison baseline")
    p.add_argument("--json", action="store_true",
                   help="machine-readable report")
    p.set_defaults(fn=_cmd_bench)

    p = sub.add_parser("runs",
                       help="run-ledger readers (obs.ledger JSONL step "
                            "series): tail the last rows, digest a whole "
                            "run, or compare two runs")
    p.add_argument("action", choices=["tail", "show", "compare"])
    p.add_argument("dir", help="ledger directory (RunLedger dirname)")
    p.add_argument("dir_b", nargs="?", default=None,
                   help="second ledger directory (compare only)")
    p.add_argument("-n", type=int, default=10,
                   help="with tail: number of rows (default 10)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable report")
    p.set_defaults(fn=_cmd_runs)

    p = sub.add_parser("lint", help="static-analyze a program IR "
                                    "(PTA*** diagnostics)")
    p.add_argument("target", nargs="?", default=None,
                   help="save_inference_model dir (or a __model__ json "
                        "file) to lint; a dir with gen_meta.json lints "
                        "the whole generation bundle (prefill + decode "
                        "+ cross-program signature checks)")
    p.add_argument("--pair", nargs=2, metavar=("TRAINER", "PSERVER"),
                   default=None,
                   help="lint a transpiled trainer/pserver pair as one "
                        "unit: Send/Recv matching, split reassembly, "
                        "collective sync (PTA011-PTA014)")
    p.add_argument("--pipeline", type=int, default=None, metavar="N",
                   help="also split each linted program into N "
                        "pipeline stages and verify boundary carriers "
                        "+ cross-stage collective sync (PTA011/PTA015)")
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

    p = sub.add_parser("replay", help="re-execute a sentinel-quarantined "
                                      "step on the CPU (exit 0 = fault "
                                      "reproduced)")
    p.add_argument("bundle", help="pickled repro bundle from the "
                                  "sentinel's quarantine dir")
    p.add_argument("--localize", action="store_true",
                   help="re-execute op by op with per-op tensor-stat "
                        "probes and name the FIRST op producing a "
                        "non-finite output (creation site + stat "
                        "trail); exit 0 = localized, 1 = clean")
    p.add_argument("--json", action="store_true",
                   help="machine-readable report instead of prose")
    p.set_defaults(fn=_cmd_replay)

    p = sub.add_parser("ckpt",
                       help="survey a checkpoint directory: steps, "
                            "per-shard manifest status, saved topology, "
                            "last-good pointer; verify re-hashes and "
                            "exit-codes on corruption")
    p.add_argument("action", choices=["inspect", "verify"])
    p.add_argument("dir", help="checkpoint directory "
                               "(CheckpointManager dirname)")
    p.add_argument("--step", type=int, default=None,
                   help="limit to one committed step")
    p.add_argument("--json", action="store_true",
                   help="machine-readable report")
    p.set_defaults(fn=_cmd_ckpt)

    p = sub.add_parser("profile",
                       help="device-performance profiling family: "
                            "per-op device time (op), per-signature "
                            "cost/memory records (compile), HBM census "
                            "(memory), N-step feed/dispatch/device-wait/"
                            "fetch breakdown (step)")
    p.add_argument("action", nargs="?", default="op",
                   choices=["op", "compile", "memory", "step"],
                   help="op = per-IR-op device-time table (default); "
                        "compile = per-signature FLOPs/bytes/memory + "
                        "prepare/first-run/capture seconds; memory = "
                        "HBM census by collection; step = per-step "
                        "phase breakdown (+ --trace-dir for a "
                        "torch.profiler trace)")
    p.add_argument("--model", default="transformer",
                   choices=["transformer", "resnet"],
                   help="built-in model for op/step modes")
    p.add_argument("--zoo", default="mnist",
                   help="zoo model for compile/memory modes "
                        "(mnist|resnet|vgg|transformer|seq2seq|"
                        "stacked_lstm|gen_lm)")
    p.add_argument("--place", default="cuda:0",
                   help="cuda[:N] (default cuda:0) or cpu")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64,
                   help="sequence length (transformer) or image side "
                        "(resnet)")
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--sorted-by", default="total",
                   choices=["total", "calls"])
    p.add_argument("--trace-dir", default=None,
                   help="with step: also write a torch.profiler trace "
                        "of the measured window here")
    p.add_argument("--json", action="store_true",
                   help="machine-readable report (compile/memory)")
    p.set_defaults(fn=_cmd_profile)

    p = sub.add_parser("launch", help="spawn a local N-process world")
    p.add_argument("--nproc", type=int, required=True)
    p.add_argument("--port", type=int, default=8357)
    p.add_argument("script")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    p.set_defaults(fn=_cmd_launch)

    p = sub.add_parser("selfcheck", help="every static gate in one pass; "
                                         "not in the port yet (raises)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_selfcheck)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
