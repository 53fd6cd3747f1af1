"""Command-line entry points of the port (the serving part of
``paddle_tpu.cli``).

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

``serve --master`` (fleet enrollment) and ``--compile-cache`` (the JAX
package's persistent XLA cache) raise: the fleet is not ported yet, and
the port's kernels always build into the build directory beside their
sources.
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

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
