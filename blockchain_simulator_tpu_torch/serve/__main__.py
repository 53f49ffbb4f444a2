"""``python -m blockchain_simulator_tpu_torch.serve`` — the scenario-serving
daemon (port of ``blockchain_simulator_tpu/serve/__main__.py``).

A stdlib-only HTTP front over :class:`~blockchain_simulator_tpu_torch.
serve.server.ScenarioServer`:

- ``POST /scenario`` — one JSON scenario request; the response body is the
  uniform result/error record and the HTTP status mirrors its ``code``.
- ``GET /stats`` — serving counters, batch-occupancy histogram, admission
  state, and the executable-registry snapshot.
- ``GET /metrics`` — the Prometheus exposition (utils/telemetry.py).
- ``GET /healthz`` — readiness: 200 while admitting, 503 while paused or
  draining.
- ``POST /health`` — push a health verdict (``{"verdict": "sick"}``) to
  pause/resume admission.
- ``POST /shutdown`` — graceful drain and exit (body ``{"drain": false}``
  answers the queued backlog with typed 503 rejections instead).

The daemon serves on the CUDA card unless ``--device cpu`` asks for the
CPU; without a card it exits nonzero before printing ``READY``, and it
never falls back to the CPU.  With ``--wal PATH`` admitted requests are
journaled durably (serve/wal.py) and replayed after a crash.  The daemon
prints exactly one ``READY {...}`` JSON line (with the bound port) once
serving, so clients of an ephemeral ``--port 0`` can find it.

``--self-test`` runs the whole stack against itself — daemon on an
ephemeral port, a mixed-workload drill over real HTTP (batchable pair,
un-batchable reject, health pause, stats), then a clean shutdown —
printing one JSON summary line and exiting nonzero on any miss.

With ``--journal PATH`` batched flushes journal their rows in the
durable-sweep journal (parallel/journal.py): a restarted daemon answers a
WAL-replayed batch whose rows were already computed from the journal, and a
``query`` request's refinement steps journal there too.  ``--mesh-sweep`` >
0 (a sweep mesh over many GPUs) comes with the serving surfaces of the sweep
axis (ROADMAP.md queue A item 7b) and exits 2.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time


def make_httpd(server, host: str = "127.0.0.1", port: int = 0):
    """Build (not start) the ThreadingHTTPServer front for a
    :class:`ScenarioServer`.  Returned httpd serves until
    ``httpd.shutdown()``; ``httpd.server_address`` carries the bound
    ephemeral port.  Separated from :func:`main` so tests can drive the
    HTTP surface in-process."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        # one JSON body per response; stderr chatter suppressed (the
        # daemon's stdout protocol is READY + nothing else)
        def log_message(self, fmt, *args):
            pass

        def _send(self, code: int, body: dict) -> None:
            blob = (json.dumps(body) + "\n").encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def _read_json(self):
            try:
                length = int(self.headers.get("Content-Length") or 0)
                return json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, json.JSONDecodeError):
                return None

        def do_GET(self):
            if self.path == "/stats":
                self._send(200, server.stats())
            elif self.path == "/metrics":
                # Prometheus text exposition (utils/telemetry.py):
                # process-wide counters/gauges/histograms
                from blockchain_simulator_tpu_torch.utils import telemetry

                telemetry.write_exposition(self)
            elif self.path == "/healthz":
                ready = not server.paused and not server._closing
                self._send(200 if ready else 503, {
                    "ready": ready,
                    "health": dict(server._health),
                })
            else:
                self._send(404, {"status": "error", "code": 404,
                                 "kind": "not-found", "error": self.path})

        def do_POST(self):
            if self.path == "/scenario":
                obj = self._read_json()
                if obj is None:
                    self._send(400, {
                        "status": "error", "code": 400,
                        "kind": "invalid-request",
                        "error": "body is not valid JSON",
                    })
                    return
                # adopt the router's trace context (X-Blocksim-Trace) so
                # this replica's span tree parents to the router's send
                # span (utils/telemetry.py; a missing/garbled header just
                # mints a fresh trace — never a rejection)
                from blockchain_simulator_tpu_torch.utils import telemetry

                ctx = telemetry.parse_header(
                    self.headers.get(telemetry.TRACE_HEADER))
                with telemetry.context(ctx):
                    resp = server.request(obj)
                # a query's answer body carries no "code" (the JAX
                # package's body, kept equal); its status "ok" is a 200
                self._send(resp.get("code", 200 if resp.get("status") == "ok" else 500), resp)
            elif self.path == "/health":
                obj = self._read_json()
                verdict = obj.get("verdict") if isinstance(obj, dict) \
                    else None
                if not isinstance(verdict, str) or not verdict:
                    # an empty/garbled probe body must NOT flip admission
                    self._send(400, {
                        "status": "error", "code": 400,
                        "kind": "invalid-request",
                        "error": "body must be a JSON object with a "
                                 "\"verdict\" string "
                                 "(healthy/sick/wedged)",
                    })
                    return
                rec = server.set_health(obj)
                self._send(200, {"status": "ok", "health": rec,
                                 "paused": server.paused})
            elif self.path == "/shutdown":
                obj = self._read_json()
                drain = True
                if isinstance(obj, dict) and obj.get("drain") is False:
                    # fast shutdown: queued requests answer as typed 503s
                    # with rejection manifests instead of dispatching
                    drain = False
                    server._drain = False
                self._send(200, {"status": "ok", "draining": drain})
                threading.Thread(target=httpd.shutdown,
                                 daemon=True).start()
            else:
                self._send(404, {"status": "error", "code": 404,
                                 "kind": "not-found", "error": self.path})

    httpd = ThreadingHTTPServer((host, port), Handler)
    return httpd


# ------------------------------------------------------------- self-test


def self_test(args) -> int:
    """End-to-end smoke over real HTTP: admission, micro-batching,
    typed rejection, stats, drain.  One JSON summary line; exit 0 only if
    every check passed."""
    import urllib.error
    import urllib.request

    from blockchain_simulator_tpu_torch.serve.server import ScenarioServer
    from blockchain_simulator_tpu_torch.utils import obs

    template = {
        "protocol": "pbft", "n": 8, "sim_ms": 300, "stat_sampler": "exact",
    }
    server = ScenarioServer(max_batch=4, max_wait_ms=200.0, max_queue=32,
                            device=args.device)
    httpd = make_httpd(server, args.host, args.port)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://{args.host}:{port}"

    def call(path, obj=None, method="GET"):
        data = None if obj is None else json.dumps(obj).encode()
        req = urllib.request.Request(
            f"{base}{path}", data=data,
            method=method if obj is None else "POST",
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    checks: dict[str, bool] = {}
    # cold pair: two same-structure requests differing only in (seed, f)
    # must land in ONE batched dispatch (max_wait 200 ms covers the gap)
    lat_ms: list[float] = []   # WARM latencies only: the gated p99 series
    results: list[dict] = []

    def post(obj, warm=False):
        s, body = call("/scenario", obj)
        results.append(body)
        if warm and body.get("status") == "ok":
            lat_ms.append(body["latency_ms"])
        return s, body

    t0 = time.monotonic()
    threads = [
        threading.Thread(target=post, args=(dict(
            template, seed=i, faults={"n_byzantine": i % 2},
        ),)) for i in range(2)
    ]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    cold_s = time.monotonic() - t0
    oks = [r for r in results if r.get("status") == "ok"]
    checks["cold_pair_ok"] = len(oks) == 2
    checks["cold_pair_batched"] = any(
        r.get("batch", {}).get("size", 0) >= 2 for r in oks
    )
    # solo warmup (untimed): the first sequential request builds the
    # serve-solo program — keep that out of the p99 sample so serve_p99_ms
    # measures the serving path, not a one-time build
    post(dict(template, seed=99))
    # warm traffic: sequential requests (batch size 1, warm solo path)
    t1 = time.monotonic()
    n_warm = args.self_test_requests
    warm_ok = 0
    for i in range(n_warm):
        s, body = post(dict(template, seed=100 + i), warm=True)
        warm_ok += body.get("status") == "ok"
    warm_s = time.monotonic() - t1
    checks["warm_ok"] = warm_ok == n_warm
    # typed rejection: the mixed shard sim is un-batchable -> 422, daemon up
    s, body = call("/scenario", dict(template, protocol="mixed", n=32))
    checks["unbatchable_422"] = (
        s == 422 and body.get("kind") == "unbatchable-config"
    )
    # health drill over HTTP: pause -> 503, resume -> served
    call("/health", {"verdict": "sick"})
    s, _body = call("/scenario", dict(template, seed=999))
    checks["paused_503"] = s == 503
    call("/health", {"verdict": "healthy"})
    s, _body = call("/scenario", dict(template, seed=999))
    checks["resumed_200"] = s == 200
    s, stats = call("/stats")
    checks["stats_cache_snapshot"] = "by_factory" in stats.get("cache", {})
    s, _ = call("/shutdown", obj={}, method="POST")
    t.join(timeout=30)
    server.close()

    rps = round((warm_ok) / warm_s, 2) if warm_s > 0 else None
    p50 = round(obs.percentile(lat_ms, 50), 3)
    p99 = round(obs.percentile(lat_ms, 99), 3)
    summary = {
        "metric": "serve_selftest",
        "ok": all(checks.values()),
        "checks": checks,
        "served": int(stats.get("served", 0)),
        "batches": int(stats.get("batches", 0)),
        "occupancy": stats.get("occupancy"),
        "cold_pair_s": round(cold_s, 3),
        "warm_rps": rps,
        "p50_ms": p50,
        "p99_ms": p99,
    }
    print(json.dumps(obs.finalize(dict(summary), None, append=False)),
          flush=True)
    # trajectory metrics (bench_compare charts both; p99 is gated
    # lower-is-better, p50 charted only) — warm-path numbers so the series
    # is comparable run to run
    obs.finalize({"metric": "serve_rps", "value": rps, "unit": "req/s"})
    obs.finalize({"metric": "serve_p99_ms", "value": p99, "unit": "ms"})
    obs.finalize({"metric": "serve_p50_ms", "value": p50, "unit": "ms"})
    return 0 if summary["ok"] else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="blockchain_simulator_tpu_torch.serve",
        description="scenario-serving daemon: JSON scenario requests over "
                    "HTTP, micro-batched into warm lane batches on the card",
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8787,
                   help="0 = ephemeral (the READY line carries the bound "
                        "port)")
    p.add_argument("--max-batch", type=int, default=8,
                   help="flush a batch group at this depth")
    p.add_argument("--max-wait-ms", type=float, default=25.0,
                   help="flush a batch group when its oldest request has "
                        "waited this long")
    p.add_argument("--max-queue", type=int, default=64,
                   help="bounded admission queue (beyond it: 429 "
                        "backpressure)")
    p.add_argument("--timeout-s", type=float, default=30.0,
                   help="default per-request timeout")
    p.add_argument("--health-log", default=None,
                   help="seed the admission gate from this rolling "
                        "HEALTH.jsonl (utils/health.py)")
    p.add_argument("--wal", default=None, metavar="PATH",
                   help="crash-durable write-ahead log of admitted "
                        "requests (serve/wal.py): a restarted daemon "
                        "replays admitted-but-unanswered requests exactly "
                        "once per pending id")
    p.add_argument("--journal", default=None, metavar="PATH",
                   help="durable-sweep journal (parallel/journal.py) for "
                        "batched flushes and query steps: a restarted daemon "
                        "answers a WAL-replayed batch whose rows were already "
                        "computed from the journal instead of re-running it")
    p.add_argument("--wal-no-sync", action="store_true",
                   help="skip the per-admit fsync (faster admission, "
                        "admits may be lost to an OS crash — process "
                        "kills still replay)")
    p.add_argument("--breaker-threshold", type=int, default=3,
                   help="consecutive batched-dispatch failures before a "
                        "group's circuit breaker opens (solo-only mode)")
    p.add_argument("--breaker-cooldown-s", type=float, default=30.0,
                   help="seconds an open breaker waits before its "
                        "half-open probe batch")
    p.add_argument("--prewarm", default=None, metavar="JSON",
                   help="request template whose batch group's registry "
                        "entries are built for every bucket size before "
                        "serving starts")
    p.add_argument("--prewarm-from", default=None, metavar="RUNS_JSONL",
                   help="prewarm the group/bucket mix OBSERVED in a prior "
                        "access log (each served line carries its "
                        "re-submittable scenario template) instead of the "
                        "fixed bucket ladder")
    p.add_argument("--prewarm-groups", type=int, default=8,
                   help="--prewarm-from warms at most this many of the "
                        "most-frequent observed batch groups")
    p.add_argument("--replica-id", default=None, metavar="ID",
                   help="fleet identity (serve/fleet.py): labels health-"
                        "log seeding so N replicas sharing one "
                        "HEALTH.jsonl read only their own verdicts, and "
                        "rides the READY line/stats")
    p.add_argument("--mesh-sweep", type=int, default=0, metavar="N",
                   help="shard batched dispatches over an N-device sweep "
                        "mesh (comes with the serving surfaces of the "
                        "sweep axis, ROADMAP.md queue A item 7b; > 0 exits 2)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device every dispatch runs on: cuda (the default; "
                        "without a card the daemon exits before READY, it "
                        "never falls back) or cpu (the kernels' plain "
                        "versions)")
    p.add_argument("--self-test", action="store_true",
                   help="serve-and-drive smoke: ephemeral daemon, "
                        "batch/reject/health drill over HTTP, one JSON "
                        "summary line")
    p.add_argument("--self-test-requests", type=int, default=16,
                   help="warm requests in the self-test latency sample")
    args = p.parse_args(argv)

    from blockchain_simulator_tpu_torch.parallel.mesh import MESH_SERVING_ITEM

    if args.mesh_sweep and args.mesh_sweep > 0:
        print(f"serve: --mesh-sweep {args.mesh_sweep} (a sweep mesh) comes with "
              f"{MESH_SERVING_ITEM}", file=sys.stderr)
        return 2
    from blockchain_simulator_tpu_torch import runner

    try:
        runner.resolve_device(args.device)
    except RuntimeError as e:
        # no card: refuse before READY, never fall back to the CPU
        print(f"serve: {e}", file=sys.stderr)
        return 1
    if args.self_test:
        args.port = 0
        return self_test(args)

    from blockchain_simulator_tpu_torch.serve.server import ScenarioServer
    from blockchain_simulator_tpu_torch.utils import telemetry

    # an unhandled daemon exception leaves a flight-recorder post-mortem
    # (when $BLOCKSIM_FLIGHT_DIR is armed) before the traceback
    telemetry.install_crash_dump()
    server = ScenarioServer(
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        max_queue=args.max_queue,
        default_timeout_s=args.timeout_s,
        health_log=args.health_log,
        wal_path=args.wal,
        wal_sync=not args.wal_no_sync,
        breaker_threshold=args.breaker_threshold,
        breaker_cooldown_s=args.breaker_cooldown_s,
        replica=args.replica_id,
        journal_path=args.journal,
        device=args.device,
    )
    if args.prewarm:
        try:
            walls = server.prewarm(json.loads(args.prewarm))
            print(json.dumps({"prewarm_s": walls}), flush=True)
        except Exception as e:
            print(json.dumps({"prewarm_error": f"{type(e).__name__}: {e}"}),
                  flush=True)
    if args.prewarm_from:
        try:
            plan = server.prewarm_from(args.prewarm_from,
                                       max_groups=args.prewarm_groups)
            print(json.dumps({"prewarm_from": {
                g: {"requests": rec["requests"], "buckets": rec["buckets"]}
                for g, rec in plan.items()
            }}), flush=True)
        except Exception as e:
            print(json.dumps(
                {"prewarm_from_error": f"{type(e).__name__}: {e}"}),
                flush=True)
    httpd = make_httpd(server, args.host, args.port)
    print("READY " + json.dumps({
        "host": args.host, "port": httpd.server_address[1],
        "max_batch": server.max_batch, "max_wait_ms": server.max_wait_ms,
        "max_queue": server.max_queue, "wal": args.wal,
        "replayed": server._wal_replayed_at_start if args.wal else 0,
        "wal_claimed_by": server._wal_claimed_by if args.wal else None,
        "replica": args.replica_id,
        "mesh": server.stats()["mesh"],
        "device": str(server.device),
    }), flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
