"""FleetRouter: health-aware request routing over N serving replicas (port
of ``blockchain_simulator_tpu/serve/router.py``).

The front door of the serving fleet (serve/fleet.py): admits the SAME
JSON scenario schema the single daemon admits (serve/schema.py — invalid
requests answer their typed 400/422 at the edge, before a replica is
bothered), and spreads valid traffic over the replica daemons:

- **Group-affinity routing** (``route="affinity"``, default): requests
  hash their batch group (canonical fault structure) onto a stable
  preferred replica, so same-group traffic lands in one batcher and
  micro-batching keeps working at fleet scale; unhealthy preferred
  replicas fall back to round-robin.  ``route="rr"`` is plain
  round-robin.
- **Health probes + breakers**: a prober thread GETs every replica's
  ``/healthz`` each ``probe_interval_s``; ``dead_after`` consecutive
  unreachable probes (or a reaped subprocess) declare the replica dead
  and trigger the WAL handoff.  A per-replica circuit breaker (the
  serve/server.py state machine, here over *transport* failures) stops
  routing to a flapping replica until its cooldown probe.
- **Bounded retry with backoff**: connection-refused sends (the request
  provably never reached admission) and 429/503 answers (queue-full /
  admission-paused / draining — the replica is alive but not taking)
  retry on a different replica, ``retries`` times with exponential
  backoff.  Any other answer is terminal — a typed 400 would be a 400
  everywhere.
- **Idempotent by request id**: each admission resolves through an
  answer-once future (:class:`RouterPending`); whichever of a slow
  primary, a hedge, or a WAL replay answers first wins, later answers
  are dropped and counted (``late_answers``) — a retry that raced a slow
  success never double-answers the client.
- **Hedged failover** (``hedge_ms`` > 0): a request with no answer after
  ``hedge_ms`` is sent once more to a different replica.  A hedged
  *simulation* may execute twice — harmless by construction: requests
  are pure functions of (config, seed), so both answers are bit-equal
  under the exact sampler.
- **WAL handoff on replica death**: a send that breaks mid-flight
  (connection reset — the request MAY have been admitted and journaled)
  is *parked*, never blind-retried; when the prober declares the replica
  dead the router lease-claims its WAL (serve/fleet.py claim rules,
  exactly once fleet-wide even with racing routers) and replays every
  admitted-but-unanswered id on a live peer in admission order, marked
  ``"replayed": true``, resolving the parked futures.  Parked ids the
  WAL never admitted are re-dispatched on a peer the same way.

Nothing here touches a tensor: the router is stdlib HTTP + the schema
layer (validation parses configs, it never dispatches), so a router
process fronting subprocess replicas on the card stays light and its tests
run against stub replicas with no dispatch at all.  Counters
(``blocksim_fleet_*``), the latency histogram and the ``router.*`` /
``fleet.*`` spans are the JAX package's, through the port's
utils/telemetry.py.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
import urllib.error
import urllib.request

from blockchain_simulator_tpu_torch.chaos import inject
from blockchain_simulator_tpu_torch.serve import schema
from blockchain_simulator_tpu_torch.serve.server import CircuitBreaker
from blockchain_simulator_tpu_torch.utils import obs, telemetry


def _transport_kind(exc: BaseException) -> str:
    """``refused`` = the connection never opened, the request provably
    never reached admission (safe to retry elsewhere); ``broken`` =
    anything after that (reset, truncated response, timeout) — the
    request MAY be admitted and WAL-journaled, so the only safe answer
    paths are the replica's own late response or the WAL handoff."""
    seen: set[int] = set()
    stack: list[BaseException] = [exc]
    while stack:
        e = stack.pop()
        if id(e) in seen:
            continue
        seen.add(id(e))
        if isinstance(e, ConnectionRefusedError):
            return "refused"
        for nxt in (getattr(e, "reason", None), e.__cause__, e.__context__):
            if isinstance(nxt, BaseException):
                stack.append(nxt)
    return "broken"


class RouterPending:
    """Answer-once future for one admitted request: the first terminal
    answer (primary, hedge, or WAL replay) wins; later ones are dropped
    and counted by the router.  ``result(wait_s)`` elapsing returns a
    typed 504 body without un-parking the request (matching
    serve/server.py's PendingResponse semantics)."""

    __slots__ = ("_event", "_lock", "_response", "req_id", "primary_id",
                 "answered_at", "submitted_at", "trace_id", "root_span")

    def __init__(self, req_id: str):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._response = None
        self.req_id = req_id
        self.primary_id = None  # replica currently carrying the request
        self.answered_at = None  # monotonic stamp of the winning answer:
        # open-loop clients collect long after resolution, so latency must
        # be measured here, not at result()
        self.submitted_at = time.monotonic()
        # trace identity (utils/telemetry.py): the trace is minted at
        # router admission; the root span id is allocated NOW so send/
        # hedge/replay children can parent to it before the root closes
        # at the winning answer
        self.trace_id = telemetry.new_trace_id()
        self.root_span = telemetry.new_span_id()

    def root_ctx(self) -> "telemetry.TraceContext":
        return telemetry.TraceContext(self.trace_id, self.root_span)

    def _set_once(self, response: dict) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._response = response
            self.answered_at = time.monotonic()
            self._event.set()
            return True

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, wait_s: float | None = None) -> dict:
        if not self._event.wait(wait_s):
            return schema.RequestTimeoutError(
                f"no fleet response within wait_s={wait_s}"
            ).to_response(self.req_id)
        return self._response


class _Endpoint:
    """Router-side runtime state for one replica.  ``spec`` duck-types
    ``id``/``base_url``/``wal_path`` (a fleet.ReplicaProc, or any
    namespace the tests build); ``base_url`` is read live so a restarted
    subprocess replica's new port is picked up."""

    __slots__ = ("spec", "id", "state", "ready", "probe_failures",
                 "breaker", "parked", "forwarded", "handoff_done")

    def __init__(self, spec, breaker_threshold: int,
                 breaker_cooldown_s: float):
        self.spec = spec
        self.id = str(spec.id)
        self.state = "up"          # "up" | "dead"
        self.ready = True          # /healthz 200 vs 503 (alive but paused)
        self.probe_failures = 0
        self.breaker = CircuitBreaker(breaker_threshold, breaker_cooldown_s)
        self.parked: dict = {}     # req_id -> (obj, RouterPending)
        self.forwarded = 0
        # set (under the router lock) BEFORE the handoff drains parked:
        # a send that breaks after the drain must self-redispatch — no
        # one will ever drain its park again
        self.handoff_done = False

    @property
    def base_url(self):
        return self.spec.base_url

    @property
    def wal_path(self):
        return getattr(self.spec, "wal_path", None)

    def snapshot(self) -> dict:
        return {
            "state": self.state,
            "ready": self.ready,
            "probe_failures": self.probe_failures,
            "forwarded": self.forwarded,
            "parked": len(self.parked),
            "breaker": self.breaker.snapshot(),
        }


class FleetRouter:
    """See the module docstring.  ``replicas`` is a list of endpoint specs
    (fleet.ReplicaProc after ``start()``, or any object with ``id``,
    ``base_url`` and optionally ``wal_path``/``proc``).  ``probe=False``
    disables the prober thread (unit tests drive :meth:`declare_dead`
    directly); ``manager`` (a fleet.FleetManager) enables restart of a
    dead replica after its handoff completes."""

    def __init__(self, replicas, *, retries: int = 2,
                 retry_backoff_s: float = 0.05, hedge_ms: float = 0.0,
                 probe_interval_s: float = 0.5, probe_timeout_s: float = 5.0,
                 dead_after: int = 2, request_timeout_s: float = 120.0,
                 breaker_threshold: int = 3, breaker_cooldown_s: float = 30.0,
                 route: str = "affinity", validate: bool = True,
                 owner: str | None = None, probe: bool = True,
                 manager=None):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        if route not in ("affinity", "rr"):
            raise ValueError(f"route must be 'affinity' or 'rr': {route!r}")
        self.retries = int(retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.hedge_ms = float(hedge_ms)
        self.probe_interval_s = float(probe_interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.dead_after = int(dead_after)
        self.request_timeout_s = float(request_timeout_s)
        self.route = route
        self.validate = bool(validate)
        self.owner = str(owner) if owner else f"router-{id(self):x}"
        self.manager = manager
        self._endpoints = [
            _Endpoint(spec, breaker_threshold, breaker_cooldown_s)
            for spec in replicas
        ]
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._rr = itertools.count()
        self._stop = threading.Event()
        self._stats = {
            "received": 0, "answered": {}, "retries": 0, "hedges": 0,
            "late_answers": 0, "parked_total": 0, "handoff_lost": 0,
        }
        self._handoffs: list[dict] = []
        # private fleet-latency histogram behind /stats "latency_ms"
        # (utils/telemetry.py; the global registry gets the same
        # observations for /metrics)
        self._hist = telemetry.Histogram("fleet_request_latency_ms", {},
                                         threading.Lock())
        self._threads: list[threading.Thread] = []
        self._prober: threading.Thread | None = None
        if probe:
            self._prober = threading.Thread(
                target=self._probe_loop, name="fleet-prober", daemon=True)
            self._prober.start()

    # ------------------------------------------------------------ plumbing
    def _http(self, method: str, base: str, path: str, obj=None,
              timeout: float = 60.0):
        headers = {"Content-Type": "application/json"}
        ctx = telemetry.current()
        if ctx is not None:
            # propagate the caller's span (a router.send span around this
            # call) so the replica's serve.request parents to it — the
            # cross-process half of the trace (utils/telemetry.py)
            headers[telemetry.TRACE_HEADER] = ctx.header()
        data = None if obj is None else json.dumps(obj).encode()
        req = urllib.request.Request(
            f"{base}{path}", data=data, method=method,
            headers=headers,
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            # got a full response: a typed 4xx/5xx body, not a transport
            # failure — the replica is alive and accounted for this id
            return e.code, json.loads(e.read())

    def _count_answer(self, body: dict) -> None:
        kind = "ok" if body.get("status") == "ok" else str(body.get("kind"))
        with self._lock:
            by = self._stats["answered"]
            by[kind] = by.get(kind, 0) + 1

    def _answer(self, pending: RouterPending, body: dict,
                log: bool = False) -> None:
        """Resolve one future exactly once; a late answer is dropped and
        counted.  ``log=True`` access-logs router-ORIGINATED bodies
        (edge rejections, replica-lost) — replica-produced answers were
        already logged by the replica itself."""
        if pending._set_once(body):
            self._count_answer(body)
            try:
                # the winning answer closes the trace's root span and
                # lands the open-loop latency (submit -> answered_at) on
                # the fleet histograms — hedge losers never reach here
                kind = "ok" if body.get("status") == "ok" \
                    else str(body.get("kind"))
                telemetry.emit(
                    "router.request", pending.submitted_at,
                    pending.answered_at, trace=pending.trace_id,
                    span_id=pending.root_span,
                    status="ok" if kind == "ok" else "error",
                    id=pending.req_id, outcome=kind,
                    hedged=body.get("hedged"),
                    replayed=body.get("replayed"),
                )
                ms = (pending.answered_at - pending.submitted_at) * 1000.0
                self._hist.observe(ms)
                telemetry.metrics.histogram(
                    "blocksim_fleet_request_latency_ms").observe(ms)
                telemetry.metrics.counter(
                    "blocksim_fleet_answered_total", kind=kind).inc()
            except Exception:
                pass  # telemetry must never block the answer
            if log:
                obs.record_run(body, None)
        else:
            with self._lock:
                self._stats["late_answers"] += 1
            telemetry.metrics.counter(
                "blocksim_fleet_late_answers_total").inc()

    # ------------------------------------------------------------- routing
    def _routable(self, now: float) -> list[_Endpoint]:
        out = []
        for ep in self._endpoints:
            if ep.state != "up" or not ep.ready:
                continue
            # breaker gate: closed (or an elapsed cooldown converting to
            # the half-open probe) admits traffic; open does not
            if not ep.breaker.allow_batched(now):
                continue
            out.append(ep)
        return out

    def _pick(self, group: str | None, exclude=()) -> _Endpoint | None:
        with self._lock:
            cands = self._routable(time.monotonic())
            if not cands:
                return None
            avail = [ep for ep in cands if ep.id not in exclude] or cands
            if self.route == "affinity" and group:
                # affinity hashes over the FULL replica list, so the
                # group→replica map is stable across flaps of others
                idx = int(group[:8], 16) % len(self._endpoints)
                pref = self._endpoints[idx]
                if pref in avail:
                    return pref
            return avail[next(self._rr) % len(avail)]

    def replica_ids(self) -> list[str]:
        return [ep.id for ep in self._endpoints]

    def affinity_replica(self, obj: dict) -> str | None:
        """Which replica a request's batch group prefers (the drills aim
        their traffic with this); None for rr routing/invalid requests."""
        if self.route != "affinity":
            return None
        try:
            req = schema.parse_request(dict(obj), "probe")
        except schema.ServeError:
            return None
        group = obs.config_hash(req.canon)
        return self._endpoints[int(group[:8], 16)
                               % len(self._endpoints)].id

    # ------------------------------------------------------------ admission
    def submit(self, obj: dict) -> RouterPending:
        """Validate (typed edge rejection) and dispatch one request;
        returns the answer-once future immediately (open-loop clients
        submit at their arrival rate and collect later)."""
        with self._lock:
            self._stats["received"] += 1
            req_id = str((obj or {}).get("id", "")
                         if isinstance(obj, dict) else "") \
                or f"fr{next(self._ids)}"
        telemetry.metrics.counter("blocksim_fleet_received_total").inc()
        pending = RouterPending(req_id)
        group = None
        if self.validate:
            try:
                req = schema.parse_request(
                    dict(obj) if isinstance(obj, dict) else obj, req_id)
                group = obs.config_hash(req.canon)
            except schema.ServeError as e:
                self._answer(pending, e.to_response(req_id), log=True)
                return pending
        t = threading.Thread(
            target=self._dispatch, args=(dict(obj), req_id, group, pending),
            name=f"fleet-dispatch-{req_id}", daemon=True,
        )
        with self._lock:
            self._threads.append(t)
            self._threads = [x for x in self._threads if x.is_alive()]
        t.start()
        # query requests are never hedged: an adaptive search is minutes
        # long by design, so a silent-past-hedge_ms duplicate would run
        # the WHOLE search twice on another replica — slow-replica rescue
        # for queries is the WAL handoff path, not the hedge
        is_query = isinstance(obj, dict) and obj.get("query") is not None
        if self.hedge_ms > 0 and not is_query:
            timer = threading.Timer(
                self.hedge_ms / 1000.0, self._hedge,
                args=(dict(obj), req_id, group, pending),
            )
            timer.daemon = True
            timer.start()
        return pending

    def request(self, obj: dict, wait_s: float | None = None) -> dict:
        """submit + wait: always a response dict (the HTTP front's shape)."""
        pending = self.submit(obj)
        return pending.result(
            wait_s if wait_s is not None else self.request_timeout_s + 30.0)

    # ------------------------------------------------------------- dispatch
    def _dispatch(self, obj: dict, req_id: str, group: str | None,
                  pending: RouterPending) -> None:
        last_retryable: dict | None = None
        tried: set[str] = set()
        for attempt in range(self.retries + 1):
            if pending.done():
                return  # a hedge (or replay) already answered
            rep = self._pick(group, exclude=tried)
            if rep is None:
                break
            if attempt:
                with self._lock:
                    self._stats["retries"] += 1
                telemetry.metrics.counter(
                    "blocksim_fleet_retries_total").inc()
                time.sleep(self.retry_backoff_s * (2.0 ** (attempt - 1)))
            obj = dict(obj)
            obj["id"] = req_id
            # the fleet's send-side chaos point: a drill can slow/fail the
            # path to ONE replica (ctx matches on replica/req_id)
            pending.primary_id = rep.id
            inject.chaos_point("fleet.send", replica=rep.id, req_id=req_id)
            tried.add(rep.id)
            try:
                # the send span: child of the trace's root, and (via the
                # thread-local context _http reads) the parent the
                # replica's serve.request span hangs off
                with telemetry.span("router.send", ctx=pending.root_ctx(),
                                    replica=rep.id, attempt=attempt,
                                    id=req_id):
                    status, body = self._http(
                        "POST", rep.base_url, "/scenario", obj,
                        timeout=self.request_timeout_s)
            except Exception as e:
                now = time.monotonic()
                with self._lock:
                    rep.breaker.record(True, now)
                if _transport_kind(e) == "broken":
                    # MAY be admitted + journaled: park — only the WAL
                    # handoff (or the replica's own late answer) may
                    # answer this id, a blind retry could double-execute
                    with self._lock:
                        late = rep.handoff_done
                        if not late:
                            rep.parked[req_id] = (obj, pending)
                            self._stats["parked_total"] += 1
                    if late:
                        # this replica's handoff already drained its
                        # parks: nothing will ever resolve a new one —
                        # run the id on a peer now, marked like a replay
                        self._redispatch_one(rep, req_id, obj, pending)
                    return
                last_retryable = schema.ReplicaLostError(
                    f"replica {rep.id} refused connection"
                ).to_response(req_id)
                continue
            with self._lock:
                rep.breaker.record(False, time.monotonic())
                rep.forwarded += 1
            if status == 429 or status == 503:
                # alive but not taking (queue-full / paused / draining):
                # spread the load, bounded by the retry budget
                last_retryable = body
                continue
            self._answer(pending, body)
            return
        if last_retryable is not None:
            self._answer(pending, last_retryable,
                         log=last_retryable.get("kind") == "replica-lost")
        else:
            self._answer(pending, schema.ReplicaLostError(
                "no live replica available"
            ).to_response(req_id), log=True)

    def _hedge(self, obj: dict, req_id: str, group: str | None,
               pending: RouterPending) -> None:
        """One extra send to a different replica when the primary is
        silent past ``hedge_ms`` — first answer wins, the loser is a
        counted late answer."""
        if pending.done():
            return
        with self._lock:
            self._stats["hedges"] += 1
        telemetry.metrics.counter("blocksim_fleet_hedges_total").inc()
        # a different replica than the silent primary (affinity ignored —
        # the whole point is escaping the preferred replica); when only
        # the primary is routable, _pick's `or cands` fallback still
        # hedges there rather than not at all
        exclude = {pending.primary_id} if pending.primary_id else set()
        rep = self._pick(None, exclude=exclude)
        if rep is None or pending.done():
            return
        obj = dict(obj)
        obj["id"] = req_id
        inject.chaos_point("fleet.send", replica=rep.id, req_id=req_id)
        try:
            with telemetry.span("router.send", ctx=pending.root_ctx(),
                                replica=rep.id, hedge=True, id=req_id):
                status, body = self._http(
                    "POST", rep.base_url, "/scenario",
                    obj, timeout=self.request_timeout_s)
        except Exception:
            return  # the primary (or the handoff) remains responsible
        with self._lock:
            rep.forwarded += 1
        if status in (429, 503):
            return
        body = dict(body)
        body["hedged"] = True
        self._answer(pending, body)

    # --------------------------------------------------------------- probes
    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_interval_s):
            for ep in list(self._endpoints):
                if ep.state == "dead":
                    continue
                proc = getattr(ep.spec, "proc", None)
                reaped = proc is not None and proc.poll() is not None
                reachable = False
                ready = False
                if not reaped:
                    try:
                        status, _ = self._http(
                            "GET", ep.base_url, "/healthz",
                            timeout=self.probe_timeout_s)
                        reachable = True
                        ready = status == 200
                    except Exception:
                        reachable = False
                with self._lock:
                    if reachable:
                        ep.probe_failures = 0
                        ep.ready = ready
                    else:
                        ep.probe_failures += 1
                if reaped or ep.probe_failures >= self.dead_after:
                    self.declare_dead(ep.id)

    def declare_dead(self, replica_id: str) -> bool:
        """Transition one replica up → dead (idempotent) and start its
        WAL handoff in a worker thread.  Public: the prober calls it on
        probe evidence, drills call it directly."""
        with self._lock:
            ep = next((e for e in self._endpoints if e.id == replica_id),
                      None)
            if ep is None or ep.state == "dead":
                return False
            ep.state = "dead"
            ep.ready = False
        t = threading.Thread(target=self._handoff, args=(ep,),
                             name=f"fleet-handoff-{ep.id}", daemon=True)
        with self._lock:
            self._threads.append(t)
        t.start()
        return True

    # -------------------------------------------------------------- handoff
    def _peer_post(self, exclude_id: str):
        """A ``post(obj) -> (status, body)`` over the live peers with the
        router's own retry budget, for fleet.handoff_wal."""
        def post(obj):
            last: Exception | None = None
            tried: set[str] = {exclude_id}
            for attempt in range(self.retries + 1):
                rep = self._pick(None, exclude=tried)
                if rep is None or rep.id == exclude_id:
                    break
                if attempt:
                    # same backoff as _dispatch: a replay must not hammer
                    # a peer that is busy absorbing the dead replica's load
                    time.sleep(self.retry_backoff_s * (2.0 ** (attempt - 1)))
                try:
                    status, body = self._http(
                        "POST", rep.base_url, "/scenario", obj,
                        timeout=self.request_timeout_s)
                except Exception as e:
                    last = e
                    tried.add(rep.id)
                    continue
                with self._lock:
                    rep.forwarded += 1
                if status in (429, 503):
                    tried.add(rep.id)
                    continue
                return status, body
            raise last or schema.ReplicaLostError(
                "no live peer for WAL handoff")
        return post

    def _handoff(self, ep: _Endpoint) -> None:
        """The death path: lease-claim the dead WAL, replay its pending
        ids on a peer (exactly once fleet-wide — serve/fleet.py claim
        rules), resolve parked futures, then re-dispatch parked ids the
        WAL never admitted.  Every outcome is typed and logged."""
        from blockchain_simulator_tpu_torch.serve import fleet

        inject.chaos_point("fleet.handoff", replica=ep.id)
        report: dict = {"replica": ep.id, "wal": ep.wal_path}
        if ep.wal_path:
            def on_answer(rid, body):
                with self._lock:
                    parked = ep.parked.pop(rid, None)
                if parked is not None:
                    self._answer(parked[1], body)
                # no parked future: the id was admitted straight to the
                # dead replica (or predates this router) — the replay is
                # access-logged + done-marked by handoff_wal; it is not
                # an admission of THIS router, so the received/answered
                # balance must not count it
            res = fleet.handoff_wal(
                ep.wal_path, self.owner, self._peer_post(ep.id),
                on_answer=on_answer,
            )
            report.update(res)
            if not res["claimed"]:
                # another router holds the lease: ITS replay is the one
                # true replay; our parked clients get a typed 502 (the
                # at-least-once edge)
                with self._lock:
                    self._stats["handoff_lost"] += 1
        # parked ids the WAL never admitted (or whose done was written but
        # the answer lost): safe — and necessary — to run on a peer now.
        # handoff_done flips under the SAME lock as the drain, so a send
        # that breaks later sees it and self-redispatches (never strands)
        with self._lock:
            ep.handoff_done = True
            leftovers = list(ep.parked.items())
            ep.parked.clear()
        redispatched = []
        for rid, (obj, pending) in leftovers:
            if pending.done():
                continue
            if ep.wal_path and not report.get("claimed"):
                self._answer(pending, schema.ReplicaLostError(
                    f"replica {ep.id} died; its WAL lease is held by "
                    f"{report.get('owner')!r} — the claim holder replays"
                ).to_response(rid), log=True)
                continue
            self._redispatch_one(ep, rid, obj, pending)
            redispatched.append(rid)
        report["redispatched"] = redispatched
        with self._lock:
            self._handoffs.append(report)
        if self.manager is not None and report.get("claimed"):
            try:
                self.manager.restart(ep.id)
                with self._lock:
                    ep.state = "up"
                    ep.ready = True
                    ep.probe_failures = 0
                report["restarted"] = True
            except Exception as e:
                report["restarted"] = f"failed: {type(e).__name__}: {e}"

    def _redispatch_one(self, ep: _Endpoint, rid: str, obj: dict,
                        pending: RouterPending) -> None:
        """Run a parked-but-not-WAL-replayed id on a peer, marked like a
        replay.  Duplicate execution is the sanctioned kind (pure
        (config, seed) functions; the answer-once future dedups the
        client side)."""
        post = self._peer_post(ep.id)
        try:
            _status, body = post(dict(obj))
            body = dict(body)
        except Exception as e:
            body = schema.ReplicaLostError(
                f"re-dispatch after replica death failed: "
                f"{type(e).__name__}: {e}"
            ).to_response(rid)
        body["replayed"] = True
        body["handoff"] = {"wal": None, "owner": self.owner}
        obs.record_run(body, None)
        self._answer(pending, body)

    def join_handoffs(self, n: int = 1, timeout_s: float = 60.0) -> bool:
        """Block until ``n`` handoffs have completed (drills synchronize
        on this before checking invariants)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if len(self._handoffs) >= n:
                    return True
            time.sleep(0.02)
        return False

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._lock:
            return {
                **{k: (dict(v) if isinstance(v, dict) else v)
                   for k, v in self._stats.items()},
                "handoffs": [dict(h) for h in self._handoffs],
                # open-loop fleet latency percentiles (submit -> winning
                # answer) from the telemetry histogram — the satellite
                # peer of the replica-side /stats latency_ms block
                "latency_ms": {"request": self._hist.percentiles()},
                "replicas": {ep.id: ep.snapshot()
                             for ep in self._endpoints},
                "knobs": {
                    "retries": self.retries,
                    "retry_backoff_s": self.retry_backoff_s,
                    "hedge_ms": self.hedge_ms,
                    "probe_interval_s": self.probe_interval_s,
                    "dead_after": self.dead_after,
                    "route": self.route,
                    "owner": self.owner,
                },
            }

    def close(self) -> None:
        self._stop.set()
        if self._prober is not None:
            self._prober.join(timeout=self.probe_timeout_s
                              + self.probe_interval_s + 5.0)
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout=5.0)


# ------------------------------------------------------------- HTTP front


def make_router_httpd(router: FleetRouter, host: str = "127.0.0.1",
                      port: int = 0):
    """The router's HTTP surface, mirroring the single daemon's: POST
    /scenario, GET /stats (fleet-wide), GET /healthz (200 while any
    replica is routable), POST /shutdown."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _send(self, code: int, body: dict) -> None:
            blob = (json.dumps(body) + "\n").encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def do_GET(self):
            if self.path == "/stats":
                self._send(200, router.stats())
            elif self.path == "/metrics":
                telemetry.write_exposition(self)
            elif self.path == "/healthz":
                up = bool(router._pick(None))
                self._send(200 if up else 503, {"ready": up})
            else:
                self._send(404, {"status": "error", "code": 404,
                                 "kind": "not-found", "error": self.path})

        def do_POST(self):
            if self.path == "/scenario":
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                    obj = json.loads(self.rfile.read(length) or b"{}")
                except (ValueError, json.JSONDecodeError):
                    self._send(400, {"status": "error", "code": 400,
                                     "kind": "invalid-request",
                                     "error": "body is not valid JSON"})
                    return
                resp = router.request(obj)
                self._send(resp.get("code", 500), resp)
            elif self.path == "/shutdown":
                self._send(200, {"status": "ok"})
                threading.Thread(target=httpd.shutdown,
                                 daemon=True).start()
            else:
                self._send(404, {"status": "error", "code": 404,
                                 "kind": "not-found", "error": self.path})

    httpd = ThreadingHTTPServer((host, port), Handler)
    return httpd
