"""Host-side telemetry: tracing, metrics, flight recorder, profiling (port of
``blockchain_simulator_tpu/utils/telemetry.py``).

The run manifests (utils/obs.py) record what a *simulation* did; this module
records what the *system around the simulations* did (the scenario server,
its batcher, the sweeps) as four host-side primitives:

- **Request-scoped tracing.**  A :class:`TraceContext` (``trace_id`` +
  ``span_id``) is minted at admission, propagated across processes via the
  ``X-Blocksim-Trace`` HTTP header, and every closed span becomes one JSON
  record: into the in-process flight recorder always, and into the span log
  (``$BLOCKSIM_SPANS_JSONL``, the rotating utils/obs.py writer) when armed.
  The serving span model: ``serve.request`` → {``serve.admit``,
  ``serve.queue_wait``, ``serve.batch_wait``, ``serve.dispatch`` (pad-bucket
  attrs), ``serve.answer``}; the segments tile the request's wall clock.
  :func:`spans_to_chrome_trace` exports spans (and, via
  utils/trace.chrome_events, a sim probe series) onto one Chrome-trace
  timeline.
- **Metrics registry.**  Thread-safe counters, gauges and fixed-bucket
  histograms (:data:`metrics`), exposed as Prometheus text (``GET /metrics``
  on the serve daemon) and as a compact block on the run manifest
  (utils/obs.py).  Names, label sets and buckets are the JAX package's, so
  one dashboard reads either package.
- **Flight recorder.**  A bounded in-memory ring of recent spans and events
  (:data:`flight`), dumped atomically to an ``ARTIFACT``-style JSON on
  shutdown or crash when ``$BLOCKSIM_FLIGHT_DIR`` names a directory.
- **Profiling hooks.**  ``BLOCKSIM_PROFILE=<dir>`` arms
  :func:`profile_region`: a ``torch.profiler`` capture (CPU and CUDA
  activity) around dispatch flushes (serve/dispatch.py) and batched sweep
  dispatches (parallel/sweep.py), exported as a Chrome trace.  Disarmed it
  is one dict read and a predicted branch.

Every call into this module is host-side: spans and counters wrap whole
dispatches, never the step functions (a span's clock reads would order
against nothing on the card).  Models and ops never import this module.

Telemetry must never take down the thing it observes: every file write
is swallowed on failure, and :func:`FlightRecorder.dump` with no armed
directory is a no-op returning ``None``.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
import uuid

from blockchain_simulator_tpu_torch.utils import obs

# HTTP propagation header: "<trace_id>:<span_id>" (the sender's span
# becomes the receiver's parent).
TRACE_HEADER = "X-Blocksim-Trace"

# Span log path (JSONL via the rotating obs.append_jsonl writer); unset =
# spans stay in the flight-recorder ring only.
SPANS_ENV = "BLOCKSIM_SPANS_JSONL"

# Flight-recorder dump directory; unset = dumps are no-ops.
FLIGHT_ENV = "BLOCKSIM_FLIGHT_DIR"
# retention: newest K ARTIFACT_flight_*.json kept per dump directory
# (default 32; 0 disables pruning) — the flight-dir analog of the
# obs.append_jsonl size-capped rotation: post-mortems are rolling
# observability artifacts, and a long chaos drill or a violation storm
# must not fill the disk with them
FLIGHT_KEEP_ENV = "BLOCKSIM_FLIGHT_KEEP"
FLIGHT_KEEP_DEFAULT = 32

# torch.profiler capture directory; unset = profile_region is free.
PROFILE_ENV = "BLOCKSIM_PROFILE"

TELEMETRY_SCHEMA = 1

# monotonic -> wall mapping, fixed at import: code paths stamp
# time.monotonic() (the clock the serving stack already uses) and spans
# publish wall-clock starts so cross-process timelines align.
_EPOCH = time.time() - time.monotonic()


def new_trace_id() -> str:
    """16 hex chars, unique per admission/chunk (uuid4-derived)."""
    return uuid.uuid4().hex[:16]


def new_span_id() -> str:
    """8 hex chars, unique within a trace."""
    return uuid.uuid4().hex[:8]


class TraceContext:
    """One (trace_id, span_id) point in a trace: the identity a child
    span parents to, and the value the ``X-Blocksim-Trace`` header
    carries across processes."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = str(trace_id)
        self.span_id = str(span_id)

    def header(self) -> str:
        return f"{self.trace_id}:{self.span_id}"

    def __eq__(self, other):
        return (isinstance(other, TraceContext)
                and other.trace_id == self.trace_id
                and other.span_id == self.span_id)

    def __repr__(self):
        return f"TraceContext({self.trace_id}:{self.span_id})"


def parse_header(value) -> TraceContext | None:
    """Parse a ``X-Blocksim-Trace`` header value; garbage (missing,
    malformed, empty ids) reads as None — a bad header must never reject
    a request."""
    if not isinstance(value, str) or ":" not in value:
        return None
    tid, _, sid = value.partition(":")
    tid, sid = tid.strip(), sid.strip()
    if not tid or not sid or not all(
            c in "0123456789abcdef" for c in (tid + sid).lower()):
        return None
    return TraceContext(tid, sid)


# ------------------------------------------------------------ span sinks ---

_tls = threading.local()
# extra span sinks (callables taking one span record): tests and the
# report tool install capture buffers here; the flight recorder is NOT a
# sink — it is unconditional.
_sinks: list = []
_sinks_lock = threading.Lock()


def current() -> TraceContext | None:
    """The calling thread's active trace context (set by :func:`span` /
    :func:`context`), or None."""
    return getattr(_tls, "ctx", None)


@contextlib.contextmanager
def context(ctx: TraceContext | None):
    """Install ``ctx`` as the thread's current trace context without
    opening a span — the HTTP handlers' header-extraction shim."""
    prev = current()
    _tls.ctx = ctx
    try:
        yield ctx
    finally:
        _tls.ctx = prev


@contextlib.contextmanager
def capture():
    """Collect every span emitted (process-wide) during the block —
    drills and tests read the list after."""
    buf: list[dict] = []
    with _sinks_lock:
        _sinks.append(buf.append)
    try:
        yield buf
    finally:
        with _sinks_lock:
            try:
                _sinks.remove(buf.append)
            except ValueError:
                pass


def emit(name: str, t0: float, t1: float | None = None,
         trace: str | None = None, parent: str | None = None,
         span_id: str | None = None, status: str = "ok", **attrs) -> str:
    """Record one closed span from explicit ``time.monotonic()`` stamps —
    the request-lifecycle synthesizer (serve/server.py builds a request's
    whole segment tree at answer time from stamps, because the segments
    straddle threads).  Returns the span id so callers can parent
    children to it.  Emission goes to the flight-recorder ring, any
    installed capture sinks, and the span log when armed."""
    t1 = time.monotonic() if t1 is None else t1
    sid = span_id or new_span_id()
    rec = {
        "kind": "span",
        "name": str(name),
        "trace": trace or new_trace_id(),
        "id": sid,
        "parent": parent,
        "ts": round(t0 + _EPOCH, 6),
        "dur_ms": round(max(t1 - t0, 0.0) * 1000.0, 3),
        "pid": os.getpid(),
        "status": str(status),
    }
    if attrs:
        rec["attrs"] = {k: v for k, v in attrs.items() if v is not None}
    flight.record(rec)
    with _sinks_lock:
        sinks = list(_sinks)
    for sink in sinks:
        try:
            sink(rec)
        except Exception:
            pass  # a broken sink must never break the emitting code path
    path = os.environ.get(SPANS_ENV)
    if path:
        obs.append_jsonl(rec, path)
    return sid


@contextlib.contextmanager
def span(name: str, ctx: TraceContext | None = None, **attrs):
    """Open/close one span around a block: child of ``ctx`` (or the
    thread's current context; a fresh trace when neither exists), set as
    the thread's current context inside the block — so nested spans and
    outbound HTTP headers pick it up.  An
    escaping exception marks ``status="error"`` and re-raises.  Yields
    the span's own :class:`TraceContext`."""
    parent = ctx if ctx is not None else current()
    tid = parent.trace_id if parent is not None else new_trace_id()
    sid = new_span_id()
    mine = TraceContext(tid, sid)
    prev = current()
    _tls.ctx = mine
    t0 = time.monotonic()
    status = "ok"
    try:
        yield mine
    except BaseException:
        status = "error"
        raise
    finally:
        _tls.ctx = prev
        emit(name, t0, time.monotonic(), trace=tid,
             parent=parent.span_id if parent is not None else None,
             span_id=sid, status=status, **attrs)


# --------------------------------------------------------------- metrics ---

# Fixed latency buckets (ms): wide enough for a sub-ms solo dispatch and
# a multi-second cold compile; fixed so two processes' histograms merge.
DEFAULT_MS_BUCKETS = (
    1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0,
)


class Counter:
    """Monotone counter.  All mutation under the registry lock the
    instrument was created with (instrument methods are the hot path:
    one lock, one add)."""

    __slots__ = ("name", "labels", "_lock", "value")

    def __init__(self, name: str, labels: dict, lock: threading.Lock):
        self.name = name
        self.labels = labels
        self._lock = lock
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-write-wins gauge."""

    __slots__ = ("name", "labels", "_lock", "value")

    def __init__(self, name: str, labels: dict, lock: threading.Lock):
        self.name = name
        self.labels = labels
        self._lock = lock
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)


class Histogram:
    """Fixed-bucket histogram (cumulative exposition, Prometheus-style).

    ``bounds`` are upper bucket edges; an implicit +Inf bucket catches
    the tail.  :meth:`percentile` answers at bucket resolution — the
    upper edge of the bucket the nearest-rank observation fell in,
    capped at the maximum observed value (so the +Inf bucket reports a
    real number).  Good enough for the ``/stats`` p50/p95/p99 blocks;
    exact percentiles stay obs.percentile over raw samples where callers
    keep them."""

    __slots__ = ("name", "labels", "bounds", "_lock", "counts", "sum",
                 "count", "_max")

    def __init__(self, name: str, labels: dict, lock: threading.Lock,
                 bounds=DEFAULT_MS_BUCKETS):
        self.name = name
        self.labels = labels
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError("histogram bounds must be sorted ascending")
        self._lock = lock
        self.counts = [0] * (len(self.bounds) + 1)  # [+Inf] last
        self.sum = 0.0
        self.count = 0
        self._max = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        i = 0
        for b in self.bounds:
            if v <= b:
                break
            i += 1
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1
            if v > self._max:
                self._max = v

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile at bucket resolution (0.0 when
        empty)."""
        with self._lock:
            total = self.count
            counts = list(self.counts)
            vmax = self._max
        if total == 0:
            return 0.0
        rank = max(1, int(round(q / 100.0 * total)))
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= rank:
                edge = self.bounds[i] if i < len(self.bounds) else vmax
                return round(min(edge, vmax), 3)
        return round(vmax, 3)

    def percentiles(self, qs=(50.0, 95.0, 99.0)) -> dict:
        return {f"p{int(q)}": self.percentile(q) for q in qs}


def _label_str(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return "{" + inner + "}"


class MetricsRegistry:
    """Get-or-create registry of instruments keyed on (name, labels).

    One process-global instance (:data:`metrics`) backs ``/metrics`` on
    every HTTP surface; tests and per-server ``/stats`` percentiles use
    private :class:`Histogram` instances instead, so N servers in one
    process do not blur each other's latency."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict = {}

    def _get(self, cls, name: str, labels: dict, **kw):
        key = (cls.__name__, name, tuple(sorted(labels.items())))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(name, dict(labels), self._lock, **kw)
                self._instruments[key] = inst
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, bounds=DEFAULT_MS_BUCKETS,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, bounds=bounds)

    def reset(self) -> None:
        """Drop every instrument — scenario/test isolation (the drills
        bracket runs with snapshots instead; see chaos/invariants.py
        check_telemetry)."""
        with self._lock:
            self._instruments = {}

    # ------------------------------------------------------- exposition ---
    def exposition(self) -> str:
        """Prometheus text format v0.0.4 — the ``GET /metrics`` body."""
        lines: list[str] = []
        with self._lock:
            instruments = list(self._instruments.values())
        typed: set[str] = set()
        for inst in sorted(instruments, key=lambda i: i.name):
            kind = type(inst).__name__.lower()
            if inst.name not in typed:
                lines.append(f"# TYPE {inst.name} {kind}")
                typed.add(inst.name)
            ls = _label_str(inst.labels)
            if isinstance(inst, Histogram):
                cum = 0
                for b, c in zip(inst.bounds, inst.counts):
                    cum += c
                    lb = dict(inst.labels, le=f"{b:g}")
                    lines.append(f"{inst.name}_bucket{_label_str(lb)} {cum}")
                cum += inst.counts[-1]
                lb = dict(inst.labels, le="+Inf")
                lines.append(f"{inst.name}_bucket{_label_str(lb)} {cum}")
                lines.append(f"{inst.name}_sum{ls} {inst.sum:g}")
                lines.append(f"{inst.name}_count{ls} {inst.count}")
            else:
                lines.append(f"{inst.name}{ls} {inst.value:g}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """Compact JSON-able view: counters/gauges by ``name{labels}``,
        histograms as {count, sum, p50, p95, p99} — the flight-recorder
        dump and ARTIFACT_telemetry.json payload, and the delta source
        for chaos/invariants.check_telemetry."""
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            instruments = list(self._instruments.values())
        for inst in instruments:
            key = inst.name + _label_str(inst.labels)
            if isinstance(inst, Counter):
                out["counters"][key] = inst.value
            elif isinstance(inst, Gauge):
                out["gauges"][key] = inst.value
            else:
                out["histograms"][key] = {
                    "count": inst.count, "sum": round(inst.sum, 3),
                    **inst.percentiles(),
                }
        return out

    def manifest(self) -> dict:
        """The tiny provenance block obs.manifest attaches to runs.jsonl
        lines when telemetry has instruments: counter totals only (the
        full snapshot would bloat every access-log line)."""
        with self._lock:
            instruments = list(self._instruments.values())
        counters = {
            inst.name + _label_str(inst.labels): inst.value
            for inst in instruments if isinstance(inst, Counter)
        }
        return {"counters": counters, "spans": flight.spans_recorded}


metrics = MetricsRegistry()


def write_exposition(handler) -> None:
    """Serve the ``GET /metrics`` body on a BaseHTTPRequestHandler — the
    one Prometheus endpoint implementation both HTTP surfaces share
    (the serve/__main__.py daemon, and the fleet router when it is ported)."""
    blob = metrics.exposition().encode()
    handler.send_response(200)
    handler.send_header("Content-Type", "text/plain; version=0.0.4")
    handler.send_header("Content-Length", str(len(blob)))
    handler.end_headers()
    handler.wfile.write(blob)


# -------------------------------------------------------- flight recorder ---


class FlightRecorder:
    """Bounded ring of the most recent spans/events in this process.

    Always on (a ring append is two list ops under a lock); the *file*
    side is armed by ``$BLOCKSIM_FLIGHT_DIR`` — :meth:`dump` writes one
    atomic ``ARTIFACT``-style JSON (tmp + ``os.replace``) named after its
    trigger, so a crash, a chaos invariant violation, a supervisor
    degrade, or a shutdown each leave a self-describing post-mortem.
    Dump failures are swallowed: the recorder must never take down the
    process it is recording."""

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._ring: list[dict] = []
        self._next = 0
        self.spans_recorded = 0
        self.dumps = 0
        self._dump_seq = itertools.count(1)

    def record(self, rec: dict) -> None:
        with self._lock:
            if len(self._ring) < self.capacity:
                self._ring.append(rec)
            else:
                self._ring[self._next % self.capacity] = rec
            self._next += 1
            if rec.get("kind") == "span":
                self.spans_recorded += 1

    def note(self, event: str, **fields) -> None:
        """Record one non-span event (supervisor transitions, chaos
        verdicts, lifecycle marks)."""
        self.record({"kind": "event", "event": str(event),
                     "ts": round(time.time(), 6), "pid": os.getpid(),
                     **fields})

    def snapshot(self) -> list[dict]:
        """Ring contents, oldest first."""
        with self._lock:
            if len(self._ring) < self.capacity:
                return list(self._ring)
            i = self._next % self.capacity
            return self._ring[i:] + self._ring[:i]

    def reset(self) -> None:
        with self._lock:
            self._ring = []
            self._next = 0
            self.spans_recorded = 0

    def dump(self, reason: str, path: str | None = None) -> str | None:
        """Write the post-mortem; returns the path, or None when neither
        ``path`` nor ``$BLOCKSIM_FLIGHT_DIR`` is set (disarmed) or the
        write failed (swallowed)."""
        if path is None:
            d = os.environ.get(FLIGHT_ENV)
            if not d:
                return None
            # sequence number: repeated same-reason triggers in one
            # process (a drill's scenarios, a long sweep's degrades)
            # each keep their own post-mortem instead of overwriting
            path = os.path.join(
                d, f"ARTIFACT_flight_{reason}_{os.getpid()}"
                   f"_{next(self._dump_seq)}.json")
        doc = {
            "telemetry_schema": TELEMETRY_SCHEMA,
            "reason": str(reason),
            "ts": round(time.time(), 3),
            "pid": os.getpid(),
            "records": self.snapshot(),
            "metrics": metrics.snapshot(),
        }
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(doc, f, default=str)
                f.write("\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None
        self._prune(os.path.dirname(path) or ".")
        with self._lock:
            self.dumps += 1
        return path

    @staticmethod
    def _prune(d: str) -> None:
        """Keep only the newest ``$BLOCKSIM_FLIGHT_KEEP`` (default 32)
        ``ARTIFACT_flight_*.json`` post-mortems in ``d``; 0 disables.
        Runs after every successful dump; failures are swallowed like the
        dump's own (the recorder never takes down its process)."""
        try:
            keep = int(os.environ.get(FLIGHT_KEEP_ENV, FLIGHT_KEEP_DEFAULT))
        except ValueError:
            keep = FLIGHT_KEEP_DEFAULT
        if keep <= 0:
            return
        try:
            names = [n for n in os.listdir(d)
                     if n.startswith("ARTIFACT_flight_")
                     and n.endswith(".json")]
            if len(names) <= keep:
                return
            paths = [os.path.join(d, n) for n in names]
            # (mtime, name): stable order for same-second bursts
            paths.sort(key=lambda p: (os.path.getmtime(p), p))
            for p in paths[:-keep]:
                os.unlink(p)
        except OSError:
            pass


flight = FlightRecorder()


def install_crash_dump() -> None:
    """Chain a flight-recorder dump onto ``sys.excepthook`` AND
    ``threading.excepthook`` — the daemon entrypoints call this once so
    an unhandled exception leaves a post-mortem before the traceback.
    The threading hook matters more: the daemon's crash surface is its
    worker threads (HTTP handlers, the batcher), not the main thread
    blocking in serve_forever.  (kill -9 has no hook; the WAL carries that
    case.)"""
    import sys
    import threading as _threading

    prev = sys.excepthook

    def hook(exc_type, exc, tb):
        try:
            flight.note("crash", error=f"{exc_type.__name__}: {exc}"[:500])
            flight.dump("crash")
        finally:
            prev(exc_type, exc, tb)

    sys.excepthook = hook
    prev_t = _threading.excepthook

    def thread_hook(args):
        try:
            flight.note(
                "crash",
                thread=getattr(args.thread, "name", None),
                error=f"{args.exc_type.__name__}: {args.exc_value}"[:500],
            )
            flight.dump("crash")
        finally:
            prev_t(args)

    _threading.excepthook = thread_hook


def reset() -> None:
    """Fresh metrics + flight ring (test/drill isolation).  Does not
    touch installed sinks or thread-local contexts."""
    metrics.reset()
    flight.reset()


# -------------------------------------------------------------- profiling ---

_profile_seq = itertools.count()
_profile_active = threading.local()


PROFILE_TRACE = "trace.json"  # the exported Chrome trace, inside a region's directory


@contextlib.contextmanager
def profile_region(name: str):
    """``torch.profiler`` capture around one host-side region (a dispatch
    flush, a batched sweep dispatch) into ``$BLOCKSIM_PROFILE/<name>-<k>/
    trace.json``.

    Disarmed (env unset, the only state tests and serving see unless an
    operator arms it): one dict read.  Armed: CPU activity, and the card's
    when CUDA is available, one directory per region instance, viewable in
    ui.perfetto.dev.  The trace is exported as it is: the profiler's
    per-op tables (``key_averages``) are never built, since they cost
    several times the region at a thousand launches a tick.  Nested regions
    (a serve flush around the sweep dispatch it routes to) skip the inner
    capture: one profiler runs at a time.  Profiler failures are swallowed:
    profiling must never take down the dispatch it measures.
    """
    d = os.environ.get(PROFILE_ENV)
    if not d or getattr(_profile_active, "on", False):
        yield
        return
    logdir = os.path.join(d, f"{name}-{next(_profile_seq)}")
    try:
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    except Exception:
        yield
        return
    _profile_active.on = True
    try:
        yield
    finally:
        _profile_active.on = False
        try:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()  # the region's kernels end inside the capture
            prof.__exit__(None, None, None)
            os.makedirs(logdir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(logdir, PROFILE_TRACE))
        except Exception:
            pass  # a failing profiler must never take down the dispatch


# ----------------------------------------------------------- trace export ---


def spans_to_chrome_trace(spans, path, series: dict | None = None,
                          name: str = "telemetry") -> dict:
    """Export span records (+ optionally one sim probe series) as a
    single Chrome-trace/Perfetto JSON timeline.

    Spans become complete events ("ph": "X") grouped one thread row per
    trace (so a request's segment tree reads left-to-right on its own
    row), timestamped on the shared wall clock.  ``series`` (a
    utils/trace.py probe series dict) is overlaid through
    ``trace.chrome_events`` as counter tracks in a second process — the
    "serving spans and sim probe series on ONE timeline" recipe (README
    "Telemetry").  Returns ``{"events", "path"}``."""
    events: list[dict] = [
        {"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
         "args": {"name": name}},
    ]
    tids: dict[str, int] = {}
    for rec in spans:
        if rec.get("kind") != "span":
            continue
        trace_id = str(rec.get("trace"))
        tid = tids.get(trace_id)
        if tid is None:
            tid = tids[trace_id] = len(tids) + 1
            events.append({
                "name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                "args": {"name": f"trace {trace_id}"},
            })
        args = dict(rec.get("attrs") or {})
        args["span_id"] = rec.get("id")
        if rec.get("parent"):
            args["parent"] = rec.get("parent")
        if rec.get("status") != "ok":
            args["status"] = rec.get("status")
        events.append({
            "name": rec.get("name"), "ph": "X", "pid": 1, "tid": tid,
            "ts": int(float(rec.get("ts", 0.0)) * 1e6),
            "dur": max(int(float(rec.get("dur_ms", 0.0)) * 1000.0), 1),
            "args": args,
        })
    if series is not None:
        from blockchain_simulator_tpu_torch.utils import trace as trace_mod

        events.extend(trace_mod.chrome_events(series, name="sim", pid=0))
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    with open(path, "w") as f:
        json.dump(doc, f)
    return {"events": len(events), "path": str(path)}
