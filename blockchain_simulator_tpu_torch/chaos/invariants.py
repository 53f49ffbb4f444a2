"""The accounting contracts a chaos scenario must not break (port of
``blockchain_simulator_tpu/chaos/invariants.py``; host code, the JAX
package's checks and wording).

The serving stack's promise (serve/server.py) is *no silent drop*: every
request that enters ``submit`` leaves through exactly one typed door —
a success response, a typed rejection, or (after a crash) a WAL replay —
and every door writes an access-log line.  Faults are allowed to change
WHICH door; they are never allowed to lose a request or a line.  This
module turns that promise into a checkable function the drills
(chaos/scenarios.py, chaos/fleet_scenarios.py) and the tests run after
every scenario:

1. **No request unaccounted** — each submitted request id observed
   exactly one terminal outcome client-side, and the server's own
   counters balance: ``received + replayed == served + errors + timeouts
   + Σ rejected`` with the queue drained (``queue_depth == 0``).
2. **No lost manifest lines** — every terminal outcome (including each
   replayed request) has at least one runs.jsonl record carrying its id.
3. **Registry stats monotone** — executable-registry counters
   (hits/misses/evictions/disk_*/corrupt_healed) never decrease across
   the scenario: a fault may add misses or heals, it may not rewind
   history.

Violations are returned as human-readable strings (empty list = clean);
a drill sums them into its invariant-violation count.
"""

from __future__ import annotations

from blockchain_simulator_tpu_torch.utils import obs

# Counters that must never decrease across a scenario (invariant 3).
MONOTONE_KEYS = (
    "hits", "misses", "evictions", "disk_hits", "disk_misses",
    "disk_saves", "disk_errors", "corrupt_healed",
)

# Span attrs that are deterministic under a scripted scenario and so may
# ride the normalized span tree (everything else — durations, batch
# occupancy/bucket/mode, retry attempt counts — is timing-shaped and
# excluded, the same rule the scenario summaries apply to stats).
_SPAN_NORM_ATTRS = ("id", "outcome", "replayed", "replay", "hedge")


def normalize_spans(spans) -> list[str]:
    """Timing-free span-tree summary (utils/telemetry.py records): one
    sorted string per *serving* span — its root-to-leaf name path plus
    the deterministic attrs — so two same-seed scenario runs must
    produce byte-equal lists (the drill's determinism gate covers span
    trees).

    ``sweep.*`` spans are excluded: a deadline-abandoned chunk attempt
    closes its span whenever the abandoned thread finishes, which can
    land inside one run's capture window and outside the other's — the
    journal's ``event`` lines are that trail's deterministic record."""
    by_id: dict[tuple, dict] = {}
    recs = []
    for rec in spans:
        if rec.get("kind") != "span":
            continue
        name = str(rec.get("name"))
        if name.startswith("sweep."):
            continue
        by_id[(rec.get("trace"), rec.get("id"))] = rec
        recs.append(rec)
    out = []
    for rec in recs:
        path = [str(rec.get("name"))]
        seen = {rec.get("id")}
        parent = by_id.get((rec.get("trace"), rec.get("parent")))
        while parent is not None and parent.get("id") not in seen:
            path.append(str(parent.get("name")))
            seen.add(parent.get("id"))
            parent = by_id.get((parent.get("trace"), parent.get("parent")))
        attrs = rec.get("attrs") or {}
        kept = ";".join(
            f"{k}={attrs[k]}" for k in _SPAN_NORM_ATTRS if k in attrs
        )
        out.append("/".join(reversed(path))
                   + f"[{kept}]" + f"~{rec.get('status')}")
    return sorted(out)


def _counter_sum(snapshot: dict, name: str) -> float:
    """Sum a counter family (bare name + every label set) out of a
    telemetry.metrics.snapshot()."""
    total = 0.0
    for key, v in (snapshot.get("counters") or {}).items():
        if key == name or key.startswith(name + "{"):
            total += v
    return total


def check_telemetry(before: dict, after: dict,
                    lost_admissions: int = 0) -> list[str]:
    """The metrics-registry accounting contract (utils/telemetry.py),
    on two ``telemetry.metrics.snapshot()`` brackets of a scenario:

    1. **Conservation** — the serve counter deltas balance exactly like
       the Ledger: ``received + replayed == answered + rejected`` (every
       admission the scenario's servers saw left through a counted
       door).  ``lost_admissions`` is the crash allowance: a scenario
       that kills a server with admitted-but-unanswered requests
       declares exactly how many admissions died with it (their WAL
       replays re-enter through the ``replayed`` counter) — the balance
       must then be off by exactly that many, no more, no fewer.
    2. **Monotone** — no counter delta is negative (telemetry counters
       never rewind, the registry-stats rule applied to telemetry).
    """
    violations: list[str] = []
    deltas = {}
    for name in ("blocksim_serve_received_total",
                 "blocksim_serve_replayed_total",
                 "blocksim_serve_answered_total",
                 "blocksim_serve_rejected_total"):
        deltas[name] = _counter_sum(after, name) - _counter_sum(before, name)
        if deltas[name] < 0:
            violations.append(
                f"telemetry counter {name!r} ran backwards "
                f"(delta {deltas[name]})")
    entered = (deltas["blocksim_serve_received_total"]
               + deltas["blocksim_serve_replayed_total"])
    left = (deltas["blocksim_serve_answered_total"]
            + deltas["blocksim_serve_rejected_total"])
    if entered != left + lost_admissions:
        violations.append(
            f"telemetry counters do not reconcile: received+replayed="
            f"{entered} but answered+rejected={left} with "
            f"{lost_admissions} declared crash-lost admissions "
            f"(deltas: {deltas})")
    return violations


class Ledger:
    """Client-side record of every submission a scenario made: one
    *attempt* per ``submitted()`` call (the same id may legitimately be
    submitted twice — a client retry, or a poison resubmission), one
    terminal outcome filled per attempt as responses land.  The checker
    demands exactly one outcome per attempt — zero means a lost request,
    two means a double answer."""

    def __init__(self):
        # id -> one outcome list per submission attempt, oldest first
        self.attempts: dict[str, list[list[str]]] = {}

    def submitted(self, req_id: str) -> None:
        self.attempts.setdefault(str(req_id), []).append([])

    def record(self, req_id: str, response: dict) -> None:
        """Record the uniform response body (ok or typed error) against
        the oldest still-unanswered attempt of this id; a surplus answer
        piles onto the newest attempt, which the checker flags."""
        kind = "ok" if response.get("status") == "ok" \
            else str(response.get("kind"))
        slots = self.attempts.setdefault(str(req_id), [[]])
        for slot in slots:
            if not slot:
                slot.append(kind)
                return
        slots[-1].append(kind)

    def record_error(self, req_id: str, err: Exception) -> None:
        """Record a typed ServeError raised by ``submit``."""
        self.record(str(req_id), {
            "status": "error", "kind": getattr(err, "kind", "internal-error"),
        })

    def kinds(self) -> dict[str, list[str]]:
        """id -> outcome kinds across attempts in submission order, for
        the drill's determinism comparison."""
        return {
            k: [kind for slot in v for kind in slot]
            for k, v in sorted(self.attempts.items())
        }


def registry_monotone(before: dict, after: dict) -> list[str]:
    """Invariant 3 on two aotcache stats snapshots."""
    violations = []
    for key in MONOTONE_KEYS:
        b, a = before.get(key, 0) or 0, after.get(key, 0) or 0
        if a < b:
            violations.append(
                f"registry counter {key!r} ran backwards: {b} -> {a}"
            )
    return violations


def _stats_balance(stats: dict) -> list[str]:
    """Invariant 1, server side: the terminal counters cover every
    admission (fresh and replayed) with nothing left in the queue."""
    violations = []
    depth = stats.get("queue_depth", 0)
    if depth != 0:
        violations.append(f"queue_depth {depth} != 0 after quiescence")
    entered = stats.get("received", 0) + stats.get("replayed", 0)
    left = (
        stats.get("served", 0) + stats.get("errors", 0)
        + stats.get("timeouts", 0)
        + sum((stats.get("rejected") or {}).values())
    )
    if entered != left:
        violations.append(
            f"request accounting broken: received+replayed={entered} but "
            f"served+errors+timeouts+rejected={left} "
            f"(stats: { {k: stats.get(k) for k in ('received', 'replayed', 'served', 'errors', 'timeouts', 'rejected')} })"
        )
    return violations


def ledger_complete(ledger: Ledger) -> list[str]:
    """Invariant 1, client side: exactly one terminal outcome per
    submission attempt — zero is a lost request, two is a double answer
    (shared by :func:`check_server` and :func:`check_fleet`)."""
    violations = []
    for req_id, attempts in ledger.attempts.items():
        for i, slot in enumerate(attempts):
            if len(slot) != 1:
                violations.append(
                    f"request {req_id!r} attempt {i} has {len(slot)} "
                    f"terminal outcomes {slot} (exactly one required)"
                )
    return violations


def check_fleet(
    ledger: Ledger | None,
    router_stats: dict,
    log_path=None,
    handoff_ids=(),
) -> list[str]:
    """The fleet-wide accounting contracts (serve/router.py + fleet.py):

    1. **Exactly one terminal outcome per admission** — client-side
       (ledger) and router-side: every received request is answered
       exactly once (``received == Σ answered``; late duplicate answers
       are *dropped*, counted in ``late_answers``, never delivered).
    2. **Handoff exactly once fleet-wide** — each dead-WAL id appears in
       exactly ONE completed handoff's replay set, and (``log_path``)
       has exactly ONE access-log line marked ``"replayed": true`` — no
       id is replayed twice, none is lost.
    3. **Claims are exclusive** — no WAL reports more than one claiming
       handoff (the lease rule serve/fleet.py enforces on disk).
    """
    violations: list[str] = []
    if ledger is not None:
        violations += ledger_complete(ledger)
    received = router_stats.get("received", 0)
    answered = sum((router_stats.get("answered") or {}).values())
    if received != answered:
        violations.append(
            f"router accounting broken: received={received} but "
            f"answered={answered} ({router_stats.get('answered')})"
        )
    handoffs = router_stats.get("handoffs") or []
    replay_counts: dict[str, int] = {}
    claims_by_wal: dict[str, int] = {}
    for h in handoffs:
        if h.get("claimed"):
            wal = str(h.get("wal"))
            claims_by_wal[wal] = claims_by_wal.get(wal, 0) + 1
        for rid in list(h.get("replayed") or []) \
                + list(h.get("redispatched") or []):
            replay_counts[str(rid)] = replay_counts.get(str(rid), 0) + 1
    for wal, n in claims_by_wal.items():
        if n > 1:
            violations.append(
                f"WAL {wal!r} claimed by {n} handoffs (lease must win "
                f"exactly once)")
    for rid, n in replay_counts.items():
        if n > 1:
            violations.append(
                f"id {rid!r} replayed {n} times across handoffs")
    for rid in handoff_ids:
        if replay_counts.get(str(rid), 0) != 1:
            violations.append(
                f"handoff id {rid!r} replayed "
                f"{replay_counts.get(str(rid), 0)} times (want exactly 1)")
    if log_path is not None:
        recs = obs.read_jsonl(log_path)
        for rid in handoff_ids:
            marked = sum(1 for r in recs
                         if str(r.get("id")) == str(rid)
                         and r.get("replayed") is True)
            if marked != 1:
                violations.append(
                    f"handoff id {rid!r} has {marked} replayed-marked "
                    f"access-log lines (want exactly 1)")
    return violations


def check_sweep_journal(
    journal,
    expected_keys=(),
    expected_rows: int | None = None,
) -> list[str]:
    """The durable-sweep accounting contracts (parallel/journal.py):

    1. **Each chunk key journaled at most once** — completed chunks are
       skipped on resume, so a second valid line for one key means a
       completed chunk was recomputed (the recompute-at-most-one rule
       broken) or double-appended.
    2. **Every journaled row checksums clean** — a chunk line whose rows
       fail their checksums is bit rot or a torn write that PARSED; the
       reader already demotes it to recompute, the checker reports it.
    3. **Coverage** — every ``expected_keys`` chunk is present and valid,
       and (``expected_rows``) the valid chunks carry that many rows
       total.
    4. **Events well-formed** — every supervisor event line names a known
       transition, so the degrade trail is machine-readable.
    """
    from blockchain_simulator_tpu_torch.parallel import journal as journal_mod

    violations: list[str] = []
    lines = journal.chunk_lines()
    seen: dict[str, int] = {}
    for rec in lines:
        key = str(rec.get("key"))
        seen[key] = seen.get(key, 0) + 1
        rows, sums = rec.get("rows"), rec.get("sums")
        if not isinstance(rows, list) or not isinstance(sums, list) \
                or len(rows) != len(sums):
            violations.append(f"chunk {key!r} line is malformed")
            continue
        bad = sum(1 for r, s in zip(rows, sums)
                  if journal_mod.row_checksum(r) != s)
        if bad:
            violations.append(
                f"chunk {key!r} has {bad}/{len(rows)} rows failing their "
                f"checksum")
    for key, n in seen.items():
        if n > 1:
            violations.append(
                f"chunk {key!r} journaled {n} times (completed chunks "
                f"must never recompute)")
    done = journal.completed()
    for key in expected_keys:
        if str(key) not in done:
            violations.append(f"expected chunk {key!r} missing/invalid")
    if expected_rows is not None:
        total = sum(len(rows) for rows in done.values())
        if total != expected_rows:
            violations.append(
                f"journal carries {total} valid rows, expected "
                f"{expected_rows}")
    known = {"deadline", "probe", "retry", "degrade", "failed", "error"}
    for ev in journal.events():
        if ev.get("event") not in known:
            violations.append(f"unknown supervisor event {ev.get('event')!r}")
    return violations


def check_query_trail(result: dict, journal=None,
                      expect_monotone: bool = True) -> list[str]:
    """The adaptive-query accounting contracts (query/engine.py):

    1. **Trail well-formed** — steps numbered consecutively from 0, one
       verdict per probed value, and no value ever evaluated twice (the
       memoization rule: a refinement loop that re-probes a value is
       wasting dispatches or disagreeing with itself).
    2. **Points complete** — the evaluation trail carries exactly one
       metrics row per (probed value, seed).
    3. **Answer consistent** — the reported boundary agrees with the
       recorded verdicts: the surviving side really passed, the failing
       side really failed, and a fully-narrowed bracket is exactly one
       step wide.
    4. **Key hygiene** — every chunk key ends in its step's ``+q<step>``
       suffix (parallel/journal.query_key_suffix), so query chunks can
       never collide with grid (pure hex) or probe (``+p``) chunks; with
       ``journal`` given, every trail key is present and valid there
       (run :func:`check_sweep_journal` separately for the journal-side
       duplicate/checksum rules).
    5. **Monotone** (``expect_monotone``) — the search observed no
       verdict ordered against the monotone-predicate assumption
       (relax it for a search known to be non-monotone).
    """
    violations: list[str] = []
    trail = result.get("trail")
    if not isinstance(trail, list) or not trail:
        return [f"query trail missing/empty: {type(trail).__name__}"]
    query = result.get("query") or {}
    answer = result.get("answer") or {}
    seeds = list(query.get("seeds") or [])
    verdicts: dict[int, bool] = {}
    for i, step in enumerate(trail):
        if step.get("step") != i:
            violations.append(
                f"trail step {i} numbered {step.get('step')!r}")
        values = step.get("values") or []
        sv = step.get("verdicts") or []
        if sorted(v for v, _ in sv) != sorted(values):
            violations.append(
                f"step {i} verdicts {sv} do not cover values {values}")
        for v, ok in sv:
            if v in verdicts:
                violations.append(
                    f"value {v} evaluated twice (step {i} re-probed it)")
            verdicts[int(v)] = bool(ok)
        sfx = f"+q{i}"
        for key in step.get("keys") or []:
            if not str(key).endswith(sfx):
                violations.append(
                    f"step {i} chunk key {key!r} lacks the {sfx!r} suffix")
            elif journal is not None \
                    and str(key) not in journal.completed():
                violations.append(
                    f"step {i} chunk {key!r} missing/invalid in journal")
    points = result.get("points")
    if points is not None:
        want = {(v, s) for v in verdicts for s in seeds}
        got = [(p.get("value"), p.get("seed")) for p in points]
        if len(got) != len(set(got)) or set(got) != want:
            violations.append(
                f"points cover {len(set(got))}/{len(got)} unique "
                f"(value, seed) pairs, expected exactly {len(want)}")
    low_keys = {"max_f_surviving": ("f_max", "first_failing"),
                "cliff_locate": ("last_true", "first_false"),
                "min_k_finality": ("last_failing", "k_min")}
    kind = query.get("kind")
    lo_k, hi_k = low_keys.get(kind, (None, None))
    if lo_k is not None:
        low, high = answer.get(lo_k), answer.get(hi_k)
        ok_low = kind != "min_k_finality"  # low side passes except min_k
        if low is not None and verdicts.get(low) is not ok_low:
            violations.append(
                f"answer {lo_k}={low} contradicts its verdict "
                f"{verdicts.get(low)}")
        if high is not None and verdicts.get(high) is ok_low:
            violations.append(
                f"answer {hi_k}={high} contradicts its verdict "
                f"{verdicts.get(high)}")
        if low is not None and high is not None and high != low + 1:
            violations.append(
                f"bracket not fully narrowed: {lo_k}={low}, {hi_k}={high}")
    run = result.get("run") or {}
    if expect_monotone and run.get("monotonicity_violations", 0):
        violations.append(
            f"{run['monotonicity_violations']} monotonicity violation(s) "
            f"observed during the search")
    return violations


def check_server(
    ledger: Ledger | None,
    stats: dict,
    log_path=None,
    registry_before: dict | None = None,
    registry_after: dict | None = None,
    replayed_ids=(),
) -> list[str]:
    """Run every invariant a scenario can supply evidence for; returns the
    violation list (empty = clean).

    ``ledger`` — the scenario's client-side submissions (None skips 1a);
    ``stats`` — ``ScenarioServer.stats()`` at quiescence;
    ``log_path`` — the scenario's runs.jsonl access log (None skips 2);
    ``registry_before/after`` — aotcache snapshots bracketing the run;
    ``replayed_ids`` — ids the scenario expects WAL replay to answer.
    """
    violations: list[str] = []
    if ledger is not None:
        violations += ledger_complete(ledger)
    violations += _stats_balance(stats)
    if log_path is not None:
        recs = obs.read_jsonl(log_path)
        logged = {str(r.get("id")) for r in recs if r.get("id") is not None}
        replay_logged = {
            str(r.get("id")) for r in recs if r.get("replayed") is True
        }
        if ledger is not None:
            for req_id in ledger.attempts:
                if req_id not in logged:
                    violations.append(
                        f"request {req_id!r} has no access-log line "
                        f"(manifest lost)"
                    )
        for req_id in replayed_ids:
            if str(req_id) not in replay_logged:
                violations.append(
                    f"replayed request {req_id!r} has no replayed "
                    f"access-log line"
                )
    if registry_before is not None and registry_after is not None:
        violations += registry_monotone(registry_before, registry_after)
    return violations


def check_consensus_probes(summaries, max_lag: int | None = None) -> list[str]:
    """The consensus-safety invariant: no in-program monitor fired across
    a scenario's probed runs.

    ``summaries`` is an iterable of probe summaries (obsim/schema.
    summarize output — a row's ``m["probe"]``, a serve response's
    ``metrics["probe"]``, or a bare summary dict).  Each summary's
    safety counters (``viol_agreement``, ``viol_quorum`` — already
    host-aggregated into its ``"violations"`` total) must be zero:
    these are the on-device twins of the host agreement checks, so a
    nonzero count under a crash/delay drill means the fault injection
    broke consensus SAFETY, not just liveness — always a violation.

    ``liveness_lag`` (progress-free trailing window, in samples) is a
    gauge, not a safety counter: it is gated only when the caller sets
    ``max_lag`` (scenario-specific — a crash drill legitimately stalls
    progress; a fault-free soak should not).

    Returns human-readable strings, empty when clean — the drill sums
    them into ``chaos_invariant_violations`` like every other check."""
    violations: list[str] = []
    for i, summary in enumerate(summaries):
        if not isinstance(summary, dict):
            violations.append(f"probe summary {i} is not a dict: {summary!r}")
            continue
        s = summary["probe"] if "probe" in summary else summary
        who = (f"run {i} ({s.get('protocol', '?')}/"
               f"{s.get('topology', '?')})")
        mon = s.get("monitors")
        if mon is None:
            violations.append(f"{who}: no monitors in probe summary "
                              f"(probes disarmed or monitors=False)")
            continue
        n_viol = s.get("violations", 0)
        if n_viol:
            detail = {k: mon.get(k) for k in ("viol_agreement", "viol_quorum")}
            violations.append(
                f"{who}: {n_viol} consensus safety violation(s) {detail}"
            )
        if max_lag is not None:
            lag = mon.get("liveness_lag")
            lag_max = max(_flat_ints(lag)) if lag is not None else None
            if lag_max is not None and lag_max > max_lag:
                violations.append(
                    f"{who}: liveness lag {lag_max} samples exceeds "
                    f"max_lag={max_lag}"
                )
    return violations


def _flat_ints(v):
    """Flatten a summary leaf (int, or nested lists from committee /
    multi-lane summaries) to a flat int list."""
    if isinstance(v, (list, tuple)):
        out = []
        for x in v:
            out.extend(_flat_ints(x))
        return out or [0]
    return [int(v)]
