"""Typed consensus-design queries: what to search, over what, until when
(a copy of ``blockchain_simulator_tpu/query/spec.py``, which imports no
JAX).

The sweep stack answers fixed grids; the questions practitioners ask are
thresholds — "what is the largest f this config survives?", "where is
the crash/loss cliff?", "what is the cheapest overlay degree k that
still reaches finality?".  A :class:`QuerySpec` names
one such question as data: a query *kind*, the integer parameter domain
it searches, and an explicit per-point *predicate* (commit target +
optional tick budget, aggregated across seeds) the engine
(query/engine.py) bisects against.

Query kinds
-----------
``max_f_surviving``
    Largest ``n_crashed`` (or ``n_byzantine``, via ``param``) at which
    the predicate still holds.  Fault counts are traced operands
    (models/base.canonical_fault_cfg), so every probe runs one registry
    entry's program — the search costs dispatches, never rebuilds.
``cliff_locate``
    The bracketing form of the same search: answers BOTH sides of the
    boundary (``last_true`` / ``first_false``) and accepts a
    ``probe_width`` > 1 to narrow the bracket faster (more points per
    generation, still ONE dispatch per generation).
``min_k_finality``
    Smallest kregular overlay degree ``k`` at which the predicate
    holds (increasing predicate).  Degree is program STRUCTURE (the
    overlay tables), so each distinct probed k is its own program — the
    reason this kind dispatches one chunk per probed value instead of one
    per generation.

Predicate semantics
-------------------
A point passes when, per seed, the protocol's commit metric reaches
``commit_target`` AND (``tick_budget`` > 0) the protocol's
commit-latency metric is within ``tick_budget`` ms AND the host
agreement check passed; seed verdicts aggregate under ``agg``:
``all_commit`` (every seed) or ``majority_commit`` (strict majority).
The engine assumes the predicate is monotone along the searched
parameter; near a noisy cliff a verdict against it is counted
(``monotonicity_violations``) and resolved toward the lower boundary.
"""

from __future__ import annotations

import dataclasses

KINDS = ("max_f_surviving", "cliff_locate", "min_k_finality")
FAULT_PARAMS = ("n_crashed", "n_byzantine")
AGGS = ("all_commit", "majority_commit")

# Per-protocol metric doors the predicate reads (models/{pbft,raft,
# paxos}.py metrics()): the commit-count metric and its latency twin.
COMMIT_KEYS = {
    "pbft": "blocks_final_all_nodes",
    "raft": "blocks",
    "paxos": "n_committed_proposers",
}
TIME_KEYS = {
    "pbft": "last_commit_ms",
    "raft": "last_block_ms",
    "paxos": "winner_commit_ms",
}


@dataclasses.dataclass(frozen=True)
class QuerySpec:
    """One adaptive query, fully determined by its fields (the engine is
    deterministic, so spec + base config + seeds IS the answer)."""

    kind: str
    param: str = "n_crashed"   # searched axis (fault count, or "degree")
    lo: int = 0                # inclusive domain floor
    hi: int = -1               # inclusive ceiling; -1 = kind default
    seeds: tuple = (0,)
    commit_target: int = 1     # commit-count metric must reach this
    tick_budget: int = 0       # ms bound on the latency metric; 0 = none
    agg: str = "all_commit"
    probe_width: int = 1       # interior probes per refinement generation

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["seeds"] = list(self.seeds)
        return d


def parse_query(obj) -> QuerySpec:
    """Validate a wire-shaped ``{"kind": ..., ...}`` dict into a
    :class:`QuerySpec`; raises ``ValueError`` with a one-line reason
    (serve/schema.py wraps it in the typed 400)."""
    if not isinstance(obj, dict):
        raise ValueError(f"query must be an object, got {type(obj).__name__}")
    obj = dict(obj)
    kind = obj.pop("kind", None)
    if kind not in KINDS:
        raise ValueError(f"query kind {kind!r} not in {KINDS}")
    fields = {f.name: f for f in dataclasses.fields(QuerySpec)}
    kw = {"kind": kind}
    for k, v in obj.items():
        if k == "kind" or k not in fields:
            raise ValueError(f"unknown query field {k!r}")
        if k == "seeds":
            if not isinstance(v, (list, tuple)) or not v \
                    or not all(isinstance(s, int)
                               and not isinstance(s, bool) for s in v):
                raise ValueError("query seeds must be a non-empty int list")
            kw[k] = tuple(int(s) for s in v)
        elif k in ("param", "agg"):
            if not isinstance(v, str):
                raise ValueError(f"query field {k!r} must be a string")
            kw[k] = v
        else:
            if isinstance(v, bool) or not isinstance(v, int):
                raise ValueError(f"query field {k!r} must be an int")
            kw[k] = int(v)
    spec = QuerySpec(**kw)
    if spec.kind == "min_k_finality":
        if "param" in kw and spec.param != "degree":
            raise ValueError("min_k_finality searches param 'degree'")
        spec = dataclasses.replace(spec, param="degree")
    elif spec.param not in FAULT_PARAMS:
        raise ValueError(
            f"query param {spec.param!r} not in {FAULT_PARAMS} "
            f"(degree is min_k_finality only)")
    if spec.agg not in AGGS:
        raise ValueError(f"query agg {spec.agg!r} not in {AGGS}")
    if spec.commit_target < 1:
        raise ValueError("query commit_target must be >= 1")
    if spec.tick_budget < 0:
        raise ValueError("query tick_budget must be >= 0")
    if not 1 <= spec.probe_width <= 64:
        raise ValueError("query probe_width must be in [1, 64]")
    if spec.lo < 0:
        raise ValueError("query lo must be >= 0")
    if spec.hi != -1 and spec.hi < spec.lo:
        raise ValueError(f"query domain empty: lo={spec.lo} > hi={spec.hi}")
    return spec


def resolve_domain(spec: QuerySpec, cfg) -> tuple[int, int]:
    """The concrete inclusive ``[lo, hi]`` integer domain for this base
    config: ``hi=-1`` defaults to the parameter's natural ceiling
    (``n - 1`` for fault counts — node 0 stays alive by the fault-mask
    layout — and ``n - 1`` for degree, which IS the full mesh)."""
    lo = spec.lo
    hi = spec.hi if spec.hi != -1 else cfg.n - 1
    if spec.param == "degree":
        lo = max(lo, 1)
    if hi >= cfg.n:
        raise ValueError(
            f"query hi={hi} exceeds the {spec.param} ceiling n-1={cfg.n - 1}")
    if hi < lo:
        raise ValueError(f"query domain empty: [{lo}, {hi}]")
    return lo, hi


def point_cfg(cfg, spec: QuerySpec, value: int):
    """The concrete SimConfig at one searched parameter value."""
    if spec.param == "degree":
        return cfg.with_(topology="kregular", degree=int(value))
    # an explicit count overrides crash_frac (FaultConfig.resolved_n_crashed),
    # so only the searched field moves — the rest of the fault load stays
    return cfg.with_(faults=dataclasses.replace(
        cfg.faults, **{spec.param: int(value)}))


def row_ok(protocol: str, row: dict, spec: QuerySpec) -> bool:
    """The per-seed predicate on one metrics row."""
    commits = row.get(COMMIT_KEYS.get(protocol, ""), 0)
    if commits is None or int(commits) < spec.commit_target:
        return False
    if not row.get("agreement_ok", False):
        return False
    if spec.tick_budget > 0:
        t = row.get(TIME_KEYS.get(protocol, ""))
        if t is None or not 0 <= float(t) <= float(spec.tick_budget):
            return False
    return True


def verdict(protocol: str, rows, spec: QuerySpec) -> bool:
    """Aggregate one point's per-seed rows into the point verdict."""
    oks = [row_ok(protocol, r, spec) for r in rows]
    if spec.agg == "majority_commit":
        return sum(oks) * 2 > len(oks)
    return all(oks)
