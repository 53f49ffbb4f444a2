"""Scenario-request schema: JSON in, typed requests and responses out (port
of ``blockchain_simulator_tpu/serve/schema.py``).

A scenario request is one JSON object selecting a simulation the daemon
should run::

    {"protocol": "pbft", "n": 64, "sim_ms": 2000, "seed": 3,
     "faults": {"n_byzantine": 2}, "stat_sampler": "exact",
     "id": "req-17", "timeout_s": 10.0}

Every key except the request-level ones (``id``, ``seed``, ``timeout_s``)
must name a :class:`~blockchain_simulator_tpu_torch.utils.config.SimConfig`
field (``faults`` takes a dict of ``FaultConfig`` fields); validation reuses
the dataclasses' own ``__post_init__`` checks and the runner's refusals, so
the server accepts exactly what the engines accept.  Parsing also computes
the request's **batch group**: the canonical fault structure
(models/base.canonical_fault_cfg) whose dynamic-fault-operand program serves
it; requests sharing a group micro-batch into one lane batch
(serve/dispatch.py).  The topology fields ride the canonical config, so
distinct topologies never share a dispatch group.  ``obs.config_hash`` of
the group equals the JAX package's for the same request.

Rejections are typed, never stringly: every failure mode is a
:class:`ServeError` subclass with an HTTP-style ``code`` and a stable
``kind`` slug, with the JAX package's codes, kinds and messages.  The
request-level ``probe`` (obsim's in-program probes) and ``query`` (adaptive
threshold searches) fields come with the durable-sweeps slice of the port
and are refused at admission with a typed 400 naming it.
"""

from __future__ import annotations

import dataclasses

from blockchain_simulator_tpu_torch.models.base import canonical_fault_cfg
from blockchain_simulator_tpu_torch.parallel.sweep import DURABLE_SWEEPS
from blockchain_simulator_tpu_torch.utils.config import FaultConfig, SimConfig

# Request-level keys that are not SimConfig fields.
REQUEST_KEYS = ("id", "seed", "timeout_s", "probe", "query")

# SimConfig fields a request may set.  mesh_axis is excluded: the serving
# dispatch is single-device.
_CFG_FIELDS = frozenset(
    f.name for f in dataclasses.fields(SimConfig)
    if f.name not in ("faults", "mesh_axis")
)
_FAULT_FIELDS = frozenset(f.name for f in dataclasses.fields(FaultConfig))

# JSON-type reference: the frozen dataclasses don't type-check their
# fields, so a string `n` would sail through construction and poison the
# first dispatch that does arithmetic on it — check every provided value
# against the default's type up front (ints accepted for float fields;
# bools are NOT ints here, unlike Python's isinstance).
_CFG_DEFAULTS = SimConfig()
_FAULT_DEFAULTS = FaultConfig()


def _check_types(kw: dict, defaults, what: str) -> None:
    for k, v in kw.items():
        d = getattr(defaults, k)
        if isinstance(d, bool):
            ok = isinstance(v, bool)
        elif isinstance(d, int):
            ok = isinstance(v, int) and not isinstance(v, bool)
        elif isinstance(d, float):
            ok = isinstance(v, (int, float)) and not isinstance(v, bool)
        elif isinstance(d, str):
            ok = isinstance(v, str)
        else:
            ok = True
        if not ok:
            raise InvalidRequestError(
                f"{what}{k} must be of type {type(d).__name__}, got "
                f"{type(v).__name__} ({v!r})"
            )


# ------------------------------------------------------------ typed errors


class ServeError(Exception):
    """Base of every typed serving rejection: HTTP-style ``code`` plus a
    stable ``kind`` slug.  :meth:`to_response` renders the uniform error
    response body."""

    code = 500
    kind = "internal-error"

    def to_response(self, req_id: str | None = None) -> dict:
        rec = {
            "id": req_id,
            "status": "error",
            "code": self.code,
            "kind": self.kind,
            "error": str(self),
        }
        return rec


class InvalidRequestError(ServeError):
    """Malformed request: unknown field, bad type, or a value the config
    layer itself refuses (SimConfig/FaultConfig ``__post_init__``)."""

    code = 400
    kind = "invalid-request"


class UnbatchableRequestError(ServeError):
    """Valid config with no dynamic-fault-operand program (today: the mixed
    shard sim — runner.UnbatchableConfigError).  4xx, not a crash: the
    client asked for something this dispatch path cannot batch."""

    code = 422
    kind = "unbatchable-config"


class QueueFullError(ServeError):
    """Backpressure: the bounded request queue is at capacity.  Retry later;
    the rejection is recorded in the access log before the caller sees it."""

    code = 429
    kind = "queue-full"


class AdmissionPausedError(ServeError):
    """The backend health verdict is not ``healthy`` (utils/health.py), so
    admission is paused.  Readiness, not validity: the same request is
    served once the verdict recovers."""

    code = 503
    kind = "admission-paused"


class RequestTimeoutError(ServeError):
    """The request's ``timeout_s`` elapsed before its batch dispatched."""

    code = 504
    kind = "timeout"


class DispatchFailedError(ServeError):
    """The request failed its SOLO dispatch (directly, or after a batched
    dispatch degraded).  A stable kind rather than a message match because
    the server's quarantine rule keys on it: an id that failed alone is
    poison and must never ride a batch again (serve/server.py)."""

    code = 500
    kind = "dispatch-failed"


class ShuttingDownError(ServeError):
    """The server is draining; no new requests."""

    code = 503
    kind = "shutting-down"


class ReplicaLostError(ServeError):
    """Fleet routing (serve/router.py) lost the replica carrying this
    request and no peer could answer it: the replica died and its WAL
    lease is held elsewhere, or no live replica remains.  502, the
    gateway's own failure class — retryable by the client, and always
    access-logged before the caller sees it."""

    code = 502
    kind = "replica-lost"


# ---------------------------------------------------------------- requests


@dataclasses.dataclass
class ScenarioRequest:
    """One admitted scenario request.

    ``cfg`` is the full simulation config the response's metrics are
    computed against; ``canon`` is its canonical fault structure — the
    batch-group key AND the executable-registry key, so two requests with
    equal ``canon`` share one built program.  ``submitted`` is stamped by the server
    (time.monotonic) when the request enters the queue.  ``replayed``
    marks a request re-admitted from the write-ahead log after a crash
    (serve/wal.py): its responses carry ``"replayed": true`` so the
    access log separates replay answers from live ones."""

    req_id: str
    cfg: SimConfig
    canon: SimConfig
    seed: int
    timeout_s: float
    submitted: float = 0.0
    replayed: bool = False
    # -- telemetry (utils/telemetry.py; host-side only) --------------------
    # trace identity: minted at admission (or adopted from the router's
    # X-Blocksim-Trace header, in which case parent_span is the router's
    # send-span id), so the replica's span tree hangs off the fleet's
    trace_id: str | None = None
    parent_span: str | None = None
    t_admit: float = 0.0
    # lifecycle stamps (time.monotonic), filled as the request moves
    # batcher-side; the server synthesizes the segment spans (queue_wait /
    # batch_wait / dispatch / answer) from these at answer time, because
    # the segments straddle the submitter, batcher and dispatch
    t_drained: float = 0.0
    t_flush: float = 0.0
    t_dispatch0: float = 0.0
    t_dispatch1: float = 0.0

    def expired(self, now: float) -> bool:
        return self.timeout_s > 0 and (now - self.submitted) > self.timeout_s


def parse_request(obj, req_id: str, default_timeout_s: float = 30.0,
                  ) -> ScenarioRequest:
    """Validate and canonicalize one JSON scenario request.

    Raises :class:`InvalidRequestError` for malformed/unknown/refused
    fields and :class:`UnbatchableRequestError` for valid configs with no
    batchable program — the original refusal message (e.g.
    ``runner.check_batchable``'s mixed text) is preserved verbatim."""
    from blockchain_simulator_tpu_torch import runner

    if not isinstance(obj, dict):
        raise InvalidRequestError(
            f"request must be a JSON object, got {type(obj).__name__}"
        )
    obj = dict(obj)
    req_id = str(obj.pop("id", req_id))
    try:
        timeout_s = float(obj.pop("timeout_s", default_timeout_s))
    except (TypeError, ValueError) as e:
        raise InvalidRequestError(f"timeout_s: {e}") from e

    probe_kw = obj.pop("probe", False)
    if probe_kw is not False and not isinstance(probe_kw, (bool, dict)):
        raise InvalidRequestError(
            "probe must be true/false or a JSON object of ProbeConfig "
            f"fields, got {type(probe_kw).__name__}"
        )

    query_kw = obj.pop("query", None)
    if query_kw is not None and not isinstance(query_kw, dict):
        raise InvalidRequestError(
            "query must be a JSON object of QuerySpec fields, got "
            f"{type(query_kw).__name__}"
        )

    fault_kw = obj.pop("faults", None)
    if fault_kw is None:
        fault_kw = {}
    if not isinstance(fault_kw, dict):
        # no falsy coercion: {"faults": []} is a client mistake, not a
        # zero-fault scenario — answering it 200 would serve the wrong sim
        raise InvalidRequestError(
            f"faults must be a JSON object of FaultConfig fields, got "
            f"{type(fault_kw).__name__}"
        )
    unknown = sorted(set(fault_kw) - _FAULT_FIELDS)
    if unknown:
        raise InvalidRequestError(
            f"unknown fault field(s): {', '.join(unknown)} "
            f"(valid: {', '.join(sorted(_FAULT_FIELDS))})"
        )
    unknown = sorted(set(obj) - _CFG_FIELDS)
    if unknown:
        raise InvalidRequestError(
            f"unknown request field(s): {', '.join(unknown)} (valid: "
            f"SimConfig fields plus {', '.join(REQUEST_KEYS)})"
        )
    _check_types(fault_kw, _FAULT_DEFAULTS, "faults.")
    _check_types(obj, _CFG_DEFAULTS, "")
    try:
        cfg = SimConfig(**obj, faults=FaultConfig(**fault_kw))
    except (TypeError, ValueError) as e:
        raise InvalidRequestError(str(e)) from e
    if cfg.n < 1:
        # the JAX package admits this and answers a 500 after its dispatch
        # fails; refused here, so no engine ever builds a negative shape
        raise InvalidRequestError(f"n must be >= 1, got {cfg.n}")
    seed = int(obj.get("seed", cfg.seed))

    # typed batchability triage, then the engine's own validity checks —
    # at admission, so a bad request can never poison a dispatched batch
    try:
        runner.check_batchable(cfg)
    except runner.UnbatchableConfigError as e:
        raise UnbatchableRequestError(str(e)) from e
    try:
        runner._reject_cpp_only(cfg)
        # resolve the schedule now: ineligible explicit 'round' raises here,
        # not inside the batch trace
        runner.use_round_schedule(cfg)
    except (NotImplementedError, ValueError, TypeError) as e:
        raise InvalidRequestError(str(e)) from e

    # obsim's probes and the adaptive queries are not ported yet: refused
    # here, so such a request never reaches a batch
    if probe_kw:
        raise InvalidRequestError(f"probe: obsim's in-program probes come with {DURABLE_SWEEPS}")
    if query_kw is not None:
        raise InvalidRequestError(f"query: adaptive queries come with {DURABLE_SWEEPS}")

    return ScenarioRequest(
        req_id=req_id,
        cfg=cfg,
        canon=canonical_fault_cfg(cfg),
        seed=seed,
        timeout_s=timeout_s,
    )


def scenario_template(cfg: SimConfig, seed: int | None = None) -> dict:
    """The compact re-submittable request template of one config: only
    the non-default SimConfig/FaultConfig fields (plus ``seed`` when
    given).  ``parse_request(scenario_template(cfg))`` reconstructs the
    same canonical batch group — the access log records this per served
    request so ``--prewarm-from`` can warm tomorrow's daemon from the
    group/bucket mix actually observed yesterday (serve/server.py)."""
    d = dataclasses.asdict(cfg)
    cfg_defaults = dataclasses.asdict(_CFG_DEFAULTS)
    out = {k: v for k, v in d.items()
           if k in _CFG_FIELDS and v != cfg_defaults.get(k)}
    fault_defaults = dataclasses.asdict(_FAULT_DEFAULTS)
    faults = {k: v for k, v in (d.get("faults") or {}).items()
              if v != fault_defaults.get(k)}
    if faults:
        out["faults"] = faults
    if seed is not None:
        out["seed"] = int(seed)
    return out


# --------------------------------------------------------------- responses


def ok_response(req: ScenarioRequest, metrics: dict, batch: dict,
                latency_s: float) -> dict:
    """The uniform success body: metrics plus the batch provenance the
    bit-equality tests and the occupancy histogram read."""
    return {
        "id": req.req_id,
        "status": "ok",
        "code": 200,
        "metrics": metrics,
        "batch": batch,
        "latency_ms": round(latency_s * 1000.0, 3),
    }
