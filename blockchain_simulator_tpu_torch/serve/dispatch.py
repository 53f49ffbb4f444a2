"""Micro-batched scenario dispatch: N queued requests, one lane batch (port of
``blockchain_simulator_tpu/serve/dispatch.py``).

The execution substrate of the scenario server (serve/server.py).  A batch
is a list of admitted :class:`~blockchain_simulator_tpu_torch.serve.schema.
ScenarioRequest` sharing one canonical fault structure (their batch group);
dispatch runs them as ONE dynamic-fault-operand program over their lanes,
through the sweeps' group-dispatch primitive
(``parallel/sweep.run_dyn_points``) and its registry entry
(``"sweep-batched-dynf"``), so a warm sweep cache serves traffic with no
build.  On the round path, the heartbeat path and the Raft tick engine the
lanes run side by side (parallel/sweep.lane_axis); elsewhere in turn.

Batch-size buckets: batches are padded up to the next power-of-two bucket
(capped at the server's ``max_batch``) by repeating the last lane, as the
JAX package does for its shape-specialized executables, so a request's
lane list (and with it the ``"normal"`` sampler's draws, which follow lane
0's key) is the JAX package's.  A pad lane repeats the last request: it
changes nobody's answer, and its row is dropped.

Robustness: a failed batched dispatch degrades to per-request solo dispatch
on the same device (the ``"serve-solo"`` registry entry over
``runner.make_dyn_sim_fn``), so one poisoned request fails alone; nothing
ever falls back to the CPU.  Every lane failure surfaces as a typed
:class:`~blockchain_simulator_tpu_torch.serve.schema.ServeError` response.

Bit-equality: under ``stat_sampler="exact"`` a request's metrics are
bit-equal whether served solo, batched, or padded (per-lane key streams);
the ``"normal"`` sampler's draws follow the first lane's key in a batch, as
the JAX package's vmapped draws do.
"""

from __future__ import annotations

import time

import numpy as np

from blockchain_simulator_tpu_torch import runner
from blockchain_simulator_tpu_torch.chaos import inject
from blockchain_simulator_tpu_torch.models.base import sim_metrics
from blockchain_simulator_tpu_torch.parallel import sweep
from blockchain_simulator_tpu_torch.runner import make_dyn_sim_fn
from blockchain_simulator_tpu_torch.serve import schema
from blockchain_simulator_tpu_torch.utils import aotcache, obs, telemetry, threefry
from blockchain_simulator_tpu_torch.utils.sync import force_sync


@aotcache.cached_factory("serve-solo")
def _solo_fn(canon):
    """``sim(key, n_crashed, n_byzantine, device) -> final`` for one
    canonical fault structure: the solo and degrade path of the scenario
    server.  One registry entry a structure serves every (seed, fault
    count) request solo."""
    return make_dyn_sim_fn(canon)


def bucket_size(n: int, max_batch: int) -> int:
    """The padded batch size actually dispatched for ``n`` queued requests:
    next power of two >= n, capped at ``max_batch`` (n is never above it —
    the batcher flushes at max_batch)."""
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


def _operands(reqs):
    """(keys [B, 2] host words, n_crashed [B], n_byzantine [B]) for a padded
    request list: ``threefry.key`` a seed, as parallel/sweep._keys."""
    keys = np.stack([threefry.key(int(r.seed)) for r in reqs])
    nc = [r.cfg.faults.resolved_n_crashed(r.cfg.n) for r in reqs]
    nb = [r.cfg.faults.n_byzantine for r in reqs]
    return keys, nc, nb


def _solo_metrics(req, device):
    """Run one request through the solo program on ``device``; returns its
    metrics.  The ``serve.solo_dispatch`` chaos point fires first with the
    request id, so a drill can poison exactly one request.  Dispatch stamps
    (span synthesis, serve/server._answer) and the ``$BLOCKSIM_PROFILE``
    capture bracket the run."""
    # stamp BEFORE the chaos point, and fire the point inside the
    # try/finally: a poisoned request still records a near-zero dispatch
    # span instead of a stale batched stamp, or none
    req.t_dispatch0 = time.monotonic()
    try:
        inject.chaos_point("serve.solo_dispatch", req_id=req.req_id)
        with telemetry.profile_region("serve_solo"):
            keys, nc, nb = _operands([req])
            final = force_sync(_solo_fn(req.canon)(keys[0], nc[0], nb[0], device))
        return sim_metrics(req.cfg, final)
    finally:
        req.t_dispatch1 = time.monotonic()


def run_batch(reqs, max_batch: int, force_solo: bool = False,
              solo_reason: str | None = None, mesh=None,
              journal=None, device=None) -> list[tuple]:
    """Dispatch one same-group batch on ``device`` (the CUDA card when
    None); returns ``[(req, response)]`` in order, one entry per request,
    every response either 200 or a typed error body.

    One request dispatches solo; two or more dispatch as one lane batch over
    the bucket-padded lane set.  Any batched failure degrades to per-request
    solo dispatch on the same device (the ``degraded`` flag feeds the
    server's ``degraded_batches`` stat), and any SOLO failure answers as the
    typed ``dispatch-failed`` error, the signal the server's quarantine keys
    on.  ``force_solo=True`` skips the batched attempt (the server's circuit
    breaker); ``solo_reason`` labels such batches' ``mode``
    (``breaker-solo``, ``quarantined-solo``).

    ``mesh`` (a batch sharded over many GPUs) and ``journal`` (durable
    batches) raise ``NotImplementedError`` naming their slices, as the
    sweep's do."""
    sweep._refuse_arms(mesh=mesh, journal=journal)
    device = runner.resolve_device(device)
    t0 = time.monotonic()
    canon = reqs[0].canon
    group = obs.config_hash(canon)
    if len(reqs) == 1:
        req = reqs[0]
        batch = {"size": 1, "padded": 1, "mode": solo_reason or "solo",
                 "group": group}
        try:
            m = _solo_metrics(req, device)
        except Exception as e:  # typed, never a crashed worker
            err = schema.DispatchFailedError(f"solo dispatch failed: "
                                             f"{type(e).__name__}: {e}")
            return [(req, err.to_response(req.req_id))]
        latency = time.monotonic() - (req.submitted or t0)
        return [(req, schema.ok_response(req, m, batch, latency))]

    if force_solo:
        # the breaker's solo-only mode: each request alone through the
        # solo program, by policy (not degradation: no degraded flag)
        out = []
        solo = {"size": len(reqs), "padded": 1,
                "mode": solo_reason or "forced-solo", "group": group}
        for req in reqs:
            try:
                m = _solo_metrics(req, device)
            except Exception as e:
                err = schema.DispatchFailedError(
                    f"solo dispatch failed: {type(e).__name__}: {e}"
                )
                out.append((req, err.to_response(req.req_id)))
                continue
            latency = time.monotonic() - (req.submitted or t0)
            out.append((req, schema.ok_response(req, m, solo, latency)))
        return out

    padded = bucket_size(len(reqs), max_batch)
    lanes = list(reqs) + [reqs[-1]] * (padded - len(reqs))
    batch = {"size": len(reqs), "padded": padded, "mode": "batched",
             "group": group}
    try:
        # the sweeps' group-dispatch primitive, fed the queue instead of a
        # cross product; record=False (the server writes its own per-request
        # access-log records); n_out drops the pad lanes' metrics
        d0 = time.monotonic()
        try:
            with telemetry.profile_region("serve_flush"):
                rows = sweep.run_dyn_points(
                    canon, [(r.cfg, r.seed) for r in lanes], record=False,
                    n_out=len(reqs), device=device,
                )
        finally:
            d1 = time.monotonic()
            for req in reqs:
                req.t_dispatch0, req.t_dispatch1 = d0, d1
        out = []
        for req, m in zip(reqs, rows):
            latency = time.monotonic() - (req.submitted or t0)
            out.append((req, schema.ok_response(req, m, batch, latency)))
        return out
    except Exception:
        # a batch peer failed: serve every lane solo, on the same device, so
        # one poisoned request cannot take its neighbours' answers down with
        # it.  The failed flush's stamps are cleared first: each solo retry
        # re-stamps its own attempt
        for req in reqs:
            req.t_dispatch0 = req.t_dispatch1 = 0.0
        out = []
        solo = {"size": len(reqs), "padded": 1, "mode": "degraded-solo",
                "group": group, "degraded": True}
        for req in reqs:
            try:
                m = _solo_metrics(req, device)
            except Exception as e:
                err = schema.DispatchFailedError(
                    f"dispatch failed (batched, then solo): "
                    f"{type(e).__name__}: {e}"
                )
                out.append((req, err.to_response(req.req_id)))
                continue
            latency = time.monotonic() - (req.submitted or t0)
            out.append((req, schema.ok_response(req, m, solo, latency)))
        return out
