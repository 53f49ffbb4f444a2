"""Fleet layer: replicated serving daemons + exactly-once WAL handoff (port
of ``blockchain_simulator_tpu/serve/fleet.py``).

The single-daemon stack (serve/server.py and its WAL) survives a kill -9
losslessly but not *availably*: capacity is zero until the restart.  This
module scales the same durability discipline out to N replicas:

- :class:`ReplicaProc` — one replica = one ``python -m
  blockchain_simulator_tpu_torch.serve`` daemon subprocess with its own WAL
  in the fleet directory, serving on ``device`` (the CUDA card by default).
- :class:`FleetManager` — spawn/monitor/kill/restart N replicas under one
  fleet directory (``<fleet_dir>/wal/<replica>.wal``).
- **WAL lease claims** (:func:`claim_wal`) — on replica death a router
  lease-claims the dead WAL through an atomic claim file so its
  admitted-but-unanswered requests are replayed on a live peer **exactly
  once fleet-wide** even with racing routers; torn claim files (a claimant
  that died mid-claim) are stolen through a second exclusive lock, also
  exactly once.
- :func:`handoff_wal` — the claim + replay + retire pipeline itself,
  shared by :class:`~blockchain_simulator_tpu_torch.serve.router.FleetRouter`
  and the chaos drills.

The claim file format, the WAL format and the replay marks are the JAX
package's, so either package's router can hand off the other's WAL.

Claim semantics:

1. A claim file is only ever created ATOMICALLY WITH ITS CONTENT
   (write-to-temp + fsync + ``os.link``), so this writer can never leave a
   torn claim; ``os.link`` onto an existing path fails, so exactly one
   fresh claimant wins.
2. A torn claim (present but unparseable: a foreign writer that died
   between create and write) is stolen through ``<claim>.steal``
   (``O_CREAT|O_EXCL``): exactly one stealer wins and atomically replaces
   the torn claim with its own fsynced record.  A torn claim whose stealer
   also died stays unclaimed forever, the safe side (no double replay; an
   operator deletes the pair to recover).
3. The claim is held for the whole replay; a replica restarting on a
   claimed WAL skips its own startup replay (serve/server.py checks
   :func:`claim_owner`): the pending ids belong to the claim holder.
   Release (:func:`release_claim`) happens only after every pending id has
   a ``done`` record, so a post-release restart replays zero.

Replayed answers are marked ``"replayed": true`` with a ``handoff`` block
(claim owner + source WAL) in both the client response and the access-log
line.

The shared compile cache has no meaning in the port yet: the JAX fleet
points every replica at ``<fleet_dir>/compile_cache`` through
``$BLOCKSIM_COMPILE_CACHE`` so replicas warm from one set of serialized
executables, and the port builds no serializable executable (aotcache's
on-disk layer, ROADMAP.md B-later item 1).  The directory layout is kept,
no cache variable is set, and replicas warm through ``--prewarm`` only.

``python -m blockchain_simulator_tpu_torch.serve.fleet`` runs the whole
thing as one daemon: N replicas + the router front-end on one port, on the
card unless ``--device cpu``; without a card it exits 1 before READY
(README "Fleet serving and chaos drills on the port").
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time

from blockchain_simulator_tpu_torch.serve.wal import WriteAheadLog
from blockchain_simulator_tpu_torch.utils import obs

CLAIM_SCHEMA = 1


# --------------------------------------------------------------- claims ---


def claim_path(wal_path: str) -> str:
    return str(wal_path) + ".claim"


def claim_owner(wal_path: str) -> str | None:
    """Owner of a VALID claim on this WAL; None when the claim file is
    missing OR torn (unparseable/ownerless — rule 2 decides who may fix a
    torn one, not this reader)."""
    try:
        with open(claim_path(wal_path)) as f:
            rec = json.loads(f.read())
    except (OSError, json.JSONDecodeError):
        return None
    if isinstance(rec, dict) and rec.get("claim") == CLAIM_SCHEMA \
            and rec.get("owner"):
        return str(rec["owner"])
    return None


def _write_fsync(path: str, blob: str) -> None:
    with open(path, "w") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())


def claim_wal(wal_path: str, owner: str) -> bool:
    """Lease-claim a (presumed dead) replica's WAL; True = this owner holds
    the lease and may replay, False = somebody else does (or a torn claim
    could not be stolen).  Exactly one caller ever gets True per claim
    lifetime — see the module docstring for the two atomic steps."""
    path = claim_path(wal_path)
    blob = json.dumps({"claim": CLAIM_SCHEMA, "owner": str(owner),
                       "ts": round(time.time(), 3)}) + "\n"
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    _write_fsync(tmp, blob)
    try:
        # content-first atomic create: the claim file can never exist torn
        # from THIS writer, and link() onto an existing path loses
        os.link(tmp, path)
        return True
    except FileExistsError:
        pass
    except OSError:
        # a filesystem without hard links: degrade to O_EXCL create (a
        # crash between create and write CAN leave a torn claim here —
        # which is exactly what the steal path below tolerates)
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            pass
        except OSError:
            os.unlink(tmp)
            return False
        else:
            with os.fdopen(fd, "w") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.unlink(tmp)
            return True
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass
    if claim_owner(wal_path) is not None:
        return False  # valid claim: lost the race outright
    # torn claim: steal through the exclusive .steal lock so two stealers
    # cannot both win; the winner replaces the torn file atomically
    try:
        sfd = os.open(path + ".steal", os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except OSError:
        return False  # another stealer holds (or died holding) the lock
    with os.fdopen(sfd, "w") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    _write_fsync(tmp, blob)
    os.replace(tmp, path)
    return True


def release_claim(wal_path: str) -> None:
    """Retire a claim after every pending id is done-marked: the WAL's
    owner returns to its replica.  Removing the steal lock too re-arms the
    torn-claim recovery for the next lifetime."""
    for suffix in (".claim", ".claim.steal"):
        try:
            os.unlink(str(wal_path) + suffix)
        except OSError:
            pass


# -------------------------------------------------------------- handoff ---


def handoff_wal(wal_path: str, owner: str, post, on_answer=None,
                release: bool = True) -> dict:
    """Claim a dead replica's WAL and replay its admitted-but-unanswered
    ids on a live peer, exactly once fleet-wide.

    ``post(obj) -> (status, body)`` dispatches one raw request JSON on the
    peer (the router passes its retrying sender); ``on_answer(req_id,
    body)`` lets the caller resolve a parked client future per replay.
    Every replay answer — success OR typed rejection (a replay of a
    now-invalid request answers its 4xx, never crashes the handoff) — is
    marked ``"replayed": true`` + a ``handoff`` block, ``done``-marked in
    the dead WAL (so a restarted replica replays zero) and access-logged.

    Returns ``{"claimed": bool, "pending": n, "replayed": [ids...],
    "failed": [ids...]}``; ``claimed=False`` means another owner holds the
    lease — the caller must NOT replay (its parked futures answer typed
    ``replica-lost``; the lease holder's replay is the one true replay).
    """
    from blockchain_simulator_tpu_torch.serve import schema
    from blockchain_simulator_tpu_torch.utils import telemetry

    if not claim_wal(wal_path, owner):
        return {"claimed": False, "owner": claim_owner(wal_path),
                "pending": None, "replayed": [], "failed": []}
    wal = WriteAheadLog(wal_path, sync=False)
    pend = wal.pending()
    replayed, failed = [], []
    for rid, raw in pend:
        obj = dict(raw) if isinstance(raw, dict) else {}
        obj["id"] = rid
        try:
            # each replay is its own FRESH trace (the dead replica's
            # original trace died with it) — context(None) clears any
            # trace the calling thread happens to carry, so a replay can
            # never graft onto an unrelated live request's tree.  The
            # span context rides the peer POST via the router's header
            # injection, marked replay=True so span trees separate
            # replays from live traffic.
            with telemetry.context(None), \
                    telemetry.span("fleet.handoff_replay",
                                   id=rid, replay=True, owner=str(owner),
                                   wal=os.path.basename(str(wal_path))):
                _status, body = post(obj)
            body = dict(body)
        except Exception as e:
            # the replay itself could not dispatch (no live peer): the
            # admitted id must NOT be retired — no done record, no
            # replayed mark — so a later restart/claimant replays it; the
            # caller's parked client still gets its typed 502 now
            body = schema.ReplicaLostError(
                f"handoff replay dispatch failed: {type(e).__name__}: {e}"
            ).to_response(rid)
            body["replay_failed"] = True
            body["handoff"] = {"wal": os.path.basename(str(wal_path)),
                               "owner": str(owner)}
            failed.append(rid)
            obs.record_run(body, None)
            if on_answer is not None:
                on_answer(rid, body)
            continue
        body["replayed"] = True
        body["handoff"] = {"wal": os.path.basename(str(wal_path)),
                           "owner": str(owner)}
        # done BEFORE release: a replica restarting after the release must
        # find nothing pending; losing the done to a crash here only
        # widens at-least-once (serve/wal.py), never loses the id
        wal.append_done(rid, body.get("code"))
        obs.record_run(body, None)
        if on_answer is not None:
            on_answer(rid, body)
        replayed.append(rid)
    wal.close()
    if release:
        release_claim(wal_path)
    return {"claimed": True, "pending": len(pend), "replayed": replayed,
            "failed": failed}


# ------------------------------------------------------------- replicas ---


class ReplicaProc:
    """One fleet replica: a ``python -m blockchain_simulator_tpu_torch.serve``
    daemon subprocess with its own WAL, serving on ``device`` (``"cuda"``,
    the card, by default), addressed by the READY line's ephemeral port.
    The router duck-types this as an endpoint (``id``/``base_url``/
    ``wal_path``/``proc``).  The daemon's stderr goes to
    ``<wal_path>.stderr``: a replica that dies before READY names its tail."""

    def __init__(self, replica_id: str, wal_path: str, max_batch: int = 8,
                 max_wait_ms: float = 25.0, max_queue: int = 64,
                 mesh_sweep: int = 0, device: str = "cuda",
                 prewarm: dict | None = None, extra_args=(), env=None):
        self.id = str(replica_id)
        self.wal_path = str(wal_path)
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.max_queue = int(max_queue)
        self.mesh_sweep = int(mesh_sweep)
        self.device = str(device)
        self.prewarm = dict(prewarm) if prewarm else None
        self.extra_args = list(extra_args)
        self.env = dict(env) if env else None
        self.proc: subprocess.Popen | None = None
        self.port: int | None = None
        self.base_url: str | None = None
        self.ready: dict = {}
        self.stderr_path = self.wal_path + ".stderr"

    def command(self) -> list[str]:
        cmd = [sys.executable, "-m", "blockchain_simulator_tpu_torch.serve",
               "--port", "0", "--wal", self.wal_path,
               "--replica-id", self.id,
               "--max-batch", str(self.max_batch),
               "--max-wait-ms", str(self.max_wait_ms),
               "--max-queue", str(self.max_queue),
               "--device", self.device]
        if self.mesh_sweep and self.mesh_sweep > 1:
            # the daemon refuses it (exit 2, ROADMAP.md queue A item 7b)
            cmd += ["--mesh-sweep", str(self.mesh_sweep)]
        if self.prewarm:
            # every registry entry of the template's group built before
            # READY: the first requests measure serving, not builds
            cmd += ["--prewarm", json.dumps(self.prewarm)]
        return cmd + self.extra_args

    def _stderr_tail(self, n: int = 2000) -> str:
        try:
            with open(self.stderr_path) as f:
                return f.read()[-n:]
        except OSError:
            return ""

    def _died(self) -> RuntimeError:
        return RuntimeError(
            f"replica {self.id} died before READY (rc={self.proc.returncode})"
            f": {self._stderr_tail()}")

    def start(self, timeout_s: float = 300.0) -> dict:
        """Spawn and wait for the READY line; returns the READY record
        (replay count included — a replica restarted onto its old WAL
        reports what it replayed, zero when the WAL is claimed)."""
        import select

        env = dict(os.environ)
        if self.env:
            env.update(self.env)
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (pkg_root, env.get("PYTHONPATH")) if p)
        os.makedirs(os.path.dirname(self.stderr_path) or ".", exist_ok=True)
        with open(self.stderr_path, "w") as err:
            self.proc = subprocess.Popen(
                self.command(), stdout=subprocess.PIPE, stderr=err,
                text=True, env=env,
            )
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            # select before readline: a silently wedged child (a hung
            # device init) must trip the deadline, not block the fleet in
            # readline() forever
            ready_fds, _, _ = select.select(
                [self.proc.stdout], [], [], 0.25)
            if not ready_fds:
                if self.proc.poll() is not None:
                    raise self._died()
                continue
            line = self.proc.stdout.readline()
            if not line:
                if self.proc.poll() is not None:
                    raise self._died()
                time.sleep(0.05)
                continue
            if line.startswith("READY "):
                self.ready = json.loads(line[len("READY "):])
                self.port = self.ready["port"]
                self.base_url = f"http://{self.ready['host']}:{self.port}"
                return self.ready
        self.kill()
        raise RuntimeError(f"replica {self.id} never printed READY")

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def kill(self) -> None:
        """SIGKILL — the chaos drills' replica-death lever.  A killed
        process's device memory is freed with it; the WAL keeps its
        admitted requests for the handoff."""
        if self.proc is not None and self.proc.poll() is None:
            os.kill(self.proc.pid, signal.SIGKILL)
            self.proc.wait(timeout=60)

    def shutdown(self, drain: bool = True, timeout_s: float = 120.0) -> None:
        """Graceful drain via POST /shutdown; falls back to kill when the
        replica does not answer (already dead, or wedged — a drill state)."""
        import urllib.request

        if self.proc is None or self.proc.poll() is not None:
            return
        try:
            urllib.request.urlopen(urllib.request.Request(
                f"{self.base_url}/shutdown",
                data=json.dumps({"drain": drain}).encode(),
                headers={"Content-Type": "application/json"},
            ), timeout=timeout_s).read()
        except Exception:
            pass
        try:
            self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            self.kill()


class FleetManager:
    """N replicas under one fleet directory: WALs in ``<dir>/wal/``.
    ``<dir>/compile_cache`` is the JAX fleet's shared cache directory; the
    port creates and sets nothing there (module docstring)."""

    def __init__(self, n_replicas: int, fleet_dir: str, **replica_kw):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        self.fleet_dir = str(fleet_dir)
        wal_dir = os.path.join(self.fleet_dir, "wal")
        os.makedirs(wal_dir, exist_ok=True)
        self.replica_kw = replica_kw
        self.replicas: list[ReplicaProc] = [
            ReplicaProc(f"replica-{i}",
                        os.path.join(wal_dir, f"replica-{i}.wal"),
                        **replica_kw)
            for i in range(n_replicas)
        ]

    def start(self, timeout_s: float = 300.0) -> list[dict]:
        """Start every replica, one after another (each pays ``import
        torch`` and a device context; parallel starts would compete for
        the host's cores)."""
        return [r.start(timeout_s) for r in self.replicas]

    def restart(self, replica_id: str, timeout_s: float = 300.0) -> dict:
        """Restart one (dead) replica onto its existing WAL — the recovery
        path after a handoff: with every handed-off id done-marked, the
        READY line must report ``replayed: 0``."""
        for r in self.replicas:
            if r.id == replica_id:
                if r.alive():
                    raise RuntimeError(f"replica {replica_id} still alive")
                return r.start(timeout_s)
        raise KeyError(replica_id)

    def close(self, drain: bool = True) -> None:
        for r in self.replicas:
            r.shutdown(drain=drain)

    def kill_all(self) -> None:
        """SIGKILL every live replica (a failed caller's cleanup: no
        replica process outlives it)."""
        for r in self.replicas:
            r.kill()


# ------------------------------------------------------------ fleet CLI ---


def main(argv=None) -> int:
    """``python -m blockchain_simulator_tpu_torch.serve.fleet`` — N replica
    daemons plus the router front-end on one port.  The router re-serves
    POST /scenario, GET /stats (fleet-wide), GET /metrics, GET /healthz and
    POST /shutdown.  Replicas serve on the card unless ``--device cpu``;
    without a card the fleet exits 1 before READY."""
    p = argparse.ArgumentParser(
        prog="blockchain_simulator_tpu_torch.serve.fleet",
        description="replicated scenario-serving fleet: a router over N "
                    "WAL-durable replica daemons with exactly-once handoff",
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8788,
                   help="router port (0 = ephemeral; the READY line "
                        "carries the bound port)")
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--fleet-dir", default="fleet",
                   help="WALs and claims live here")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=25.0)
    p.add_argument("--max-queue", type=int, default=64)
    p.add_argument("--mesh-sweep", type=int, default=0,
                   help="per-replica sweep mesh width (refused in the "
                        "port: ROADMAP.md queue A item 7b)")
    p.add_argument("--retries", type=int, default=2)
    p.add_argument("--retry-backoff-s", type=float, default=0.05)
    p.add_argument("--hedge-ms", type=float, default=0.0,
                   help="hedge a silent replica after this many ms "
                        "(0 disables; a hedged simulation may execute "
                        "twice — deterministic, so both answers agree)")
    p.add_argument("--probe-interval-s", type=float, default=0.5)
    p.add_argument("--dead-after", type=int, default=2,
                   help="consecutive failed probes before a replica is "
                        "declared dead and its WAL handed off")
    p.add_argument("--restart-dead", action="store_true",
                   help="restart a dead replica after its WAL handoff "
                        "completes (capacity recovery)")
    p.add_argument("--prewarm", default=None, metavar="JSON",
                   help="a request template every replica builds its "
                        "registry entries for before READY")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="the replicas' device: the CUDA card (default; "
                        "without a card the fleet exits 1 before READY) "
                        "or the CPU")
    args = p.parse_args(argv)

    if args.mesh_sweep and args.mesh_sweep > 0:
        from blockchain_simulator_tpu_torch.parallel.mesh import MESH_SERVING_ITEM

        print(f"fleet: --mesh-sweep {args.mesh_sweep} (a sweep mesh per "
              f"replica) comes with {MESH_SERVING_ITEM}", file=sys.stderr)
        return 2
    from blockchain_simulator_tpu_torch import runner

    try:
        runner.resolve_device(args.device)
    except RuntimeError as e:
        # no card: refuse before READY, never fall back to the CPU
        print(f"fleet: {e}", file=sys.stderr)
        return 1
    from blockchain_simulator_tpu_torch.serve.router import (
        FleetRouter, make_router_httpd,
    )

    mgr = FleetManager(
        args.replicas, args.fleet_dir,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        max_queue=args.max_queue, device=args.device,
        prewarm=json.loads(args.prewarm) if args.prewarm else None,
    )
    try:
        mgr.start()
    except Exception as e:
        mgr.kill_all()
        print(f"fleet: {e}", file=sys.stderr)
        return 1
    router = FleetRouter(
        mgr.replicas, retries=args.retries,
        retry_backoff_s=args.retry_backoff_s, hedge_ms=args.hedge_ms,
        probe_interval_s=args.probe_interval_s, dead_after=args.dead_after,
        manager=mgr if args.restart_dead else None,
    )
    httpd = make_router_httpd(router, args.host, args.port)
    print("READY " + json.dumps({
        "host": args.host, "port": httpd.server_address[1],
        "replicas": [{"id": r.id, "port": r.port,
                      "replayed": r.ready.get("replayed"),
                      "device": r.ready.get("device")}
                     for r in mgr.replicas],
        "fleet_dir": args.fleet_dir,
    }), flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        router.close()
        mgr.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
