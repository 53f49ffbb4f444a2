"""The WAL lease of the fleet layer (port of the lease part of
``blockchain_simulator_tpu/serve/fleet.py``).

On a replica's death a router lease-claims the dead replica's WAL through an
atomic claim file, so its admitted-but-unanswered requests are replayed on a
live peer exactly once fleet-wide.  The scenario server reads the lease at
start (:func:`claim_owner`): a replica restarting on a claimed WAL skips its
own replay, because the pending ids belong to the claim holder.  The claim
file format is the JAX package's.

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
3. Release (:func:`release_claim`) happens only after every pending id has
   a ``done`` record, so a post-release restart replays zero.

The rest of the JAX module (``handoff_wal``, ``ReplicaProc``,
``FleetManager``, the fleet daemon) and the router come with the fleet slice
of the port (ROADMAP.md §B item 1).
"""

from __future__ import annotations

import json
import os
import threading
import time

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
