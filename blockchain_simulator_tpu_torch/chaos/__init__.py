"""Deterministic fault injection for the serving stack (port of
``blockchain_simulator_tpu/chaos``).

Production code carries named chaos points (:func:`~blockchain_simulator_tpu_torch.
chaos.inject.chaos_point`) that are free when disarmed; a seeded
:class:`~blockchain_simulator_tpu_torch.chaos.inject.ChaosController` arms
them with counted, reproducible faults (raise, hang, slow, poison), and
:mod:`~blockchain_simulator_tpu_torch.chaos.invariants` checks that the
stack kept its accounting promises while the faults flew:

- **no request unaccounted** — every admission ends in exactly one of
  {response, typed rejection, replayed};
- **no lost manifest lines** — every terminal outcome has its access-log
  line in runs.jsonl;
- **registry stats monotone** — cache counters never run backwards.

:mod:`~blockchain_simulator_tpu_torch.chaos.scenarios` scripts the
single-daemon drills (dispatch-fail/hang, health-flap, batcher-kill,
queue-storm, poison-request, crash-restart, sweep-kill9, sweep-wedge,
query-kill9; ``cache-corrupt`` is refused until aotcache's on-disk layer,
ROADMAP.md B-later item 1) and
:mod:`~blockchain_simulator_tpu_torch.chaos.fleet_scenarios` the fleet's
(replica death with WAL handoff, slow-replica hedged failover, router
retry storms, double-claim races), checked by
:func:`~blockchain_simulator_tpu_torch.chaos.invariants.check_fleet`.
Every summary equals the JAX package's for the same scenario and seed;
README "Fleet serving and chaos drills on the port" is the operator doc.
"""

from blockchain_simulator_tpu_torch.chaos.inject import (  # noqa: F401
    ChaosController,
    ChaosFault,
    ChaosKill,
    chaos_point,
    controller,
)
from blockchain_simulator_tpu_torch.chaos.invariants import (  # noqa: F401
    Ledger,
    check_fleet,
    check_server,
    registry_monotone,
)
