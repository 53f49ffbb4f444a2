"""Deterministic fault injection for the serving stack (port of
``blockchain_simulator_tpu/chaos``, its hook layer).

Production code carries named chaos points (:func:`~blockchain_simulator_tpu_torch.
chaos.inject.chaos_point`) that are free when disarmed; a seeded
:class:`~blockchain_simulator_tpu_torch.chaos.inject.ChaosController` arms
them with counted, reproducible faults (raise, hang, slow, poison), so the
degrade machinery of the scenario server (degrade-to-solo, circuit
breakers, batcher supervision, quarantine) is exercised by the control
flow it defends.  ``inject.py`` is a copy of the JAX package's: it is host
code.  The invariant checkers and the drill scenarios (``invariants.py``,
``scenarios.py``, ``fleet_scenarios.py``) come with a later slice of the
port (ROADMAP.md).
"""

from blockchain_simulator_tpu_torch.chaos.inject import (  # noqa: F401
    ChaosController,
    ChaosFault,
    ChaosKill,
    chaos_point,
    controller,
)
